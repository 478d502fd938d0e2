"""Encode a concurrent history into int32 event arrays for the checker.

Host numpy, bit-identical to the JAX package's encoder. A register
history becomes

  events[E, 6] int32 rows: (kind, slot, f, a1, a2, rv)

    kind: EV_INVOKE - an op becomes pending (its fields load into `slot`)
          EV_RETURN - the op in `slot` returned ok; every surviving
                      linearization must have linearized it by now
          EV_PAD    - padding (no-op)
    f:    F_READ / F_WRITE / F_CAS
    a1,a2: op arguments (write value; cas old/new)
    rv:   observed value for reads (NIL when the key was missing)

Completion handling: ok ops contribute an invoke and a return; info ops
only an invoke (pending forever; indeterminate reads are dropped); fail
ops are dropped. Each pending op occupies one of `k_slots` slots while it
is pending, so a configuration's linearized set is a K-bit mask.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np

from .op import FAIL, INFO, INVOKE, OK, Op

NIL = -1

# F_READ is by convention the pure-observation code of every op language:
# the encoder drops indeterminate reads without asking the model.
F_READ, F_WRITE, F_CAS = 0, 1, 2
FUNC_CODES = {"read": F_READ, "write": F_WRITE, "cas": F_CAS}

EV_INVOKE, EV_RETURN, EV_PAD = 0, 1, 2

EVENT_WIDTH = 6  # (kind, slot, f, a1, a2, rv)


class EncodeError(ValueError):
    pass


class SlotOverflow(EncodeError):
    """More simultaneously-pending ops than k_slots."""


@dataclass
class Invocation:
    """One paired invocation: invoke entry + (optional) completion."""

    f: int
    a1: int
    a2: int
    rv: int
    status: str            # ok | fail | info
    invoke_index: int
    complete_index: int    # -1 if the op never completed
    process: Any = None


@dataclass
class EncodedHistory:
    """Event array plus bookkeeping, ready for the dense sweep."""

    events: np.ndarray     # [E, 6] int32
    n_events: int          # real (non-pad) events
    n_ops: int             # invocations included (ok + open info)
    k_slots: int
    max_pending: int       # high-water mark of simultaneously pending ops
    max_value: int = 0     # largest encoded value (a1/a2/rv)

    def padded_to(self, e_cap: int) -> "EncodedHistory":
        if e_cap < self.events.shape[0]:
            raise EncodeError(
                f"cannot pad events of length {self.events.shape[0]} to "
                f"{e_cap}")
        ev = np.zeros((e_cap, EVENT_WIDTH), dtype=np.int32)
        ev[:, 0] = EV_PAD
        ev[: self.events.shape[0]] = self.events
        return EncodedHistory(ev, self.n_events, self.n_ops, self.k_slots,
                              self.max_pending, self.max_value)

    def to_arrays(self) -> dict[str, np.ndarray]:
        return {"events": np.asarray(self.events[: self.n_events]),
                "n_ops": np.asarray(self.n_ops),
                "k_slots": np.asarray(self.k_slots),
                "max_pending": np.asarray(self.max_pending),
                "max_value": np.asarray(self.max_value)}


def _encode_value(v: Any) -> int:
    if v is None:
        return NIL
    v = int(v)
    if v < 0:
        raise EncodeError(
            f"negative history values are unsupported (got {v}); "
            f"-1 is the NIL sentinel")
    return v


def register_fields(f_name: str, invoke_value: Any, ok_value: Any,
                    status: str) -> tuple[int, int, int, int]:
    """The register op language: read -> rv = observed value;
    write -> a1 = value; cas -> a1, a2 = old, new."""
    if f_name not in FUNC_CODES:
        raise EncodeError(f"unsupported register op f={f_name!r}")
    f = FUNC_CODES[f_name]
    a1 = a2 = 0
    rv = NIL
    if f == F_READ:
        if status == OK:
            rv = _encode_value(ok_value)
    elif f == F_WRITE:
        a1 = _encode_value(invoke_value)
    elif f == F_CAS:
        old, new = invoke_value
        a1, a2 = _encode_value(old), _encode_value(new)
    return f, a1, a2, rv


def pair_history(history: Sequence[Op], model=None) -> list[Invocation]:
    """Pair invoke entries with their completions by process id.

    A process has at most one outstanding invocation. Invocations whose
    completion never arrives are treated as `info` (crashed mid-op).
    `model` supplies the op-language codec; None uses the register one."""
    pending: dict[Any, tuple[int, Op]] = {}
    out: list[Invocation] = []
    for idx, op in enumerate(history):
        if op.type == INVOKE:
            if op.process in pending:
                raise EncodeError(
                    f"process {op.process} invoked twice without completing "
                    f"(history indices {pending[op.process][0]} and {idx})")
            pending[op.process] = (idx, op)
        elif op.type in (OK, FAIL, INFO):
            if op.process not in pending:
                raise EncodeError(
                    f"completion for process {op.process} at history index "
                    f"{idx} has no pending invocation")
            inv_idx, inv = pending.pop(op.process)
            out.append(_make_invocation(inv, op, inv_idx, idx, model))
        else:
            raise EncodeError(f"unknown op type {op.type!r} at index {idx}")
    for _proc, (inv_idx, inv) in pending.items():
        out.append(_make_invocation(inv, None, inv_idx, -1, model))
    out.sort(key=lambda i: i.invoke_index)
    return out


def _make_invocation(inv: Op, comp: Optional[Op], inv_idx: int,
                     comp_idx: int, model=None) -> Invocation:
    status = comp.type if comp is not None else INFO
    comp_value = (comp.value if comp is not None
                  and comp.type in (OK, INFO) else None)
    codec = register_fields if model is None else model.encode_invocation
    f, a1, a2, rv = codec(inv.f, inv.value, comp_value, status)
    return Invocation(f=f, a1=a1, a2=a2, rv=rv, status=status,
                      invoke_index=inv_idx, complete_index=comp_idx,
                      process=inv.process)


def _timeline_points(invocations: Sequence[Invocation]
                     ) -> list[tuple[int, int, Invocation]]:
    """(history_index, is_return, invocation) per event, in event order."""
    points: list[tuple[int, int, Invocation]] = []
    for inv in invocations:
        if inv.status == FAIL:
            continue
        if inv.status == INFO and inv.f == F_READ:
            continue  # an indeterminate read imposes no constraint
        points.append((inv.invoke_index, 0, inv))
        if inv.status == OK:
            points.append((inv.complete_index, 1, inv))
    points.sort(key=lambda p: (p[0], p[1]))
    return points


def encode_events(invocations: Sequence[Invocation], k_slots: int = 32
                  ) -> EncodedHistory:
    """Build the (kind, slot, f, a1, a2, rv) event stream, assigning each
    pending op the lowest free slot (freed slots are reused LIFO)."""
    points = _timeline_points(invocations)
    free = list(range(k_slots - 1, -1, -1))  # pop() yields lowest slot first
    slot_of: dict[int, int] = {}
    rows: list[list[int]] = []
    max_pending = 0
    for hist_idx, is_return, inv in points:
        if not is_return:
            if not free:
                raise SlotOverflow(
                    f"more than {k_slots} simultaneously pending ops at "
                    f"history index {hist_idx}; raise k_slots")
            slot = free.pop()
            slot_of[inv.invoke_index] = slot
            rows.append([EV_INVOKE, slot, inv.f, inv.a1, inv.a2, inv.rv])
            max_pending = max(max_pending, k_slots - len(free))
        else:
            slot = slot_of.pop(inv.invoke_index)
            rows.append([EV_RETURN, slot, inv.f, inv.a1, inv.a2, inv.rv])
            free.append(slot)
    events = np.asarray(rows, dtype=np.int32).reshape(-1, EVENT_WIDTH)
    n_ops = sum(1 for _, r, _i in points if not r)
    max_value = int(events[:, 3:6].max()) if len(rows) else 0
    return EncodedHistory(events=events, n_events=len(rows), n_ops=n_ops,
                          k_slots=k_slots, max_pending=max_pending,
                          max_value=max_value)


def encode_register_history(history: Sequence[Op], k_slots: int = 32
                            ) -> EncodedHistory:
    """History of register ops (read/write/cas) -> event array."""
    return encode_events(pair_history(history), k_slots=k_slots)


def encode_history(history: Sequence[Op], model, k_slots: int = 32
                   ) -> EncodedHistory:
    """History in `model`'s op language -> event array (does NOT apply
    model.prepare_history; the checker translates once)."""
    return encode_events(pair_history(history, model), k_slots=k_slots)


def reslot_events(enc: EncodedHistory, k_slots: int) -> EncodedHistory:
    """Remap slot ids into a smaller slot table (k_slots >= max_pending),
    with the same lowest-free assignment encode_events uses, so the result
    is what encoding with the smaller k_slots would have produced."""
    if k_slots < enc.max_pending:
        raise EncodeError(
            f"cannot reslot to {k_slots} slots: history has "
            f"{enc.max_pending} simultaneously pending ops")
    ev = enc.events[: enc.n_events].copy()
    free = list(range(k_slots - 1, -1, -1))
    mapping: dict[int, int] = {}
    for row in ev:
        if row[0] == EV_INVOKE:
            new = free.pop()
            mapping[int(row[1])] = new
            row[1] = new
        elif row[0] == EV_RETURN:
            new = mapping.pop(int(row[1]))
            row[1] = new
            free.append(new)
    return EncodedHistory(events=ev, n_events=enc.n_events, n_ops=enc.n_ops,
                          k_slots=k_slots, max_pending=enc.max_pending,
                          max_value=enc.max_value)


@dataclass
class ReturnSteps:
    """Return-event-major encoding: one row per EV_RETURN with a full
    pending-slot snapshot. slot_tabs[i] is the slot table just before
    return i: every op invoked earlier and not yet returned is active,
    the returning op included."""

    slot_tabs: np.ndarray    # [R, K, 4] int32 (f, a1, a2, rv)
    slot_active: np.ndarray  # [R, K] bool
    targets: np.ndarray      # [R] int32 slot of the returning op; -1 = pad
    n_steps: int             # real (non-pad) returns
    n_ops: int
    k_slots: int
    max_pending: int
    max_value: int = 0

    def padded_to(self, r_cap: int) -> "ReturnSteps":
        r = self.slot_tabs.shape[0]
        if r_cap < r:
            raise EncodeError(f"cannot pad {r} return steps to {r_cap}")
        tabs = np.zeros((r_cap,) + self.slot_tabs.shape[1:], np.int32)
        act = np.zeros((r_cap, self.k_slots), bool)
        tgt = np.full((r_cap,), -1, np.int32)
        tabs[:r] = self.slot_tabs
        act[:r] = self.slot_active
        tgt[:r] = self.targets
        return ReturnSteps(tabs, act, tgt, self.n_steps, self.n_ops,
                           self.k_slots, self.max_pending, self.max_value)


def encode_return_steps(enc: EncodedHistory) -> ReturnSteps:
    """The return-major encoding, vectorised: for each return event at
    position p, slot k's row is the fields of the last EV_INVOKE of slot k
    before p, and slot k is active iff its invokes before p outnumber its
    returns strictly before p (the returning op itself counts active)."""
    k = enc.k_slots
    n = enc.n_events
    ev = np.asarray(enc.events[:n])
    if n == 0 or not (ev[:, 0] == EV_RETURN).any():
        return ReturnSteps(
            slot_tabs=np.zeros((0, k, 4), np.int32),
            slot_active=np.zeros((0, k), bool),
            targets=np.zeros((0,), np.int32),
            n_steps=0, n_ops=enc.n_ops, k_slots=k,
            max_pending=enc.max_pending, max_value=enc.max_value)
    kinds, slots = ev[:, 0], ev[:, 1]
    slot_ids = np.arange(k)
    inv_onehot = (kinds == EV_INVOKE)[:, None] & (slots[:, None] == slot_ids)
    ret_onehot = (kinds == EV_RETURN)[:, None] & (slots[:, None] == slot_ids)
    inv_cum = np.cumsum(inv_onehot, axis=0)
    ret_cum = np.cumsum(ret_onehot, axis=0)
    last_inv = np.maximum.accumulate(
        np.where(inv_onehot, np.arange(n)[:, None], -1), axis=0)
    ret_pos = np.nonzero(kinds == EV_RETURN)[0]
    active = inv_cum[ret_pos] > (ret_cum[ret_pos] - ret_onehot[ret_pos])
    last = last_inv[ret_pos]
    tabs = np.where(last[:, :, None] >= 0,
                    ev[np.maximum(last, 0)][:, :, 2:6], 0).astype(np.int32)
    return ReturnSteps(
        slot_tabs=tabs,
        slot_active=active,
        targets=slots[ret_pos].astype(np.int32),
        n_steps=len(ret_pos), n_ops=enc.n_ops, k_slots=k,
        max_pending=enc.max_pending, max_value=enc.max_value)
