"""The return-major expansion of an event stream, on the device.

The host expansion (ops/encode.py `_encode_return_steps_host`) builds
R x (K x 5 + 1) int32 cells per history from the compact event stream
events[E, 6], about K times smaller. This module is the same expansion
as torch ops on the stream's device: the events cross to the card once
and the slot table of every return step is rebuilt there (one-hot
cumsums, a running cummax of the last invoke position, a fixed-size
extraction of the return positions, gathers).

Routing: ``limits().encode_mode`` (ops/limits.py), read by
``ops.encode.encode_return_steps``.

Bit-identity: for any EncodedHistory, the first n_steps rows of
`expand` equal the host expansion exactly, and the rows past them equal
``ReturnSteps.padded_to``'s pads (tabs 0, active False, targets -1). All
arithmetic is on integers and booleans.

Shapes: the event axis is padded to an `event_bucket` and the step axis
to a {2^k, 1.5*2^k} bucket, as the JAX package's compiled encoder pads
them; the port compiles nothing, but the buckets keep its inputs and
its padded tail the same.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from . import wgl3
from .encode import EV_INVOKE, EV_RETURN, EncodedHistory, ReturnSteps
from .limits import limits

# Floor of the event-axis buckets (and of the step axis of a device
# encode), the JAX package's.
EVENT_BUCKET_FLOOR = 32


def event_bucket(n_events: int, floor: int = EVENT_BUCKET_FLOOR) -> int:
    """{2^k, 1.5*2^k} capacity bucket of the event axis."""
    return wgl3.step_bucket(max(1, int(n_events)), floor=floor)


def returns_count(enc: EncodedHistory) -> int:
    """Return steps of the history, counted on its event stream (the
    n_steps encode_return_steps reports), with no expansion."""
    if enc.n_events == 0:
        return 0
    ev = np.asarray(enc.events[: enc.n_events])
    return int((ev[:, 0] == EV_RETURN).sum())


def expand(events: torch.Tensor, k_slots: int, r_cap: int):
    """events int32[E, 6] (pads EV_PAD) on any device -> (slot_tabs
    int32[r_cap, K, 4], slot_active bool[r_cap, K], targets int32[r_cap])
    on the same device; r_cap must be at least the number of returns.

    Term for term the host expansion: for each return at position p, slot
    k's row is the fields of the last invoke of slot k at or before p,
    and slot k is active iff its invokes up to p outnumber its returns
    strictly before p. The return positions come from a scatter of each
    return's rank (a fixed-size nonzero, no host sync); rows past the
    real returns gather event 0 and are zeroed."""
    dev = events.device
    e_cap = events.shape[0]
    kinds, slots = events[:, 0], events[:, 1]
    sid = torch.arange(k_slots, dtype=slots.dtype, device=dev)
    is_ret = kinds == EV_RETURN
    inv_oh = (kinds == EV_INVOKE)[:, None] & (slots[:, None] == sid)
    ret_oh = is_ret[:, None] & (slots[:, None] == sid)
    inv_cum = torch.cumsum(inv_oh, dim=0, dtype=torch.int32)
    ret_cum = torch.cumsum(ret_oh, dim=0, dtype=torch.int32)
    pos = torch.arange(e_cap, dtype=torch.int32, device=dev)
    last_inv = torch.cummax(torch.where(inv_oh, pos[:, None], -1),
                            dim=0).values
    rank = torch.cumsum(is_ret, dim=0, dtype=torch.int64) - 1
    ret_pos = torch.zeros(r_cap + 1, dtype=torch.int64, device=dev)
    ret_pos.scatter_(0, torch.where(is_ret, rank.clamp(max=r_cap), r_cap),
                     pos.to(torch.int64))
    ret_pos = ret_pos[:r_cap]
    valid = (torch.arange(r_cap, device=dev)
             < is_ret.sum(dtype=torch.int64))
    active = valid[:, None] & (
        inv_cum[ret_pos] > ret_cum[ret_pos] - ret_oh[ret_pos].to(torch.int32))
    last = last_inv[ret_pos]
    fields = events[last.clamp(min=0).long()][:, :, 2:6]
    tabs = torch.where(((last >= 0) & valid[:, None])[:, :, None], fields,
                       0).to(torch.int32)
    targets = torch.where(valid, slots[ret_pos], -1).to(torch.int32)
    return tabs, active, targets


def encode_return_steps_device(enc: EncodedHistory,
                               device=None) -> ReturnSteps:
    """One history's return steps expanded on `device` (None = cuda) with
    the event and step axes padded to their buckets, fetched back as a
    host ReturnSteps trimmed to the real return count: bit-identical to
    the host expansion."""
    k = enc.k_slots
    n_ret = returns_count(enc)
    if n_ret == 0:
        return ReturnSteps(
            slot_tabs=np.zeros((0, k, 4), np.int32),
            slot_active=np.zeros((0, k), bool),
            targets=np.zeros((0,), np.int32),
            n_steps=0, n_ops=enc.n_ops, k_slots=k,
            max_pending=enc.max_pending, max_value=enc.max_value)
    r_cap = wgl3.step_bucket(n_ret, floor=EVENT_BUCKET_FLOOR)
    ev = torch.from_numpy(enc.padded_to(event_bucket(enc.n_events)).events
                          ).to(resolve_device(device))
    tabs, act, tgt = (x[:n_ret].cpu().numpy() for x in expand(ev, k, r_cap))
    return ReturnSteps(
        slot_tabs=tabs, slot_active=act, targets=tgt,
        n_steps=n_ret, n_ops=enc.n_ops, k_slots=k,
        max_pending=enc.max_pending, max_value=enc.max_value)


def device_encode_feasible(enc: EncodedHistory) -> bool:
    """Whether the device encoder takes this history: a non-empty event
    stream whose one-hot expansion (e_cap x k_slots cells) stays within
    the stacked-element budget."""
    if enc.n_events == 0:
        return False
    e_cap = event_bucket(enc.n_events)
    return e_cap * max(1, enc.k_slots) <= limits().stack_element_budget
