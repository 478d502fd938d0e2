"""Counterexample extraction: explain why a history is not linearizable.

The sweeps report only the fatal return step (a packed table keeps no
lineage), so the witness is rebuilt on the host by replaying the WGL
search with parent tracking up to the death point:

  * the failed operation (the return no reachable config had linearized),
  * one maximal linearization of the prefix (the firing order of a config
    that survived longest: concrete evidence the prefix is linearizable),
  * the final reachable configurations (state and still-pending ops).

A long history's full replay can exceed the effort cap; then the dense
sweep recovers the exact frontier WITNESS_WINDOW_STEPS return steps
before the death point (ops/wgl3.recover_table3, on the card, under the
chunked cell budget) and only that window is replayed
(`reconstruct_witness_windowed`). Where no such table exists, the sort
search's frontier at the start of the chunk it died in seeds the replay
(`reconstruct_witness_from_sort_checkpoint`).

Artifacts: `linear.json` (machine-readable) and `linear.svg` (rendering),
`linear-<key>.{json,svg}` under the independent-keys checker.
"""

from __future__ import annotations

import html
import json
from pathlib import Path
from typing import Any, Optional, Sequence

import numpy as np

from ..models.base import Model
from ..ops.encode import (EV_INVOKE, EV_RETURN, EncodedHistory, Invocation,
                          event_sources, pair_history)
from ..ops.op import Op

# Model steps the lineage replay may take before it gives up; the replay
# is as exponential as the search, and witnesses are for humans.
MAX_WITNESS_EVENTS = 200_000

# Return steps replayed after the frontier recovery: enough to show the
# failing op in context, few enough that the replay is quick.
WITNESS_WINDOW_STEPS = 64


class WitnessEffortExceeded(Exception):
    """The replay hit its effort cap before the death point; the caller
    falls back to the windowed replay or records a "skipped" marker."""

    def __init__(self, event_index: int, effort: int):
        super().__init__(
            f"witness replay exceeded {effort} model steps at event "
            f"{event_index}")
        self.event_index = event_index
        self.effort = effort


def _inv_info(inv: Optional[Invocation]) -> dict[str, Any]:
    if inv is None:
        return {}
    return {"process": inv.process, "invoke_index": inv.invoke_index,
            "complete_index": inv.complete_index}


def _sources_fn(history: Sequence[Op] | None, model):
    sources: list[Optional[Invocation]] = []
    if history is not None:
        sources = list(event_sources(pair_history(history, model)))

    def src(i: int) -> Optional[Invocation]:
        return sources[i] if i < len(sources) else None

    return src


def slots_at_event(enc: EncodedHistory, e0: int):
    """Pending-slot state just before event e0: slot -> (f, a1, a2, rv)
    and slot -> invoke event index."""
    events = np.asarray(enc.events)
    slots: dict[int, tuple[int, int, int, int]] = {}
    slot_event: dict[int, int] = {}
    for i in range(min(e0, enc.n_events)):
        kind, slot, f, a1, a2, rv = (int(x) for x in events[i])
        if kind == EV_INVOKE:
            slots[slot] = (f, a1, a2, rv)
            slot_event[slot] = i
        elif kind == EV_RETURN:
            slots.pop(slot, None)
            slot_event.pop(slot, None)
    return slots, slot_event


def _replay(enc: EncodedHistory, model: Model, start_event: int,
            frontier: dict, slots: dict, slot_event: dict, src,
            effort_cap: int) -> Optional[dict[str, Any]]:
    """The lineage-tracking WGL replay from a starting point. Returns the
    witness at the death point, None when the replayed range is
    linearizable; raises WitnessEffortExceeded past the cap."""
    events = np.asarray(enc.events)
    effort = 0
    for i in range(start_event, enc.n_events):
        kind, slot, f, a1, a2, rv = (int(x) for x in events[i])
        if kind == EV_INVOKE:
            slots[slot] = (f, a1, a2, rv)
            slot_event[slot] = i
        elif kind == EV_RETURN:
            tbit = 1 << slot
            seen = dict(frontier)
            stack = [c for c in frontier if not c[1] & tbit]
            while stack:
                state, mask = stack.pop()
                lin = seen[(state, mask)]
                for s, (sf, sa1, sa2, srv) in slots.items():
                    if mask >> s & 1:
                        continue
                    legal, nxt = model.step_py(state, sf, sa1, sa2, srv)
                    effort += 1
                    if legal:
                        cfg = (int(nxt), mask | (1 << s))
                        if cfg not in seen:
                            seen[cfg] = lin + ((slot_event.get(s, -1),
                                                int(nxt)),)
                            if not cfg[1] & tbit:
                                stack.append(cfg)
                if effort > effort_cap:
                    raise WitnessEffortExceeded(i, effort)
            survivors = {(s, m & ~tbit): lin
                         for (s, m), lin in seen.items() if m & tbit}
            if not survivors:
                return _build_witness(enc, model, i, slot, slots,
                                      slot_event, seen, src)
            frontier = survivors
            del slots[slot]
            del slot_event[slot]
    return None


def reconstruct_witness(enc: EncodedHistory, model: Model,
                        history: Sequence[Op] | None = None,
                        effort_cap: int | None = None
                        ) -> Optional[dict[str, Any]]:
    """Replay the search with lineage from the start: the witness of an
    invalid history, None for a linearizable one. Raises
    WitnessEffortExceeded past the effort cap (MAX_WITNESS_EVENTS, read
    at call time)."""
    if effort_cap is None:
        effort_cap = MAX_WITNESS_EVENTS
    src = _sources_fn(history, model)
    frontier: dict[tuple[int, int], tuple] = {
        (int(model.init_state()), 0): ()}
    return _replay(enc, model, 0, frontier, {}, {}, src, effort_cap)


def reconstruct_witness_windowed(enc: EncodedHistory, model: Model,
                                 dead_step: int,
                                 history: Sequence[Op] | None = None,
                                 window: int = WITNESS_WINDOW_STEPS,
                                 effort_cap: int | None = None,
                                 device=None) -> Optional[dict[str, Any]]:
    """The witness of a long history: recover the exact frontier `window`
    return steps before the known death point with the resumable dense
    sweep on `device` (None = cuda), and replay only that window. The
    witness's maximal linearization then covers the window; the prefix
    before it is linearizable by the sweep's own verdict
    (window_start_step records where it starts).

    Raises ValueError when no table under the chunked cell budget
    (dense_cell_budget_chunked) holds the history and
    WitnessEffortExceeded when the window's replay exceeds the cap."""
    from ..ops import wgl3
    from ..ops.encode import encode_return_steps, reslot_events
    from ..ops.limits import limits

    if effort_cap is None:
        effort_cap = MAX_WITNESS_EVENTS
    k = wgl3.tight_k_slots(enc)
    cfg = wgl3.dense_config(model, k, enc.max_value,
                            budget=limits().dense_cell_budget_chunked)
    if cfg is None:
        raise ValueError(
            f"dense frontier recovery infeasible: max_pending="
            f"{enc.max_pending}, max_value={enc.max_value}")
    enc_r = reslot_events(enc, k) if enc.k_slots != k else enc
    rs = encode_return_steps(enc_r, device)
    s0 = max(0, min(dead_step, rs.n_steps - 1) - window)
    configs = wgl3.recover_table3(rs, model, cfg, s0, device)
    # Event index just after the s0-th return.
    events = np.asarray(enc_r.events[: enc_r.n_events])
    ret_pos = np.nonzero(events[:, 0] == EV_RETURN)[0]
    e0 = 0 if s0 == 0 else int(ret_pos[s0 - 1]) + 1
    slots, slot_event = slots_at_event(enc_r, e0)
    frontier = {(int(s), int(m)): () for s, m in configs}
    src = _sources_fn(history, model)
    w = _replay(enc_r, model, e0, frontier, slots, slot_event, src,
                effort_cap)
    if w is not None:
        w["window_start_step"] = s0
        w["window_start_event"] = e0
        w["note"] = (
            f"maximal_linearization covers the final window only "
            f"(from return step {s0}); the prefix before it is "
            f"machine-verified linearizable by the dense kernel")
    return w


def reconstruct_witness_from_sort_checkpoint(
        enc: EncodedHistory, model: Model,
        history: Sequence[Op] | None = None,
        effort_cap: int | None = None,
        time_budget_s: float | None = None,
        checkpoint: tuple | None = None,
        dead_step: int = -1, device=None) -> Optional[dict[str, Any]]:
    """The witness of a history no dense table holds: the lineage replay
    starts from the sort search's exact frontier at the start of the chunk
    it died in, so at most one chunk (wgl2.DEFAULT_CHUNK return steps) is
    replayed.

    `checkpoint` is the (states, masks, valid, step) the search recorded
    (ops/wgl2.check_steps_resumable keep_death_checkpoint). Without one
    the search runs again here on `device` (None = cuda), unless
    `dead_step` says the death lies in the first chunk, where the
    checkpoint would be the empty prefix. Returns None when that search
    finds the history linearizable; raises WitnessEffortExceeded when the
    replay exceeds the cap or would start at step 0, and MemoryError when
    the search does not fit."""
    from ..ops import wgl2
    from ..ops.encode import encode_return_steps, reslot_events

    if effort_cap is None:
        effort_cap = MAX_WITNESS_EVENTS
    tight = wgl2.sort_k_slots(enc)
    enc_r = reslot_events(enc, tight) if enc.k_slots != tight else enc
    if checkpoint is None:
        if 0 <= dead_step < wgl2.DEFAULT_CHUNK:
            raise WitnessEffortExceeded(0, 0)
        out = wgl2.check_steps_resumable(
            encode_return_steps(enc_r, device), model, f_cap_max=1 << 20,
            keep_death_checkpoint=True, time_budget_s=time_budget_s,
            device=device)
        if out["valid"]:
            return None
        checkpoint = out["death_checkpoint"]
    states, masks, valid, s0 = checkpoint
    if s0 == 0:
        # The replay from here would repeat the full one that blew its cap.
        raise WitnessEffortExceeded(0, 0)
    configs = wgl2.checkpoint_configs(states, masks, valid)
    events = np.asarray(enc_r.events[: enc_r.n_events])
    ret_pos = np.nonzero(events[:, 0] == EV_RETURN)[0]
    e0 = int(ret_pos[s0 - 1]) + 1
    slots, slot_event = slots_at_event(enc_r, e0)
    frontier = {(int(s), int(m)): () for s, m in configs}
    src = _sources_fn(history, model)
    w = _replay(enc_r, model, e0, frontier, slots, slot_event, src,
                effort_cap)
    if w is not None:
        w["window_start_step"] = s0
        w["window_start_event"] = e0
        w["note"] = (
            f"maximal_linearization covers the final window only (from "
            f"return step {s0}, the sort kernel's exact checkpoint "
            f"nearest the death); the prefix before it is "
            f"machine-verified linearizable by the sort kernel")
    return w


def _build_witness(enc, model, event_index, slot, slots, slot_event,
                   seen, src):
    f, a1, a2, rv = slots[slot]
    desc = model.describe_op
    # The best explanation: a reachable config that linearized the most
    # ops (its lineage is a concrete maximal linearization of the prefix).
    best_cfg = max(seen, key=lambda c: bin(c[1]).count("1"))
    prefix = [{
        "event_index": ev_i,
        "op": desc(*_op_at(enc, ev_i)),
        "state_after": state,
        **_inv_info(src(ev_i)),
    } for ev_i, state in seen[best_cfg]]
    final_configs = sorted(
        {(s, _pending_desc(m, slots, model)) for s, m in seen},
        key=str)[:16]
    ret = int((np.asarray(enc.events[:event_index, 0]) == EV_RETURN).sum())
    return {
        "valid": False,
        "op": desc(f, a1, a2, rv),
        **_inv_info(src(slot_event[slot])),
        "event_index": event_index,
        "dead_step": ret,
        "maximal_linearization": prefix,
        "final_state": best_cfg[0],
        "final_configs": [
            {"state": s, "pending_unfired": list(p)}
            for s, p in final_configs],
        "explanation": (
            f"no reachable configuration could linearize "
            f"{desc(f, a1, a2, rv)} by the time it returned"),
    }


def _op_at(enc, event_index: int) -> tuple[int, int, int, int]:
    _, _, f, a1, a2, rv = (int(x) for x in enc.events[event_index])
    return f, a1, a2, rv


def _pending_desc(mask: int, slots, model) -> tuple:
    return tuple(model.describe_op(*op) for s, op in sorted(slots.items())
                 if not mask >> s & 1)


SVG_STYLE = "font-family:sans-serif;font-size:12px"


def render_witness_svg(w: dict[str, Any]) -> str:
    """knossos-linear.svg-style rendering: the maximal linearization as a
    chain of state transitions, then the stuck op in red."""
    rows = []
    y = 28
    rows.append(f'<text x="10" y="{y}" font-weight="bold">'
                f'not linearizable: {html.escape(w["op"])}</text>')
    y += 22
    rows.append(f'<text x="10" y="{y}" fill="#555">'
                f'{html.escape(w["explanation"])}</text>')
    y += 28
    x = 10
    for stepd in w["maximal_linearization"]:
        label = f'{stepd["op"]} ⇒ {stepd["state_after"]}'
        wpx = 9 * len(label) + 16
        rows.append(
            f'<rect x="{x}" y="{y - 16}" width="{wpx}" height="22" rx="4" '
            f'fill="#e8f5e9" stroke="#66bb6a"/>'
            f'<text x="{x + 8}" y="{y}">{html.escape(label)}</text>')
        x += wpx + 10
        if x > 760:
            x = 10
            y += 30
    wpx = 9 * len(w["op"]) + 16
    rows.append(
        f'<rect x="{x}" y="{y - 16}" width="{wpx}" height="22" rx="4" '
        f'fill="#ffebee" stroke="#e53935"/>'
        f'<text x="{x + 8}" y="{y}" fill="#b71c1c">'
        f'{html.escape(w["op"])}</text>')
    height = y + 30
    return (f'<svg xmlns="http://www.w3.org/2000/svg" width="980" '
            f'height="{height}" style="{SVG_STYLE}">'
            f'<rect width="100%" height="100%" fill="white"/>'
            + "".join(rows) + "</svg>")


def write_witness(store_dir: str, key: Any, w: dict[str, Any]) -> str:
    """Persist a witness as linear.json + linear.svg (a per-key suffix
    under the independent-keys checker); returns the json file's name."""
    suffix = f"-{key}" if key is not None else ""
    jname = f"linear{suffix}.json"
    Path(store_dir, jname).write_text(json.dumps(w, indent=2, default=str))
    Path(store_dir, f"linear{suffix}.svg").write_text(render_witness_svg(w))
    return jname
