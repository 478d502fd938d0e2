"""Pure-Python linearizability oracle over the event encoding.

Wing-Gong/Lowe frontier search with set-based dedup: keep the set of
(model-state, linearized-bitmask) configurations, close it under firing
pending ops, and at each return keep only the configurations that have
linearized the returning op. Independent of the dense sweep, so the tests
and the chip smoke run hold the sweep's verdicts against it, and
`Linearizable(backend="oracle")` checks with it alone.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..models.base import Model
from ..ops.encode import EV_INVOKE, EV_PAD, EV_RETURN, EncodedHistory


@dataclass
class OracleResult:
    valid: bool
    dead_event: int = -1       # first event index where the frontier emptied
    max_frontier: int = 0
    configs_explored: int = 0

    def to_dict(self):
        return {
            "valid": self.valid,
            "dead_event": self.dead_event,
            "max_frontier": self.max_frontier,
            "configs_explored": self.configs_explored,
        }

    def dead_step(self, enc: EncodedHistory) -> int:
        """The dead event as a return-step index (the dense sweep's
        dead_step)."""
        return _event_to_step(enc, self.dead_event)


def _event_to_step(enc: EncodedHistory, dead_event: int) -> int:
    """An event index as a return-step index: the count of returns
    strictly before the fatal one (-1 stays -1)."""
    if dead_event < 0:
        return -1
    return int((np.asarray(enc.events[:dead_event, 0]) == EV_RETURN).sum())


def check_events_oracle(enc: EncodedHistory, model: Model) -> OracleResult:
    events = np.asarray(enc.events)
    slots: dict[int, tuple[int, int, int, int]] = {}
    frontier: set[tuple[int, int]] = {(int(model.init_state()), 0)}
    max_frontier = len(frontier)
    explored = 0

    def closure(configs, target_slot):
        """Reachable configs; configs that fired the returning op are
        banked, not expanded (just-in-time linearization)."""
        nonlocal explored
        tbit = 1 << target_slot
        seen = set(configs)
        stack = [c for c in configs if not c[1] & tbit]
        while stack:
            state, mask = stack.pop()
            for slot, (f, a1, a2, rv) in slots.items():
                if mask >> slot & 1:
                    continue
                legal, nxt = model.step_py(state, f, a1, a2, rv)
                explored += 1
                if legal:
                    cfg = (int(nxt), mask | (1 << slot))
                    if cfg not in seen:
                        seen.add(cfg)
                        if not cfg[1] & tbit:
                            stack.append(cfg)
        return seen

    for i in range(enc.n_events):
        kind, slot, f, a1, a2, rv = (int(x) for x in events[i])
        if kind == EV_PAD:
            continue
        if kind == EV_INVOKE:
            slots[slot] = (f, a1, a2, rv)
        elif kind == EV_RETURN:
            expanded = closure(frontier, slot)
            max_frontier = max(max_frontier, len(expanded))
            bit = 1 << slot
            frontier = {(s, m & ~bit) for (s, m) in expanded if m & bit}
            del slots[slot]
            if not frontier:
                return OracleResult(False, dead_event=i,
                                    max_frontier=max_frontier,
                                    configs_explored=explored)
        max_frontier = max(max_frontier, len(frontier))
    return OracleResult(True, max_frontier=max_frontier,
                        configs_explored=explored)
