"""Model protocol: a deterministic state machine stepped by linearized ops.

A step either yields a successor state or is illegal; the checker prunes
illegal transitions from candidate linearization orders.
"""

from __future__ import annotations

import abc
from typing import Tuple


class Model(abc.ABC):
    """A state machine over int32 scalar states."""

    name: str = "model"
    # Register-like models whose reachable states are bounded by the
    # history's values opt in; `state_offset` maps the smallest state
    # (NIL = -1) to row 0 of the dense table.
    packable_states: bool = False
    state_offset: int = 0

    def state_bound(self, max_value: int) -> int:
        """Largest shifted state index reachable, given the largest value
        in the history: the reachable range is {init_state()} plus the
        history's values."""
        return max(int(max_value), int(self.init_state())) + self.state_offset

    def prepare_history(self, history):
        """Model-level op translation before encoding; identity here."""
        return history

    def encode_invocation(self, f_name: str, invoke_value, ok_value,
                          status: str) -> Tuple[int, int, int, int]:
        """Op-language codec: the register language by default."""
        from ..ops.encode import register_fields

        return register_fields(f_name, invoke_value, ok_value, status)

    @abc.abstractmethod
    def init_state(self) -> int:
        ...

    @abc.abstractmethod
    def step_py(self, state: int, f: int, a1: int, a2: int, rv: int
                ) -> Tuple[bool, int]:
        """Python-scalar step: (legal, next_state)."""

    @abc.abstractmethod
    def step(self, state, f, a1, a2, rv):
        """Branchless tensor step over broadcastable int32 tensors:
        (legal bool, next_state int32)."""
