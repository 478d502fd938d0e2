"""Plain read/write register (no CAS): the simplest register model."""

from __future__ import annotations

import torch

from ..ops.encode import F_READ, F_WRITE, NIL
from .base import Model


class Register(Model):
    name = "register"
    packable_states = True

    def __init__(self, initial: int = NIL):
        self.initial = initial
        self.state_offset = -min(NIL, initial)

    def init_state(self) -> int:
        return self.initial

    def step_py(self, state, f, a1, a2, rv):
        if f == F_READ:
            return (state == rv, state)
        if f == F_WRITE:
            return (True, a1)
        return (False, state)  # cas is not part of this model

    def step(self, state, f, a1, a2, rv):
        is_read = f == F_READ
        is_write = f == F_WRITE
        legal = torch.where(is_read, state == rv, is_write)
        nxt = torch.where(is_write, a1, state)
        return legal, nxt.to(torch.int32)
