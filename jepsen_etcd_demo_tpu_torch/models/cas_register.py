"""CAS register: the model the register workload is checked against.

  read  - legal iff the current value equals the observed value `rv`
          (NIL means the key was absent).
  write - always legal; sets the value.
  cas   - legal iff current value == old (a1); sets the value to new (a2).
          A cas that returned :fail never reaches the model.
"""

from __future__ import annotations

import torch

from ..ops.encode import F_CAS, F_READ, F_WRITE, NIL
from .base import Model


class CASRegister(Model):
    name = "cas-register"
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
        if f == F_CAS:
            return (state == a1, a2 if state == a1 else state)
        raise ValueError(f"bad f {f}")

    def step(self, state, f, a1, a2, rv):
        is_read = f == F_READ
        is_write = f == F_WRITE
        is_cas = f == F_CAS
        legal = torch.where(is_read, state == rv,
                            torch.where(is_cas, state == a1, is_write))
        nxt = torch.where(is_write, a1,
                          torch.where(is_cas & (state == a1), a2, state))
        return legal, nxt.to(torch.int32)
