"""Multi-register: `n_registers` registers, each read and written alone:
`write(i, v)` and `read(i) -> v`.

The register file packs into one int32: register i is the `digit_bits`-
wide field i, holding v+1 (0: never written, read as nil). Op language:
values are (index, value) pairs; `write` carries both on the invoke,
`read` the index on the invoke and the observed value on the ok
completion, as (i, v), a bare v, or None for a register never written.
"""

from __future__ import annotations

import torch

from ..ops.encode import F_READ, F_WRITE, NIL, EncodeError
from .base import Model


class MultiRegister(Model):
    name = "multi-register"
    packable_states = True

    def __init__(self, n_registers: int = 3, max_value: int = 4):
        self.n_registers = int(n_registers)
        self.max_value = int(max_value)
        self.digit_bits = (self.max_value + 1).bit_length()
        if self.n_registers * self.digit_bits > 30:
            raise ValueError(
                f"multi-register state needs "
                f"{self.n_registers * self.digit_bits} bits "
                f"({self.n_registers} x {self.digit_bits}-bit registers); "
                f"int32 admits 30: shrink n_registers or max_value")
        self.digit_mask = (1 << self.digit_bits) - 1

    def init_state(self) -> int:
        return 0  # every register never written

    def state_bound(self, max_value: int) -> int:
        # Fixed by the geometry, not by the history's values.
        return (1 << (self.n_registers * self.digit_bits)) - 1

    def _check_index(self, i) -> int:
        i = int(i)
        if not 0 <= i < self.n_registers:
            raise EncodeError(
                f"register index {i} outside 0..{self.n_registers - 1}")
        return i

    def _check_value(self, v) -> int:
        v = int(v)
        if not 0 <= v <= self.max_value:
            raise EncodeError(
                f"multi-register value {v} outside 0..{self.max_value}")
        return v

    def encode_invocation(self, f_name, invoke_value, ok_value, status):
        if f_name == "write":
            i, v = invoke_value
            return F_WRITE, self._check_index(i), self._check_value(v), NIL
        if f_name == "read":
            i = (invoke_value[0] if isinstance(invoke_value, (tuple, list))
                 else invoke_value)
            i = self._check_index(i)
            if ok_value is None:
                return F_READ, i, 0, NIL
            v = (ok_value[1] if isinstance(ok_value, (tuple, list))
                 else ok_value)
            return F_READ, i, 0, (NIL if v is None else self._check_value(v))
        raise EncodeError(f"unsupported multi-register op f={f_name!r}")

    def describe_op(self, f, a1, a2, rv):
        if f == F_WRITE:
            return f"write(r{a1} = {a2})"
        if f == F_READ:
            return f"read(r{a1}) -> {'nil' if rv == NIL else rv}"
        return super().describe_op(f, a1, a2, rv)

    def step_py(self, state, f, a1, a2, rv):
        b, m = self.digit_bits, self.digit_mask
        shift = a1 * b
        digit = (state >> shift) & m
        if f == F_READ:
            return (digit == rv + 1, state)
        if f == F_WRITE:
            return (True, (state & ~(m << shift)) | ((a2 + 1) << shift))
        raise ValueError(f"bad f {f}")

    def step(self, state, f, a1, a2, rv):
        b, m = self.digit_bits, self.digit_mask
        shift = a1 * b
        digit = (state >> shift) & m
        is_read = f == F_READ
        is_write = f == F_WRITE
        legal = torch.where(is_read, digit == rv + 1, is_write)
        nxt = torch.where(is_write,
                          (state & ~(m << shift)) | ((a2 + 1) << shift),
                          state)
        return legal, nxt.to(torch.int32)
