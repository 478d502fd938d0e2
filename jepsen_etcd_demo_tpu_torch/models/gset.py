"""Grow-only set: every read must observe exactly the adds linearized
before it.

The set over elements 0..30 is its int32 characteristic bitmask:

  add(v)  - always legal; state' = state | (1 << v)
  read(S) - legal iff state == bitmask(S)

With the gset workload's values 0..4 the state space is 32 states, one
row of the dense table each. Op language: `add` carries the element on
the invoke, `read` the observed collection on the ok completion.
Indeterminate reads are dropped by the encoder; indeterminate adds stay
pending forever.
"""

from __future__ import annotations

import torch

from ..ops.encode import F_ADD, F_READ, NIL, EncodeError
from .base import Model

MAX_ELEMENT = 30  # bit 31 would flip the int32 sign


def _element_bit(v) -> int:
    v = int(v)
    if not 0 <= v <= MAX_ELEMENT:
        raise EncodeError(
            f"gset elements must be in 0..{MAX_ELEMENT} (got {v}); the set "
            f"state is an int32 bitmask")
    return 1 << v


def mask_state_bound(max_value: int) -> int:
    """State bound of a model whose states are ORs of element bits, each
    at most `max_value` (the largest encoded field): all ones up to its
    bit width. Not max_value itself: adds of 0 and 4 give masks 1 and 16
    but state 17."""
    return (1 << max(int(max_value), 1).bit_length()) - 1


class GSet(Model):
    name = "gset"
    packable_states = True

    def init_state(self) -> int:
        return 0  # the empty set

    def state_bound(self, max_value: int) -> int:
        return mask_state_bound(max_value)

    def encode_invocation(self, f_name, invoke_value, ok_value, status):
        if f_name == "add":
            return F_ADD, _element_bit(invoke_value), 0, NIL
        if f_name == "read":
            if ok_value is None:
                return F_READ, 0, 0, NIL
            mask = 0
            for v in ok_value:
                mask |= _element_bit(v)
            return F_READ, 0, 0, mask
        raise EncodeError(f"unsupported gset op f={f_name!r}")

    def describe_op(self, f, a1, a2, rv):
        if f == F_ADD:
            return f"add({int(a1).bit_length() - 1})"
        if f == F_READ:
            els = [i for i in range(MAX_ELEMENT + 1) if int(rv) >> i & 1]
            return f"read -> {{{', '.join(map(str, els))}}}"
        return super().describe_op(f, a1, a2, rv)

    def step_py(self, state, f, a1, a2, rv):
        if f == F_ADD:
            return (True, state | a1)
        if f == F_READ:
            return (state == rv, state)
        raise ValueError(f"bad f {f}")

    def step(self, state, f, a1, a2, rv):
        is_add = f == F_ADD
        legal = torch.where(is_add, True, (f == F_READ) & (state == rv))
        nxt = torch.where(is_add, state | a1, state)
        return legal, nxt.to(torch.int32)
