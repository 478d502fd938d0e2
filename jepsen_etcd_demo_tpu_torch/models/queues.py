"""Queue models: an unordered bag and a bounded FIFO queue, each state
packed into one int32.

* `UnorderedQueue`: unique elements 0..30; the state is the bitmask of
  the elements queued. Enqueue sets a bit, dequeue requires and clears
  it, in any order. Unique enqueue values are checked before encoding.

* `FIFOQueue`: a queue of at most `capacity` values 0..max_value; the
  state holds one `digit_bits`-wide digit per position, head at the low
  bits, each value stored as v+1 so digit 0 is an empty position. The
  queue is contiguous from the head, so its nonzero digits count its
  length. An enqueue past `capacity` would be illegal and prune a real
  linearization, so a history with more enqueues than `capacity` is
  rejected before encoding.

Indeterminate enqueues stay pending forever. An indeterminate dequeue is
encodable only when its completion recorded the element it claimed: it
stays pending with that value. Without one it is rejected: fixed fields
cannot say "removed an unknown element", and dropping it could accept a
history that is not linearizable.
"""

from __future__ import annotations

import torch

from ..ops.encode import F_DEQ, F_ENQ, NIL, EncodeError
from ..ops.op import INFO, INVOKE
from .base import Model
from .gset import _element_bit, mask_state_bound


def _claimed(ok_value, status):
    """The element a dequeue took: None for a failed one (the encoder
    drops it); raises for an indeterminate one that recorded none."""
    if status == INFO and ok_value is None:
        raise EncodeError(
            "indeterminate dequeue with no claimed value cannot be encoded "
            "soundly; fail it or record the element it claimed")
    return ok_value


class UnorderedQueue(Model):
    name = "unordered-queue"
    packable_states = True

    def init_state(self) -> int:
        return 0  # the empty bag

    def state_bound(self, max_value: int) -> int:
        return mask_state_bound(max_value)

    def prepare_history(self, history):
        seen: set[int] = set()
        for op in history:
            if op.type == INVOKE and op.f == "enqueue":
                v = int(op.value)
                if v in seen:
                    raise EncodeError(
                        f"unordered-queue requires unique enqueue values "
                        f"(duplicate {v}); the bag state is a bitmask")
                seen.add(v)
        return history

    def encode_invocation(self, f_name, invoke_value, ok_value, status):
        if f_name == "enqueue":
            return F_ENQ, _element_bit(invoke_value), 0, NIL
        if f_name == "dequeue":
            v = _claimed(ok_value, status)
            return F_DEQ, 0, 0, NIL if v is None else _element_bit(v)
        raise EncodeError(f"unsupported unordered-queue op f={f_name!r}")

    def describe_op(self, f, a1, a2, rv):
        if f == F_ENQ:
            return f"enqueue({int(a1).bit_length() - 1})"
        if f == F_DEQ:
            return f"dequeue -> {int(rv).bit_length() - 1}"
        return super().describe_op(f, a1, a2, rv)

    def step_py(self, state, f, a1, a2, rv):
        if f == F_ENQ:
            return (True, state | a1)
        if f == F_DEQ:
            return (bool(state & rv), state & ~rv)
        raise ValueError(f"bad f {f}")

    def step(self, state, f, a1, a2, rv):
        is_enq = f == F_ENQ
        is_deq = f == F_DEQ
        legal = torch.where(is_enq, True, is_deq & ((state & rv) != 0))
        nxt = torch.where(is_enq, state | a1,
                          torch.where(is_deq, state & ~rv, state))
        return legal, nxt.to(torch.int32)


class FIFOQueue(Model):
    name = "fifo-queue"
    packable_states = True

    def __init__(self, max_value: int = 4, capacity: int = 10):
        self.max_value = int(max_value)
        self.capacity = int(capacity)
        # v+1 must fit a digit.
        self.digit_bits = (self.max_value + 1).bit_length()
        if self.capacity * self.digit_bits > 30:
            raise ValueError(
                f"fifo-queue state needs {self.capacity * self.digit_bits} "
                f"bits (capacity {self.capacity} x {self.digit_bits}-bit "
                f"digits); int32 admits 30: shrink capacity or max_value")
        self.digit_mask = (1 << self.digit_bits) - 1

    def init_state(self) -> int:
        return 0  # the empty queue

    def state_bound(self, max_value: int) -> int:
        # Fixed by the geometry, not by the history's values.
        return (1 << (self.capacity * self.digit_bits)) - 1

    def _check_value(self, v) -> int:
        v = int(v)
        if not 0 <= v <= self.max_value:
            raise EncodeError(
                f"fifo-queue value {v} outside 0..{self.max_value}")
        return v

    def prepare_history(self, history):
        enqueues = sum(1 for op in history
                       if op.type == INVOKE and op.f == "enqueue")
        if enqueues > self.capacity:
            raise EncodeError(
                f"history has {enqueues} enqueues but fifo-queue capacity "
                f"is {self.capacity}: a linearization could overflow the "
                f"bounded state and be wrongly pruned; raise capacity")
        return history

    def encode_invocation(self, f_name, invoke_value, ok_value, status):
        if f_name == "enqueue":
            return F_ENQ, self._check_value(invoke_value), 0, NIL
        if f_name == "dequeue":
            v = _claimed(ok_value, status)
            return F_DEQ, 0, 0, NIL if v is None else self._check_value(v)
        raise EncodeError(f"unsupported fifo-queue op f={f_name!r}")

    def describe_op(self, f, a1, a2, rv):
        if f == F_ENQ:
            return f"enqueue({a1})"
        if f == F_DEQ:
            return f"dequeue -> {rv}"
        return super().describe_op(f, a1, a2, rv)

    def step_py(self, state, f, a1, a2, rv):
        b, m = self.digit_bits, self.digit_mask
        if f == F_ENQ:
            length = sum(1 for i in range(self.capacity)
                         if (state >> (i * b)) & m)
            if length >= self.capacity:
                return (False, state)
            return (True, state | ((a1 + 1) << (length * b)))
        if f == F_DEQ:
            return ((state & m) == rv + 1, state >> b)
        raise ValueError(f"bad f {f}")

    def step(self, state, f, a1, a2, rv):
        b, m, cap = self.digit_bits, self.digit_mask, self.capacity
        is_enq = f == F_ENQ
        is_deq = f == F_DEQ
        # The states stay below 2^30, so int32's arithmetic >> is exact.
        length = sum((((state >> (i * b)) & m) != 0).to(torch.int32)
                     for i in range(cap))
        can_enq = is_enq & (length < cap)
        # Clamped, so the discarded append at length == cap stays in-word.
        enq_state = state | ((a1 + 1) << (length.clamp(max=cap - 1) * b))
        can_deq = is_deq & ((state & m) == rv + 1)
        nxt = torch.where(can_enq, enq_state,
                          torch.where(is_deq, state >> b, state))
        return can_enq | can_deq, nxt.to(torch.int32)
