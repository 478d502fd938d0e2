"""Mutex: `acquire` is legal iff unlocked, `release` iff locked.

That is a CAS register over {0 unlocked, 1 locked} with acquire =
cas(0 -> 1) and release = cas(1 -> 0), so the model reuses the CAS step
and adds only the op translation, applied before encoding.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Sequence

from ..ops.encode import F_CAS
from ..ops.op import Op
from .cas_register import CASRegister

UNLOCKED, LOCKED = 0, 1


class Mutex(CASRegister):
    name = "mutex"

    def __init__(self):
        super().__init__(initial=UNLOCKED)

    def describe_op(self, f, a1, a2, rv):
        if f == F_CAS and (a1, a2) == (UNLOCKED, LOCKED):
            return "acquire"
        if f == F_CAS and (a1, a2) == (LOCKED, UNLOCKED):
            return "release"
        return super().describe_op(f, a1, a2, rv)

    def prepare_history(self, history: Sequence[Op]) -> list[Op]:
        out = []
        for op in history:
            if op.f == "acquire":
                out.append(replace(op, f="cas", value=(UNLOCKED, LOCKED)))
            elif op.f == "release":
                out.append(replace(op, f="cas", value=(LOCKED, UNLOCKED)))
            else:
                raise ValueError(
                    f"mutex history may only acquire/release, got {op.f!r}")
        return out
