"""Grow-only-set durability checker, the equivalent of `checker/set`.

Concurrent `add` ops, then one final `read` of the whole set. Every
acknowledged add must appear in the final read (else it is lost);
an element read that no add ever attempted is unexpected. Indeterminate
adds that do appear are "recovered", absent ones are not failures.
"""

from __future__ import annotations

from typing import Any, Sequence

from ..ops.op import INFO, INVOKE, OK, Op
from .base import Checker


class SetChecker(Checker):
    def check(self, test: dict, history: Sequence[Op],
              opts: dict | None = None) -> dict[str, Any]:
        attempts: set = set()
        ok_adds: set = set()
        info_adds: set = set()
        final_read = None
        pending: dict[Any, Op] = {}
        for op in history:
            if op.type == INVOKE:
                pending[op.process] = op
                if op.f == "add":
                    attempts.add(op.value)
            else:
                inv = pending.pop(op.process, None)
                if inv is None:
                    continue
                if inv.f == "add":
                    if op.type == OK:
                        ok_adds.add(inv.value)
                    elif op.type == INFO:
                        info_adds.add(inv.value)
                elif inv.f == "read" and op.type == OK:
                    final_read = (set(op.value) if op.value is not None
                                  else None)
        # Adds whose completion never arrived are indeterminate too.
        for inv in pending.values():
            if inv.f == "add":
                info_adds.add(inv.value)

        if final_read is None:
            return {"valid": "unknown", "error": "no final read",
                    "attempt_count": len(attempts), "ok_count": len(ok_adds)}

        lost = ok_adds - final_read
        unexpected = final_read - attempts
        recovered = (final_read & info_adds) - ok_adds
        return {
            "valid": not lost and not unexpected,
            "attempt_count": len(attempts),
            "ok_count": len(ok_adds),
            "lost_count": len(lost),
            "lost": sorted(lost)[:100],
            "unexpected_count": len(unexpected),
            "unexpected": sorted(unexpected)[:100],
            "recovered_count": len(recovered),
        }
