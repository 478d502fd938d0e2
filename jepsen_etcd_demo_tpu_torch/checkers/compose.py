"""checker/compose: run named sub-checkers, merge their validity.

The reference composes {:perf, :indep} at the top
(src/jepsen/etcdemo.clj:165-167) and {:linear, :timeline} per key
(:115-119).
"""

from __future__ import annotations

from typing import Any, Sequence

from ..ops.op import Op
from .base import Checker, merge_valid


class Compose(Checker):
    def __init__(self, checkers: dict[str, Checker]):
        if "valid" in checkers:
            raise ValueError(
                "'valid' is reserved for the merged verdict; rename the "
                "sub-checker")
        self.checkers = dict(checkers)

    def check(self, test: dict, history: Sequence[Op],
              opts: dict | None = None) -> dict[str, Any]:
        results = {name: c.check(test, history, opts)
                   for name, c in self.checkers.items()}
        return {"valid": merge_valid([r.get("valid")
                                      for r in results.values()]),
                **results}
