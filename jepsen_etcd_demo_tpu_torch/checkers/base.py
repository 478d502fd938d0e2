"""The Checker seam: check(test, history, opts) -> {"valid": ...}.

`valid` is tri-state like jepsen's: True, False, or "unknown".
"""

from __future__ import annotations

import abc
from typing import Any, Sequence

from ..ops.op import Op


class Checker(abc.ABC):
    @abc.abstractmethod
    def check(self, test: dict, history: Sequence[Op],
              opts: dict | None = None) -> dict[str, Any]:
        """Return at least {"valid": True|False|"unknown"}."""


def merge_valid(vs: list) -> Any:
    """jepsen's validity merge: all true -> true; any false -> false;
    otherwise unknown."""
    if any(v is False for v in vs):
        return False
    if all(v is True for v in vs):
        return True
    return "unknown"
