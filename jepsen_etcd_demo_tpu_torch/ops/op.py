"""Operation records: the atoms of a history.

The op shape is ``{type, f, value, process, time, index, error}``.
Completion semantics (load-bearing for the checker):
  ok    - the op definitely took effect.
  fail  - the op definitely did NOT take effect (excluded from the check).
  info  - indeterminate: may have taken effect at any point after its
          invoke, arbitrarily far in the future ("open forever").

JSONL round trips are byte-compatible with the JAX package's store files.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field, fields
from typing import Any, Optional

INVOKE = "invoke"
OK = "ok"
FAIL = "fail"
INFO = "info"

COMPLETION_TYPES = (OK, FAIL, INFO)


@dataclass
class Op:
    """One history entry: either an invocation or its completion."""

    type: str                      # invoke | ok | fail | info
    f: str                         # read | write | cas | ...
    value: Any = None              # op payload (may be a (key, v) tuple)
    process: Any = None            # logical process id (int) or "nemesis"
    time: int = 0                  # nanoseconds relative to test start
    index: int = -1                # position in the recorded history
    error: Optional[Any] = None    # e.g. "timeout"
    seq: int = -1                  # recorder sequence number; -1 = unset
    extra: dict = field(default_factory=dict)

    def is_invoke(self) -> bool:
        return self.type == INVOKE

    def is_completion(self) -> bool:
        return self.type in COMPLETION_TYPES

    def to_json(self) -> str:
        # A shallow dict in field order: the same JSON as asdict() gives,
        # without its recursive copy (most of a store write's time).
        d = {f: getattr(self, f) for f in _FIELDS}
        if not d["extra"]:
            d.pop("extra")
        if d["seq"] < 0:
            d.pop("seq")
        return json.dumps(d, default=_jsonable)

    @staticmethod
    def from_json(line: str) -> "Op":
        d = json.loads(line)
        d.setdefault("extra", {})
        d.setdefault("seq", -1)
        # JSON turns tuples into lists; 2-lists come back as (key, value)
        # tuples so independent-key histories survive the round trip.
        v = d.get("value")
        if isinstance(v, list) and len(v) == 2:
            d["value"] = tuple(v)
        return Op(**d)


_FIELDS = tuple(f.name for f in fields(Op))


def _jsonable(x):
    if isinstance(x, (set, frozenset)):
        return sorted(x)
    if isinstance(x, tuple):
        return list(x)
    return str(x)


def history_to_jsonl(history: list[Op]) -> str:
    return "\n".join(op.to_json() for op in history) + "\n"


def history_from_jsonl(text: str) -> list[Op]:
    return [Op.from_json(line) for line in text.splitlines() if line.strip()]
