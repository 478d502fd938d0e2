"""History recorder: the one synchronization point of a run.

The recorded history is jepsen's central artifact, an ordered list of
invoke and completion entries with process ids and timestamps. Append
sets the index, a monotonic per-entry `seq` and the relative time. Every
append happens on the run's one event loop, so the order is the loop's
scheduling order: the real-time order the checkers need.
"""

from __future__ import annotations

import itertools
import time
from typing import Optional

from ..ops.op import Op


class HistoryRecorder:
    def __init__(self, start_ns: Optional[int] = None):
        self.start_ns = (start_ns if start_ns is not None
                         else time.monotonic_ns())
        self.entries: list[Op] = []
        self._seq = itertools.count()

    def now(self) -> int:
        """Relative ns since test start."""
        return time.monotonic_ns() - self.start_ns

    def append(self, op: Op) -> Op:
        op.index = len(self.entries)
        op.seq = next(self._seq)
        op.time = self.now()
        self.entries.append(op)
        return op

    @property
    def history(self) -> list[Op]:
        return self.entries
