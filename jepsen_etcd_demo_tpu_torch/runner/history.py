"""History recorder: the one synchronization point of a run.

The recorded history is jepsen's central artifact, an ordered list of
invoke and completion entries with process ids and timestamps. Append
sets the index, a monotonic per-entry `seq` and the relative time. Every
append happens on the run's one event loop, so the order is the loop's
scheduling order: the real-time order the checkers need.

An optional `listener` is called with each entry once it is stamped: the
feed of the streaming check (stream/). It runs on the event loop, so it
must only enqueue; a listener that raises is detached, never allowed to
end the run.
"""

from __future__ import annotations

import itertools
import logging
import time
from typing import Callable, Optional

from ..ops.op import Op

log = logging.getLogger(__name__)


class HistoryRecorder:
    def __init__(self, start_ns: Optional[int] = None,
                 listener: Optional[Callable[[Op], None]] = None):
        self.start_ns = (start_ns if start_ns is not None
                         else time.monotonic_ns())
        self.entries: list[Op] = []
        self.listener = listener
        self._seq = itertools.count()

    def now(self) -> int:
        """Relative ns since test start."""
        return time.monotonic_ns() - self.start_ns

    def append(self, op: Op) -> Op:
        op.index = len(self.entries)
        op.seq = next(self._seq)
        op.time = self.now()
        self.entries.append(op)
        if self.listener is not None:
            try:
                self.listener(op)
            except Exception:
                log.exception("history listener failed; detaching it")
                self.listener = None
        return op

    @property
    def history(self) -> list[Op]:
        return self.entries
