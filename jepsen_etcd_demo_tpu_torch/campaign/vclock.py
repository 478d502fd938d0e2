"""Virtual-time asyncio: deterministic, instant execution of a real run.

The runner (runner/core.py) is an asyncio interpreter whose only sources
of nondeterminism are the wall clock (the recorder's monotonic clock
drives the stagger, time-limit and sleep generators) and the jitter real
sleeps bring. Replace the clock and both go: this module's loop never
blocks in `select`. Where the loop would sleep until its next timer, it
advances a virtual clock by that much instead, and the recorder reads
the same clock. So

  * a scenario of 30 virtual seconds runs in milliseconds;
  * two runs of the same composed test with the same seed record the
    same history (timers fire in (when, counter) order, the ready queue
    is FIFO, nothing wakes the loop from outside).

The loop is the one `cli test` runs on (runner.event_loop: a selector
loop over select(2)) with its selector wrapped, so every timer of a sim
run is virtual. Only runs with no real I/O qualify: the fake cluster
(clients/fake_kv.py) awaits locks and sleeps only. Live minietcd specs
(campaign/cluster.py) run on a real loop.
"""

from __future__ import annotations

import asyncio
import selectors
from typing import Awaitable, Callable, TypeVar

from ..runner.history import HistoryRecorder

T = TypeVar("T")


class _InstantSelector:
    """A selector that never blocks: a `select(timeout)` that would have
    slept advances the loop's virtual clock by `timeout` and polls
    instead. Registration goes to a real select(2) selector, so the
    loop's self-pipe keeps working."""

    def __init__(self, loop: "VirtualTimeLoop"):
        self._loop = loop
        self._inner = selectors.SelectSelector()

    def select(self, timeout=None):
        if timeout:
            self._loop._vtime += timeout
        return self._inner.select(0)

    def register(self, *a, **kw):
        return self._inner.register(*a, **kw)

    def unregister(self, *a, **kw):
        return self._inner.unregister(*a, **kw)

    def modify(self, *a, **kw):
        return self._inner.modify(*a, **kw)

    def get_map(self):
        return self._inner.get_map()

    def get_key(self, fileobj):
        return self._inner.get_key(fileobj)

    def close(self):
        return self._inner.close()


class VirtualTimeLoop(asyncio.SelectorEventLoop):
    """The runner's selector loop whose `time()` is a virtual clock that
    would-be sleeps advance. Timers (`call_later` and what is built on
    it: asyncio.sleep, wait_for, Condition timeouts) fire in exact
    virtual order with no real delay."""

    def __init__(self):
        self._vtime = 0.0
        super().__init__(_InstantSelector(self))

    def time(self) -> float:
        return self._vtime


class VirtualRecorder(HistoryRecorder):
    """A HistoryRecorder on the virtual loop's clock, so the generators
    see virtual time and the recorded timestamps are deterministic."""

    def __init__(self, loop: VirtualTimeLoop, listener=None):
        super().__init__(start_ns=0, listener=listener)
        self._loop = loop

    def now(self) -> int:
        return int(self._loop.time() * 1e9)


def run_virtual(main: Callable[[VirtualTimeLoop, VirtualRecorder],
                               Awaitable[T]]) -> T:
    """Run `main(loop, recorder)` to its end on a fresh virtual-time loop.
    The loop belongs to this call only, so campaign worker threads each
    drive a scenario of their own at the same time."""
    loop = VirtualTimeLoop()
    recorder = VirtualRecorder(loop)
    try:
        asyncio.set_event_loop(loop)
        return loop.run_until_complete(main(loop, recorder))
    finally:
        asyncio.set_event_loop(None)
        loop.close()
