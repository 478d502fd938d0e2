"""The serve daemon's rolling-window SLO gauges.

Only the part of the JAX package's obs/ledger.py that the checking daemon
reads: the SLO target and error budget, and the time-bounded latency
window behind the `serve.slo_*` gauges. The scaling ledger itself (launch
time attribution, the waterfall) has no counterpart in the port yet.
"""

from __future__ import annotations

import os
import time
from typing import Optional


def slo_target_s() -> float:
    """The serve SLO latency target (p99 threshold) in seconds."""
    try:
        return float(os.environ.get("JEPSEN_TPU_SERVE_SLO_P99_S", "1.0"))
    except ValueError:
        return 1.0


def slo_budget() -> float:
    """The SLO error budget: the tolerated breach fraction (burn rate
    1.0 means breaches exactly consume the budget)."""
    try:
        return float(os.environ.get("JEPSEN_TPU_SERVE_SLO_BUDGET",
                                    "0.01"))
    except ValueError:
        return 0.01


class RollingWindow:
    """A time-bounded latency window: p50/p99 over the last window_s
    seconds (the cumulative request histogram cannot forget, so a
    recovered daemon would wear its worst minute forever) and the burn
    rate, the breach fraction over the error budget."""

    def __init__(self, window_s: float = 60.0, maxlen: int = 4096):
        self.window_s = window_s
        self.maxlen = maxlen
        self._items: list[tuple[float, float]] = []

    def observe(self, value: float, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        self._items.append((now, float(value)))
        self._prune(now)

    def _prune(self, now: float) -> None:
        cut = now - self.window_s
        i = 0
        n = len(self._items)
        while i < n and self._items[i][0] < cut:
            i += 1
        if i or n > self.maxlen:
            self._items = self._items[max(i, n - self.maxlen):]

    def values(self, now: Optional[float] = None) -> list[float]:
        self._prune(time.monotonic() if now is None else now)
        return [v for _, v in self._items]

    def quantiles(self, now: Optional[float] = None) \
            -> tuple[float, float]:
        vals = sorted(self.values(now))
        if not vals:
            return 0.0, 0.0

        def q(p: float) -> float:
            return vals[min(len(vals) - 1, int(p * len(vals)))]

        return q(0.50), q(0.99)

    def burn_rate(self, slo_s: Optional[float] = None,
                  budget: Optional[float] = None,
                  now: Optional[float] = None) -> float:
        vals = self.values(now)
        if not vals:
            return 0.0
        slo = slo_target_s() if slo_s is None else slo_s
        bud = slo_budget() if budget is None else budget
        breach = sum(1 for v in vals if v > slo) / len(vals)
        return round(breach / bud, 4) if bud > 0 else 0.0
