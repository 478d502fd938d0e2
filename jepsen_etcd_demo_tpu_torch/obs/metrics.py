"""Metrics registry: counters, gauges, histograms (standard library only).

The JAX package's obs/metrics.py: bounded-memory running aggregates that
the checking daemon (serve/) keeps and /metrics exposes. Every instrument
is a fixed-size record (a counter is one float, a gauge tracks
last/min/max, a histogram count/sum/min/max and a fixed log-bucket sketch
for quantiles), so an update costs one lock and a few float operations.

Naming convention (dotted, lowercase): `<layer>.<what>[_<unit>]`, e.g.
`serve.requests`, `serve.request_latency_s`.

snapshot() schema:
  counter   {"type": "counter", "value": f}
  gauge     {"type": "gauge", "last": f|null, "min": f|null, "max": f|null,
             "n": int}
  histogram {"type": "histogram", "count": int, "sum": f, "min": f|null,
             "max": f|null, "avg": f|null,
             "p50": f|null, "p95": f|null, "p99": f|null}

The quantiles come from a log-bucket sketch of base 1.1 (about 5%
relative error): an observation lands in bucket floor(log(v)/log(1.1)),
clamped to a bounded index range, so the sketch's memory is bounded by
the value range, never by the number of observations. Every instrument
notes its name in the registry's dirty set on update (drain_dirty).
"""

from __future__ import annotations

import json
import math
import threading
from pathlib import Path
from typing import Optional

# Log-bucket geometry for histogram quantiles: base 1.1 gives ~±4.9%
# relative error; indices clamped so memory stays bounded for any input
# (index 400 covers up to ~5e16, -400 down to ~2e-17).
_LN_BASE = math.log(1.1)
_BUCKET_LO, _BUCKET_HI = -400, 400
QUANTILES = (0.5, 0.95, 0.99)


class Counter:
    __slots__ = ("_lock", "_dirty", "name", "value")

    def __init__(self, lock: threading.Lock, name: str = "",
                 dirty: Optional[set] = None):
        # The registry's ONE lock, injected so a snapshot pass and the
        # writers serialize on the same object.
        self._lock = lock
        self._dirty = dirty
        self.name = name
        self.value = 0.0

    def add(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n
            if self._dirty is not None:
                self._dirty.add(self.name)

    def snapshot(self) -> dict:
        # Under the lock: /metrics scrapes run on handler threads while
        # the dispatch thread writes.
        with self._lock:
            return {"type": "counter", "value": self.value}


class Gauge:
    __slots__ = ("_lock", "_dirty", "name", "last", "min", "max", "n")

    def __init__(self, lock: threading.Lock, name: str = "",
                 dirty: Optional[set] = None):
        self._lock = lock
        self._dirty = dirty
        self.name = name
        self.last: Optional[float] = None
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.n = 0

    def set(self, v: float) -> None:
        with self._lock:
            v = float(v)
            self.last = v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            self.n += 1
            if self._dirty is not None:
                self._dirty.add(self.name)

    def snapshot(self) -> dict:
        # Snapshot-under-lock (see Counter.snapshot): a torn
        # last/min/max triple would mix two updates on one row.
        with self._lock:
            return {"type": "gauge", "last": self.last, "min": self.min,
                    "max": self.max, "n": self.n}


class Histogram:
    __slots__ = ("_lock", "_dirty", "name", "count", "sum", "min", "max",
                 "_buckets", "_nonpos")

    def __init__(self, lock: threading.Lock, name: str = "",
                 dirty: Optional[set] = None):
        self._lock = lock
        self._dirty = dirty
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._buckets: dict[int, int] = {}
        self._nonpos = 0

    def observe(self, v: float) -> None:
        with self._lock:
            v = float(v)
            self.count += 1
            self.sum += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            if v > 0.0:
                i = int(math.floor(math.log(v) / _LN_BASE))
                i = min(_BUCKET_HI, max(_BUCKET_LO, i))
                self._buckets[i] = self._buckets.get(i, 0) + 1
            else:
                self._nonpos += 1
            if self._dirty is not None:
                self._dirty.add(self.name)

    def _quantile(self, q: float) -> Optional[float]:
        """Sketch estimate for quantile q (caller holds the lock)."""
        if self.count == 0:
            return None
        target = max(1, math.ceil(q * self.count))
        cum = self._nonpos
        if cum >= target:
            # The quantile falls among the <=0 observations; min is the
            # best (and only) order statistic kept for them.
            return self.min
        for i in sorted(self._buckets):
            cum += self._buckets[i]
            if cum >= target:
                rep = math.exp((i + 0.5) * _LN_BASE)   # geometric mid
                rep = max(rep, self.min) if self.min is not None else rep
                rep = min(rep, self.max) if self.max is not None else rep
                return rep
        return self.max

    def snapshot(self) -> dict:
        with self._lock:
            out = {"type": "histogram", "count": self.count,
                   "sum": self.sum, "min": self.min, "max": self.max,
                   "avg": (self.sum / self.count) if self.count else None}
            for q in QUANTILES:
                out[f"p{int(q * 100)}"] = self._quantile(q)
        return out


class _NullInstrument:
    """Accepts every instrument method, stores nothing — what the
    disabled registry hands out so call sites never branch."""

    def add(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass


_NULL_INSTRUMENT = _NullInstrument()


class MetricsRegistry:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}
        self._dirty: set[str] = set()

    def _get(self, name: str, cls):
        if not self.enabled:
            return _NULL_INSTRUMENT
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(self._lock, name=name,
                                              dirty=self._dirty)
                self._dirty.add(name)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    # -- reading ----------------------------------------------------------

    def snapshot(self) -> dict[str, dict]:
        with self._lock:
            items = list(self._metrics.items())
        return {name: m.snapshot() for name, m in sorted(items)}

    def drain_dirty(self) -> dict[str, dict]:
        """Snapshot of every instrument updated since the last drain,
        clearing the dirty set."""
        with self._lock:
            names = [n for n in self._dirty if n in self._metrics]
            insts = [self._metrics[n] for n in names]
            self._dirty.clear()
        return {n: m.snapshot() for n, m in zip(names, insts)}

    def value(self, name: str, default: float = 0.0) -> float:
        """Scalar view for consumers that just want a number: a counter's
        value, a gauge's last, a histogram's sum. Read under the shared
        lock the instruments write under."""
        with self._lock:
            m = self._metrics.get(name)
            if isinstance(m, Counter):
                return m.value
            if isinstance(m, Gauge):
                return m.last if m.last is not None else default
            if isinstance(m, Histogram):
                return m.sum
        return default

    def to_json(self) -> str:
        return json.dumps({"metrics": self.snapshot()}, indent=2) + "\n"

    def write(self, path: str | Path) -> None:
        Path(path).write_text(self.to_json())


def read_metrics(path: str | Path) -> dict[str, dict]:
    """Load a metrics.json back into its snapshot dict."""
    return json.loads(Path(path).read_text())["metrics"]
