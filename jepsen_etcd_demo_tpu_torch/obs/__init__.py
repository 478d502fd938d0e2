"""obs: the metrics the checking daemon keeps and serves.

The part of the JAX package's obs/ the serve path reads:

  * metrics.py - counters, gauges and histograms (MetricsRegistry)
  * export.py  - their Prometheus text exposition (/metrics)
  * health.py  - the healthy/degraded/wedged backend supervisor
                 (/healthz, the daemon's refusal and park)
  * ledger.py  - the rolling-window SLO gauges of the daemon
  * this module - the capture stack: `get_metrics()` returns the active
                  capture's registry, or a registry that records nothing
                  outside a capture, so library calls pay one list read

The JAX package's span tracer, per-run artifacts (telemetry.jsonl,
metrics.json), kernel attribution, scaling ledger and live event bus have
no counterpart in the port yet.

Env vars:
  JEPSEN_TPU_TELEMETRY=0   disable captures (every registry records
                           nothing; /metrics renders the process series
                           only)
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from typing import Iterator

from . import export, health, ledger  # noqa: F401
from .metrics import MetricsRegistry, read_metrics  # noqa: F401

# The serve daemon's well-known keys, registered at zero by every capture
# so /metrics always carries them (the JAX package's SERVE_COUNTERS,
# SERVE_GAUGES, SERVE_HISTOGRAM, SLO_GAUGES and HEALTH_GAUGE, with
# failed_requests in the place of JAX's shed_cpu): admitted requests,
# coalesced batches, requests that shared a batch, requests answered
# with an error verdict because the card failed their batch, refusals (in-flight bound, wedged backend),
# webhook deliveries; the queue depth and batch fill; the request
# latency; the rolling-window SLO; the supervisor's state.
SERVE_COUNTERS = ("serve.requests", "serve.batches",
                  "serve.coalesced_requests", "serve.failed_requests",
                  "serve.rejected_inflight", "serve.rejected_wedged",
                  "serve.webhooks")
SERVE_GAUGES = ("serve.queue_depth", "serve.batch_fill")
SERVE_HISTOGRAM = "serve.request_latency_s"
SLO_GAUGES = ("serve.slo_p50_s", "serve.slo_p99_s",
              "serve.slo_burn_rate")
HEALTH_GAUGE = "health.state"

_NULL_METRICS = MetricsRegistry(enabled=False)


class Capture:
    """One active telemetry scope: a metrics registry with the serve
    keys registered."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.metrics = MetricsRegistry(enabled=enabled)
        if enabled:
            for name in SERVE_COUNTERS:
                self.metrics.counter(name)
            for name in SERVE_GAUGES + SLO_GAUGES + (HEALTH_GAUGE,):
                self.metrics.gauge(name)
            self.metrics.histogram(SERVE_HISTOGRAM)


_lock = threading.Lock()
_stack: list[Capture] = []


def telemetry_enabled() -> bool:
    return os.environ.get("JEPSEN_TPU_TELEMETRY", "1").lower() \
        not in ("0", "false", "no", "off")


def get_metrics() -> MetricsRegistry:
    """The active capture's registry, or a registry that records
    nothing."""
    stack = _stack
    return stack[-1].metrics if stack else _NULL_METRICS


def capture_active() -> bool:
    """True while some capture is installed (the /healthz
    `run_in_flight` field)."""
    return bool(_stack)


@contextmanager
def capture() -> Iterator[Capture]:
    """Install a fresh registry as the active one; on exit restore the
    previous. Nesting shadows: the innermost capture receives the
    records."""
    cap = Capture(enabled=telemetry_enabled())
    if not cap.enabled:
        yield cap
        return
    with _lock:
        _stack.append(cap)
    try:
        yield cap
    finally:
        with _lock:
            if cap in _stack:
                _stack.remove(cap)
