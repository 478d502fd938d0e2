"""The cross-tenant coalescing scheduler: the core of the checking daemon.

A command per client pays every launch alone. The daemon keeps one
scheduler that coalesces concurrent requests from different tenants into
shared bucketed launches of the dense sweep (sched/engine.py), so one
tenant's bucket fill benefits the next.

  * **Coalescing queue**: requests land in per-tenant FIFO queues; the
    dispatch thread wakes on the first arrival, lingers up to
    ``limits().serve_coalesce_ms`` for more (latency against batch
    fill), then drains a batch of up to ``serve_max_batch`` requests
    **round robin** across tenants (one request a tenant a turn), so a
    flooding tenant cannot starve a light one.
  * **Shared bucketed launches**: the batch goes through
    ``sched.submit_corpus`` on the daemon's device; different tenants'
    histories of one step bucket stack into one launch of
    csrc/wgl3_sweep.cu (a batch of one takes the single-history route).
  * **Admission control**: at most ``serve_max_inflight`` admitted,
    unfinished requests a tenant; past it a submission is refused
    (HTTP 429) instead of queueing without bound.
  * **Backpressure from the supervisor** (obs/health.py): ``wedged``
    refuses new work (HTTP 503 + Retry-After) and parks the dispatcher
    (admitted requests drain when the backend recovers). The dispatch
    thread owns the supervisor's active probe, so a parked daemon finds
    its card again. A batch whose launch or read-back raises is answered
    with an error verdict (``route: "error"``, ``valid: null``) and the
    failure is noted; ``degraded`` changes nothing else, and the next
    batch launches on the card again. Nothing is checked on the host: a
    card that fails shows as failed verdicts, never as host verdicts.

Verdicts are those of ``analyze`` on the same histories: the batched path
is the corpus scheduler's. The JAX package's serve/scheduler.py, without
its spans and batch telemetry; its device route is labelled ``"jax"``, and
it sheds degraded or failed batches to its CPU oracle.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from .. import obs
from ..obs import health
from ..ops.limits import limits

log = logging.getLogger(__name__)

# Retry-After seconds of a wedged refusal: long enough for a client to
# back off past a probe cycle, short enough to come back promptly.
RETRY_AFTER_S = 5

# Retry-After seconds of a 429 at the in-flight bound: the bound clears
# as soon as one batch drains.
RETRY_AFTER_INFLIGHT_S = 1

# The route label of a batch checked on the daemon's device.
DEVICE_ROUTE = "torch"

# Most tenants whose recent-latency windows are kept (each window holds
# at most 1024 samples): client-supplied tenant ids must not grow the
# process's state without bound.
TENANT_LATENCY_TENANTS = 256


class Rejected(Exception):
    """A submission the scheduler refused. ``status`` is the HTTP code the
    daemon answers (429 admission bound, 503 wedged, 409 closed session);
    ``retry_after_s`` the Retry-After it advertises, if any."""

    def __init__(self, reason: str, status: int,
                 retry_after_s: Optional[int] = None):
        super().__init__(reason)
        self.reason = reason
        self.status = status
        self.retry_after_s = retry_after_s


@dataclass
class ServeRequest:
    """One admitted check request riding the coalescing queue."""

    tenant: str
    model_name: str
    enc: Any                                   # EncodedHistory
    ops: Optional[list] = None                 # raw Op history (artifacts)
    webhook: Optional[str] = None
    id: str = field(default_factory=lambda: uuid.uuid4().hex)
    submitted_mono: float = field(default_factory=time.monotonic)
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[dict] = None
    error: Optional[str] = None

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self.done.wait(timeout)


class CoalescingScheduler:
    """The dispatcher (module docstring), checking on `device` (None =
    cuda). ``submit`` is called from any number of handler threads;
    everything else happens on the dispatch thread. Shared state is
    guarded by one condition (``_lock``)."""

    def __init__(self, coalesce_ms: Optional[int] = None,
                 max_batch: Optional[int] = None,
                 max_inflight: Optional[int] = None,
                 artifact_sink: Optional[Callable] = None,
                 webhook_sink: Optional[Callable] = None,
                 device=None):
        from ..device import resolve_device

        self.device = resolve_device(device)
        self._coalesce_ms = coalesce_ms
        self._max_batch = max_batch
        self._max_inflight = max_inflight
        # Both sinks run on the dispatch thread once verdicts settle:
        # artifact_sink(requests) writes the store runs,
        # webhook_sink(request) delivers the verdict callback.
        self._artifact_sink = artifact_sink
        self._webhook_sink = webhook_sink
        self._lock = threading.Condition()
        self._queues: dict[str, deque[ServeRequest]] = {}
        self._rotation: deque[str] = deque()    # round-robin turn order
        self._inflight: dict[str, int] = {}
        self._pending = 0
        self._models: dict[str, Any] = {}       # model name -> Model
        self._batch_ids = itertools.count(1)
        self._stop = threading.Event()
        # Written on the dispatch thread under the lock; stats() copies.
        self._batches = 0
        self._requests_done = 0
        self._coalesced_requests = 0
        self._failed_requests = 0
        self._fill_sum = 0.0
        self._tenant_latency: dict[str, deque] = {}
        # Rolling-window SLO gauges: p50/p99 over the last minute and the
        # burn rate, updated by the dispatch thread only.
        self._slo_window = obs.ledger.RollingWindow()
        self._slo = {"slo_p50_s": 0.0, "slo_p99_s": 0.0,
                     "slo_burn_rate": 0.0,
                     "slo_target_s": obs.ledger.slo_target_s()}
        self._thread = threading.Thread(target=self._run,
                                        name="serve-dispatch", daemon=True)
        self._thread.start()

    # -- knobs (resolved late, so set_limits applies) ----------------------
    def coalesce_s(self) -> float:
        ms = self._coalesce_ms if self._coalesce_ms is not None \
            else limits().serve_coalesce_ms
        return max(0.0, ms / 1000.0)

    def max_batch(self) -> int:
        return self._max_batch if self._max_batch is not None \
            else limits().serve_max_batch

    def max_inflight(self) -> int:
        return self._max_inflight if self._max_inflight is not None \
            else limits().serve_max_inflight

    # -- submit side (handler threads) -------------------------------------
    def submit(self, tenant: str, enc, model_name: str = "cas-register",
               ops: Optional[list] = None,
               webhook: Optional[str] = None) -> ServeRequest:
        """Admit one request (or raise :class:`Rejected`). Returns the
        request; await the verdict with ``req.wait()`` / ``req.result``."""
        m = obs.get_metrics()
        sup = health.get_supervisor()
        if sup.snapshot()["state"] == health.WEDGED:
            m.counter("serve.rejected_wedged").add(1)
            raise Rejected(
                "backend wedged; shedding new work "
                f"(retry after {RETRY_AFTER_S}s)", 503,
                retry_after_s=RETRY_AFTER_S)
        req = ServeRequest(tenant=str(tenant), model_name=model_name,
                           enc=enc, ops=ops, webhook=webhook)
        with self._lock:
            if self._inflight.get(req.tenant, 0) >= self.max_inflight():
                m.counter("serve.rejected_inflight").add(1)
                raise Rejected(
                    f"tenant {req.tenant!r} at the in-flight bound "
                    f"({self.max_inflight()}); drain verdicts first", 429,
                    retry_after_s=RETRY_AFTER_INFLIGHT_S)
            q = self._queues.get(req.tenant)
            if q is None:
                q = self._queues[req.tenant] = deque()
                self._rotation.append(req.tenant)
            q.append(req)
            self._inflight[req.tenant] = \
                self._inflight.get(req.tenant, 0) + 1
            self._pending += 1
            depth = self._pending
            self._lock.notify_all()
        m.counter("serve.requests").add(1)
        m.gauge("serve.queue_depth").set(depth)
        return req

    def model_for(self, name: str):
        """The Model instance of a model name, one per name: racing
        callers all get the instance the registry holds."""
        with self._lock:
            mdl = self._models.get(name)
        if mdl is None:
            from ..models import get_model

            mdl = get_model(name)
            with self._lock:
                mdl = self._models.setdefault(name, mdl)
        return mdl

    # -- dispatch thread ---------------------------------------------------
    def _park_while_wedged(self) -> bool:
        """Wait out a wedged backend (admitted work is kept: it drains
        once the supervisor sees a success, which the probe gives). False
        when stopped."""
        sup = health.get_supervisor()
        while sup.snapshot()["state"] == health.WEDGED \
                and not self._stop.is_set():
            sup.maybe_probe(source="serve.dispatch")
            self._stop.wait(0.05)
        return not self._stop.is_set()

    def _run(self) -> None:
        while not self._stop.is_set():
            # The daemon owns the supervisor's active probe: the idle
            # dispatcher runs it when probe_interval_s has passed (one
            # lock and one clock read when it has not).
            health.get_supervisor().maybe_probe(source="serve.dispatch")
            with self._lock:
                if self._pending == 0:
                    self._lock.wait(0.5)
                    continue
            if not self._park_while_wedged():
                return
            # Max-linger: wait for more requests to coalesce, bounded by
            # serve_coalesce_ms.
            deadline = time.monotonic() + self.coalesce_s()
            with self._lock:
                while self._pending < self.max_batch() \
                        and not self._stop.is_set():
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._lock.wait(remaining)
            # Again after the linger: a backend that wedged meanwhile
            # must not receive the batch.
            if not self._park_while_wedged():
                return
            batch = self._drain_batch()
            if batch:
                self._dispatch(batch)

    def _drain_batch(self) -> list[ServeRequest]:
        """Round-robin drain: one queued request a tenant a turn, until the
        batch cap or the queues run dry. Tenants keep their place in the
        rotation across batches."""
        cap = self.max_batch()
        batch: list[ServeRequest] = []
        with self._lock:
            turns_without_progress = 0
            while len(batch) < cap and self._pending > 0 \
                    and turns_without_progress < len(self._rotation):
                tenant = self._rotation[0]
                self._rotation.rotate(-1)
                q = self._queues.get(tenant)
                if q:
                    batch.append(q.popleft())
                    self._pending -= 1
                    turns_without_progress = 0
                else:
                    turns_without_progress += 1
        return batch

    def _dispatch(self, batch: list[ServeRequest]) -> None:
        m = obs.get_metrics()
        batch_id = next(self._batch_ids)
        route = DEVICE_ROUTE
        t0 = time.monotonic()
        error: Optional[str] = None
        try:
            results, kernel = self._check_device(batch)
        except Exception as e:
            # A launch or read-back failed: tell the supervisor and answer
            # every request with an error verdict, its admission slot back
            # and its waiter woken. The dispatch thread must survive.
            error = f"{type(e).__name__}: {e}"
            log.exception("serve batch %s: device route failed", batch_id)
            health.get_supervisor().note_failure(error,
                                                 source="serve.dispatch")
            route = "error"
            kernel = "none"
            results = [{"valid": None, "op_count": int(req.enc.n_ops),
                        "dead_step": -1, "kernel": "none", "error": error}
                       for req in batch]
        wall = time.monotonic() - t0
        fill = len(batch) / self.max_batch()
        now = time.monotonic()
        for req, res in zip(batch, results):
            latency = now - req.submitted_mono
            if error is not None:
                req.error = error
            req.result = {
                **res,
                "request_id": req.id,
                "tenant": req.tenant,
                "model": req.model_name,
                "route": route,
                "kernel": res.get("kernel", kernel),
                "batch": {"id": batch_id, "size": len(batch),
                          "fill": round(fill, 4),
                          "coalesced": len(batch) > 1,
                          "wall_s": round(wall, 4)},
                "latency_s": round(latency, 4),
            }
            m.histogram("serve.request_latency_s").observe(latency)
            self._slo_window.observe(latency, now=now)
            with self._lock:
                lat = self._tenant_latency.setdefault(
                    req.tenant, deque(maxlen=1024))
                lat.append(latency)
        m.counter("serve.batches").add(1)
        if len(batch) > 1:
            m.counter("serve.coalesced_requests").add(len(batch))
        if error is not None:
            m.counter("serve.failed_requests").add(len(batch))
        m.gauge("serve.batch_fill").set(fill)
        # Rolling-window quantiles, not the cumulative histogram: a
        # recovered daemon must not wear its worst minute forever.
        p50, p99 = self._slo_window.quantiles(now=now)
        burn = self._slo_window.burn_rate(now=now)
        m.gauge("serve.slo_p50_s").set(round(p50, 6))
        m.gauge("serve.slo_p99_s").set(round(p99, 6))
        m.gauge("serve.slo_burn_rate").set(burn)
        with self._lock:
            self._batches += 1
            self._slo.update(slo_p50_s=round(p50, 6),
                             slo_p99_s=round(p99, 6),
                             slo_burn_rate=burn)
            self._requests_done += len(batch)
            self._fill_sum += fill
            if len(batch) > 1:
                self._coalesced_requests += len(batch)
            if error is not None:
                self._failed_requests += len(batch)
            for req in batch:
                self._inflight[req.tenant] = \
                    max(0, self._inflight.get(req.tenant, 1) - 1)
                # A tenant with nothing queued and nothing in flight gives
                # its queue and rotation slot back (made again on its
                # next submit).
                if not self._inflight.get(req.tenant) \
                        and not self._queues.get(req.tenant):
                    self._queues.pop(req.tenant, None)
                    self._inflight.pop(req.tenant, None)
                    try:
                        self._rotation.remove(req.tenant)
                    except ValueError:
                        pass
            while len(self._tenant_latency) > TENANT_LATENCY_TENANTS:
                self._tenant_latency.pop(
                    next(iter(self._tenant_latency)))
            m.gauge("serve.queue_depth").set(self._pending)
        # Waiters wake (and webhooks fire) before the store writes: the
        # artifacts' I/O must not ride every request's latency.
        for req in batch:
            req.done.set()
            if req.webhook and self._webhook_sink is not None:
                # Counted before the sink starts its delivery thread: a
                # receiver never sees a delivery the counter has not.
                m.counter("serve.webhooks").add(1)
                self._webhook_sink(req)
        if self._artifact_sink is not None:
            try:
                self._artifact_sink(batch)
            except Exception:
                log.exception("serve artifact sink failed (verdicts "
                              "unaffected)")

    def _check_device(self, batch: list[ServeRequest]
                      ) -> tuple[list[dict], str]:
        """The shared-launch path: one corpus submission a model (the
        tenants' histories stack into the same bucket launches), awaited
        on the corpus executor."""
        from .. import sched

        results: list[Optional[dict]] = [None] * len(batch)
        kernels: set[str] = set()
        by_model: dict[str, list[int]] = {}
        for i, req in enumerate(batch):
            by_model.setdefault(req.model_name, []).append(i)
        for name in sorted(by_model):
            idxs = by_model[name]
            model = self.model_for(name)
            outs, kernel, _stats = sched.submit_corpus(
                [batch[i].enc for i in idxs], model,
                device=self.device).result()
            kernels.add(kernel)
            for i, one in zip(idxs, outs):
                results[i] = {
                    "valid": one.get("valid"),
                    "op_count": int(batch[i].enc.n_ops),
                    "dead_step": int(one.get("dead_step", -1)),
                    "kernel": one.get("kernel", kernel),
                }
        kernel = kernels.pop() if len(kernels) == 1 else "mixed"
        # check_corpus answers one result per input, in order. A missing
        # slot here would put one tenant's verdict on another's request:
        # fail instead (the dispatch handler answers the batch with an
        # error verdict).
        missing = [i for i, r in enumerate(results) if r is None]
        if missing:
            raise RuntimeError(
                f"corpus check returned no result for batch slots "
                f"{missing}: misaligned results would cross tenants")
        return results, kernel

    # -- introspection / lifecycle -----------------------------------------
    def stats(self) -> dict:
        """The /serve/stats view (copied under the lock). `kernel_cache`
        holds the corpus scheduler's launch-shape counts (hits + misses =
        bucket launches of this process)."""
        from ..sched import engine

        with self._lock:
            per_tenant = {
                t: {"inflight": self._inflight.get(t, 0),
                    "queued": len(self._queues.get(t) or ()),
                    "served": len(self._tenant_latency.get(t) or ()),
                    "latency_p50_s": quantile(
                        self._tenant_latency.get(t), 0.50),
                    "latency_p99_s": quantile(
                        self._tenant_latency.get(t), 0.99)}
                for t in sorted(self._queues)}
            out = {
                "pending": self._pending,
                "batches": self._batches,
                "requests_done": self._requests_done,
                "coalesced_requests": self._coalesced_requests,
                "failed_requests": self._failed_requests,
                "batch_fill_avg": round(
                    self._fill_sum / self._batches, 4)
                if self._batches else 0.0,
                "coalesce_ms": int(self.coalesce_s() * 1000),
                "max_batch": self.max_batch(),
                "max_inflight": self.max_inflight(),
                "slo": dict(self._slo),
                "tenants": per_tenant,
            }
        out["kernel_cache"] = engine.shape_stats()
        out["health"] = health.get_supervisor().snapshot()["state"]
        return out

    def tenant_latencies(self) -> dict[str, list[float]]:
        """Per-tenant recent request latencies (bounded), for the /metrics
        tenant-labelled lines."""
        with self._lock:
            return {t: list(d) for t, d in self._tenant_latency.items()}

    def close(self) -> None:
        """Stop the dispatch thread (pending requests keep their queue
        state; a daemon shutdown follows with the process)."""
        self._stop.set()
        with self._lock:
            self._lock.notify_all()
        self._thread.join(timeout=5.0)


def quantile(values, q: float) -> float:
    """Empirical quantile over a bounded latency window: the one copy that
    /serve/stats and the /metrics tenant summaries share."""
    if not values:
        return 0.0
    xs = sorted(values)
    i = min(len(xs) - 1, int(q * len(xs)))
    return round(xs[i], 6)
