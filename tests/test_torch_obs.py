"""The port's obs/ (metrics registry, Prometheus exposition, backend health
supervisor, rolling SLO window, capture stack) against the JAX package's,
and the passive health signals of the port's hot paths."""

from __future__ import annotations

import random
import time

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from jepsen_etcd_demo_tpu import obs as jobs
from jepsen_etcd_demo_tpu.obs import export as jexport
from jepsen_etcd_demo_tpu.obs import health as jhealth
from jepsen_etcd_demo_tpu.obs import ledger as jledger
from jepsen_etcd_demo_tpu.obs import metrics as jmetrics
from jepsen_etcd_demo_tpu.ops import limits as jlimits
from jepsen_etcd_demo_tpu_torch import obs as pobs
from jepsen_etcd_demo_tpu_torch.checkers import Linearizable
from jepsen_etcd_demo_tpu_torch.obs import export as pexport
from jepsen_etcd_demo_tpu_torch.obs import health as phealth
from jepsen_etcd_demo_tpu_torch.obs import ledger as pledger
from jepsen_etcd_demo_tpu_torch.obs import metrics as pmetrics
from jepsen_etcd_demo_tpu_torch.ops import limits as plimits
from jepsen_etcd_demo_tpu_torch.utils import fuzz as pfuzz

# Metric names: plain ones and members of the labelled families.
NAMES = ("serve.requests", "serve.batch_fill", "serve.request_latency_s",
         "health.state", "wgl.compile_s", "wgl.compile_s.wgl3-chunk",
         "wgl.execute_s.a\"b", "tune.chosen.knob\\x", "ledger.bucket_s.h2d_s",
         "3d.odd-name", "sched.steps_real")
values = st.floats(min_value=-1e6, max_value=1e9, allow_nan=False,
                   allow_infinity=False)
updates = st.lists(st.tuples(st.sampled_from(NAMES),
                             st.sampled_from(("counter", "gauge",
                                              "histogram")),
                             values), max_size=40)


def _apply(reg, ops):
    """The same instrument updates on a registry (a name keeps the kind it
    was first given)."""
    kinds = {}
    for name, kind, v in ops:
        kind = kinds.setdefault(name, kind)
        if kind == "counter":
            reg.counter(name).add(v)
        elif kind == "gauge":
            reg.gauge(name).set(v)
        else:
            reg.histogram(name).observe(v)


@settings(max_examples=60, deadline=None)
@given(updates)
def test_registry_snapshot_and_exposition_equal_jax(ops):
    """Same updates -> the same snapshot, and render_prometheus gives the
    same bytes (extra lines included)."""
    j, p = jmetrics.MetricsRegistry(), pmetrics.MetricsRegistry()
    _apply(j, ops)
    _apply(p, ops)
    assert p.snapshot() == j.snapshot()
    extra = ["# TYPE jepsen_tpu_up gauge", "jepsen_tpu_up 1"]
    assert pexport.render_prometheus(p.snapshot(), extra_lines=extra) \
        == jexport.render_prometheus(j.snapshot(), extra_lines=extra)
    for name in NAMES:
        assert p.value(name, -1.0) == j.value(name, -1.0)
    assert p.drain_dirty() == j.drain_dirty()


@pytest.mark.parametrize("text", ["serve.requests", "wgl.compile_s.x-y",
                                  "9lives", "a b\tc", "", "ünï"])
def test_sanitizers_equal_jax(text):
    assert pexport.sanitize_metric_name(text) \
        == jexport.sanitize_metric_name(text)
    assert pexport.sanitize_label_value(text + '"\\\n') \
        == jexport.sanitize_label_value(text + '"\\\n')
    assert pexport.PROM_CONTENT_TYPE == jexport.PROM_CONTENT_TYPE


def test_disabled_registry_records_nothing_and_kind_clash_raises():
    off = pmetrics.MetricsRegistry(enabled=False)
    off.counter("a").add(1)
    off.histogram("b").observe(2)
    assert off.snapshot() == {}
    on = pmetrics.MetricsRegistry()
    on.counter("a")
    with pytest.raises(TypeError):
        on.gauge("a")


def test_read_metrics_round_trip(tmp_path):
    reg = pmetrics.MetricsRegistry()
    _apply(reg, [("serve.requests", "counter", 3.0),
                 ("serve.request_latency_s", "histogram", 0.25)])
    reg.write(tmp_path / "metrics.json")
    assert pmetrics.read_metrics(tmp_path / "metrics.json") \
        == jmetrics.read_metrics(tmp_path / "metrics.json") \
        == reg.snapshot()


# -- the capture stack --------------------------------------------------------

def test_capture_enables_the_registry_only_inside(monkeypatch):
    assert not pobs.capture_active()
    assert pobs.get_metrics().enabled is False
    with pobs.capture() as outer:
        assert pobs.capture_active() and pobs.get_metrics() is outer.metrics
        with pobs.capture() as inner:
            assert pobs.get_metrics() is inner.metrics
        assert pobs.get_metrics() is outer.metrics
        snap = outer.metrics.snapshot()
    assert not pobs.capture_active()
    # The serve keys the JAX capture registers are there at zero, with
    # failed requests in the place of the JAX daemon's CPU shed.
    with jobs.capture() as jcap:
        jsnap = jcap.metrics.snapshot()
    jsnap["serve.failed_requests"] = jsnap.pop("serve.shed_cpu")
    assert set(snap) <= set(jsnap)
    assert {k for k in jsnap if k.startswith("serve.")} | {"health.state"} \
        == set(snap)
    assert all(snap[k] == jsnap[k] for k in snap)
    monkeypatch.setenv("JEPSEN_TPU_TELEMETRY", "0")
    assert pobs.telemetry_enabled() is jobs.telemetry_enabled() is False
    with pobs.capture():
        assert not pobs.capture_active()


# -- the rolling SLO window ---------------------------------------------------

@settings(max_examples=60, deadline=None)
@given(st.lists(st.tuples(st.floats(0, 200), st.floats(0, 5)),
                max_size=60),
       st.floats(1, 120), st.integers(1, 50))
def test_rolling_window_equals_jax(samples, window_s, maxlen):
    j = jledger.RollingWindow(window_s=window_s, maxlen=maxlen)
    p = pledger.RollingWindow(window_s=window_s, maxlen=maxlen)
    now = 0.0
    for dt, v in samples:
        now += dt
        j.observe(v, now=now)
        p.observe(v, now=now)
        assert p.quantiles(now=now) == j.quantiles(now=now)
        assert p.burn_rate(now=now) == j.burn_rate(now=now)
        assert p.burn_rate(slo_s=0.5, budget=0.1, now=now) \
            == j.burn_rate(slo_s=0.5, budget=0.1, now=now)


def test_slo_knobs_equal_jax(monkeypatch):
    assert pledger.slo_target_s() == jledger.slo_target_s() == 1.0
    monkeypatch.setenv("JEPSEN_TPU_SERVE_SLO_P99_S", "0.25")
    monkeypatch.setenv("JEPSEN_TPU_SERVE_SLO_BUDGET", "bad")
    assert pledger.slo_target_s() == jledger.slo_target_s() == 0.25
    assert pledger.slo_budget() == jledger.slo_budget() == 0.01


# -- the backend supervisor ---------------------------------------------------

SIGNALS = ("ok", "fail", "wedge", "probe_ok", "probe_fail", "probe_hang")


def _drive(health_mod, steps, fail_degraded, fail_wedged):
    """The state after each step of one signal sequence."""
    outcomes = iter([s for s in steps if s.startswith("probe")])

    def probe():
        s = next(outcomes)
        return (s == "probe_ok", f"probe said {s}", s == "probe_hang")

    sup = health_mod.BackendSupervisor(
        probe=probe, fail_degraded=fail_degraded, fail_wedged=fail_wedged,
        probe_timeout_s=5.0, probe_interval_s=3600.0)
    seen = []
    for s in steps:
        if s == "ok":
            sup.note_ok(source="t")
        elif s == "fail":
            sup.note_failure("boom", source="t")
        elif s == "wedge":
            sup.note_failure("hang", source="t", wedged=True)
        else:
            sup.probe(source="t")
        snap = sup.snapshot()
        for k in ("since",):
            snap.pop(k)
        if snap["last_transition"]:
            snap["last_transition"].pop("at")
        seen.append(snap)
    return seen


@settings(max_examples=80, deadline=None)
@given(st.lists(st.sampled_from(SIGNALS), max_size=25),
       st.integers(1, 3), st.integers(1, 5))
def test_supervisor_transitions_equal_jax(steps, fail_degraded, extra):
    args = (steps, fail_degraded, fail_degraded + extra - 1)
    assert _drive(phealth, *args) == _drive(jhealth, *args)


def test_state_levels_and_env_knobs_equal_jax(monkeypatch):
    assert phealth.STATE_LEVEL == jhealth.STATE_LEVEL
    monkeypatch.setenv("JEPSEN_TPU_HEALTH_FAIL_DEGRADED", "2")
    monkeypatch.setenv("JEPSEN_TPU_HEALTH_FAIL_WEDGED", "1")
    monkeypatch.setenv("JEPSEN_TPU_HEALTH_PROBE_INTERVAL_S", "7")
    monkeypatch.setenv("JEPSEN_TPU_HEALTH_PROBE_TIMEOUT_S", "x")
    got = phealth.BackendSupervisor().snapshot()["thresholds"]
    assert got == jhealth.BackendSupervisor().snapshot()["thresholds"]
    assert got == {"fail_degraded": 2, "fail_wedged": 2,
                   "probe_timeout_s": 240.0, "probe_interval_s": 7.0}


def test_transition_sets_the_health_gauge():
    sup = phealth.BackendSupervisor(probe=lambda: (True, "", False),
                                    probe_interval_s=3600.0)
    with pobs.capture() as cap:
        sup.note_failure("x", source="t", wedged=True)
        assert cap.metrics.value("health.state") == 2
        sup.note_ok(source="t")
        assert cap.metrics.value("health.state") == 0


def test_maybe_probe_is_rate_limited_and_can_be_disabled(monkeypatch):
    calls = []
    sup = phealth.BackendSupervisor(
        probe=lambda: calls.append(1) or (True, "", False),
        probe_interval_s=3600.0)
    assert sup.maybe_probe() is None and not calls
    sup.probe_interval_s = 0.0
    monkeypatch.setenv("JEPSEN_TPU_HEALTH_PROBE", "0")
    assert sup.maybe_probe() is None and not calls
    monkeypatch.delenv("JEPSEN_TPU_HEALTH_PROBE")
    assert sup.maybe_probe() is True and calls == [1]
    assert sup.snapshot()["probes_run"] == 1


def test_get_and_reset_supervisor():
    mine = phealth.BackendSupervisor(probe=lambda: (True, "", False))
    prev = phealth.reset_supervisor(mine)
    try:
        assert phealth.get_supervisor() is mine
        phealth.reset_supervisor(None)
        fresh = phealth.get_supervisor()
        assert fresh is not mine and fresh.state == phealth.HEALTHY
    finally:
        phealth.reset_supervisor(prev)


def test_probe_checks_on_the_device_in_a_subprocess():
    """(ok, reason, timed_out): a check on the host passes; on a box with
    no card the cuda probe fails fast (not a hang); a probe past its
    timeout is the wedged signature, named by TIMEOUT_MARKER."""
    assert phealth.probe_backend(timeout_s=240, device="cpu") \
        == (True, "", False)
    ok, reason, timed_out = phealth.probe_backend(timeout_s=0.01,
                                                  device="cpu")
    assert (ok, timed_out) == (False, True)
    assert phealth.TIMEOUT_MARKER in reason
    if torch.cuda.is_available():
        return
    ok, reason, timed_out = phealth.probe_backend(timeout_s=240)
    assert (ok, timed_out) == (False, False)
    assert "CUDA is not available" in reason


def test_serve_limits_equal_jax():
    j, p = jlimits.KernelLimits(), plimits.KernelLimits()
    for f in ("serve_coalesce_ms", "serve_max_batch", "serve_max_inflight"):
        assert getattr(p, f) == getattr(j, f), f


# -- passive signals of the hot paths ----------------------------------------

@pytest.fixture
def quiet_supervisor():
    sup = phealth.BackendSupervisor(probe=lambda: (True, "", False),
                                    probe_interval_s=3600.0)
    prev = phealth.reset_supervisor(sup)
    yield sup
    phealth.reset_supervisor(prev)


def _encs(n, seed=0):
    lin = Linearizable(device="cpu")
    rng = random.Random(seed)
    return lin.encode, [lin.encode(pfuzz.gen_register_history(
        rng, n_ops=30, n_procs=4, p_info=0.0)) for _ in range(n)]


def test_check_corpus_notes_read_back(quiet_supervisor, monkeypatch):
    from jepsen_etcd_demo_tpu_torch.sched import check_corpus, engine

    _enc, encs = _encs(3)
    check_corpus(encs, device="cpu")
    assert quiet_supervisor.snapshot()["ok_total"] == 1
    # A read-back that raises is noted as a failure, then propagates.
    monkeypatch.setattr(engine, "launch_bucket",
                        lambda model, cfg, steps, r, dev: torch.empty(
                            (len(steps), 5), dtype=torch.int32,
                            device="meta"))
    with pytest.raises(NotImplementedError):
        check_corpus(encs, device="cpu")
    snap = quiet_supervisor.snapshot()
    assert snap["fail_total"] == 1 and snap["state"] == phealth.DEGRADED
    assert "NotImplementedError" in snap["last_failure"]


def test_stream_consumer_notes_launches(quiet_supervisor, monkeypatch):
    from jepsen_etcd_demo_tpu_torch.models import CASRegister
    from jepsen_etcd_demo_tpu_torch.ops import wgl3_kernels as wk
    from jepsen_etcd_demo_tpu_torch.stream import StreamSession

    h = pfuzz.gen_register_history(random.Random(5), n_ops=200, n_procs=4,
                                   p_info=0.0)
    for i, op in enumerate(h):
        op.seq = i
    prev = plimits.set_limits(plimits.KernelLimits(stream_flush_ops=16))
    try:
        s = StreamSession(CASRegister(), keyed=False, device="cpu")
        for op in h:
            s.feed(op)
        assert s.finalize()
        oks = quiet_supervisor.snapshot()["ok_total"]
        assert oks == s.stats()["chunks"] > 1

        def boom(*a, **k):
            raise RuntimeError("synthetic launch failure")

        monkeypatch.setattr(wk, "stream_chunk", boom)
        s = StreamSession(CASRegister(), keyed=False, device="cpu")
        for op in h:
            s.feed(op)
        assert s.finalize() is None
    finally:
        plimits.set_limits(prev)
    snap = quiet_supervisor.snapshot()
    assert snap["fail_total"] == 1
    assert "synthetic launch failure" in snap["last_failure"]


def test_runner_check_phase_notes_ok(quiet_supervisor, tmp_path):
    import asyncio

    from jepsen_etcd_demo_tpu_torch.compose import fake_test
    from jepsen_etcd_demo_tpu_torch.runner import run_test

    quiet_supervisor.note_failure("earlier", source="t")
    test = fake_test({"workload": "register", "time_limit": 0.5,
                      "rate": 100.0, "concurrency": 4, "no_nemesis": True,
                      "recovery_wait": 0.05, "seed": 3, "device": "cpu",
                      "store_root": str(tmp_path / "store")})
    t0 = time.monotonic()
    assert asyncio.run(run_test(test))["valid"] is True
    assert time.monotonic() - t0 < 120
    snap = quiet_supervisor.snapshot()
    assert snap["state"] == phealth.HEALTHY
    assert snap["last_transition"]["source"] in ("runner.check",
                                                 "sched.dispatch")
