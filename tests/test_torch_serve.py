"""The port's checking daemon (serve/) against the JAX package's: the
coalescing scheduler's behaviour on the same scripts, the served verdicts
over HTTP (single-shot, polled, streaming sessions, mutants), the
/serve/stats, /healthz and /metrics surfaces, `cli serve --check` as a
subprocess, and concurrent sessions and requests. The port runs on the
CPU (device="cpu", the kernels' plain versions); every compared field is
a bool, an int or a string, so the comparisons are exact."""

from __future__ import annotations

import json
import os
import random
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from jepsen_etcd_demo_tpu import obs as jobs
from jepsen_etcd_demo_tpu import sched as jsched
from jepsen_etcd_demo_tpu import serve as jserve
from jepsen_etcd_demo_tpu.checkers import Linearizable as JLin
from jepsen_etcd_demo_tpu.obs import health as jhealth
from jepsen_etcd_demo_tpu.utils import fuzz as jfuzz
from jepsen_etcd_demo_tpu_torch import cli
from jepsen_etcd_demo_tpu_torch import obs as pobs
from jepsen_etcd_demo_tpu_torch import sched as psched
from jepsen_etcd_demo_tpu_torch import serve as pserve
from jepsen_etcd_demo_tpu_torch.checkers import Linearizable as PLin
from jepsen_etcd_demo_tpu_torch.checkers.oracle import check_events_oracle
from jepsen_etcd_demo_tpu_torch.obs import health as phealth
from jepsen_etcd_demo_tpu_torch.store import Store
from jepsen_etcd_demo_tpu_torch.utils import fuzz as pfuzz

from torch_port_util import fuzz_pair

ROOT = Path(__file__).resolve().parent.parent
VERDICT = ("valid", "dead_step", "op_count")

JAX = SimpleNamespace(name="jax", serve=jserve, health=jhealth, obs=jobs,
                      sched=jsched, route="jax",
                      encode=lambda h: JLin().encode(h),
                      daemon=lambda root, **kw: jserve.ServeDaemon(
                          store_root=root, **kw))
PORT = SimpleNamespace(name="port", serve=pserve, health=phealth, obs=pobs,
                       sched=psched, route="torch",
                       encode=lambda h: PLin(device="cpu").encode(h),
                       daemon=lambda root, **kw: pserve.ServeDaemon(
                           store_root=root, device="cpu", **kw))
PKGS = (JAX, PORT)


def _fake_supervisor(health, **kw):
    return health.BackendSupervisor(probe=lambda: (True, "", False),
                                    probe_interval_s=3600.0, **kw)


@pytest.fixture
def healthy_supervisor():
    """Fresh supervisors with active probing off in both packages: no test
    inherits another's degraded state or pays a probe subprocess.
    Yields {package name: supervisor}."""
    sups = {p.name: _fake_supervisor(p.health) for p in PKGS}
    prev = {p.name: p.health.reset_supervisor(sups[p.name]) for p in PKGS}
    try:
        yield sups
    finally:
        for p in PKGS:
            p.health.reset_supervisor(prev[p.name])


def _pair_histories(n, n_ops=40, seed=0, mutant_every=3):
    """n histories from both packages' generators (JAX Ops, port Ops);
    every `mutant_every`-th is a mutant."""
    out = []
    for i in range(n):
        out.append(fuzz_pair(seed + i, n_ops=n_ops, n_procs=5,
                             p_info=0.02,
                             mutate=(i % mutant_every == mutant_every - 1)))
    return out


def _op_dicts(hist):
    return [json.loads(op.to_json()) for op in hist]


def _verdict(res: dict) -> tuple:
    return tuple(res.get(f) for f in VERDICT)


# -- the scheduler, script by script ----------------------------------------

def _run_script(pkg, script, **sched_kw):
    s = pkg.serve.CoalescingScheduler(
        **sched_kw, **({"device": "cpu"} if pkg is PORT else {}))
    try:
        with pkg.obs.capture() as cap:
            out = script(pkg, s)
            metrics = cap.metrics.snapshot()
    finally:
        s.close()
    return out, {k: v["value"] for k, v in metrics.items()
                 if k.startswith("serve.") and v["type"] == "counter"}


def _as_port_counters(jm: dict) -> dict:
    """JAX's serve counters under the port's names: the port counts
    failed requests where JAX counts its CPU shed (ROADMAP C); on traffic
    that neither fails nor sheds both are zero."""
    return {("serve.failed_requests" if k == "serve.shed_cpu" else k): v
            for k, v in jm.items()}


def _coalesce(pkg, s):
    hists = [pair[pkg is PORT] for pair in _pair_histories(8, seed=10)]
    reqs = [None] * 8

    def client(t):
        for i in range(t, 8, 2):
            reqs[i] = s.submit(f"t{t}", pkg.encode(hists[i]),
                               model_name="cas-register")

    ts = [threading.Thread(target=client, args=(t,)) for t in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    for r in reqs:
        assert r.wait(120), "verdict timed out"
    return [(_verdict(r.result), r.result["batch"]["size"],
             r.result["batch"]["coalesced"], r.result["route"])
            for r in reqs]


def _fair(pkg, s):
    e = pkg.encode(_pair_histories(1, seed=20)[0][pkg is PORT])
    flood = [s.submit("flood", e) for _ in range(12)]
    light = s.submit("light", e)
    for r in flood + [light]:
        assert r.wait(120)
    return [r.result["batch"]["id"] for r in flood + [light]]


def _admission(pkg, s):
    e = pkg.encode(_pair_histories(1, seed=30)[0][pkg is PORT])
    r1, r2 = s.submit("t", e), s.submit("t", e)
    with pytest.raises(pkg.serve.Rejected) as exc:
        s.submit("t", e)
    other = s.submit("u", e)
    assert r1.wait(120) and r2.wait(120) and other.wait(120)
    r4 = s.submit("t", e)
    assert r4.wait(120)
    return (exc.value.status, exc.value.retry_after_s,
            "in-flight bound" in exc.value.reason,
            [_verdict(r.result) for r in (r1, r2, other, r4)])


SCRIPTS = {
    "coalesce": (_coalesce, {"coalesce_ms": 300, "max_batch": 16}),
    "weighted_fair": (_fair, {"coalesce_ms": 200, "max_batch": 4}),
    "admission_429": (_admission, {"coalesce_ms": 300, "max_batch": 16,
                                   "max_inflight": 2}),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_scheduler_script_equals_jax(name, healthy_supervisor):
    script, kw = SCRIPTS[name]
    (jout, jm), (pout, pm) = (_run_script(p, script, **kw) for p in PKGS)
    if name == "coalesce":
        assert [o[:3] for o in pout] == [o[:3] for o in jout]
        assert {o[3] for o in pout} == {"torch"}
        assert all(o[1] == 8 and o[2] for o in pout)
    else:
        assert pout == jout
    assert pm == _as_port_counters(jm)


def test_degraded_sheds_to_the_oracle_like_jax():
    """A degraded backend: the JAX scheduler sheds the batch to its CPU
    oracle; the port launches it on its device all the same (no host
    failover, ROADMAP C), with the same verdicts, and the success makes
    the supervisor healthy again."""
    hists = _pair_histories(4, seed=40, mutant_every=2)
    got, sups = {}, {}
    for p in PKGS:
        sup = sups[p.name] = _fake_supervisor(p.health, fail_degraded=1,
                                              fail_wedged=3)
        prev = p.health.reset_supervisor(sup)
        try:
            sup.note_failure("synthetic wobble", source="test")
            assert sup.snapshot()["state"] == "degraded"

            def script(pkg, s):
                reqs = [s.submit("t", pkg.encode(pair[pkg is PORT]))
                        for pair in hists]
                assert all(r.wait(120) for r in reqs)
                return [(_verdict(r.result), r.result["route"],
                         r.result["kernel"]) for r in reqs]

            got[p.name] = _run_script(p, script, coalesce_ms=50,
                                      max_batch=16)
        finally:
            p.health.reset_supervisor(prev)
    (jout, jm), (pout, pm) = got["jax"], got["port"]
    assert [o[0] for o in pout] == [o[0] for o in jout]
    assert {o[1:] for o in jout} == {("cpu-oracle", "cpu-oracle-shed")}
    assert {o[1] for o in pout} == {"torch"}
    assert not any("oracle" in o[2] for o in pout)
    assert any(o[0][0] is False for o in pout)
    assert jm["serve.shed_cpu"] == 4
    assert pm["serve.failed_requests"] == 0 and "serve.shed_cpu" not in pm
    assert sups["port"].snapshot()["state"] == "healthy"
    for pair, o in zip(hists, pout):
        enc = PORT.encode(pair[1])
        want = check_events_oracle(enc, PLin(device="cpu").model)
        assert o[0][:2] == (want.valid, want.dead_step(enc))


def test_wedged_refuses_503_then_drains_like_jax():
    got = {}
    for p in PKGS:
        sup = _fake_supervisor(p.health)
        prev = p.health.reset_supervisor(sup)
        try:
            def script(pkg, s):
                e = pkg.encode(_pair_histories(1, seed=50)[0][pkg is PORT])
                queued = s.submit("t", e)
                sup.note_failure("hang", source="test", wedged=True)
                with pytest.raises(pkg.serve.Rejected) as exc:
                    s.submit("t", e)
                parked = not queued.wait(0.8)
                sup.note_ok(source="test")
                assert queued.wait(120), "admitted work must drain"
                return (exc.value.status, exc.value.retry_after_s, parked,
                        _verdict(queued.result))

            got[p.name] = _run_script(p, script, coalesce_ms=400,
                                      max_batch=16)
        finally:
            p.health.reset_supervisor(prev)
    assert got["port"][0] == got["jax"][0]
    assert got["port"][1] == _as_port_counters(got["jax"][1])
    (status, retry, parked, _v), metrics = got["port"]
    assert (status, retry, parked) == (503, 5, True)
    assert metrics["serve.rejected_wedged"] == 1


def test_raising_device_route_sheds_and_notes_like_jax(healthy_supervisor,
                                                       monkeypatch):
    """A device route that raises: both schedulers note the failure to
    the supervisor (degraded). The JAX one sheds the batch to its CPU
    oracle; the port answers an error verdict (route "error", valid
    null, the error text) and checks nothing on the host."""
    def boom(*a, **k):
        raise RuntimeError("synthetic dispatch crash")

    for p in PKGS:
        monkeypatch.setattr(p.sched, "submit_corpus", boom)
    hist = _pair_histories(1, seed=60, mutant_every=1)[0]
    got = {}
    for p in PKGS:
        def script(pkg, s):
            r = s.submit("t", pkg.encode(hist[pkg is PORT]))
            assert r.wait(120)
            return r.result

        got[p.name] = _run_script(p, script, coalesce_ms=20, max_batch=8)
    (jres, jm), (pres, pm) = got["jax"], got["port"]
    enc = PORT.encode(hist[1])
    want = check_events_oracle(enc, PLin(device="cpu").model)
    assert jres["route"] == "cpu-oracle"
    assert _verdict(jres) == (want.valid, want.dead_step(enc), enc.n_ops)
    assert pres["route"] == "error" and pres["kernel"] == "none"
    assert _verdict(pres) == (None, -1, enc.n_ops)
    assert "synthetic dispatch crash" in pres["error"]
    assert jm["serve.shed_cpu"] == 1 and pm["serve.failed_requests"] == 1
    for p in PKGS:
        snap = healthy_supervisor[p.name].snapshot()
        assert snap["fail_total"] == 1 and snap["state"] == "degraded"
        assert "synthetic dispatch crash" in snap["last_failure"]


def test_misaligned_corpus_results_never_cross_tenants(healthy_supervisor,
                                                       monkeypatch):
    """A corpus answer missing a slot is a dispatch failure: every request
    of the batch gets an error verdict, none another tenant's verdict."""
    from concurrent.futures import Future

    def short(encs, model=None, f_cap=256, device=None):
        fut = Future()
        res, kernel, stats = psched.check_corpus(encs, model, device="cpu")
        fut.set_result((res[:-1], kernel, stats))
        return fut

    monkeypatch.setattr(psched, "submit_corpus", short)
    hists = _pair_histories(3, seed=65, mutant_every=2)

    def script(pkg, s):
        reqs = [s.submit(f"t{i}", pkg.encode(pair[1]))
                for i, pair in enumerate(hists)]
        assert all(r.wait(120) for r in reqs)
        return [r.result for r in reqs]

    out, metrics = _run_script(PORT, script, coalesce_ms=200, max_batch=8)
    assert {r["route"] for r in out} == {"error"}
    assert all(r["valid"] is None and "misaligned" in r["error"]
               for r in out)
    assert metrics["serve.failed_requests"] == 3
    assert "misaligned" in \
        healthy_supervisor["port"].snapshot()["last_failure"]


def test_only_the_dispatcher_probes_and_a_parked_one_recovers(monkeypatch):
    """The daemon's dispatch thread owns the active probe: check_corpus
    never runs it, the idle dispatcher does once it is due, and a
    dispatcher parked on a wedged backend probes its way back and
    drains its admitted work."""
    calls = []

    def probe():
        calls.append(time.monotonic())
        return True, "", False

    sup = phealth.BackendSupervisor(probe=probe, probe_interval_s=0.0)
    prev = phealth.reset_supervisor(sup)
    monkeypatch.delenv("JEPSEN_TPU_HEALTH_PROBE", raising=False)
    try:
        encs = [PORT.encode(pair[1])
                for pair in _pair_histories(3, seed=67)]
        psched.check_corpus(encs, device="cpu")
        assert calls == []
        sup.probe_interval_s = 0.3
        s = pserve.CoalescingScheduler(coalesce_ms=400, max_batch=8,
                                       device="cpu")
        try:
            deadline = time.monotonic() + 30
            while not calls and time.monotonic() < deadline:
                time.sleep(0.05)
            assert calls, "the idle dispatcher never probed"
            sup.probe_interval_s = 3600.0
            queued = s.submit("t", encs[0])
            sup.note_failure("hang", source="test", wedged=True)
            with pytest.raises(pserve.Rejected):
                s.submit("t", encs[1])
            n = len(calls)
            assert not queued.wait(0.8), "a wedged backend parks"
            sup.probe_interval_s = 0.3
            assert queued.wait(30), "a parked dispatcher must recover"
            assert len(calls) > n
            assert sup.snapshot()["state"] == "healthy"
            assert queued.result["route"] == "torch"
        finally:
            s.close()
    finally:
        phealth.reset_supervisor(prev)


def test_submit_corpus_future_equals_check_corpus():
    encs = [PORT.encode(pair[1]) for pair in _pair_histories(5, seed=70)]
    want = psched.check_corpus(encs, device="cpu")
    got = psched.submit_corpus(encs, device="cpu").result(timeout=120)
    assert got == want
    assert psched.corpus_executor() is psched.corpus_executor()


def test_batch_of_one_takes_the_single_route(healthy_supervisor):
    """A lone request launches the single-history route, a coalesced
    batch the bucketed one (the launch counts the chip run tells apart)."""
    from jepsen_etcd_demo_tpu_torch.sched import engine

    encs = [PORT.encode(pair[1]) for pair in _pair_histories(4, seed=75)]
    before = engine.shape_stats()
    s = pserve.CoalescingScheduler(coalesce_ms=0, max_batch=8,
                                   device="cpu")
    try:
        assert s.submit("t", encs[0]).wait(120)
        one = engine.shape_stats()
        reqs = [s.submit("t", e) for e in encs]
        assert all(r.wait(120) for r in reqs)
    finally:
        s.close()
    assert one["hits"] + one["misses"] \
        == before["hits"] + before["misses"]
    stats = s.stats()
    assert stats["kernel_cache"] == engine.shape_stats()
    assert stats["requests_done"] == 5 and stats["health"] == "healthy"


# -- the daemon over HTTP -------------------------------------------------------

def _start(pkg, root, **kw):
    daemon = pkg.daemon(str(root), **kw)
    httpd = ThreadingHTTPServer(
        ("127.0.0.1", 0), pkg.serve.make_serve_handler(str(root), daemon))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return daemon, httpd, httpd.server_address[1]


def _stop(daemon, httpd):
    httpd.shutdown()
    httpd.server_close()
    daemon.close()


def _post(port, path, body, timeout=120):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read().decode())


def _get(port, path, timeout=60):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=timeout) as r:
        return r.status, r.read().decode()


def _poll(port, rid):
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        status, text = _get(port, f"/check/{rid}")
        if status == 200:
            return json.loads(text)
        assert status == 202
        time.sleep(0.02)
    raise AssertionError(f"request {rid} never finished")


def _keyed_history(seed, keys=3, n_ops=24):
    """The same keyed (key, value) history from both packages."""
    out = []
    for fuzz in (jfuzz, pfuzz):
        rng = random.Random(seed)
        per_key = [fuzz.gen_register_history(rng, n_ops=n_ops, n_procs=3,
                                             p_info=0.0)
                   for _ in range(keys)]
        per_key[1] = fuzz.mutate_history(random.Random(seed + 1),
                                         per_key[1])
        out.append(fuzz.interleave_keyed(per_key))
    return out


def _serve_traffic(pkg, port, hists, keyed):
    """Single-shot (wait), polled, and session traffic: the verdicts."""
    out = {"wait": [], "poll": [], "session": [], "keyed": None}
    for pair in hists:
        ops = _op_dicts(pair[pkg is PORT])
        status, body = _post(port, "/check", {"tenant": "w", "history": ops})
        assert status == 200
        out["wait"].append(body)
        status, body = _post(port, "/check", {"tenant": "p", "wait": False,
                                              "history": ops})
        assert status == 202 and body["pending"]
        out["poll"].append(_poll(port, body["request_id"]))
        status, sess = _post(port, "/serve/session", {"tenant": "s"})
        assert status == 201
        half = len(ops) // 2
        for chunk in (ops[:half], ops[half:]):
            status, fed = _post(port, sess["ops"], {"ops": chunk})
            assert status == 200
        assert fed["ops_fed"] == len(ops)
        status, verdict = _post(port, sess["close"], {})
        assert status == 200
        out["session"].append(verdict)
    status, sess = _post(port, "/serve/session", {"tenant": "k",
                                                  "keyed": True})
    _post(port, sess["ops"], {"ops": _op_dicts(keyed[pkg is PORT])})
    out["keyed"] = _post(port, sess["close"], {})[1]
    return out


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The same traffic through the JAX daemon and the port's (on the
    CPU), each in-process on port 0: {package name: (verdicts, stats,
    healthz, metrics text, index html)}."""
    hists = _pair_histories(4, seed=80)
    keyed = _keyed_history(85)
    done = {}
    for p in PKGS:
        sup = _fake_supervisor(p.health)
        prev = p.health.reset_supervisor(sup)
        root = tmp_path_factory.mktemp(f"serve-{p.name}") / "store"
        daemon, httpd, port = _start(p, root, coalesce_ms=10)
        try:
            with p.obs.capture():
                verdicts = _serve_traffic(p, port, hists, keyed)
                stats = json.loads(_get(port, "/serve/stats")[1])
                healthz = json.loads(_get(port, "/healthz")[1])
                metrics = _get(port, "/metrics")[1]
                deadline = time.monotonic() + 60
                while len(Store(root).runs()) < 13 \
                        and time.monotonic() < deadline:
                    time.sleep(0.05)
                index = _get(port, "/")[1]
        finally:
            _stop(daemon, httpd)
            p.health.reset_supervisor(prev)
        done[p.name] = (verdicts, stats, healthz, metrics, index, root)
    return done


@pytest.mark.parametrize("mode", ["wait", "poll", "session"])
def test_served_verdicts_equal_jax(served, mode):
    jv, pv = served["jax"][0][mode], served["port"][0][mode]
    assert len(pv) == len(jv) == 4
    for j, p in zip(jv, pv):
        if mode == "session":
            assert p["streamed"] is j["streamed"] is True
            assert p["valid"] == j["valid"]
            assert {k: _verdict(v) for k, v in p["keys"].items()} \
                == {k: _verdict(v) for k, v in j["keys"].items()}
            assert set(p) == set(j)
            assert set(p["stream"]) == set(j["stream"])
        else:
            assert _verdict(p) == _verdict(j)
            assert set(p) == set(j)
            assert set(p["batch"]) == set(j["batch"])
            assert p["route"] == "torch" and j["route"] == "jax"
    assert any(v["valid"] is False for v in pv), "mutants must be found"


def test_keyed_session_equals_jax(served):
    j, p = served["jax"][0]["keyed"], served["port"][0]["keyed"]
    assert p["valid"] is j["valid"] is False
    assert {k: _verdict(v) for k, v in p["keys"].items()} \
        == {k: _verdict(v) for k, v in j["keys"].items()}
    assert len(p["keys"]) == 3


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k not in ("tenants", "per_tenant"):
            out |= _keys(v, prefix + k + ".")
    return out


def test_stats_and_healthz_key_sets_equal_jax(served):
    """The JAX daemon's keys, and `launches`, the port's kernel launch
    counts (a batch of one launches the single-history route, a coalesced
    batch the bucketed one, a session's chunks the resumable one)."""
    port, jax = _keys(served["port"][1]), _keys(served["jax"][1])
    assert port - jax == {"launches", "scheduler.failed_requests"} | {
        f"launches.{n}" for n in served["port"][1]["launches"]}
    assert jax - port == {"scheduler.shed_cpu"}
    jh, ph = served["jax"][2], served["port"][2]
    assert set(ph) == set(jh) and set(ph["serve"]) == set(jh["serve"])
    assert ph["status"] == jh["status"] == "healthy"
    sched = served["port"][1]["scheduler"]
    assert sched["requests_done"] == served["jax"][1]["scheduler"][
        "requests_done"] == 8
    assert sched["failed_requests"] == 0 and sched["health"] == "healthy"


def _families(text):
    return {m.group(1) for m in re.finditer(r"^# TYPE (\S+) ", text, re.M)}


def test_metrics_families_equal_jax(served):
    """The port's /metrics carries the serve, tenant and health families
    of the JAX daemon's, failed requests in the place of its CPU shed,
    and nothing else (no kernel attribution, campaign or ledger families:
    ROADMAP C)."""
    jf, pf = _families(served["jax"][3]), _families(served["port"][3])
    shared = {f for f in jf if f.startswith(("jepsen_tpu_serve_",
                                             "jepsen_tpu_health_"))} \
        | {"jepsen_tpu_up", "jepsen_tpu_run_in_flight"}
    assert pf == shared - {"jepsen_tpu_serve_shed_cpu"} \
        | {"jepsen_tpu_serve_failed_requests"}
    assert 'tenant="w"' in served["port"][3]
    assert "jepsen_tpu_serve_requests 8" in served["port"][3]


def test_every_verdict_lands_in_the_store_and_index(served):
    root = served["port"][5]
    runs = Store(root).runs()
    assert len(runs) == 13
    assert all(r.path.parent.name == "serve" for r in runs)
    modes = {r.read_results()["check_mode"] for r in runs}
    assert modes == {"serve"}
    for r in runs:
        assert (r.path / "test.json").exists()
        assert (r.path / "history.jsonl").exists()
        assert not (r.path / "telemetry.jsonl").exists()
    index = served["port"][4]
    assert index.count("<tr><td><a href='/files/serve/") == 13
    assert "tenant w" in index and ">serve</td>" in index


class _Hook:
    """A webhook receiver on port 0."""

    def __init__(self):
        from http.server import BaseHTTPRequestHandler, HTTPServer

        got, self.received = threading.Event(), []
        self.got = got
        received = self.received

        class H(BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                received.append(json.loads(self.rfile.read(n).decode()))
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()
                got.set()

            def log_message(self, *a):
                pass

        self.server = HTTPServer(("127.0.0.1", 0), H)
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}/v"

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def test_webhook_oversized_body_and_unknown_endpoints(tmp_path,
                                                      healthy_supervisor):
    hook = _Hook()
    daemon, httpd, port = _start(PORT, tmp_path / "store", coalesce_ms=10)
    try:
        with pobs.capture() as cap:
            ops = _op_dicts(_pair_histories(1, seed=90)[0][1])
            status, body = _post(port, "/check", {"tenant": "h",
                                                  "history": ops,
                                                  "webhook": hook.url})
            assert status == 200
            assert hook.got.wait(60), "webhook never delivered"
            assert hook.received[0]["request_id"] == body["request_id"]
            assert hook.received[0]["valid"] == body["valid"]
            assert cap.metrics.value("serve.webhooks") == 1
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/check", data=b"{}",
            headers={"Content-Type": "application/json",
                     "Content-Length": str((64 << 20) + 1)})
        for path, body, code in (("/check", None, 400),
                                 ("/nowhere", {}, 404),
                                 ("/check", {"history": []}, 400),
                                 ("/serve/session/nope/ops", {"ops": []},
                                  404)):
            with pytest.raises(urllib.error.HTTPError) as exc:
                if body is None:
                    urllib.request.urlopen(req, timeout=30)
                else:
                    _post(port, path, body, timeout=30)
            assert exc.value.code == code, path
        with pytest.raises(urllib.error.HTTPError) as exc:
            _get(port, "/check/unknown")
        assert exc.value.code == 404
    finally:
        hook.close()
        _stop(daemon, httpd)


def test_sessions_refuse_wedged_closed_and_over_bound(healthy_supervisor):
    model = PLin(device="cpu").model
    mgr = pserve.SessionManager(max_per_tenant=1, device="cpu")
    sess = mgr.open("t", model, "cas-register")
    with pytest.raises(pserve.Rejected) as exc:
        mgr.open("t", model, "cas-register")
    assert exc.value.status == 429
    ops = list(_pair_histories(1, seed=95)[0][1])
    sess.feed(ops[:4])
    assert mgr.close(sess.id)["session_id"] == sess.id
    with pytest.raises(pserve.Rejected) as exc:
        sess.feed(ops[4:])
    assert exc.value.status == 409
    healthy_supervisor["port"].note_failure("hang", source="t", wedged=True)
    with pytest.raises(pserve.Rejected) as exc:
        mgr.open("u", model, "cas-register")
    assert (exc.value.status, exc.value.retry_after_s) == (503, 5)
    assert mgr.close_all() == 0


@pytest.mark.parametrize("entry", [
    {"type": "invoke", "f": "cas", "value": [1, 2], "process": 3,
     "time": 9},
    {"type": "ok", "f": "read", "value": None, "process": 0, "seq": 4,
     "error": "x", "index": 2},
    {"value": 1},
    ["not", "an", "object"],
])
def test_op_from_dict_equals_jax(entry):
    try:
        want = vars(jserve.op_from_dict(entry))
    except ValueError:
        with pytest.raises(ValueError):
            pserve.op_from_dict(entry)
        return
    assert vars(pserve.op_from_dict(entry)) == want


# -- the command line ----------------------------------------------------------

def _spawn(args, tmp_path, env=None):
    env = {**os.environ, **(env or {})}
    env.pop("PYTHONPATH", None)
    return subprocess.Popen(
        [sys.executable, "-m", "jepsen_etcd_demo_tpu_torch.cli", "serve",
         "--port", "0", "--store", str(tmp_path / "store"), *args],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _finish(proc):
    proc.terminate()
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)


def test_cli_serve_check_on_cpu_answers_like_analyze(tmp_path):
    proc = _spawn(["--check", "--device", "cpu"], tmp_path)
    try:
        ready = json.loads(proc.stdout.readline())
        assert set(ready) == {"serving", "port", "store", "check", "warmed"}
        assert ready["check"] is True and ready["warmed"] is True
        port = ready["port"]
        hists = _pair_histories(2, seed=100, mutant_every=2)
        lin = PLin(device="cpu")
        for _jh, ph in hists:
            status, body = _post(port, "/check",
                                 {"tenant": "cli", "history": _op_dicts(ph)},
                                 timeout=300)
            want = lin.check({}, ph, {})
            assert status == 200 and body["route"] == "torch"
            assert body["valid"] == want["valid"]
            assert body["dead_step"] == int(want.get("dead_step", -1))
        healthz = json.loads(_get(port, "/healthz")[1])
        assert healthz["serve"]["warmed"] is True
        assert healthz["serve"]["warmup_families"] == []
    finally:
        _finish(proc)


def test_cli_serve_check_without_a_card_exits_before_binding(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this pins the no-card path")
    proc = _spawn(["--check"], tmp_path)
    try:
        out, err = proc.communicate(timeout=300)
    finally:
        _finish(proc)
    assert proc.returncode != 0 and out == ""
    assert "CUDA is not available" in err


def test_cli_serve_without_check_browses_the_store(tmp_path):
    proc = _spawn([], tmp_path)
    try:
        line = proc.stdout.readline()
        port = int(re.search(r"http://127\.0\.0\.1:(\d+)", line).group(1))
        assert _get(port, "/")[0] == 200
        status, text = _get(port, "/healthz")
        assert status == 200 and json.loads(text)["status"] == "healthy"
    finally:
        _finish(proc)


def test_serve_warmup_checks_and_failures_end_the_command(monkeypatch,
                                                          capsys, tmp_path):
    rec = cli.serve_warmup(torch.device("cpu"), "cas-register")
    assert rec["kernel"] == "wgl3-dense-plain" and rec["families"] == []
    monkeypatch.setenv(cli.NO_WARMUP_ENV, "1")
    assert cli.serve_warmup(torch.device("cpu"), "cas-register") is None

    def broken(device, model_name):
        raise RuntimeError("nvcc failed for wgl3_sweep.cu")

    monkeypatch.setattr(cli, "serve_warmup", broken)
    assert cli.main(["serve", "--check", "--device", "cpu", "--port", "0",
                     "--store", str(tmp_path / "store")]) == 1
    out, err = capsys.readouterr()
    assert out == "" and "nvcc failed" in err


# -- concurrency ----------------------------------------------------------------

def test_concurrent_sessions_and_requests_equal_sequential(
        tmp_path, healthy_supervisor):
    """Four streaming sessions and 64 single-shot requests at once, with a
    short switch interval: every verdict equals the sequential check of
    the same history."""
    hists = [pair[1] for pair in _pair_histories(16, n_ops=30, seed=200,
                                                 mutant_every=4)]
    lin = PLin(device="cpu")
    want = []
    for h in hists:
        res, _k, _s = psched.check_corpus([lin.encode(h)], device="cpu")
        want.append((res[0]["valid"], int(res[0]["dead_step"])))
    daemon, httpd, port = _start(PORT, tmp_path / "store", coalesce_ms=5,
                                 max_batch=8)
    got_checks: dict = {}
    got_sessions: dict = {}
    errors = []

    def checker(t):
        try:
            for i in range(t, 64, 8):
                _s, body = _post(port, "/check",
                                 {"tenant": f"t{t}",
                                  "history": _op_dicts(hists[i % 16])})
                got_checks[i] = (body["valid"], body["dead_step"])
        except Exception as e:   # reported below
            errors.append(e)

    def session(j):
        try:
            _s, sess = _post(port, "/serve/session", {"tenant": f"s{j}"})
            ops = _op_dicts(hists[j])
            for c in range(0, len(ops), 7):
                _post(port, sess["ops"], {"ops": ops[c:c + 7]})
            _s, v = _post(port, sess["close"], {})
            got_sessions[j] = (v["valid"], v["keys"]["_"]["dead_step"])
        except Exception as e:
            errors.append(e)

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=checker, args=(t,))
                   for t in range(8)]
        threads += [threading.Thread(target=session, args=(j,))
                    for j in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(prev)
        _stop(daemon, httpd)
    assert not errors, errors
    assert got_checks == {i: want[i % 16] for i in range(64)}
    assert got_sessions == {j: want[j] for j in range(4)}
    stats = daemon.scheduler.stats()
    assert stats["requests_done"] == 64 and stats["failed_requests"] == 0
    assert stats["coalesced_requests"] > 0


def test_launch_counts_lose_no_update_across_threads():
    """The launch counters are bumped from the executor thread and the
    sessions' consumer threads at once: none is lost. The made-up counts
    are taken back afterwards: the counters are process-wide, and a later
    test in this worker reads them."""
    from jepsen_etcd_demo_tpu_torch.ops import wgl3_kernels as wk

    before = wk.launch_counts()
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            wk._count("dense_sweep", "dense_sweep_grouped")
            for _ in range(2000)]) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        after = wk.launch_counts()
    finally:
        sys.setswitchinterval(prev)
        with wk._launches_lock:
            wk.launches.update(before)
    for name in ("dense_sweep", "dense_sweep_grouped"):
        assert after[name] - before[name] == 16 * 2000
