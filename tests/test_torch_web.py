"""The port's store browser (web/server.py) against the JAX package's: the
run index's verdict and detail columns over a store the port's
`test --fake` wrote, the column helpers, the per-run metrics page, the
static files, and the /metrics and /healthz endpoints."""

from __future__ import annotations

import html
import json
import re
import threading
import urllib.error
import urllib.parse
import urllib.request
from http.server import ThreadingHTTPServer

import pytest

from jepsen_etcd_demo_tpu.obs import health as jhealth
from jepsen_etcd_demo_tpu.store import Store as JStore
from jepsen_etcd_demo_tpu.web import server as jweb
from jepsen_etcd_demo_tpu_torch import cli
from jepsen_etcd_demo_tpu_torch import obs as pobs
from jepsen_etcd_demo_tpu_torch.obs import health as phealth
from jepsen_etcd_demo_tpu_torch.obs.metrics import MetricsRegistry
from jepsen_etcd_demo_tpu_torch.serve import ServeDaemon
from jepsen_etcd_demo_tpu_torch.store import Store
from jepsen_etcd_demo_tpu_torch.web import server as pweb

COLUMNS = ("run", "valid", "detail", "eps", "waste", "sweep", "live",
           "mode", "overlap", "profile")

# Port runs of the store: (`cli test --fake --device cpu` flags, exit
# code).
RUNS = {
    "healthy": (["-w", "register", "--no-nemesis"], 0),
    "stale": (["-w", "register", "--stale-read-prob", "0.8", "--no-nemesis",
               "--time-limit", "1.5", "--seed", "3"], 1),
    "stream": (["-w", "register", "--no-nemesis", "--check-mode",
                "stream"], 0),
    "set-lost": (["-w", "set", "--lost-write-prob", "0.3",
                  "--no-nemesis"], 1),
}


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """A store with the port's RUNS and two serve runs (one shed)."""
    root = tmp_path_factory.mktemp("web") / "store"
    for flags, rc in RUNS.values():
        assert cli.main(["test", "--fake", "--device", "cpu",
                         "--time-limit", "1.0", "--rate", "200",
                         "--ops-per-key", "40", "--concurrency", "6",
                         "--recovery-wait", "0.1", "--seed", "1",
                         "--store", str(root), *flags]) == rc
    sup = phealth.BackendSupervisor(probe=lambda: (True, "", False),
                                    probe_interval_s=3600.0)
    prev = phealth.reset_supervisor(sup)
    daemon = ServeDaemon(store_root=str(root), device="cpu")
    try:
        for i, route in enumerate(("torch", "cpu-oracle")):
            ident = str(i + 1) * 32
            daemon.write_serve_run(
                ident, {"tenant": f"t{i}", "model": "cas-register",
                        "request_id": ident}, [], i == 0,
                {"valid": i == 0, "op_count": 30, "route": route,
                 "tenant": f"t{i}", "batch": {"size": 3}})
    finally:
        daemon.close()
        phealth.reset_supervisor(prev)
    return root


def _rows(page: str) -> list[dict]:
    out = []
    for tr in re.findall(r"<tr><td><a href=.*?</tr>", page):
        cells = [html.unescape(re.sub(r"<[^>]+>", "", c))
                 for c in re.findall(r"<td[^>]*>(.*?)</td>", tr)]
        out.append(dict(zip(COLUMNS, cells)))
    return out


def test_index_columns_equal_jax(store):
    port = _rows(pweb._index_html(Store(store)))
    jax = _rows(jweb._index_html(JStore(store)))
    assert len(port) == len(jax) == len(RUNS) + 2
    for p, j in zip(port, jax):
        if p["run"].startswith("serve/"):
            # The JAX summary hides its own route label, the port's its.
            j = {**j, "detail": j["detail"].replace("; route torch", "")}
        assert p == j
    by_valid = {p["valid"] for p in port}
    assert by_valid == {"True", "False"}
    details = " | ".join(p["detail"] for p in port)
    assert "lost adds:" in details and "tenant t1" in details
    assert "route cpu-oracle" in details and "route torch" not in details
    assert {p["mode"] for p in port} == {"post", "stream", "serve"}


SUMMARIES = [
    {},
    {"perf": {"count": 120, "rate_hz": 99.6}},
    {"serve": {"tenant": "a", "batch": {"size": 4}, "route": "ROUTE",
               "op_count": 30}},
    {"serve": {"tenant": "b", "route": "cpu-oracle", "op_count": 0}},
    {"indep": {"results": {"1": {"linear": {"valid": False,
                                            "failed_op": "op 3"}},
                           "2": {"valid": False}}}},
    {"indep": {"linear": {"valid": False}, "lost_count": 7,
               "elle": {"anomaly_types": ["G0", "G1c"]}}},
]


@pytest.mark.parametrize("i", range(len(SUMMARIES)))
def test_run_summary_equals_jax(i):
    """Each package hides its own device route: "torch" in the port,
    "jax" in the JAX package (web/server.py :53)."""
    res = SUMMARIES[i]

    def with_route(route):
        return json.loads(json.dumps(res).replace("ROUTE", route))

    assert pweb._run_summary(with_route("torch")) \
        == jweb._run_summary(with_route("jax"))
    assert pweb._stream_columns(res) == jweb._stream_columns(res)
    assert pweb._profile_column(res) == jweb._profile_column(res)


@pytest.mark.parametrize("results", [
    {"check_mode": "post"},
    {"check_mode": "stream", "stream": {"overlap_ratio": 0.875}},
    {"check_mode": "serve", "serve": {"stream": {"overlap_ratio": 0.5}}},
    {"check_mode": "other"},
    {"profile": {"hash": "abc123", "tuned_fields": 2}},
    {"profile": {"hash": "abc123"}},
])
def test_stream_and_profile_columns_equal_jax(results):
    assert pweb._stream_columns(results) == jweb._stream_columns(results)
    assert pweb._profile_column(results) == jweb._profile_column(results)


def _metrics_run(tmp_path, updates):
    reg = MetricsRegistry()
    for name, kind, v in updates:
        getattr(reg, kind)(name).add(v) if kind == "counter" \
            else getattr(reg, kind)(name).set(v)
    run = tmp_path / "t" / "run"
    run.mkdir(parents=True)
    reg.write(run / "metrics.json")
    (run / "results.json").write_text('{"valid": true}')
    return run


@pytest.mark.parametrize("updates", [
    [],
    [("encode.event_bytes", "counter", 2400), ("wgl.execute_s", "counter",
                                                0.5),
     ("wgl.step_padding_ratio", "gauge", 1.25),
     ("wgl.sweep_steps_dense", "counter", 10)],
    [("wgl.sweep_steps_sparse", "counter", 3),
     ("wgl.sweep_steps_dense", "counter", 9),
     ("wgl.live_tile_ratio", "gauge", 0.125)],
    [("wgl.sweep_steps_sparse", "counter", 3)],
])
def test_perf_columns_and_metrics_page_equal_jax(tmp_path, updates):
    run = _metrics_run(tmp_path, updates)

    class _Run:
        path = run

    assert pweb._check_perf_columns(_Run) == jweb._check_perf_columns(_Run)
    page = pweb._telemetry_html(Store(tmp_path), "t/run")
    assert page is not None and "<h3>metrics</h3>" in page
    for name, _kind, _v in updates:
        assert name in page


@pytest.fixture
def browser(store):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                pweb.make_handler(str(store)))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield httpd.server_address[1]
    httpd.shutdown()
    httpd.server_close()


def _get(port, path):
    url = f"http://127.0.0.1:{port}{urllib.parse.quote(path)}"
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, r.headers.get("Content-Type"), r.read().decode()


def test_browser_serves_index_files_and_no_telemetry(store, browser):
    status, _ct, page = _get(browser, "/")
    assert status == 200 and len(_rows(page)) == len(RUNS) + 2
    run = Store(store).runs()[0]
    rel = run.path.relative_to(store)
    status, _ct, text = _get(browser, f"/files/{rel}/results.json")
    assert status == 200 and json.loads(text) == run.read_results()
    for path in (f"/telemetry/{rel}", "/telemetry/../../etc"):
        with pytest.raises(urllib.error.HTTPError) as exc:
            _get(browser, path)
        assert exc.value.code == 404
        assert "no telemetry" in exc.value.read().decode()


def test_metrics_and_healthz_endpoints(browser):
    sup = phealth.BackendSupervisor(probe=lambda: (True, "", False),
                                    probe_interval_s=3600.0)
    prev = phealth.reset_supervisor(sup)
    try:
        with pobs.capture():
            pobs.get_metrics().counter("serve.requests").add(3)
            status, ctype, text = _get(browser, "/metrics")
            assert status == 200 and ctype == pobs.export.PROM_CONTENT_TYPE
            assert "jepsen_tpu_serve_requests 3" in text
            assert "jepsen_tpu_run_in_flight 1" in text
            assert text.count("# TYPE jepsen_tpu_health_state ") == 1
            status, _ct, text = _get(browser, "/healthz")
            body = json.loads(text)
            assert status == 200 and body["status"] == "healthy"
            assert body["run_in_flight"] is True
        sup.note_failure("hang", source="t", wedged=True)
        with pytest.raises(urllib.error.HTTPError) as exc:
            _get(browser, "/healthz")
        assert exc.value.code == 503
        assert json.loads(exc.value.read())["status"] == "wedged"
        assert "jepsen_tpu_health_state 2" in _get(browser, "/metrics")[2]
    finally:
        phealth.reset_supervisor(prev)


def test_healthz_body_keys_equal_jax():
    sups = [h.BackendSupervisor(probe=lambda: (True, "", False),
                                probe_interval_s=3600.0)
            for h in (phealth, jhealth)]
    prevs = [h.reset_supervisor(s) for h, s in zip((phealth, jhealth), sups)]
    try:
        (pc, pb), (jc, jb) = pweb._healthz(), jweb._healthz()
        assert pc == jc == 200 and set(pb) == set(jb)
        assert pb["status"] == jb["status"] == "healthy"
    finally:
        for h, p in zip((phealth, jhealth), prevs):
            h.reset_supervisor(p)
