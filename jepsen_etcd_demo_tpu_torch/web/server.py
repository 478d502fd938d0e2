"""A small standard-library HTTP server over a results store.

The reference serves its store with ring/jetty and a directory browser;
this is the JAX package's web/server.py on http.server: an index of runs
with their verdicts (``/``), static files of each run directory
(``/files/...``), a run's metrics page (``/telemetry/<run>``, where the
run recorded a metrics.json), and two endpoints of the serving process:

  /metrics     Prometheus text of the active capture's registry
               (obs/export.py) with the backend health series
  /healthz     the backend supervisor's state as JSON (obs/health.py);
               HTTP 503 when wedged, so a load balancer sees it

The checking daemon (serve/daemon.py) extends StoreHandler. The JAX
package's live page (``/live``, ``/live/events``), its span-tree
rendering of telemetry.jsonl and the campaign corpus banner have no
counterpart in the port yet.
"""

from __future__ import annotations

import html
import json
import urllib.parse
from functools import partial
from http.server import SimpleHTTPRequestHandler, ThreadingHTTPServer

from .. import obs
from ..obs import export, health, read_metrics
from ..store.store import Store

# The per-run metrics file of the JAX package's runs (the port's runs
# write none yet): the index links a run's page when it has one.
METRICS_FILE = "metrics.json"

# The route label of a verdict checked on the daemon's device; the run
# summary names only other routes.
DEVICE_ROUTE = "torch"


def _run_summary(results: dict) -> str:
    """Compact what-ran / why-it-failed column: op count, rate, and for
    invalid runs the failing detail (per-key failed ops, elle anomaly
    types) from the composed result tree. Served checks (serve/daemon.py
    runs) show their tenant, batch and route instead."""
    bits = []
    srv = results.get("serve") or {}
    if srv.get("tenant"):
        bits.append(f"tenant {srv['tenant']}")
        batch = srv.get("batch") or {}
        if batch.get("size"):
            bits.append(f"batch of {batch['size']}")
        if srv.get("route") and srv["route"] != DEVICE_ROUTE:
            bits.append(f"route {srv['route']}")
        if srv.get("op_count"):
            bits.append(f"{srv['op_count']} ops")
    perf = results.get("perf") or {}
    if perf.get("count"):
        bits.append(f"{perf['count']} ops")
    if perf.get("rate_hz"):
        bits.append(f"{perf['rate_hz']:.0f}/s")
    indep = results.get("indep") or {}
    for key, sub in (indep.get("results") or {}).items():
        lin = sub.get("linear", sub) if isinstance(sub, dict) else {}
        if isinstance(lin, dict) and lin.get("valid") is False:
            op = lin.get("failed_op")
            bits.append(f"key {key}: {op}" if op else f"key {key}: invalid")
    # Whole-history workloads (gset, mutex, multiregister) have no per-key
    # results: the failing op sits directly under indep.linear.
    whole_lin = indep.get("linear") or {}
    if whole_lin.get("valid") is False:
        op = whole_lin.get("failed_op")
        bits.append(str(op) if op else "invalid")
    elle = indep.get("elle") or {}
    if elle.get("anomaly_types"):
        bits.append("anomalies: " + ", ".join(elle["anomaly_types"]))
    if indep.get("lost_count"):   # untruncated ('lost' caps at 100)
        bits.append(f"lost adds: {indep['lost_count']}")
    return "; ".join(str(b) for b in bits[:4])


def _check_perf_columns(run) -> tuple[str, str, str, str]:
    """(throughput, padding waste, sweep mode, live-tile ratio) columns of
    the index, from the run's metrics.json: encoded events over the
    kernels' wall, the last launch's padded/real step ratio, which sweep
    the checks took, and the live-tile gauge. Blank when the run has no
    metrics.json (every run of the port, for now) or never launched."""
    try:
        metrics = read_metrics(run.path / METRICS_FILE)
    except Exception:
        return "", "", "", ""

    def counter(name: str) -> float:
        rec = metrics.get(name) or {}
        return float(rec.get("value", 0.0)) \
            if rec.get("type") == "counter" else 0.0

    events = counter("encode.event_bytes") / 24.0   # 6 int32 per event
    kernel_s = counter("wgl.compile_s") + counter("wgl.execute_s")
    eps = f"{events / kernel_s:,.0f}/s" if events and kernel_s else ""
    ratio = (metrics.get("wgl.step_padding_ratio") or {}).get("last")
    waste = f"{ratio:.2f}x" if isinstance(ratio, (int, float)) else ""
    sp = counter("wgl.sweep_steps_sparse")
    dn = counter("wgl.sweep_steps_dense")
    if sp and dn:
        sweep = f"mixed ({100 * sp / (sp + dn):.0f}% sp)"
    elif sp:
        sweep = "sparse"
    elif dn or counter("wgl.sweep_checks_dense") \
            or counter("wgl.sweep_checks_mixed"):
        sweep = "dense"
    else:
        sweep = ""
    lt = (metrics.get("wgl.live_tile_ratio") or {}).get("last")
    live = f"{lt:.1%}" if isinstance(lt, (int, float)) else ""
    return eps, waste, sweep, live


def _stream_columns(results: dict) -> tuple[str, str]:
    """(check mode, overlap ratio) columns of the index, from the run's
    results.json (runner/core.py stamps check_mode and the stream record,
    serve/daemon.py "serve"). Blank for runs that record no mode; overlap
    shows only for streamed checks."""
    mode = results.get("check_mode")
    if mode not in ("post", "stream", "serve"):
        return "", ""
    if mode == "serve":
        ov = ((results.get("serve") or {}).get("stream")
              or {}).get("overlap_ratio")
        return mode, (f"{ov:.0%}" if isinstance(ov, (int, float)) else "")
    if mode != "stream":
        return mode, ""
    ov = (results.get("stream") or {}).get("overlap_ratio")
    return mode, (f"{ov:.0%}" if isinstance(ov, (int, float)) else "")


def _profile_column(results: dict) -> str:
    """The tuning profile a run's check resolved (the JAX package stamps
    results.json with it): the short hash, and the tuned-field count when
    any applied. Blank for the port's runs, which have no profiles."""
    prof = results.get("profile")
    if not isinstance(prof, dict) or not prof.get("hash"):
        return ""
    h = str(prof["hash"])
    n = prof.get("tuned_fields") or 0
    return f"{h} ({n} tuned)" if n else h


def _index_html(store: Store) -> str:
    rows = []
    for run in reversed(store.runs()):
        rel = run.path.relative_to(store.root)
        try:
            results = run.read_results()
            valid = results.get("valid")
        except Exception:
            results, valid = {}, "?"
        try:
            summary = _run_summary(results)
        except Exception:   # off-schema results must not hide the verdict
            summary = ""
        color = {True: "#2a9d43", False: "#d43a2a"}.get(valid, "#e9a820")
        href = urllib.parse.quote(f"/files/{rel}/")
        tele = ""
        if (run.path / METRICS_FILE).exists():
            thref = urllib.parse.quote(f"/telemetry/{rel}")
            tele = f"<a href='{thref}'>telemetry</a>"
        eps, waste, sweep, live = _check_perf_columns(run)
        mode, overlap = _stream_columns(results)
        rows.append(
            f"<tr><td><a href='{href}'>"
            f"{html.escape(str(rel))}</a></td>"
            f"<td style='color:{color};font-weight:bold'>{valid}</td>"
            f"<td style='color:#666'>{html.escape(summary)}</td>"
            f"<td>{html.escape(eps)}</td>"
            f"<td>{html.escape(waste)}</td>"
            f"<td>{html.escape(sweep)}</td>"
            f"<td>{html.escape(live)}</td>"
            f"<td>{html.escape(mode)}</td>"
            f"<td>{html.escape(overlap)}</td>"
            f"<td><code>{html.escape(_profile_column(results))}</code></td>"
            f"<td>{tele}</td></tr>")
    return (
        "<!doctype html><html><head><meta charset='utf-8'>"
        "<title>jepsen-tpu store</title>"
        "<style>body{font-family:sans-serif}td{padding:4px 12px}</style>"
        "</head><body><h2>test runs</h2>"
        "<p><a href='/metrics'>metrics</a> · "
        "<a href='/healthz'>healthz</a></p>"
        f"<table><tr><th>run</th><th>valid</th><th>detail</th>"
        f"<th>check eps</th><th>pad waste</th>"
        f"<th>sweep</th><th>live tiles</th>"
        f"<th>check mode</th><th>overlap</th>"
        f"<th>profile</th>"
        f"<th>obs</th></tr>"
        f"{''.join(rows)}</table>"
        "</body></html>")


def _metrics_table_html(metrics: dict) -> str:
    rows = []
    for name, rec in sorted(metrics.items()):
        kind = rec.get("type", "?")
        if kind == "counter":
            val = f"{rec.get('value', 0):,.6g}"
        elif kind == "gauge":
            val = (f"last {rec.get('last')} / min {rec.get('min')} / "
                   f"max {rec.get('max')} (n={rec.get('n', 0)})")
        else:
            avg = rec.get("avg")
            val = (f"n {rec.get('count', 0)}, sum {rec.get('sum', 0):.6g}, "
                   f"min {rec.get('min')}, max {rec.get('max')}, "
                   f"avg {round(avg, 6) if avg is not None else None}")
            if rec.get("p50") is not None:
                val += (f", p50 {rec['p50']:.4g} / p95 "
                        f"{rec.get('p95'):.4g} / p99 {rec.get('p99'):.4g}")
        rows.append(f"<tr><td><code>{html.escape(name)}</code></td>"
                    f"<td>{kind}</td><td>{html.escape(val)}</td></tr>")
    return (f"<table><tr><th>metric</th><th>type</th><th>value</th></tr>"
            f"{''.join(rows)}</table>")


def _telemetry_html(store: Store, rel: str) -> str | None:
    """<store>/<rel>'s metrics page: the index's perf columns and the
    metric table of its metrics.json. None (a 404) for a missing run, a
    run without metrics.json, or a path outside the store root."""
    root = store.root.resolve()
    run_dir = (root / rel).resolve()
    if root not in run_dir.parents or not run_dir.is_dir():
        return None
    metr = run_dir / METRICS_FILE
    if not metr.exists():
        return None

    class _Run:
        path = run_dir

    eps, waste, sweep, live = _check_perf_columns(_Run)
    shown = [f"{name}: <b>{html.escape(val)}</b>"
             for name, val in (("check eps", eps), ("pad waste", waste),
                               ("sweep", sweep), ("live tiles", live))
             if val]
    parts = [
        "<!doctype html><html><head><meta charset='utf-8'>",
        f"<title>telemetry — {html.escape(rel)}</title>",
        "<style>body{font-family:sans-serif;margin:2em}"
        "td{padding:2px 10px;border-bottom:1px solid #eee}"
        ".a{color:#888;font-size:90%}.err{color:#d43a2a}</style>"
        "</head><body>",
        f"<h2>telemetry — {html.escape(rel)}</h2>",
        f"<p><a href='/'>index</a> · "
        f"<a href='{urllib.parse.quote(f'/files/{rel}/')}'>run files</a></p>",
        f"<p class='a'>{' · '.join(shown)}</p>" if shown else "",
    ]
    try:
        parts.append("<h3>metrics</h3>")
        parts.append(_metrics_table_html(read_metrics(metr)))
    except Exception as e:   # a torn metrics.json must not 500 the page
        parts.append(f"<p class='err'>metrics.json unreadable: "
                     f"{html.escape(str(e))}</p>")
    parts.append("</body></html>")
    return "".join(parts)


# -- the serving process's endpoints ---------------------------------------

def _metrics_text() -> str:
    """The /metrics payload: the active capture's registry as Prometheus
    text (empty outside a capture), and the process series: up, and the
    backend supervisor's state as a level gauge and a labelled info
    series."""
    reg = obs.get_metrics()
    snap = reg.snapshot() if getattr(reg, "enabled", False) else {}
    # The supervisor is the authority on health: drop the capture's
    # health.state gauge, so the exposition carries one
    # jepsen_tpu_health_state family (a repeated TYPE line would make the
    # whole scrape invalid).
    snap.pop("health.state", None)
    hs = health.get_supervisor().snapshot()
    level = health.STATE_LEVEL.get(hs["state"], -1)
    extra = [
        "# TYPE jepsen_tpu_up gauge",
        "jepsen_tpu_up 1",
        "# TYPE jepsen_tpu_health_state gauge",
        f"jepsen_tpu_health_state {level}",
        "# TYPE jepsen_tpu_health_info gauge",
        f'jepsen_tpu_health_info{{state='
        f'"{export.sanitize_label_value(hs["state"])}"}} 1',
        "# TYPE jepsen_tpu_run_in_flight gauge",
        f"jepsen_tpu_run_in_flight {int(obs.capture_active())}",
    ]
    return export.render_prometheus(snap, extra_lines=extra)


def _healthz() -> tuple[int, dict]:
    """(status code, body) of /healthz: the supervisor's snapshot with its
    last transition; 503 when wedged."""
    hs = health.get_supervisor().snapshot()
    body = {"status": hs["state"], **hs,
            "run_in_flight": obs.capture_active(),
            "telemetry_enabled": obs.telemetry_enabled()}
    return (503 if hs["state"] == health.WEDGED else 200), body


class StoreServer(ThreadingHTTPServer):
    """A thread per connection, with a listen backlog for many concurrent
    clients: past socketserver's default of 5 queued connections a busy
    accept loop drops or resets new ones."""

    request_queue_size = 128


class StoreHandler(SimpleHTTPRequestHandler):
    """/ -> run index; /telemetry/<run> -> a run's metrics page; /metrics
    and /healthz -> the serving process; /files/... -> static files
    rooted at the store."""

    def __init__(self, *args, store_root: str = "store", **kw):
        self.store = Store(store_root)
        super().__init__(*args, directory=str(store_root), **kw)

    def _send_html(self, body: str, status: int = 200) -> None:
        self._send_payload(body.encode(), "text/html; charset=utf-8",
                           status)

    def _send_payload(self, payload: bytes, ctype: str,
                      status: int = 200) -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def do_GET(self):
        if self.path in ("/", "/index.html"):
            self._send_html(_index_html(self.store))
            return
        if self.path.rstrip("/") == "/metrics":
            self._send_payload(_metrics_text().encode(),
                               export.PROM_CONTENT_TYPE)
            return
        if self.path.rstrip("/") == "/healthz":
            status, body = _healthz()
            self._send_payload(
                (json.dumps(body, indent=2) + "\n").encode(),
                "application/json; charset=utf-8", status)
            return
        if self.path.startswith("/telemetry/"):
            rel = urllib.parse.unquote(
                self.path[len("/telemetry/"):]).strip("/")
            try:
                body = _telemetry_html(self.store, rel)
            except Exception as e:   # never 500 on a torn artifact
                body = (f"<!doctype html><p>telemetry unreadable: "
                        f"{html.escape(str(e))}</p>")
            if body is None:
                self._send_html("<!doctype html><p>no telemetry for "
                                f"{html.escape(rel)}</p>", status=404)
            else:
                self._send_html(body)
            return
        if self.path.startswith("/files/"):
            self.path = self.path[len("/files"):]
        return super().do_GET()

    def log_message(self, fmt, *args):  # quiet
        pass


def make_handler(store_root: str):
    return partial(StoreHandler, store_root=store_root)


def serve(store_root: str = "store", host: str = "127.0.0.1",
          port: int = 8080) -> None:
    """Serve the store until interrupted."""
    httpd = StoreServer((host, port), make_handler(store_root))
    print(f"serving {store_root} on http://{host}:{httpd.server_address[1]} "
          f"(/metrics, /healthz)", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
