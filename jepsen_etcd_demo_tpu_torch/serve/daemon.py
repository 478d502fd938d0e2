"""`serve --check`: the checking-as-a-service HTTP daemon.

One long-running process whose HTTP surface takes histories from many
concurrent clients and checks them on the coalescing scheduler
(scheduler.py) on its device. The handler extends web/server.py's
StoreHandler, so the daemon also serves the run index, /metrics (with
the serve families and per-tenant latency summaries) and /healthz:

  POST /check                     submit one history
      {"tenant": "t1", "model": "cas-register",
       "history": [ {op}, ... ],        # history.jsonl entry objects
       "wait": true,                    # default: block for the verdict
       "timeout_s": 60,                 # wait bound -> 202 + poll URL
       "webhook": "http://..."}         # optional verdict callback
  GET  /check/<request-id>        poll an asynchronous submission
  POST /serve/session             open a streaming session
      {"tenant": "t1", "model": "cas-register", "keyed": false}
  POST /serve/session/<id>/ops    feed ops ({"ops": [ {op}, ... ]})
  POST /serve/session/<id>/close  drain and finalize -> verdict
  GET  /serve/stats               scheduler and session stats JSON

Backpressure answers with HTTP codes (scheduler.Rejected): 429 when a
tenant is at the in-flight bound, 503 + Retry-After while the backend
supervisor says wedged. A batch the card fails is answered with error
verdicts (`route: "error"`), never checked on the host. Every verdict lands in the store
as a browsable run, store/serve/<ts>Z-<id>/ with test.json, history.jsonl
and results.json (`check_mode: "serve"`), in the JAX package's layout;
the port writes no telemetry.jsonl there yet.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.request
from collections import OrderedDict
from pathlib import Path
from typing import Any, Optional

from .. import obs
from ..obs import export
from ..store.store import RunDir, Store
from ..web import server as web_server
from .scheduler import (CoalescingScheduler, Rejected, ServeRequest,
                        quantile)
from .sessions import SessionManager, op_from_dict

log = logging.getLogger(__name__)

# Completed-request registry bound: a finished request's verdict stays
# pollable until this many newer ones finished (pending requests stay
# pollable; the per-tenant admission bound already bounds them).
REQUEST_REGISTRY_CAP = 4096
# Tenants shown on the per-tenant /metrics latency summaries: client-
# supplied tenant ids must not explode the exposition.
METRICS_TENANT_CAP = 32
DEFAULT_WAIT_TIMEOUT_S = 120.0
# Largest request body accepted: a client's Content-Length must not size
# an unbounded read. 64 MiB fits ~100k-op histories.
MAX_BODY_BYTES = 64 << 20


class ServeDaemon:
    """Process state every handler thread shares: the scheduler, the
    streaming sessions, the request registry and the store sink, all on
    `device` (None = cuda). `warmup` is the startup record of the build
    and warm check (cli `serve --check`), or None when skipped."""

    def __init__(self, store_root: str = "store",
                 default_model: str = "cas-register",
                 coalesce_ms: Optional[int] = None,
                 max_batch: Optional[int] = None,
                 max_inflight: Optional[int] = None,
                 warmup: Optional[dict] = None,
                 device=None):
        from ..device import resolve_device

        self.device = resolve_device(device)
        self.store = Store(store_root)
        self.default_model = default_model
        self.warmup_record = warmup
        self._lock = threading.Lock()
        self._requests: "OrderedDict[str, ServeRequest]" = OrderedDict()
        self._lins: dict[str, Any] = {}     # model name -> Linearizable
        self.scheduler = CoalescingScheduler(
            coalesce_ms=coalesce_ms, max_batch=max_batch,
            max_inflight=max_inflight,
            artifact_sink=self._artifact_sink,
            webhook_sink=self._webhook_sink, device=self.device)
        self.sessions = SessionManager(max_per_tenant=max_inflight,
                                       device=self.device)

    # -- request plumbing ---------------------------------------------------
    def encode(self, model_name: str, ops: list) -> Any:
        """History -> EncodedHistory through the encoder `analyze` uses
        (Linearizable.encode: the model's op translation and slot
        escalation), so served verdicts are the post-hoc path's."""
        from ..checkers.linearizable import Linearizable

        with self._lock:
            lin = self._lins.get(model_name)
        if lin is None:
            lin = Linearizable(model=model_name, device=self.device)
            with self._lock:
                lin = self._lins.setdefault(model_name, lin)
        history = [op for op in ops if op.process != "nemesis"]
        return lin.encode(history)

    def submit(self, tenant: str, model_name: str, ops: list,
               webhook: Optional[str] = None) -> ServeRequest:
        enc = self.encode(model_name, ops)
        req = self.scheduler.submit(tenant, enc, model_name=model_name,
                                    ops=ops, webhook=webhook)
        with self._lock:
            self._requests[req.id] = req
            if len(self._requests) > REQUEST_REGISTRY_CAP:
                # Evict the oldest completed entries only: a pending
                # request's poll URL answers until its verdict lands.
                done_ids = [rid for rid, r in self._requests.items()
                            if r.done.is_set()]
                for rid in done_ids[:len(self._requests)
                                    - REQUEST_REGISTRY_CAP]:
                    self._requests.pop(rid, None)
        return req

    def request(self, request_id: str) -> Optional[ServeRequest]:
        with self._lock:
            return self._requests.get(request_id)

    # -- sinks (the scheduler's dispatch thread) -----------------------------
    def _artifact_sink(self, batch: list[ServeRequest]) -> None:
        """Write each verdict as a browsable store run."""
        for req in batch:
            if req.result is None:
                continue
            self.write_serve_run(
                req.id, {"tenant": req.tenant, "model": req.model_name,
                         "request_id": req.id},
                req.ops, valid=req.result.get("valid"),
                serve_record=dict(req.result))

    def write_serve_run(self, ident: str, serve_meta: dict, ops, valid,
                        serve_record: dict) -> Optional[RunDir]:
        """The one serve run layout, for single-shot requests and
        sessions alike: store/serve/<ts>Z-<id12>/ with test.json,
        history.jsonl and results.json (check_mode "serve")."""
        try:
            ts = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
            path = self.store.root / "serve" / f"{ts}Z-{ident[:12]}"
            path.mkdir(parents=True, exist_ok=True)
            run = RunDir(path)
            run.write_test({"name": "serve", "workload": "serve",
                            "serve": serve_meta})
            if ops:
                run.write_history(ops)
            run.write_results({"valid": valid, "check_mode": "serve",
                               "serve": serve_record})
            return run
        except OSError:
            log.exception("could not write the serve run of %s", ident)
            return None

    def _webhook_sink(self, req: ServeRequest) -> None:
        """Fire-and-forget verdict callback: POST the result JSON to the
        request's webhook URL from a short-lived thread (a failed
        delivery is logged and never blocks the dispatch loop)."""
        def deliver():
            try:
                body = json.dumps(req.result).encode()
                r = urllib.request.Request(
                    req.webhook, data=body,
                    headers={"Content-Type": "application/json"})
                urllib.request.urlopen(r, timeout=10).read()
            except Exception:
                log.warning("webhook delivery to %s failed for request %s",
                            req.webhook, req.id)

        threading.Thread(target=deliver, name="serve-webhook",
                         daemon=True).start()

    # -- /metrics extras -----------------------------------------------------
    def tenant_metric_lines(self) -> list[str]:
        """Per-tenant latency summaries and request counts for /metrics
        (at most METRICS_TENANT_CAP tenants)."""
        lats = self.scheduler.tenant_latencies()
        if not lats:
            return []
        lines = ["# TYPE jepsen_tpu_serve_tenant_latency_seconds summary",
                 "# TYPE jepsen_tpu_serve_tenant_requests_total counter"]
        for tenant in sorted(lats)[:METRICS_TENANT_CAP]:
            xs = lats[tenant]
            if not xs:
                continue
            lv = export.sanitize_label_value(tenant)
            for q in (0.5, 0.95, 0.99):
                lines.append(
                    f'jepsen_tpu_serve_tenant_latency_seconds'
                    f'{{tenant="{lv}",quantile="{q:g}"}} '
                    f'{quantile(xs, q):.6g}')
            lines.append(f'jepsen_tpu_serve_tenant_requests_total'
                         f'{{tenant="{lv}"}} {len(xs)}')
        return lines

    def stats(self) -> dict:
        """The /serve/stats view: the JAX daemon's, and `launches`, this
        process's kernel launches by wrapper (ops/wgl3_kernels.launches;
        the warm check's included)."""
        from ..ops import wgl3_kernels as wk

        return {"scheduler": self.scheduler.stats(),
                "sessions": self.sessions.stats(),
                "launches": wk.launch_counts()}

    def close(self) -> None:
        """Stop both thread sources: every open session's consumer, then
        the dispatch thread."""
        self.sessions.close_all()
        self.scheduler.close()


class ServeHandler(web_server.StoreHandler):
    """StoreHandler (run index, /metrics, /healthz) and the ingestion
    endpoints."""

    daemon_obj: ServeDaemon = None   # bound by make_serve_handler

    # -- helpers -------------------------------------------------------------
    def _send_json(self, body: dict, status: int = 200,
                   headers: Optional[dict] = None) -> None:
        payload = (json.dumps(body, indent=2, default=str) + "\n").encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json; charset=utf-8")
        self.send_header("Content-Length", str(len(payload)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(payload)

    def _read_body(self) -> dict:
        n = int(self.headers.get("Content-Length") or 0)
        if n <= 0:
            return {}
        if n > MAX_BODY_BYTES:
            raise ValueError(
                f"request body of {n} bytes exceeds the "
                f"{MAX_BODY_BYTES}-byte bound")
        body = json.loads(self.rfile.read(n).decode("utf-8"))
        if not isinstance(body, dict):
            raise ValueError("request body must be a JSON object")
        return body

    def _rejected(self, e: Rejected) -> None:
        headers = {}
        if e.retry_after_s is not None:
            headers["Retry-After"] = str(int(e.retry_after_s))
        self._send_json({"error": e.reason, "rejected": True},
                        status=e.status, headers=headers)

    # -- POST ----------------------------------------------------------------
    def do_POST(self):
        d = self.daemon_obj
        path = self.path.rstrip("/")
        try:
            if path == "/check":
                return self._post_check(d)
            if path == "/serve/session":
                return self._post_session_open(d)
            if path.startswith("/serve/session/"):
                rest = path[len("/serve/session/"):]
                if rest.endswith("/ops"):
                    return self._post_session_ops(d, rest[:-len("/ops")])
                if rest.endswith("/close"):
                    return self._post_session_close(
                        d, rest[:-len("/close")])
            self._send_json({"error": f"unknown endpoint {self.path}"},
                            status=404)
        except Rejected as e:
            self._rejected(e)
        except (ValueError, KeyError) as e:   # JSONDecodeError included
            self._send_json({"error": f"bad request: {e}"}, status=400)
        except (BrokenPipeError, ConnectionResetError):
            pass
        except Exception as e:   # a handler bug must not kill the thread
            log.exception("serve handler failed on %s", self.path)
            self._send_json({"error": f"{type(e).__name__}: {e}"},
                            status=500)

    def _post_check(self, d: ServeDaemon) -> None:
        body = self._read_body()
        tenant = str(body.get("tenant") or "default")
        model_name = str(body.get("model") or d.default_model)
        raw_ops = body.get("history")
        if not isinstance(raw_ops, list) or not raw_ops:
            raise ValueError("history must be a non-empty list of ops")
        ops = [op_from_dict(o) for o in raw_ops]
        req = d.submit(tenant, model_name, ops,
                       webhook=body.get("webhook"))
        if body.get("wait", True):
            timeout = float(body.get("timeout_s", DEFAULT_WAIT_TIMEOUT_S))
            if req.wait(timeout):
                return self._send_json(req.result)
        self._send_json({"request_id": req.id, "pending": True,
                         "poll": f"/check/{req.id}"}, status=202)

    def _post_session_open(self, d: ServeDaemon) -> None:
        body = self._read_body()
        tenant = str(body.get("tenant") or "default")
        model_name = str(body.get("model") or d.default_model)
        model = d.scheduler.model_for(model_name)
        sess = d.sessions.open(tenant, model, model_name,
                               keyed=bool(body.get("keyed", False)))
        self._send_json({"session_id": sess.id, "tenant": tenant,
                         "model": model_name,
                         "ops": f"/serve/session/{sess.id}/ops",
                         "close": f"/serve/session/{sess.id}/close"},
                        status=201)

    def _post_session_ops(self, d: ServeDaemon, session_id: str) -> None:
        sess = d.sessions.get(session_id)
        if sess is None:
            return self._send_json(
                {"error": f"no session {session_id}"}, status=404)
        body = self._read_body()
        raw_ops = body.get("ops")
        if not isinstance(raw_ops, list):
            raise ValueError("ops must be a list")
        self._send_json(sess.feed([op_from_dict(o) for o in raw_ops]))

    def _post_session_close(self, d: ServeDaemon,
                            session_id: str) -> None:
        sess = d.sessions.get(session_id)
        if sess is None:
            return self._send_json(
                {"error": f"no session {session_id}"}, status=404)
        ops = sess.ops
        verdict = d.sessions.close(session_id)
        if verdict is None:   # closed concurrently
            return self._send_json(
                {"error": f"no session {session_id}"}, status=404)
        d.write_serve_run(
            verdict["session_id"],
            {"tenant": verdict.get("tenant"), "model": verdict.get("model"),
             "session_id": verdict["session_id"], "streamed": True},
            ops, verdict.get("valid"), verdict)
        self._send_json(verdict)

    # -- GET -----------------------------------------------------------------
    def do_GET(self):
        d = self.daemon_obj
        path = self.path.rstrip("/")
        try:
            if path.startswith("/check/"):
                rid = path[len("/check/"):]
                req = d.request(rid)
                if req is None:
                    return self._send_json(
                        {"error": f"no request {rid}"}, status=404)
                if req.done.is_set():
                    return self._send_json(req.result)
                return self._send_json(
                    {"request_id": rid, "pending": True}, status=202)
            if path == "/serve/stats":
                return self._send_json(d.stats())
            if path == "/healthz":
                # The store's /healthz (the supervisor's snapshot, 503
                # when wedged) with the daemon's startup build-and-warm
                # record. A daemon that answers is ready: it binds only
                # after the build and the warm check.
                status, body = web_server._healthz()
                wrec = d.warmup_record
                body["serve"] = {
                    "ready": True,
                    "warmed": wrec is not None,
                    "warmup_launches": (wrec or {}).get("launches", 0),
                    "warmup_families": (wrec or {}).get("families", []),
                }
                return self._send_json(body, status=status)
            if path == "/metrics":
                text = web_server._metrics_text()
                extra = d.tenant_metric_lines()
                if extra:
                    text = text.rstrip("\n") + "\n" \
                        + "\n".join(extra) + "\n"
                return self._send_payload(text.encode(),
                                          export.PROM_CONTENT_TYPE)
        except (BrokenPipeError, ConnectionResetError):
            return
        return super().do_GET()


def make_serve_handler(store_root: str, daemon: ServeDaemon):
    class _Bound(ServeHandler):
        daemon_obj = daemon

        def __init__(self, *args, **kw):
            super().__init__(*args, store_root=store_root, **kw)

    return _Bound


def serve_check(store_root: str = "store", host: str = "127.0.0.1",
                port: int = 8080, default_model: str = "cas-register",
                coalesce_ms: Optional[int] = None,
                max_batch: Optional[int] = None,
                max_inflight: Optional[int] = None,
                ready_file: Optional[str] = None,
                warmup: Optional[dict] = None, device=None) -> int:
    """Run the checking daemon on `device` (None = cuda) until
    interrupted. Binds, then prints one JSON line naming the bound port
    (port 0 = ephemeral), also written to ``ready_file`` when given. The
    daemon's whole life runs under one obs capture, so /metrics is
    live."""
    daemon = ServeDaemon(store_root=store_root,
                         default_model=default_model,
                         coalesce_ms=coalesce_ms, max_batch=max_batch,
                         max_inflight=max_inflight, warmup=warmup,
                         device=device)
    httpd = web_server.StoreServer((host, port),
                                   make_serve_handler(store_root, daemon))
    actual_port = httpd.server_address[1]
    # `warmed`: the CLI builds every kernel and runs one warm check before
    # it calls this, so ready implies warm unless JEPSEN_TPU_NO_WARMUP
    # skipped the check.
    ready = {"serving": f"http://{host}:{actual_port}",
             "port": actual_port, "store": str(store_root),
             "check": True, "warmed": warmup is not None}
    with obs.capture():
        print(json.dumps(ready), flush=True)
        if ready_file:
            Path(ready_file).write_text(json.dumps(ready))
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            daemon.close()
            httpd.server_close()
    return 0
