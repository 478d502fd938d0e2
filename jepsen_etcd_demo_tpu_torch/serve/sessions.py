"""Streaming serve sessions: tenants' live op feeds checked as they come.

`POST /check` coalesces whole histories; a session is the other way in. A
tenant opens one, posts ops as they happen, and the daemon checks the
stable prefix while the tenant's run goes on: `--check-mode stream`, with
the network in place of the in-process recorder.

Each session wraps a :class:`stream.engine.StreamSession` on the daemon's
device: an incremental encoder, the watermark, and resumable dense-sweep
chunk launches (csrc/wgl3_sweep.cu) from the session's consumer thread.
Sessions are admitted under the same per-tenant bound and the same
supervisor gate as single-shot work (wedged -> 503 + Retry-After).
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Any, Optional

from ..obs import health
from ..ops.op import Op
from .scheduler import RETRY_AFTER_INFLIGHT_S, RETRY_AFTER_S, Rejected

# Bounds on client-driven session state: the most sessions open at once
# over all tenants, and the idle age past which an abandoned session is
# finalized and dropped at the next open() (each open session holds an
# encoder and a consumer thread).
MAX_OPEN_SESSIONS = 512
SESSION_IDLE_TTL_S = 900.0


def _refuse_if_wedged(what: str) -> None:
    if health.get_supervisor().snapshot()["state"] == health.WEDGED:
        raise Rejected(f"backend wedged; not {what} "
                       f"(retry after {RETRY_AFTER_S}s)", 503,
                       retry_after_s=RETRY_AFTER_S)


class ServeSession:
    """One tenant's streaming check session on `device`. Ops are stamped
    with a session-local increasing ``seq`` (the recorder's contract the
    encoder's watermark rests on), so clients send plain op JSON, in
    order."""

    def __init__(self, tenant: str, model, model_name: str,
                 keyed: bool = False, device=None):
        from ..stream.engine import StreamSession

        self.id = uuid.uuid4().hex
        self.tenant = tenant
        self.model_name = model_name
        self.created_mono = time.monotonic()
        self.last_fed_mono = time.monotonic()
        self.ops_fed = 0
        self._seq = 0
        self._closed = False
        # Guards the seq stamp and the feed order: each POST runs on its
        # own handler thread, and interleaved stamping would corrupt the
        # stable prefix.
        self._lock = threading.Lock()
        self._session = StreamSession(model, keyed=keyed, device=device)
        self._ops: list[Op] = []    # the whole feed, for the store run

    def feed(self, ops: list[Op]) -> dict:
        # The single-shot gate: a wedged backend takes no new streaming
        # work either (the session survives; the client sends again).
        _refuse_if_wedged("accepting stream ops")
        with self._lock:
            if self._closed:
                # A feed racing a close must not answer "accepted" for
                # ops that were dropped.
                raise Rejected(f"session {self.id} already closed", 409)
            for op in ops:
                op.seq = self._seq
                self._seq += 1
                self._ops.append(op)
                self._session.feed(op)
            self.ops_fed += len(ops)
            self.last_fed_mono = time.monotonic()
            return {"accepted": len(ops), "ops_fed": self.ops_fed,
                    "falsified": self._session.falsified()}

    def close(self) -> dict:
        """Drain and finalize: the session's verdict. A session the stream
        gave up on answers ``valid: null, streamed: false`` with the
        reason, rather than guessing.

        The lock only latches ``_closed`` (a racing feed gets its 409 and
        no op lands after it); finalize(), which joins the consumer
        thread, runs outside it, so other calls on the session do not
        stall behind the drain."""
        with self._lock:
            self._closed = True
            fed = self.ops_fed
        results = self._session.finalize()
        stats = self._session.stats()
        if results is None:
            return {"valid": None, "streamed": False,
                    "error": stats.get("fallback",
                                       "no streamable verdicts"),
                    "stream": stats, "ops_fed": fed}
        keys = {}
        valid = True
        for key, res in sorted(results.items(), key=lambda kv: str(kv[0])):
            keys[str(key) if key is not None else "_"] = {
                "valid": res.get("valid"),
                "dead_step": int(res.get("dead_step", -1)),
                "op_count": int(res.get("op_count", 0)),
                "kernel": res.get("kernel"),
            }
            if res.get("valid") is not True:
                valid = False
        return {"valid": valid, "streamed": True, "keys": keys,
                "stream": stats, "ops_fed": fed}

    def idle_at(self) -> float:
        """The last-fed stamp, read under the session lock (the reaper's
        view)."""
        with self._lock:
            return self.last_fed_mono

    @property
    def ops(self) -> list[Op]:
        with self._lock:
            return list(self._ops)


class SessionManager:
    """Admission and registry of the daemon's streaming sessions on
    `device` (None = cuda)."""

    def __init__(self, max_per_tenant: Optional[int] = None, device=None):
        from ..device import resolve_device

        self.device = resolve_device(device)
        self._max_per_tenant = max_per_tenant
        self._lock = threading.Lock()
        self._sessions: dict[str, ServeSession] = {}
        self._per_tenant: dict[str, int] = {}

    def _cap(self) -> int:
        if self._max_per_tenant is not None:
            return self._max_per_tenant
        from ..ops.limits import limits

        return limits().serve_max_inflight

    def open(self, tenant: str, model, model_name: str,
             keyed: bool = False) -> ServeSession:
        _refuse_if_wedged("opening new stream sessions")
        tenant = str(tenant)
        self._reap_idle()
        with self._lock:
            if len(self._sessions) >= MAX_OPEN_SESSIONS:
                raise Rejected(
                    f"daemon at the global session bound "
                    f"({MAX_OPEN_SESSIONS}); close sessions first", 429,
                    retry_after_s=RETRY_AFTER_INFLIGHT_S)
            if self._per_tenant.get(tenant, 0) >= self._cap():
                raise Rejected(
                    f"tenant {tenant!r} at the session bound "
                    f"({self._cap()}); close sessions first", 429,
                    retry_after_s=RETRY_AFTER_INFLIGHT_S)
            sess = ServeSession(tenant, model, model_name, keyed=keyed,
                                device=self.device)
            self._sessions[sess.id] = sess
            self._per_tenant[tenant] = self._per_tenant.get(tenant, 0) + 1
        return sess

    def _reap_idle(self) -> None:
        """Finalize and drop sessions idle past SESSION_IDLE_TTL_S (run
        lazily on open(), so an idle daemon spends nothing). The registry
        is copied under the manager lock and each session's lock taken
        after releasing it, so one tenant's bulk feed does not hold up
        every other tenant's open."""
        cutoff = time.monotonic() - SESSION_IDLE_TTL_S
        with self._lock:
            sessions = list(self._sessions.items())
        for sid, s in sessions:
            if s.idle_at() < cutoff:
                self.close(sid)

    def get(self, session_id: str) -> Optional[ServeSession]:
        with self._lock:
            return self._sessions.get(session_id)

    def close(self, session_id: str) -> Optional[dict]:
        with self._lock:
            sess = self._sessions.pop(session_id, None)
            if sess is not None:
                n = self._per_tenant.get(sess.tenant, 1) - 1
                if n > 0:
                    self._per_tenant[sess.tenant] = n
                else:
                    self._per_tenant.pop(sess.tenant, None)
        if sess is None:
            return None
        verdict = sess.close()
        verdict["session_id"] = session_id
        verdict["tenant"] = sess.tenant
        verdict["model"] = sess.model_name
        return verdict

    def close_all(self) -> int:
        """Finalize every open session (the daemon's shutdown: each holds
        an encoder and a consumer thread). Returns how many closed."""
        with self._lock:
            open_ids = list(self._sessions)
        return sum(self.close(sid) is not None for sid in open_ids)

    def stats(self) -> dict:
        with self._lock:
            return {"open_sessions": len(self._sessions),
                    "per_tenant": dict(self._per_tenant)}


def op_from_dict(d: dict[str, Any]) -> Op:
    """One history entry from its HTTP JSON shape (the fields of a
    history.jsonl line, ops/op.py). 2-lists become tuples, so independent
    (key, value) ops survive the JSON trip."""
    if not isinstance(d, dict) or "type" not in d or "f" not in d:
        raise ValueError(f"op entry must be an object with type/f: {d!r}")
    v = d.get("value")
    if isinstance(v, list) and len(v) == 2:
        v = tuple(v)
    return Op(type=str(d["type"]), f=str(d["f"]), value=v,
              process=d.get("process", 0), time=int(d.get("time", 0)),
              index=int(d.get("index", -1)), error=d.get("error"),
              seq=int(d.get("seq", -1)))
