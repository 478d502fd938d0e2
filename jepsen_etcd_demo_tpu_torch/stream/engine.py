"""The streaming check: stable-prefix chunks swept while the run goes on.

Post-hoc, a test records its whole history and only then encodes and
sweeps it. The resumable dense sweep needs only a closed prefix of the
history, and the prefix closes while the run is still going, so
`test --check-mode stream` checks it as it closes:

  * the incremental encoder (ops/encode.IncrementalEncoder) emits event
    rows once they precede every still-open invoke (the watermark,
    ordered by the recorder's `Op.seq`); an op that will crash pins the
    watermark until its info completion is recorded;
  * KeyStream keeps a running slot-table snapshot of the stable rows and
    buffers one return step per EV_RETURN; every
    `limits().stream_flush_ops` of them form a chunk that one launch of
    the resumable dense sweep (ops/wgl3_kernels.stream_chunk: the
    register or shared-memory route of csrc/wgl3_sweep.cu, its global
    tier past 2^20 bits) applies to the key's carry, which lives on the
    device for the whole run. The carry's death flag is read every
    `limits().stream_max_lag_chunks` chunks: the fail-fast bound;
  * the geometry (max_pending, max_value) only grows; when the stable
    rows outgrow it, the key restarts under the bigger one from a fresh
    carry and sweeps its stable prefix again. A key no table of
    `dense_cell_budget_chunked` cells holds stops streaming and is left
    to the post-hoc check;
  * StreamSession takes the recorder's ops on the event loop (an
    enqueue) and does the rest on one consumer thread; keyed, it splits
    an independent-key history per key as checkers/independent.
    split_by_key does.

A streamed chunk always takes the plain dense sweep: no sparse sweep and
no frontier canonicalisation (a live stream cannot know which pending
ops never return). The verdict fields (valid, dead_step, max_frontier,
configs_explored) are the post-hoc dense sweep's: the stable rows are the
post-hoc encoding's prefix, the carry chains exactly across chunks, pads
do nothing, and a dead carry stays dead. The runner (runner/core.py)
wires it: the recorder's listener feeds the session, the check phase
drains and finalizes it, valid streamed keys settle in the checkers, and
invalid ones are checked again post-hoc for their witness.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Any, Optional

import numpy as np

from ..device import resolve_device
from ..models.base import Model
from ..ops import wgl3
from ..ops import wgl3_kernels as wk
from ..ops.encode import (EV_INVOKE, EV_RETURN, EncodedHistory, EncodeError,
                          IncrementalEncoder, encode_return_steps)
from ..ops.limits import limits
from ..ops.op import INVOKE, Op

log = logging.getLogger(__name__)

_DONE = object()   # end of input on the session's queue


class KeyStream:
    """One key's streaming check: the incremental encoder, the running
    slot-table snapshot and the chunks swept into the key's carry on
    `device` (None = cuda)."""

    def __init__(self, model: Model, key: Any, k_slots: int = 24,
                 device=None):
        self.model = model
        self.key = key
        self.k0 = k_slots
        self.device = resolve_device(device)
        self.encoder = IncrementalEncoder(model)
        self.cfg: Optional[wgl3.DenseConfig] = None
        self.carry = None              # (T int32[1,S,W], meta int32[1,5])
        self.steps_done = 0            # steps swept this epoch, pads included
        self.real_dispatched = 0       # real steps swept this epoch
        self.live_high = 0             # most real steps swept during the run
        self.total_high = 0            # most real steps swept
        self.chunks = 0
        self.restarts = 0
        self.dispatch_s = 0.0
        self._since_poll = 0
        self.last_flush = time.monotonic()
        self.dead = False
        self.infeasible: Optional[str] = None
        # The running slot snapshot over the stable rows, at a capacity
        # that grows (slots past max_pending are inactive zeros).
        self._tab = np.zeros((8, 4), np.int32)
        self._act = np.zeros((8,), bool)
        # Return steps waiting for a full chunk: (slot table [cap, 4],
        # active [cap], target slot).
        self._buf: list[tuple[np.ndarray, np.ndarray, int]] = []

    # -- feeding ----------------------------------------------------------
    def feed(self, op: Op, live: bool) -> None:
        self._advance(self.encoder.append(op), live)

    def _advance(self, rows, live: bool) -> None:
        if self.infeasible or not rows:
            return
        for kind, slot, f, a1, a2, rv in rows:
            if slot >= self._act.shape[0]:
                grow = max(8, slot + 1 - self._act.shape[0])
                self._tab = np.concatenate(
                    [self._tab, np.zeros((grow, 4), np.int32)])
                self._act = np.concatenate(
                    [self._act, np.zeros((grow,), bool)])
            if kind == EV_INVOKE:
                self._tab[slot] = (f, a1, a2, rv)
                self._act[slot] = True
            elif kind == EV_RETURN:
                # The snapshot just before the return: the returning op
                # counts active (encode_return_steps). After death the
                # steps change nothing, so they are not kept.
                if not self.dead:
                    self._buf.append((self._tab.copy(), self._act.copy(),
                                      int(slot)))
                self._act[slot] = False
        chunk = limits().stream_flush_ops
        while len(self._buf) >= chunk and not self.dead \
                and self.infeasible is None:
            if not self._ensure_geometry(live):
                return
            if len(self._buf) < chunk:       # a restart swept them
                break
            steps, self._buf = self._buf[:chunk], self._buf[chunk:]
            self._dispatch(steps, live, pad_to=chunk)

    def flush_partial(self, live: bool) -> None:
        """Sweep the buffered tail now as one padded chunk, without
        waiting for a full one, then read the death flag: fail-fast's
        bound for keys the workload has moved away from. Pads change
        nothing (stream_chunk), so the verdict fields stay the post-hoc
        sweep's."""
        if self.dead or self.infeasible or not self._buf:
            return
        if not self._ensure_geometry(live):
            return
        chunk = limits().stream_flush_ops
        while len(self._buf) >= chunk and not self.dead:
            steps, self._buf = self._buf[:chunk], self._buf[chunk:]
            self._dispatch(steps, live, pad_to=chunk)
        if self._buf and not self.dead:
            steps, self._buf = self._buf, []
            self._dispatch(steps, live, pad_to=chunk)
        self._poll_death()

    # -- geometry ---------------------------------------------------------
    def _needed_cfg(self) -> Optional[wgl3.DenseConfig]:
        k = wgl3.tight_k_for_pending(self.encoder.max_pending)
        if self.cfg is not None:
            k = max(k, self.cfg.k_slots)
        return wgl3.dense_config(self.model, k, self.encoder.max_value,
                                 budget=limits().dense_cell_budget_chunked)

    def _ensure_geometry(self, live: bool) -> bool:
        """True when the current geometry holds the stable rows, after a
        restart under a bigger one if they outgrew it; False (and the key
        marked infeasible, left to the post-hoc check) when no dense
        table holds them."""
        need = self._needed_cfg()
        if need is None:
            self.infeasible = (
                f"dense geometry infeasible (max_pending="
                f"{self.encoder.max_pending}, max_value="
                f"{self.encoder.max_value})")
            self._buf = []
            return False
        if need != self.cfg:
            self._restart(need, live)
        return True

    def _restart(self, cfg: wgl3.DenseConfig, live: bool) -> None:
        """Start over under `cfg`: a fresh carry, the stable rows' return
        steps rebuilt at once, their full chunks swept and the tail
        buffered again. Geometries only grow, a few times, early on."""
        if self.cfg is not None:
            self.restarts += 1
        self.cfg = cfg
        self.carry = wk.start_carry(self.model, cfg, self.device)
        self.steps_done = 0
        self.real_dispatched = 0
        self.chunks = 0
        self._since_poll = 0
        self.dead = False
        rows = self.encoder.rows
        enc = EncodedHistory(
            events=np.asarray(rows, np.int32).reshape(-1, 6),
            n_events=len(rows), n_ops=self.encoder.n_ops,
            k_slots=cfg.k_slots, max_pending=self.encoder.max_pending,
            max_value=self.encoder.max_value)
        rs = encode_return_steps(enc, self.device)
        chunk = limits().stream_flush_ops
        full = rs.n_steps // chunk * chunk
        self._buf = [(rs.slot_tabs[i], rs.slot_active[i],
                      int(rs.targets[i])) for i in range(full, rs.n_steps)]
        for c0 in range(0, full, chunk):
            self._dispatch_arrays(
                rs.slot_tabs[c0:c0 + chunk], rs.slot_active[c0:c0 + chunk],
                rs.targets[c0:c0 + chunk], live=live, real=chunk)

    # -- dispatch ---------------------------------------------------------
    def _dispatch(self, steps, live: bool, pad_to: int) -> None:
        K = self.cfg.k_slots
        tabs = np.zeros((pad_to, K, 4), np.int32)
        act = np.zeros((pad_to, K), bool)
        tgt = np.full((pad_to,), -1, np.int32)
        for i, (t, a, s) in enumerate(steps):
            w = min(K, t.shape[0])
            tabs[i, :w] = t[:w]
            act[i, :w] = a[:w]
            tgt[i] = s
        self._dispatch_arrays(tabs, act, tgt, live, real=len(steps))

    def _dispatch_arrays(self, tabs, act, tgt, live: bool,
                         real: int) -> None:
        t0 = time.monotonic()
        self.carry = wk.stream_chunk(self.carry, tabs, act, tgt, self.model,
                                     self.cfg)
        self.dispatch_s += time.monotonic() - t0
        self.last_flush = t0
        self.steps_done += tgt.shape[0]
        self.real_dispatched += real
        self.total_high = max(self.total_high, self.real_dispatched)
        if live:
            self.live_high = max(self.live_high, self.real_dispatched)
        self.chunks += 1
        self._since_poll += 1
        if self._since_poll >= limits().stream_max_lag_chunks:
            self._poll_death()

    def _poll_death(self) -> None:
        """Read the carry's death flag (a device sync on this thread); a
        dead carry stays dead, so the buffered steps are dropped."""
        self._since_poll = 0
        if self.carry is not None and not self.dead \
                and int(self.carry[1][0, 0].item()):
            self.dead = True
            self._buf = []

    def dead_step(self) -> int:
        return int(self.carry[1][0, 1].item()) if self.carry is not None \
            else -1

    # -- finalize ---------------------------------------------------------
    def finalize(self) -> Optional[dict]:
        """Sweep what is left and read the carry: the streamed result in
        the long sweep's schema (with `model`, `streamed` and `_enc`, the
        encoding), or None when the key stopped streaming (the post-hoc
        check takes it)."""
        self._advance(self.encoder.finalize(), live=False)
        enc = self.encoder.encoded_history(self.k0)
        if self.infeasible is not None:
            return None
        if enc.n_events == 0:
            return {"valid": True, "op_count": 0, "model": self.model.name,
                    "streamed": True, "_enc": enc}
        if not self._ensure_geometry(live=False):
            return None
        if self._buf and not self.dead:
            steps, self._buf = self._buf, []
            self._dispatch(steps, live=False,
                           pad_to=max(limits().stream_flush_ops, len(steps)))
        out = wk.long_result(self.carry[1][0].cpu().tolist())
        on_card = self.device.type == "cuda"
        out.update(op_count=enc.n_ops,
                   kernel=f"wgl3-dense-{'cuda' if on_card else 'plain'}"
                          f"-stream-chunked",
                   model=self.model.name,
                   table_cells=self.cfg.n_states * self.cfg.n_masks,
                   streamed=True)
        out["_enc"] = enc
        return out


class StreamSession:
    """The run's side: a queue and one consumer thread that feed the
    recorder's ops into per-key KeyStreams on `device` (None = cuda).

    `feed` (the recorder's listener) only enqueues; encoding and launches
    happen on the consumer thread while the event loop's workers run:
    that concurrency is the overlap. The check phase calls finalize();
    `--fail-fast` polls falsified() from the runner."""

    def __init__(self, model: Model, keyed: bool, k_slots: int = 24,
                 device=None):
        self.model = model
        self.keyed = keyed
        self.k0 = k_slots
        self.device = resolve_device(device)
        # The fail-fast latch: the runner's watcher sets it while the
        # consumer may be mid-launch; both the consumer and finalize
        # stop launching once it is set.
        self._abort = threading.Event()
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._streams: dict[Any, KeyStream] = {}
        self._key_of_process: dict[Any, Any] = {}
        self._falsified: dict[Any, int] = {}
        self._broken: Optional[str] = None
        self._run_live = threading.Event()
        self._run_live.set()
        self._done_sent = False
        self._eager_flush_s: Optional[float] = None
        self._lag_max = 0
        self._encode_s = 0.0
        self._results: Optional[dict] = None
        self._stats: dict = {}
        self._thread = threading.Thread(target=self._consume,
                                        name="stream-check", daemon=True)
        self._thread.start()

    @property
    def aborted(self) -> bool:
        return self._abort.is_set()

    @aborted.setter
    def aborted(self, value: bool) -> None:
        if value:
            self._abort.set()
        else:
            self._abort.clear()

    # -- event-loop side --------------------------------------------------
    def feed(self, op: Op) -> None:
        """The recorder's listener: enqueue and return."""
        if op.process == "nemesis":
            return
        self._q.put(op)

    def finish_input(self) -> None:
        """The run is over: what is swept from now on is not overlap, and
        the consumer exits once the queue is drained. Idempotent."""
        self._run_live.clear()
        if not self._done_sent:
            self._done_sent = True
            self._q.put(_DONE)

    def enable_eager_flush(self, interval_s: float = 0.5) -> None:
        """Fail-fast mode: sweep the tail of any key whose buffer sat idle
        for `interval_s`, so a falsified key the workload has left still
        trips the abort (at most one padded chunk a key per interval)."""
        self._eager_flush_s = float(interval_s)

    def falsified(self) -> bool:
        """True once some key's carry died: the --fail-fast trigger."""
        return bool(self._falsified)

    # -- consumer thread --------------------------------------------------
    def _consume(self) -> None:
        while True:
            try:
                op = self._q.get(timeout=self._eager_flush_s)
            except queue.Empty:
                # Idle with eager flush on: sweep stale buffers so a quiet
                # falsified key still trips the fail-fast watcher.
                try:
                    self._flush_stale(live=self._run_live.is_set())
                except Exception as e:
                    self._broken = f"{type(e).__name__}: {e}"
                    log.exception("streaming eager flush failed; the "
                                  "post-hoc check takes over")
                continue
            if op is _DONE:
                return
            if self._broken is not None or self._abort.is_set():
                # The post-hoc check owns every verdict now: drain cheaply
                # and launch nothing more.
                continue
            t0 = time.monotonic()
            try:
                self._feed_one(op, live=self._run_live.is_set())
            except (EncodeError, ValueError) as e:
                # A shape streaming cannot take (a malformed pairing, a
                # keyed op without (key, value)): the post-hoc checker sees
                # the same history and answers as it always does.
                self._broken = f"{type(e).__name__}: {e}"
                log.warning("streaming check abandoned: %s", self._broken)
            except Exception as e:
                # A failed build or launch: never a quiet switch to the
                # plain version; the post-hoc check runs on the device.
                self._broken = f"{type(e).__name__}: {e}"
                log.exception("streaming check failed; the post-hoc check "
                              "takes over")
            finally:
                self._encode_s += time.monotonic() - t0

    def _feed_one(self, op: Op, live: bool) -> None:
        if self.keyed:
            routed = self._route(op)
            if routed is None:
                return
            key, sub = routed
        else:
            key, sub = None, op
        ks = self._streams.get(key)
        if ks is None:
            ks = self._streams[key] = KeyStream(self.model, key, self.k0,
                                                self.device)
        ks.feed(sub, live)
        self._lag_max = max(self._lag_max, ks.encoder.lag())
        self._note_dead(key, ks)
        if self._eager_flush_s is not None:
            self._flush_stale(live)

    def _flush_stale(self, live: bool) -> None:
        """Sweep the tails of keys idle past the eager-flush interval."""
        if self._eager_flush_s is None or self._abort.is_set():
            return
        cutoff = time.monotonic() - self._eager_flush_s
        for key, ks in self._streams.items():
            if ks._buf and ks.last_flush < cutoff:
                ks.flush_partial(live)
                self._note_dead(key, ks)

    def _note_dead(self, key, ks: KeyStream) -> None:
        if ks.dead and key not in self._falsified:
            self._falsified[key] = ks.dead_step()
            log.info("stream: key %r falsified at return step %d", key,
                     self._falsified[key])

    def _route(self, op: Op):
        """checkers/independent.split_by_key, one op at a time."""
        if op.type == INVOKE:
            if not (isinstance(op.value, tuple) and len(op.value) == 2):
                raise ValueError(
                    f"independent history op without (key, value) tuple: "
                    f"{op}")
            k, v = op.value
            self._key_of_process[op.process] = k
        else:
            k = self._key_of_process.pop(op.process, None)
            if k is None:
                return None
            v = op.value[1] if (isinstance(op.value, tuple)
                                and len(op.value) == 2) else op.value
        return k, Op(type=op.type, f=op.f, value=v, process=op.process,
                     time=op.time, index=op.index, error=op.error,
                     seq=op.seq)

    # -- check-phase side -------------------------------------------------
    def finalize(self) -> Optional[dict]:
        """Join the consumer and finalize every key: {key: streamed
        result}, or None when the session gave up streaming. Idempotent.

        After a fail-fast abort nothing more is swept and nothing
        settles: a prefix proves nothing about the whole history, and the
        post-hoc check takes every key."""
        if self._results is not None:
            return self._results or None
        self.finish_input()
        self._thread.join()
        results: dict[Any, dict] = {}
        if self._abort.is_set():
            self._finalize_stats(abandoned=len(self._streams))
            self._results = {}
            return None
        if self._broken is None:
            for key, ks in self._streams.items():
                t0 = time.monotonic()
                try:
                    res = ks.finalize()
                except Exception:
                    log.exception("stream finalize failed for key %r", key)
                    res = None
                self._encode_s += time.monotonic() - t0
                if res is not None:
                    results[key] = res
        self._finalize_stats(streamed_keys=len(results))
        self._results = results
        return results or None

    def _finalize_stats(self, streamed_keys: int = 0,
                        abandoned: int = 0) -> None:
        """The results.json `stream` record. encode_s is the consumer's
        time outside the chunk launches (host encoding)."""
        dispatch_s = sum(ks.dispatch_s for ks in self._streams.values())
        total = sum(ks.total_high for ks in self._streams.values())
        live = sum(ks.live_high for ks in self._streams.values())
        self._stats = {
            "overlap_ratio": round(live / total if total else 0.0, 4),
            "keys": len(self._streams),
            "streamed_keys": streamed_keys,
            "chunks": sum(ks.chunks for ks in self._streams.values()),
            "restarts": sum(ks.restarts for ks in self._streams.values()),
            "steps_total": int(total),
            "steps_overlapped": int(live),
            "watermark_lag_max": int(self._lag_max),
            "encode_s": round(max(0.0, self._encode_s - dispatch_s), 4),
            "dispatch_s": round(dispatch_s, 4),
            "failfast_aborted": self.aborted,
        }
        if abandoned:
            self._stats["abandoned_keys"] = abandoned
        if self._broken:
            self._stats["fallback"] = self._broken

    def stats(self) -> dict:
        """The results.json `stream` record (after finalize)."""
        return {**self._stats, "failfast_aborted": self.aborted}


def session_for_test(test: dict):
    """The streaming session of a composed test, or None when its checkers
    cannot stream: no Linearizable and no ElleChecker, or a model whose
    prepare_history rewrites the history (the stream feeds raw ops). The
    caller then checks post-hoc. An ElleChecker streams through
    stream/elle.py."""
    found = _find_streamable(test.get("checker"))
    if found is None:
        from .elle import ElleStreamSession, find_elle_checker

        elle = find_elle_checker(test.get("checker"))
        return ElleStreamSession(elle) if elle is not None else None
    lin, keyed = found
    if type(lin.model).prepare_history is not Model.prepare_history:
        log.info("check-mode stream: model %r translates histories; "
                 "checking post-hoc", lin.model.name)
        return None
    return StreamSession(lin.model, keyed=keyed, k_slots=lin.k_slots,
                         device=lin.device)


def _find_streamable(checker) -> Optional[tuple]:
    """The first device-backed Linearizable of the checker tree and
    whether it sits under an IndependentChecker: (lin, keyed)."""
    from ..checkers.compose import Compose
    from ..checkers.independent import IndependentChecker
    from ..checkers.linearizable import Linearizable

    if isinstance(checker, Linearizable):
        return (checker, False) if checker.backend == "torch" else None
    if isinstance(checker, IndependentChecker):
        sub = _find_streamable(checker.sub_checker)
        return (sub[0], True) if sub is not None else None
    if isinstance(checker, Compose):
        for sub in checker.checkers.values():
            found = _find_streamable(sub)
            if found is not None:
                return found
    return None
