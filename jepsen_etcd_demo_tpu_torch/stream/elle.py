"""The streaming elle check: the dependency graph grows while the run
goes on.

  * A txn is stable once its completion is recorded: elle's inference
    reads completed txns only. History positions are counted as the
    post-hoc pairing counts them (every recorded op, nemesis ops
    included), so the realtime edges are the same.
  * Completed txns feed the checker's own ElleGraph (checkers/elle.py),
    which derives again only the keys a txn touched.
  * Every `limits().elle_stream_flush` completed txns (or after an idle
    interval under `--fail-fast`) the graph is checked again: its direct
    anomalies, then cycle presence through the routed closure
    (ops/cycles.cycle_mask on the checker's device, the tiled kernel for
    big components). Edges only accumulate as txns complete, so an
    anomaly of a prefix is one of the whole history: the fail-fast
    trigger is sound.
  * finalize resolves the invokes still open as info, as the pairing
    does, and runs ElleChecker._check_graph on the graph: the post-hoc
    check's own code on the same state, so the results are equal.

A valid streamed verdict settles in ElleChecker.check through
`opts["stream_results"]["elle"]`; an invalid run is checked again
post-hoc.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Any, Optional

from ..ops import cycles
from ..ops.limits import limits
from ..ops.op import Op

log = logging.getLogger(__name__)

_DONE = object()


class ElleStreamSession:
    """The run's side of the streaming elle check: a queue and one
    consumer thread that feed completed txns into an ElleGraph and check
    it again every few txns (the `--fail-fast` trigger). It offers
    StreamSession's interface, so the runner treats both alike."""

    def __init__(self, checker):
        from ..checkers.elle import ElleGraph

        self.checker = checker
        self.aborted = False        # set by the runner's fail-fast watcher
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._graph = ElleGraph()
        self._pending: dict[Any, tuple[int, Op]] = {}
        self._pos = 0               # history position (the pairing's index)
        self._since_flush = 0
        self._txns = 0
        self._txns_live = 0
        self._rechecks = 0
        self._recheck_s = 0.0
        self._falsified = False
        self._broken: Optional[str] = None
        self._results: Optional[dict] = None
        self._stats: dict = {}
        self._run_live = threading.Event()
        self._run_live.set()
        self._done_sent = False
        self._eager_flush_s: Optional[float] = None
        self._last_flush = time.monotonic()
        self._thread = threading.Thread(target=self._consume,
                                        name="elle-stream-check",
                                        daemon=True)
        self._thread.start()

    # -- event-loop side --------------------------------------------------
    def feed(self, op: Op) -> None:
        """The recorder's listener: stamp the history position (every
        recorded op takes one, nemesis ops included), then enqueue."""
        pos = self._pos
        self._pos += 1
        if op.process == "nemesis":
            return
        self._q.put((pos, op))

    def finish_input(self) -> None:
        """The run is over; the consumer exits once the queue is drained.
        Idempotent."""
        self._run_live.clear()
        if not self._done_sent:
            self._done_sent = True
            self._q.put(_DONE)

    def enable_eager_flush(self, interval_s: float = 0.5) -> None:
        """Fail-fast mode: check the grown graph again after `interval_s`
        without new ops, even short of a full elle_stream_flush batch."""
        self._eager_flush_s = float(interval_s)

    def falsified(self) -> bool:
        """True once a re-check found an anomaly: the --fail-fast
        trigger."""
        return self._falsified

    # -- consumer thread --------------------------------------------------
    def _consume(self) -> None:
        while True:
            try:
                item = self._q.get(timeout=self._eager_flush_s)
            except queue.Empty:
                try:
                    if self._broken is None and self._since_flush \
                            and time.monotonic() - self._last_flush \
                            >= self._eager_flush_s:
                        self._recheck()
                except Exception as e:
                    self._broken = f"{type(e).__name__}: {e}"
                    log.exception("elle stream re-check failed; the "
                                  "post-hoc check takes over")
                continue
            if item is _DONE:
                return
            if self._broken is not None:
                continue   # the post-hoc check owns the verdict now
            pos, op = item
            try:
                self._feed_one(pos, op)
            except Exception as e:
                # A malformed pairing or a non-txn op, which the post-hoc
                # checker reports on the same history; or a failed launch,
                # which the post-hoc check meets again on the device.
                self._broken = f"{type(e).__name__}: {e}"
                log.warning("elle streaming check abandoned: %s",
                            self._broken)

    def _feed_one(self, pos: int, op: Op) -> None:
        from ..checkers.elle import TxnEncodeError

        if op.f != "txn":
            raise TxnEncodeError(f"non-txn op {op.f!r} in txn history")
        if op.type == "invoke":
            if op.process in self._pending:
                raise TxnEncodeError(
                    f"process {op.process} double-invoke")
            self._pending[op.process] = (pos, op)
            return
        if op.type not in ("ok", "fail", "info"):
            return
        got = self._pending.pop(op.process, None)
        if got is None:
            raise TxnEncodeError(f"completion without invoke: {op}")
        inv_pos, inv = got
        self._graph.add_txn(
            inv.value, op.type,
            op.value if op.type == "ok" else inv.value, inv_pos, pos)
        self._txns += 1
        if self._run_live.is_set():
            self._txns_live += 1
        self._since_flush += 1
        if self._since_flush >= limits().elle_stream_flush:
            self._recheck()

    def _recheck(self) -> None:
        """One probe of the graph so far: its direct anomalies, then cycle
        presence of the whole edge set through the routed closure."""
        self._since_flush = 0
        self._last_flush = time.monotonic()
        if self._falsified:
            return             # the verdict can only stay bad
        t0 = time.monotonic()
        g = self._graph
        bad = any(v for v in g.direct_anomalies().values())
        if not bad and g.oks:
            ww, wr, rw = g.edge_matrices()
            full = ww | wr | rw
            if self.checker.realtime:
                rt = g.rt_matrix()
                if rt is not None:
                    full = full | rt
            bad = bool(cycles.cycle_mask(full,
                                         device=self.checker.device).any())
        self._rechecks += 1
        self._recheck_s += time.monotonic() - t0
        if bad:
            self._falsified = True
            log.info("stream: elle graph falsified after %d txns",
                     self._txns)

    # -- check-phase side -------------------------------------------------
    def finalize(self) -> Optional[dict]:
        """Join the consumer, resolve the invokes still open as info and
        run the checker's verdict assembly: {"elle": result} (the
        opts["stream_results"] shape), or None when the session gave up
        streaming. Idempotent."""
        if self._results is not None:
            return self._results or None
        self.finish_input()
        self._thread.join()
        results: dict = {}
        if self._broken is None:
            try:
                for inv_pos, inv in self._pending.values():
                    self._graph.add_txn(inv.value, "info", inv.value,
                                        inv_pos, -1)
                self._pending.clear()
                t0 = time.monotonic()
                res = self.checker._check_graph(self._graph)
                self._recheck_s += time.monotonic() - t0
                res["streamed"] = True
                results["elle"] = res
            except Exception:
                log.exception("elle stream finalize failed; the post-hoc "
                              "check takes over")
                results = {}
        self._stats = {
            "overlap_ratio": round(self._txns_live / self._txns
                                   if self._txns else 0.0, 4),
            "txns": self._txns,
            "txns_overlapped": self._txns_live,
            "rechecks": self._rechecks,
            "recheck_s": round(self._recheck_s, 4),
            "failfast_aborted": self.aborted,
        }
        if self._broken:
            self._stats["fallback"] = self._broken
        self._results = results
        return results or None

    def stats(self) -> dict:
        """The results.json `stream` record (after finalize)."""
        return {**self._stats, "failfast_aborted": self.aborted}


def find_elle_checker(checker):
    """The first ElleChecker of a checker tree (through nested Composes),
    the streamable shape. ElleRwChecker is not: its rw-register
    inference derives version orders over the whole history, so it stays
    post-hoc. IndependentChecker trees are not walked: elle checks whole
    txn histories, never per-key splits."""
    from ..checkers.compose import Compose
    from ..checkers.elle import ElleChecker, ElleRwChecker

    if isinstance(checker, ElleChecker) \
            and not isinstance(checker, ElleRwChecker):
        return checker
    if isinstance(checker, Compose):
        for sub in checker.checkers.values():
            found = find_elle_checker(sub)
            if found is not None:
                return found
    return None
