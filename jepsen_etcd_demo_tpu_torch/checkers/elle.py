"""Elle-equivalent transactional anomaly checkers: list-append
(ElleChecker) and rw-register (ElleRwChecker), the port of the JAX
package's checkers/elle.py.

  txn ops: Op(f="txn", value=[micro-op, ...]) with micro-ops
      ("append", k, v)  append v to the list under key k
      ("r", k, vs)      read the list under k (vs: None on invoke, the
                        observed list on :ok)
  (rw-register: ("w", k, v) and ("r", k, v), one value per register.)

Inference (elle's): appends are observable as list prefixes, so a read
orders every append it saw. Two reads of a key must be prefix-compatible;
consecutive observed values give ww edges writer(e_i) -> writer(e_i+1);
a read ending at e gives a wr edge writer(e) -> reader; and a read of
list L gives an rw edge reader -> writer(v) for every committed append of
a v absent from L.

Anomalies: internal, G1a (aborted read), G1b (intermediate read),
incompatible-order, duplicates, lost-append, and the cycle classes G0
(ww), G1c (ww|wr with a wr), G-single (exactly one rw), G2-item (two or
more rw); with realtime=True wall-clock order joins the graph and the
cycles that need it are reported as the "-realtime" classes. :info txns
may be observed (never G1a) but add no edges.

Cycle search runs on the routed closure engine (ops/cycles.py): one
diagonal-only probe of the full graph on the valid path, the
classification ladder's two same-size tiers closed in one batched launch,
big graphs split into weak components closed batched or through the
tiled kernel (ops/cycles_tiled.py). The witness cycle is rebuilt on the
host. Checkers take `device=None` (cuda; raises without a card) or
"cpu" (every product on the host). Results equal the JAX package's field
for field except `backend`.

The inference lives in ElleGraph, a state machine fed one completed txn
at a time; the checker feeds it the whole paired history.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Any, Sequence

import numpy as np

from ..device import resolve_device
from ..ops import cycles
from ..ops.cycles import bfs_path
from ..ops.op import Op
from .base import Checker


class TxnEncodeError(ValueError):
    pass


def _pair_txns(history: Sequence[Op]):
    """Invoke/completion pairing by process (the runner guarantees one
    outstanding op per process). Returns list of
    (invoke_value, completion_type, completion_value, invoke_pos,
    complete_pos) — positions are history indices (complete_pos = -1 when
    the txn never completed), the raw material for realtime edges."""
    pending: dict[Any, tuple[int, Op]] = {}
    txns = []
    for pos, op in enumerate(history):
        if op.process == "nemesis":   # fault-plane channel, not a txn
            continue
        if op.f != "txn":
            raise TxnEncodeError(f"non-txn op {op.f!r} in txn history")
        if op.type == "invoke":
            if op.process in pending:
                raise TxnEncodeError(f"process {op.process} double-invoke")
            pending[op.process] = (pos, op)
        elif op.type in ("ok", "fail", "info"):
            got = pending.pop(op.process, None)
            if got is None:
                raise TxnEncodeError(f"completion without invoke: {op}")
            inv_pos, inv = got
            txns.append((inv.value, op.type,
                         op.value if op.type == "ok" else inv.value,
                         inv_pos, pos))
    for inv_pos, inv in pending.values():  # still-open at history end = info
        txns.append((inv.value, "info", inv.value, inv_pos, -1))
    return txns


class ElleGraph:
    """Incremental list-append dependency-graph inference — ONE state
    machine behind the post-hoc checker (and, in the JAX package, its
    streaming session), so the two can never drift.

    Feed completed txns in history order with :meth:`add_txn`; per-key
    derived state (direct anomalies + ww/wr/rw edge contributions) is
    recomputed lazily for DIRTY keys only on :meth:`refresh` — a key is
    dirty when a new read, a new committed append, or a newly-known
    failed append touches it, which is exactly when its derived record
    can change. Every edge and every direct anomaly is derivable from
    per-key state alone, so the incremental recompute is equal by
    construction to the one-shot pass over the full history."""

    def __init__(self):
        self.oks: list[tuple] = []           # the _pair_txns 5-tuples
        self.append_of: dict[tuple, int] = {}
        self.failed_vals: set[tuple] = set()
        self.multi_appends: dict[tuple, list] = defaultdict(list)
        self.appends_by_key: dict[Any, list] = {}
        self.reads: dict[Any, list] = {}     # k -> [(reader, vs tuple)]
        self.internal: list[dict] = []       # txn-ordered
        self._dirty: set = set()
        self._per_key: dict[Any, dict] = {}

    # -- feeding ----------------------------------------------------------
    def add_txn(self, value, typ, comp_value, inv_pos: int = -1,
                comp_pos: int = -1) -> None:
        """One completed txn, in history order (the _pair_txns tuple
        shape). :ok txns join the graph; :fail txns contribute their
        append values to the aborted-read set; :info txns contribute
        nothing (their order is unknowable)."""
        if typ == "fail":
            for mop in value:
                if mop[0] == "append":
                    self.failed_vals.add((mop[1], mop[2]))
                    self._dirty.add(mop[1])
            return
        if typ != "ok":
            return
        i = len(self.oks)
        self.oks.append((value, typ, comp_value, inv_pos, comp_pos))
        own: dict[Any, list] = defaultdict(list)
        for mop in comp_value:
            if mop[0] == "append":
                k, v = mop[1], mop[2]
                if (k, v) in self.append_of:
                    raise TxnEncodeError(
                        f"append value {v!r} reused for key {k!r}")
                self.append_of[(k, v)] = i
                self.multi_appends[(i, k)].append(v)
                self.appends_by_key.setdefault(k, []).append((v, i))
                self._dirty.add(k)
                own[k].append(v)
            elif mop[0] == "r" and mop[2] is not None:
                k = mop[1]
                # Internal consistency: a read of k must observe the
                # txn's own earlier appends to k as the list's suffix
                # (elle's :internal — the txn's own completed micro-op
                # order, before any cross-txn inference).
                o = own[k]
                vs = list(mop[2])
                if o and vs[len(vs) - len(o):] != o:
                    self.internal.append(
                        {"key": k, "expected_suffix": list(o),
                         "read": vs, "txn": i})
                self.reads.setdefault(k, []).append((i, tuple(mop[2])))
                self._dirty.add(k)

    # -- per-key derivation ----------------------------------------------
    def refresh(self) -> None:
        for k in self._dirty:
            if k in self.reads:
                self._per_key[k] = self._derive_key(k)
        self._dirty.clear()

    def _derive_key(self, k) -> dict:
        """The full per-key derived record: direct anomaly lists (reader
        order), the observed version order, and this key's ww/wr/rw edge
        contributions — the one copy of the inference both the post-hoc
        and the streamed paths run."""
        append_of, multi_appends = self.append_of, self.multi_appends
        rec: dict[str, Any] = {"duplicates": [], "G1a": [],
                               "lost-append": [], "G1b": [],
                               "incompatible-order": []}
        obs = self.reads[k]
        for reader, vs in obs:
            if len(set(vs)) != len(vs):
                rec["duplicates"].append(
                    {"key": k, "read": list(vs), "reader": reader})
            for v in vs:
                if (k, v) in self.failed_vals \
                        and (k, v) not in append_of:
                    rec["G1a"].append(
                        {"key": k, "value": v, "reader": reader})
            # A committed txn's appends to k are atomic: they occupy a
            # contiguous run of the true list, and any read is a prefix
            # of that list. So an observed value must have the writer's
            # previous append IMMEDIATELY before it, and — unless the
            # read ends there — the writer's next append immediately
            # after it. A violation proves an acked append vanished
            # (lost-append), regardless of which txn wrote the value
            # that sits there instead.
            for p, v in enumerate(vs):
                owner = append_of.get((k, v))
                if owner is None or owner == reader:
                    continue
                own = multi_appends[(owner, k)]
                i = own.index(v)
                if i > 0 and (p == 0 or vs[p - 1] != own[i - 1]):
                    rec["lost-append"].append(
                        {"key": k, "missing": own[i - 1],
                         "observed": v, "read": list(vs),
                         "writer": owner, "reader": reader})
                if (i + 1 < len(own) and p + 1 < len(vs)
                        and vs[p + 1] != own[i + 1]):
                    rec["lost-append"].append(
                        {"key": k, "missing": own[i + 1],
                         "observed": v, "read": list(vs),
                         "writer": owner, "reader": reader})
            if vs:
                owner = append_of.get((k, vs[-1]))
                if owner is not None:
                    own = multi_appends[(owner, k)]
                    if own and vs[-1] != own[-1] and owner != reader:
                        rec["G1b"].append(
                            {"key": k, "value": vs[-1],
                             "reader": reader, "writer": owner})
        # Prefix-compatibility: ascending by length, every read must
        # extend the previous longest (two equal-length reads that
        # differ fail the prefix test directly).
        longest: tuple = ()
        for _, vs in sorted(obs, key=lambda rv: len(rv[1])):
            if vs[:len(longest)] != longest:
                rec["incompatible-order"].append(
                    {"key": k, "read_a": list(longest),
                     "read_b": list(vs)})
                break
            longest = vs
        rec["order"] = longest

        # Edge contributions. ww: consecutive observed versions order
        # their writers. wr: the read's last value orders its writer
        # before the reader. rw (anti-dependency): a read returns the
        # WHOLE list, so a committed append serialized before it must
        # appear in it — contrapositive: every committed append of a
        # value ABSENT from the observed list is serialized after the
        # read, including acked appends no read ever observed. The
        # absent-writer set depends only on (key, observed
        # tuple): memoized so many readers of one prefix share a scan;
        # self-edges dropped (a txn is not its own anti-dependency).
        ww_pairs: set = set()
        for a, b in zip(longest, longest[1:]):
            wa, wb = append_of.get((k, a)), append_of.get((k, b))
            if wa is not None and wb is not None and wa != wb:
                ww_pairs.add((wa, wb))
        wr_pairs: set = set()
        rw_pairs: set = set()
        absent: dict[tuple, list] = {}
        appends = self.appends_by_key.get(k, ())
        for reader, vs in obs:
            if vs:
                wa = append_of.get((k, vs[-1]))
                if wa is not None and wa != reader:
                    wr_pairs.add((wa, reader))
            tgt = absent.get(vs)
            if tgt is None:
                seen = set(vs)
                tgt = [wb for v, wb in appends if v not in seen]
                absent[vs] = tgt
            for wb in tgt:
                if wb != reader:
                    rw_pairs.add((reader, wb))
        rec["ww"], rec["wr"], rec["rw"] = ww_pairs, wr_pairs, rw_pairs
        return rec

    # -- assembled views --------------------------------------------------
    def direct_anomalies(self) -> dict[str, list]:
        """Fresh anomaly dict of every non-cycle anomaly found so far —
        internal in txn order, then per-key lists in key-first-read
        order (the exact order the one-shot pass produced)."""
        self.refresh()
        anomalies: dict[str, list] = defaultdict(list)
        anomalies["internal"].extend(self.internal)
        if not self.internal:
            del anomalies["internal"]
        for k in self.reads:
            rec = self._per_key[k]
            for t in ("duplicates", "G1a", "lost-append", "G1b",
                      "incompatible-order"):
                if rec[t]:
                    anomalies[t].extend(rec[t])
        return anomalies

    def edge_matrices(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(ww, wr, rw) boolean matrices over the ok txns so far."""
        self.refresh()
        n = len(self.oks)
        ww = np.zeros((n, n), bool)
        wr = np.zeros((n, n), bool)
        rw = np.zeros((n, n), bool)
        for k in self.reads:
            rec = self._per_key[k]
            for m, pairs in ((ww, rec["ww"]), (wr, rec["wr"]),
                             (rw, rec["rw"])):
                if pairs:
                    idx = np.fromiter((x for p in pairs for x in p),
                                      dtype=np.intp,
                                      count=2 * len(pairs)).reshape(-1, 2)
                    m[idx[:, 0], idx[:, 1]] = True
        return ww, wr, rw

    def rt_matrix(self) -> np.ndarray | None:
        """Wall-clock order over the ok txns (A completed before B
        invoked => A precedes B) — the strict-serializability edges."""
        n = len(self.oks)
        if not n:
            return None
        inv_pos = np.array([t[3] for t in self.oks])
        comp_pos = np.array([t[4] for t in self.oks])
        return comp_pos[:, None] < inv_pos[None, :]


class ElleChecker(Checker):
    """checker/elle equivalent over list-append txn histories.

    realtime=True additionally asserts STRICT serializability: wall-clock
    completion-before-invocation order joins the dependency graph, so a
    serialization that reorders non-overlapping txns becomes a cycle
    (reported under the elle "-realtime" anomaly names)."""

    name = "elle"

    def __init__(self, realtime: bool = False, device=None):
        self.realtime = realtime
        self.device = resolve_device(device)

    @property
    def backend(self) -> str:
        return ("torch-closure-cuda" if self.device.type == "cuda"
                else "torch-closure-plain")

    def check(self, test: dict, history: Sequence[Op],
              opts: dict | None = None,
              timings: dict | None = None) -> dict[str, Any]:
        """The verdict on a txn history. When `timings` is a dict, it gets
        the host-clock seconds of each stage: pairing and inference
        ("pair_infer_s"), the direct anomalies and edge matrices
        ("edge_matrices_s"), the full graph's cycle probe split into its
        weak components ("weak_components_s") and its closures with their
        fetches ("closure_s"), and the rest of the cycle search
        ("classification_s")."""
        # A valid verdict the run's streaming elle session already
        # settled (the same ElleGraph fed live) skips the post-hoc pass
        # entirely; invalid/absent re-runs post-hoc.
        pre = ((opts or {}).get("stream_results") or {}).get("elle")
        if (isinstance(pre, dict) and pre.get("streamed")
                and pre.get("valid") is True
                and pre.get("realtime") == self.realtime):
            return pre
        t0 = time.perf_counter()
        graph = ElleGraph()
        for txn in _pair_txns(history):
            graph.add_txn(*txn)
        if timings is not None:
            timings["pair_infer_s"] = time.perf_counter() - t0
        return self._check_graph(graph, timings)

    def _check_graph(self, graph: ElleGraph,
                     timings: dict | None = None) -> dict[str, Any]:
        """Verdict assembly from an (incrementally or batch) fed graph —
        the one finalization path post-hoc and streamed checks share."""
        n = len(graph.oks)
        t0 = time.perf_counter()
        anomalies = graph.direct_anomalies()
        ww, wr, rw = graph.edge_matrices()
        rt = graph.rt_matrix() if self.realtime else None
        t1 = time.perf_counter()
        probe: dict | None = None if timings is None else {}
        self._find_cycles(ww, wr, rw, graph.oks, anomalies, rt, probe)
        if timings is not None:
            wc = probe.get("weak_components_s", 0.0)
            closure = probe.get("closure_s", 0.0)
            timings.update(edge_matrices_s=t1 - t0, weak_components_s=wc,
                           closure_s=closure,
                           classification_s=(time.perf_counter() - t1
                                             - wc - closure))

        types = sorted(anomalies)
        edge_counts = {"ww": int(ww.sum()), "wr": int(wr.sum()),
                       "rw": int(rw.sum())}
        if rt is not None:
            edge_counts["rt"] = int(rt.sum())
        return {
            "valid": not types,
            "anomaly_types": types,
            "anomalies": {t: anomalies[t] for t in types},
            "txn_count": n,
            "realtime": self.realtime,
            "edge_counts": edge_counts,
            "backend": self.backend,
        }

    # -- cycle classification --------------------------------------------
    def _find_cycles(self, ww, wr, rw, oks, anomalies, rt=None,
                     timings=None):
        """Run the classification ladder into `anomalies`; `timings`, when
        a dict, gets the full graph's probe (cycles.cycle_mask's
        stages)."""
        def witness(cyc):
            return {"cycle": cyc,
                    "txns": [list(oks[i][2]) for i in cyc[:-1]]}

        if rt is None:
            self._classify(ww, wr, rw, None, "", witness, anomalies,
                           timings)
            return
        # Realtime mode, still ONE closure launch on the (common) valid
        # path: full|rt is a superset of every tier of both ladders, so
        # acyclic(full|rt) clears them all at once. On a cycle, run the
        # serializable ladder first (its anomaly names are stronger); only
        # when the cycle NEEDS a realtime edge does the "-realtime" ladder
        # name it.
        if not cycles.cycle_mask(ww | wr | rw | rt, device=self.device,
                                 timings=timings).any():
            return
        if not self._classify(ww, wr, rw, None, "", witness, anomalies):
            self._classify(ww, wr, rw, rt, "-realtime", witness, anomalies)

    def _classify(self, ww, wr, rw, rt, suffix, witness, anomalies,
                  timings=None) -> bool:
        """One G0/G1c/G-single/G2-item classification ladder over
        ww|wr|rw (plus rt when given, with `suffix` on the anomaly
        names); `timings` goes to the full graph's probe. Returns True
        iff a cycle was found."""
        dev = self.device

        def with_rt(adj):
            return adj if rt is None else adj | rt

        # Full graph first: acyclic full graph implies every subset is
        # acyclic — ONE cycle-presence probe (diagonal-only fetch,
        # component-decomposed for big graphs) on the common valid path.
        full = with_rt(ww | wr | rw)
        cyc_f = cycles.cycle_mask(full, device=dev, timings=timings)
        if not cyc_f.any():
            return False
        # The two sub-ladder tiers share the full graph's size: ONE
        # vmapped batched launch closes both — except past the dense
        # crossover / cell budget, where each tier routes individually
        # (decomposition / tiled / host oracle) instead of stacking two
        # full-size copies.
        g0 = with_rt(ww)
        g1 = with_rt(ww | wr)
        if cycles.batchable(full.shape[0]):
            cyc_g0, cyc_g1 = cycles.cycle_masks_batch([g0, g1], dev)
        else:
            cyc_g0 = cycles.cycle_mask(g0, device=dev)
            cyc_g1 = cycles.cycle_mask(g1, device=dev)
        if cyc_g0.any():
            anomalies["G0" + suffix].append(witness(
                cycles.extract_cycle_any(g0, cyc_g0)))
        if cyc_g1.any() and not cyc_g0.any():
            anomalies["G1c" + suffix].append(witness(
                cycles.extract_cycle_any(g1, cyc_g1)))
        if not cyc_g1.any():
            # Cycles need rw edges. G-single holds iff SOME rw edge is
            # closed by a (ww|wr|rt)-only path (exactly one
            # anti-dependency) — exact, unlike counting rw edges on one
            # arbitrary extracted cycle, which can mis-classify when 1-rw
            # and 2-rw cycles coexist. Reachability answers come from
            # reach_pairs (per-component closures), never a full [N, N]
            # slab fetch.
            edges = list(zip(*np.nonzero(rw & ~g1)))
            hits = cycles.reach_pairs(
                g1, [(int(b), int(a)) for a, b in edges], dev)
            for (a, b), hit in zip(edges, hits):
                if hit:
                    back = bfs_path(g1, int(b), int(a))  # [b, ..., a]
                    anomalies["G-single" + suffix].append(
                        witness([int(a)] + back))
                    break
            else:
                anomalies["G2-item" + suffix].append(witness(
                    cycles.extract_cycle_any(full, cyc_f)))
        return True


class ElleRwChecker(ElleChecker):
    """elle.rw-register equivalent: transactional anomaly inference over
    REGISTER txns — elle 0.1.2's other workload family (the reference
    ships it at jepsen.etcdemo.iml:46).

      txn ops: Op(f="txn", value=[micro-op, ...]) with micro-ops
          ("w", k, v)  — write v to register k (values unique per key)
          ("r", k, v)  — read register k (v: None on invoke; the observed
                          value, or None for the initial nil, on :ok)

    Unlike list-append, a register read observes only the LAST write, so
    the per-key version order must be INFERRED rather than read off a
    list prefix. Sources (each sound for a register with unique writes
    and no deletes):
      * own-txn write order — successive writes to k inside one :ok txn;
      * writes-follow-reads — an :ok txn that reads k=v1 before its own
        first write v2 to k places v1 before v2 (the read saw the state
        its write replaced or succeeded);
      * the initial nil precedes every written version.
    The per-key version DAG is closed transitively (tiny host matrices);
    a CYCLIC version graph is itself reported (:cyclic-versions, elle's
    name) and that key contributes no ww/rw edges — deriving order from
    a contradiction would fabricate anomalies.

    Dependency edges over :ok txns, fed to the SAME G0/G1c/G-single/
    G2-item (+ -realtime) classification ladder as list-append:
      * wr  writer(v) -> reader that observed v;
      * ww  writer(v1) -> writer(v2) for v1 < v2 in the version order;
      * rw  reader of v -> writer(v2) for every v2 > v (a register holds
        the last write, so a later version's writer must serialize after
        any read that still saw v); a read of nil anti-depends on EVERY
        writer of the key.

    Direct anomalies: internal (own-txn read contradicts the state the
    txn's earlier writes OR reads established), G1a (observed a :fail
    txn's value), G1b (observed a txn's
    non-final write), garbage-read (observed a value nobody wrote),
    cyclic-versions. :info txns: their writes may legitimately be
    observed (never G1a) but contribute no edges."""

    name = "elle-rw"

    def check(self, test: dict, history: Sequence[Op],
              opts: dict | None = None) -> dict[str, Any]:
        txns = _pair_txns(history)
        oks = [t for t in txns if t[1] == "ok"]
        n = len(oks)
        anomalies: dict[str, list] = defaultdict(list)

        # Ownership: (k, v) -> ok writer idx; final write per (txn, k);
        # failed and indeterminate writes.
        writer_of: dict[tuple, int] = {}
        final_write: dict[tuple, Any] = {}
        info_vals: set[tuple] = set()
        failed_vals: set[tuple] = set()
        for i, (_, _, value, *_pos) in enumerate(oks):
            for mop in value:
                if mop[0] == "w":
                    k, v = mop[1], mop[2]
                    if (k, v) in writer_of:
                        raise TxnEncodeError(
                            f"write value {v!r} reused for key {k!r}")
                    writer_of[(k, v)] = i
                    final_write[(i, k)] = v
        for value, typ, *_rest in txns:
            if typ in ("fail", "info"):
                for mop in value:
                    if mop[0] == "w":
                        (failed_vals if typ == "fail"
                         else info_vals).add((mop[1], mop[2]))

        # Internal: each read must match the txn's own intermediate state
        # for that key — established by a prior own WRITE or a prior own
        # READ (elle's rw-register :internal covers both; a read-read
        # contradiction is flagged directly, not left to a wr/rw cycle,
        # which needs the versions to be orderable). A read also PINS the
        # observed state: later reads must agree until an own write
        # changes it.
        for i, (_, _, value, *_pos) in enumerate(oks):
            own_last: dict[Any, Any] = {}
            for mop in value:
                if mop[0] == "w":
                    own_last[mop[1]] = mop[2]
                elif mop[0] == "r":
                    if (mop[1] in own_last
                            and mop[2] != own_last[mop[1]]):
                        anomalies["internal"].append(
                            {"key": mop[1], "expected": own_last[mop[1]],
                             "read": mop[2], "txn": i})
                    own_last[mop[1]] = mop[2]

        # External reads: (reader, key, observed) with own-value reads
        # excluded (covered by internal above; no self-edges).
        ext_reads: list[tuple[int, Any, Any]] = []
        for i, (_, _, value, *_pos) in enumerate(oks):
            own_written: set = set()
            for mop in value:
                if mop[0] == "w":
                    own_written.add((mop[1], mop[2]))
                elif mop[0] == "r":
                    k, v = mop[1], mop[2]
                    if (k, v) in own_written:
                        continue
                    ext_reads.append((i, k, v))
                    if v is None:
                        continue
                    # Same guard as the append family: a value a :fail
                    # txn shares with a committed write was legitimately
                    # observable.
                    if (k, v) in failed_vals and (k, v) not in writer_of:
                        anomalies["G1a"].append(
                            {"key": k, "value": v, "reader": i})
                    elif ((k, v) not in writer_of
                            and (k, v) not in info_vals):
                        anomalies["garbage-read"].append(
                            {"key": k, "value": v, "reader": i})
                    owner = writer_of.get((k, v))
                    if owner is not None and final_write[(owner, k)] != v:
                        anomalies["G1b"].append(
                            {"key": k, "value": v, "reader": i,
                             "writer": owner})

        # Per-key version DAG -> transitive closure -> ww/rw edges.
        versions: dict[Any, list] = defaultdict(lambda: [None])
        for (k, v) in writer_of:
            versions[k].append(v)
        prec: dict[Any, np.ndarray] = {}
        for k, vs in versions.items():
            idx = {v: j for j, v in enumerate(vs)}
            m = np.zeros((len(vs), len(vs)), bool)
            m[0, 1:] = True                      # nil precedes everything
            for i, (_, _, value, *_pos) in enumerate(oks):
                last_own = None
                first_read: Any = "__none__"
                for mop in value:
                    if mop[0] == "w" and mop[1] == k:
                        if last_own is not None:
                            m[idx[last_own], idx[mop[2]]] = True
                        elif (first_read != "__none__"
                                and first_read in idx):
                            # writes-follow-reads: the pre-write read
                            m[idx[first_read], idx[mop[2]]] = True
                        last_own = mop[2]
                    elif (mop[0] == "r" and mop[1] == k
                            and last_own is None
                            and first_read == "__none__"):
                        first_read = mop[2]   # may be None = nil (idx 0)
            closure = _bool_closure(m)
            if closure.diagonal().any():
                cyc_vals = [vs[j] for j in
                            np.nonzero(closure.diagonal())[0]]
                anomalies["cyclic-versions"].append(
                    {"key": k, "values": cyc_vals})
                continue   # contradictory order: derive no edges from k
            prec[k] = closure

        ww = np.zeros((n, n), bool)
        wr = np.zeros((n, n), bool)
        rw = np.zeros((n, n), bool)
        vidx = {k: {x: j for j, x in enumerate(vs)}
                for k, vs in versions.items()}
        for k, closure in prec.items():
            vs = versions[k]
            owners = np.full(len(vs), -1, dtype=np.intp)
            for j, v in enumerate(vs[1:], start=1):
                owners[j] = writer_of[(k, v)]
            for a, b in zip(*np.nonzero(closure)):
                wa, wb = owners[a], owners[b]
                if wa >= 0 and wb >= 0 and wa != wb:
                    ww[wa, wb] = True
        for reader, k, v in ext_reads:
            # wr needs no version order — sound even when the key's
            # inferred order is contradictory (cyclic-versions only
            # withholds the order-DERIVED ww/rw edges).
            if v is not None and (k, v) in writer_of:
                wa = writer_of[(k, v)]
                if wa != reader:
                    wr[wa, reader] = True
            if k not in prec:
                continue
            vs = versions[k]
            j = vidx[k].get(v)
            if j is None:
                continue   # garbage / info value: no inferable position
            for succ in np.nonzero(prec[k][j])[0]:
                wb = writer_of[(k, vs[succ])]
                if wb != reader:
                    rw[reader, wb] = True

        rt = None
        if self.realtime and n:
            inv_pos = np.array([t[3] for t in oks])
            comp_pos = np.array([t[4] for t in oks])
            rt = comp_pos[:, None] < inv_pos[None, :]
        self._find_cycles(ww, wr, rw, oks, anomalies, rt)

        types = sorted(anomalies)
        edge_counts = {"ww": int(ww.sum()), "wr": int(wr.sum()),
                       "rw": int(rw.sum())}
        if rt is not None:
            edge_counts["rt"] = int(rt.sum())
        return {
            "valid": not types,
            "anomaly_types": types,
            "anomalies": {t: anomalies[t] for t in types},
            "txn_count": n,
            "realtime": self.realtime,
            "edge_counts": edge_counts,
            "backend": self.backend,
        }


def _bool_closure(m: np.ndarray) -> np.ndarray:
    """Transitive closure by boolean matrix squaring (host: per-key
    version matrices are tiny; the TXN graph uses the closure engine of
    ops/cycles.py)."""
    out = m.copy()
    while True:
        nxt = out | (out @ out)
        if (nxt == out).all():
            return out
        out = nxt


# -- pure-Python oracle (differential tests) -----------------------------

def tarjan_has_cycle(adj: np.ndarray) -> bool:
    """Iterative DFS cycle detection — the host oracle the closure engine
    is differentially tested against."""
    n = adj.shape[0]
    color = [0] * n   # 0 white, 1 grey, 2 black
    for root in range(n):
        if color[root]:
            continue
        stack = [(root, iter(np.flatnonzero(adj[root])))]
        color[root] = 1
        while stack:
            node, it = stack[-1]
            adv = False
            for s in it:
                s = int(s)
                if color[s] == 1:
                    return True
                if color[s] == 0:
                    color[s] = 1
                    stack.append((s, iter(np.flatnonzero(adj[s]))))
                    adv = True
                    break
            if not adv:
                color[node] = 2
                stack.pop()
    return False
