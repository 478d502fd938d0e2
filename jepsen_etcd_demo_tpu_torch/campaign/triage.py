"""Triage: anomaly signatures and the batched ddmin shrinker.

A campaign that falsifies hundreds of runs is useful only if those runs
collapse into a handful of bugs. Two pieces do that:

  * **Signatures.** Each falsifying per-key history is classified by
    (workload family, model, anomaly kind, failing op), from the verdict:
    the dead return step maps back through the encoder's pairing
    (ops/encode.pair_history: the ok completions in completion order are
    the return steps) to the op whose return emptied the frontier, and
    that op's function names the anomaly. Witnesses of one signature
    dedupe; one of them is shrunk and banked.

  * **ddmin** (Zeller and Hildebrandt's delta debugging) over logical
    operations (an invoke and its completion go together, so every
    candidate is a well-paired history). Each round's subsets and
    complements are checked as one corpus launch on the card
    (sched.check_corpus) rather than one launch a candidate. Verdicts
    are pure functions of the candidate, and the round takes the first
    failing candidate in a fixed order (subsets, then complements, each
    in split order), so the batched search visits exactly the states a
    sequential ddmin in that order visits. It ends 1-minimal: removing
    any one remaining op makes the history pass.

Each minimal witness is checked again by the single-history dense route,
the corpus route and the host oracle before it is banked
(`verify_routes`): valid and dead_step must agree, or it is not banked.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

from ..checkers.linearizable import Linearizable
from ..ops.encode import OK, EncodeError, pair_history
from ..ops.op import INVOKE, Op

# The anomaly taxonomy: failing-op function -> anomaly kind. The
# function that killed the frontier names the observable contradiction
# (a read that no linearization explains is a stale/invented read, a
# dequeue is an order/duplication violation, ...). Unlisted functions
# fall back to "nonlinearizable-<f>".
ANOMALY_BY_F = {
    "read": "stale-read",
    "write": "unwritable-state",
    "cas": "cas-divergence",
    "dequeue": "queue-order",
    "enqueue": "queue-loss",
    "add": "set-divergence",
}


@dataclass(frozen=True)
class Signature:
    """The dedupe key of one bug class."""

    family: str
    model: str
    anomaly: str
    failing_f: str

    @property
    def slug(self) -> str:
        return "-".join((self.family, self.model, self.anomaly)) \
            .replace("/", "_")

    def to_dict(self) -> dict:
        return {"family": self.family, "model": self.model,
                "anomaly": self.anomaly, "failing_f": self.failing_f,
                "slug": self.slug}


def failing_op(history: Sequence[Op], model, dead_step: int
               ) -> Optional[Op]:
    """The concrete completion op whose return step killed the
    frontier. Return steps are exactly the ok completions of the
    model-translated history in completion order (ops/encode.py
    _timeline_points: fail ops and info reads never emit EV_RETURN), so
    dead_step indexes that list directly."""
    prepared = model.prepare_history(
        [op for op in history if op.process != "nemesis"])
    try:
        invs = pair_history(prepared, model)
    except EncodeError:
        return None
    oks = sorted((i for i in invs if i.status == OK),
                 key=lambda i: i.complete_index)
    if not 0 <= dead_step < len(oks):
        return None
    return prepared[oks[dead_step].complete_index]


def classify(family: str, model, history: Sequence[Op],
             result: dict) -> Signature:
    """Signature of one falsifying (history, verdict) pair."""
    op = failing_op(history, model, int(result.get("dead_step", -1)))
    f = op.f if op is not None else "unknown"
    anomaly = ANOMALY_BY_F.get(f, f"nonlinearizable-{f}")
    return Signature(family=family, model=model.name, anomaly=anomaly,
                     failing_f=f)


# -- logical-op grouping ----------------------------------------------------

def logical_ops(history: Sequence[Op]) -> list[list[Op]]:
    """Group history entries into logical operations: each invoke with
    its completion (paired by process, jepsen's one-outstanding-op
    worker model). Removing a whole group always leaves a well-paired
    candidate history. Stray completions (no pending invoke — cannot
    occur in recorder output) group alone."""
    groups: list[list[Op]] = []
    open_of: dict = {}
    for op in history:
        if op.type == INVOKE:
            grp = [op]
            groups.append(grp)
            open_of[op.process] = grp
        else:
            grp = open_of.pop(op.process, None)
            if grp is None:
                groups.append([op])
            else:
                grp.append(op)
    return groups


def _rebuild(groups: Sequence[list[Op]]) -> list[Op]:
    """Flatten a group subset back into a history in original record
    order (seq when stamped, else index — both total orders on one
    key's entries)."""
    ops = [op for grp in groups for op in grp]
    ops.sort(key=lambda o: (o.seq if o.seq >= 0 else o.index, o.index))
    return ops


# -- ddmin ------------------------------------------------------------------

CheckBatch = Callable[[list[list[Op]]], list[bool]]
#   candidates -> [still_falsifies?] — ONE batched corpus launch.


@dataclass
class ShrinkResult:
    minimal: list[Op]
    from_ops: int                     # logical ops before shrinking
    to_ops: int                       # logical ops after
    rounds: int = 0
    checks: int = 0                   # candidate histories re-checked
    launches: int = 0                 # batched check launches
    one_minimal: bool = False
    budget_exhausted: bool = False
    verify: dict = field(default_factory=dict)


def _partition(ops: list, n: int) -> list[list]:
    """Split into n near-even contiguous chunks (every chunk non-empty
    when n <= len)."""
    k, m = divmod(len(ops), n)
    out, start = [], 0
    for i in range(n):
        size = k + (1 if i < m else 0)
        out.append(ops[start:start + size])
        start += size
    return [c for c in out if c]


def ddmin_shrink(history: Sequence[Op], check_batch: CheckBatch,
                 max_checks: int = 4096) -> ShrinkResult:
    """Delta-debug `history` (already known falsifying) to a 1-minimal
    counterexample. `check_batch` re-checks a whole round's candidates
    as one corpus launch; `max_checks` bounds total candidate checks —
    on exhaustion the smallest failing history found so far is returned
    with budget_exhausted=True (still a witness, just not proven
    1-minimal)."""
    ops = logical_ops(history)
    res = ShrinkResult(minimal=list(history), from_ops=len(ops),
                       to_ops=len(ops))
    if len(ops) < 2:
        res.one_minimal = True
        return res
    n = 2
    while len(ops) >= 2:
        if res.checks >= max_checks:
            res.budget_exhausted = True
            break
        res.rounds += 1
        chunks = _partition(ops, n)
        # Candidate order is the soundness anchor: subsets first, then
        # complements, each in split order — the batched check learns
        # every verdict, the reduction applies the FIRST failing one.
        candidates = list(chunks)
        if len(chunks) > 2:
            candidates += [[g for c2 in chunks if c2 is not c for g in c2]
                           for c in chunks]
        histories = [_rebuild(c) for c in candidates]
        verdicts = check_batch(histories)
        res.checks += len(histories)
        res.launches += 1
        hit = next((i for i, bad in enumerate(verdicts) if bad), None)
        if hit is None:
            if n >= len(ops):
                # Every single-op-removed complement passes: 1-minimal.
                res.one_minimal = True
                break
            n = min(len(ops), 2 * n)
            continue
        if hit < len(chunks):
            ops = candidates[hit]
            n = 2
        else:
            ops = candidates[hit]
            n = max(n - 1, 2)
        res.minimal = _rebuild(ops)
        res.to_ops = len(ops)
        if len(ops) == 1:
            res.one_minimal = True
            break
    # n == 2 complements ARE the subsets (each chunk is the other's
    # complement), so the len(chunks) > 2 guard above skips the
    # duplicates — but then a 2-op history terminates via the subset
    # arm or the n >= len(ops) exit, both covered.
    res.to_ops = len(ops)
    return res


# -- cross-route verification ----------------------------------------------

def verify_routes(history: Sequence[Op], model, device=None) -> dict:
    """Check a minimal witness again on both routes of the card and on the
    host oracle, and compare the verdicts:

      * the dense single-history route, wgl3_kernels.
        check_batch_encoded_auto on [enc], what `analyze` resolves
        through;
      * the corpus route, sched.check_corpus on the witness twice (two
        entries keep the scheduler on its bucketed launch, not its
        one-history bypass; both verdicts are the same function of the
        history);
      * the pure-Python search (checkers/oracle.py).

    Returns the record the bank keeps; `identical` is the gate the
    campaign holds before banking. `device` is where the two routes run
    (None = cuda)."""
    import numpy as np

    from .. import sched
    from ..checkers.oracle import _event_to_step, check_events_oracle
    from ..ops import wgl3_kernels

    lin = Linearizable(model, device=device)
    enc = lin.encode([op for op in history if op.process != "nemesis"])
    dense_out, dense_kernel = wgl3_kernels.check_batch_encoded_auto(
        [enc], lin.model, lin.device)
    dense = dense_out[0]
    batch_out, batch_kernel, _stats = sched.check_corpus(
        [enc, enc], lin.model, device=lin.device)
    batched = batch_out[0]
    oracle = check_events_oracle(enc, lin.model).to_dict()
    oracle_dead = _event_to_step(enc, oracle["dead_event"])
    # max_frontier belongs to the two card routes (the oracle has none).
    # The JAX package leaves it out when a tiny witness took its host
    # oracle route; the port has no such route.
    identical = (
        bool(dense["valid"]) == bool(batched["valid"])
        == bool(oracle["valid"])
        and int(dense["dead_step"]) == int(batched["dead_step"])
        == int(oracle_dead)
        and int(dense["max_frontier"]) == int(batched["max_frontier"]))
    return {
        "identical": bool(identical),
        "dense": {"valid": bool(np.asarray(dense["valid"])),
                  "dead_step": int(dense["dead_step"]),
                  "max_frontier": int(dense["max_frontier"]),
                  "kernel": dense_kernel},
        "batched": {"valid": bool(np.asarray(batched["valid"])),
                    "dead_step": int(batched["dead_step"]),
                    "max_frontier": int(batched["max_frontier"]),
                    "kernel": batch_kernel},
        "oracle": {"valid": bool(oracle["valid"]),
                   "dead_step": int(oracle_dead)},
    }


def make_check_batch(model, route_check, device=None) -> CheckBatch:
    """The engine's batched falsification probe: encode every candidate
    (one that does not encode passes: it is no witness) and check the
    others in one call of `route_check(encs, model) -> results`.
    `device` is the campaign's (None = cuda)."""
    lin = Linearizable(model, device=device)

    def check_batch(histories: list[list[Op]]) -> list[bool]:
        encs, idx = [], []
        verdicts = [False] * len(histories)
        for i, h in enumerate(histories):
            try:
                enc = lin.encode(h)
            except (EncodeError, ValueError):
                continue
            if enc.n_events == 0:
                continue
            encs.append(enc)
            idx.append(i)
        if encs:
            results = route_check(encs, lin.model)
            for i, one in zip(idx, results):
                verdicts[i] = one.get("valid") is False
        return verdicts

    return check_batch
