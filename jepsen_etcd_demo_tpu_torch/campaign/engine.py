"""The campaign executor: run many scenarios, check them on the card in
corpus batches, triage what falsifies, shrink, bank.

  1. **Execute.** Sim specs run a real composed fake_test on the
     virtual-time loop (vclock.py), deterministic and milliseconds a
     scenario, across a pool of worker threads. Live specs run one after
     another against a fresh in-process minietcd cluster (cluster.py)
     with stream/'s fail-fast session attached, so a falsified live run
     ends as soon as its streamed frontier dies. (One at a time because
     the disk-fault plane sets a process-wide env gate for its window,
     and live runs take real time either way.)
  2. **Check.** Every run's per-key histories are encoded once and
     checked in batches, one model at a time: `route="direct"` through
     sched.submit_corpus (the bucketed launches on the corpus
     executor), `route="serve"` as waves of the serve scheduler's
     CAMPAIGN_TENANT, the campaign as one more tenant of checking as a
     service.
  3. **Triage.** Falsifying keys classify into anomaly signatures
     (triage.classify); duplicates dedupe; the smallest witness of each
     signature is shrunk by ddmin to a 1-minimal counterexample, each
     round's candidates one batched launch.
  4. **Bank.** Minimal witnesses whose verdicts agree across the dense,
     corpus and oracle routes (triage.verify_routes) land in the
     regression corpus (bank.py) with the spec that made them.

The same (specs, seed) gives the same histories (sim), verdicts,
signatures and minimal witnesses, as in the JAX package; specs_per_sec
and wall_s are reported, not part of that. Every check runs on `device`
(None = cuda); without a card run_campaign raises before it runs a
scenario. The JAX package also records `campaign.execute`, `check` and
`shrink` spans; the port has no span tracer.
"""

from __future__ import annotations

import asyncio
import logging
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from .. import obs, sched
from ..checkers.independent import split_by_key
from ..device import resolve_device
from ..checkers.linearizable import Linearizable
from ..ops.encode import EncodeError
from ..ops.op import Op
from ..runner.history import HistoryRecorder
from . import triage
from .bank import bank_witness
from .specs import ScenarioSpec, sample_specs
from .vclock import run_virtual

log = logging.getLogger(__name__)

# Check-wave size: histories a corpus submission. It bounds the host's
# stacking memory; the serve route chunks its waves by max_inflight.
WAVE = 512

# A history with more ops pending at once than this (mostly pending
# forever, piled up by reincarnated processes) blows the sort search's
# frontier up as C(pending, k), the shape a run's check budget turns
# into "unknown". The campaign has no per-key budget, so such keys are
# skipped and counted (campaign.keys_skipped_hard,
# report.keys_skipped_hard): an "unknown", never a silent drop.
HARD_PENDING_CAP = 24


@dataclass
class SpecOutcome:
    """One executed scenario, pre-check."""

    spec: ScenarioSpec
    keyed: dict[Any, list[Op]] = field(default_factory=dict)
    ops: int = 0
    aborted: bool = False
    error: Optional[str] = None


@dataclass
class CampaignReport:
    seed: int
    route: str
    specs: int = 0
    executed: int = 0
    run_errors: int = 0
    aborted_runs: int = 0
    keys_checked: int = 0
    keys_skipped_hard: int = 0
    encode_errors: int = 0
    falsified_runs: int = 0
    falsified_keys: int = 0
    signatures: dict[str, dict] = field(default_factory=dict)
    shrinks: list[dict] = field(default_factory=list)
    banked: list[str] = field(default_factory=list)
    replay: Optional[dict] = None
    # Folded check_corpus launch stats — direct route only (the serve
    # route's batches belong to the scheduler; see serve_route).
    sched: dict = field(default_factory=dict)
    wall_s: float = 0.0
    specs_per_sec: float = 0.0

    def to_dict(self) -> dict:
        return {
            "seed": self.seed, "route": self.route, "specs": self.specs,
            "executed": self.executed, "run_errors": self.run_errors,
            "aborted_runs": self.aborted_runs,
            "keys_checked": self.keys_checked,
            "keys_skipped_hard": self.keys_skipped_hard,
            "encode_errors": self.encode_errors,
            "falsified_runs": self.falsified_runs,
            "falsified_keys": self.falsified_keys,
            "unique_signatures": len(self.signatures),
            "signatures": self.signatures,
            "shrinks": self.shrinks,
            "banked": self.banked,
            "replay": self.replay,
            "sched": self.sched,
            "wall_s": round(self.wall_s, 3),
            "specs_per_sec": round(self.specs_per_sec, 2),
        }


# -- execute ----------------------------------------------------------------

def _execute_sim(spec: ScenarioSpec, device=None) -> SpecOutcome:
    """One deterministic virtual-time run of the composed fake test.
    fake_test builds the FakeKVStore from the opts, and spec.test_opts()
    carries the seed, op_delay and every seeded fault. `device` is the
    one the composed checkers would run on; the run checks nothing."""
    from ..compose import fake_test
    from ..runner.core import run_workload

    test = fake_test({**spec.test_opts(), "device": device})

    async def main(loop, recorder):
        return await run_workload(test, recorder)

    out = SpecOutcome(spec=spec)
    try:
        history = run_virtual(main)
    except Exception as e:   # a single broken scenario must not end the
        out.error = f"{type(e).__name__}: {e}"        # campaign
        log.exception("campaign spec %d (sim) crashed", spec.spec_id)
        return out
    out.ops = sum(1 for op in history if op.type == "invoke")
    out.keyed = _split(spec, history)
    return out


def _execute_live(spec: ScenarioSpec, device=None) -> SpecOutcome:
    """One live run against a fresh in-process minietcd cluster, with
    the stream fail-fast session on `device` attached: a falsified run
    ends as soon as the streamed frontier dies. It runs on the loop
    `cli test` runs on (runner.event_loop)."""
    import tempfile

    from ..compose import compose_test
    from ..db.fake import FakeDB
    from ..nemesis import NoopNemesis
    from ..nemesis.cluster_faults import (DiskFaultNemesis,
                                          LeaseSkewNemesis,
                                          MemberChurnNemesis)
    from ..runner.core import event_loop, run_workload
    from ..stream import session_for_test
    from .cluster import MiniCluster

    out = SpecOutcome(spec=spec)
    with tempfile.TemporaryDirectory() as td:
        cluster = MiniCluster(
            nodes=[f"n{i + 1}" for i in range(spec.nodes)], data_dir=td)
        session = None
        try:
            test = compose_test({**spec.test_opts(), "device": device},
                                cluster.conn_factory())
            test["db"] = FakeDB()   # members are already serving
            nem = {
                "member-churn": lambda: MemberChurnNemesis(
                    cluster, seed=spec.seed,
                    fork=bool(spec.faults.get("churn_fork"))),
                "disk-full": lambda: DiskFaultNemesis(
                    cluster, mode="disk-full", seed=spec.seed),
                "corrupt-write": lambda: DiskFaultNemesis(
                    cluster, mode="corrupt-write", seed=spec.seed),
                "lease-skew": lambda: LeaseSkewNemesis(
                    cluster, seed=spec.seed),
            }.get(spec.nemesis, NoopNemesis)()
            test["nemesis"] = nem
            session = session_for_test(test)
            recorder = HistoryRecorder(
                listener=session.feed if session else None)
            if session is not None:
                session.enable_eager_flush()

            def stop_check():
                if session.falsified():
                    session.aborted = True
                    return True
                return False

            async def go():
                return await run_workload(
                    test, recorder,
                    stop_check=stop_check if session else None)

            history = asyncio.run(go(), loop_factory=event_loop)
            out.ops = sum(1 for op in history if op.type == "invoke")
            out.keyed = _split(spec, history)
        except Exception as e:
            out.error = f"{type(e).__name__}: {e}"
            log.exception("campaign spec %d (live) crashed", spec.spec_id)
        finally:
            if session is not None:
                # Join the consumer thread on every exit: a crashed run
                # that skipped finalize would leave one stream thread
                # behind a failing spec.
                out.aborted = session.aborted
                session.finalize()
            cluster.close()
    return out


def _split(spec: ScenarioSpec, history: list[Op]) -> dict[Any, list[Op]]:
    if spec.keyed:
        return split_by_key(history)
    return {None: [op for op in history if op.process != "nemesis"]}


# -- check routing ----------------------------------------------------------

RouteCheck = Callable[[list, Any], list]   # (encs, model) -> results


def direct_route(stats_sink: dict, device=None) -> RouteCheck:
    """sched.check_corpus on `device` in WAVE-sized submissions through
    the process's one corpus executor (so it takes turns with a serve
    daemon in the same process)."""

    def route(encs, model):
        results = []
        for i in range(0, len(encs), WAVE):
            outs, _kernel, stats = sched.submit_corpus(
                encs[i:i + WAVE], model, device=device).result()
            sched.fold_stats(stats_sink, stats)
            results.extend(outs)
        return results

    return route


def serve_route(scheduler) -> RouteCheck:
    """Every wave to the serve scheduler as the campaign tenant
    (serve/scheduler.CAMPAIGN_TENANT): the campaign's checks share the
    batches interactive tenants ride, one turn a tenant. The scheduler
    owns its launches (serve.* metrics), so CampaignReport.sched stays
    empty on this route."""
    from ..serve.scheduler import CAMPAIGN_TENANT

    def route(encs, model):
        results = []
        bound = max(1, scheduler.max_inflight())
        for i in range(0, len(encs), bound):
            reqs = scheduler.submit_many(CAMPAIGN_TENANT,
                                         encs[i:i + bound],
                                         model_name=model.name)
            for req in reqs:
                if not req.wait(300):
                    raise TimeoutError(
                        "campaign serve-route verdict timed out")
                one = req.result
                if one is None or one.get("route") == "error":
                    # A batch the card failed ({"valid": None, "route":
                    # "error"}): reading it as "did not falsify" would
                    # turn a failed check into a clean scenario (and let
                    # ddmin bank a witness that is not minimal). The
                    # direct route raises; so does this one.
                    raise RuntimeError(
                        "campaign serve-route check failed: "
                        f"{(one or {}).get('error', 'no result')}")
                results.append(one)
        return results

    return route


# -- the campaign -----------------------------------------------------------

def run_campaign(n_specs: int = 256, seed: int = 0,
                 specs: Optional[list[ScenarioSpec]] = None,
                 families: Optional[list[str]] = None,
                 bug_rate: float = 0.25, live: int = 0,
                 scale: float = 1.0, workers: int = 4,
                 route: str = "direct", scheduler=None,
                 shrink: bool = True, bank: bool = True,
                 store_root: Optional[str] = None,
                 max_shrink_checks: int = 4096,
                 device=None) -> CampaignReport:
    """Run one campaign end to end (module docstring) on `device` (None =
    cuda). `specs` replaces the sampler; `scheduler` is a serve
    scheduler for route="serve" (otherwise one is made and closed here
    on `device`); banking needs `store_root`."""
    dev = resolve_device(device)
    m = obs.get_metrics()
    t0 = time.perf_counter()
    if specs is None:
        specs = sample_specs(n_specs, seed, families=families,
                             bug_rate=bug_rate, live=live, scale=scale)
    report = CampaignReport(seed=seed, route=route, specs=len(specs))

    own_scheduler = None
    if route == "serve" and scheduler is None:
        from ..serve.scheduler import CoalescingScheduler

        scheduler = own_scheduler = CoalescingScheduler(coalesce_ms=2,
                                                        device=dev)
    try:
        route_check = (serve_route(scheduler) if route == "serve"
                       else direct_route(report.sched, dev))

        # 1. Execute: sim specs across the pool (deterministic
        # per-spec; pool.map preserves order), live specs sequential.
        sim = [s for s in specs if s.backend == "sim"]
        live_specs = [s for s in specs if s.backend != "sim"]
        outcomes: dict[int, SpecOutcome] = {}
        with ThreadPoolExecutor(max_workers=max(1, workers),
                                thread_name_prefix="campaign") as pool:
            for out in pool.map(lambda s: _execute_sim(s, dev), sim):
                outcomes[out.spec.spec_id] = out
        for spec in live_specs:
            outcomes[spec.spec_id] = _execute_live(spec, dev)
        ordered = [outcomes[s.spec_id] for s in specs]
        report.executed = sum(1 for o in ordered if o.error is None)
        report.run_errors = sum(1 for o in ordered if o.error is not None)
        report.aborted_runs = sum(1 for o in ordered if o.aborted)
        m.counter("campaign.specs").add(len(specs))
        m.counter("campaign.aborted_runs").add(report.aborted_runs)

        # 2. Check: encode every key once, corpus-batch per model.
        by_model: dict[str, list[tuple[int, Any, list[Op]]]] = {}
        for o in ordered:
            for key, hist in sorted(o.keyed.items(),
                                    key=lambda kv: str(kv[0])):
                if hist:
                    by_model.setdefault(o.spec.model_name, []).append(
                        (o.spec.spec_id, key, hist))
        falsified: list[tuple[ScenarioSpec, Any, list[Op], dict]] = []
        spec_of = {s.spec_id: s for s in specs}
        for model_name in sorted(by_model):
            entries = by_model[model_name]
            lin = Linearizable(model_name, device=dev)
            encs, kept = [], []
            for sid, key, hist in entries:
                try:
                    enc = lin.encode(hist)
                except (EncodeError, ValueError):
                    report.encode_errors += 1
                    continue
                if enc.n_events == 0:
                    continue
                if enc.max_pending > HARD_PENDING_CAP:
                    # The combinatorial-frontier shape (see
                    # HARD_PENDING_CAP): an honest "unknown".
                    report.keys_skipped_hard += 1
                    m.counter("campaign.keys_skipped_hard").add(1)
                    continue
                encs.append(enc)
                kept.append((sid, key, hist))
            if not encs:
                continue
            results = route_check(encs, lin.model)
            report.keys_checked += len(encs)
            for (sid, key, hist), one in zip(kept, results):
                if one.get("valid") is False:
                    falsified.append((spec_of[sid], key, hist, one))
        m.counter("campaign.keys_checked").add(report.keys_checked)
        report.falsified_keys = len(falsified)
        report.falsified_runs = len({s.spec_id for s, *_ in falsified})
        m.counter("campaign.runs_falsified").add(report.falsified_runs)

        # 3. Triage: signature dedupe, then one shrink a signature.
        groups: dict[str, dict] = {}
        for spec, key, hist, result in falsified:
            model = Linearizable(spec.model_name, device=dev).model
            sig = triage.classify(spec.family, model, hist, result)
            g = groups.setdefault(sig.slug, {
                "sig": sig, "count": 0, "witnesses": []})
            g["count"] += 1
            g["witnesses"].append((spec, key, hist, result))
        m.gauge("campaign.unique_signatures").set(len(groups))
        for slug in sorted(groups):
            g = groups[slug]
            sig: triage.Signature = g["sig"]
            # The cheapest witness shrinks fastest; the tiebreak keeps
            # representative selection deterministic.
            spec, key, hist, result = min(
                g["witnesses"],
                key=lambda w: (len(w[2]), w[0].spec_id, str(w[1])))
            report.signatures[slug] = {
                **sig.to_dict(), "count": g["count"],
                "example_spec": spec.spec_id,
                "example_key": None if key is None else str(key),
                "witness_ops": len(hist),
            }
            if not shrink:
                continue
            model = Linearizable(spec.model_name, device=dev).model
            check_batch = triage.make_check_batch(model, route_check, dev)
            sres = triage.ddmin_shrink(hist, check_batch,
                                       max_checks=max_shrink_checks)
            sres.verify = triage.verify_routes(sres.minimal, model, dev)
            m.counter("campaign.shrink_checks").add(sres.checks)
            m.counter("campaign.shrink_launches").add(sres.launches)
            if sres.from_ops:
                m.gauge("campaign.shrink_ratio").set(
                    sres.to_ops / sres.from_ops)
            shrink_rec = {
                "signature": slug,
                "from_ops": sres.from_ops, "to_ops": sres.to_ops,
                "rounds": sres.rounds, "checks": sres.checks,
                "launches": sres.launches,
                "one_minimal": sres.one_minimal,
                "budget_exhausted": sres.budget_exhausted,
                "verified_identical": sres.verify.get("identical"),
            }
            report.shrinks.append(shrink_rec)
            # 4. Bank: only route-verified, still-falsifying minima.
            if bank and store_root is not None \
                    and sres.verify.get("identical") \
                    and sres.verify["batched"]["valid"] is False:
                path = bank_witness(
                    store_root, sig, spec.model_name, sres.minimal,
                    expect={
                        "valid": False,
                        "dead_step":
                            sres.verify["batched"]["dead_step"]},
                    spec=spec.to_dict(),
                    campaign={"seed": seed, "specs": len(specs),
                              "route": route},
                    shrink=shrink_rec)
                report.banked.append(str(path))
                m.counter("campaign.banked").add(1)
    finally:
        if own_scheduler is not None:
            own_scheduler.close()
    report.wall_s = time.perf_counter() - t0
    report.specs_per_sec = (len(specs) / report.wall_s
                            if report.wall_s else 0.0)
    m.gauge("campaign.specs_per_sec").set(report.specs_per_sec)
    return report
