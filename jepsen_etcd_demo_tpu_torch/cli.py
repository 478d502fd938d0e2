"""Command line of the port.

    python -m jepsen_etcd_demo_tpu_torch.cli test -w WORKLOAD --fake
        [-q] [-r HZ] [--ops-per-key N] [--time-limit S] [--seed N] ...
        [--check-mode post|stream] [--fail-fast] [--device cuda|cpu]
    python -m jepsen_etcd_demo_tpu_torch.cli analyze <run-dir|history.jsonl>
        [-w|--workload WORKLOAD] [--model MODEL] [--device cuda|cpu]

`test` runs a whole Jepsen test against the in-process fake cluster, as
the JAX package's `test --fake` does (the reference's `lein run test -w
register`, src/jepsen/etcdemo.clj:146-199): the workload's generator
drives its client and the fake nemesis, the recorded history is checked
on the device (cuda by default; it is resolved before the run starts and
never falls back to the host), and the run directory
<store>/<name>/<timestamp>/ gets test.json, history.jsonl, results.json,
jepsen.log, the per-key timelines and encoded histories
(history-<key>.npz), and the perf charts where matplotlib imports. It
prints {"valid", "op_count", "run_seconds"} per run and exits 0 iff every
run is valid. With `--check-mode stream` the history is checked while the
run goes on (stream/), and `--fail-fast` ends a run as soon as that check
falsifies it; results.json then says `check_mode: "stream"` and carries a
`stream` record. The real-cluster path (without --fake) is not ported.

`analyze` re-checks a stored run as the JAX package's `analyze` does. The
workload comes from -w/--workload, else from the run's test.json
("workload"), else register; the model from --model, else the
workload's:
  * register and queue: per key against cas-register and fifo-queue,
    through the independent-keys checker (a history whose values are not
    (key, value) pairs is checked as one history);
  * multiregister, gset and mutex: one whole history against
    multi-register, gset and mutex;
  * set: the durability algebra of the set checker;
  * append and txnregister: the elle list-append and rw-register
    checkers, strict-serializable when test.json records "elle_realtime".
Each is composed as {"perf", "indep": ...}, with a per-key timeline.
Linearizability is searched under the run's budget (test.json
"check_budget_s", 120 s when absent, 0 or null for none). On a run
directory it writes results.json and the checkers' artifacts there; on a
bare history.jsonl it writes nothing. It prints {"valid": ...} and exits 0
iff valid is true, else 1 (invalid, unknown, or not checkable).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import sys
from pathlib import Path

from .compose import FAKE_NEMESES, WORKLOADS, check_budget
from .models import REGISTRY
from .ops.op import INVOKE, history_from_jsonl

ELLE_WORKLOADS = ("append", "txnregister")

# The linearizability model that re-checks a workload's per-key histories
# (the JAX package's cli CORPUS_MODELS).
CORPUS_MODELS = {"register": "cas-register", "queue": "fifo-queue"}

# Workloads checked as one whole history, with no key split, and the
# model of each (the JAX package's cli WHOLE_HISTORY_MODELS).
WHOLE_HISTORY_MODELS = {"multiregister": "multi-register", "gset": "gset",
                        "mutex": "mutex"}


def positive_float(s: str) -> float:
    v = float(s)
    if v <= 0:
        raise argparse.ArgumentTypeError("must be a positive number")
    return v


def nonnegative_float(s: str) -> float:
    v = float(s)
    if v < 0:
        raise argparse.ArgumentTypeError("must be >= 0 (0 = unbounded)")
    return v


def positive_int(s: str) -> int:
    v = int(s)
    if v <= 0:
        raise argparse.ArgumentTypeError("must be a positive integer")
    return v


# -- test ----------------------------------------------------------------

def _read_nodes(args) -> list[str]:
    if args.nodes_file:
        with open(args.nodes_file) as f:
            return [ln.strip() for ln in f if ln.strip()]
    return [n.strip() for n in args.nodes.split(",") if n.strip()]


def _test_opts(args) -> dict:
    return {
        "workload": args.workload,
        "quorum": args.quorum,
        "rate": args.rate,
        "ops_per_key": args.ops_per_key,
        "nodes": _read_nodes(args),
        "time_limit": args.time_limit,
        "recovery_wait": args.recovery_wait,
        "concurrency": args.concurrency,
        "seed": args.seed,
        "store_root": args.store,
        "no_nemesis": args.no_nemesis,
        "nemesis": args.nemesis,
        "stale_read_prob": args.stale_read_prob,
        "lost_write_prob": args.lost_write_prob,
        "duplicate_cas_prob": args.duplicate_cas_prob,
        "elle_realtime": args.elle_realtime,
        "check_budget_s": args.check_budget_s,
        "reorder_prob": args.reorder_prob,
        "duplicate_delivery_prob": args.duplicate_delivery_prob,
        "device": args.device,
        "check_mode": args.check_mode,
        "fail_fast": args.fail_fast,
    }


def cmd_test(args) -> int:
    from .compose import fake_test
    from .device import resolve_device
    from .runner import event_loop, run_test

    if not args.fake:
        print("error: the real-cluster path is not ported; run with --fake",
              file=sys.stderr)
        return 2
    try:
        # Before the run: a check that cannot run must not cost a run.
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    rc = 0
    for i in range(args.test_count):
        opts = _test_opts(args)
        opts["seed"] = args.seed + i
        result = asyncio.run(run_test(fake_test(opts)),
                             loop_factory=event_loop)
        print(json.dumps({"valid": result.get("valid"),
                          "op_count": result.get("op_count"),
                          "run_seconds": round(
                              result.get("run_seconds", 0), 2)}),
              flush=True)
        if result.get("valid") is not True:
            rc = 1
    return rc


# -- analyze -------------------------------------------------------------

def _read_history(path: Path):
    if path.is_dir():
        path = path / "history.jsonl"
    return history_from_jsonl(path.read_text())


def _read_test(path: Path) -> dict:
    """The run directory's test.json, {} for a bare history file or a run
    without a readable one."""
    test = path / "test.json"
    if not test.is_file():
        return {}
    try:
        return json.loads(test.read_text())
    except ValueError as e:
        print(f"# warning: cannot read test.json ({e}); assuming register "
              f"workload, serializable elle", file=sys.stderr)
        return {}


def is_keyed(history) -> bool:
    """Every client invoke carries a (key, value) pair. A plain cas's
    (old, new) is a pair too, so a history of bare cas ops does not
    count."""
    invs = [op for op in history
            if op.type == INVOKE and op.process != "nemesis"]
    return (bool(invs)
            and all(isinstance(op.value, tuple) and len(op.value) == 2
                    for op in invs)
            and any(op.f != "cas" or isinstance(op.value[1], (list, tuple))
                    for op in invs))


def _checker(args, test: dict, history):
    """The "indep" part of the analyze composition for the workload."""
    from .checkers import (Compose, ElleChecker, ElleRwChecker,
                           IndependentChecker, Linearizable, SetChecker,
                           TimelineChecker)

    workload = args.workload or test.get("workload", "register")
    if workload == "set":
        return SetChecker()
    if workload in ELLE_WORKLOADS:
        cls = ElleChecker if workload == "append" else ElleRwChecker
        return Compose({"elle": cls(realtime=bool(test.get("elle_realtime")),
                                    device=args.device),
                        "timeline": TimelineChecker()})
    if workload in WHOLE_HISTORY_MODELS:
        model = args.model or WHOLE_HISTORY_MODELS[workload]
    else:
        model = args.model or CORPUS_MODELS.get(workload, "cas-register")
    per_history = Compose({
        "linear": Linearizable(model, device=args.device,
                               time_budget_s=check_budget(test)),
        "timeline": TimelineChecker()})
    if workload in WHOLE_HISTORY_MODELS or not is_keyed(history):
        return per_history
    return IndependentChecker(per_history)


def cmd_analyze(args) -> int:
    from .checkers import Compose, PerfChecker
    from .store.store import RunDir

    path = Path(args.path)
    run = RunDir(path) if path.is_dir() else None
    try:
        history = _read_history(path)
        checker = Compose({"perf": PerfChecker(),
                           "indep": _checker(args, _read_test(path),
                                             history)})
        result = checker.check({}, history,
                               {"store_dir": str(path)} if run else {})
    except (OSError, ValueError, RuntimeError) as e:
        result = {"valid": "unknown", "error": f"{type(e).__name__}: {e}"}
        print(f"error: {result['error']}", file=sys.stderr)
    if run is not None:
        run.write_results(result)
    print(json.dumps({"valid": result.get("valid")}), flush=True)
    return 0 if result.get("valid") is True else 1


# -- parser --------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m jepsen_etcd_demo_tpu_torch.cli",
        description="Jepsen-style correctness harness, checked on an "
                    "NVIDIA GPU")
    sub = p.add_subparsers(dest="command", required=True)

    t = sub.add_parser("test", help="run a test against the fake cluster")
    t.add_argument("-w", "--workload", required=True,
                   choices=sorted(WORKLOADS), help="test workload to run")
    t.add_argument("-q", "--quorum", action="store_true", default=False,
                   help="use quorum reads (default false)")
    t.add_argument("-r", "--rate", type=positive_float, default=10.0,
                   metavar="HZ", help="approximate request rate (default 10)")
    t.add_argument("--ops-per-key", type=positive_int, default=100,
                   help="ops per key before rotating (default 100)")
    t.add_argument("--nodes", default="n1,n2,n3,n4,n5",
                   help="comma-separated node list")
    t.add_argument("--nodes-file", default=None,
                   help="file with one node per line (overrides --nodes)")
    t.add_argument("--time-limit", type=positive_float, default=30.0,
                   help="main-phase wall clock budget in seconds")
    t.add_argument("--recovery-wait", type=nonnegative_float, default=10.0,
                   help="quiet window after healing before the final "
                        "phase, in seconds")
    t.add_argument("--concurrency", type=positive_int, default=10,
                   help="client worker count")
    t.add_argument("--test-count", type=positive_int, default=1,
                   help="number of times to run the test")
    t.add_argument("--seed", type=int, default=0,
                   help="schedule and value rng seed")
    t.add_argument("--store", default="store", help="results store root")
    t.add_argument("--fake", action="store_true",
                   help="hermetic run against the in-process fake cluster "
                        "(required: the real-cluster path is not ported)")
    t.add_argument("--no-nemesis", action="store_true",
                   help="disable fault injection")
    t.add_argument("--nemesis", default="partition",
                   choices=sorted(FAKE_NEMESES),
                   help="fault to inject on the nemesis channel")
    t.add_argument("--stale-read-prob", type=float, default=0.0,
                   help="[fake] inject stale non-quorum reads")
    t.add_argument("--lost-write-prob", type=float, default=0.0,
                   help="[fake] inject acknowledged-but-lost updates")
    t.add_argument("--duplicate-cas-prob", type=float, default=0.0,
                   help="[fake] inject CASes acknowledged :fail that "
                        "applied")
    t.add_argument("--reorder-prob", type=float, default=0.0,
                   help="[fake] queue dequeues pop a random position")
    t.add_argument("--duplicate-delivery-prob", type=float, default=0.0,
                   help="[fake] queue dequeues return the head without "
                        "removing it")
    t.add_argument("--check-mode", default="post",
                   choices=["post", "stream"],
                   help="post (default): check the recorded history after "
                        "the run. stream: check it while the run goes on "
                        "(stable-prefix chunks swept on the device; the "
                        "check phase drains and finalizes; the same "
                        "verdicts). Checkers that cannot stream are "
                        "checked post-hoc")
    t.add_argument("--fail-fast", action="store_true",
                   help="with --check-mode stream: end the run as soon as "
                        "the streaming check falsifies the history")
    t.add_argument("--check-budget-s", type=nonnegative_float, default=120.0,
                   help="wall-clock bound per linearizability search "
                        "(0 = unbounded); expiry yields 'unknown'")
    t.add_argument("--elle-realtime", action="store_true",
                   help="append/txnregister: check strict "
                        "serializability")
    t.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the check runs (default cuda; cpu runs the "
                        "kernels' plain versions)")

    a = sub.add_parser("analyze", help="re-check a stored history")
    a.add_argument("path", help="run directory or history.jsonl file")
    a.add_argument("-w", "--workload", default=None, choices=sorted(WORKLOADS),
                   help="default: the run's test.json, else register")
    a.add_argument("--model", default=None, choices=sorted(REGISTRY),
                   help="model to check against (default: the workload's, "
                        "cas-register for register, fifo-queue for queue)")
    a.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    args = build_parser().parse_args(argv)
    if args.command == "test":
        return cmd_test(args)
    return cmd_analyze(args)


if __name__ == "__main__":
    sys.exit(main())
