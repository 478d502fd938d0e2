"""Command line of the port.

    python -m jepsen_etcd_demo_tpu_torch.cli analyze <run-dir|history.jsonl>
        [-w|--workload WORKLOAD] [--model MODEL] [--device cuda|cpu]

Re-checks a stored history and prints the result as one JSON object. A
run directory is read through its history.jsonl. The workload comes from
-w/--workload, else from the run directory's test.json ("workload"), else
register; the model from --model, else from the workload, as the JAX
package's CLI maps them:
  * register and queue: checked per key against cas-register and
    fifo-queue, through the independent-keys checker when the history is
    keyed (values are (key, value) pairs), else as one history;
  * multiregister, gset and mutex: one whole history against
    multi-register, gset and mutex;
  * set: the durability algebra of the set checker;
  * append and txnregister: the elle list-append and rw-register
    checkers, strict-serializable when test.json records "elle_realtime".
Linearizability is searched under the run's budget (test.json
"check_budget_s", 120 s when absent, 0 or null for none). Exit code: 0
valid, 1 invalid, 2 unknown or not checkable.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

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

WORKLOADS = sorted({"set", *ELLE_WORKLOADS, *CORPUS_MODELS,
                    *WHOLE_HISTORY_MODELS})


def check_budget(test: dict) -> float | None:
    """Wall-clock bound of the linearizability search, in seconds, from a
    run's test.json: its "check_budget_s" (0 or null: unbounded), 120
    when it has none."""
    if "check_budget_s" in test:
        v = test["check_budget_s"]
        return float(v) if v else None
    return 120.0


def _read_history(path: Path):
    if path.is_dir():
        path = path / "history.jsonl"
    return history_from_jsonl(path.read_text())


def _read_test(path: Path) -> dict:
    """The run directory's test.json, {} for a bare history file or a run
    without one."""
    test = path / "test.json"
    return json.loads(test.read_text()) if test.is_file() else {}


def is_keyed(history) -> bool:
    """Every invoke carries a (key, value) pair. A plain cas's (old, new)
    is a pair too, so a history of bare cas ops does not count."""
    invs = [op for op in history if op.type == INVOKE]
    return (bool(invs)
            and all(isinstance(op.value, tuple) and len(op.value) == 2
                    for op in invs)
            and any(op.f != "cas" or isinstance(op.value[1], (list, tuple))
                    for op in invs))


def _checker(args, path: Path, history):
    from .checkers import (ElleChecker, ElleRwChecker, IndependentChecker,
                           Linearizable, SetChecker)

    test = _read_test(path)
    workload = args.workload or test.get("workload", "register")
    if workload == "set":
        return SetChecker()
    if workload in ELLE_WORKLOADS:
        cls = ElleChecker if workload == "append" else ElleRwChecker
        return cls(realtime=bool(test.get("elle_realtime")),
                   device=args.device)
    if workload in WHOLE_HISTORY_MODELS:
        return Linearizable(args.model or WHOLE_HISTORY_MODELS[workload],
                            device=args.device,
                            time_budget_s=check_budget(test))
    model = args.model or CORPUS_MODELS.get(workload, "cas-register")
    lin = Linearizable(model, device=args.device,
                       time_budget_s=check_budget(test))
    return IndependentChecker(lin) if is_keyed(history) else lin


def cmd_analyze(args) -> int:
    # Exit 1 means "not valid", so a history that cannot be read or
    # checked answers "unknown" (exit 2), never 1.
    try:
        path = Path(args.path)
        history = _read_history(path)
        result = _checker(args, path, history).check({}, history)
    except (OSError, ValueError, RuntimeError) as e:
        print(json.dumps({"valid": "unknown",
                          "error": f"{type(e).__name__}: {e}"}))
        return 2
    print(json.dumps(result, default=str))
    valid = result.get("valid")
    return 0 if valid is True else 1 if valid is False else 2


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m jepsen_etcd_demo_tpu_torch.cli")
    sub = p.add_subparsers(dest="command", required=True)
    a = sub.add_parser("analyze", help="re-check a stored history")
    a.add_argument("path", help="run directory or history.jsonl file")
    a.add_argument("-w", "--workload", default=None, choices=WORKLOADS,
                   help="default: the run's test.json, else register")
    a.add_argument("--model", default=None, choices=sorted(REGISTRY),
                   help="model to check against (default: the workload's, "
                        "cas-register for register, fifo-queue for queue)")
    a.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    return cmd_analyze(args)


if __name__ == "__main__":
    sys.exit(main())
