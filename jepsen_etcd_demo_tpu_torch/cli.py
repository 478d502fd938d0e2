"""Command line of the port.

    python -m jepsen_etcd_demo_tpu_torch.cli analyze <run-dir|history.jsonl>
        [-w register|cas-register] [--device cuda|cpu]

Re-checks a stored history and prints the result as one JSON object. A
run directory is read through its history.jsonl. A keyed history (values
are (key, value) pairs) goes through the independent-keys checker, a
plain one through the linearizability checker. Exit code: 0 valid,
1 invalid, 2 unknown or not checkable by this slice.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .ops.op import INVOKE, history_from_jsonl


def _read_history(path: Path):
    if path.is_dir():
        path = path / "history.jsonl"
    return history_from_jsonl(path.read_text())


def is_keyed(history) -> bool:
    """Every invoke carries a (key, value) pair. A plain cas's (old, new)
    is a pair too, so a history of bare cas ops does not count."""
    invs = [op for op in history if op.type == INVOKE]
    return (bool(invs)
            and all(isinstance(op.value, tuple) and len(op.value) == 2
                    for op in invs)
            and any(op.f != "cas" or isinstance(op.value[1], (list, tuple))
                    for op in invs))


def cmd_analyze(args) -> int:
    from .checkers import IndependentChecker, Linearizable

    # Exit 1 means "not linearizable", so a history that cannot be read
    # or checked answers "unknown" (exit 2), never 1.
    try:
        history = _read_history(Path(args.path))
        lin = Linearizable(args.model, device=args.device)
        checker = IndependentChecker(lin) if is_keyed(history) else lin
        result = checker.check({}, history)
    except (OSError, ValueError, NotImplementedError, RuntimeError) as e:
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
    a.add_argument("-w", "--model", default="cas-register",
                   choices=["register", "cas-register"],
                   help="model to check against (the register workload's "
                        "histories are checked against cas-register)")
    a.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    return cmd_analyze(args)


if __name__ == "__main__":
    sys.exit(main())
