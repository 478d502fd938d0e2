"""Command line of the port.

    python -m jepsen_etcd_demo_tpu_torch.cli test -w WORKLOAD [--fake]
        [-q] [-r HZ] [--ops-per-key N] [--time-limit S] [--seed N] ...
        [--nodes N1,N2,...] [--username U] [--private-key F]
        [--password P] [--ssh-port N] [--version V] [--nemesis NAME]
        [--check-mode post|stream] [--fail-fast] [--device cuda|cpu]
    python -m jepsen_etcd_demo_tpu_torch.cli analyze <run-dir|history.jsonl>
        [-w|--workload WORKLOAD] [--model MODEL] [--backend torch|oracle]
        [--no-encode-cache] [--sweep-mode auto|dense|sparse]
        [--device cuda|cpu]
    python -m jepsen_etcd_demo_tpu_torch.cli corpus <store>
        [--model MODEL] [--reencode] [--no-encode-cache]
        [--sweep-mode auto|dense|sparse] [--device cuda|cpu]
    python -m jepsen_etcd_demo_tpu_torch.cli serve [--port N] [--host H]
        [--store DIR] [--check [--model MODEL] [--coalesce-ms MS]
        [--max-batch N] [--max-inflight N] [--ready-file F]
        [--device cuda|cpu]]

`test` runs a whole Jepsen test, as the JAX package's `test` does (the
reference's `lein run test -w register`, src/jepsen/etcdemo.clj:146-199):
against an etcd cluster on --nodes, installed and started over ssh
(compose.etcd_test; --username, --private-key, --password through
sshpass, --ssh-port; etcd --version, the db/etcd.py
JEPSEN_TPU_ETCD_* variables), or with --fake against the in-process fake
cluster (compose.fake_test). The workload's generator drives its client
and the nemesis, the recorded history is checked
on the device (cuda by default; it is resolved before the run starts and
never falls back to the host), and the run directory
<store>/<name>/<timestamp>/ gets test.json, history.jsonl, results.json,
jepsen.log, the per-key timelines and encoded histories
(history-<key>.npz), and the perf charts where matplotlib imports. It
prints {"valid", "op_count", "run_seconds"} per run and exits 0 iff every
run is valid. With `--check-mode stream` the history is checked while the
run goes on (stream/), and `--fail-fast` ends a run as soon as that check
falsifies it; results.json then says `check_mode: "stream"` and carries a
`stream` record.

`analyze` re-checks a stored run as the JAX package's `analyze` does. The
workload comes from -w/--workload, else from the run's test.json
("workload"), else register; the model from --model, else the
workload's; --backend oracle searches with the pure-Python oracle
instead of the sweeps (an independent cross-check):
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
directory it writes results.json and the checkers' artifacts there, and
keeps the encoded histories in <run>/.encode-cache/ unless
--no-encode-cache; on a bare history.jsonl it writes nothing. It prints
{"valid": ...} and exits 0 iff valid is true, else 1 (invalid, unknown,
or not checkable). --sweep-mode sets the long sweeps' mode
(limits().sparse_mode) for the command.

`corpus` re-checks every run of a store (the port's or the JAX
package's) together through the corpus scheduler (sched/), one call a
model, and prints the JAX verb's JSON ({"valid", "runs", "keys",
"invalid", "kernel", "from_tensors", "wall_s", "launches",
"padding_waste", "cache_hit_rate", "sweep_steps_sparse",
"sweep_steps_dense", "configs_pruned", "sparse_overflow_rounds"}); it
exits 0 iff every history is valid (cmd_corpus).

`serve` serves the store over HTTP: the run index, each run's files,
/metrics and /healthz (web/server.py). With --check it is the checking
daemon (serve/): tenants POST histories to /check and stream ops through
/serve/session; the coalescing scheduler checks them on --device (cuda by
default) in shared bucketed launches, and every verdict lands in the
store as a run under <store>/serve/. Before it binds, it builds every
kernel library the path launches and makes one warm check on the device
(JEPSEN_TPU_NO_WARMUP=1 skips the check, never the build); a failure
there exits 1 before the ready line. Bound, it prints one JSON line,
{"serving", "port", "store", "check", "warmed"} (--port 0 picks a free
port), also written to --ready-file.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import logging
import sys
from dataclasses import replace
from pathlib import Path

from .compose import NEMESES, WORKLOADS, check_budget
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
        "version": args.version,
        "ssh": {"username": args.username, "private_key": args.private_key,
                "password": args.password, "port": args.ssh_port},
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
    from .compose import etcd_test, fake_test
    from .device import resolve_device
    from .runner import event_loop, run_test

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
        test = fake_test(opts) if args.fake else etcd_test(opts)
        result = asyncio.run(run_test(test), loop_factory=event_loop)
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
                               time_budget_s=check_budget(test),
                               backend=args.backend),
        "timeline": TimelineChecker()})
    if workload in WHOLE_HISTORY_MODELS or not is_keyed(history):
        return per_history
    return IndependentChecker(per_history)


def cmd_analyze(args) -> int:
    from .checkers import Compose, PerfChecker
    from .store import encode_cache
    from .store.store import RunDir

    path = Path(args.path)
    run = RunDir(path) if path.is_dir() else None
    # The encode cache of a run directory: analyzing the run again skips
    # the host encode. A bare history file gets nothing written.
    cache_root = (path / encode_cache.CACHE_DIRNAME
                  if run is not None and not args.no_encode_cache else None)
    try:
        history = _read_history(path)
        checker = Compose({"perf": PerfChecker(),
                           "indep": _checker(args, _read_test(path),
                                             history)})
        with encode_cache.activated(cache_root):
            result = checker.check({}, history,
                                   {"store_dir": str(path)} if run else {})
    except (OSError, ValueError, RuntimeError) as e:
        result = {"valid": "unknown", "error": f"{type(e).__name__}: {e}"}
        print(f"error: {result['error']}", file=sys.stderr)
    if run is not None:
        run.write_results(result)
    print(json.dumps({"valid": result.get("valid")}), flush=True)
    return 0 if result.get("valid") is True else 1


# -- serve ---------------------------------------------------------------

# The kernel libraries `serve --check` launches: the dense sweep's
# (csrc/wgl3_sweep.cu: the single, grouped, resumable and global routes)
# and the sparse work-list sweep's (csrc/wgl3_sparse.cu).
SERVE_LIBS = ("wgl3_sweep", "wgl3_sparse")
NO_WARMUP_ENV = "JEPSEN_TPU_NO_WARMUP"


def serve_warmup(device, model_name: str) -> dict | None:
    """Before `serve --check` binds: build every library the path
    launches (on a card), then check four small histories, two of them
    mutants, through check_corpus on `device` and hold the verdicts
    against the host oracle. Raises on a failed build, launch or
    disagreement. Returns the record /healthz and the ready line report,
    or None when JEPSEN_TPU_NO_WARMUP skipped the check (never the
    build)."""
    import os
    import random
    import time

    from .checkers import Linearizable
    from .checkers.oracle import check_events_oracle
    from .ops import build
    from .ops import wgl3_kernels as wk
    from .sched import check_corpus
    from .utils.fuzz import gen_register_history, mutate_history

    t0 = time.perf_counter()
    families = list(SERVE_LIBS) if device.type == "cuda" else []
    if families:
        build.load_all(families)
    build_s = time.perf_counter() - t0
    if os.environ.get(NO_WARMUP_ENV):
        return None
    lin = Linearizable(model=model_name, device=device)
    rng = random.Random(0)
    hists = [gen_register_history(rng, n_ops=60, n_procs=4, p_info=0.0)
             for _ in range(4)]
    hists[1::2] = [mutate_history(rng, h) for h in hists[1::2]]
    encs = [lin.encode(h) for h in hists]
    before = sum(wk.launch_counts().values())
    results, kernel, _stats = check_corpus(encs, lin.model, device=device)
    for i, (enc, res) in enumerate(zip(encs, results)):
        want = check_events_oracle(enc, lin.model)
        if res["valid"] != want.valid \
                or int(res["dead_step"]) != want.dead_step(enc):
            raise RuntimeError(
                f"warm check {i} on {device}: {kernel} says valid="
                f"{res['valid']} dead_step={res['dead_step']}, the host "
                f"oracle valid={want.valid} "
                f"dead_step={want.dead_step(enc)}")
    return {"device": str(device), "families": families, "kernel": kernel,
            "launches": sum(wk.launch_counts().values()) - before,
            "build_s": round(build_s, 4),
            "seconds": round(time.perf_counter() - t0, 4)}


def cmd_serve(args) -> int:
    if not args.check:
        from .web.server import serve

        serve(args.store, host=args.host, port=args.port)
        return 0
    from .device import resolve_device
    from .obs import health
    from .serve.daemon import serve_check

    try:
        device = resolve_device(args.device)
        warm = serve_warmup(device, args.model)
    except Exception as e:
        # A card that is missing or fails its build or warm check ends
        # the command before it binds: never a daemon that sheds every
        # request to the host.
        print(f"error: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    if warm is not None:
        print(f"WARMUP {json.dumps(warm, sort_keys=True)}", file=sys.stderr,
              flush=True)
    # The supervisor's active probe checks on the daemon's device.
    health.reset_supervisor(health.BackendSupervisor(device=device.type))
    return serve_check(
        args.store, host=args.host, port=args.port,
        default_model=args.model, coalesce_ms=args.coalesce_ms,
        max_batch=args.max_batch, max_inflight=args.max_inflight,
        ready_file=args.ready_file, warmup=warm, device=device)


# -- corpus --------------------------------------------------------------

def cmd_corpus(args) -> int:
    """Corpus replay (BASELINE.json configs[4]): every stored run's
    histories re-checked together, one scheduler call a model
    (sched.check_corpus: length-bucketed launches of the dense sweep).
    The model comes from the workload each run's test.json records
    (CORPUS_MODELS per key, WHOLE_HISTORY_MODELS for the whole history;
    --model replaces cas-register for register runs only); runs of other
    workloads are skipped. A run's stored history-*.npz tensors are read
    when they cover it (results.json's indep.key_count keys, or the one
    tensor of a whole-history run) and were encoded under its model;
    otherwise, and for every run under --reencode, its history.jsonl is
    encoded again (Linearizable.encode) through the encode cache under
    <store>/.encode-cache/, which --reencode refreshes and
    --no-encode-cache leaves off."""
    from .device import resolve_device
    from .store import encode_cache
    from .store.store import Store

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        print(json.dumps({"valid": "unknown"}), flush=True)
        return 1
    cache_root = (None if args.no_encode_cache else
                  Store(args.store_root).root / encode_cache.CACHE_DIRNAME)
    with encode_cache.activated(cache_root, refresh=args.reencode):
        return _cmd_corpus_checked(args, device)


def corpus_entries(args, device):
    """({model name: [(run path, key, EncodedHistory)]}, runs, keys read
    from stored tensors)."""
    from .checkers import Linearizable, split_by_key
    from .store.store import Store, read_encoded_tensors

    by_model: dict[str, list] = {}
    runs_seen = set()
    n_from_tensors = 0
    for run in Store(args.store_root).runs():
        try:
            workload = run.read_test().get("workload", "register")
        except (ValueError, OSError):
            workload = "register"
        whole = workload in WHOLE_HISTORY_MODELS
        model_name = (WHOLE_HISTORY_MODELS[workload] if whole
                      else CORPUS_MODELS.get(workload))
        if model_name is None:
            print(f"# skipping {run.path}: workload {workload!r} is not "
                  f"linearizability-checked", file=sys.stderr)
            continue
        if workload == "register":
            model_name = args.model
        if not args.reencode:
            tensors = read_encoded_tensors(run.path, model_name)
            if whole:
                expected = 1
            else:
                try:
                    expected = run.read_results()["indep"]["key_count"]
                except (ValueError, OSError, KeyError, TypeError):
                    expected = None
            if tensors and len(tensors) == expected:
                runs_seen.add(str(run.path))
                n_from_tensors += len(tensors)
                by_model.setdefault(model_name, []).extend(
                    (str(run.path), k, enc) for k, enc in tensors)
                continue
        lin = Linearizable(model_name, device=device)
        try:
            history = run.read_history()
            if whole:
                keyed = {None: [op for op in history
                                if op.process != "nemesis"]}
            else:
                keyed = split_by_key(history)
        except (ValueError, OSError) as e:
            print(f"# skipping {run.path}: {e}", file=sys.stderr)
            continue
        runs_seen.add(str(run.path))
        for k, h in sorted(keyed.items(), key=lambda kv: str(kv[0])):
            try:
                # str(k): the tensor path's keys are file-name strings.
                entry = (str(run.path), None if k is None else str(k),
                         lin.encode(h))
            except ValueError as e:
                print(f"# skipping {run.path} key {k}: {e}",
                      file=sys.stderr)
                continue
            by_model.setdefault(model_name, []).append(entry)
    return by_model, len(runs_seen), n_from_tensors


def _cmd_corpus_checked(args, device) -> int:
    import time

    from . import sched
    from .models import get_model

    by_model, n_runs, n_from_tensors = corpus_entries(args, device)
    if not by_model:
        print(json.dumps({"valid": True, "runs": 0, "keys": 0}), flush=True)
        return 0
    t0 = time.perf_counter()
    invalid, kernels, n_keys = [], set(), 0
    totals: dict = {}
    for model_name, entries in sorted(by_model.items()):
        results, kernel, stats = sched.check_corpus(
            [e[2] for e in entries], get_model(model_name), device=device)
        sched.fold_stats(totals, stats)
        kernels.add(kernel)
        n_keys += len(entries)
        invalid.extend({"run": r, "key": k, "model": model_name}
                       for (r, k, _), one in zip(entries, results)
                       if one["valid"] is not True)
    wall = time.perf_counter() - t0
    out = {
        "valid": not invalid,
        "runs": n_runs,
        "keys": n_keys,
        "invalid": invalid,
        "kernel": kernels.pop() if len(kernels) == 1 else "mixed",
        "from_tensors": n_from_tensors,
        "wall_s": round(wall, 3),
        "launches": totals["launches"],
        "padding_waste": (round(totals["steps_padded"]
                                / totals["steps_real"], 4)
                          if totals["steps_real"] else 0.0),
        "cache_hit_rate": round(sched.shape_hit_rate(), 4),
        "sweep_steps_sparse": totals["sweep_steps_sparse"],
        "sweep_steps_dense": totals["sweep_steps_dense"],
        "configs_pruned": totals["configs_pruned"],
        "sparse_overflow_rounds": totals["sparse_overflow_rounds"],
    }
    print(json.dumps(out), flush=True)
    return 0 if not invalid else 1


# -- parser --------------------------------------------------------------

# --sweep-mode -> limits().sparse_mode (ops/limits.py).
SWEEP_MODES = {"auto": 0, "dense": 1, "sparse": 2}


@contextlib.contextmanager
def sweep_mode(mode: str | None):
    """limits().sparse_mode as --sweep-mode says, for one command (None
    leaves the limits as they are)."""
    if mode is None:
        yield
        return
    from .ops.limits import limits, set_limits

    prev = set_limits(replace(limits(), sparse_mode=SWEEP_MODES[mode]))
    try:
        yield
    finally:
        set_limits(prev)


def _add_sweep_mode_flag(p) -> None:
    p.add_argument("--sweep-mode", default=None, choices=sorted(SWEEP_MODES),
                   help="long sweeps: auto (the sparse kernel where the "
                        "density policy picks it; default), dense (sparse "
                        "kernel off) or sparse (every closure round over "
                        "the live blocks only). Verdicts are the same in "
                        "every mode")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m jepsen_etcd_demo_tpu_torch.cli",
        description="Jepsen-style correctness harness, checked on an "
                    "NVIDIA GPU")
    sub = p.add_subparsers(dest="command", required=True)

    t = sub.add_parser("test", help="run a test against an etcd cluster "
                                    "or the fake cluster")
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
    t.add_argument("--username", default="root", help="ssh username")
    t.add_argument("--private-key", default=None, help="ssh identity file")
    t.add_argument("--password", default=None,
                   help="ssh password (rides sshpass: it travels in the "
                        "SSHPASS environment variable, never on argv)")
    t.add_argument("--ssh-port", type=positive_int, default=22,
                   help="ssh port on every node")
    t.add_argument("--seed", type=int, default=0,
                   help="schedule and value rng seed")
    t.add_argument("--store", default="store", help="results store root")
    t.add_argument("--fake", action="store_true",
                   help="hermetic run against the in-process fake cluster "
                        "(no ssh, no etcd)")
    t.add_argument("--no-nemesis", action="store_true",
                   help="disable fault injection")
    t.add_argument("--nemesis", default="partition",
                   choices=list(NEMESES),
                   help="fault to inject on the nemesis channel (kill, "
                        "pause, clock-strobe and partition-bridge/-ring "
                        "need a real cluster, not --fake)")
    t.add_argument("--version", default="v3.1.5",
                   help="etcd version to install")
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
    a.add_argument("--backend", default="torch", choices=["torch", "oracle"],
                   help="torch (default): the sweeps on --device; oracle: "
                        "the pure-Python search")
    a.add_argument("--no-encode-cache", action="store_true",
                   help="do not keep encoded histories under "
                        "<run>/.encode-cache/ (encode from history.jsonl "
                        "every time)")
    _add_sweep_mode_flag(a)
    a.add_argument("--device", default="cuda", choices=["cuda", "cpu"])

    c = sub.add_parser("corpus", help="re-check every stored run's "
                                      "histories together (corpus replay)")
    c.add_argument("store_root", help="results store root directory")
    c.add_argument("--model", default="cas-register", choices=sorted(REGISTRY),
                   help="model of register runs (default cas-register)")
    c.add_argument("--reencode", action="store_true",
                   help="encode every run from history.jsonl instead of "
                        "reading its stored history-*.npz tensors")
    c.add_argument("--no-encode-cache", action="store_true",
                   help="do not keep encoded histories under "
                        "<store>/.encode-cache/")
    _add_sweep_mode_flag(c)
    c.add_argument("--device", default="cuda", choices=["cuda", "cpu"])

    s = sub.add_parser("serve", help="serve the results store over http "
                                     "(run index, /metrics, /healthz); "
                                     "--check adds the checking daemon")
    s.add_argument("--port", type=int, default=8080,
                   help="0 = a free port; with --check the bound port is "
                        "printed as one JSON line")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--store", default="store", help="results store root")
    s.add_argument("--check", action="store_true",
                   help="checking as a service: take histories over HTTP "
                        "(POST /check, /serve/session) and check them on "
                        "the coalescing scheduler; verdicts land in the "
                        "store as runs")
    s.add_argument("--model", default="cas-register", choices=sorted(REGISTRY),
                   help="[--check] model of requests that name none")
    s.add_argument("--coalesce-ms", type=int, default=None, metavar="MS",
                   help="[--check] linger of the coalescing scheduler "
                        "(default limits().serve_coalesce_ms)")
    s.add_argument("--max-batch", type=positive_int, default=None,
                   help="[--check] requests per coalesced batch (default "
                        "limits().serve_max_batch)")
    s.add_argument("--max-inflight", type=positive_int, default=None,
                   help="[--check] admitted, unfinished requests per "
                        "tenant (default limits().serve_max_inflight)")
    s.add_argument("--ready-file", default=None,
                   help="[--check] also write the ready JSON line here")
    s.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="[--check] where the checks run (default cuda; cpu "
                        "runs the kernels' plain versions)")
    return p


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    args = build_parser().parse_args(argv)
    if args.command == "test":
        return cmd_test(args)
    if args.command == "serve":
        return cmd_serve(args)
    with sweep_mode(args.sweep_mode):
        return (cmd_corpus if args.command == "corpus" else cmd_analyze)(args)


if __name__ == "__main__":
    sys.exit(main())
