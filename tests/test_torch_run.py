"""Whole runs of the port's harness on the CPU (`device="cpu"`): every
workload over the fake cluster, the run directory's artifacts, and the
two packages' `analyze` on each other's run directories."""

from __future__ import annotations

import asyncio
import json
import shutil

import numpy as np
import pytest

from jepsen_etcd_demo_tpu.checkers import Linearizable as JLin
from jepsen_etcd_demo_tpu.checkers.independent import split_by_key as jsplit
from jepsen_etcd_demo_tpu.cli import main as jcli
from jepsen_etcd_demo_tpu.compose import fake_test as jfake_test
from jepsen_etcd_demo_tpu.ops import limits as jlimits
from jepsen_etcd_demo_tpu.ops.op import history_from_jsonl as jread
from jepsen_etcd_demo_tpu.runner import run_test as jrun_test
from jepsen_etcd_demo_tpu.store import store as jstore
from jepsen_etcd_demo_tpu_torch import cli
from jepsen_etcd_demo_tpu_torch.checkers import (Compose, IndependentChecker,
                                                 Linearizable,
                                                 TimelineChecker,
                                                 split_by_key)
from jepsen_etcd_demo_tpu_torch.checkers.perf import charts_available
from jepsen_etcd_demo_tpu_torch.compose import fake_test
from jepsen_etcd_demo_tpu_torch.ops import limits as plimits
from jepsen_etcd_demo_tpu_torch.runner import run_test
from jepsen_etcd_demo_tpu_torch.store import Store, read_encoded_tensors

from torch_port_util import port_ops

LINEAR = ("valid", "dead_step", "max_frontier", "configs_explored",
          "op_count")


def fast_opts(tmp_path, **kw):
    """The sizes of the JAX package's end-to-end tests."""
    opts = {"time_limit": 1.5, "rate": 200.0, "ops_per_key": 40,
            "concurrency": 10, "recovery_wait": 0.1,
            "nemesis_interval": 0.3, "store_root": str(tmp_path / "store"),
            "seed": 1, "device": "cpu"}
    opts.update(kw)
    return opts


def run(opts):
    test = fake_test(opts)
    result = asyncio.run(run_test(test))
    return result, Store(test["store_root"]).latest().path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """run(name) -> (result, a fresh copy of its run directory): each of
    RUNS runs once per module."""
    done: dict = {}

    def get(name):
        if name not in done:
            root = tmp_path_factory.mktemp(name)
            done[name] = run(fast_opts(root, **RUNS[name][0]))
        result, rd = done[name]
        copy = tmp_path_factory.mktemp(f"{name}-copy") / "run"
        shutil.copytree(rd, copy)
        return json.loads(json.dumps(result, default=str)), copy

    return get


@pytest.fixture
def dedup1():
    """dedup_mode=1 in both packages: the port's table sweeps never
    canonicalise the frontier (ROADMAP C)."""
    jprev = jlimits.set_limits(jlimits.KernelLimits(dedup_mode=1))
    pprev = plimits.set_limits(plimits.KernelLimits(dedup_mode=1))
    yield
    jlimits.set_limits(jprev)
    plimits.set_limits(pprev)


def linear_fields(results: dict) -> dict:
    """{key: the compared linear fields} of a keyed run's results."""
    return {k: {f: r["linear"].get(f) for f in LINEAR}
            for k, r in results["indep"]["results"].items()}


def jax_analyze(run_dir) -> tuple[int, dict]:
    rc = jcli(["analyze", str(run_dir)])
    return rc, json.loads((run_dir / "results.json").read_text())


RUNS = {
    "register-healthy": ({"workload": "register", "no_nemesis": True},
                         True),
    "register-partitions": ({"workload": "register", "seed": 2}, True),
    "register-stale": ({"workload": "register", "stale_read_prob": 0.8,
                        "no_nemesis": True, "time_limit": 2.0, "seed": 3},
                       False),
    "set-healthy": ({"workload": "set", "no_nemesis": True}, True),
    "set-lost": ({"workload": "set", "lost_write_prob": 0.3,
                  "no_nemesis": True}, False),
    "queue": ({"workload": "queue"}, True),
    "gset": ({"workload": "gset", "no_nemesis": True}, True),
    "mutex": ({"workload": "mutex", "nemesis": "noop"}, True),
    "multiregister": ({"workload": "multiregister", "nemesis": "noop"}, True),
    "append": ({"workload": "append"}, True),
    "txnregister": ({"workload": "txnregister", "nemesis": "clock"}, True),
    "register-stream": ({"workload": "register", "no_nemesis": True,
                         "check_mode": "stream"}, True),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_workload_runs_on_cpu(runs, name):
    opts, valid = RUNS[name]
    result, rd = runs(name)
    assert result["valid"] is valid, result
    assert result["op_count"] > 20
    assert json.loads((rd / "results.json").read_text())["valid"] is valid
    files = {p.name for p in rd.iterdir()}
    assert {"test.json", "history.jsonl", "results.json",
            "jepsen.log"} <= files
    charts = {"latency-raw.png", "latency-quantiles.png", "rate.png"}
    assert (charts <= files) is charts_available()
    stored = json.loads((rd / "test.json").read_text())
    assert stored["workload"] == opts["workload"]
    assert stored["device"] == "cpu"
    indep = result["indep"]
    if opts["workload"] in ("register", "queue"):
        keys = indep["results"]
        assert indep["key_count"] == len(keys) >= 1
        for k in keys:
            assert f"timeline-{k}.html" in files
            assert f"history-{k}.npz" in files
    elif opts["workload"] in ("gset", "mutex", "multiregister"):
        assert {"timeline.html", "history.npz"} <= files
        assert indep["linear"]["valid"] is True
    elif opts["workload"] in ("append", "txnregister"):
        assert indep["elle"]["backend"] == "torch-closure-plain"
    if name == "register-stale":
        bad = [k for k, r in indep["results"].items()
               if r["valid"] is False]
        assert bad and indep["results"][bad[0]]["linear"]["failed_op"]
        assert (rd / f"linear-{bad[0]}.json").is_file()
    if name == "register-partitions":
        assert any(op.type == "info" and op.error
                   for op in jread((rd / "history.jsonl").read_text()))
    if name == "set-lost":
        assert indep["lost_count"] > 0


@pytest.mark.parametrize("name", ["register-partitions", "register-stale",
                                  "queue", "gset", "register-stream"])
def test_jax_analyze_reads_port_runs(runs, name, dedup1):
    """The JAX package's analyze on the port's run directory: the run's
    verdict and, per key, the linear fields of the port's analyze under
    the same limits (the run itself may have been checked under others,
    whose frontier reductions change max_frontier); and its
    read_encoded_tensors reads the port's .npz files as its own encoding
    of the same key histories."""
    valid = RUNS[name][1]
    result, rd = runs(name)
    _result, rd_port = runs(name)
    rc, want = jax_analyze(rd)
    assert cli.main(["analyze", str(rd_port), "--device", "cpu"]) == rc \
        == (0 if valid else 1)
    mine = json.loads((rd_port / "results.json").read_text())
    assert want["valid"] is result["valid"] is mine["valid"] is valid
    if "results" in want["indep"]:
        assert linear_fields(mine) == linear_fields(want)
    else:
        for f in LINEAR:
            assert mine["indep"]["linear"].get(f) == \
                want["indep"]["linear"].get(f), f
    model = {"queue": "fifo-queue", "gset": "gset"}.get(name,
                                                        "cas-register")
    stored = jstore.read_encoded_tensors(rd, model)
    history = jread((rd / "history.jsonl").read_text())
    per_key = jsplit(history) if name != "gset" else None
    assert len(stored) == (len(per_key) if per_key else 1)
    lin = JLin(model)
    for key, enc in stored:
        h = per_key[int(key)] if per_key else \
            [op for op in history if op.process != "nemesis"]
        mine = lin.encode(h)
        assert np.array_equal(enc.events, mine.events[:mine.n_events])
        assert (enc.n_ops, enc.k_slots, enc.max_pending, enc.max_value) == \
            (mine.n_ops, mine.k_slots, mine.max_pending, mine.max_value)
    back = read_encoded_tensors(rd, model)
    assert [k for k, _ in back] == [k for k, _ in stored]
    assert read_encoded_tensors(rd, "mutex") == []


def test_port_analyze_reads_jax_runs(tmp_path, dedup1):
    """The port's analyze on a JAX-made run directory (stale reads under
    partitions: valid and invalid keys) gives JAX's results.json verdict
    and per-key linear fields, and leaves the npz files the run wrote as
    they were (write-once)."""
    # Which keys a stale read spoils depends on the run's timing: the
    # first of a few seeds whose run holds both verdicts.
    for seed in range(2, 8):
        o = fast_opts(tmp_path / str(seed), workload="register", seed=seed,
                      stale_read_prob=0.3)
        o.pop("device")
        test = jfake_test(o)
        want = asyncio.run(jrun_test(test))
        if {r["valid"] for r in want["indep"]["results"].values()} == \
                {True, False}:
            break
    rd = jstore.Store(test["store_root"]).latest().path
    npz = {p.name: p.read_bytes() for p in rd.glob("*.npz")}
    assert cli.main(["analyze", str(rd), "--device", "cpu"]) == 1
    got = json.loads((rd / "results.json").read_text())
    assert got["valid"] is want["valid"] is False
    assert linear_fields(got) == linear_fields(want)
    verdicts = {r["valid"] for r in got["indep"]["results"].values()}
    assert verdicts == {True, False}
    assert {p.name: p.read_bytes() for p in rd.glob("*.npz")} == npz


def test_batched_compose_route_equals_unbatched(runs):
    """IndependentChecker batches the Linearizable entry of a Compose in
    one launch; every key's fields equal its own unbatched check."""
    _result, rd = runs("register-partitions")
    history = port_ops(jread((rd / "history.jsonl").read_text()))
    keyed = split_by_key(history)
    assert len(keyed) > 1
    batched = IndependentChecker(Compose({
        "linear": Linearizable("cas-register", device="cpu"),
        "timeline": TimelineChecker()})).check({}, history)
    single = Linearizable("cas-register", device="cpu")
    for k, h in keyed.items():
        got = batched["results"][str(k)]
        want = single.check({}, h, {"key": k})
        for f in LINEAR:
            assert got["linear"].get(f) == want.get(f), (k, f)
        assert got["timeline"] == {"valid": True}
    assert any(r["linear"]["backend"].endswith("-batched")
               for r in batched["results"].values())


def test_cli_test_verb_on_cpu(tmp_path, capsys, monkeypatch):
    """`test --fake --device cpu` prints JAX's result line and exits 0 iff
    valid; without --fake it composes the real cluster's test
    (compose.etcd_test) with the ssh options, here swapped for the fake
    cluster's so that no ssh runs."""
    store = tmp_path / "store"
    argv = ["test", "-w", "register", "--fake", "--device", "cpu",
            "--time-limit", "0.8", "--rate", "100", "--recovery-wait", "0.1",
            "--store", str(store), "--seed", "4"]
    assert cli.main(argv) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"valid", "op_count", "run_seconds"}
    assert line["valid"] is True and line["op_count"] > 20
    assert cli.main(argv + ["--stale-read-prob", "0.9", "--no-nemesis",
                            "--rate", "200", "--test-count", "2"]) == 1
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(s)["valid"] for s in lines[-2:]] == [False, False]
    assert len(Store(store).runs()) == 3
    from jepsen_etcd_demo_tpu_torch import compose

    seen = []
    monkeypatch.setattr(compose, "etcd_test", lambda opts: (
        seen.append(opts), compose.fake_test(opts))[1])
    bare = tmp_path / "bare"
    assert cli.main(["test", "-w", "register", "--device", "cpu",
                     "--time-limit", "0.5", "--rate", "50",
                     "--recovery-wait", "0.1", "--username", "u",
                     "--password", "pw", "--ssh-port", "2222",
                     "--store", str(bare)]) == 0
    assert [o["ssh"] for o in seen] == [{"username": "u",
                                          "private_key": None,
                                          "password": "pw", "port": 2222}]
    assert seen[0]["version"] == "v3.1.5"
    assert len(Store(bare).runs()) == 1
    shutil.rmtree(store)
