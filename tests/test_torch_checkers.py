"""The port's checkers, oracle and CLI against the JAX package's, on the
same seeded histories (exact equality on the integer result fields)."""

from __future__ import annotations

import json
import random
import subprocess
import sys
from pathlib import Path

import pytest

from jepsen_etcd_demo_tpu.checkers import IndependentChecker as JInd
from jepsen_etcd_demo_tpu.checkers import Linearizable as JLin
from jepsen_etcd_demo_tpu.checkers.base import merge_valid as jmerge
from jepsen_etcd_demo_tpu.checkers.independent import \
    split_by_key as jsplit
from jepsen_etcd_demo_tpu.checkers.oracle import \
    check_events_oracle as joracle
from jepsen_etcd_demo_tpu.models import CASRegister as JM
from jepsen_etcd_demo_tpu.ops.encode import encode_register_history as jenc
from jepsen_etcd_demo_tpu.utils import fuzz as jfuzz
from jepsen_etcd_demo_tpu_torch import cli
from jepsen_etcd_demo_tpu_torch.checkers import (IndependentChecker,
                                                 Linearizable, merge_valid,
                                                 split_by_key)
from jepsen_etcd_demo_tpu_torch.checkers.oracle import check_events_oracle
from jepsen_etcd_demo_tpu_torch.models import CASRegister as PM
from jepsen_etcd_demo_tpu_torch.ops import wgl3_kernels as wk
from jepsen_etcd_demo_tpu_torch.ops.encode import encode_register_history
from jepsen_etcd_demo_tpu_torch.ops.limits import (KernelLimits, limits,
                                                   set_limits)
from jepsen_etcd_demo_tpu_torch.ops.op import Op as POp
from jepsen_etcd_demo_tpu_torch.ops.op import history_to_jsonl
from jepsen_etcd_demo_tpu_torch.utils import fuzz as pfuzz

from golden import GOLDEN
from torch_port_util import fields, fuzz_pair, jax_ops, port_ops

ROOT = Path(__file__).resolve().parent.parent
GOLD = {name: (hist, expected) for name, hist, expected in GOLDEN}


@pytest.mark.parametrize("seed,mutate", [(0, False), (1, True), (2, False),
                                         (3, True)])
def test_linearizable_matches_jax(seed, mutate):
    hj, hp = fuzz_pair(seed, n_ops=40, n_procs=6, mutate=mutate)
    want = JLin().check({}, hj)
    got = Linearizable(device="cpu").check({}, hp)
    assert fields(got) == fields(want)
    assert got["op_count"] == want["op_count"]
    assert got["f_cap"] == want["f_cap"]
    assert got["backend"] == "torch-dense-plain"


def test_linearizable_golden_verdicts():
    lin = Linearizable(device="cpu")
    for name, hist, expected in GOLDEN:
        assert lin.check({}, port_ops(hist))["valid"] is expected, name


def _keyed(seed: int, n_keys: int = 4, n_ops: int = 30):
    rng_j, rng_p = random.Random(seed), random.Random(seed)
    per_j = [jfuzz.gen_register_history(rng_j, n_ops=n_ops, n_procs=5)
             for _ in range(n_keys)]
    per_p = [pfuzz.gen_register_history(rng_p, n_ops=n_ops, n_procs=5)
             for _ in range(n_keys)]
    per_j[1] = jfuzz.mutate_history(random.Random(seed + 1), per_j[1])
    per_p[1] = pfuzz.mutate_history(random.Random(seed + 1), per_p[1])
    return jfuzz.interleave_keyed(per_j), pfuzz.interleave_keyed(per_p)


@pytest.mark.parametrize("seed", [11, 12])
def test_independent_matches_jax(seed):
    hj, hp = _keyed(seed)
    want = JInd(JLin()).check({}, hj)
    got = IndependentChecker(Linearizable(device="cpu")).check({}, hp)
    assert got["valid"] == want["valid"]
    assert got["key_count"] == want["key_count"]
    assert set(got["results"]) == set(want["results"])
    for k, r in want["results"].items():
        assert fields(got["results"][k]) == fields(r), k


def test_independent_unbatched_equals_batched():
    _, hp = _keyed(13, n_keys=3)
    lin = Linearizable(device="cpu")
    a = IndependentChecker(lin).check({}, hp)
    for k, h in split_by_key(hp).items():
        assert fields(a["results"][str(k)]) == fields(lin.check({}, h))


def test_split_by_key_and_merge_match():
    hj, hp = _keyed(14, n_keys=3)
    a, b = jsplit(hj), split_by_key(hp)
    assert sorted(a) == sorted(b)
    for k in a:
        assert [o.to_json() for o in a[k]] == [o.to_json() for o in b[k]]
    for vs in ([True, True], [True, False], [True, "unknown"], []):
        assert merge_valid(vs) == jmerge(vs)
    assert IndependentChecker(Linearizable(device="cpu")).check(
        {}, []) == {"valid": True, "key_count": 0}


@pytest.mark.parametrize("seed,mutate", [(20, False), (21, True),
                                         (22, True)])
def test_oracle_matches_jax(seed, mutate):
    hj, hp = fuzz_pair(seed, n_ops=40, n_procs=5, mutate=mutate)
    a = joracle(jenc(hj, k_slots=16), JM())
    pe = encode_register_history(hp, k_slots=16)
    b = check_events_oracle(pe, PM())
    assert (a.valid, a.dead_event, a.max_frontier, a.configs_explored) == \
        (b.valid, b.dead_event, b.max_frontier, b.configs_explored)
    got = Linearizable(device="cpu").check({}, hp)
    assert got["valid"] == b.valid and got["dead_step"] == b.dead_step(pe)


def test_empty_history_is_valid():
    res = Linearizable(device="cpu").check({}, [])
    assert res == {"valid": True, "op_count": 0,
                   "backend": "torch-dense-plain"}


def test_not_dense_feasible_takes_general_path():
    """30 indeterminate writes pending at once: K=30 leaves the 2^20-cell
    dense budget, and the general path (the sort ladder, its frontier
    canonicalised) checks it, as the JAX package's."""
    from jepsen_etcd_demo_tpu_torch.ops.op import Op

    h = [Op(type="invoke", f="write", value=1, process=p) for p in range(30)]
    h += [Op(type="info", f="write", value=1, process=p) for p in range(30)]
    got = Linearizable(device="cpu").check({}, h)
    want = JLin().check({}, jax_ops(h))
    assert got["valid"] is want["valid"] is True
    assert got["kernel"] == want["kernel"] == "wgl2-sort-resumable"
    for f in ("max_frontier", "f_cap", "escalations", "dead_step"):
        assert got[f] == want[f], f


def test_long_history_takes_long_route_and_wide_one_general_path():
    """Past one scan a dense-feasible history takes the long route (the
    same result as the one-scan route); one that is not dense-feasible
    takes the general path, with the JAX package's verdict."""
    _, hp = fuzz_pair(30, n_ops=200, n_procs=4)
    whole = Linearizable(device="cpu").check({}, hp)
    wide = [POp(type="invoke", f="write", value=1, process=100 + p)
            for p in range(30)]
    wide += [POp(type="info", f="write", value=1, process=100 + p)
             for p in range(30)]
    # A read of 9, a value no write stores, ends the search right there.
    wide += [POp(type="invoke", f="read", value=None, process=99),
             POp(type="ok", f="read", value=9, process=99)]
    prev = set_limits(KernelLimits(long_scan_max=64, long_window_steps=48))
    try:
        got = Linearizable(device="cpu").check({}, hp)
        subsumed = Linearizable(device="cpu").check({}, wide + hp)
        # The JAX package's search frontier for frontier: no subsumption.
        set_limits(KernelLimits(long_scan_max=64, long_window_steps=48,
                                subsume_mode=1))
        general = Linearizable(device="cpu").check({}, wide + hp)
    finally:
        set_limits(prev)
    want = JLin().check({}, jax_ops(wide + hp))
    assert general["valid"] is False and general["dead_step"] == 0
    assert fields(got) == fields(whole)
    assert limits().long_scan_max == 32768
    assert general["kernel"] == "wgl2-sort-resumable"
    for f in ("valid", "dead_step", "max_frontier", "failed_op", "witness"):
        assert general.get(f) == want.get(f), f
    # Subsumption keeps the verdict and shrinks the frontier.
    for f in ("valid", "dead_step", "kernel", "failed_op", "witness"):
        assert subsumed.get(f) == general.get(f), f
    assert subsumed["max_frontier"] < general["max_frontier"]


def _write(tmp_path, name, history):
    p = tmp_path / name
    p.write_text(history_to_jsonl(history))
    return p


def _results(run) -> dict:
    return json.loads((run / "results.json").read_text())


def _run_dir(tmp_path, name, history, test: dict | None = None):
    run = tmp_path / name
    run.mkdir()
    _write(run, "history.jsonl", history)
    if test is not None:
        (run / "test.json").write_text(json.dumps(test))
    return run


def test_cli_analyze_exit_codes(tmp_path, capsys):
    """analyze prints only {"valid"} and exits 0 iff valid, else 1, as the
    JAX package's does; a run directory gets results.json, a bare history
    file nothing."""
    valid = port_ops(GOLD["info-write-late-effect"][0])
    invalid = port_ops(GOLD["stale-read-after-overwrite"][0])
    v, iv = _write(tmp_path, "v.jsonl", valid), _write(tmp_path, "iv.jsonl",
                                                       invalid)
    assert cli.main(["analyze", str(v), "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out) == {"valid": True}
    assert cli.main(["analyze", str(iv), "--device", "cpu"]) == 1
    assert json.loads(capsys.readouterr().out) == {"valid": False}
    assert sorted(p.name for p in tmp_path.iterdir()) == ["iv.jsonl",
                                                          "v.jsonl"]
    bad = _run_dir(tmp_path, "bad", invalid)
    assert cli.main(["analyze", str(bad), "--device", "cpu"]) == 1
    assert json.loads(capsys.readouterr().out) == {"valid": False}
    out = _results(bad)
    lin = out["indep"]["linear"]
    assert out["valid"] is False and lin["valid"] is False
    assert lin["dead_step"] >= 0 and lin["failed_op"]
    assert out["perf"]["valid"] is True
    assert cli.main(["analyze", str(tmp_path / "missing.jsonl"),
                     "--device", "cpu"]) == 1
    assert json.loads(capsys.readouterr().out) == {"valid": "unknown"}
    run = _run_dir(tmp_path, "run", valid)
    assert cli.main(["analyze", str(run), "--device", "cpu"]) == 0
    assert _results(run)["valid"] is True
    empty = tmp_path / "empty"
    empty.mkdir()
    assert cli.main(["analyze", str(empty), "--device", "cpu"]) == 1
    out = _results(empty)
    assert out["valid"] == "unknown" and "history.jsonl" in out["error"]
    capsys.readouterr()


def test_cli_keyed_history_and_model_flag(tmp_path, capsys):
    _, hp = _keyed(15, n_keys=3)
    run = _run_dir(tmp_path, "k", hp)
    rc = cli.main(["analyze", str(run), "--device", "cpu"])
    out = _results(run)["indep"]
    assert out["key_count"] == 3 and rc == (0 if out["valid"] else 1)
    assert sorted(out["results"]) == ["0", "1", "2"]
    cas_only = port_ops(GOLD["cas-success"][0])
    assert not cli.is_keyed(cas_only)
    c = _write(tmp_path, "cas.jsonl", cas_only)
    assert cli.main(["analyze", str(c), "--device", "cpu"]) == 0
    assert cli.main(["analyze", str(c), "--device", "cpu",
                     "--model", "register"]) == 1     # no cas in this model
    capsys.readouterr()


def _c1_run(tmp_path, test: dict):
    """The run directory of ROADMAP C-1: a register run whose one key is
    written, cas'd and read back."""
    run = tmp_path / "run"
    run.mkdir()
    (run / "test.json").write_text(json.dumps(test))
    h = [POp(type="invoke", f="write", value=(7, 1), process=0),
         POp(type="ok", f="write", value=(7, 1), process=0),
         POp(type="invoke", f="cas", value=(7, (1, 2)), process=0),
         POp(type="ok", f="cas", value=(7, (1, 2)), process=0),
         POp(type="invoke", f="read", value=(7, None), process=0),
         POp(type="ok", f="read", value=(7, 2), process=0)]
    _write(run, "history.jsonl", h)
    return run, h


@pytest.mark.parametrize("argv,rc", [(["-w", "register"], 0),
                                     (["--workload", "register"], 0),
                                     ([], 0),
                                     (["--model", "register"], 1)])
def test_cli_workload_flag_checks_register_as_cas_register(tmp_path, capsys,
                                                           argv, rc):
    """-w is --workload, as in the JAX package, and the register workload
    is checked against cas-register: the C-1 run is valid, as the JAX
    package's cas-register checker finds it. --model overrides."""
    run, h = _c1_run(tmp_path, {"workload": "register"})
    assert cli.main(["analyze", str(run), "--device", "cpu", *argv]) == rc
    assert json.loads(capsys.readouterr().out)["valid"] is (rc == 0)
    out = _results(run)["indep"]
    want = JInd(JLin("cas-register")).check({}, jax_ops(h))
    assert want["valid"] is True
    assert out["valid"] is (want["valid"] if rc == 0 else False)
    assert out["key_count"] == want["key_count"] == 1


@pytest.mark.parametrize("test", [{}, {"check_budget_s": 7},
                                  {"check_budget_s": 0.5},
                                  {"check_budget_s": 0},
                                  {"check_budget_s": None}])
def test_cli_check_budget_reaches_linearizable(tmp_path, test):
    """analyze bounds the search by test.json's check_budget_s as the JAX
    package's compose.check_budget reads it (120 s when absent)."""
    import argparse

    from jepsen_etcd_demo_tpu.compose import check_budget as jbudget

    run, h = _c1_run(tmp_path, {"workload": "register", **test})
    assert cli.check_budget(test) == jbudget(test)
    args = argparse.Namespace(workload=None, model=None, device="cpu",
                              backend="torch")
    checker = cli._checker(args, cli._read_test(run), h)
    assert isinstance(checker, IndependentChecker)
    lin = checker.sub_checker.checkers["linear"]
    assert lin.time_budget_s == jbudget(test)
    assert lin.model.name == "cas-register"


def test_cli_expired_check_budget_answers_unknown(tmp_path, capsys):
    """A check_budget_s the long route outlasts gives "unknown" (exit 1,
    as the JAX package exits for anything not valid), so the budget
    reaches the search itself."""
    _, hp = fuzz_pair(30, n_ops=200, n_procs=4)
    run = _run_dir(tmp_path, "run", hp)
    prev = set_limits(KernelLimits(long_scan_max=64, long_window_steps=48))
    try:
        (run / "test.json").write_text(json.dumps({"check_budget_s": 1e-9}))
        assert cli.main(["analyze", str(run), "--device", "cpu"]) == 1
        assert json.loads(capsys.readouterr().out) == {"valid": "unknown"}
        lin = _results(run)["indep"]["linear"]
        assert lin["valid"] == "unknown" and "time budget" in lin["error"]
        (run / "test.json").write_text(json.dumps({"check_budget_s": 0}))
        assert cli.main(["analyze", str(run), "--device", "cpu"]) == 0
        assert json.loads(capsys.readouterr().out)["valid"] is True
        assert _results(run)["indep"]["linear"]["valid"] is True
    finally:
        set_limits(prev)


def test_cli_module_entry_point(tmp_path):
    import torch

    p = _write(tmp_path, "iv.jsonl", port_ops(GOLD["read-sees-future-write"][0]))
    r = subprocess.run([sys.executable, "-m", "jepsen_etcd_demo_tpu_torch.cli",
                        "analyze", str(p), "--device", "cpu"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    said = f"stdout: {r.stdout[-2000:]!r}\nstderr: {r.stderr[-2000:]!r}"
    assert r.returncode == 1, said
    assert json.loads(r.stdout) == {"valid": False}, said
    r = subprocess.run([sys.executable, "-m", "jepsen_etcd_demo_tpu_torch.cli",
                        "analyze", str(p)], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    said = f"stdout: {r.stdout[-2000:]!r}\nstderr: {r.stderr[-2000:]!r}"
    if not torch.cuda.is_available():
        # Default device is cuda: without a card the check cannot run,
        # and it does not fall back to the host.
        assert r.returncode == 1, said
        assert json.loads(r.stdout) == {"valid": "unknown"}, said
        assert "CUDA is not available" in r.stderr, said
    assert sum(wk.launches.values()) == 0 or torch.cuda.is_available(), \
        dict(wk.launches)
