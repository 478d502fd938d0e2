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
from jepsen_etcd_demo_tpu_torch.ops.op import history_to_jsonl
from jepsen_etcd_demo_tpu_torch.utils import fuzz as pfuzz

from golden import GOLDEN
from torch_port_util import fields, fuzz_pair, port_ops

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


def test_not_dense_feasible_raises_not_implemented():
    # 30 ops pending at once: K=30 leaves the 2^20-cell dense budget.
    from jepsen_etcd_demo_tpu_torch.ops.op import Op

    h = [Op(type="invoke", f="write", value=1, process=p) for p in range(30)]
    h += [Op(type="ok", f="write", value=1, process=p) for p in range(30)]
    with pytest.raises(NotImplementedError, match="A-5"):
        Linearizable(device="cpu").check({}, h)


def test_history_longer_than_one_scan_raises_not_implemented():
    _, hp = fuzz_pair(30, n_ops=200, n_procs=4)
    prev = set_limits(KernelLimits(long_scan_max=64))
    try:
        with pytest.raises(NotImplementedError, match="A-4"):
            Linearizable(device="cpu").check({}, hp)
    finally:
        set_limits(prev)
    assert limits().long_scan_max == 32768


def _write(tmp_path, name, history):
    p = tmp_path / name
    p.write_text(history_to_jsonl(history))
    return p


def test_cli_analyze_exit_codes(tmp_path, capsys):
    valid = port_ops(GOLD["info-write-late-effect"][0])
    invalid = port_ops(GOLD["stale-read-after-overwrite"][0])
    v, iv = _write(tmp_path, "v.jsonl", valid), _write(tmp_path, "iv.jsonl",
                                                       invalid)
    assert cli.main(["analyze", str(v), "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out)["valid"] is True
    assert cli.main(["analyze", str(iv), "--device", "cpu"]) == 1
    out = json.loads(capsys.readouterr().out)
    assert out["valid"] is False and out["dead_step"] >= 0
    assert cli.main(["analyze", str(tmp_path / "missing.jsonl"),
                     "--device", "cpu"]) == 2
    run = tmp_path / "run"
    run.mkdir()
    _write(run, "history.jsonl", valid)
    assert cli.main(["analyze", str(run), "--device", "cpu"]) == 0


def test_cli_keyed_history_and_model_flag(tmp_path, capsys):
    _, hp = _keyed(15, n_keys=3)
    p = _write(tmp_path, "k.jsonl", hp)
    rc = cli.main(["analyze", str(p), "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert out["key_count"] == 3 and rc == (0 if out["valid"] else 1)
    cas_only = port_ops(GOLD["cas-success"][0])
    assert not cli.is_keyed(cas_only)
    c = _write(tmp_path, "cas.jsonl", cas_only)
    assert cli.main(["analyze", str(c), "--device", "cpu"]) == 0
    assert cli.main(["analyze", str(c), "--device", "cpu",
                     "-w", "register"]) == 1     # no cas in this model
    capsys.readouterr()


def test_cli_module_entry_point(tmp_path):
    import torch

    p = _write(tmp_path, "iv.jsonl", port_ops(GOLD["read-sees-future-write"][0]))
    r = subprocess.run([sys.executable, "-m", "jepsen_etcd_demo_tpu_torch.cli",
                        "analyze", str(p), "--device", "cpu"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 1, r.stderr[-2000:]
    r = subprocess.run([sys.executable, "-m", "jepsen_etcd_demo_tpu_torch.cli",
                        "analyze", str(p)], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    if not torch.cuda.is_available():
        # Default device is cuda: without a card the check cannot run,
        # and it does not fall back to the host.
        assert r.returncode == 2
        assert "CUDA is not available" in r.stdout
    assert wk.launches == 0 or torch.cuda.is_available()

