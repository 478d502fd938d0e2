"""The port's non-register workloads against the JAX package's: the
generators draw the same histories for the same seeds; Linearizable
(on the CPU, the plain versions of the kernels) gives the same verdict,
dead_step, max_frontier, configs_explored, failed_op and witness on
valid histories and their mutants, for a dense case (gset, mutex), a
packed general case (multi-register, unordered-queue) and an unpacked
general case (fifo-queue); the queue workload through the
independent-keys checker; SetChecker's result dict; and `cli analyze`
on run directories of each new workload. Tolerance: exact.

The JAX package's sort search may canonicalise its frontier, which
shrinks the search metrics by design, so both packages run under
dedup_mode=1 (as tests/test_torch_long.py does)."""

from __future__ import annotations

import json
import random

import pytest

from jepsen_etcd_demo_tpu.checkers import IndependentChecker as JInd
from jepsen_etcd_demo_tpu.checkers import Linearizable as JLin
from jepsen_etcd_demo_tpu.checkers import SetChecker as JSet
from jepsen_etcd_demo_tpu.ops import limits as jlimits
from jepsen_etcd_demo_tpu.utils import fuzz as jfuzz
from jepsen_etcd_demo_tpu_torch import cli
from jepsen_etcd_demo_tpu_torch.checkers import (IndependentChecker,
                                                 Linearizable, SetChecker)
from jepsen_etcd_demo_tpu_torch.ops import limits as plimits
from jepsen_etcd_demo_tpu_torch.ops import wgl3
from jepsen_etcd_demo_tpu_torch.ops.op import history_to_jsonl
from jepsen_etcd_demo_tpu_torch.utils import fuzz as pfuzz

from torch_port_util import jax_ops, port_ops

FIELDS = ("valid", "dead_step", "max_frontier", "configs_explored",
          "failed_op", "witness")


def gen_mutex_history(fuzz, rng, n_ops=40, n_procs=5, p_info=0.05):
    """A valid mutex history from `fuzz`'s _gen_history: a simulated lock
    that grants an acquire when free and a release when held (else the op
    fails); acquires and releases may end indeterminate."""
    def choose(rng):
        return ("acquire" if rng.random() < 0.5 else "release"), None

    def linearize(sim, f, _v):
        want = f == "acquire"
        if sim["locked"] == want:
            return False, None
        sim["locked"] = want
        return True, None

    return fuzz._gen_history(rng, n_ops, n_procs, choose, linearize,
                             lambda f: True, {"locked": False}, p_info)


def mutex_mutant(history):
    """A double grant: the first ok release followed by an ok acquire
    becomes :fail, so the lock is granted while held."""
    out = [type(op)(**vars(op)) for op in history]
    for i, op in enumerate(out):
        if op.type == "ok" and op.f == "release" and any(
                o.type == "ok" and o.f == "acquire" for o in out[i:]):
            op.type = "fail"
            return out
    raise AssertionError("no ok release before an ok acquire")


GENS = {
    "gset": lambda fz, rng: fz.gen_gset_history(rng, n_ops=50, n_procs=5),
    "fifo-queue": lambda fz, rng: fz.gen_queue_history(rng, n_ops=20,
                                                       n_procs=4),
    "unordered-queue": lambda fz, rng: fz.gen_queue_history(
        rng, n_ops=30, n_procs=4, fifo=False),
    "multi-register": lambda fz, rng: fz.gen_multireg_history(
        rng, n_ops=30, n_procs=5),
}


def family_pair(name: str, seed: int, mutate: bool):
    """The same history of model `name` from both packages' generators
    (JAX ops, port ops), mutated with seed 100 + seed when `mutate`."""
    if name == "mutex":
        hj = gen_mutex_history(jfuzz, random.Random(seed))
        hp = gen_mutex_history(pfuzz, random.Random(seed))
        return (mutex_mutant(hj), mutex_mutant(hp)) if mutate else (hj, hp)
    hj = GENS[name](jfuzz, random.Random(seed))
    hp = GENS[name](pfuzz, random.Random(seed))
    if mutate:
        hj = jfuzz.mutate_family_history(random.Random(100 + seed), hj, name)
        hp = pfuzz.mutate_family_history(random.Random(100 + seed), hp, name)
    return hj, hp


@pytest.fixture
def dedup_off():
    jprev = jlimits.set_limits(jlimits.KernelLimits(dedup_mode=1))
    pprev = plimits.set_limits(plimits.KernelLimits(dedup_mode=1))
    yield
    jlimits.set_limits(jprev)
    plimits.set_limits(pprev)


@pytest.mark.parametrize("name", sorted(GENS) + ["mutex"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_generators_reproduce_jax(name, seed):
    for mutate in (False, True):
        hj, hp = family_pair(name, seed, mutate)
        assert [o.to_json() for o in hj] == [o.to_json() for o in hp]


# (model, seed, mutate): the route each takes at its default geometry.
CASES = [("gset", 0, False), ("gset", 1, True),            # dense, S = 32
         ("mutex", 3, False), ("mutex", 3, True),          # dense, S = 4
         ("multi-register", 0, False),                     # packed general
         ("multi-register", 2, True),
         ("unordered-queue", 0, True),                     # packed general
         ("fifo-queue", 0, False), ("fifo-queue", 4, True)]  # unpacked


@pytest.mark.parametrize("name,seed,mutate", CASES)
def test_linearizable_matches_jax(dedup_off, name, seed, mutate):
    hj, hp = family_pair(name, seed, mutate)
    want = JLin(name).check({}, hj)
    lin = Linearizable(name, device="cpu")
    got = lin.check({}, hp)
    for f in FIELDS:
        assert got.get(f) == want.get(f), (f, got, want)
    assert got["op_count"] == want["op_count"]
    enc = lin.encode(hp)
    dense = wgl3.dense_config(lin.model, wgl3.tight_k_slots(enc),
                              enc.max_value) is not None
    assert dense == (name in ("gset", "mutex"))
    assert got["backend"] == ("torch-dense-plain" if dense else "torch-cpu")
    if mutate and name != "fifo-queue":
        assert got["valid"] is False and got["failed_op"]


def test_queue_workload_through_independent_keys(dedup_off):
    """The queue workload's shape: per-key fifo-queue histories of at most
    2 x capacity ops, interleaved as (key, value) ops; one key mutated."""
    per_key = [jfuzz.gen_queue_history(random.Random(s), n_ops=20,
                                       n_procs=4) for s in range(4)]
    per_key[2] = jfuzz.mutate_family_history(random.Random(7), per_key[2],
                                             "fifo-queue")
    hj = jfuzz.interleave_keyed(per_key)
    want = JInd(JLin("fifo-queue")).check({}, hj)
    got = IndependentChecker(Linearizable("fifo-queue", device="cpu")).check(
        {}, port_ops(hj))
    assert got["valid"] == want["valid"] is False
    assert got["key_count"] == want["key_count"] == 4
    for k, r in want["results"].items():
        for f in ("valid", "dead_step", "max_frontier", "failed_op"):
            assert got["results"][k].get(f) == r.get(f), (k, f)


def _set_history(lose: bool = False, invent: bool = False,
                 final: bool = True):
    """Adds 0..9 from three processes (3 and 7 indeterminate, 8 failed),
    then one final read of what landed."""
    from jepsen_etcd_demo_tpu.ops.op import Op

    h = []
    for v in range(10):
        p = v % 3
        typ = "info" if v in (3, 7) else "fail" if v == 8 else "ok"
        h += [Op(type="invoke", f="add", value=v, process=p),
              Op(type=typ, f="add", value=v, process=p)]
    seen = sorted({v for v in range(10) if v not in (7, 8)}
                  - ({5} if lose else set()) | ({42} if invent else set()))
    if final:
        h += [Op(type="invoke", f="read", value=None, process=9),
              Op(type="ok", f="read", value=seen, process=9)]
    return h


@pytest.mark.parametrize("kind", ["valid", "lost", "unexpected", "no-read"])
def test_set_checker_matches_jax(kind):
    h = _set_history(lose=kind == "lost", invent=kind == "unexpected",
                     final=kind != "no-read")
    want = JSet().check({}, h)
    got = SetChecker().check({}, port_ops(h))
    assert got == want
    assert got["valid"] == {"valid": True, "lost": False,
                            "unexpected": False,
                            "no-read": "unknown"}[kind]


def _cli_history(workload: str, invalid: bool):
    """A history of the workload (port ops)."""
    if workload == "set":
        return port_ops(_set_history(lose=invalid))
    if workload == "queue":
        per_key = [pfuzz.gen_queue_history(random.Random(s), n_ops=20,
                                           n_procs=4) for s in range(3)]
        if invalid:
            per_key[1] = pfuzz.mutate_family_history(
                random.Random(7), per_key[1], "fifo-queue")
        return pfuzz.interleave_keyed(per_key)
    name = cli.WHOLE_HISTORY_MODELS[workload]
    return family_pair(name, 1, invalid)[1]


@pytest.mark.parametrize("workload", ["set", "gset", "mutex",
                                      "multiregister", "queue"])
def test_cli_analyze_new_workloads(tmp_path, capsys, workload):
    for invalid, rc in ((False, 0), (True, 1)):
        run = tmp_path / f"{workload}-{int(invalid)}"
        run.mkdir()
        h = _cli_history(workload, invalid)
        (run / "history.jsonl").write_text(history_to_jsonl(h))
        (run / "test.json").write_text(json.dumps({"workload": workload}))
        assert cli.main(["analyze", str(run), "--device", "cpu"]) == rc
        assert json.loads(capsys.readouterr().out) == {"valid": not invalid}
        out = json.loads((run / "results.json").read_text())["indep"]
        assert out["valid"] is (not invalid)
        if workload == "queue":
            assert out["key_count"] == 3
        elif workload != "set":
            assert "key_count" not in out
            assert out["linear"]["op_count"] > 0
            if invalid:
                assert out["linear"]["failed_op"]
    jh = jax_ops(_cli_history(workload, True))
    if workload in cli.WHOLE_HISTORY_MODELS:
        assert JLin(cli.WHOLE_HISTORY_MODELS[workload]).check(
            {}, jh)["valid"] is False
