"""The port's general path (the ladder with its dense-chunked rung, the
batched sort tiers, the sort-checkpoint witness, the checkers and the
CLI on it, the global tier's plain version and routing) against the JAX
package on the same seeded histories; the sort search itself and its
canonicalisation are in tests/test_torch_canon.py.

Both packages run under the same limits, pinned per test and restored
after it: a dense budget of 2^10 cells so that histories from K = 8 go
general, a chunked budget of 2^14 cells (the dense-chunked rung exists
up to K = 11 at S = 8), and a first frontier capacity of 4 so that the
sort search escalates. The JAX package runs as its own tests run it on
the CPU (its XLA search and sweeps). The tolerance is exact equality on
every compared field, and bit equality on the sort frontier at the death
checkpoint. The JAX package runs on one device here (fixture one_device).
"""

from __future__ import annotations

import json

import pytest
import torch

from jepsen_etcd_demo_tpu.checkers import IndependentChecker as JInd
from jepsen_etcd_demo_tpu.checkers import Linearizable as JLin
from jepsen_etcd_demo_tpu.checkers import witness as jwitness
from jepsen_etcd_demo_tpu.models import CASRegister as JM
from jepsen_etcd_demo_tpu.ops import wgl2 as jwgl2
from jepsen_etcd_demo_tpu.ops import wgl3_pallas as jpal
from jepsen_etcd_demo_tpu.ops.op import OK
from jepsen_etcd_demo_tpu.utils import fuzz as jfuzz
from jepsen_etcd_demo_tpu_torch import cli, plan
from jepsen_etcd_demo_tpu_torch.checkers import (IndependentChecker,
                                                 Linearizable)
from jepsen_etcd_demo_tpu_torch.checkers import witness as pwitness
from jepsen_etcd_demo_tpu_torch.models import CASRegister as PM
from jepsen_etcd_demo_tpu_torch.ops import encode as penc
from jepsen_etcd_demo_tpu_torch.ops import wgl3 as pwgl3
from jepsen_etcd_demo_tpu_torch.ops import wgl3_kernels as wk
from jepsen_etcd_demo_tpu_torch.ops.op import history_to_jsonl

from torch_port_util import (GENERAL, assert_checkpoints_equal, encodings,
                             history, one_device, pin, port_ops)

JMODEL, PMODEL = JM(), PM()
# The shared fixtures this module uses (one_device is autouse).
__all__ = ["one_device", "pin"]
LADDER = ("valid", "survived", "overflow", "dead_step", "max_frontier",
          "f_cap", "escalations", "kernel_rung")


# -- the ladder --------------------------------------------------------------

def _ladder_fields(res: dict) -> dict:
    out = {f: res.get(f) for f in LADDER if f != "kernel_rung"}
    kernel = res["kernel"]
    out["kernel_rung"] = ("dense" if kernel.startswith("wgl3-dense")
                          else kernel)
    if kernel.startswith("wgl3-dense"):
        out["configs_explored"] = res["configs_explored"]
    return out


# (seed, mutate seed, f_cap_max, time_budget_s, expected rung)
LADDER_CASES = {
    "sort-valid": (0, None, None, None, "wgl2-sort-resumable"),
    "sort-invalid": (0, 500, None, None, "wgl2-sort-resumable"),
    "dense-valid": (2, None, None, None, "dense"),
    "dense-invalid": (2, 502, None, None, "dense"),
    "exhausted-capacity": (0, None, 16, None, "exhausted"),
    "exhausted-budget": (2, None, None, 0.0, "exhausted"),
}


@pytest.mark.parametrize("case", sorted(LADDER_CASES))
def test_check_encoded_general_rungs_match_jax(pin, case):
    seed, mut, f_cap_max, budget, rung = LADDER_CASES[case]
    pin(**GENERAL)
    je, pe = encodings(history(seed, 80, 6, 0.05, mutate=mut))
    want = jpal.check_encoded_general(je, JMODEL, f_cap=4,
                                      f_cap_max=f_cap_max,
                                      time_budget_s=budget)
    got = wk.check_encoded_general(pe, PMODEL, f_cap=4, f_cap_max=f_cap_max,
                                   time_budget_s=budget, device="cpu")
    assert _ladder_fields(got) == _ladder_fields(want)
    assert _ladder_fields(got)["kernel_rung"] == rung
    if rung == "dense":
        assert got["plan_family"] == "wgl3-plain-chunk"
    if "death_checkpoint" in want:
        assert_checkpoints_equal(want["death_checkpoint"],
                                 got["death_checkpoint"])


def _batch(seeds):
    hs = [history(s, n, procs, p, mutate=m) for s, n, procs, p, m in seeds]
    return [encodings(h) for h in hs]


# Dense-feasible (K <= 7 at 2^10 cells), tier-settled and laddered
# histories, valid and invalid.
MIXED = [(3, 40, 3, 0.0, None), (0, 80, 6, 0.05, None), (4, 40, 3, 0.0, 9),
         (2, 80, 6, 0.05, 502), (1, 120, 8, 0.05, None),
         (0, 80, 6, 0.05, 500)]


def test_batch_general_matches_jax(pin):
    pin(**GENERAL)
    encs = _batch(MIXED)
    idx = list(range(len(encs)))
    jres, pres = [None] * len(encs), [None] * len(encs)
    jk, pk = set(), set()
    want = jpal._batch_general([e[0] for e in encs], idx, JMODEL, jres, jk)
    got = wk._batch_general([e[1] for e in encs], idx, PMODEL, pres, pk,
                            device="cpu")
    assert got == want and pk == jk
    assert pres == jres
    assert want[0] and any(r is not None for r in jres)


def test_check_batch_encoded_auto_mixed_matches_jax(pin):
    pin(**GENERAL)
    encs = _batch(MIXED)
    want, jkernel = jpal.check_batch_encoded_auto([e[0] for e in encs],
                                                  JMODEL)
    got, pkernel = wk.check_batch_encoded_auto([e[1] for e in encs], PMODEL,
                                               "cpu")
    assert jkernel == pkernel == "mixed"
    for w, g in zip(want, got):
        assert g["valid"] == w["valid"] and g["dead_step"] == w["dead_step"]
        assert g["max_frontier"] == w["max_frontier"]
        if "kernel" in w and w["kernel"].startswith("wgl2"):
            assert g["kernel"] == w["kernel"] and g["f_cap"] == w["f_cap"]
            assert g["escalations"] == w["escalations"]
    assert {g.get("kernel", "dense") for g in got} >= {
        "dense", "wgl2-sort-batched", "wgl2-sort-resumable"}


# -- checkers ------------------------------------------------------------------

CHECKER = ("valid", "op_count", "dead_step", "max_frontier", "overflow",
           "f_cap", "escalations", "kernel", "failed_op")


@pytest.mark.parametrize("case", ["sort-valid", "sort-invalid",
                                  "dense-invalid"])
def test_linearizable_general_matches_jax(pin, case):
    seed, mut, _, _, _ = LADDER_CASES[case]
    pin(**GENERAL)
    h = history(seed, 80, 6, 0.05, mutate=mut)
    want = JLin(JMODEL, f_cap=4).check({}, h)
    got = Linearizable(PMODEL, device="cpu", f_cap=4).check({}, port_ops(h))
    for f in CHECKER:
        if f == "kernel" and str(want.get(f)).startswith("wgl3-dense"):
            assert got[f] == "wgl3-dense-plain-chunked"
            continue
        assert got.get(f) == want.get(f), (f, got, want)
    assert "death_checkpoint" not in got


@pytest.fixture
def small_cap(monkeypatch):
    """A witness effort cap (model steps) that the full replay of the
    witness history exceeds (about 16,000) and the replay from its sort
    checkpoint does not (about 1,000), in both packages."""
    monkeypatch.setattr(jwitness, "MAX_WITNESS_EVENTS", 2000)
    monkeypatch.setattr(pwitness, "MAX_WITNESS_EVENTS", 2000)


def _witness_history():
    """600 ops at concurrency 8 with the first ok read past 62% of the
    history reading 5, a value no write stores: the search dies at that
    read's return, step 259, just past the first sort chunk."""
    out = history(12, 600, 8, 0.0)
    i = next(i for i in range(int(0.62 * len(out)), len(out))
             if out[i].type == OK and out[i].f == "read")
    out[i].value = 5
    return out


def test_witness_from_sort_checkpoint_matches_jax(pin, small_cap, tmp_path):
    """No dense table under the chunked budget holds the history, so the
    windowed rung fails and both packages replay from the sort search's
    death checkpoint."""
    pin(dense_cell_budget=1 << 8, dense_cell_budget_chunked=1 << 10)
    h = _witness_history()
    (tmp_path / "p").mkdir()
    want = JLin(JMODEL, f_cap=4).check({}, h, {"store_dir": str(tmp_path)})
    got = Linearizable(PMODEL, device="cpu", f_cap=4).check(
        {}, port_ops(h), {"store_dir": str(tmp_path / "p")})
    assert want["valid"] is got["valid"] is False
    assert want["dead_step"] >= jwgl2.DEFAULT_CHUNK
    for f in CHECKER:
        assert got.get(f) == want.get(f), (f, got, want)
    assert got["witness"] == want["witness"] != "skipped"
    jw = json.loads((tmp_path / want["witness_file"]).read_text())
    pw = json.loads((tmp_path / "p" / got["witness_file"]).read_text())
    for f in ("op", "explanation", "dead_step", "window_start_step",
              "window_start_event", "note", "final_state"):
        assert pw[f] == jw[f], f
    assert pw["window_start_step"] == (want["dead_step"] // 256) * 256


def test_witness_rung_without_a_checkpoint_reruns_the_search(pin):
    pin(dense_cell_budget=1 << 8, dense_cell_budget_chunked=1 << 10)
    h = _witness_history()
    je, pe = encodings(h)
    want = jwitness.reconstruct_witness_from_sort_checkpoint(
        je, JMODEL, h)
    got = pwitness.reconstruct_witness_from_sort_checkpoint(
        pe, PMODEL, port_ops(h), device="cpu")
    assert got["op"] == want["op"] and got["dead_step"] == want["dead_step"]
    with pytest.raises(pwitness.WitnessEffortExceeded):
        pwitness.reconstruct_witness_from_sort_checkpoint(
            pe, PMODEL, port_ops(h), dead_step=10, device="cpu")


def test_independent_general_matches_jax(pin):
    """Keys no shared dense table serves: every key through the batched
    sort tiers, the unsettled ones laddered alone from f_cap_floor."""
    pin(**GENERAL)
    per_key = [history(s, n, procs, p, mutate=m)
               for s, n, procs, p, m in MIXED[1:]]
    ops = jfuzz.interleave_keyed(per_key)
    want = JInd(JLin(JMODEL, f_cap=4)).check({}, ops)
    got = IndependentChecker(Linearizable(PMODEL, device="cpu",
                                          f_cap=4)).check({}, port_ops(ops))
    assert got["valid"] == want["valid"] is False
    assert got["results"].keys() == want["results"].keys()
    for k, w in want["results"].items():
        g = got["results"][k]
        for f in ("valid", "dead_step", "max_frontier", "f_cap",
                  "escalations", "failed_op", "op_count"):
            assert g.get(f) == w.get(f), (k, f, g, w)
    assert any(w.get("backend") == "jax-batched"
               for w in want["results"].values())


def test_cli_analyze_checks_a_general_history(pin, tmp_path, capsys):
    """A stored history past the dense budget: checked, not refused (exit
    0 valid, 1 invalid)."""
    pin(**GENERAL)
    for mut, code in ((None, 0), (500, 1)):
        h = port_ops(history(0, 80, 6, 0.05, mutate=mut))
        enc = penc.encode_register_history(h, k_slots=64)
        assert pwgl3.dense_config(PMODEL, pwgl3.tight_k_slots(enc),
                                  enc.max_value) is None
        path = tmp_path / f"h{code}.jsonl"
        path.write_text(history_to_jsonl(h))
        assert cli.main(["analyze", str(path), "--device", "cpu"]) == code
        out = json.loads(capsys.readouterr().out)
        assert out["valid"] is (code == 0)


# -- the global tier's plain version and routing ---------------------------

def test_global_tier_geometry_and_plain_version():
    """The global tier takes 2^20 < S * 2^K <= 2^26; on CPU tensors its
    wrapper runs the plain resumable sweep."""
    cfg = pwgl3.DenseConfig(k_slots=16, n_states=32, state_offset=1)
    assert wk.global_tier(cfg)
    wk.check_geometry(cfg, "global")
    with pytest.raises(ValueError):
        wk.check_geometry(cfg)
    for K, S in ((15, 32), (24, 8)):
        with pytest.raises(ValueError):
            wk.check_geometry(pwgl3.DenseConfig(K, S, 1), "global")
    h = penc.encode_register_history(
        port_ops(history(1, 40, 16, 0.1, value_range=30)), k_slots=16)
    rs = penc.encode_return_steps(h)
    tg, cm = wk.prepare_steps(rs, PMODEL, cfg, "cpu")
    c0 = wk.start_carry(PMODEL, cfg, "cpu")
    ln = torch.tensor([rs.n_steps], dtype=torch.int32)
    got = wk.dense_sweep_global(ln, tg, cm, cfg, *(x.clone() for x in c0))
    want = wk.resumable_reference(ln, tg, cm, cfg, *c0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert wk.launches["dense_sweep_global"] == 0
    with pytest.raises(ValueError):
        wk.dense_sweep_global(ln.repeat(2), tg.repeat(2, 1),
                              cm.repeat(2, 1, 1, 1), cfg,
                              *(x.repeat(2, *[1] * (x.dim() - 1))
                                for x in c0))


def test_plan_labels_of_the_chunked_geometry():
    cfg = pwgl3.DenseConfig(k_slots=20, n_states=8, state_offset=1)
    p = plan.plan_long_sweep(cfg, "cpu")
    assert (p.family, p.label, p.sparse) == (
        "wgl3-plain-chunk", "wgl3-dense-plain-chunked", False)
    assert plan.plan_resumable(True) == "wgl2-chunk-canon"
    assert plan.plan_resumable() == "wgl2-chunk"
