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
from jepsen_etcd_demo_tpu.ops import encode as jenc
from jepsen_etcd_demo_tpu.ops import wgl2 as jwgl2
from jepsen_etcd_demo_tpu.ops import wgl3 as jwgl3
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

from torch_port_util import (GENERAL, assert_checkpoints_equal,
                             edge_history, encodings, history, one_device,
                             pin, port_ops)

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
        run = tmp_path / f"h{code}"
        run.mkdir()
        (run / "history.jsonl").write_text(history_to_jsonl(h))
        assert cli.main(["analyze", str(run), "--device", "cpu"]) == code
        assert json.loads(capsys.readouterr().out) == {"valid": code == 0}
        lin = json.loads((run / "results.json").read_text())["indep"][
            "linear"]
        assert lin["valid"] is (code == 0)
        assert lin["backend"] == "torch-cpu"


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


# The global tier's geometry rule as csrc/wgl3_sweep.cu's global_geometry
# applies it (the card's launcher is its only copy in the port; the card
# test test_torch_cuda.py::test_global_geometry_on_card_is_the_rule holds
# its choices to this rule's on the H100): a block's slice of the table is
# at most GLOBAL_SLICE_BYTES and, where the card holds that many blocks in
# clusters of GLOBAL_MAX_CLUSTER (up to GLOBAL_MAX_BLOCKS), at least
# GLOBAL_MIN_SLICE_BITS.
GLOBAL_SLICE_BYTES = 128 * 1024
GLOBAL_MIN_SLICE_BITS = 1 << 17
GLOBAL_MAX_CLUSTER = 16
GLOBAL_MAX_BLOCKS = 64
# Clusters of each size an NVIDIA H100 80GB HBM3 holds at once with a
# 128 KiB slice (and its step ring) and 1024 threads a block
# (cudaOccupancyMaxActiveClusters).
H100_MAX_CLUSTERS = {16: 7, 8: 15, 4: 30, 2: 66, 1: 132}


def global_geometry(n_states: int, k_slots: int,
                    max_clusters: dict[int, int] = H100_MAX_CLUSTERS) -> dict:
    """The global tier's launch for a table of S = n_states rows of
    2^(K-5) words given the card's resident clusters of each size
    (`max_clusters`): `blocks` G (as many as clusters of 16 hold, up to
    GLOBAL_MAX_BLOCKS, down to slices of GLOBAL_MIN_SLICE_BITS, up to
    slices of GLOBAL_SLICE_BYTES, and at least GLOBAL_MAX_CLUSTER),
    `cluster` C (the largest power of two up to 16 and G with G / C
    clusters resident; 0 if none is), `slice_words` a row's words per
    block, `threads` a block, and the slots j >= 5 by where their word
    pairs lie: `local_slots` (inside a slice), `cluster_slots` (two blocks
    of a cluster, through distributed shared memory) and `grid_slots` (two
    clusters, behind a grid barrier; none when G == C)."""
    W = 1 << (k_slots - 5)
    bits = n_states << k_slots
    lo = max(GLOBAL_MAX_CLUSTER, bits // 8 // GLOBAL_SLICE_BYTES)
    G = max(lo, min(GLOBAL_MAX_BLOCKS, bits // GLOBAL_MIN_SLICE_BITS))
    while G > lo and (max_clusters.get(GLOBAL_MAX_CLUSTER, 0)
                      * GLOBAL_MAX_CLUSTER < G):
        G //= 2
    C = min(G, GLOBAL_MAX_CLUSTER)
    while C >= 1 and max_clusters.get(C, 0) * C < G:
        C //= 2
    Wb = W // G
    slots = {"local_slots": [], "cluster_slots": [], "grid_slots": []}
    for j in range(5, k_slots):
        span = 1 << (j - 5)
        where = ("local" if span < Wb else
                 "cluster" if span < Wb * max(C, 1) else "grid")
        slots[f"{where}_slots"].append(j)
    return {"blocks": G, "cluster": C, "slice_words": Wb,
            "threads": min(Wb, 1024), **slots}


# (S, K) -> blocks, cluster size, cluster slots, grid slots, on the H100.
GLOBAL_GEOMETRY = [((8, 18), 16, 16, [14, 15, 16, 17], []),
                   ((8, 19), 32, 16, [14, 15, 16, 17], [18]),
                   ((8, 20), 64, 16, [14, 15, 16, 17], [18, 19]),
                   ((8, 21), 64, 16, [15, 16, 17, 18], [19, 20]),
                   ((8, 22), 64, 16, [16, 17, 18, 19], [20, 21]),
                   ((8, 23), 64, 16, [17, 18, 19, 20], [21, 22])]


@pytest.mark.parametrize("geom,blocks,cluster,cluster_slots,grid_slots",
                         GLOBAL_GEOMETRY)
def test_global_geometry_rule(geom, blocks, cluster, cluster_slots,
                              grid_slots):
    """The launcher's choice for each size the global tier takes (2^21 to
    2^26 bits): as many blocks as clusters of 16 hold on the card (64),
    down to 16 KiB slices and up to 128 KiB ones; every slot j >= 5 is
    local, crosses two blocks of a cluster or crosses two clusters (grid
    barrier), in that order."""
    S, K = geom
    g = global_geometry(S, K)
    assert (g["blocks"], g["cluster"]) == (blocks, cluster)
    assert g["cluster_slots"] == cluster_slots
    assert g["grid_slots"] == grid_slots
    assert g["local_slots"] == list(range(5, cluster_slots[0]))
    W = 1 << (K - 5)
    assert g["slice_words"] * blocks == W
    assert S * g["slice_words"] * 4 <= GLOBAL_SLICE_BYTES
    assert g["threads"] == min(1024, g["slice_words"])
    assert (1 << (cluster_slots[0] - 5)) == g["slice_words"]
    # A block index bit per crossing slot.
    assert 1 << len(cluster_slots + grid_slots) == blocks


def test_global_geometry_under_fewer_resident_clusters():
    """Where the card holds fewer clusters of 16, the grid shrinks to what
    they hold, or keeps its blocks in smaller clusters when its slices
    cannot grow; a card that holds no cluster gets cluster size 0."""
    few = {16: 3, 8: 15, 4: 30, 2: 66, 1: 132}
    g = global_geometry(8, 21, few)
    assert (g["blocks"], g["cluster"], g["grid_slots"]) == (32, 16, [20])
    g = global_geometry(8, 23, few)
    assert (g["blocks"], g["cluster"]) == (64, 8)
    assert g["cluster_slots"] == [17, 18, 19]
    assert g["grid_slots"] == [20, 21, 22]
    assert global_geometry(8, 21, {})["cluster"] == 0


@pytest.mark.parametrize("k", [19, 24])
@pytest.mark.parametrize("dies", [False, True])
def test_global_tier_plain_version_at_its_edges(pin, k, dies):
    """At the global tier's edges, 2^21 and 2^26 bits at the narrowest S
    (4): its plain version, through the long route's window chain, gives
    the JAX package's XLA long sweep's result."""
    pin(sparse_mode=1)
    hj = edge_history(k, writes=10, dies=dies)
    jrs = jenc.encode_return_steps(jenc.encode_register_history(hj, k))
    prs = penc.encode_return_steps(
        penc.encode_register_history(port_ops(hj), k))
    jcfg = jwgl3.dense_config(JMODEL, k, 1, budget=1 << 28)
    pcfg = pwgl3.DenseConfig(k_slots=k, n_states=jcfg.n_states,
                             state_offset=jcfg.state_offset)
    assert pcfg.n_states == 4 and wk.global_tier(pcfg)
    assert pcfg.n_states << k == (1 << 21 if k == 19 else 1 << 26)
    want = jwgl3.check_steps3_long(jrs, JMODEL, jcfg)
    _T, meta = wk.run_chain(prs, PMODEL, pcfg, "cpu")
    got = wk.long_result(meta[0].tolist())
    for f in ("valid", "dead_step", "max_frontier", "configs_explored"):
        assert got[f] == want[f], (f, got, want)
    assert got["valid"] is not dies and got["max_frontier"] > 1 << 9
    assert got["dead_step"] == (3 if dies else -1)


def test_plan_labels_of_the_chunked_geometry():
    cfg = pwgl3.DenseConfig(k_slots=20, n_states=8, state_offset=1)
    p = plan.plan_long_sweep(cfg, "cpu")
    assert (p.family, p.label, p.sparse) == (
        "wgl3-plain-chunk", "wgl3-dense-plain-chunked", False)
    assert plan.plan_resumable(True) == "wgl2-chunk-canon"
    assert plan.plan_resumable() == "wgl2-chunk"
