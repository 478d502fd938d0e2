"""The port's long route (the resumable dense sweep, the sparse work-list
sweep, the windowed witness) against the JAX package on the same seeded
histories, with windows shrunk so that every history spans several.

Both packages' limits are pinned per test and restored after it. The
JAX package's XLA long sweep may canonicalise its frontier, which shrinks
the search metrics by design, so every comparison with it runs under
dedup_mode=1; the Pallas sweeps (interpret mode) never canonicalise. The
tolerance is exact equality on every compared field."""

from __future__ import annotations

import json
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from jepsen_etcd_demo_tpu import plan as jplan
from jepsen_etcd_demo_tpu.checkers import IndependentChecker as JInd
from jepsen_etcd_demo_tpu.checkers import Linearizable as JLin
from jepsen_etcd_demo_tpu.checkers import witness as jwitness
from jepsen_etcd_demo_tpu.models import CASRegister as JM
from jepsen_etcd_demo_tpu.ops import encode as jenc
from jepsen_etcd_demo_tpu.ops import limits as jlimits
from jepsen_etcd_demo_tpu.ops import wgl3 as jwgl3
from jepsen_etcd_demo_tpu.ops import wgl3_pallas as jpal
from jepsen_etcd_demo_tpu.ops.op import Op as JOp
from jepsen_etcd_demo_tpu.utils import fuzz as jfuzz
from jepsen_etcd_demo_tpu_torch import carry, plan
from jepsen_etcd_demo_tpu_torch.checkers import (IndependentChecker,
                                                 Linearizable)
from jepsen_etcd_demo_tpu_torch.checkers import witness as pwitness
from jepsen_etcd_demo_tpu_torch.checkers.oracle import check_events_oracle
from jepsen_etcd_demo_tpu_torch.models import CASRegister as PM
from jepsen_etcd_demo_tpu_torch.ops import encode as penc
from jepsen_etcd_demo_tpu_torch.ops import limits as plimits
from jepsen_etcd_demo_tpu_torch.ops import wgl3 as pwgl3
from jepsen_etcd_demo_tpu_torch.ops import wgl3_kernels as wk
from jepsen_etcd_demo_tpu_torch.ops import wgl3_sparse as psparse
from jepsen_etcd_demo_tpu_torch.utils import fuzz as pfuzz

from torch_port_util import edge_history, fuzz_pair, port_ops

JMODEL, PMODEL = JM(), PM()
LONG = ("valid", "survived", "dead_step", "max_frontier",
        "configs_explored")


@pytest.fixture
def pin():
    """pin(jax={...}, port={...}): install limits in both packages."""
    jprev = jlimits.set_limits(jlimits.KernelLimits(dedup_mode=1))
    pprev = plimits.limits()

    def _pin(jax=None, port=None):
        jlimits.set_limits(jlimits.KernelLimits(dedup_mode=1,
                                                **(jax or {})))
        plimits.set_limits(plimits.KernelLimits(**(port or {})))

    yield _pin
    jlimits.set_limits(jprev)
    plimits.set_limits(pprev)


def _steps_pair(hj, hp, k: int, k_enc: int = 16):
    """Both packages' return-major encodings at mask width k."""
    je = jenc.encode_register_history(hj, k_slots=k_enc)
    pe = penc.encode_register_history(hp, k_slots=k_enc)
    if k != k_enc:
        je, pe = jenc.reslot_events(je, k), penc.reslot_events(pe, k)
    return jenc.encode_return_steps(je), penc.encode_return_steps(pe)


def _cfgs(k: int, max_value: int, budget: int | None = None):
    jcfg = jwgl3.dense_config(JMODEL, k, max_value, budget=budget)
    pcfg = pwgl3.DenseConfig(k_slots=k, n_states=jcfg.n_states,
                             state_offset=jcfg.state_offset)
    return jcfg, pcfg


# -- the resumable dense sweep ----------------------------------------------

def _dense_case(trial: int):
    """The tests/test_wgl3_pallas.py resumable-sweep recipe: 300 ops at
    concurrency 6, odd trials mutated."""
    hj = jfuzz.gen_register_history(random.Random(trial), n_ops=300,
                                    n_procs=6, p_info=0.01)
    hp = pfuzz.gen_register_history(random.Random(trial), n_ops=300,
                                    n_procs=6, p_info=0.01)
    if trial % 2:
        hj = jfuzz.mutate_history(random.Random(100 + trial), hj)
        hp = pfuzz.mutate_history(random.Random(100 + trial), hp)
    je = jenc.encode_register_history(hj, k_slots=16)
    k = jwgl3.tight_k_slots(je)
    jrs, prs = _steps_pair(hj, hp, k)
    jcfg, pcfg = _cfgs(k, je.max_value)
    return jrs, prs, jcfg, pcfg


@pytest.mark.parametrize("trial", [0, 1, 2])
def test_long_route_matches_pallas_resumable(pin, trial):
    pin(jax={"max_r_pallas": 64, "pallas_step_chunk": 32},
        port={"long_window_steps": 64})
    jrs, prs, jcfg, pcfg = _dense_case(trial)
    assert prs.n_steps > 2 * wk.long_window() == 128
    want = jpal.check_steps3_long_pallas(jrs, JMODEL, jcfg, interpret=True)
    got = plan.dispatch_long(prs, PMODEL, pcfg, "cpu")
    for f in LONG:
        assert got[f] == want[f], (trial, f, got, want)
    assert got["plan_family"] == "wgl3-plain-chunk"
    assert got["kernel"] == "wgl3-dense-plain-chunked"


def test_long_window_matches_jax(pin):
    pin()
    assert wk.long_window() == 16384
    for cap in (32, 63, 64, 100, 1000, 16384, 40000):
        pin(port={"long_window_steps": cap})
        assert wk.long_window() == jpal._long_window(
            SimpleNamespace(max_r_pallas=cap)), cap


def test_jax_window_carried_into_the_port(pin):
    """JAX sweeps the first window; the port resumes from its (Tout,
    mt_next) and finishes with JAX's whole-chain result."""
    pin(jax={"max_r_pallas": 64, "pallas_step_chunk": 32},
        port={"long_window_steps": 64})
    jrs, prs, jcfg, pcfg = _dense_case(1)
    want = jpal.check_steps3_long_pallas(jrs, JMODEL, jcfg, interpret=True)
    launch = jpal._cached_resumable_launcher(JMODEL, jcfg, interpret=True)
    prep = jpal._cached_prep(JMODEL, jcfg)
    Sp = max(8, (jcfg.n_states + 7) // 8 * 8)
    Tin = np.zeros((1, Sp, 1 << (jcfg.k_slots - 5)), np.uint32)
    Tin[0, pwgl3.init_row(PMODEL, pcfg), 0] = 1
    sl = slice(0, 64)
    cm, tg, ln = prep(jrs.slot_tabs[sl][None], jrs.slot_active[sl][None],
                      jrs.targets[sl][None])
    _out, Tout, mt = launch(64)(ln, np.array([[0, -1, 1, 0, 0]], np.int32),
                                tg, cm, Tin, np.int32(64))
    T, meta = carry.table_from_numpy(np.asarray(Tout), np.asarray(mt), pcfg)
    assert int(meta[0, 4]) == 64
    # The carry round-trips to the JAX layout unchanged.
    back_T, back_m = carry.table_to_numpy(T, meta, pcfg)
    np.testing.assert_array_equal(back_T, np.asarray(Tout))
    np.testing.assert_array_equal(back_m, np.asarray(mt))
    _T, meta = wk.run_chain(prs, PMODEL, pcfg, "cpu", carry=(T, meta))
    got = wk.long_result(meta[0].tolist())
    for f in LONG:
        assert got[f] == want[f], (f, got, want)


def test_table_from_numpy_refuses_configs_in_padding_rows():
    _, pcfg = _cfgs(8, 4)
    table = np.zeros((1, 8, pcfg.n_words), np.uint32)
    table[0, pcfg.n_states - 1, 0] = 1
    carry.table_from_numpy(table, np.zeros((1, 5), np.int32), pcfg)
    pcfg4 = pwgl3.DenseConfig(k_slots=8, n_states=4, state_offset=1)
    table[0, 6, 0] = 1
    with pytest.raises(ValueError, match="padding rows"):
        carry.table_from_numpy(table, np.zeros((1, 5), np.int32), pcfg4)
    with pytest.raises(ValueError):
        carry.table_from_numpy(table[:, :, :1], np.zeros((1, 5)), pcfg4)


def test_configs_explored_wraps_per_window_and_saturates(pin):
    """A carry whose configs_explored starts at 2^31 - 100: the i32
    accumulator wraps inside the window exactly as JAX's resumable kernel
    does, and the long result saturates the negative count at the end."""
    pin(jax={"max_r_pallas": 64, "pallas_step_chunk": 32},
        port={"long_window_steps": 64})
    jrs, prs, jcfg, pcfg = _dense_case(0)
    launch = jpal._cached_resumable_launcher(JMODEL, jcfg, interpret=True)
    prep = jpal._cached_prep(JMODEL, jcfg)
    Sp = max(8, (jcfg.n_states + 7) // 8 * 8)
    Tin = np.zeros((1, Sp, 1 << (jcfg.k_slots - 5)), np.uint32)
    Tin[0, pwgl3.init_row(PMODEL, pcfg), 0] = 1
    mt0 = np.array([[0, -1, 1, 2**31 - 100, 0]], np.int32)
    sl = slice(0, 64)
    cm, tg, ln = prep(jrs.slot_tabs[sl][None], jrs.slot_active[sl][None],
                      jrs.targets[sl][None])
    out, _Tout, _mt = launch(64)(ln, mt0.copy(), tg, cm, Tin, np.int32(64))
    T, meta = carry.table_from_numpy(Tin, mt0, pcfg)
    _T, meta = wk.run_chain(prs, PMODEL, pcfg, "cpu", upto=64,
                            carry=(T, meta))
    assert int(meta[0, 3]) == int(np.asarray(out)[4]) < 0
    assert wk.long_result(meta[0].tolist())["configs_explored"] == 2**31 - 1
    # The batch route wraps instead (its accumulator never saturates).
    assert int(pwgl3.wrap_i32(torch.tensor(2**31 + 5))) == -2**31 + 5


def test_recover_table3_matches_jax(pin):
    pin()
    jrs, prs, jcfg, pcfg = _dense_case(2)
    for upto in (0, 37, 150):
        want = jwgl3.recover_table3(jrs, JMODEL, jcfg, upto, chunk=64)
        got = pwgl3.recover_table3(prs, PMODEL, pcfg, upto, "cpu")
        assert got == want, upto


# -- the sparse work-list sweep ---------------------------------------------

# Histories whose pending ops reach slot 12 (60 ops at concurrency 10 with
# indeterminate writes left pending), so configs live in several blocks.
SPARSE_CASES = [(9, 0.1, False), (8, 0.2, True), (11, 0.1, True)]


def _sparse_case(seed: int, p_info: float, mutate: bool, k: int = 13):
    hj = jfuzz.gen_register_history(random.Random(seed), n_ops=60,
                                    n_procs=10, p_info=p_info)
    hp = pfuzz.gen_register_history(random.Random(seed), n_ops=60,
                                    n_procs=10, p_info=p_info)
    if mutate:
        hj = jfuzz.mutate_history(random.Random(seed + 1), hj)
        hp = pfuzz.mutate_history(random.Random(seed + 1), hp)
    jrs, prs = _steps_pair(hj, hp, k, k_enc=k)
    assert jrs.max_pending >= 13
    jcfg, pcfg = _cfgs(k, 4, budget=1 << 28)
    return jrs, prs, jcfg, pcfg


@pytest.mark.parametrize("mode,pct", [(2, 25), (0, 50)])
@pytest.mark.parametrize("case", SPARSE_CASES)
def test_sparse_route_matches_pallas_sparse(pin, mode, pct, case):
    """sparse_mode=2 (every round sparse) and an auto threshold (rounds
    switch to dense past half the blocks): every field, the sweep record
    included, equals the sparse Pallas kernel's."""
    lim = {"sparse_mode": mode, "sparse_density_threshold_pct": pct}
    pin(jax={**lim, "sparse_min_tiles": 2, "max_r_pallas": 32},
        port={**lim, "sparse_min_words": 16, "long_window_steps": 32})
    jrs, prs, jcfg, pcfg = _sparse_case(*case)
    assert wk.sparse_selected(pcfg) and jpal.pallas_sparse_selected(jcfg)
    want = jpal.check_steps3_long_pallas_sparse(jrs, JMODEL, jcfg,
                                                interpret=True)
    got = plan.dispatch_long(prs, PMODEL, pcfg, "cpu")
    for f in LONG + ("sweep", "live_tile_ratio"):
        assert got[f] == want[f], (case, f, got, want)
    assert got["plan_family"] == "wgl3-plain-sparse-chunk"
    assert got["kernel"] == "wgl3-dense-plain-sparse-chunked"
    if case == SPARSE_CASES[0]:
        assert got["sweep"]["live_tile_ratio"] > 0.5   # block 1 was reached
    if mode == 2:
        assert got["sweep"]["steps_sparse"] == prs.n_steps


def test_jax_sparse_window_carried_into_the_port(pin):
    pin(jax={"sparse_mode": 2, "sparse_min_tiles": 2, "max_r_pallas": 32},
        port={"sparse_mode": 2, "long_window_steps": 32})
    jrs, prs, jcfg, pcfg = _sparse_case(*SPARSE_CASES[0])
    want = jpal.check_steps3_long_pallas_sparse(jrs, JMODEL, jcfg,
                                                interpret=True)
    launch = jpal._cached_sparse_resumable_launcher(JMODEL, jcfg, True)
    prep = jpal._cached_prep(JMODEL, jcfg)
    Tin = np.zeros((1, 8, jcfg.n_masks // 32), np.uint32)
    Tin[0, pwgl3.init_row(PMODEL, pcfg), 0] = 1
    sl = slice(0, 32)
    cm, tg, ln = prep(jrs.slot_tabs[sl][None], jrs.slot_active[sl][None],
                      jrs.targets[sl][None])
    _out, Tout, mt = launch(32)(ln, np.array([[0, -1, 1, 0, 0, 0, 0, 0]],
                                             np.int32),
                                tg, cm, Tin, np.int32(32))
    T, meta = carry.table_from_numpy(np.asarray(Tout), np.asarray(mt), pcfg)
    _T, meta = wk.run_chain(prs, PMODEL, pcfg, "cpu", sparse=True,
                            carry=(T, meta))
    m = meta[0].tolist()
    got = wk.long_result(m)
    for f in LONG:
        assert got[f] == want[f], (f, got, want)
    sweep = pwgl3.sweep_summary(m[5], m[7], m[6], tiling=(128, 2))
    assert sweep == want["sweep"]


def test_sparse_policy_matches_jax(pin):
    """The port's policy selects the sparse kernel where the JAX package
    selects its sparse Pallas kernel, within the Pallas envelope (K <= 16);
    the port's own kernel also takes K = 17 and 18. The port's one
    auto-mode threshold in words stands for JAX's tiles x tile words."""
    geoms = [(k, s) for k in (6, 12, 13, 14, 16, 17, 18) for s in (4, 8)
             if s << k <= 1 << 20]
    for jlim, plim in (({}, {}), ({"sparse_mode": 1}, {"sparse_mode": 1}),
                       ({"sparse_mode": 2}, {"sparse_mode": 2}),
                       ({"sparse_min_tiles": 2,
                         "sparse_density_threshold_pct": 60},
                        {"sparse_min_words": 16,
                         "sparse_density_threshold_pct": 60}),
                       ({"sparse_tile_words": 6, "sparse_mode": 2},
                        {"sparse_mode": 2}),
                       ({"sparse_tile_words": 64, "sparse_min_tiles": 2},
                        {"sparse_min_words": 128}),
                       ({"sparse_min_tiles": 32}, {"sparse_min_words": 256})):
        pin(jax=jlim, port=plim)
        for k, s in geoms:
            jcfg = jwgl3.DenseConfig(k_slots=k, n_states=s, state_offset=1)
            pcfg = pwgl3.DenseConfig(k_slots=k, n_states=s, state_offset=1)
            got = psparse.sparse_plan(pcfg)
            assert wk.sparse_selected(pcfg) == (got is not None)
            if k <= 16:
                assert wk.sparse_selected(pcfg) == \
                    jpal.pallas_sparse_selected(jcfg), (jlim, k)
                if got is not None:
                    assert got.blocks == jpal.pallas_sparse_blocks(jcfg)
            else:
                assert not jpal.pallas_sparse_blocks(jcfg)
                assert (got is not None) == (
                    plim.get("sparse_mode") == 2 or "sparse_min_words" in plim)
                if got is not None:
                    assert got.blocks == 1 << (k - 12)
    pin(port={"sparse_mode": 2})
    limited = pwgl3.DenseConfig(k_slots=14, n_states=4, state_offset=1,
                                max_rounds=3)
    assert psparse.sparse_plan(limited) is None
    pin(port={"sparse_density_threshold_pct": 30, "sparse_min_words": 16})
    auto = psparse.sparse_plan(pwgl3.DenseConfig(k_slots=16, n_states=4,
                                                 state_offset=1))
    assert (auto.blocks, auto.thresh_blocks) == (16, 4)


def test_sparse_route_past_the_pallas_envelope(pin):
    """At K = 17 (32 blocks) the port's sparse kernel takes the history
    where the JAX package's Pallas envelope stops: the verdict fields equal
    the JAX package's long sweep and the port's own dense route."""
    pin(port={"sparse_mode": 2, "long_window_steps": 32})
    jrs, prs, jcfg, pcfg = _sparse_case(*SPARSE_CASES[0], k=17)
    assert not jpal.pallas_sparse_selected(jcfg)
    want = jplan.dispatch_long(jrs, JMODEL, jcfg)
    got = plan.dispatch_long(prs, PMODEL, pcfg, "cpu")
    assert got["plan_family"] == "wgl3-plain-sparse-chunk"
    assert got["sweep"]["tiles"] == 32
    assert got["sweep"]["steps_sparse"] == prs.n_steps
    pin(port={"sparse_mode": 1, "long_window_steps": 32})
    dense = plan.dispatch_long(prs, PMODEL, pcfg, "cpu")
    assert dense["plan_family"] == "wgl3-plain-chunk"
    for f in LONG:
        assert got[f] == want[f] == dense[f], (f, got, want)


def test_sweep_summary_matches_jax():
    cfg_j = jwgl3.DenseConfig(k_slots=14, n_states=8, state_offset=1)
    for args in ((0.0, 0, 0), (30.0, 10, 10), (25.0, 10, 3), (7.0, 9, 0),
                 (100.0, 10, 20)):
        for tiling in (None, (128, 4)):
            # JAX's default tiling of K = 14 is 64 tiles of 8 words.
            assert pwgl3.sweep_summary(*args, tiling=tiling or (8, 64)) == \
                jwgl3.sweep_summary(cfg_j, *args, tiling=tiling)


@pytest.mark.parametrize("k", [13, 18])
@pytest.mark.parametrize("dies", [False, True])
def test_sparse_plain_version_at_its_edges(pin, k, dies):
    """At the sparse kernel's edges, 2 and 64 blocks (K=13 and 18) at the
    narrowest S (4), with configs in many blocks: its plain version, every
    round sparse and with a threshold of 4 live blocks, gives the JAX
    package's XLA long sweep's verdict fields and the port's dense plain
    version's carry, and counts every step."""
    pin(jax={"sparse_mode": 1})
    hj = edge_history(k, writes=9, dies=dies)
    jrs = jenc.encode_return_steps(jenc.encode_register_history(hj, k))
    prs = penc.encode_return_steps(
        penc.encode_register_history(port_ops(hj), k))
    jcfg, pcfg = _cfgs(k, 1, budget=1 << 28)
    assert pcfg.n_states == 4
    nb = pcfg.n_words // 128
    assert nb == (2 if k == 13 else 64)
    want = jwgl3.check_steps3_long(jrs, JMODEL, jcfg)
    tg, cm = wk.prepare_steps(prs, PMODEL, pcfg, "cpu")
    ln = torch.tensor([prs.n_steps], dtype=torch.int32)
    dense = wk.dense_sweep_resumable(ln, tg, cm, pcfg,
                                     *wk.start_carry(PMODEL, pcfg, "cpu"))
    live = None
    for thresh in (nb, 4):
        T, meta = wk.sparse_sweep_resumable(
            ln, tg, cm, pcfg, *wk.start_carry(PMODEL, pcfg, "cpu", True),
            thresh)
        m = meta[0].tolist()
        got = wk.long_result(m)
        for f in ("valid", "dead_step", "max_frontier", "configs_explored"):
            assert got[f] == want[f], (f, got, want)
        assert torch.equal(T, dense[0]) and m[:5] == dense[1][0].tolist()
        assert m[7] == prs.n_steps
        if thresh == nb:
            assert m[6] == prs.n_steps   # every step sparse
            live = m[5]
        else:
            assert m[5] == live          # the same live blocks either way
    assert live > prs.n_steps * (1 if k == 13 else 4)


def test_sparse_wrapper_refuses_narrow_tables():
    cfg = pwgl3.DenseConfig(k_slots=12, n_states=4, state_offset=1)
    T, meta = pwgl3.fresh_carry(cfg, 0, 1, "cpu", width=8)
    ln = torch.zeros(1, dtype=torch.int32)
    tg = torch.zeros((1, 1), dtype=torch.int32)
    cm = torch.zeros((1, 1, 4, 12), dtype=torch.int32)
    with pytest.raises(ValueError, match="13 <= K"):
        wk.sparse_sweep_resumable(ln, tg, cm, cfg, pwgl3.words32(T),
                                  meta.int(), 2)
    with pytest.raises(ValueError, match="check_steps3_long_sparse|sparse"):
        wk.check_steps3_long_sparse(None, PMODEL, cfg, "cpu")


# -- the checkers past one scan ---------------------------------------------

LONG_SCAN = 1024


def _long_history(seed: int, mutate_seed: int | None = None,
                  n_ops: int = 1800):
    """A register history of about 1300 return steps at concurrency 5 from
    both packages' generators; with `mutate_seed`, the first mutant that
    the port's oracle finds dying after return step 300."""
    hj, hp = fuzz_pair(seed, n_ops=n_ops, n_procs=5, p_info=0.0)
    if mutate_seed is None:
        return hj, hp
    for i in range(50):
        mp = pfuzz.mutate_history(random.Random(mutate_seed + i), hp)
        enc = penc.encode_register_history(mp, k_slots=16)
        o = check_events_oracle(enc, PMODEL)
        if not o.valid and o.dead_step(enc) > 300:
            return jfuzz.mutate_history(random.Random(mutate_seed + i), hj), mp
    raise AssertionError("no late-dying mutant")


@pytest.fixture(scope="module")
def late_mutant():
    return _long_history(40, mutate_seed=400)


def _witness_fields(r: dict) -> tuple:
    return (r["valid"], r["dead_step"], r.get("failed_op"), r.get("witness"))


def test_linearizable_past_long_scan_max_matches_jax(pin, tmp_path):
    pin(jax={"long_scan_max": LONG_SCAN}, port={"long_scan_max": LONG_SCAN})
    hj, hp = _long_history(41)
    want = JLin().check({}, hj)
    got = Linearizable(device="cpu").check({}, hp)
    assert got["valid"] is True
    for f in ("valid", "dead_step", "max_frontier", "configs_explored",
              "op_count", "f_cap"):
        assert got[f] == want[f], f
    enc = penc.encode_register_history(hp, k_slots=32)
    assert wk.check_batch_encoded_auto([enc], PMODEL, "cpu")[1] == \
        "wgl3-dense-plain-chunked"


def test_windowed_witness_matches_jax(pin, tmp_path, late_mutant,
                                      monkeypatch):
    """A long invalid history whose full replay exceeds a shrunk effort
    cap in both packages: the windowed rung recovers the frontier before
    the death point and names the same failed op at the same step."""
    pin(jax={"long_scan_max": LONG_SCAN}, port={"long_scan_max": LONG_SCAN})
    monkeypatch.setattr(jwitness, "MAX_WITNESS_EVENTS", 3000)
    monkeypatch.setattr(pwitness, "MAX_WITNESS_EVENTS", 3000)
    hj, hp = late_mutant
    enc = penc.encode_register_history(hp, k_slots=32)
    assert penc.encode_return_steps(enc).n_steps > LONG_SCAN
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    want = JLin().check({}, hj, {"store_dir": str(tmp_path / "j")})
    got = Linearizable(device="cpu").check({}, hp,
                                          {"store_dir": str(tmp_path / "p")})
    assert got["valid"] is False and got["dead_step"] > 300
    assert _witness_fields(got) == _witness_fields(want)
    wj = json.loads((tmp_path / "j" / want["witness_file"]).read_text())
    wp = json.loads((tmp_path / "p" / got["witness_file"]).read_text())
    assert wp["window_start_step"] == wj["window_start_step"] > 0
    for f in ("op", "process", "event_index", "dead_step", "explanation",
              "window_start_event"):
        assert wp[f] == wj[f], f
    assert (tmp_path / "p" / "linear.svg").read_text().startswith("<svg")


def test_full_replay_witness_matches_jax(pin, late_mutant):
    pin(jax={"long_scan_max": LONG_SCAN}, port={"long_scan_max": LONG_SCAN})
    hj, hp = late_mutant
    want = JLin().check({}, hj)
    got = Linearizable(device="cpu").check({}, hp)
    assert _witness_fields(got) == _witness_fields(want)
    assert got["failed_op"] and got["witness"].startswith("no reachable")


def test_witness_skipped_marker_when_every_rung_fails(pin, late_mutant,
                                                      monkeypatch):
    pin(port={"long_scan_max": LONG_SCAN})
    monkeypatch.setattr(pwitness, "MAX_WITNESS_EVENTS", 10)
    got = Linearizable(device="cpu").check({}, late_mutant[1])
    assert got["valid"] is False and got["witness"] == "skipped"
    assert "WitnessEffortExceeded" in got["witness_detail"]
    assert "failed_op" not in got


def test_independent_long_keys_match_jax(pin, late_mutant, monkeypatch):
    pin(jax={"long_scan_max": LONG_SCAN}, port={"long_scan_max": LONG_SCAN})
    monkeypatch.setattr(jwitness, "MAX_WITNESS_EVENTS", 3000)
    monkeypatch.setattr(pwitness, "MAX_WITNESS_EVENTS", 3000)
    short_j, short_p = fuzz_pair(42, n_ops=60, n_procs=4)
    hj = jfuzz.interleave_keyed([late_mutant[0], short_j])
    hp = pfuzz.interleave_keyed([late_mutant[1], short_p])
    want = JInd(JLin()).check({}, hj)
    got = IndependentChecker(Linearizable(device="cpu")).check({}, hp)
    assert got["valid"] is want["valid"] is False
    for k, r in want["results"].items():
        g = got["results"][k]
        assert _witness_fields(g) == _witness_fields(r), k
        for f in ("max_frontier", "configs_explored"):
            assert g[f] == r[f], (k, f)
    assert got["results"]["0"].get("failed_op")


def test_dispatch_long_budget_zero_is_unknown(pin):
    pin(jax={"max_r_pallas": 64}, port={"long_window_steps": 64})
    jrs, prs, jcfg, pcfg = _dense_case(0)
    want = jplan.dispatch_long(jrs, JMODEL, jcfg, time_budget_s=0)
    got = plan.dispatch_long(prs, PMODEL, pcfg, "cpu", time_budget_s=0)
    assert got["valid"] == want["valid"] == "unknown"
    for f in ("survived", "overflow", "dead_step", "max_frontier",
              "configs_explored", "kernel"):
        assert got[f] == want[f], f
    assert "time budget" in got["error"]
    res = Linearizable(device="cpu", time_budget_s=0)
    pin(port={"long_scan_max": LONG_SCAN})
    out = res.check({}, _long_history(43)[1])
    assert out["valid"] == "unknown" and out["overflow"] is True


def test_not_dense_feasible_long_history_takes_general_path(pin):
    """A long history that is not dense-feasible takes the general path
    (it no longer raises), with the JAX package's verdict."""
    from jepsen_etcd_demo_tpu_torch.ops.op import Op

    pin(port={"long_scan_max": LONG_SCAN})
    # The sort ladder canonicalises under the default dedup_mode in both
    # packages (pin's dedup_mode=1 is for the table sweeps).
    jlimits.set_limits(jlimits.KernelLimits())
    h = [Op(type="invoke", f="write", value=1, process=p) for p in range(30)]
    h += [Op(type="info", f="write", value=1, process=p) for p in range(30)]
    # A read of 9, a value no write stores, ends the search right there.
    h += [Op(type="invoke", f="read", value=None, process=99),
          Op(type="ok", f="read", value=9, process=99)]
    h += port_ops(_long_history(44)[0])
    subsumed = Linearizable(device="cpu").check({}, h)
    # The JAX package's search frontier for frontier: no subsumption.
    plimits.set_limits(plimits.KernelLimits(long_scan_max=LONG_SCAN,
                                            subsume_mode=1))
    got = Linearizable(device="cpu").check({}, h)
    want = JLin().check({}, [JOp(**vars(op)) for op in h])
    for f in ("valid", "dead_step", "max_frontier", "kernel", "failed_op",
              "witness"):
        assert got.get(f) == want.get(f), f
    assert got["kernel"] == "wgl2-sort-resumable"
    assert got["valid"] is False and got["dead_step"] == 0
    # Subsumption keeps the verdict and shrinks the frontier.
    for f in ("valid", "dead_step", "kernel", "failed_op", "witness"):
        assert subsumed.get(f) == want.get(f), f
    assert subsumed["max_frontier"] < want["max_frontier"]


def test_cli_analyze_long_invalid_history_prints_witness(pin, tmp_path,
                                                         capsys,
                                                         late_mutant):
    from jepsen_etcd_demo_tpu_torch import cli
    from jepsen_etcd_demo_tpu_torch.ops.op import history_to_jsonl

    pin(port={"long_scan_max": LONG_SCAN})
    run = tmp_path / "long"
    run.mkdir()
    (run / "history.jsonl").write_text(history_to_jsonl(late_mutant[1]))
    assert cli.main(["analyze", str(run), "--device", "cpu"]) == 1
    assert json.loads(capsys.readouterr().out) == {"valid": False}
    out = json.loads((run / "results.json").read_text())["indep"]["linear"]
    want = Linearizable(device="cpu").check({}, late_mutant[1])
    assert _witness_fields(out) == _witness_fields(want)
    assert out["failed_op"] and out["dead_step"] > 300
