"""Tests of the CUDA kernels themselves. They need an NVIDIA GPU with nvcc
and skip without one; run them on the card with

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

(--noconftest: the suite's conftest sets up JAX, which a card machine
running only the port need not have.)
"""

from __future__ import annotations

import random
from functools import partial

import pytest
import torch

from jepsen_etcd_demo_tpu_torch.models import CASRegister
from jepsen_etcd_demo_tpu_torch.ops import wgl3, wgl3_kernels as wk
from jepsen_etcd_demo_tpu_torch.ops.encode import encode_register_history
from jepsen_etcd_demo_tpu_torch.utils.fuzz import (gen_register_history,
                                                   mutate_history)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _encs(n: int, seed: int):
    rng = random.Random(seed)
    out = []
    for i in range(n):
        h = gen_register_history(rng, n_ops=60 + 7 * i, n_procs=8,
                                 p_info=0.01)
        if i % 2:
            h = mutate_history(rng, h)
        out.append(encode_register_history(h, k_slots=32))
    return out


def test_kernel_equals_plain_on_card(card):
    model = CASRegister()
    cfg, steps, r_cap = wgl3.batch_steps3(_encs(9, 1), model)
    ln, tg, cm = wk.prepare_colmask(
        model, cfg, *wgl3.stack_steps3(steps, r_cap, card))
    row0 = wgl3.init_row(model, cfg)
    got = wk.dense_sweep(ln, tg, cm, cfg, row0)
    torch.cuda.synchronize()
    assert torch.equal(got, wk.sweep_reference(ln, tg, cm, cfg, row0))


def test_main_path_launches_the_kernel(card):
    encs = _encs(5, 2)
    wk.reset_launches()
    got, kernel = wk.check_batch_encoded_auto(encs, CASRegister(), card)
    assert kernel == "wgl3-dense-cuda" and wk.launches["dense_sweep"] == 1
    want, _ = wk.check_batch_encoded_auto(encs, CASRegister(), "cpu")
    assert [(g["valid"], g["dead_step"], g["max_frontier"],
             g["configs_explored"]) for g in got] == \
        [(w["valid"], w["dead_step"], w["max_frontier"],
          w["configs_explored"]) for w in want]


def _chain_inputs(K: int, S: int, seed: int, device):
    """A history at mask width K whose pending ops reach slot min(K,13)-1,
    prepared on `device`: (cfg, ln, tg, cm)."""
    from jepsen_etcd_demo_tpu_torch.ops.encode import (SlotOverflow,
                                                       encode_return_steps)

    model = CASRegister()
    cfg = wgl3.DenseConfig(k_slots=K, n_states=S,
                           state_offset=model.state_offset)
    for i in range(500):
        rng = random.Random(seed + i)
        h = gen_register_history(rng, n_ops=130, n_procs=min(K, 10),
                                 value_range=S - 1, p_info=0.06)
        if i % 2:
            h = mutate_history(rng, h, value_range=S - 1)
        try:
            enc = encode_register_history(h, k_slots=K)
        except SlotOverflow:
            continue
        if enc.max_pending >= min(K, 13):
            break
    rs = encode_return_steps(enc)
    arrays = (torch.from_numpy(a[None]).to(device)
              for a in (rs.slot_tabs, rs.slot_active, rs.targets))
    return (cfg,) + wk.prepare_colmask(model, cfg, *arrays)


def _chain(cfg, tg, cm, sweep, sparse):
    """The carry after each 32-step window of the route's own window loop
    through `sweep`, from a fresh start."""
    carry = wk.start_carry(CASRegister(), cfg, tg.device, sparse)
    return [(T.clone(), m.clone())
            for T, m in wk.window_sweep(sweep, tg, cm, cfg, carry, 32)]


@pytest.mark.parametrize("K,S", [(6, 8), (12, 4), (13, 8), (17, 8)])
def test_resumable_kernel_equals_plain_over_windows(card, K, S):
    cfg, _ln, tg, cm = _chain_inputs(K, S, 100 * K + S, card)
    got = _chain(cfg, tg, cm, wk.dense_sweep_resumable, False)
    want = _chain(cfg, tg, cm, wk.resumable_reference, False)
    torch.cuda.synchronize()
    assert len(got) >= 3
    for (Tk, mk), (Tp, mp) in zip(got, want):
        assert torch.equal(Tk, Tp) and torch.equal(mk, mp)


@pytest.mark.parametrize("K,S", [(13, 8), (14, 32), (16, 4), (17, 8),
                                 (18, 4)])
def test_sparse_kernel_equals_plain_over_windows(card, K, S):
    cfg, _ln, tg, cm = _chain_inputs(K, S, 200 * K + S, card)
    nb = cfg.n_words // 128
    for thresh in (nb, max(1, nb // 4)):
        got = _chain(cfg, tg, cm, partial(wk.sparse_sweep_resumable,
                                          thresh_blocks=thresh), True)
        want = _chain(cfg, tg, cm, partial(wk.sparse_reference,
                                           thresh_blocks=thresh), True)
        torch.cuda.synchronize()
        assert len(got) >= 3
        for (Tk, mk), (Tp, mp) in zip(got, want):
            assert torch.equal(Tk, Tp) and torch.equal(mk, mp)


def test_long_route_launches_per_window(card):
    from dataclasses import replace

    from jepsen_etcd_demo_tpu_torch.checkers import Linearizable
    from jepsen_etcd_demo_tpu_torch.ops.limits import limits, set_limits

    from jepsen_etcd_demo_tpu_torch.ops.encode import encode_return_steps

    h = gen_register_history(random.Random(7), n_ops=600, n_procs=6,
                             p_info=0.0)
    steps = encode_return_steps(encode_register_history(h, k_slots=16))
    prev = set_limits(replace(limits(), long_scan_max=128,
                              long_window_steps=128))
    try:
        wk.reset_launches()
        got = Linearizable(device=card).check({}, h)
        n = wk.launches["dense_sweep_resumable"]
    finally:
        set_limits(prev)
    want = Linearizable(device=card).check({}, h)
    assert n == -(-steps.n_steps // 128) >= 3
    for f in ("valid", "dead_step", "max_frontier", "configs_explored"):
        assert got[f] == want[f]


def test_elle_accumulate_equals_plain_on_card(card):
    import chip_smoke
    from jepsen_etcd_demo_tpu_torch.ops import cycles_tiled as ct

    ct.reset_launches()
    launched = 0
    for name, R_flat, work in chip_smoke.accumulate_cases(card):
        got = ct.tile_accumulate(R_flat, work)
        want = ct.tile_accumulate_reference(R_flat, work)
        torch.cuda.synchronize()
        assert torch.equal(got, want), name
        launched += name != "empty"
    assert ct.launches["tile_accumulate"] == launched


def test_elle_tiled_closure_kernel_equals_plain_on_card(card):
    import numpy as np

    import chip_smoke
    from jepsen_etcd_demo_tpu_torch.checkers import ElleChecker
    from jepsen_etcd_demo_tpu_torch.ops import cycles_tiled as ct
    from jepsen_etcd_demo_tpu_torch.utils.fuzz import append_txn_ops

    _h, _full, sub = chip_smoke.pool_graph(3000, 7)
    ct.reset_launches()
    Rk, ck, sk = ct.closure_tiled(sub, card)
    assert ct.launches["tile_accumulate"] == sk["rounds_sparse"] > 0
    Rp, cp, sp = ct.closure_tiled(sub, card, ct.tile_accumulate_reference)
    assert torch.equal(Rk, Rp) and sk == sp and np.array_equal(ck, cp)
    h = append_txn_ops(chip_smoke.pool_txns(3000, 7))
    got = ElleChecker(device=card).check({}, h)
    want = ElleChecker(device="cpu").check({}, h)
    assert got["valid"] is True and got["backend"] == "torch-closure-cuda"
    assert {**got, "backend": None} == {**want, "backend": None}


def test_alu_peak_equals_plain_on_card(card):
    from jepsen_etcd_demo_tpu_torch.ops import peak as pk

    sms = torch.cuda.get_device_properties(card).multi_processor_count
    n = sms * pk.THREADS_PER_SM + 77     # a ragged last block
    pk.reset_launches()
    for iters in (0, 1, 300):
        got, ops = pk.alu_peak(n, iters, card)
        want = pk.alu_peak_reference(pk.probe_input(n, card), iters)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and ops == pk.word_ops(n, iters)
    assert pk.launches["alu_peak"] == 3
    res = pk.measure_peak(card, iters=2000, reps=1)
    assert res["card_word_ops_per_s"] > res["sm_word_ops_per_s"] > 0


# (K, S) from K=5 to the dense budget's largest (S * 2^K <= 2^20), on both
# sides of the register/shared-memory cut of csrc/wgl3_sweep.cu.
SWEEP_GEOMS = [(5, 4), (7, 8), (9, 32), (10, 8), (10, 32), (11, 16),
               (11, 20), (12, 8), (12, 12), (13, 4), (13, 8), (14, 4),
               (15, 16), (16, 8), (17, 8), (18, 4)]


def test_sweep_geometries_cover_both_routes(card):
    import chip_smoke

    routes = {chip_smoke.register_route(wgl3.DenseConfig(
        k_slots=K, n_states=S, state_offset=1)) for K, S in SWEEP_GEOMS}
    assert routes == {True, False}


@pytest.mark.parametrize("K,S", SWEEP_GEOMS)
def test_sweep_routes_equal_plain_fresh_and_resumed(card, K, S):
    """Whole scan and a chain of resumed windows, valid and mutant
    histories that fill the high slots, against the plain versions."""
    for seed in (300 * K + S, 300 * K + S + 1):
        cfg, ln, tg, cm = _chain_inputs(K, S, seed, card)
        row0 = wgl3.init_row(CASRegister(), cfg)
        want = wk.sweep_reference(ln, tg, cm, cfg, row0)
        want_chain = _chain(cfg, tg, cm, wk.resumable_reference, False)
        # Every slot table of the register route (the shared-memory route
        # takes none).
        for where in wk.SLOT_TABLES:
            got = wk.dense_sweep(ln, tg, cm, cfg, row0, slot_table=where)
            torch.cuda.synchronize()
            assert torch.equal(got, want), where
            chain = _chain(cfg, tg, cm, partial(wk.dense_sweep_resumable,
                                                slot_table=where), False)
            torch.cuda.synchronize()
            for (Tk, mk), (Tp, mp) in zip(chain, want_chain):
                assert torch.equal(Tk, Tp) and torch.equal(mk, mp), where


def _dying_inputs(K: int, S: int, device):
    """A history at width K that dies past its 8th step, prepared on
    `device`: (cfg, tg, cm, dead_step)."""
    from jepsen_etcd_demo_tpu_torch.ops.encode import (SlotOverflow,
                                                       encode_return_steps)

    model = CASRegister()
    cfg = wgl3.DenseConfig(k_slots=K, n_states=S,
                           state_offset=model.state_offset)
    for i in range(500):
        rng = random.Random(1000 * K + i)
        h = mutate_history(rng, gen_register_history(
            rng, n_ops=120, n_procs=min(K, 8), value_range=S - 1,
            p_info=0.02), value_range=S - 1)
        try:
            enc = encode_register_history(h, k_slots=K)
        except SlotOverflow:
            continue
        rs = encode_return_steps(enc)
        tg, cm = wk.prepare_steps(rs, model, cfg, device)
        ln = torch.tensor([tg.shape[1]], dtype=torch.int32, device=device)
        dead = int(wk.sweep_reference(ln, tg, cm, cfg,
                                      wgl3.init_row(model, cfg))[0, 2])
        if dead >= 8 and tg.shape[1] >= dead + 12:
            return cfg, tg, cm, dead
    raise AssertionError(f"no history dies late enough at K={K}")


@pytest.mark.parametrize("K,S", [(10, 8), (12, 8), (14, 8), (16, 4)])
def test_resumed_windows_around_the_death(card, K, S):
    """Windows [0, d), [d, d+5) (dead at its step 0) and [d+5, d+10)
    (starts dead: only the offset advances), kernel against plain."""
    cfg, tg, cm, d = _dying_inputs(K, S, card)
    carries = {}
    for name, sweep in (("kernel", wk.dense_sweep_resumable),
                        ("ring", partial(wk.dense_sweep_resumable,
                                         slot_table="ring")),
                        ("plain", wk.resumable_reference)):
        T, m = wk.start_carry(CASRegister(), cfg, card)
        out = []
        for lo, hi in ((0, d), (d, d + 5), (d + 5, d + 10)):
            ln = torch.tensor([hi - lo], dtype=torch.int32, device=card)
            T, m = sweep(ln, tg[:, lo:hi].contiguous(),
                         cm[:, lo:hi].contiguous(), cfg, T, m)
            out.append((T.clone(), m.clone()))
        carries[name] = out
    torch.cuda.synchronize()
    for kernel in ("kernel", "ring"):
        for (Tk, mk), (Tp, mp) in zip(carries[kernel], carries["plain"]):
            assert torch.equal(Tk, Tp) and torch.equal(mk, mp), kernel
    metas = [m[0].tolist() for _T, m in carries["kernel"]]
    assert metas[0][0] == 0 and metas[0][4] == d
    assert metas[1][:2] == [1, d] and metas[1][4] == d + 5
    assert metas[2][:4] == metas[1][:4] and metas[2][4] == d + 10


@pytest.mark.parametrize("n", [1, 5, 9])
def test_corpus_layout_with_mixed_widths(card, n):
    """A batch whose histories need different widths, checked under the
    batch's shared geometry (K=12, S=8: the register route, histories
    packed by warp, a ragged last block) and under a wider one (K=13:
    the shared-memory route)."""
    from jepsen_etcd_demo_tpu_torch.ops.encode import encode_return_steps

    model = CASRegister()
    rng = random.Random(n)
    steps = []
    for i in range(n):
        h = gen_register_history(rng, n_ops=40 + 30 * i,
                                 n_procs=2 + (i % 9), p_info=0.0)
        if i % 3 == 2:
            h = mutate_history(rng, h)
        steps.append(encode_return_steps(
            encode_register_history(h, k_slots=12)))
    r_cap = wgl3.step_bucket(max(s.n_steps for s in steps))
    arrays = wgl3.stack_steps3(steps, r_cap, card)
    for K in (12, 13):
        cfg = wgl3.DenseConfig(k_slots=K, n_states=8,
                               state_offset=model.state_offset)
        ln, tg, cm = wk.prepare_colmask(model, cfg, *arrays) if K == 12 \
            else wk.prepare_colmask(model, cfg, *_widen(arrays, K))
        row0 = wgl3.init_row(model, cfg)
        want = wk.sweep_reference(ln, tg, cm, cfg, row0)
        for where in wk.SLOT_TABLES:
            got = wk.dense_sweep(ln, tg, cm, cfg, row0, slot_table=where)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (K, where)


def _widen(arrays, K: int):
    """Step arrays (slot_tabs [B,R,K0,4], slot_active [B,R,K0], targets)
    padded with inactive slots to width K."""
    tabs, act, tgt = arrays
    pad = K - tabs.shape[2]
    tabs = torch.cat([tabs, tabs.new_zeros(tabs.shape[:2] + (pad, 4))], 2)
    act = torch.cat([act, act.new_zeros(act.shape[:2] + (pad,))], 2)
    return tabs, act, tgt


def test_elle_accumulate_pool_rounds_equal_plain(card):
    """The tensor-core accumulate on the pool history's real round-0 and
    round-3 work lists (T=256), exactly equal to the plain version."""
    import chip_smoke
    from jepsen_etcd_demo_tpu_torch.ops import cycles_tiled as ct

    rounds = dict(chip_smoke.pool_round_inputs(card))
    for r in (0, 3):
        R = rounds[r]
        nb, T = R.shape[0], R.shape[-1]
        R_flat, work = R.reshape(nb * nb, T, T), ct.work_list(R)
        got = ct.tile_accumulate(R_flat, work)
        want = ct.tile_accumulate_reference(R_flat, work)
        torch.cuda.synchronize()
        assert torch.equal(got, want), r


@pytest.mark.parametrize("K,S", [(18, 8), (16, 32)])
def test_global_tier_equals_plain_over_windows(card, K, S):
    """The global tier (tables past 2^20 bits over thread-block clusters)
    against sweep_plain_carry after every 32-step window, through the long
    route's window loop."""
    cfg, _ln, tg, cm = _chain_inputs(K, S, 300 * K + S, card)
    assert wk.global_tier(cfg)
    wk.reset_launches()
    got = _chain(cfg, tg, cm, wk.dense_sweep_global, False)
    n_launch = wk.launches["dense_sweep_global"]
    want = _chain(cfg, tg, cm, wk.resumable_reference, False)
    torch.cuda.synchronize()
    assert len(got) >= 3 and n_launch == len(got)
    for (Tk, mk), (Tp, mp) in zip(got, want):
        assert torch.equal(Tk, Tp) and torch.equal(mk, mp)


def _edge_inputs(K: int, writes: int, dies: bool, device):
    """S = 4 (values 0..1): K - writes - 1 indeterminate cas ops that never
    fire hold the low slots, `writes` indeterminate writes of 0 the slots
    above them (so the crossing slots fire), then reads of 0 (and with
    `dies` one of 1, which ends the search): (cfg, tg, cm)."""
    from jepsen_etcd_demo_tpu_torch.ops.encode import encode_return_steps
    from jepsen_etcd_demo_tpu_torch.ops.op import Op

    cas = range(K - writes - 1)
    wr = range(K - writes - 1, K - 1)
    h = [Op(type="invoke", f="cas", value=(1, 1), process=p) for p in cas]
    h += [Op(type="invoke", f="write", value=0, process=p) for p in wr]
    for v in (0, 0, 0, 1) if dies else (0, 0, 0):
        h += [Op(type="invoke", f="read", value=None, process=100),
              Op(type="ok", f="read", value=v, process=100)]
    h += [Op(type="info", f="cas", value=(1, 1), process=p) for p in cas]
    h += [Op(type="info", f="write", value=0, process=p) for p in wr]
    model = CASRegister()
    cfg = wgl3.DenseConfig(k_slots=K, n_states=4,
                           state_offset=model.state_offset)
    rs = encode_return_steps(encode_register_history(h, k_slots=K))
    return (cfg,) + wk.prepare_steps(rs, model, cfg, device)


@pytest.mark.parametrize("S,K,blocks,cluster", [
    (8, 18, 16, 16), (8, 19, 32, 16), (8, 20, 64, 16), (8, 21, 64, 16),
    (8, 22, 64, 16), (8, 23, 64, 16), (4, 19, 16, 16), (4, 24, 64, 16)])
def test_global_geometry_on_card_is_the_rule(card, S, K, blocks, cluster):
    """The launcher's blocks and cluster size on an H100 (7 clusters of
    16 resident) are the geometry rule's
    (test_torch_general.py::global_geometry)."""
    assert wk.card_global_geometry(S, K) == (blocks, cluster)


@pytest.mark.parametrize("K", [19, 24])
@pytest.mark.parametrize("dies", [False, True])
def test_global_tier_edges_equal_plain(card, K, dies):
    """2^21 bits (one cluster, no grid barrier) and 2^26 bits (four
    clusters, two grid slots) at S = 4, with the writes in the crossing
    slots: the kernel equals its plain version after every window."""
    cfg, tg, cm = _edge_inputs(K, 10, dies, card)
    got = _chain(cfg, tg, cm, wk.dense_sweep_global, False)
    want = _chain(cfg, tg, cm, wk.resumable_reference, False)
    torch.cuda.synchronize()
    for (Tk, mk), (Tp, mp) in zip(got, want):
        assert torch.equal(Tk, Tp) and torch.equal(mk, mp)
    assert int(got[-1][1][0, 1]) == (3 if dies else -1)


@pytest.mark.parametrize("K", [13, 18])
@pytest.mark.parametrize("dies", [False, True])
def test_sparse_kernel_edges_equal_plain(card, K, dies):
    """2 and 64 blocks at S = 4 with configs spread over many blocks:
    every round sparse, and a threshold of 4 live blocks (rounds switch to
    dense), equal to the plain version, telemetry included."""
    cfg, tg, cm = _edge_inputs(K, 9, dies, card)
    nb = cfg.n_words // 128
    for thresh in (nb, 4):
        got = _chain(cfg, tg, cm, partial(wk.sparse_sweep_resumable,
                                          thresh_blocks=thresh), True)
        want = _chain(cfg, tg, cm, partial(wk.sparse_reference,
                                           thresh_blocks=thresh), True)
        torch.cuda.synchronize()
        for (Tk, mk), (Tp, mp) in zip(got, want):
            assert torch.equal(Tk, Tp) and torch.equal(mk, mp)


def test_global_tier_refuses_tables_it_does_not_take(card):
    """A table past 2^26 bits, or one the shared-memory route takes,
    raises on the card; nothing falls back to the plain version."""
    model = CASRegister()
    for K, S in ((24, 8), (17, 8)):
        cfg = wgl3.DenseConfig(k_slots=K, n_states=S,
                               state_offset=model.state_offset)
        T, meta = wk.start_carry(model, cfg, card)
        tg = torch.zeros((1, 4), dtype=torch.int32, device=card)
        cm = torch.zeros((1, 4, S, K), dtype=torch.int32, device=card)
        ln = torch.tensor([4], dtype=torch.int32, device=card)
        with pytest.raises(ValueError):
            wk.dense_sweep_global(ln, tg, cm, cfg, T, meta)
    cfg = wgl3.DenseConfig(k_slots=24, n_states=8,
                           state_offset=model.state_offset)
    with pytest.raises(ValueError):
        wk.dense_sweep_resumable(ln, tg, torch.zeros(
            (1, 4, 8, 24), dtype=torch.int32, device=card), cfg,
            torch.zeros((1, 8, 1 << 19), dtype=torch.int32, device=card),
            torch.zeros((1, 5), dtype=torch.int32, device=card))


def test_general_path_on_card_equals_plain(card):
    """A history past the dense budget through Linearizable on the card
    and on the host: the same verdict fields."""
    from jepsen_etcd_demo_tpu_torch.checkers import Linearizable

    for mutate in (False, True):
        rng = random.Random(0x6E1)
        h = gen_register_history(rng, n_ops=200, n_procs=10, p_info=0.03)
        if mutate:
            h = mutate_history(rng, h)
        got = Linearizable(device=card).check({}, h)
        want = Linearizable(device="cpu").check({}, h)
        for f in ("valid", "dead_step", "max_frontier", "f_cap",
                  "escalations", "kernel", "failed_op"):
            if f == "kernel" and str(want.get(f)).startswith("wgl3"):
                continue
            assert got.get(f) == want.get(f), (f, got, want)


def _gset_inputs(K: int, seed: int, device):
    """A batch of gset histories (values 0..4, so S = 32) re-slotted to
    mask width K, one of them mutated, prepared on `device`: (cfg, ln,
    tg, cm). Adds from row 31 (the set {0..4}) land on row 31, so bit 31
    of cm[..., 31, :] is set: negative as int32, a uint32 in the
    kernels."""
    from jepsen_etcd_demo_tpu_torch.models import GSet
    from jepsen_etcd_demo_tpu_torch.ops.encode import (encode_history,
                                                       encode_return_steps,
                                                       reslot_events)
    from jepsen_etcd_demo_tpu_torch.utils.fuzz import (gen_gset_history,
                                                       mutate_family_history)

    model = GSet()
    rng = random.Random(seed)
    steps = []
    while len(steps) < 4:
        h = gen_gset_history(rng, n_ops=150, n_procs=K - 2, p_info=0.02)
        if len(steps) == 1:
            h = mutate_family_history(rng, h, "gset")
        enc = encode_history(h, model, k_slots=32)
        if K - 2 <= enc.max_pending <= K:
            steps.append(encode_return_steps(reslot_events(enc, K)))
    cfg = wgl3.DenseConfig(k_slots=K, n_states=32, state_offset=0)
    r_cap = wgl3.step_bucket(max(s.n_steps for s in steps))
    ln, tg, cm = wk.prepare_colmask(model, cfg,
                                    *wgl3.stack_steps3(steps, r_cap, device))
    assert tuple(cm.shape[2:]) == (32, K)
    assert bool((cm[:, :, 31, :] < 0).any())
    return cfg, ln, tg, cm


@pytest.mark.parametrize("K", [10, 13])
def test_gset_column_masks_equal_plain(card, K):
    """The register route (K = 10 at S = 32) and the shared route (K = 13)
    on gset column masks, row 31's sign bit included: whole scan and a
    chain of resumed windows, against the plain versions."""
    import chip_smoke

    from jepsen_etcd_demo_tpu_torch.models import GSet

    cfg, ln, tg, cm = _gset_inputs(K, 0x65E7 + K, card)
    assert chip_smoke.register_route(cfg) == (K == 10), K
    row0 = wgl3.init_row(GSet(), cfg)
    got = wk.dense_sweep(ln, tg, cm, cfg, row0)
    want = wk.sweep_reference(ln, tg, cm, cfg, row0)
    torch.cuda.synchronize()
    assert torch.equal(got, want), (got.tolist(), want.tolist())
    for b in range(tg.shape[0]):
        n = int(ln[b])
        one = (tg[b:b + 1, :n], cm[b:b + 1, :n])
        # The kernel updates its carry in place: each chain starts fresh.
        got_chain = [(T.clone(), m.clone()) for T, m in wk.window_sweep(
            wk.dense_sweep_resumable, *one, cfg,
            wk.start_carry(GSet(), cfg, card, False), 32)]
        want_chain = [(T.clone(), m.clone()) for T, m in wk.window_sweep(
            wk.resumable_reference, *one, cfg,
            wk.start_carry(GSet(), cfg, card, False), 32)]
        torch.cuda.synchronize()
        assert len(got_chain) == len(want_chain) >= 3
        for (Tk, mk), (Tp, mp) in zip(got_chain, want_chain):
            assert torch.equal(Tk, Tp) and torch.equal(mk, mp), b


def test_streamed_key_equals_plain_stream_on_card(card):
    """A KeyStream on the card (every chunk one launch of the resumable
    sweep, with padded partial flushes) against the same stream's plain
    version on the CPU: every field equal, and the stream launched the
    kernel."""
    from jepsen_etcd_demo_tpu_torch.stream import KeyStream

    h = mutate_history(random.Random(9), gen_register_history(
        random.Random(9), n_ops=600, n_procs=8, p_info=0.01))
    wk.reset_launches()
    got = KeyStream(CASRegister(), None, device=card)
    want = KeyStream(CASRegister(), None, device="cpu")
    for i, op in enumerate(h):
        for ks in (got, want):
            ks.feed(op, live=True)
            if i % 97 == 0:
                ks.flush_partial(live=True)
    g, w = got.finalize(), want.finalize()
    assert wk.launches["dense_sweep_resumable"] >= 1
    for f in ("valid", "survived", "dead_step", "max_frontier",
              "configs_explored"):
        assert g[f] == w[f], f


@pytest.mark.parametrize("real,pads", [(9, 3), (5, 0), (1, 7)])
def test_bucket_launch_with_all_pad_lanes_on_card(card, real, pads):
    """A scheduler bucket launch whose b is not a multiple of 4, at a step
    count a bucket above every real length: equal to the plain version,
    each all-pad lane surviving with no work."""
    from jepsen_etcd_demo_tpu_torch.ops.encode import (encode_return_steps,
                                                       reslot_events)
    from jepsen_etcd_demo_tpu_torch.sched import engine

    model = CASRegister()
    encs = _encs(real, 30 + real)
    k = max(wgl3.tight_k_slots(e) for e in encs)
    cfg = wgl3.dense_config(model, k, max(e.max_value for e in encs))
    steps = [encode_return_steps(reslot_events(e, k)) for e in encs]
    r = wgl3.step_bucket(2 * max(s.n_steps for s in steps) + 1)
    padded = steps + [engine._pad_rs(k)] * pads
    got = engine.launch_bucket(model, cfg, padded, r, card)
    ln, tg, cm = wk.prepare_colmask(
        model, cfg, *wgl3.stack_steps3(padded, r, card))
    want = wk.sweep_reference(ln, tg, cm, cfg, wgl3.init_row(model, cfg))
    assert torch.equal(got, want)
    assert got[real:].tolist() == [[1, 0, -1, 1, 0]] * pads


def test_check_corpus_on_card_equals_plain(card):
    """The scheduler on the card, every bucket launched before one read
    back: every result equals the plain versions'."""
    from jepsen_etcd_demo_tpu_torch import sched

    rng = random.Random(0x5C4ED)
    encs = []
    for i in range(40):
        h = gen_register_history(rng, n_ops=rng.randrange(8, 400),
                                 n_procs=8, p_info=0.0)
        if i % 3 == 0:
            h = mutate_history(rng, h)
        encs.append(encode_register_history(h, k_slots=32))
    wk.reset_launches()
    got, kernel, stats = sched.check_corpus(encs, CASRegister())
    assert wk.launches["dense_sweep"] == stats["launches"] >= 3
    want, _k, _s = sched.check_corpus(encs, CASRegister(), device="cpu")
    assert kernel == "wgl3-dense-cuda"
    for g, w in zip(got, want):
        for f in ("valid", "dead_step", "max_frontier", "configs_explored"):
            assert g[f] == w[f]
