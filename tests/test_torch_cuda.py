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
