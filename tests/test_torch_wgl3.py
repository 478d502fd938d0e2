"""The port's plain dense sweep against the JAX package's XLA kernel and
both Pallas kernels (interpret mode), on the same stacked arrays. All five
packed fields are integers: the tolerance is exact equality."""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from jepsen_etcd_demo_tpu.models import CASRegister as JM
from jepsen_etcd_demo_tpu.ops import encode as jenc
from jepsen_etcd_demo_tpu.ops import wgl3 as jwgl3
from jepsen_etcd_demo_tpu.ops import wgl3_pallas
from jepsen_etcd_demo_tpu_torch.models import CASRegister as PM
from jepsen_etcd_demo_tpu_torch.ops import encode as penc
from jepsen_etcd_demo_tpu_torch.ops import wgl3 as pwgl3
from jepsen_etcd_demo_tpu_torch.ops import wgl3_kernels as wk

from golden import GOLDEN
from torch_port_util import fuzz_pair, port_ops

JMODEL, PMODEL = JM(), PM()


def _batch(k: int, n: int = 8, n_ops: int = 40, seed: int = 0):
    """n fuzzed histories (every other one mutated, lengths ragged) encoded
    by both packages at mask width k, plus the common step bucket."""
    jsteps, psteps = [], []
    for i in range(n):
        hj, hp = fuzz_pair(seed + i, n_ops=n_ops - 3 * (i % 4),
                           n_procs=min(6, k), p_info=0.03 if k > 6 else 0.0,
                           mutate=bool(i % 2))
        je = jenc.encode_register_history(hj, k_slots=k)
        pe = penc.encode_register_history(hp, k_slots=k)
        jsteps.append(jenc.encode_return_steps(je))
        psteps.append(penc.encode_return_steps(pe))
    r_cap = jwgl3.step_bucket(max(s.n_steps for s in jsteps))
    max_value = max(s.max_value for s in jsteps)
    jcfg = jwgl3.dense_config(JMODEL, k, max_value)
    pcfg = pwgl3.dense_config(PMODEL, k, max_value)
    return jcfg, pcfg, jsteps, psteps, r_cap


def _plain(pcfg, psteps, r_cap):
    arrays = pwgl3.stack_steps3(psteps, r_cap, "cpu")
    return pwgl3.check_batch_plain(*arrays, PMODEL, pcfg).numpy()


@pytest.mark.parametrize("k", [6, 8, 12])
def test_plain_matches_xla_kernel(k):
    jcfg, pcfg, jsteps, psteps, r_cap = _batch(k)
    ref = np.asarray(jwgl3.cached_batch_checker3_packed(JMODEL, jcfg)(
        *jwgl3.stack_steps3(jsteps, r_cap)))
    got = _plain(pcfg, psteps, r_cap)
    assert (got[:, 0] == 0).any(), "batch must hold a dead history"
    np.testing.assert_array_equal(ref[:, :5], got)


@pytest.mark.parametrize("k", [6, 8, 12])
def test_plain_matches_pallas_per_history_kernel(k):
    jcfg, pcfg, jsteps, psteps, r_cap = _batch(k, seed=100)
    ref = np.asarray(wgl3_pallas.make_batch_checker_pallas(
        JMODEL, jcfg, interpret=True)(*jwgl3.stack_steps3(jsteps, r_cap)))
    np.testing.assert_array_equal(ref, _plain(pcfg, psteps, r_cap))


@pytest.mark.parametrize("k", [6, 8, 12])
def test_plain_matches_pallas_grouped_kernel(k):
    # 7 histories under group=8: the grouped kernel pads the group with an
    # all-pad history, and the port's batch is ragged with pads too.
    jcfg, pcfg, jsteps, psteps, r_cap = _batch(k, n=7, seed=200)
    ref = np.asarray(wgl3_pallas.make_batch_checker_pallas_grouped(
        JMODEL, jcfg, group=8, interpret=True)(
            *jwgl3.stack_steps3(jsteps, r_cap)))
    np.testing.assert_array_equal(ref, _plain(pcfg, psteps, r_cap))


def test_golden_through_plain_matches_verdicts_and_xla():
    jencs = [jenc.encode_register_history(h, k_slots=16) for _, h, _ in GOLDEN]
    pencs = [penc.encode_register_history(port_ops(h), k_slots=16)
             for _, h, _ in GOLDEN]
    ref = jwgl3.check_batch_encoded3(jencs, JMODEL)
    got, kernel = wk.check_batch_encoded_auto(pencs, PMODEL, device="cpu")
    assert kernel == "wgl3-dense-plain"
    for (name, _, expected), r, g in zip(GOLDEN, ref, got):
        assert g["valid"] is expected, name
        for f in ("valid", "dead_step", "max_frontier", "configs_explored"):
            assert r[f] == g[f], (name, f)


@pytest.mark.parametrize("k", [6, 12])
def test_prepare_colmask_matches_pallas_prep(k):
    jcfg, pcfg, jsteps, psteps, r_cap = _batch(k, n=4, seed=300)
    cm_j, tg_j, ln_j = wgl3_pallas.prepare_pallas_batch(
        JMODEL, jcfg, *jwgl3.stack_steps3(jsteps, r_cap))
    ln, tg, cm = wk.prepare_colmask(
        PMODEL, pcfg, *pwgl3.stack_steps3(psteps, r_cap, "cpu"))
    S = pcfg.n_states
    want = np.asarray(cm_j)[:, :, :S, :k].astype(np.uint32)
    np.testing.assert_array_equal(cm.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(tg_j))
    np.testing.assert_array_equal(ln.numpy(), np.asarray(ln_j))


def test_colmask_round_trips_to_transitions():
    _, pcfg, _, psteps, r_cap = _batch(8, n=3, seed=400)
    tabs, act, tgt = pwgl3.stack_steps3(psteps, r_cap, "cpu")
    _, _, cm = wk.prepare_colmask(PMODEL, pcfg, tabs, act, tgt)
    want = pwgl3.transitions(PMODEL, pcfg, tabs, act)
    assert torch.equal(wk.colmask_transitions(cm), want)


def test_wrapper_on_cpu_runs_the_plain_version():
    _, pcfg, _, psteps, r_cap = _batch(12, n=5, seed=500)
    arrays = pwgl3.stack_steps3(psteps, r_cap, "cpu")
    ln, tg, cm = wk.prepare_colmask(PMODEL, pcfg, *arrays)
    before = wk.launches
    got = wk.dense_sweep(ln, tg, cm, pcfg, pwgl3.init_row(PMODEL, pcfg))
    assert wk.launches == before, "the CPU path must not count a launch"
    assert got.dtype == torch.int32 and got.shape == (5, 5)
    assert torch.equal(got, pwgl3.check_batch_plain(*arrays, PMODEL, pcfg))


def test_wide_states_geometry_matches_xla():
    """S = 32 (values up to 30): the widest state axis the kernel takes."""
    encs_j, encs_p = [], []
    for i in range(4):
        from jepsen_etcd_demo_tpu.utils.fuzz import gen_register_history
        from jepsen_etcd_demo_tpu_torch.utils.fuzz import \
            gen_register_history as pgen

        hj = gen_register_history(random.Random(i), n_ops=30, n_procs=5,
                                  value_range=31)
        hp = pgen(random.Random(i), n_ops=30, n_procs=5, value_range=31)
        encs_j.append(jenc.encode_register_history(hj, k_slots=16))
        encs_p.append(penc.encode_register_history(hp, k_slots=16))
    ref = jwgl3.check_batch_encoded3(encs_j, JMODEL)
    got, _ = wk.check_batch_encoded_auto(encs_p, PMODEL, device="cpu")
    assert got[0]["table_cells"] == ref[0]["table_cells"] == 32 * 2 ** 6
    for r, g in zip(ref, got):
        for f in ("valid", "dead_step", "max_frontier", "configs_explored"):
            assert r[f] == g[f], f


def test_popcount32_matches_numpy():
    rng = np.random.default_rng(7)
    x = rng.integers(0, 2**32, size=4096, dtype=np.int64)
    x[:3] = [0, 2**32 - 1, 2**31]
    got = pwgl3.popcount32(torch.from_numpy(x)).numpy()
    want = np.array([bin(int(v)).count("1") for v in x])
    np.testing.assert_array_equal(got, want)


def test_configs_explored_wraps_as_i32():
    # The Pallas kernels accumulate configs_explored in an i32 that wraps.
    x = torch.tensor([0, 5, 2**31 - 1, 2**31, 2**32 + 7, 3 * 2**31])
    want = np.array([0, 5, 2**31 - 1, 2**31, 2**32 + 7, 3 * 2**31],
                    dtype=np.int64).astype(np.uint32).view(np.int32)
    np.testing.assert_array_equal(
        pwgl3.wrap_i32(x).to(torch.int32).numpy(), want)


@pytest.mark.parametrize("k,s", [(4, 8), (6, 36), (18, 8), (17, 16)])
def test_wrapper_rejects_geometries_outside_the_kernel(k, s):
    cfg = pwgl3.DenseConfig(k_slots=k, n_states=s, state_offset=1)
    with pytest.raises(ValueError):
        wk.check_geometry(cfg)


def test_truncating_round_cap_is_rejected():
    cfg = pwgl3.DenseConfig(k_slots=8, n_states=8, state_offset=1,
                            max_rounds=3)
    with pytest.raises(ValueError):
        wk.check_geometry(cfg)
    ok = pwgl3.DenseConfig(k_slots=18, n_states=4, state_offset=1)
    wk.check_geometry(ok)   # K=18 at S=4 is 2^20 cells: admitted


def test_wrapper_rejects_shape_mismatch():
    _, pcfg, _, psteps, r_cap = _batch(8, n=2, seed=600)
    ln, tg, cm = wk.prepare_colmask(
        PMODEL, pcfg, *pwgl3.stack_steps3(psteps, r_cap, "cpu"))
    with pytest.raises(ValueError):
        wk.dense_sweep(ln, tg, cm[:, :, :4], pcfg, 1)
    with pytest.raises(ValueError):
        wk.dense_sweep(ln, tg, cm, pcfg, pcfg.n_states)
