"""The slice as a whole at a small size: 32 fuzzed register histories
through the port's check_batch_encoded_auto against the JAX package's
router and the oracle; and the no-card behaviour of every entry point
(they raise, they never fall back to the host)."""

from __future__ import annotations

import pytest
import torch

from jepsen_etcd_demo_tpu.models import CASRegister as JM
from jepsen_etcd_demo_tpu.ops import wgl3_pallas
from jepsen_etcd_demo_tpu.ops.encode import encode_register_history as jenc
from jepsen_etcd_demo_tpu_torch import resolve_device
from jepsen_etcd_demo_tpu_torch.checkers import (IndependentChecker,
                                                 Linearizable)
from jepsen_etcd_demo_tpu_torch.checkers.oracle import check_events_oracle
from jepsen_etcd_demo_tpu_torch.models import CASRegister as PM
from jepsen_etcd_demo_tpu_torch.ops import wgl3_kernels as wk
from jepsen_etcd_demo_tpu_torch.ops.encode import encode_register_history

from torch_port_util import FIELDS, fuzz_pair


def _corpus(n: int = 32):
    jencs, pencs = [], []
    for i in range(n):
        hj, hp = fuzz_pair(1000 + i, n_ops=30 + (i % 5) * 4,
                           n_procs=4 + i % 4, p_info=0.02,
                           mutate=i % 3 == 0)
        jencs.append(jenc(hj, k_slots=32))
        pencs.append(encode_register_history(hp, k_slots=32))
    return jencs, pencs


@pytest.fixture(scope="module")
def corpus_results():
    jencs, pencs = _corpus()
    want, _ = wgl3_pallas.check_batch_encoded_auto(jencs, JM())
    got, kernel = wk.check_batch_encoded_auto(pencs, PM(), device="cpu")
    return pencs, want, got, kernel


def test_corpus_matches_jax_router(corpus_results):
    _, want, got, kernel = corpus_results
    assert kernel == "wgl3-dense-plain"
    assert len(got) == len(want) == 32
    for i, (w, g) in enumerate(zip(want, got)):
        for f in FIELDS:
            assert w[f] == g[f], (i, f)
        assert g["op_count"] == w["op_count"]
        assert g["table_cells"] == w["table_cells"]
    assert any(g["valid"] is False for g in got)
    assert any(g["valid"] is True for g in got)


def test_corpus_matches_oracle(corpus_results):
    pencs, _, got, _ = corpus_results
    for e, g in zip(pencs, got):
        o = check_events_oracle(e, PM())
        assert g["valid"] == o.valid and g["dead_step"] == o.dead_step(e)


def test_corpus_result_schema(corpus_results):
    _, _, got, _ = corpus_results
    for g in got:
        assert set(g) == {"survived", "overflow", "dead_step",
                          "max_frontier", "configs_explored", "valid",
                          "op_count", "table_cells"}
        assert g["overflow"] is False


def test_stage_timings_leave_results_unchanged(corpus_results):
    pencs, _, got, _ = corpus_results
    timings: dict[str, float] = {}
    again, _ = wk.check_batch_encoded_auto(pencs, PM(), device="cpu",
                                           timings=timings)
    assert again == got
    assert list(timings) == ["batch_steps3", "stack_h2d", "prepare_colmask",
                             "kernel", "fetch_assemble"]
    assert all(s >= 0.0 for s in timings.values())


def test_empty_batch():
    assert wk.check_batch_encoded_auto([], PM(), device="cpu") == ([], "none")


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this pins the no-card path")


def test_default_device_without_card_raises():
    _no_card()
    _, pencs = _corpus(2)
    before = dict(wk.launches)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        wk.check_batch_encoded_auto(pencs, PM())
    with pytest.raises(RuntimeError):
        wk.check_batch_encoded_auto(pencs, PM(), device="cuda")
    with pytest.raises(RuntimeError):
        Linearizable()
    with pytest.raises(RuntimeError):
        IndependentChecker(Linearizable(device="cuda"))
    with pytest.raises(RuntimeError):
        resolve_device(None)
    assert wk.launches == before


def test_dense_sweep_refuses_non_cpu_non_cuda_tensors():
    _, pencs = _corpus(2)
    from jepsen_etcd_demo_tpu_torch.ops import wgl3

    cfg, steps, r_cap = wgl3.batch_steps3(pencs, PM())
    ln, tg, cm = wk.prepare_colmask(
        PM(), cfg, *wgl3.stack_steps3(steps, r_cap, "cpu"))
    with pytest.raises(ValueError):
        wk.dense_sweep(ln.to("meta"), tg.to("meta"), cm.to("meta"), cfg, 1)


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
