"""Tests of the CUDA kernel itself. They need an NVIDIA GPU with nvcc and
skip without one; run them on the card with

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

(--noconftest: the suite's conftest sets up JAX, which a card machine
running only the port need not have.)
"""

from __future__ import annotations

import random

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
    wk.launches = 0
    got, kernel = wk.check_batch_encoded_auto(encs, CASRegister(), card)
    assert kernel == "wgl3-dense-cuda" and wk.launches == 1
    want, _ = wk.check_batch_encoded_auto(encs, CASRegister(), "cpu")
    assert [(g["valid"], g["dead_step"], g["max_frontier"],
             g["configs_explored"]) for g in got] == \
        [(w["valid"], w["dead_step"], w["max_frontier"],
          w["configs_explored"]) for w in want]
