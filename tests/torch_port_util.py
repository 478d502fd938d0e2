"""Shared helpers for the tests of the PyTorch port (tests/test_torch_*.py):
the same seeded inputs for both packages."""

from __future__ import annotations

import random

from jepsen_etcd_demo_tpu.ops.op import Op as JOp
from jepsen_etcd_demo_tpu.utils import fuzz as jfuzz
from jepsen_etcd_demo_tpu_torch.ops.op import Op as POp
from jepsen_etcd_demo_tpu_torch.utils import fuzz as pfuzz

FIELDS = ("valid", "dead_step", "max_frontier", "configs_explored")


def port_ops(history):
    """JAX package Ops -> port Ops (the two records have the same fields)."""
    return [POp(**vars(op)) for op in history]


def jax_ops(history):
    return [JOp(**vars(op)) for op in history]


def fuzz_pair(seed: int, n_ops: int = 40, n_procs: int = 6,
              p_info: float = 0.05, mutate: bool = False):
    """The same generated history from both packages' generators."""
    hj = jfuzz.gen_register_history(random.Random(seed), n_ops=n_ops,
                                    n_procs=n_procs, p_info=p_info)
    hp = pfuzz.gen_register_history(random.Random(seed), n_ops=n_ops,
                                    n_procs=n_procs, p_info=p_info)
    if mutate:
        hj = jfuzz.mutate_history(random.Random(10_000 + seed), hj)
        hp = pfuzz.mutate_history(random.Random(10_000 + seed), hp)
    return hj, hp


def fields(result: dict) -> tuple:
    return tuple(result[f] for f in FIELDS)
