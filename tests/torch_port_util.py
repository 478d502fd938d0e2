"""Shared helpers for the tests of the PyTorch port (tests/test_torch_*.py):
the same seeded inputs for both packages."""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from jepsen_etcd_demo_tpu.ops import encode as jenc
from jepsen_etcd_demo_tpu.ops import limits as jlimits
from jepsen_etcd_demo_tpu.ops.op import INVOKE, OK
from jepsen_etcd_demo_tpu.ops.op import Op as JOp
from jepsen_etcd_demo_tpu.utils import fuzz as jfuzz
from jepsen_etcd_demo_tpu_torch import carry
from jepsen_etcd_demo_tpu_torch import models as pmodels
from jepsen_etcd_demo_tpu_torch.ops import encode as penc
from jepsen_etcd_demo_tpu_torch.ops import limits as plimits
from jepsen_etcd_demo_tpu_torch.ops.op import Op as POp
from jepsen_etcd_demo_tpu_torch.utils import fuzz as pfuzz

FIELDS = ("valid", "dead_step", "max_frontier", "configs_explored")


# The constructor arguments a model takes, by name (the same in both
# packages).
MODEL_ARGS = {"cas-register": ("initial",), "register": ("initial",),
              "fifo-queue": ("max_value", "capacity"),
              "multi-register": ("n_registers", "max_value")}


def port_model(jax_model):
    """The port's model of the same name and geometry as a JAX one."""
    kw = {a: getattr(jax_model, a) for a in MODEL_ARGS.get(jax_model.name,
                                                           ())}
    return pmodels.REGISTRY[jax_model.name](**kw)


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


def edge_history(k: int, writes: int, dies: bool = False):
    """A history (JAX package Ops) that fills k slots at once: k - writes
    - 1 indeterminate cas ops expecting 1, a value no op writes (they
    never fire), take the low slots; `writes` indeterminate writes of 0
    the slots above them; then three reads of 0 return, and with `dies`
    a fourth read returns 1, which ends the search. Values stay within
    0..1, so the geometry has its narrowest S (4)."""
    cas = range(k - writes - 1)
    wr = range(k - writes - 1, k - 1)
    h = [JOp(type="invoke", f="cas", value=(1, 1), process=p) for p in cas]
    h += [JOp(type="invoke", f="write", value=0, process=p) for p in wr]
    for v in (0, 0, 0, 1) if dies else (0, 0, 0):
        h += [JOp(type="invoke", f="read", value=None, process=100),
              JOp(type="ok", f="read", value=v, process=100)]
    h += [JOp(type="info", f="cas", value=(1, 1), process=p) for p in cas]
    h += [JOp(type="info", f="write", value=0, process=p) for p in wr]
    return h


# -- the general path (tests/test_torch_general.py, test_torch_canon.py) --

# Budgets under which histories from K = 8 go general and the
# dense-chunked rung exists up to K = 11 at S = 8.
GENERAL = {"dense_cell_budget": 1 << 10, "dense_cell_budget_chunked": 1 << 14}


@pytest.fixture(autouse=True)
def one_device(monkeypatch):
    """The JAX package sees one device: the suite's virtual 8-device CPU
    platform would send its ladder to the lattice-sharded rung and its
    batches to the sharded launches, which the port has no counterpart of
    yet (ROADMAP §A, multi-device)."""
    import jax

    monkeypatch.setattr(jax, "device_count", lambda *a, **k: 1)


@pytest.fixture
def pin():
    """pin(**limits): install the same limits in both packages, with the
    port's subsumption off (the JAX package has none, and these tests
    hold the two searches to each other frontier for frontier)."""
    jprev, pprev = jlimits.limits(), plimits.limits()

    def _pin(**kw):
        jlimits.set_limits(jlimits.KernelLimits(**kw))
        plimits.set_limits(plimits.KernelLimits(subsume_mode=1, **kw))

    _pin()
    yield _pin
    jlimits.set_limits(jprev)
    plimits.set_limits(pprev)


def history(seed: int, n_ops: int, n_procs: int, p_info: float, *,
            value_range: int = 5, p_write: float = 0.35,
            mutate: int | None = None, big: int | None = None,
            stuck: int = 0):
    """A generated register history (the JAX package's generator; the
    port's draws the same numbers per seed), mutated with seed `mutate`,
    with a final write of `big` appended (huge values), and `stuck` cas
    ops invoked first that never complete and can never fire (each
    cas(value_range + 2 -> value_range + 3 + i) waits for a value no write
    stores): they hold `stuck` slots for the whole history."""
    h = jfuzz.gen_register_history(random.Random(seed), n_ops=n_ops,
                                   n_procs=n_procs, p_info=p_info,
                                   value_range=value_range, p_write=p_write)
    if mutate is not None:
        h = jfuzz.mutate_history(random.Random(mutate), h,
                                 value_range=value_range)
    h = [JOp(type=INVOKE, f="cas", process=500 + i,
             value=(value_range + 2, value_range + 3 + i))
         for i in range(stuck)] + h
    if big is not None:
        h = h + [JOp(type=INVOKE, f="write", value=big, process=999),
                 JOp(type=OK, f="write", value=big, process=999)]
    for i, op in enumerate(h):
        op.index = i
    return h


def encodings(h, k_slots: int = 64):
    return (jenc.encode_register_history(h, k_slots=k_slots),
            penc.encode_register_history(port_ops(h), k_slots=k_slots))


def assert_checkpoints_equal(want, got):
    """Death checkpoints bit for bit, through the port's frontier
    conversion."""
    assert got[3] == want[3]
    js, jm, jv = carry.frontier_from_numpy(*want[:3])
    ps, pm, pv = carry.frontier_from_numpy(*got[:3])
    assert torch.equal(js, ps) and torch.equal(jm, pm) \
        and torch.equal(jv, pv)
    for a, b in zip(want[:3], got[:3]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
