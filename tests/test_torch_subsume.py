"""Subsumption of the sort search's frontier over forever-pending ops
(jepsen_etcd_demo_tpu_torch/ops/subsume.py): the forever masks, the
verdicts with and without it (and the JAX package's), the batched tiers,
and the independent checker's split between the dense and sort routes."""

from __future__ import annotations

import random
from dataclasses import replace

import numpy as np
import pytest

from jepsen_etcd_demo_tpu.checkers import Linearizable as JLin
from jepsen_etcd_demo_tpu_torch.checkers import (IndependentChecker,
                                                 Linearizable)
from jepsen_etcd_demo_tpu_torch.ops import wgl2, wgl3, wgl3_kernels
from jepsen_etcd_demo_tpu_torch.ops.encode import encode_return_steps
from jepsen_etcd_demo_tpu_torch.ops.limits import limits, set_limits
from jepsen_etcd_demo_tpu_torch.ops.op import Op
from jepsen_etcd_demo_tpu_torch.ops.subsume import forever_masks
from jepsen_etcd_demo_tpu_torch.utils import fuzz as pfuzz

from torch_port_util import jax_ops


@pytest.fixture
def knobs():
    """knobs(**limits): the port's limits for one test, restored after."""
    prev = limits()

    def _set(**kw):
        set_limits(replace(prev, **kw))

    yield _set
    set_limits(prev)


def gen(kind: str, seed: int):
    """(model name, history) of a generated family history with many
    indeterminate ops, mutated on odd seeds."""
    rng = random.Random(seed)
    if kind == "cas-register":
        h = pfuzz.gen_register_history(rng, n_ops=40, n_procs=6,
                                       p_info=0.2)
        if seed % 2:
            h = pfuzz.mutate_history(random.Random(seed + 1), h)
    elif kind == "gset":
        h = pfuzz.gen_gset_history(rng, n_ops=40, p_info=0.2)
    elif kind == "multi-register":
        h = pfuzz.gen_multireg_history(rng, n_ops=40, p_info=0.15)
    else:
        h = pfuzz.gen_queue_history(rng, n_ops=20, p_info=0.3)
    if seed % 2 and kind != "cas-register" and kind != "fifo-queue":
        h = pfuzz.mutate_family_history(random.Random(seed + 1), h, kind)
    return kind, h


def partition_key(n_writes: int, dies: bool = False):
    """A key a partition leaves behind: n_writes indeterminate writes and
    cas ops over values 0-4 invoked at once, never returning, then reads
    that each need some of them fired (one read of 9 with `dies`)."""
    rng = random.Random(n_writes)
    h = []
    for p in range(n_writes):
        f = "write" if p % 2 else "cas"
        v = rng.randrange(5) if f == "write" else (rng.randrange(5),
                                                   rng.randrange(5))
        h.append(Op(type="invoke", f=f, value=v, process=p))
    for i, v in enumerate([1, 3, 0, 2, 4, 9 if dies else 1]):
        h += [Op(type="invoke", f="read", value=None, process=100 + i),
              Op(type="ok", f="read", value=v, process=100 + i)]
    for p in range(n_writes):
        h.append(Op(type="info", f=h[p].f, value=h[p].value, process=p))
    return h


def sort_check(name: str, h, **kw):
    lin = Linearizable(name, device="cpu")
    return wgl2.check_encoded_resumable(lin.encode(h), lin.model, f_cap=64,
                                        device="cpu", **kw)


@pytest.mark.parametrize("seed", range(4))
def test_forever_masks_are_the_slots_that_never_return(seed):
    """At each return step, the active slots that are no later step's
    target, by a direct count."""
    _name, h = gen("cas-register", seed)
    rs = encode_return_steps(Linearizable(device="cpu").encode(h))
    got = forever_masks(rs)
    n, K = rs.n_steps, rs.k_slots
    want = np.zeros((rs.slot_tabs.shape[0], (K + 31) // 32), np.int64)
    for t in range(n):
        for j in range(K):
            later = any(int(rs.targets[u]) == j for u in range(t, n))
            if rs.slot_active[t, j] and not later:
                want[t, j // 32] |= 1 << (j % 32)
    if not want.any():
        assert got is None
    else:
        assert np.array_equal(got, want)


@pytest.mark.parametrize("kind,seed", [
    (kind, seed) for kind in ("cas-register", "gset", "multi-register",
                              "fifo-queue") for seed in range(3)])
def test_subsumption_keeps_the_verdict(kind, seed, knobs):
    """The sort ladder with and without subsumption: the same valid and
    dead_step, a frontier no larger; and the JAX package's verdict."""
    name, h = gen(kind, seed)
    on = sort_check(name, h)
    knobs(subsume_mode=1)
    off = sort_check(name, h)
    assert (on["valid"], on["dead_step"]) == (off["valid"], off["dead_step"])
    assert on["max_frontier"] <= off["max_frontier"]
    want = JLin(name).check({}, jax_ops(h))
    assert want["valid"] is on["valid"]


def test_partitioned_key_fits_a_small_frontier(knobs):
    """Twelve indeterminate writes and cas ops: without subsumption the
    frontier outgrows a 1,024 capacity; with it the ladder decides at the
    first capacity, with the verdict of the search without it at a larger
    capacity, valid and (a read of 9) invalid."""
    for dies in (False, True):
        h = partition_key(12, dies)
        on = sort_check("cas-register", h, f_cap_max=1024)
        knobs(subsume_mode=1)
        with pytest.raises(MemoryError):
            sort_check("cas-register", h, f_cap_max=1024)
        off = sort_check("cas-register", h, f_cap_max=1 << 16)
        knobs()
        assert on["escalations"] == 0 and on["max_frontier"] <= 64
        assert (on["valid"], on["dead_step"]) == \
            (off["valid"], off["dead_step"]) == \
            ((False, 5) if dies else (True, -1))


def test_batched_tiers_keep_the_verdicts(knobs):
    """The batched sort tiers (canonicalised and subsumed) against the same
    tiers without subsumption: every history's verdict and dead_step."""
    hs = [gen("cas-register", s)[1] for s in range(6)]
    hs.append(partition_key(12))
    lin = Linearizable(device="cpu")
    encs = [lin.encode(h) for h in hs]

    def tiers():
        slots: list = [None] * len(encs)
        over, _long, _top = wgl3_kernels._batch_general(
            encs, list(range(len(encs))), lin.model, slots, set(),
            device="cpu")
        return slots, over

    on, over_on = tiers()
    knobs(subsume_mode=1)
    off, over_off = tiers()
    assert over_on == [] and set(over_off) <= {len(encs) - 1}
    for i, (a, b) in enumerate(zip(on, off)):
        if b is None:
            continue
        assert (a["valid"], a["dead_step"]) == (b["valid"], b["dead_step"])
        assert a["max_frontier"] <= b["max_frontier"], i


def test_independent_checker_splits_dense_and_sort_keys(knobs):
    """A key past the dense tables takes the batched sort tiers while the
    others stay on the dense route: each key's verdict is its own single
    check's."""
    knobs(dense_cell_budget=1 << 12)
    per_key = [pfuzz.gen_register_history(random.Random(s), n_ops=40,
                                          n_procs=3, p_info=0.0)
               for s in range(3)]
    per_key.append(partition_key(12))
    lin = Linearizable(device="cpu")
    encs = [lin.encode(h) for h in per_key]
    assert [wgl3.dense_config(lin.model, wgl3.tight_k_slots(e),
                              e.max_value) is None for e in encs] == \
        [False, False, False, True]
    got = IndependentChecker(lin).check({}, pfuzz.interleave_keyed(per_key))
    for k, h in enumerate(per_key):
        r = got["results"][str(k)]
        one = lin.check({}, h)
        assert (r["valid"], r["dead_step"]) == (one["valid"],
                                                one["dead_step"])
        if k < 3:
            assert r["backend"] == "torch-dense-plain-batched", r
            assert r["configs_explored"] is not None
        else:
            assert r["backend"] == "torch-cpu-batched", r
    assert got["valid"] is True
