"""The port's corpus scheduler (sched/) against the JAX package's
`sched.check_corpus` on the same seeded golden and fuzz corpora of mixed
lengths: bucket assignment, per-history fields, the launch accounting,
the general partition, alignment across buckets and launch-size chunks,
one read back after the last launch, the single-history delegation, the
padding of a bucket launch, the launch-shape counts behind
cache_hit_rate, and the independent-keys checker on top of it.

Both packages' limits are pinned per test (`pin`, subsumption off in the
port) and the JAX package sees one device (`one_device`). The tolerance
is exact equality on every compared field."""

from __future__ import annotations

import random

import pytest
import torch

from jepsen_etcd_demo_tpu import sched as jsched
from jepsen_etcd_demo_tpu.checkers import IndependentChecker as JInd
from jepsen_etcd_demo_tpu.checkers import Linearizable as JLin
from jepsen_etcd_demo_tpu.models import CASRegister as JM
from jepsen_etcd_demo_tpu.ops import encode as jenc
from jepsen_etcd_demo_tpu.sched import engine as jengine
from jepsen_etcd_demo_tpu.utils import fuzz as jfuzz
from jepsen_etcd_demo_tpu_torch import sched
from jepsen_etcd_demo_tpu_torch.checkers import (IndependentChecker,
                                                 Linearizable)
from jepsen_etcd_demo_tpu_torch.models import CASRegister as PM
from jepsen_etcd_demo_tpu_torch.ops import encode as penc
from jepsen_etcd_demo_tpu_torch.ops import wgl3 as pwgl3
from jepsen_etcd_demo_tpu_torch.ops import wgl3_kernels as wk
from jepsen_etcd_demo_tpu_torch.sched import engine

from golden import GOLDEN
from torch_port_util import one_device, pin, port_ops

__all__ = ["one_device", "pin"]

RESULT_FIELDS = ("valid", "survived", "dead_step", "max_frontier",
                 "configs_explored", "op_count", "overflow")
GENERAL_FIELDS = ("valid", "dead_step", "max_frontier", "op_count")
STATS = ("launches", "buckets", "steps_real", "steps_padded",
         "padding_waste")
CPU = "cpu"


def mixed_corpus(seed: int, n: int, lo: int = 8, hi: int = 150,
                 mutate_every: int = 3, scale: int = 1):
    """(JAX encodings, port encodings) of n generated histories of
    lo..hi ops, every `mutate_every`-th mutated, values times `scale`
    (211 puts them past the dense tables)."""
    rng = random.Random(seed)
    js, ps = [], []
    for i in range(n):
        h = jfuzz.gen_register_history(rng, n_ops=rng.randrange(lo, hi),
                                       n_procs=rng.randrange(2, 8),
                                       p_info=rng.choice([0.0, 0.02]))
        if mutate_every and i % mutate_every == 0:
            h = jfuzz.mutate_history(rng, h)
        if scale != 1:
            for op in h:
                if isinstance(op.value, int):
                    op.value *= scale
                elif isinstance(op.value, tuple):
                    op.value = tuple(v * scale for v in op.value)
        js.append(jenc.encode_register_history(h, k_slots=16))
        ps.append(penc.encode_register_history(port_ops(h), k_slots=16))
    return js, ps


def golden_corpus():
    jl, pl = JLin(model=JM()), Linearizable(PM(), device=CPU)
    return ([jl.encode(h) for _n, h, _v in GOLDEN],
            [pl.encode(port_ops(h)) for _n, h, _v in GOLDEN])


def both(js, ps, **kw):
    """(JAX check_corpus, port check_corpus) on the same corpus."""
    want = jsched.check_corpus(js, JM())
    got = sched.check_corpus(ps, PM(), device=CPU, **kw)
    return want, got


def assert_same_results(want, got, fields=RESULT_FIELDS):
    assert len(got) == len(want)
    for i, (w, g) in enumerate(zip(want, got)):
        for f in fields:
            assert g[f] == w[f], (i, f, g, w)


def stats_of(stats: dict) -> dict:
    return {f: (list(map(list, stats[f])) if f == "buckets" else stats[f])
            for f in STATS}


# -- buckets ----------------------------------------------------------------

COUNTS = [0, 1, 17, 31, 32, 33, 64, 65, 96, 97, 400, 4000, 17, 96]


@pytest.mark.parametrize("floor", [None, 8, 16, 64])
def test_step_buckets_equal_jax(pin, floor):
    pin(**({} if floor is None else {"step_bucket_floor": floor}))
    assert sched.assign_step_buckets(COUNTS) == \
        jsched.assign_step_buckets(COUNTS)
    assert sched.assign_step_buckets(list(reversed(COUNTS))) == \
        list(reversed(sched.assign_step_buckets(COUNTS)))


@pytest.mark.parametrize("floor", [None, 1, 4, 8, 32])
def test_batch_buckets_equal_jax(pin, floor):
    pin(**({} if floor is None else {"batch_bucket_floor": floor}))
    for cap in (1, 3, 7, 12, 64, 1 << 20):
        for n in range(1, 200):
            assert engine._batch_bucket(n, cap) == \
                jengine._batch_bucket(n, cap), (n, cap)


def test_pad_history_is_empty():
    rs = engine._pad_rs(12)
    want = jengine._pad_rs(12)
    assert (rs.n_steps, rs.n_ops, rs.k_slots, rs.max_pending) == \
        (want.n_steps, want.n_ops, want.k_slots, want.max_pending) \
        == (0, 0, 12, 0)
    assert rs.slot_tabs.shape == (0, 12, 4) and rs.targets.shape == (0,)


def test_foldable_stats_equal_jax():
    assert sched.FOLDABLE_STATS == jsched.engine.FOLDABLE_STATS
    total = {}
    for s in ({"launches": 2, "steps_real": 10, "steps_padded": 16},
              {"launches": 1, "steps_real": 5, "steps_padded": 8,
               "sweep_steps_dense": 3}):
        sched.fold_stats(total, s)
    assert total == jsched.fold_stats(
        jsched.fold_stats({}, {"launches": 2, "steps_real": 10,
                               "steps_padded": 16}),
        {"launches": 1, "steps_real": 5, "steps_padded": 8,
         "sweep_steps_dense": 3})


# -- check_corpus against the JAX package ------------------------------------

def test_golden_corpus_equals_jax(pin):
    js, ps = golden_corpus()
    (want, _wk, wstats), (got, kernel, stats) = both(js, ps)
    assert_same_results(want, got)
    for (_n, _h, valid), g in zip(GOLDEN, got):
        assert g["valid"] is valid
    assert stats_of(stats) == stats_of(wstats)
    assert kernel == "wgl3-dense-plain"


@pytest.mark.parametrize("seed", [0x5CED, 0x5CEF])
def test_fuzz_corpus_equals_jax_with_stats(pin, seed):
    js, ps = mixed_corpus(seed, 10, hi=80)
    (want, _wk, wstats), (got, _k, stats) = both(js, ps)
    assert_same_results(want, got)
    assert stats_of(stats) == stats_of(wstats)
    assert stats["launches"] >= 2, "mixed lengths must split buckets"
    assert sum(g["valid"] is False for g in got) >= 2, "corpus too tame"


def test_long_history_takes_the_long_route_and_stats_equal_jax(pin):
    """long_scan_max lowered in both packages so that one history of the
    corpus takes the long route; the bucketed rest, its fields and the
    launch accounting still equal the JAX package's."""
    pin(long_scan_max=96, dedup_mode=1)
    js, ps = mixed_corpus(0x10A6, 9, lo=20, hi=60, mutate_every=4)
    h = jfuzz.gen_register_history(random.Random(0x10A7), n_ops=240,
                                   n_procs=4, p_info=0.0)
    js.insert(4, jenc.encode_register_history(h, k_slots=16))
    ps.insert(4, penc.encode_register_history(port_ops(h), k_slots=16))
    (want, wkernel, wstats), (got, kernel, stats) = both(js, ps)
    assert_same_results(want, got)
    assert stats_of(stats) == stats_of(wstats)
    assert got[4]["kernel"] == "wgl3-dense-plain-chunked"
    assert kernel == "mixed" and wkernel == "mixed"


def test_general_partition_rides_the_sort_tiers(pin):
    """Huge values defeat the dense tables: every history takes the
    general path's batched sort tiers, as in the JAX package."""
    js, ps = mixed_corpus(0xB16, 6, lo=15, hi=50, mutate_every=2, scale=211)
    assert pwgl3.dense_config(PM(), pwgl3.tight_k_slots(ps[0]),
                              ps[0].max_value) is None
    (want, _wk, wstats), (got, kernel, stats) = both(js, ps)
    assert_same_results(want, got, GENERAL_FIELDS)
    assert kernel == "wgl2-sort-batched" and stats["launches"] == 0
    assert stats_of(stats) == stats_of(wstats)
    assert {g["valid"] for g in got} == {True, False}


def test_mixed_dense_and_general_corpus(pin):
    jd, pd = mixed_corpus(0xD0, 5, lo=10, hi=80)
    jg, pg = mixed_corpus(0x6E, 3, lo=10, hi=40, scale=211)
    js, ps = jd[:2] + jg + jd[2:], pd[:2] + pg + pd[2:]
    (want, _wk, wstats), (got, kernel, stats) = both(js, ps)
    assert_same_results([want[i] for i in (0, 1, 5, 6, 7)],
                        [got[i] for i in (0, 1, 5, 6, 7)])
    assert_same_results(want[2:5], got[2:5], GENERAL_FIELDS)
    assert stats_of(stats) == stats_of(wstats) and kernel == "mixed"


def test_shared_geometry_missing_sends_all_general(pin):
    """Each history fits a dense table alone but not under one shared
    geometry (the widest K with the largest S): all take the general
    path, as the JAX policy says."""
    narrow = jfuzz.gen_register_history(random.Random(1), n_ops=30,
                                        n_procs=3, value_range=28)
    wide = jfuzz.gen_register_history(random.Random(2), n_ops=60,
                                      n_procs=10, value_range=2)
    js = [jenc.encode_register_history(h, k_slots=16) for h in (narrow,
                                                                 wide)]
    ps = [penc.encode_register_history(port_ops(h), k_slots=16)
          for h in (narrow, wide)]
    alone = [pwgl3.dense_config(PM(), pwgl3.tight_k_slots(e), e.max_value)
             for e in ps]
    shared = pwgl3.dense_config(PM(), max(map(pwgl3.tight_k_slots, ps)),
                                max(e.max_value for e in ps))
    cells = [c.n_states * c.n_masks for c in alone]
    assert shared.n_states * shared.n_masks > max(cells)
    pin(dense_cell_budget=max(cells))
    (want, _wk, wstats), (got, kernel, stats) = both(js, ps)
    assert_same_results(want, got, GENERAL_FIELDS)
    assert stats["launches"] == wstats["launches"] == 0
    assert kernel == "wgl2-sort-batched"


def test_results_align_across_buckets_and_chunks(pin):
    """Short and long histories interleaved, with a launch-size cap of
    three histories of 32 steps (one of the longer buckets): results
    land at their input positions."""
    pin(stack_element_budget=3 * 32 * (6 * 5 + 1))
    rng = random.Random(0xA11)
    hs = [jfuzz.gen_register_history(rng, n_ops=10 if i % 2 else 120,
                                     n_procs=4, p_info=0.0)
          for i in range(13)]
    hs = [jfuzz.mutate_history(rng, h) if i % 5 == 0 else h
          for i, h in enumerate(hs)]
    js = [jenc.encode_register_history(h, k_slots=16) for h in hs]
    ps = [penc.encode_register_history(port_ops(h), k_slots=16) for h in hs]
    (want, _wk, wstats), (got, _k, stats) = both(js, ps)
    assert_same_results(want, got)
    assert stats_of(stats) == stats_of(wstats)
    assert len(stats["buckets"]) >= 2
    assert stats["launches"] > len(stats["buckets"]), "no chunked bucket"
    for e, g in zip(ps, got):
        assert g["op_count"] == e.n_ops


@pytest.mark.parametrize("budget", [None, 2000])
def test_every_bucket_launches_before_any_read_back(pin, monkeypatch,
                                                    budget):
    """No launch waits for an earlier one's result: every bucket is
    launched, then all rows are read back in one copy; with a launch-size
    budget of 2000 stacked elements, every chunk too."""
    if budget:
        pin(stack_element_budget=budget)
    js, ps = mixed_corpus(0xDE7, 14, lo=8, hi=200)
    events = []
    launch, unpack = engine.launch_bucket, pwgl3.unpack_np

    def recording_launch(*a, **kw):
        events.append("launch")
        return launch(*a, **kw)

    def recording_unpack(arr):
        events.append(("read", len(arr)))
        return unpack(arr)

    monkeypatch.setattr(engine, "launch_bucket", recording_launch)
    monkeypatch.setattr(pwgl3, "unpack_np", recording_unpack)
    (want, _wk, wstats), (got, _k, stats) = both(js, ps)
    assert_same_results(want, got)
    n = stats["launches"]
    assert n >= 3 and events == ["launch"] * n + [("read", len(ps))]
    if budget:
        assert n > len(stats["buckets"]), "no chunked bucket"


def test_single_history_delegates_to_the_auto_router(pin):
    _js, ps = mixed_corpus(0x51, 1, mutate_every=0)
    results, kernel, stats = sched.check_corpus(ps, PM(), device=CPU)
    want, want_kernel = wk.check_batch_encoded_auto(ps, PM(), CPU)
    assert results == want and kernel == want_kernel
    assert stats["launches"] == 0
    assert sched.check_corpus([], PM(), device=CPU)[:2] == ([], "none")


def test_no_card_means_no_fallback(pin):
    """device None is cuda: without a card check_corpus raises instead
    of running the plain versions."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _js, ps = mixed_corpus(0x5C, 3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sched.check_corpus(ps, PM())


# -- the bucket launch and its launch shapes ----------------------------------

def test_bucket_launch_with_all_pad_lanes(pin):
    """A launch of b = 13 lanes (not a multiple of 4): 10 histories and 3
    all-pad lanes at a step count a bucket above every real length.
    Each real lane equals its own unpadded sweep and each pad lane
    survives with no work."""
    _js, ps = mixed_corpus(0xBAD, 10, lo=20, hi=90, mutate_every=2)
    model = PM()
    k = max(pwgl3.tight_k_slots(e) for e in ps)
    cfg = pwgl3.dense_config(model, k, max(e.max_value for e in ps))
    steps = [penc.encode_return_steps(penc.reslot_events(e, k), CPU)
             for e in ps]
    r = pwgl3.step_bucket(2 * max(s.n_steps for s in steps) + 1)
    padded = steps + [engine._pad_rs(k)] * 3
    rows = engine.launch_bucket(model, cfg, padded, r, CPU)
    assert tuple(rows.shape) == (13, 5)
    for i, s in enumerate(steps):
        alone = engine.launch_bucket(model, cfg, [s], s.n_steps, CPU)
        assert torch.equal(rows[i], alone[0]), i
    assert rows[10:].tolist() == [[1, 0, -1, 1, 0]] * 3
    assert {bool(x) for x in rows[:10, 0]} == {True, False}


def test_stack_pads_as_padded_to_writes(pin):
    """stack_steps3 writes each lane as ReturnSteps.padded_to does (one
    owner of the padding: pad_into), all-pad lanes included, and refuses
    a history longer than the launch."""
    _js, ps = mixed_corpus(0x57A, 5, lo=20, hi=90)
    k = max(pwgl3.tight_k_slots(e) for e in ps)
    steps = [penc.encode_return_steps(penc.reslot_events(e, k), CPU)
             for e in ps] + [engine._pad_rs(k)] * 2
    r = pwgl3.step_bucket(max(s.n_steps for s in steps))
    tabs, act, tgt = pwgl3.stack_steps3(steps, r, CPU)
    for i, s in enumerate(steps):
        p = s.padded_to(r)
        assert (tabs[i].numpy() == p.slot_tabs).all(), i
        assert (act[i].numpy() == p.slot_active).all(), i
        assert (tgt[i].numpy() == p.targets).all(), i
    assert (tgt[-2:] == -1).all() and not act[-2:].any()
    assert not tabs[-2:].any()
    with pytest.raises(penc.EncodeError, match="cannot pad"):
        pwgl3.stack_steps3(steps, max(s.n_steps for s in steps) - 1, CPU)


def test_padded_to_writes_pads_past_the_real_rows():
    _js, ps = mixed_corpus(0x57B, 1, lo=20, hi=40, mutate_every=0)
    s = penc.encode_return_steps(ps[0], CPU)
    p = s.padded_to(s.n_steps + 5)
    assert p.n_steps == s.n_steps and p.targets.shape == (s.n_steps + 5,)
    assert (p.slot_tabs[:s.n_steps] == s.slot_tabs).all()
    assert (p.targets[s.n_steps:] == -1).all()
    assert not p.slot_active[s.n_steps:].any()
    assert not p.slot_tabs[s.n_steps:].any()
    with pytest.raises(penc.EncodeError, match="cannot pad"):
        s.padded_to(s.n_steps - 1)


def test_repeated_launch_shapes_count_as_hits(pin, monkeypatch):
    """A shape (kernel, model, K, S, b, r) launched before counts as a
    hit: a second pass over the same corpus hits on every launch."""
    monkeypatch.setattr(engine, "_seen_shapes", set())
    monkeypatch.setattr(engine, "shape_counts", {"hits": 0, "misses": 0})
    assert sched.shape_hit_rate() == 0.0
    _js, ps = mixed_corpus(0xCAC, 10, mutate_every=0)
    first = sched.check_corpus(ps, PM(), device=CPU)
    n = first[2]["launches"]
    distinct = len(first[2]["buckets"])
    assert engine.shape_counts == {"hits": n - distinct, "misses": distinct}
    second = sched.check_corpus(ps, PM(), device=CPU)
    assert second == first
    assert engine.shape_counts == {"hits": 2 * n - distinct,
                                   "misses": distinct}
    assert sched.shape_hit_rate() == (2 * n - distinct) / (2 * n)


# -- independent keys through the scheduler ----------------------------------

def keyed_history(seed: int, n_keys: int, long_key: int | None = None):
    """(JAX ops, port ops) of n_keys keys of 15-40 ops, key `long_key`
    with 160, as one (key, value) history."""
    rng = random.Random(seed)
    out = []
    for k in range(n_keys):
        h = jfuzz.gen_register_history(
            rng, n_ops=160 if k == long_key else rng.randrange(15, 40),
            n_procs=4, p_info=0.02)
        if k % 3 == 1:
            h = jfuzz.mutate_history(rng, h)
        for op in h:
            op.value = (k, op.value)
            op.process = (k, op.process)
        out.extend(h)
    return out, port_ops(out)


@pytest.mark.parametrize("long_key", [None, 2])
def test_independent_keys_equal_before_and_after_the_switch(pin, long_key):
    """Every key's fields through the scheduler equal what the batched
    router gave before the switch, and the JAX checker's."""
    hj, hp = keyed_history(0x1D0 + (long_key or 0), 5, long_key)
    got = IndependentChecker(Linearizable(device=CPU)).check({}, hp)
    want = JInd(JLin()).check({}, hj)
    lin = Linearizable(device=CPU)
    from jepsen_etcd_demo_tpu_torch.checkers import split_by_key

    keyed = split_by_key(hp)
    keys = sorted(keyed, key=str)
    before, _k = wk.check_batch_encoded_auto(
        [lin.encode(keyed[k]) for k in keys], PM(), CPU)
    assert got["valid"] == want["valid"] is False
    for k, b in zip(keys, before):
        g, w = got["results"][str(k)], want["results"][str(k)]
        for f in ("valid", "dead_step", "max_frontier", "configs_explored",
                  "op_count"):
            assert g.get(f) == w.get(f), (k, f)
        if g["valid"] is True:
            assert g["backend"] == "torch-dense-plain-batched"
            for f in ("dead_step", "max_frontier", "configs_explored"):
                assert g[f] == b[f], (k, f)
