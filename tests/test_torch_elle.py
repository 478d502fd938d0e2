"""The port's elle path (ops/cycles.py, ops/cycles_tiled.py,
checkers/elle.py, the append/txnregister CLI) against the JAX package on
the same seeded inputs, on the CPU.

The JAX package's blocked accumulate runs as its Pallas kernel in
interpret mode; the port runs the plain version of its CUDA kernel (the
tensors lie on the CPU). Every comparison is exact equality: the grids
hold 0/1 and every sum is an integer below 2^24, so no summation order
changes a bit. Both packages' limits are pinned per test and restored
after it."""

from __future__ import annotations

import json
import random
from dataclasses import fields as dc_fields

import numpy as np
import pytest
import torch

from jepsen_etcd_demo_tpu.checkers.elle import ElleChecker as JElle
from jepsen_etcd_demo_tpu.checkers.elle import ElleRwChecker as JElleRw
from jepsen_etcd_demo_tpu.ops import cycles as jcycles
from jepsen_etcd_demo_tpu.ops import cycles_tiled as jtiled
from jepsen_etcd_demo_tpu.ops import limits as jlimits
from jepsen_etcd_demo_tpu.ops.op import Op as JOp
from jepsen_etcd_demo_tpu.utils import fuzz as jfuzz
from jepsen_etcd_demo_tpu_torch import carry, cli
from jepsen_etcd_demo_tpu_torch.checkers import (ElleChecker, ElleRwChecker,
                                                 TxnEncodeError)
from jepsen_etcd_demo_tpu_torch.checkers.elle import tarjan_has_cycle
from jepsen_etcd_demo_tpu_torch.ops import cycles
from jepsen_etcd_demo_tpu_torch.ops import cycles_tiled as tiled
from jepsen_etcd_demo_tpu_torch.ops import limits as plimits
from jepsen_etcd_demo_tpu_torch.ops.op import (Op, history_from_jsonl,
                                               history_to_jsonl)
from jepsen_etcd_demo_tpu_torch.utils import fuzz as pfuzz

import chip_smoke

CPU = torch.device("cpu")
ELLE_KNOBS = ("elle_mode", "elle_dense_max_nodes", "elle_tile",
              "elle_batch_floor", "elle_worklist_cap",
              "elle_density_threshold_pct", "elle_cell_budget",
              "stack_element_budget")
ROUTES = {"dense": {"elle_mode": 1}, "auto": {"elle_mode": 0},
          "tiled": {"elle_mode": 2},
          "tarjan": {"elle_mode": 0, "elle_cell_budget": 1 << 12}}


@pytest.fixture
def pin():
    """pin(**knobs): the same limits in both packages, restored after."""
    jprev = jlimits.set_limits(jlimits.KernelLimits())
    pprev = plimits.limits()

    def _pin(**knobs):
        jlimits.set_limits(jlimits.KernelLimits(**knobs))
        plimits.set_limits(plimits.KernelLimits(**knobs))

    yield _pin
    jlimits.set_limits(jprev)
    plimits.set_limits(pprev)


def rand_graph(rng, n: int, density: float) -> np.ndarray:
    adj = rng.random((n, n)) < density
    np.fill_diagonal(adj, False)
    return adj


def jax_ops(history):
    return [JOp(**vars(op)) for op in history]


def txn_history(*txns):
    """(completion type, [micro-ops]) per txn -> invoke/completion pairs,
    one process per txn, reads blanked on the invoke."""
    return pfuzz.append_txn_ops(list(txns))


def same_result(port: dict, jax: dict) -> bool:
    """Field for field, except `backend` (the port names its own)."""
    return ({k: v for k, v in port.items() if k != "backend"}
            == {k: v for k, v in jax.items() if k != "backend"})


def test_elle_limit_defaults_match():
    j, p = jlimits.KernelLimits(), plimits.KernelLimits()
    for f in ELLE_KNOBS:
        assert getattr(j, f) == getattr(p, f), f
    assert set(ELLE_KNOBS) <= {f.name for f in dc_fields(p)}


def test_append_generators_draw_like_the_jax_package():
    for seed in range(4):
        pt = pfuzz.gen_append_txns(random.Random(seed), n_txns=30,
                                   n_keys=3, max_len=3)
        jt = jfuzz.gen_append_txns(random.Random(seed), n_txns=30,
                                   n_keys=3, max_len=3)
        assert pt == jt
        assert (pfuzz.mutate_append_txns(random.Random(seed + 9), pt)
                == jfuzz.mutate_append_txns(random.Random(seed + 9), jt))
        ph, jh = pfuzz.append_txn_ops(pt), jfuzz.append_txn_ops(jt)
        assert [vars(o) for o in ph] == [vars(o) for o in jh]


# -- the accumulate: plain version vs the Pallas kernel (interpret) -----------

def _work(rng, nb: int, kind: str):
    """(sa, sb, dd) int32 numpy of one of the geometries: 'empty' (only
    padding entries), 'all' (every one of the nb^3 products, shuffled),
    'random' (an eligible subset plus padding)."""
    nbb = nb * nb
    ii, kk, jj = (x.ravel() for x in np.meshgrid(
        np.arange(nb), np.arange(nb), np.arange(nb), indexing="ij"))
    if kind == "empty":
        sel = np.zeros(0, np.intp)
    elif kind == "all":
        sel = rng.permutation(ii.size)
    else:
        sel = rng.choice(ii.size, size=ii.size // 3, replace=False)
    sa, sb, dd = ii[sel] * nb + kk[sel], kk[sel] * nb + jj[sel], \
        ii[sel] * nb + jj[sel]
    pad = np.full(5, nbb)
    return tuple(np.concatenate([x, pad]).astype(np.int32)
                 for x in (sa, sb, dd))


@pytest.mark.parametrize("T,nb", [(128, 3), (256, 2)])
@pytest.mark.parametrize("kind", ["empty", "all", "random"])
def test_tile_accumulate_matches_the_pallas_kernel(T, nb, kind):
    rng = np.random.default_rng(T + nb + len(kind))
    R = (rng.random((nb * nb, T, T)) < 0.02).astype(np.float32)
    R[1] = 0.0                                     # an empty tile
    sa, sb, dd = _work(rng, nb, kind)
    tiled.reset_launches()
    want = np.array(jtiled._pallas_accumulate(nb, T, sa.size, True)(
        R, sa, sb, dd))
    work = torch.from_numpy(np.stack([sa, sb, dd]))
    got = tiled.tile_accumulate(torch.from_numpy(R), work)
    assert torch.equal(got, torch.from_numpy(want))
    # The kernel's destination-major lists, summed as the kernel sums
    # them, give the same acc.
    Rt = torch.from_numpy(R)
    psa, psb, dst, off = tiled.destination_lists(work, nb * nb)
    csr = torch.zeros_like(got)
    for i, d in enumerate(dst.tolist()):
        for p in range(int(off[i]), int(off[i + 1])):
            csr[d] += Rt[psa[p]] @ Rt[psb[p]]
    assert torch.equal(csr, got)
    assert tiled.launches["tile_accumulate"] == 0


# -- the tiled closure --------------------------------------------------------

def _closure_pair(adj):
    Rj, cj, sj = jtiled.closure_tiled(adj, pallas=True, interpret=True)
    Rp, cp, sp = tiled.closure_tiled(adj, CPU)
    n = adj.shape[0]
    assert (cp == cj).all() and sp == sj
    assert torch.equal(carry.tiles_from_numpy(np.asarray(Rj), n), Rp)
    assert np.array_equal(carry.tiles_to_numpy(Rp), np.asarray(Rj))
    return sp


@pytest.mark.parametrize("n", [127, 128, 129, 255, 257])
def test_closure_tiled_matches_jax(pin, n):
    # Tiles of 128 and every round sparse below the work-list cap, so the
    # accumulate runs in every round.
    pin(elle_tile=128, elle_density_threshold_pct=100)
    adj = rand_graph(np.random.default_rng(n), n, 2.0 / n)
    adj[n - 1, 0] = adj[0, n // 2] = True
    stats = _closure_pair(adj)
    assert stats["rounds_sparse"] == stats["rounds"] > 0


def test_closure_tiled_blocky_graph_matches_jax(pin):
    n = 512
    adj = np.zeros((n, n), bool)
    for b0 in range(0, n, 128):
        for i in range(b0, b0 + 127):
            adj[i, i + 1] = True
    adj[127, 0] = True
    pin(elle_tile=128, elle_density_threshold_pct=90,
        elle_worklist_cap=8192)
    stats = _closure_pair(adj)
    assert stats["rounds_sparse"] > 0 and stats["nb"] == 4


def test_closure_tiled_worklist_overflow_matches_jax(pin):
    pin(elle_worklist_cap=64, elle_density_threshold_pct=1)
    stats = _closure_pair(rand_graph(np.random.default_rng(0x0F10), 200,
                                     0.02))
    assert stats["rounds_dense"] == stats["rounds"] > 0


def test_closure_rounds_runs_the_given_accumulate(pin):
    """The round loop calls the accumulate it is given (and nothing else)
    on its sparse rounds, and counts the rounds."""
    pin(elle_tile=128, elle_density_threshold_pct=60)
    adj = np.eye(300, k=1, dtype=bool)             # a chain: banded tiles
    calls = []

    def spy(R_flat, work):
        calls.append(work.shape[1])
        return tiled.tile_accumulate_reference(R_flat, work)

    cycles.reset_counts()
    R = tiled.grid_from_adj(adj, 128, CPU)
    kinds = [k for k, _R, _row in tiled.closure_rounds(R, spy)]
    assert kinds.count("sparse") == len(calls) > 0
    assert cycles.counts["tiled_rounds_sparse"] == len(calls)
    assert cycles.counts["tiled_rounds_dense"] == kinds.count("dense")


def test_carry_tiles_refuse_padding_and_bad_shapes():
    grid = np.zeros((2, 2, 128, 128), np.float32)
    grid[0, 1, 3, 4] = 1.0
    assert torch.equal(carry.tiles_from_numpy(grid, 200),
                       torch.from_numpy(grid))
    bad = grid.copy()
    bad[1, 1, 100, 0] = 1.0                        # row 228 of 200 nodes
    with pytest.raises(ValueError, match="padding"):
        carry.tiles_from_numpy(bad, 200)
    with pytest.raises(ValueError, match="does not fit"):
        carry.tiles_from_numpy(grid, 300)
    with pytest.raises(ValueError, match="0 and 1"):
        carry.tiles_from_numpy(grid * 2, 200)


# -- every cycles route -------------------------------------------------------

@pytest.mark.parametrize("route", sorted(ROUTES))
def test_cycles_functions_match_jax_on_every_route(pin, route):
    pin(elle_dense_max_nodes=128, elle_tile=128, **ROUTES[route])
    rng = np.random.default_rng(0xC7C)
    adjs = [rand_graph(rng, n, 2.5 / n) for n in (2, 3, 127, 129, 200)]
    big = np.zeros((300, 300), bool)               # two components
    for i in range(0, 149):
        big[i, i + 1] = True
    big[150:299, 151:300] = np.eye(149, dtype=bool)
    big[299, 150] = True
    adjs.append(big)
    cycles.reset_counts()
    for adj in adjs:
        assert (cycles.cycle_mask(adj, device=CPU)
                == jcycles.cycle_mask(adj)).all()
        reach_p, cyc_p = cycles.reach_and_cycles(adj, device=CPU)
        reach_j, cyc_j = jcycles.reach_and_cycles(adj)
        assert (reach_p == reach_j).all() and (cyc_p == cyc_j).all()
        assert cycles.has_cycle(adj, CPU) == tarjan_has_cycle(adj)
        pairs = [(int(a), int(b)) for a, b in rng.integers(
            0, adj.shape[0], size=(12, 2))]
        assert (cycles.reach_pairs(adj, pairs, CPU)
                == jcycles.reach_pairs(adj, pairs)).all()
    for p, j in zip(cycles.cycle_masks_batch(adjs, CPU),
                    jcycles.cycle_masks_batch(adjs)):
        assert (p == j).all()
    for (rp, cp), (rj, cj) in zip(cycles.reach_and_cycles_batch(adjs, CPU),
                                  jcycles.reach_and_cycles_batch(adjs)):
        assert (rp == rj).all() and (cp == cj).all()
    taken = {k for k, v in cycles.counts.items() if v and k[:6] == "graphs"}
    want = {"dense": {"graphs_dense", "graphs_batched"},
            "auto": {"graphs_dense", "graphs_batched", "graphs_tiled"},
            "tiled": {"graphs_tiled", "graphs_batched"},
            "tarjan": {"graphs_oracle"}}[route]
    assert taken == want, cycles.counts
    comps = cycles.weak_components(big)
    assert [c.tolist() for c in comps] == [
        c.tolist() for c in jcycles.weak_components(big)]


@pytest.mark.parametrize("floor,budget", [(1, 1 << 15), (8, 1 << 26)])
def test_batched_closure_buckets_match_jax(pin, floor, budget):
    """Size buckets at the 128 / 192 / 256 boundaries, batch buckets from
    elle_batch_floor, launches chunked under stack_element_budget (2^15
    cells: two 128-node graphs a launch)."""
    pin(elle_batch_floor=floor, stack_element_budget=budget)
    rng = np.random.default_rng(0xBA7C)
    adjs = [rand_graph(rng, n, 2.5 / n)
            for n in (2, 127, 128, 129, 191, 192, 193, 255, 256, 3, 40)]
    cycles.reset_counts()
    for p, j in zip(cycles.cycle_masks_batch(adjs, CPU),
                    jcycles.cycle_masks_batch(adjs)):
        assert (p == j).all()
    for (rp, cp), (rj, cj) in zip(cycles.reach_and_cycles_batch(adjs, CPU),
                                  jcycles.reach_and_cycles_batch(adjs)):
        assert (rp == rj).all() and (cp == cj).all()
    assert cycles.counts["graphs_batched"] == 2 * len(adjs)


def test_entry_points_resolve_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this pins the no-card path")
    adj = np.zeros((3, 3), bool)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cycles.cycle_mask(adj)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ElleChecker()


# -- the checkers -------------------------------------------------------------

APPEND_GOLDEN = {
    "serial": [("ok", [("append", "x", 1)]),
               ("ok", [("r", "x", (1,)), ("append", "x", 2)]),
               ("ok", [("r", "x", (1, 2))])],
    "g0": [("ok", [("append", "x", 1), ("append", "y", 1)]),
           ("ok", [("append", "x", 2), ("append", "y", 2)]),
           ("ok", [("r", "x", (1, 2)), ("r", "y", (2, 1))])],
    "g1a": [("fail", [("append", "x", 7)]), ("ok", [("r", "x", (7,))])],
    "info-observed": [("info", [("append", "x", 7)]),
                      ("ok", [("r", "x", (7,))])],
    "internal": [("ok", [("append", "x", 1), ("r", "x", (1,)),
                         ("append", "x", 2), ("r", "x", (1,))])],
    "internal-suffix": [("ok", [("append", "x", 9)]),
                        ("ok", [("append", "x", 1), ("r", "x", (9, 1))])],
    "g1b": [("ok", [("append", "x", 1), ("append", "x", 2)]),
            ("ok", [("r", "x", (1,))]), ("ok", [("r", "x", (1, 2))])],
    "incompatible": [("ok", [("append", "x", 1)]),
                     ("ok", [("append", "x", 2)]),
                     ("ok", [("r", "x", (1, 2))]),
                     ("ok", [("r", "x", (2, 1))])],
    "g1c": [("ok", [("append", "x", 1), ("r", "y", (1,))]),
            ("ok", [("r", "x", (1,)), ("append", "y", 1)])],
    "g-single": [("ok", [("append", "x", 1), ("append", "z", 1)]),
                 ("ok", [("r", "x", (1,)), ("r", "z", ())]),
                 ("ok", [("r", "z", (1,))])],
    "g2-item": [("ok", [("append", "x", 1), ("r", "y", ())]),
                ("ok", [("append", "y", 1), ("r", "x", ())]),
                ("ok", [("r", "x", (1,)), ("r", "y", (1,))])],
    "interlocking-wr": [
        ("ok", [("append", "x", 1), ("r", "w", (1,))]),
        ("ok", [("r", "x", (1,)), ("append", "y", 1), ("r", "z", (1,))]),
        ("ok", [("r", "y", (1,)), ("append", "z", 1), ("append", "w", 1)]),
        ("ok", [("r", "w", (1,)), ("append", "v", 1)])],
    "lost-append-mid": [("ok", [("append", "x", 1), ("append", "x", 2)]),
                        ("ok", [("r", "x", (2,))])],
    "lost-append-between": [("ok", [("append", "x", 1), ("append", "x", 2)]),
                            ("ok", [("append", "x", 3)]),
                            ("ok", [("r", "x", (1, 3))])],
    "duplicates": [("ok", [("append", "x", 1)]), ("ok", [("r", "x", (1, 1))])],
    "rt-stale-empty": [("ok", [("append", "x", 1)]), ("ok", [("r", "x", ())]),
                       ("ok", [("r", "x", (1,))])],
    "rt-unobserved": [("ok", [("append", "x", 1)]), ("ok", [("r", "x", ())])],
    "rt-future-read": [("ok", [("r", "x", (1,))]),
                       ("ok", [("append", "x", 1)])],
}

RW_GOLDEN = {
    "serial": [("ok", [("w", "x", 1)]), ("ok", [("r", "x", 1), ("w", "x", 2)]),
               ("ok", [("r", "x", 2)])],
    "nil-read": [("ok", [("r", "x", None)]), ("ok", [("w", "x", 1)]),
                 ("ok", [("r", "x", 1)])],
    "internal-write": [("ok", [("w", "x", 1), ("r", "x", 9)])],
    "internal-read": [("ok", [("w", "x", 1)]), ("ok", [("w", "x", 2)]),
                      ("ok", [("r", "x", 1), ("r", "x", 2)])],
    "read-read-agree": [("ok", [("w", "x", 1)]),
                        ("ok", [("r", "x", 1), ("r", "x", 1)])],
    "own-write": [("ok", [("w", "x", 1), ("r", "x", 1), ("w", "x", 2),
                          ("r", "x", 2)])],
    "g1a": [("fail", [("w", "x", 1)]), ("ok", [("r", "x", 1)])],
    "info-observed": [("info", [("w", "x", 1)]), ("ok", [("r", "x", 1)])],
    "garbage": [("ok", [("w", "x", 1)]), ("ok", [("r", "x", 42)])],
    "g1b": [("ok", [("w", "x", 1), ("w", "x", 2)]), ("ok", [("r", "x", 1)])],
    "cyclic-versions": [("ok", [("r", "x", 2), ("w", "x", 1)]),
                        ("ok", [("r", "x", 1), ("w", "x", 2)])],
    "g0": [("ok", [("r", "x", 1), ("w", "x", 2), ("w", "y", 1)]),
           ("ok", [("r", "y", 1), ("w", "y", 2), ("w", "x", 1)])],
    "g1c": [("ok", [("w", "x", 1), ("r", "y", 1), ("w", "y", 2)]),
            ("ok", [("r", "x", 1), ("w", "y", 1)])],
    "g-single": [("ok", [("r", "z", 5), ("r", "x", None), ("w", "y", 1)]),
                 ("ok", [("w", "z", 5), ("w", "x", 1)])],
    "g2-item": [("ok", [("r", "x", None), ("w", "y", 1)]),
                ("ok", [("r", "y", None), ("w", "x", 1)])],
    "fail-and-ok-share": [("fail", [("w", "x", 1)]), ("ok", [("w", "x", 1)]),
                          ("ok", [("r", "x", 1)])],
}


def rw_txns(rng: random.Random, n_txns: int, mutate: bool):
    """Serially executed rw-register txns over three keys (unique writes),
    one read changed to another key's value when `mutate`."""
    store: dict = {}
    counters: dict = {}
    txns = []
    for _ in range(n_txns):
        mops = []
        for _ in range(1 + rng.randrange(3)):
            k = f"k{rng.randrange(3)}"
            if rng.random() < 0.5:
                mops.append(("r", k, store.get(k)))
            else:
                counters[k] = counters.get(k, 0) + 1
                store[k] = counters[k]
                mops.append(("w", k, counters[k]))
        txns.append(("ok", mops))
    if mutate:
        reads = [(i, j) for i, (_t, mops) in enumerate(txns)
                 for j, m in enumerate(mops) if m[0] == "r"]
        i, j = reads[rng.randrange(len(reads))]
        _r, k, v = txns[i][1][j]
        txns[i][1][j] = ("r", k, None if v else 1)
    return txns


def _check_both(port_cls, jax_cls, histories, realtime):
    for h in histories:
        got = port_cls(realtime=realtime, device=CPU).check({}, h)
        want = jax_cls(realtime=realtime).check({}, jax_ops(h))
        assert same_result(got, want), (got, want)
        assert got["backend"] == "torch-closure-plain"


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("realtime", [False, True])
def test_elle_checker_golden_and_corpus_match_jax(pin, route, realtime):
    pin(**ROUTES[route])
    rng = random.Random(0xE11 + realtime)
    corpus = []
    for i in range(6):
        t = pfuzz.gen_append_txns(rng, n_txns=30, n_keys=4, max_len=3)
        corpus.append(pfuzz.mutate_append_txns(rng, t) if i % 2 else t)
    histories = [txn_history(*t) for t in APPEND_GOLDEN.values()]
    histories += [pfuzz.append_txn_ops(t) for t in corpus]
    cycles.reset_counts()
    _check_both(ElleChecker, JElle, histories, realtime)
    if route == "tarjan":
        assert cycles.counts["graphs_oracle"] > 0
        assert cycles.counts["graphs_dense"] == 0


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("realtime", [False, True])
def test_elle_rw_checker_golden_and_corpus_match_jax(pin, route, realtime):
    pin(**ROUTES[route])
    rng = random.Random(0x5E1B + realtime)
    histories = [txn_history(*t) for t in RW_GOLDEN.values()]
    histories += [txn_history(*rw_txns(rng, 25, i % 2 == 1))
                  for i in range(4)]
    _check_both(ElleRwChecker, JElleRw, histories, realtime)


def test_golden_anomaly_classes():
    """The classes the golden cases name, in the port itself."""
    check = ElleChecker(device=CPU)
    types = {name: check.check({}, txn_history(*t))["anomaly_types"]
             for name, t in APPEND_GOLDEN.items()}
    assert types["serial"] == [] and types["g1a"] == ["G1a"]
    assert types["g1c"] == ["G1c"] and types["g-single"] == ["G-single"]
    assert types["g2-item"] == ["G2-item"] and "G0" in types["g0"]
    rt = ElleChecker(realtime=True, device=CPU).check(
        {}, txn_history(*APPEND_GOLDEN["rt-unobserved"]))
    assert rt["anomaly_types"] == ["G-single-realtime"]
    assert rt["edge_counts"]["rt"] >= 1
    with pytest.raises(TxnEncodeError):
        check.check({}, [Op(type="invoke", f="read", value=None, process=0)])
    with pytest.raises(TxnEncodeError):
        ElleRwChecker(device=CPU).check({}, txn_history(
            ("ok", [("w", "x", 1)]), ("ok", [("w", "x", 1)])))


def test_stream_results_settle_a_valid_verdict():
    pre = {"valid": True, "streamed": True, "realtime": False, "txn_count": 0}
    h = txn_history(*APPEND_GOLDEN["g1a"])
    opts = {"stream_results": {"elle": pre}}
    assert ElleChecker(device=CPU).check({}, h, opts) is pre
    # Another strictness, or an invalid streamed verdict, re-checks.
    assert ElleChecker(realtime=True, device=CPU).check(
        {}, h, opts)["valid"] is False
    bad = {**pre, "valid": False}
    assert ElleChecker(device=CPU).check(
        {}, h, {"stream_results": {"elle": bad}})["anomaly_types"] == ["G1a"]


def test_pool_history_takes_the_tiled_route_and_matches_jax(pin):
    """chip_smoke.py's pool history at 600 txns, with the tile and the
    dense crossover shrunk so the auto route takes the tiled closure on
    the CPU, valid and mutated."""
    pin(elle_tile=128, elle_dense_max_nodes=128)
    txns = chip_smoke.pool_txns(600, 0xA11E)
    mutant = pfuzz.mutate_append_txns(random.Random(5), txns)
    for t, valid in ((txns, True), (mutant, False)):
        h = pfuzz.append_txn_ops(t)
        cycles.reset_counts()
        got = ElleChecker(device=CPU).check({}, h)
        assert got["valid"] is valid
        assert cycles.counts["graphs_tiled"] >= 1
        assert cycles.counts["tiled_rounds_sparse"] > 0
        assert same_result(got, JElle().check({}, jax_ops(h)))


def test_cycle_mutant_names_a_ww_cycle_on_every_route(pin):
    """chip_smoke.py's certified mutant of a 600-txn pool history: a G0
    or G1c cycle, one result under the tiled route, the host Tarjan
    route and the JAX package (all fields but backend), and its big
    component's cycle mask through the tiled closure equal to the host
    SCC's."""
    h, full = chip_smoke.cycle_mutant(chip_smoke.pool_txns(600, 0xC13),
                                      0xC14)
    tiled_knobs = {"elle_tile": 128, "elle_dense_max_nodes": 128}
    got = {}
    for route, knobs, counter in (("tiled", tiled_knobs, "graphs_tiled"),
                                  ("tarjan", ROUTES["tarjan"],
                                   "graphs_oracle")):
        pin(**knobs)
        cycles.reset_counts()
        got[route] = ElleChecker(device=CPU).check({}, h)
        assert cycles.counts[counter] > 0, (route, cycles.counts)
    assert {"G0", "G1c"} & set(got["tiled"]["anomaly_types"])
    assert got["tiled"] == got["tarjan"]
    assert same_result(got["tiled"], JElle().check({}, jax_ops(h)))
    pin(**tiled_knobs)
    sub = chip_smoke.largest_component(full)
    host = cycles._host_cycle_mask(sub)
    assert host.any()
    assert np.array_equal(cycles.cycle_mask(sub, device=CPU), host)


@pytest.mark.parametrize("realtime", [False, True])
def test_elle_check_timings_name_every_stage(pin, realtime):
    """check(timings=) gets the seconds of each stage, the full graph's
    probe split into its components and closures, and the result stays
    the one without it."""
    pin(elle_tile=128, elle_dense_max_nodes=128)
    txns = chip_smoke.pool_txns(300, 0xA11E)
    h = pfuzz.append_txn_ops(pfuzz.mutate_append_txns(random.Random(5),
                                                      txns))
    check = ElleChecker(realtime=realtime, device=CPU)
    timings: dict = {}
    assert check.check({}, h, timings=timings) == check.check({}, h)
    assert set(timings) == {"pair_infer_s", "edge_matrices_s",
                            "weak_components_s", "closure_s",
                            "classification_s"}
    assert all(v >= 0 for v in timings.values()), timings
    assert timings["weak_components_s"] > 0 and timings["closure_s"] > 0


def test_txn_history_survives_the_jsonl_round_trip():
    """Micro-ops come back from JSONL as lists (a two-op txn's value as a
    tuple of lists); reads still compare as tuples, and every verdict
    equals the one on the original records, as JSON."""
    rng = random.Random(0x7A)
    for i in range(6):
        t = pfuzz.gen_append_txns(rng, n_txns=30, n_keys=3, max_len=3)
        if i % 2:
            t = pfuzz.mutate_append_txns(rng, t)
        h = pfuzz.append_txn_ops(t)
        back = history_from_jsonl(history_to_jsonl(h))
        assert any(isinstance(op.value, tuple) for op in back)
        for cls in (ElleChecker, ElleRwChecker):
            if cls is ElleRwChecker:
                h = txn_history(*rw_txns(rng, 20, i % 2 == 1))
                back = history_from_jsonl(history_to_jsonl(h))
            a = cls(device=CPU).check({}, h)
            b = cls(device=CPU).check({}, back)
            assert json.loads(json.dumps(a)) == json.loads(json.dumps(b))


def _run_dir(tmp_path, name, history, test):
    d = tmp_path / name
    d.mkdir()
    (d / "history.jsonl").write_text(history_to_jsonl(history))
    if test is not None:
        (d / "test.json").write_text(json.dumps(test))
    return d


def test_cli_analyze_append_and_txnregister(tmp_path, capsys):
    ok = pfuzz.append_txn_ops(chip_smoke.pool_txns(80, 3))
    bad = txn_history(*APPEND_GOLDEN["g-single"])
    stale = txn_history(*APPEND_GOLDEN["rt-unobserved"])
    rw = txn_history(*RW_GOLDEN["g2-item"])
    cases = [("ok", ok, {"workload": "append"}, [], 0),
             ("bad", bad, {"workload": "append"}, [], 1),
             ("serial", stale, {"workload": "append"}, [], 0),
             ("strict", stale, {"workload": "append", "elle_realtime": True},
              [], 1),
             ("rw", rw, None, ["--workload", "txnregister"], 1),
             ("rw-as-append", rw, {"workload": "append"}, [], 0)]
    for name, h, test, flags, rc in cases:
        d = _run_dir(tmp_path, name, h, test)
        assert cli.main(["analyze", str(d), "--device", "cpu", *flags]) == rc
        out = json.loads(capsys.readouterr().out)
        assert out == {"valid": rc == 0}, (name, out)
        res = json.loads((d / "results.json").read_text())
        assert res["indep"]["elle"]["valid"] is (rc == 0), (name, res)
        assert res["indep"]["elle"]["backend"] == "torch-closure-plain"
    # A txn history read as the register workload is not checkable:
    # "unknown", exit 1.
    d = _run_dir(tmp_path, "reg", ok, {"workload": "register"})
    assert cli.main(["analyze", str(d), "--device", "cpu"]) == 1
    res = json.loads((d / "results.json").read_text())
    assert res["valid"] == "unknown" and "EncodeError" in res["error"]
    assert cli.main(["analyze", str(d), "--device", "cpu",
                     "--workload", "append"]) == 0
    capsys.readouterr()
