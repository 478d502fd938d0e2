"""The general path's sort search (ops/wgl2.py) and its frontier
canonicalisation (ops/canon.py) against the JAX package on the same
seeded histories, under both packages' same limits: the network of
compare-exchanges, the resumable search's fields and its death
checkpoint's frontier bit for bit, packed and unpacked keys, one and two
mask words, with and without canonicalisation. The JAX package runs as
its own tests run it on the CPU, on one device (fixture one_device).
The tolerance is exact equality.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from jepsen_etcd_demo_tpu.models import CASRegister as JM
from jepsen_etcd_demo_tpu.ops import canon as jcanon
from jepsen_etcd_demo_tpu.ops import encode as jenc
from jepsen_etcd_demo_tpu.ops import wgl2 as jwgl2
from jepsen_etcd_demo_tpu_torch import carry
from jepsen_etcd_demo_tpu_torch.models import CASRegister as PM
from jepsen_etcd_demo_tpu_torch.ops import canon as pcanon
from jepsen_etcd_demo_tpu_torch.ops import encode as penc
from jepsen_etcd_demo_tpu_torch.ops import wgl2 as pwgl2

from torch_port_util import (GENERAL, assert_checkpoints_equal, encodings,
                             history, one_device, pin)

JMODEL, PMODEL = JM(), PM()
SORT = ("valid", "survived", "dead_step", "max_frontier", "f_cap",
        "escalations")
__all__ = ["one_device", "pin"]


# -- canonicalisation ----------------------------------------------------------

CANON_CASES = [(s, 60, 5, 0.15) for s in range(3)] + [(3, 150, 3, 0.4)]


@pytest.mark.parametrize("case", CANON_CASES)
def test_canon_pairs_match_jax(pin, case):
    seed, n_ops, n_procs, p_info = case
    je, pe = encodings(history(seed, n_ops, n_procs, p_info, value_range=2))
    k = jwgl2.sort_k_slots(je)
    jrs = jenc.encode_return_steps(jenc.reslot_events(je, k))
    prs = penc.encode_return_steps(penc.reslot_events(pe, k))
    want, got = jcanon.canon_pairs(jrs), pcanon.canon_pairs(prs)
    assert (want is None) == (got is None)
    if want is not None:
        np.testing.assert_array_equal(got, want)
    for mode in (0, 1, 2):
        pin(dedup_mode=mode)
        for table in (False, True):
            w = jcanon.history_canon_pairs(jrs, table=table)
            g = pcanon.history_canon_pairs(prs, table=table)
            assert (w is None) == (g is None), (mode, table)
    assert pcanon.pair_capacity(5) == jcanon.pair_capacity(5) == 8
    assert pcanon._selection_network([1, 4, 6]) \
        == jcanon._selection_network([1, 4, 6])


@pytest.mark.parametrize("words", [1, 2])
def test_canon_rewrite_matches_the_jax_network(words):
    """One step's network on random keys and mask rows: the port's
    class-count rewrite equals the JAX package's compare-exchanges."""
    import jax.numpy as jnp

    rng = np.random.default_rng(7 + words)
    K = 40 if words == 2 else 20
    # Three classes, one of them crossing the word boundary when K > 32.
    classes = [[0, 3, 7, 9], [2, 5], [11, 30, 33, 38] if words == 2
               else [11, 14, 19]]
    pairs = [p for c in classes for p in pcanon._selection_network(c)]
    P = pcanon.pair_capacity(len(pairs))
    row = np.full((P, 2), -1, np.int32)
    row[:len(pairs)] = pairs
    cls = pcanon.pair_classes(row, K, "cpu")
    _, _, slot_bitmask = jwgl2._slot_constants(jwgl2.WGLConfig(K, 4))
    masks = rng.integers(0, 2**32, size=(300, words), dtype=np.uint64)
    masks[:, -1] &= (1 << (K - 32 * (words - 1))) - 1
    want = np.asarray(jcanon.canon_masks_words(
        jnp.asarray(masks.astype(np.uint32)), jnp.asarray(row),
        slot_bitmask))
    got = pcanon.canon_masks_words(torch.from_numpy(masks.astype(np.int64)),
                                   cls)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    if words == 1:
        sbits = 8
        keys = (rng.integers(0, 1 << sbits, 300)
                | (masks[:, 0].astype(np.int64) << sbits)) & 0x7FFFFFFF
        keys[::7] = 0xFFFFFFFF
        want = np.asarray(jcanon.canon_keys_packed(
            jnp.asarray(keys.astype(np.uint32)), jnp.asarray(row), sbits,
            jwgl2.PACKED_INVALID))
        got = pcanon.canon_keys_packed(torch.from_numpy(keys), cls, sbits,
                                       pwgl2.PACKED_INVALID)
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


# -- the resumable sort search ----------------------------------------------

# (seed, n_ops, n_procs, p_info, value_range, big, stuck): packed keys
# with symmetric info writes; unpacked keys (a final write of 100,000
# needs 17 state bits); two mask words (30 stuck cas ops, K = 36).
SEARCH_CASES = {
    "packed": (0, 60, 5, 0.15, 3, None, 0),
    "unpacked": (1, 60, 5, 0.03, 3, 100_000, 10),
    "two-words": (0, 60, 4, 0.03, 3, None, 30),
}
SEARCH_RUNS = [(case, mutant, mode) for case in sorted(SEARCH_CASES)
               for mutant in (False, True) for mode in (0, 1)]


@pytest.mark.parametrize("case,mutant,dedup_mode", SEARCH_RUNS)
def test_check_steps_resumable_matches_jax(pin, case, mutant, dedup_mode):
    seed, n_ops, n_procs, p_info, vr, big, stuck = SEARCH_CASES[case]
    pin(dedup_mode=dedup_mode)
    h = history(seed, n_ops, n_procs, p_info, value_range=vr,
                mutate=seed + 7 if mutant else None, big=big, stuck=stuck)
    je, pe = encodings(h)
    k = jwgl2.sort_k_slots(je)
    packed = jwgl2.packable(JMODEL, jwgl2.make_config(JMODEL, k, 4,
                                                      je.max_value))
    assert packed == case.startswith("packed")
    assert (k > 32) == (case == "two-words")
    want = jwgl2.check_encoded_resumable(je, JMODEL, f_cap=4,
                                         keep_death_checkpoint=True)
    got = pwgl2.check_encoded_resumable(pe, PMODEL, f_cap=4,
                                        keep_death_checkpoint=True,
                                        device="cpu")
    for f in SORT:
        assert got[f] == want[f], (f, got, want)
    assert got["escalations"] > 0
    assert ("death_checkpoint" in got) == ("death_checkpoint" in want)
    if "death_checkpoint" in want:
        assert_checkpoints_equal(want["death_checkpoint"],
                                 got["death_checkpoint"])


def test_frontier_round_trip():
    rng = np.random.default_rng(3)
    states = rng.integers(-1, 5, 16).astype(np.int32)
    masks = rng.integers(0, 2**32, (16, 2), dtype=np.uint64).astype(np.uint32)
    valid = rng.random(16) < 0.5
    s, m, v = carry.frontier_from_numpy(states, masks, valid)
    assert s.dtype == torch.int32 and m.dtype == torch.int64
    assert int(m.max()) == int(masks.max())
    for a, b in zip(carry.frontier_to_numpy(s, m, v), (states, masks, valid)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(ValueError):
        carry.frontier_from_numpy(states, masks[:3], valid)


def test_sort_stats_count_the_steps(pin):
    pin(**GENERAL)
    _je, pe = encodings(history(0, 80, 6, 0.05))
    pwgl2.reset_stats()
    out = pwgl2.check_encoded_resumable(pe, PMODEL, f_cap=4, device="cpu")
    assert set(pwgl2.stats) == {4 * 4**i for i in
                                range(out["escalations"] + 1)}
    assert sum(n for n, _s in pwgl2.stats.values()) >= out["n_steps"]
