"""The port's host encoder, generators and op records against the JAX
package's: identical histories for identical seeds, identical arrays."""

from __future__ import annotations

import random

import numpy as np
import pytest

from jepsen_etcd_demo_tpu.ops import encode as jenc
from jepsen_etcd_demo_tpu.ops import op as jop
from jepsen_etcd_demo_tpu.ops import wgl3 as jwgl3
from jepsen_etcd_demo_tpu.utils import fuzz as jfuzz
from jepsen_etcd_demo_tpu_torch import carry
from jepsen_etcd_demo_tpu_torch.ops import encode as penc
from jepsen_etcd_demo_tpu_torch.ops import op as pop
from jepsen_etcd_demo_tpu_torch.ops import wgl3 as pwgl3
from jepsen_etcd_demo_tpu_torch.utils import fuzz as pfuzz

from golden import GOLDEN
from torch_port_util import fuzz_pair, port_ops

SEEDS = range(8)


def _same_encoding(a, b):
    np.testing.assert_array_equal(a.events, b.events)
    assert (a.n_events, a.n_ops, a.k_slots, a.max_pending, a.max_value) == \
        (b.n_events, b.n_ops, b.k_slots, b.max_pending, b.max_value)


def _same_steps(a, b):
    np.testing.assert_array_equal(a.slot_tabs, b.slot_tabs)
    np.testing.assert_array_equal(a.slot_active, b.slot_active)
    np.testing.assert_array_equal(a.targets, b.targets)
    assert (a.n_steps, a.n_ops, a.k_slots, a.max_pending, a.max_value) == \
        (b.n_steps, b.n_ops, b.k_slots, b.max_pending, b.max_value)


@pytest.mark.parametrize("name,hist,_expected", GOLDEN,
                         ids=[g[0] for g in GOLDEN])
def test_golden_encoding_matches(name, hist, _expected):
    je = jenc.encode_register_history(hist, k_slots=16)
    pe = penc.encode_register_history(port_ops(hist), k_slots=16)
    _same_encoding(je, pe)
    _same_steps(jenc.encode_return_steps(je), penc.encode_return_steps(pe))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("mutate", [False, True])
def test_fuzz_histories_and_encodings_match(seed, mutate):
    hj, hp = fuzz_pair(seed, n_ops=60, n_procs=7, p_info=0.05,
                       mutate=mutate)
    assert [o.to_json() for o in hj] == [o.to_json() for o in hp]
    je = jenc.encode_register_history(hj, k_slots=32)
    pe = penc.encode_register_history(hp, k_slots=32)
    _same_encoding(je, pe)
    k = jwgl3.tight_k_slots(je)
    assert pwgl3.tight_k_slots(pe) == k
    jr, pr = jenc.reslot_events(je, k), penc.reslot_events(pe, k)
    _same_encoding(jr, pr)
    js, ps = jenc.encode_return_steps(jr), penc.encode_return_steps(pr)
    _same_steps(js, ps)
    r_cap = jwgl3.step_bucket(js.n_steps)
    assert pwgl3.step_bucket(ps.n_steps) == r_cap
    _same_steps(js.padded_to(r_cap), ps.padded_to(r_cap))


def test_interleave_keyed_matches():
    per_key_j = [jfuzz.gen_register_history(random.Random(s), n_ops=20)
                 for s in range(3)]
    per_key_p = [pfuzz.gen_register_history(random.Random(s), n_ops=20)
                 for s in range(3)]
    a = jfuzz.interleave_keyed(per_key_j)
    b = pfuzz.interleave_keyed(per_key_p)
    assert [o.to_json() for o in a] == [o.to_json() for o in b]


def test_jsonl_round_trip_is_byte_compatible():
    hj, hp = fuzz_pair(3, n_ops=30)
    text = jop.history_to_jsonl(hj)
    assert pop.history_to_jsonl(hp) == text
    back = pop.history_from_jsonl(text)
    assert [o.to_json() for o in back] == \
        [o.to_json() for o in jop.history_from_jsonl(text)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_carry_encoded_from_numpy(seed):
    hj, hp = fuzz_pair(seed, n_ops=50)
    je = jenc.encode_register_history(hj, k_slots=24)
    got = carry.encoded_from_numpy(je.to_arrays())
    _same_encoding(je, got)
    _same_encoding(got, penc.encode_register_history(hp, k_slots=24))


def test_slot_overflow_and_errors_match():
    hj, hp = fuzz_pair(5, n_ops=40, n_procs=8, p_info=0.0)
    with pytest.raises(jenc.SlotOverflow):
        jenc.encode_register_history(hj, k_slots=2)
    with pytest.raises(penc.SlotOverflow):
        penc.encode_register_history(hp, k_slots=2)
    bad = [pop.Op(type="ok", f="read", value=1, process=0)]
    with pytest.raises(penc.EncodeError):
        penc.encode_register_history(bad)
    neg = [pop.Op(type="invoke", f="write", value=-3, process=0)]
    with pytest.raises(penc.EncodeError):
        penc.encode_register_history(neg)


def test_packing_constants_and_geometry_match():
    assert pwgl3._LO_MASK == tuple(int(x) for x in jwgl3._LO_MASK)
    assert pwgl3.PACKED_FIELDS == jwgl3.PACKED_FIELDS
    from jepsen_etcd_demo_tpu.models import CASRegister as JM
    from jepsen_etcd_demo_tpu_torch.models import CASRegister as PM

    for k in range(3, 22):
        for mv in (0, 4, 9, 30, 40):
            a = jwgl3.dense_config(JM(), k, mv)
            b = pwgl3.dense_config(PM(), k, mv)
            assert (a is None) == (b is None), (k, mv)
            if a is not None:
                assert (a.k_slots, a.n_states, a.state_offset) == \
                    (b.k_slots, b.n_states, b.state_offset)
    for n in (0, 1, 31, 32, 33, 48, 49, 100, 5000, 40000):
        assert pwgl3.step_bucket(n) == jwgl3.step_bucket(n)
    for p in range(0, 30):
        assert pwgl3.tight_k_for_pending(p) == jwgl3.tight_k_for_pending(p)


def test_limits_defaults_match():
    from jepsen_etcd_demo_tpu.ops.limits import KernelLimits as JL
    from jepsen_etcd_demo_tpu_torch.ops.limits import KernelLimits as PL

    j, p = JL(), PL()
    for f in ("dense_cell_budget", "long_scan_max", "step_bucket_floor"):
        assert getattr(j, f) == getattr(p, f), f
