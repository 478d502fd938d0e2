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


# -- the device encoder (ops/encode_device.py), on CPU tensors ---------------
#
# The cases of tests/test_pod_scaling.py: golden, fuzz, padded tail,
# streaming prefix, empty history and encode_mode=2 routing. Each holds
# the port's device expansion against its own host expansion and against
# the JAX package's device encoder, exactly.

from dataclasses import replace  # noqa: E402

from jepsen_etcd_demo_tpu.ops import encode_device as jed  # noqa: E402
from jepsen_etcd_demo_tpu.ops import limits as jlimits  # noqa: E402
from jepsen_etcd_demo_tpu_torch.ops import encode_device as ped  # noqa: E402
from jepsen_etcd_demo_tpu_torch.ops import limits as plimits  # noqa: E402


def _jax_device_steps(je):
    """The JAX package's device encode of a JAX encoding."""
    return jed.encode_return_steps_device(je)


def _device_matches(pe, je=None):
    """The port's device expansion of `pe` equals its host expansion and,
    given the JAX encoding `je`, the JAX package's device encoder."""
    host = penc._encode_return_steps_host(pe)
    dev = ped.encode_return_steps_device(pe, "cpu")
    _same_steps(dev, host)
    if je is not None:
        _same_steps(dev, _jax_device_steps(je))
    return dev


def test_device_encoder_golden():
    """A crashed cas (invoked, never completed) keeps its slot active in
    every later step, its row pinned to the invoke's fields."""
    h = [jop.Op(type="invoke", f="write", value=3, process=0, index=0),
         jop.Op(type="invoke", f="read", value=None, process=1, index=1),
         jop.Op(type="ok", f="write", value=3, process=0, index=2),
         jop.Op(type="invoke", f="cas", value=(3, 4), process=2, index=3),
         jop.Op(type="ok", f="read", value=3, process=1, index=4),
         jop.Op(type="invoke", f="read", value=None, process=0, index=5),
         jop.Op(type="ok", f="read", value=4, process=0, index=6)]
    je = jenc.encode_register_history(h, k_slots=8)
    dev = _device_matches(penc.encode_register_history(port_ops(h),
                                                       k_slots=8), je)
    assert dev.n_steps == 3
    assert dev.slot_active[-1].sum() == 2 and dev.targets[-1] != -1


@pytest.mark.parametrize("chunk", range(4))
def test_device_encoder_fuzz(chunk):
    """Seeded fuzz histories (mutants, indeterminate ops, slot reuse) and
    the golden ones, 5 of each a case."""
    rng = random.Random(0x17E + chunk)
    for i in range(5):
        n_ops, n_procs = rng.randrange(5, 80), rng.randrange(2, 7)
        seed = rng.randrange(1 << 30)
        hj = jfuzz.gen_register_history(random.Random(seed), n_ops=n_ops,
                                        n_procs=n_procs)
        if i % 3 == 0:
            hj = jfuzz.mutate_history(random.Random(seed + 1), hj)
        _device_matches(penc.encode_register_history(port_ops(hj),
                                                     k_slots=32),
                        jenc.encode_register_history(hj, k_slots=32))
    for _name, hist, _exp in GOLDEN[chunk::4]:
        _device_matches(penc.encode_register_history(port_ops(hist),
                                                     k_slots=16),
                        jenc.encode_register_history(hist, k_slots=16))


def test_device_encoder_padded_tail():
    """Rows past n_steps on the padded step axis are padded_to's pads
    (tabs 0, active False, targets -1), as the JAX encoder's are."""
    import torch

    hj, hp = fuzz_pair(3, n_ops=20)
    pe = penc.encode_register_history(hp, k_slots=16)
    host = penc._encode_return_steps_host(pe)
    r_cap = pwgl3.step_bucket(host.n_steps + 9)
    e_cap = ped.event_bucket(pe.n_events)
    assert e_cap == jed.event_bucket(pe.n_events)
    ev = torch.from_numpy(pe.padded_to(e_cap).events)
    tabs, act, tgt = (x.numpy() for x in ped.expand(ev, pe.k_slots, r_cap))
    want = host.padded_to(r_cap)
    np.testing.assert_array_equal(tabs, want.slot_tabs)
    np.testing.assert_array_equal(act, want.slot_active)
    np.testing.assert_array_equal(tgt, want.targets)
    je = jenc.encode_register_history(hj, k_slots=16)
    fn = jed.cached_device_encoder(je.k_slots, e_cap, r_cap)
    jt = [np.asarray(x) for x in fn(jed.stack_events([je], e_cap)[0])]
    for a, b in zip((tabs, act, tgt), jt):
        np.testing.assert_array_equal(a, b)


def test_device_encoder_streaming_prefix():
    """The JAX package's IncrementalEncoder's stable prefixes (LIFO slot
    reuse, the watermark rule) mid-stream and after finalize."""
    from jepsen_etcd_demo_tpu.models import CASRegister as JM

    h = jfuzz.gen_register_history(random.Random(0x5F1), n_ops=60,
                                   n_procs=6, p_info=0.15)
    inc = jenc.IncrementalEncoder(JM())
    checked = 0
    for i, op in enumerate(h):
        inc.append(op)
        if i % 17 == 0 and inc.rows:
            je = inc.encoded_history(k_slots=16)
            _device_matches(carry.encoded_from_numpy(je.to_arrays()), je)
            checked += 1
    inc.finalize()
    je = inc.encoded_history(k_slots=16)
    _device_matches(carry.encoded_from_numpy(je.to_arrays()), je)
    assert checked > 0


def test_device_encoder_empty_history():
    pe = penc.encode_register_history([], k_slots=4)
    assert not ped.device_encode_feasible(pe)
    assert ped.returns_count(pe) == 0
    dev = ped.encode_return_steps_device(pe, "cpu")
    assert dev.n_steps == 0 and dev.slot_tabs.shape == (0, 4, 4)
    je = jenc.encode_register_history([], k_slots=4)
    assert not jed.device_encode_feasible(je)


@pytest.mark.parametrize("family", ["gset", "fifo-queue", "multi-register"])
def test_device_encoder_family_histories(family):
    from jepsen_etcd_demo_tpu import models as jmodels

    from torch_port_util import port_model

    gen = {"gset": lambda fz, r: fz.gen_gset_history(r, n_ops=60),
           "fifo-queue": lambda fz, r: fz.gen_queue_history(r, n_ops=20),
           "multi-register": lambda fz, r: fz.gen_multireg_history(
               r, n_ops=50)}[family]
    jm = jmodels.REGISTRY[family]()
    hj = gen(jfuzz, random.Random(5))
    hp = gen(pfuzz, random.Random(5))
    _device_matches(penc.encode_history(hp, port_model(jm), k_slots=16),
                    jenc.encode_history(hj, jm, k_slots=16))


def test_encode_mode_routes_and_defaults_to_host(monkeypatch):
    """encode_mode defaults to the host (0, as in the JAX package); 2
    routes encode_return_steps through the device expansion on the given
    device, with the same rows, and an infeasible history to the host;
    without a card, mode 2 on the default device raises rather than run
    on the host."""
    import torch

    assert plimits.KernelLimits().encode_mode == \
        jlimits.KernelLimits().encode_mode == 0
    _hj, hp = fuzz_pair(11, n_ops=40)
    pe = penc.encode_register_history(hp, k_slots=16)
    host = penc.encode_return_steps(pe)
    calls = []
    real = ped.encode_return_steps_device
    monkeypatch.setattr(ped, "encode_return_steps_device",
                        lambda enc, device=None: calls.append(device)
                        or real(enc, device))
    prev = plimits.set_limits(replace(plimits.limits(), encode_mode=2))
    try:
        _same_steps(penc.encode_return_steps(pe, "cpu"), host)
        assert calls == ["cpu"]
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                penc.encode_return_steps(pe)
        plimits.set_limits(replace(plimits.limits(), encode_mode=2,
                                   stack_element_budget=16))
        assert not ped.device_encode_feasible(pe)
        _same_steps(penc.encode_return_steps(pe), host)
        assert len(calls) == 1 + (not torch.cuda.is_available())
    finally:
        plimits.set_limits(prev)
