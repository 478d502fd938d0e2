"""The port's five non-register models (mutex, gset, both queues,
multi-register) against the JAX package's: the torch step on the CPU
equals the JAX step and step_py over an exhaustive grid of (state, f,
a1, a2, rv) at a small geometry; the geometry (state_bound, pack_bits),
the op-language codec and the op descriptions are equal; both packages
reject the same histories. Tolerance: exact, every field is an integer
or a boolean."""

from __future__ import annotations

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepsen_etcd_demo_tpu import models as jmodels
from jepsen_etcd_demo_tpu.ops import encode as jenc
from jepsen_etcd_demo_tpu.ops.op import Op as JOp
from jepsen_etcd_demo_tpu_torch import models as pmodels
from jepsen_etcd_demo_tpu_torch.ops import encode as penc
from jepsen_etcd_demo_tpu_torch.ops.op import Op as POp

from torch_port_util import port_model

NIL = penc.NIL
BITS5 = [1 << i for i in range(5)]

# name -> (constructor arguments, states, ops (f, a1, a2, rv)) of a small
# geometry: every state the geometry can hold, every op its language
# encodes there (NIL included where a field may hold it).
GRIDS = {
    "gset": ({}, range(32),
             [(penc.F_ADD, a, 0, NIL) for a in BITS5]
             + [(penc.F_READ, 0, 0, rv) for rv in [NIL, *range(32)]]),
    "unordered-queue": ({}, range(32),
                        [(penc.F_ENQ, a, 0, NIL) for a in BITS5]
                        + [(penc.F_DEQ, 0, 0, rv) for rv in [NIL, *BITS5]]),
    "fifo-queue": ({"max_value": 2, "capacity": 3}, range(64),
                   [(penc.F_ENQ, a, 0, NIL) for a in range(3)]
                   + [(penc.F_DEQ, 0, 0, rv) for rv in [NIL, 0, 1, 2]]),
    "multi-register": ({"n_registers": 2, "max_value": 2}, range(16),
                       [(penc.F_WRITE, i, v, NIL)
                        for i in range(2) for v in range(3)]
                       + [(penc.F_READ, i, 0, rv) for i in range(2)
                          for rv in [NIL, 0, 1, 2]]),
    "mutex": ({}, [NIL, 0, 1],
              [(penc.F_CAS, a1, a2, NIL)
               for a1, a2 in itertools.product([0, 1], repeat=2)]),
}
NAMES = sorted(GRIDS)


def _pair(name):
    kw = GRIDS[name][0]
    jm = jmodels.REGISTRY[name](**kw)
    return jm, port_model(jm)


def _grid(name):
    _kw, states, ops = GRIDS[name]
    rows = [(s, *op) for s in states for op in ops]
    return np.asarray(rows, dtype=np.int32).T


def test_registry_holds_the_jax_models():
    assert sorted(pmodels.REGISTRY) == sorted(jmodels.REGISTRY)
    for name, cls in pmodels.REGISTRY.items():
        assert cls().name == jmodels.REGISTRY[name]().name == name


@pytest.mark.parametrize("name", NAMES)
def test_step_equals_jax_step_and_step_py(name):
    jm, pm = _pair(name)
    cols = _grid(name)
    p_legal, p_next = pm.step(*(torch.from_numpy(c) for c in cols))
    j_legal, j_next = jm.step(*(jnp.asarray(c) for c in cols))
    assert p_next.dtype == torch.int32
    np.testing.assert_array_equal(p_legal.numpy(), np.asarray(j_legal))
    np.testing.assert_array_equal(p_next.numpy(), np.asarray(j_next))
    for i, row in enumerate(cols.T.tolist()):
        legal, nxt = pm.step_py(*row)
        assert (legal, nxt) == jm.step_py(*row)
        assert bool(p_legal[i]) == bool(legal), (name, row)
        if legal:
            assert int(p_next[i]) == nxt, (name, row)


@pytest.mark.parametrize("name", NAMES)
def test_geometry_codec_and_descriptions_equal(name):
    jm, pm = _pair(name)
    for mv in (0, 1, 2, 4, 17, 30, 1000):
        assert pm.state_bound(mv) == jm.state_bound(mv)
        assert pm.pack_bits(mv) == jm.pack_bits(mv)
    assert (pm.init_state(), pm.state_offset, pm.packable_states) == \
        (jm.init_state(), jm.state_offset, jm.packable_states)
    cases = {
        "gset": [("add", 3, None, "ok"), ("read", None, [0, 4], "ok"),
                 ("read", None, None, "info"), ("read", None, (), "ok")],
        "unordered-queue": [("enqueue", 7, None, "ok"),
                            ("dequeue", None, 7, "ok"),
                            ("dequeue", None, 30, "info"),
                            ("dequeue", None, None, "fail")],
        "fifo-queue": [("enqueue", 2, None, "ok"), ("dequeue", None, 0, "ok"),
                       ("dequeue", None, 1, "info"),
                       ("dequeue", None, None, "fail")],
        "multi-register": [("write", (1, 2), None, "ok"),
                           ("read", (0, None), (0, 2), "ok"),
                           ("read", 1, 2, "ok"), ("read", (1, None), None,
                                                  "ok"),
                           ("read", (1, None), (1, None), "ok")],
        "mutex": [("cas", (0, 1), None, "ok"), ("read", None, 1, "ok"),
                  ("write", 1, None, "info")],
    }[name]
    for args in cases:
        got = pm.encode_invocation(*args)
        assert got == jm.encode_invocation(*args), (name, args)
        assert pm.describe_op(*got) == jm.describe_op(*got)
    for row in _grid(name).T.tolist():
        assert pm.describe_op(*row[1:]) == jm.describe_op(*row[1:])


def _both(fn, name, history):
    """fn(model, history) in each package: (JAX outcome, port outcome),
    each the exception's type name or the value."""
    jm, pm = _pair(name)
    out = []
    for m, mk in ((jm, JOp), (pm, POp)):
        try:
            out.append(fn(m, [mk(**o) for o in history]))
        except ValueError as e:
            out.append(type(e).__name__)
    return out


def _inv(f, value, p, typ="invoke"):
    return {"type": typ, "f": f, "value": value, "process": p}


REJECTED = {
    "fifo-queue": ("prepare", [_inv("enqueue", 1, p) for p in range(4)],
                   "EncodeError"),
    "unordered-queue": ("prepare", [_inv("enqueue", 5, 0),
                                    _inv("enqueue", 5, 1)], "EncodeError"),
    "gset": ("encode", [_inv("add", 31, 0), _inv("add", 31, 0, "ok")],
             "EncodeError"),
    "mutex": ("prepare", [_inv("read", None, 0)], "ValueError"),
    "multi-register": ("encode", [_inv("write", (2, 0), 0),
                                  _inv("write", (2, 0), 0, "ok")],
                       "EncodeError"),
}


@pytest.mark.parametrize("name", NAMES)
def test_same_rejections(name):
    how, history, err = REJECTED[name]

    def run(m, h):
        if how == "prepare":
            return len(m.prepare_history(h))
        mod = jenc if isinstance(m, jmodels.Model) else penc
        return mod.encode_history(h, m).n_events

    assert _both(run, name, history) == [err, err]


@pytest.mark.parametrize("name", ["fifo-queue", "unordered-queue"])
def test_indeterminate_dequeue(name):
    """Without a claimed value both packages reject it; with one it stays
    pending forever, rv set to the claimed element."""
    base = [_inv("enqueue", 2, 0), _inv("enqueue", 2, 0, "ok"),
            _inv("dequeue", None, 1)]

    def run(m, h):
        mod = jenc if isinstance(m, jmodels.Model) else penc
        return mod.encode_history(h, m).events.tolist()

    lost = base + [_inv("dequeue", None, 1, "info")]
    assert _both(run, name, lost) == ["EncodeError", "EncodeError"]
    claimed = base + [_inv("dequeue", 2, 1, "info")]
    want, got = _both(run, name, claimed)
    assert got == want and len(got) == 3
    assert got[-1][0] == penc.EV_INVOKE and got[-1][5] != NIL


def test_mutex_translation_and_fifo_geometry_limit():
    h = [_inv("acquire", None, 0), _inv("acquire", None, 0, "ok"),
         _inv("release", None, 0), _inv("release", None, 0, "fail")]
    got, want = (pmodels.Mutex().prepare_history([POp(**o) for o in h]),
                 jmodels.Mutex().prepare_history([JOp(**o) for o in h]))
    assert [(o.type, o.f, o.value) for o in got] == \
        [(o.type, o.f, o.value) for o in want]
    for args in ({"max_value": 4, "capacity": 11},
                 {"max_value": 7, "capacity": 8}):
        with pytest.raises(ValueError):
            pmodels.FIFOQueue(**args)
        with pytest.raises(ValueError):
            jmodels.FIFOQueue(**args)
    with pytest.raises(ValueError):
        pmodels.MultiRegister(n_registers=11, max_value=4)
