"""The port's run harness against the JAX package's, piece by piece, on
the same seeds: generators op for op under a scripted clock, the fake
cluster's completions under every fault knob, the fake nemeses, the
composed test maps, the timeline (byte for byte), the perf numbers and
Compose."""

from __future__ import annotations

import asyncio
import random
import re

import pytest

from jepsen_etcd_demo_tpu import compose as jcompose
from jepsen_etcd_demo_tpu import generators as jgen
from jepsen_etcd_demo_tpu.checkers.compose import Compose as JCompose
from jepsen_etcd_demo_tpu.checkers.perf import PerfChecker as JPerf
from jepsen_etcd_demo_tpu.checkers.timeline import \
    render_timeline as jrender
from jepsen_etcd_demo_tpu.clients import fake_kv as jfake
from jepsen_etcd_demo_tpu.clients import mutex_client as jmutex
from jepsen_etcd_demo_tpu.clients import queue_client as jqueue
from jepsen_etcd_demo_tpu.clients import register as jregister
from jepsen_etcd_demo_tpu.clients import set_client as jset
from jepsen_etcd_demo_tpu.clients import txn as jtxn
from jepsen_etcd_demo_tpu.nemesis import base as jnbase
from jepsen_etcd_demo_tpu.nemesis import clock as jclock
from jepsen_etcd_demo_tpu.nemesis import partition as jpartition
from jepsen_etcd_demo_tpu.ops.op import Op as JOp
from jepsen_etcd_demo_tpu.store import store as jstore
from jepsen_etcd_demo_tpu.utils import fuzz as jfuzz
from jepsen_etcd_demo_tpu_torch import compose as pcompose
from jepsen_etcd_demo_tpu_torch import generators as pgen
from jepsen_etcd_demo_tpu_torch.checkers import base as pbase
from jepsen_etcd_demo_tpu_torch.checkers.compose import Compose as PCompose
from jepsen_etcd_demo_tpu_torch.checkers.perf import PerfChecker as PPerf
from jepsen_etcd_demo_tpu_torch.checkers.timeline import \
    render_timeline as prender
from jepsen_etcd_demo_tpu_torch.clients import fake_kv as pfake
from jepsen_etcd_demo_tpu_torch.clients import mutex_client as pmutex
from jepsen_etcd_demo_tpu_torch.clients import queue_client as pqueue
from jepsen_etcd_demo_tpu_torch.clients import register as pregister
from jepsen_etcd_demo_tpu_torch.clients import set_client as pset
from jepsen_etcd_demo_tpu_torch.clients import txn as ptxn
from jepsen_etcd_demo_tpu_torch.nemesis import base as pnbase
from jepsen_etcd_demo_tpu_torch.nemesis import clock as pclock
from jepsen_etcd_demo_tpu_torch.nemesis import partition as ppartition
from jepsen_etcd_demo_tpu_torch.ops.op import Op as POp
from jepsen_etcd_demo_tpu_torch.store import store as pstore

from torch_port_util import port_ops

SECOND = 1_000_000_000
PKGS = {"jax": (jgen, jcompose, JOp), "port": (pgen, pcompose, POp)}


def _norm(res):
    """An emission in a form both packages share."""
    if res is None:
        return None
    if isinstance(res, (jgen.Pending, pgen.Pending)):
        return ("pending", res.wake)
    return (res.type, res.f, res.value, res.process)


def script(g, pkg: str, seed: int, steps: int, processes,
           concurrency: int = 10, t_step: int = SECOND // 50):
    """Drive a generator under a scripted clock: askers take turns from
    `processes`, Pending(wake) jumps the clock to its wake (else t_step),
    an op advances it 1 ms, and a pending phase barrier opens at once."""
    mod = PKGS[pkg][0]
    rng = random.Random(seed)
    test = {"concurrency": concurrency}
    t, out = 0, []
    for i in range(steps):
        p = processes[i % len(processes)]
        res = g.next_for(mod.GenContext(t, p, rng, test))
        out.append(_norm(res))
        if isinstance(res, mod.Pending):
            t = max(t, res.wake) if res.wake is not None else t + t_step
        elif res is not None:
            t += SECOND // 1000
        if isinstance(g, mod.Phases) and g.barrier_pending():
            g.barrier_done()
    return out


def _fn(pkg):
    cmp = PKGS[pkg][1]
    return cmp.r, cmp.w, cmp.cas


GENERATORS = {
    "mix": lambda g, pkg: g.limit(40, g.mix(list(_fn(pkg)))),
    "limit": lambda g, pkg: g.limit(7, _fn(pkg)[1]),
    "stagger": lambda g, pkg: g.limit(30, g.stagger(0.01, g.repeat(
        _fn(pkg)[2]))),
    "time_limit": lambda g, pkg: g.time_limit(0.2, g.stagger(
        0.005, g.mix(list(_fn(pkg))))),
    "phases": lambda g, pkg: g.phases(
        g.time_limit(0.1, g.clients_gen(g.stagger(0.01, _fn(pkg)[1]))),
        g.log("heal"), g.nemesis_gen(g.once({"f": "stop", "value": None})),
        g.sleep(0.05), g.clients_gen(g.once({"f": "read", "value": None}))),
    "cycle": lambda g, pkg: g.time_limit(1.0, g.nemesis_gen(g.cycle(
        lambda: [g.sleep(0.1), g.once({"f": "start", "value": None}),
                 g.sleep(0.1), g.once({"f": "stop", "value": None})]))),
    "each_thread": lambda g, pkg: g.limit(60, g.each_thread(
        lambda: g.limit(4, g.mix([_fn(pkg)[0], _fn(pkg)[1]])))),
    "concurrent_generator": lambda g, pkg: g.concurrent_generator(
        2, iter(range(6)), lambda k: g.limit(5, g.mix(list(_fn(pkg))))),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generators_op_for_op(name):
    procs = [0, 1, 2, 3, 12, "nemesis", 5, 14]
    got = {pkg: script(GENERATORS[name](PKGS[pkg][0], pkg), pkg, seed=11,
                       steps=400, processes=procs) for pkg in PKGS}
    assert got["port"] == got["jax"]
    assert any(isinstance(e, tuple) and e[0] == "invoke"
               for e in got["port"])


@pytest.mark.parametrize("workload", sorted(jcompose.WORKLOADS))
def test_workload_generators_op_for_op(workload):
    """Each workload's whole phased generator (rate limit, nemesis
    schedule, time limit, heal, recovery, final phase) emits the same ops
    from one seed."""
    opts = {"workload": workload, "time_limit": 0.5, "rate": 200.0,
            "nemesis_interval": 0.1, "recovery_wait": 0.05,
            "ops_per_key": 7, "seed": 3, "device": "cpu"}
    got = {}
    for pkg, (_g, cmp, _op) in PKGS.items():
        test = cmp.compose_test(dict(opts), lambda t, n: None)
        got[pkg] = script(test["generator"], pkg, seed=3, steps=600,
                          processes=list(range(10)) + ["nemesis"],
                          t_step=SECOND // 200)
    assert got["port"] == got["jax"]
    assert sum(1 for e in got["port"]
               if isinstance(e, tuple) and e[0] == "invoke") > 20


# -- the fake cluster -----------------------------------------------------

KNOBS = {"healthy": {},
         "stale": {"stale_read_prob": 0.5},
         "lost": {"lost_write_prob": 0.3},
         "dup-cas": {"duplicate_cas_prob": 0.4},
         "reorder": {"reorder_prob": 0.5},
         "dup-delivery": {"duplicate_delivery_prob": 0.4},
         "all": {"stale_read_prob": 0.3, "lost_write_prob": 0.2,
                 "duplicate_cas_prob": 0.2, "reorder_prob": 0.3,
                 "duplicate_delivery_prob": 0.2}}


def _invocations(workload: str, rng: random.Random, n: int):
    """(f, value) invocations of a workload."""
    out = []
    for i in range(n):
        x = rng.random()
        if workload == "register":
            k = rng.randrange(3)
            out.append(("read", (k, None)) if x < 0.3 else
                       ("write", (k, rng.randrange(5))) if x < 0.6 else
                       ("cas", (k, (rng.randrange(5), rng.randrange(5)))))
        elif workload == "multiregister":
            out.append(("read", (rng.randrange(3), None)) if x < 0.5 else
                       ("write", (rng.randrange(3), rng.randrange(5))))
        elif workload in ("set", "gset"):
            out.append(("read", None) if x < 0.2 else ("add", i % 7))
        elif workload == "queue":
            out.append(("enqueue", (rng.randrange(2), rng.randrange(5)))
                       if x < 0.55 else ("dequeue", (rng.randrange(2), None)))
        elif workload == "mutex":
            out.append(("acquire" if x < 0.5 else "release", None))
        else:
            w = "append" if workload == "append" else "w"
            out.append(("txn", [("r", f"k{rng.randrange(3)}", None)
                                if rng.random() < 0.5 else
                                (w, f"k{rng.randrange(3)}", i)
                                for _ in range(1 + rng.randrange(3))]))
    return out


def _client(workload: str, pkg: str, factory):
    mods = {"jax": (jregister, jset, jqueue, jmutex, jtxn),
            "port": (pregister, pset, pqueue, pmutex, ptxn)}[pkg]
    reg, st, qu, mu, tx = mods
    return {"register": lambda: reg.RegisterClient(factory),
            "multiregister": lambda: reg.MultiRegisterClient(factory),
            "set": lambda: st.SetClient(factory),
            "gset": lambda: st.SetClient(factory),
            "queue": lambda: qu.QueueClient(factory),
            "mutex": lambda: mu.MutexClient(factory),
            "append": lambda: tx.TxnClient(factory, method="txn"),
            "txnregister": lambda: tx.TxnClient(factory,
                                                method="txn_register"),
            }[workload]()


def _completions(workload: str, pkg: str, knobs: dict, seed: int):
    fake = {"jax": jfake, "port": pfake}[pkg]
    reg = {"jax": jregister, "port": pregister}[pkg]
    op_cls = PKGS[pkg][2]
    store = fake.FakeKVStore(seed=seed, **knobs)
    proto = _client(workload, pkg, reg.fake_conn_factory(store))
    test = {"quorum": False}
    invs = _invocations(workload, random.Random(seed), 120)

    async def go():
        c0 = await proto.open(test, "n1")
        await c0.setup(test)
        out = []
        for i, (f, v) in enumerate(invs):
            if i == 40:
                store.isolate({"n2", "n3"})
            if i == 80:
                store.heal()
            c = await proto.open(test, f"n{1 + i % 5}")
            done = await c.invoke(test, op_cls(type="invoke", f=f, value=v,
                                               process=i % 5))
            out.append((done.type, done.f, done.value, done.error))
        return out, dict(store.data), {k: list(q) for k, q
                                       in store.queues.items()}

    return asyncio.run(go())


@pytest.mark.parametrize("knob", sorted(KNOBS))
@pytest.mark.parametrize("workload", sorted(jcompose.WORKLOADS))
def test_fake_cluster_completions(workload, knob):
    want = _completions(workload, "jax", KNOBS[knob], seed=5)
    got = _completions(workload, "port", KNOBS[knob], seed=5)
    assert got == want
    assert {c[0] for c in got[0]} & {"ok"}


# -- the fake nemeses -----------------------------------------------------

NEMESES = {
    "partition": (lambda s: jpartition.FakePartitionNemesis(s, seed=4),
                  lambda s: ppartition.FakePartitionNemesis(s, seed=4)),
    "partition-node": (
        lambda s: jpartition.FakeIsolatedNodeNemesis(s, seed=4),
        lambda s: ppartition.FakeIsolatedNodeNemesis(s, seed=4)),
    "clock": (lambda s: jclock.FakeClockSkewNemesis(s, seed=4),
              lambda s: pclock.FakeClockSkewNemesis(s, seed=4)),
    "noop": (lambda s: jnbase.NoopNemesis(), lambda s: pnbase.NoopNemesis()),
}


@pytest.mark.parametrize("kind", sorted(NEMESES))
def test_fake_nemesis_fault_sequences(kind):
    def faults(pkg):
        fake = {"jax": jfake, "port": pfake}[pkg]
        store = fake.FakeKVStore(seed=0)
        nem = NEMESES[kind][pkg == "port"](store)
        test = {"nodes": ["n1", "n2", "n3", "n4", "n5"]}
        op_cls = PKGS[pkg][2]

        async def go():
            out = []
            await nem.setup(test)
            for i in range(12):
                f = "start" if i % 3 != 2 else "stop"
                done = await nem.invoke(test, op_cls(
                    type="invoke", f=f, value=None, process="nemesis"))
                out.append((done.type, done.f, done.value,
                            sorted(store.isolated),
                            dict(getattr(store, "clock_skew", {}))))
            await nem.teardown(test)
            out.append((sorted(store.isolated),
                        dict(getattr(store, "clock_skew", {}))))
            return out

        return asyncio.run(go())

    assert faults("port") == faults("jax")


# -- the composed test map ------------------------------------------------

_REPR = re.compile(r"<([\w.]+)\.(\w+) object at 0x[0-9a-f]+>")


def _data(test: dict, mod) -> dict:
    """_jsonable_test's output with each object's repr cut to its class
    name (addresses and package paths differ)."""
    out = mod._jsonable_test(test)
    return {k: _REPR.sub(lambda m: m.group(2), v) if isinstance(v, str)
            else v for k, v in out.items()}


@pytest.mark.parametrize("workload", sorted(jcompose.WORKLOADS))
def test_fake_test_maps_match(workload, tmp_path):
    opts = {"workload": workload, "time_limit": 2.0, "rate": 50.0,
            "seed": 9, "store_root": str(tmp_path), "nemesis": "partition",
            "stale_read_prob": 0.1, "device": "cpu",
            "ssh": {"username": "u", "password": "secret"}}
    jt = jcompose.fake_test(dict(opts))
    pt = pcompose.fake_test(dict(opts))
    assert list(pt) == list(jt)
    assert _data(pt, pstore) == _data(jt, jstore)
    assert _data(pt, pstore)["ssh"]["password"] == "<redacted>"
    assert type(pt["checker"].checkers["indep"]).__name__ == \
        type(jt["checker"].checkers["indep"]).__name__
    assert pt["fake_store"].stale_read_prob == 0.1
    ct = pcompose.compose_test(dict(opts), lambda t, n: None)
    assert list(ct) == list(jcompose.compose_test(dict(opts),
                                                  lambda t, n: None))


@pytest.mark.parametrize("kind", ["partition", "partition-node", "clock",
                                  "noop", "kill"])
def test_pick_nemesis_matches_the_fake_registry(kind):
    opts = {"nemesis": kind, "seed": 1}
    if kind == "kill":
        with pytest.raises(ValueError, match="not available in --fake"):
            pcompose.pick_nemesis(opts, pfake.FakeKVStore())
        with pytest.raises(ValueError, match="not available in --fake"):
            jcompose.pick_nemesis(opts, store=jfake.FakeKVStore())
        return
    got = pcompose.pick_nemesis(opts, pfake.FakeKVStore())
    want = jcompose.pick_nemesis(opts, store=jfake.FakeKVStore())
    assert type(got).__name__ == type(want).__name__


@pytest.mark.parametrize("opts", [{}, {"check_budget_s": 0},
                                  {"check_budget_s": 3.5}])
def test_check_budget_matches(opts):
    assert pcompose.check_budget(opts) == jcompose.check_budget(opts)


# -- timeline, perf, compose ---------------------------------------------

def _timed_history(seed: int):
    """A keyed register history (JAX ops) with invoke/complete times, a
    nemesis window and ops that never complete."""
    per_key = [jfuzz.gen_register_history(random.Random(seed + k),
                                          n_ops=25, n_procs=4, p_info=0.1)
               for k in range(3)]
    h = jfuzz.interleave_keyed(per_key)
    h = h[:5] + [JOp(type="invoke", f="start", value=None,
                     process="nemesis"),
                 JOp(type="info", f="start", value={"isolated": ["n1"]},
                     process="nemesis")] + h[5:] + [
        JOp(type="invoke", f="stop", value=None, process="nemesis"),
        JOp(type="info", f="stop", value="network healed",
            process="nemesis"),
        JOp(type="invoke", f="write", value=(9, 1), process=77)]
    rng = random.Random(seed)
    t = 0
    for i, op in enumerate(h):
        t += rng.randrange(1, 3_000_000)
        op.time, op.index = t, i
    return h


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_timeline_byte_for_byte(seed):
    h = _timed_history(seed)
    assert prender(port_ops(h)) == jrender(h)
    assert prender([]) == jrender([])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_perf_numbers(seed):
    h = _timed_history(seed)
    want = JPerf().check({}, h)
    got = PPerf().check({}, port_ops(h))
    assert got.keys() == want.keys()
    assert got["count"] == want["count"] and got["valid"] is True
    assert got["rate_hz"] == pytest.approx(want["rate_hz"], abs=1e-12)
    for q, v in want["latency"].items():
        assert got["latency"][q] == pytest.approx(v, abs=1e-12), q
    assert PPerf().check({}, []) == JPerf().check({}, [])


class _Const(pbase.Checker):
    def __init__(self, v):
        self.v = v

    def check(self, test, history, opts=None):
        return {"valid": self.v, "opts": dict(opts or {})}


@pytest.mark.parametrize("vs", [(True, True), (True, False),
                                (True, "unknown"), ("unknown", False), ()])
def test_compose_and_merge_valid(vs):
    from jepsen_etcd_demo_tpu.checkers.base import merge_valid as jmerge

    checks = {f"c{i}": _Const(v) for i, v in enumerate(vs)}
    got = PCompose(checks).check({}, [], {"key": 3})
    want = JCompose(checks).check({}, [], {"key": 3})
    assert got == want
    assert pbase.merge_valid(list(vs)) == jmerge(list(vs))
    with pytest.raises(ValueError, match="reserved"):
        PCompose({"valid": _Const(True)})
