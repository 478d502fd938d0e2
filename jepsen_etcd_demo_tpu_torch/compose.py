"""Test composition: the workloads and the hermetic test map.

The reference's test assembly (src/jepsen/etcdemo.clj:110-190): the
workload registry (:128-131), the phased generator with rate limiting and
the cycling nemesis schedule (add-phase-generator, :134-144), the main ->
heal -> recover -> final-read shape (:168-174), merged over
noop-test-style defaults (:156-157). The JAX package's eight workloads,
with the same generators, clients and checkers; every checker a workload
constructs runs on the test's device, `opts["device"]` (None: cuda).

Only the hermetic composition over the in-process fake cluster
(`fake_test`) is ported; the real etcd composition is not.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from . import generators as gen
from .checkers import (Compose, ElleChecker, ElleRwChecker,
                       IndependentChecker, Linearizable, SetChecker)
from .checkers.perf import PerfChecker
from .checkers.timeline import TimelineChecker
from .clients import (FakeKVStore, MultiRegisterClient, MutexClient,
                      QueueClient, RegisterClient, SetClient, TxnClient,
                      fake_conn_factory)
from .db.fake import FakeDB
from .models import FIFOQueue, MultiRegister
from .nemesis import (FakeClockSkewNemesis, FakeIsolatedNodeNemesis,
                      FakePartitionNemesis, NoopNemesis)

# noop-test-style defaults (n1..n5, concurrency, time limit), overridden
# by the options, then by the workload (src/jepsen/etcdemo.clj:156-157).
DEFAULTS: dict[str, Any] = {
    "nodes": ["n1", "n2", "n3", "n4", "n5"],
    "concurrency": 10,
    "time_limit": 30,
    "rate": 10.0,           # Hz (:180-183)
    "ops_per_key": 100,     # (:184-187)
    "quorum": False,        # (:179)
    "seed": 0,
    "store_root": "store",
}


def r(ctx):
    """{:type :invoke, :f :read} (:67)."""
    return {"f": "read", "value": None}


def w(ctx):
    """A write of (rand-int 5) (:68)."""
    return {"f": "write", "value": ctx.rng.randrange(5)}


def cas(ctx):
    """A cas of a random [old new] over 0-4 (:69)."""
    return {"f": "cas", "value": (ctx.rng.randrange(5), ctx.rng.randrange(5))}


def check_budget(opts: dict) -> Optional[float]:
    """Wall-clock bound of the linearizability search, in seconds: the
    options' "check_budget_s" (0 or None: unbounded), else 120 s, which
    turns a combinatorially exploding frontier into "unknown"."""
    if "check_budget_s" in opts:
        v = opts["check_budget_s"]
        return float(v) if v else None
    return 120.0


def _linear(model, opts: dict) -> Linearizable:
    return Linearizable(model, device=opts.get("device"),
                        time_budget_s=check_budget(opts))


def _linear_timeline(model, opts: dict) -> Compose:
    """The per-key {linear, timeline} composition (:115-119)."""
    return Compose({"linear": _linear(model, opts),
                    "timeline": TimelineChecker()})


def _key_stream():
    i = 0
    while True:
        yield i
        i += 1


def register_workload(opts: dict, conn_factory: Callable) -> dict:
    """Register workload (:110-126): mixed r/w/cas over many independent
    keys, each checked {linear: cas-register, timeline: html}."""
    return {
        "client": RegisterClient(conn_factory),
        "checker": IndependentChecker(
            _linear_timeline("cas-register", opts)),
        "generator": gen.concurrent_generator(
            10, _key_stream(), lambda k: gen.limit(
                int(opts.get("ops_per_key", 100)), gen.mix([r, w, cas]))),
        "final_generator": None,
    }


def set_workload(opts: dict, conn_factory: Callable) -> dict:
    """Grow-only-set workload (set.clj:42-49): adds of successive ints
    forever, one final read after healing, the set-durability checker."""
    counter = iter(range(10**9))
    return {
        "client": SetClient(conn_factory),
        "checker": SetChecker(),
        "generator": gen.repeat(lambda ctx: {"f": "add",
                                             "value": next(counter)}),
        "final_generator": gen.once({"f": "read", "value": None}),
    }


def _elle_txn_workload(opts: dict, conn_factory: Callable, write_mop: str,
                       method: str, checker_cls) -> dict:
    """The two elle workloads: random multi-key txns of reads and writes
    (write values unique per key), a final read of every key after
    healing, the elle checker in the run's strictness. They need a
    transactional connection (the fake cluster)."""
    n_keys = int(opts.get("txn_keys", 3))
    max_len = int(opts.get("txn_len", 4))
    counters: dict = {}

    def txn_gen(ctx):
        mops = []
        for _ in range(1 + ctx.rng.randrange(max_len)):
            k = f"k{ctx.rng.randrange(n_keys)}"
            if ctx.rng.random() < 0.5:
                mops.append(("r", k, None))
            else:
                counters[k] = counters.get(k, 0) + 1
                mops.append((write_mop, k, counters[k]))
        return {"f": "txn", "value": mops}

    return {
        "client": TxnClient(conn_factory, method=method),
        "checker": Compose({"elle": checker_cls(
                                realtime=bool(opts.get("elle_realtime")),
                                device=opts.get("device")),
                            "timeline": TimelineChecker()}),
        "generator": gen.repeat(txn_gen),
        "final_generator": gen.once({
            "f": "txn",
            "value": [("r", f"k{i}", None) for i in range(n_keys)]}),
    }


def append_workload(opts: dict, conn_factory: Callable) -> dict:
    """Elle list-append: txns of reads and appends, the elle checker."""
    return _elle_txn_workload(opts, conn_factory, "append", "txn",
                              ElleChecker)


def txnregister_workload(opts: dict, conn_factory: Callable) -> dict:
    """Elle rw-register: txns of register reads and writes, ElleRwChecker."""
    return _elle_txn_workload(opts, conn_factory, "w", "txn_register",
                              ElleRwChecker)


def queue_workload(opts: dict, conn_factory: Callable) -> dict:
    """FIFO queues over independent keys: enqueues of small random values
    and dequeues, each key checked {linear: fifo-queue, timeline}. A key's
    enqueues stay within the model's capacity, so every key's history is
    checkable; the keys give the scale, not the history length."""
    model = FIFOQueue()  # values 0..4, capacity 10
    per_key_ops = min(int(opts.get("ops_per_key", 100)), 2 * model.capacity)

    def per_key(k):
        budget = {"enq": model.capacity}

        def step(ctx):
            if budget["enq"] > 0 and ctx.rng.random() < 0.55:
                budget["enq"] -= 1
                return {"f": "enqueue",
                        "value": ctx.rng.randrange(model.max_value + 1)}
            return {"f": "dequeue", "value": None}

        return gen.limit(per_key_ops, gen.repeat(step))

    return {
        "client": QueueClient(conn_factory),
        "checker": IndependentChecker(_linear_timeline(model, opts)),
        "generator": gen.concurrent_generator(10, _key_stream(), per_key),
        "final_generator": None,
    }


def multiregister_workload(opts: dict, conn_factory: Callable) -> dict:
    """Reads and writes over a small register file, checked as ONE
    history against the multi-register model, so ordering across
    registers is checked too."""
    model = MultiRegister()  # 3 registers over values 0..4

    def step(ctx):
        i = ctx.rng.randrange(model.n_registers)
        if ctx.rng.random() < 0.5:
            return {"f": "read", "value": (i, None)}
        return {"f": "write",
                "value": (i, ctx.rng.randrange(model.max_value + 1))}

    return {
        "client": MultiRegisterClient(conn_factory),
        "checker": _linear_timeline(model, opts),
        "generator": gen.repeat(step),
        "final_generator": None,
    }


def gset_workload(opts: dict, conn_factory: Callable) -> dict:
    """Set ops checked for read linearizability under the gset model:
    every read must see exactly the adds linearized before it. Values
    cycle over 0-4, so adds are idempotent and the 32 states fit the
    dense table."""
    counter = {"i": 0}

    def step(ctx):
        if ctx.rng.random() < 0.3:
            return {"f": "read", "value": None}
        counter["i"] += 1
        return {"f": "add", "value": counter["i"] % 5}

    return {
        "client": SetClient(conn_factory),
        "checker": _linear_timeline("gset", opts),
        "generator": gen.repeat(step),
        "final_generator": gen.once({"f": "read", "value": None}),
    }


def mutex_workload(opts: dict, conn_factory: Callable) -> dict:
    """A distributed lock under the mutex model: every worker thread
    alternates acquire/release forever, checked as ONE history. Long
    partitions pile up indeterminate acquires and releases whose
    interleavings explode; the search budget turns that into "unknown"."""

    def thread_gen():
        state = {"i": 0}

        def step(ctx):
            i = state["i"]
            state["i"] = i + 1
            return {"f": "acquire" if i % 2 == 0 else "release",
                    "value": None}

        return gen.repeat(step)

    return {
        "client": MutexClient(conn_factory),
        "checker": _linear_timeline("mutex", opts),
        "generator": gen.each_thread(thread_gen),
        "final_generator": None,
    }


WORKLOADS = {
    "register": register_workload,
    "set": set_workload,
    "gset": gset_workload,
    "append": append_workload,
    "txnregister": txnregister_workload,
    "queue": queue_workload,
    "multiregister": multiregister_workload,
    "mutex": mutex_workload,
}


def add_phase_generator(opts: dict, workload_gen, final_gen) -> gen.Phases:
    """Rate-limit the client stream, overlay the cycling nemesis schedule,
    cap the wall time; then heal -> recover -> final phase (:134-144,
    :168-174)."""
    rate = float(opts.get("rate", 10.0))
    interval = float(opts.get("nemesis_interval", 5))
    main = gen.time_limit(
        float(opts.get("time_limit", 30)),
        _merge(
            gen.clients_gen(gen.stagger(1.0 / rate, workload_gen)),
            gen.nemesis_gen(gen.cycle(lambda: [
                gen.sleep(interval),
                gen.once({"f": "start", "value": None}),
                gen.sleep(interval),
                gen.once({"f": "stop", "value": None}),
            ])) if not opts.get("no_nemesis") else gen.Gen()))
    phases = [
        main,
        gen.log("Healing cluster"),
        gen.nemesis_gen(gen.once({"f": "stop", "value": None})),
        gen.log("Waiting for recovery"),
        gen.sleep(float(opts.get("recovery_wait", 10))),
    ]
    if final_gen is not None:
        phases.append(gen.clients_gen(final_gen))
    return gen.phases(*phases)


class _merge(gen.Gen):
    """Interleave two channel-routed generators: each asker takes from
    whichever answers (clients and nemesis side by side, :136-143)."""

    def __init__(self, *gens):
        self.gens = list(gens)

    def next_for(self, ctx):
        best_wake = None
        exhausted = 0
        for g in self.gens:
            out = g.next_for(ctx)
            if isinstance(out, gen.Pending):
                if out.wake is not None:
                    best_wake = (out.wake if best_wake is None
                                 else min(best_wake, out.wake))
            elif out is None:
                exhausted += 1
            else:
                return out
        if exhausted == len(self.gens):
            return None
        return gen.Pending(best_wake)


def compose_test(opts: dict, conn_factory: Callable,
                 workload_name: Optional[str] = None) -> dict:
    """The test map: defaults <- opts <- workload wiring (the merge order
    of :156-175)."""
    test = dict(DEFAULTS)
    test.update(opts)
    name = workload_name or test.get("workload", "register")
    workload = WORKLOADS[name](test, conn_factory)
    test.setdefault("name", f"etcd q={str(test['quorum']).lower()}")
    test["workload"] = name
    test["client"] = workload["client"]
    test["generator"] = add_phase_generator(
        test, workload["generator"], workload.get("final_generator"))
    test["checker"] = Compose({
        "perf": PerfChecker(),
        "indep": workload["checker"],
    })
    return test


# The nemeses the fake cluster can express, by --nemesis name.
FAKE_NEMESES = {
    "partition": lambda store, seed: FakePartitionNemesis(store, seed=seed),
    "partition-node": lambda store, seed: FakeIsolatedNodeNemesis(
        store, seed=seed),
    "clock": lambda store, seed: FakeClockSkewNemesis(store, seed=seed),
    "noop": lambda store, seed: NoopNemesis(),
}


def pick_nemesis(opts: dict, store: FakeKVStore):
    """The fake cluster's nemesis for opts["nemesis"] (partition by
    default). The real cluster's nemeses are not ported."""
    kind = opts.get("nemesis", "partition")
    if kind not in FAKE_NEMESES:
        raise ValueError(
            f"nemesis {kind!r} not available in --fake mode "
            f"(have: {sorted(FAKE_NEMESES)})")
    return FAKE_NEMESES[kind](store, int(opts.get("seed", 0)))


def fake_test(opts: dict, store: Optional[FakeKVStore] = None) -> dict:
    """The hermetic composition over the in-process fake cluster."""
    opts = dict(opts)
    opts["local_mode"] = True
    if store is None:
        store = FakeKVStore(seed=int(opts.get("seed", 0)),
                            op_delay_s=float(opts.get("op_delay", 0.0)),
                            stale_read_prob=float(
                                opts.get("stale_read_prob", 0.0)),
                            lost_write_prob=float(
                                opts.get("lost_write_prob", 0.0)),
                            duplicate_cas_prob=float(
                                opts.get("duplicate_cas_prob", 0.0)),
                            reorder_prob=float(
                                opts.get("reorder_prob", 0.0)),
                            duplicate_delivery_prob=float(
                                opts.get("duplicate_delivery_prob", 0.0)))
    test = compose_test(opts, fake_conn_factory(store))
    test["db"] = FakeDB()
    test["nemesis"] = pick_nemesis(test, store)
    test["fake_store"] = store
    return test
