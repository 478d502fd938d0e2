"""Core generator combinators (see the package docstring for the protocol)."""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence, Union

from ..ops.op import INVOKE, Op

NEMESIS = "nemesis"

SECOND = 1_000_000_000  # ns


@dataclass(frozen=True)
class Pending:
    """Nothing to dispatch for this asker right now.

    wake: relative time (ns) at which asking again may yield an op, or None
    when the generator waits on an external event (e.g. another phase)."""

    wake: Optional[int] = None


@dataclass
class GenContext:
    """What a generator may observe when asked for an op."""

    time: int                    # relative ns since test start
    process: Any                 # asking worker: client int or NEMESIS
    rng: random.Random
    test: dict | None = None

    def for_process(self, process) -> "GenContext":
        return GenContext(self.time, process, self.rng, self.test)


NextResult = Union[Op, Pending, None]


class Gen:
    """Base generator: exhausted immediately."""

    def next_for(self, ctx: GenContext) -> NextResult:
        return None


class _FnGen(Gen):
    """Wraps a callable returning an Op (or a dict of Op fields) per call;
    the reference's op constructors r/w/cas (src/jepsen/etcdemo.clj:67-69)
    are such callables, drawing from the shared rng through ctx."""

    def __init__(self, fn: Callable):
        self.fn = fn

    def next_for(self, ctx: GenContext) -> NextResult:
        return _as_op(self.fn(ctx), ctx)


def _as_op(out, ctx: GenContext) -> NextResult:
    if out is None or isinstance(out, (Op, Pending)):
        return out
    if isinstance(out, dict):
        d = dict(out)
        d.setdefault("type", INVOKE)
        return Op(**d)
    raise TypeError(f"generator fn returned {out!r}")


def fn_gen(fn: Callable) -> Gen:
    return _FnGen(fn)


def lift(x) -> Gen:
    """Coerce: Gen | callable | Op | dict | iterable-of-those -> Gen."""
    if isinstance(x, Gen):
        return x
    if callable(x):
        return _FnGen(x)
    if isinstance(x, Op):
        return Once(_ConstGen(x))
    if isinstance(x, dict):
        d = dict(x)
        d.setdefault("type", INVOKE)
        return Once(_ConstGen(Op(**d)))
    if isinstance(x, (list, tuple)):
        return Seq([lift(e) for e in x])
    raise TypeError(f"cannot lift {x!r} to a generator")


class _ConstGen(Gen):
    def __init__(self, op: Op):
        self.op = op

    def next_for(self, ctx: GenContext) -> NextResult:
        # A fresh copy each time: the runner sets process/time/index.
        o = self.op
        return Op(type=o.type, f=o.f, value=o.value, process=o.process,
                  time=o.time, error=o.error)


class Mix(Gen):
    """A uniform random choice among sub-generators per emission - gen/mix
    (src/jepsen/etcdemo.clj:123). Exhausted sub-generators drop out; the
    mix is exhausted when all are."""

    def __init__(self, gens: Sequence):
        self.gens = [lift(g) for g in gens]

    def next_for(self, ctx: GenContext) -> NextResult:
        live = list(range(len(self.gens)))
        best_wake = None
        while live:
            i = live[ctx.rng.randrange(len(live))]
            out = self.gens[i].next_for(ctx)
            if isinstance(out, Op):
                return out
            if isinstance(out, Pending):
                if out.wake is not None:
                    best_wake = (out.wake if best_wake is None
                                 else min(best_wake, out.wake))
                live.remove(i)
            else:
                self.gens.pop(i)
                live = [j if j < i else j - 1 for j in live if j != i]
        if self.gens:
            return Pending(best_wake)
        return None


class Limit(Gen):
    """At most n ops, then exhausted - gen/limit (:ops-per-key,
    src/jepsen/etcdemo.clj:124)."""

    def __init__(self, n: int, gen):
        self.remaining = n
        self.gen = lift(gen)

    def next_for(self, ctx: GenContext) -> NextResult:
        if self.remaining <= 0:
            return None
        out = self.gen.next_for(ctx)
        if isinstance(out, Op):
            self.remaining -= 1
        return out


def once(gen) -> Gen:
    """gen/once: exactly one op (src/jepsen/etcdemo.clj:171)."""
    return Limit(1, gen)


Once = once


class TimeLimit(Gen):
    """Exhausted once ctx.time passes the budget - gen/time-limit
    (src/jepsen/etcdemo.clj:144). The window starts at the first ask, so
    each phase's limit is relative to its own start."""

    def __init__(self, seconds: float, gen):
        self.budget_ns = int(seconds * SECOND)
        self.deadline: Optional[int] = None
        self.gen = lift(gen)

    def next_for(self, ctx: GenContext) -> NextResult:
        if self.deadline is None:
            self.deadline = ctx.time + self.budget_ns
        if ctx.time >= self.deadline:
            return None
        return self.gen.next_for(ctx)


class Stagger(Gen):
    """Rate limiting: successive ops are spaced by a uniform random delay
    in [0, 2*mean), so the long-run rate is 1/mean across every worker of
    the channel - gen/stagger (src/jepsen/etcdemo.clj:137)."""

    def __init__(self, mean_seconds: float, gen):
        self.mean_ns = int(mean_seconds * SECOND)
        self.next_time: Optional[int] = None
        self.gen = lift(gen)

    def next_for(self, ctx: GenContext) -> NextResult:
        if self.next_time is None:
            self.next_time = ctx.time
        if ctx.time < self.next_time:
            return Pending(self.next_time)
        out = self.gen.next_for(ctx)
        if isinstance(out, Op):
            self.next_time += ctx.rng.randrange(max(1, 2 * self.mean_ns))
            # Never fall behind by more than one interval: catch up after
            # a stall instead of bursting.
            self.next_time = max(self.next_time, ctx.time)
        return out


class Sleep(Gen):
    """Emit nothing for `seconds`, then exhausted - gen/sleep
    (src/jepsen/etcdemo.clj:139,141,173)."""

    def __init__(self, seconds: float):
        self.budget_ns = int(seconds * SECOND)
        self.deadline: Optional[int] = None

    def next_for(self, ctx: GenContext) -> NextResult:
        if self.deadline is None:
            self.deadline = ctx.time + self.budget_ns
        if ctx.time >= self.deadline:
            return None
        return Pending(self.deadline)


class Log(Gen):
    """Emit one log pseudo-op that the runner prints - gen/log
    (src/jepsen/etcdemo.clj:170,172)."""

    def __init__(self, message: str):
        self.message: Optional[str] = message

    def next_for(self, ctx: GenContext) -> NextResult:
        if self.message is None:
            return None
        msg, self.message = self.message, None
        return Op(type="log", f="log", value=msg)


class Seq(Gen):
    """Sub-generators in order; the next starts when the head exhausts,
    with no barrier (unlike Phases), alongside ops still in flight."""

    def __init__(self, gens: Sequence):
        self.gens = [lift(g) for g in gens]

    def next_for(self, ctx: GenContext) -> NextResult:
        while self.gens:
            out = self.gens[0].next_for(ctx)
            if out is not None:
                return out
            self.gens.pop(0)
        return None


class Cycle(Gen):
    """Rebuild and drain a generator from a factory, forever - gen/cycle
    (the nemesis schedule, src/jepsen/etcdemo.clj:138-143)."""

    def __init__(self, factory: Callable[[], Any]):
        self.factory = factory
        self.current = lift(factory())

    def next_for(self, ctx: GenContext) -> NextResult:
        for _ in range(2):
            out = self.current.next_for(ctx)
            if out is not None:
                return out
            self.current = lift(self.factory())
        # A factory whose product is exhausted at once would spin forever.
        return None


def cycle(*gens_or_factory) -> Gen:
    if len(gens_or_factory) == 1 and callable(gens_or_factory[0]) \
            and not isinstance(gens_or_factory[0], Gen):
        return Cycle(gens_or_factory[0])
    items = list(gens_or_factory)
    return Cycle(lambda: [lift(g) for g in items])


class Repeat(Gen):
    """Emit ops from a fn generator forever."""

    def __init__(self, fn: Callable):
        self.gen = _FnGen(fn)

    def next_for(self, ctx: GenContext) -> NextResult:
        return self.gen.next_for(ctx)


class EachThread(Gen):
    """One sub-generator per worker thread - gen/each-thread. The factory
    runs once per thread (thread = process mod concurrency: a crashed
    process reincarnates as p + concurrency on the same thread, which
    keeps its generator), e.g. the mutex workload's acquire/release
    alternation."""

    def __init__(self, factory: Callable[[], Any]):
        self.factory = factory
        self.per_thread: dict[int, Gen] = {}

    def next_for(self, ctx: GenContext) -> NextResult:
        if ctx.process == NEMESIS:
            return Pending(None)
        # The runner publishes its concurrency in the test map; the
        # default serves generators driven outside the runner.
        conc = int((ctx.test or {}).get("concurrency", 10))
        thread = int(ctx.process) % conc
        if thread not in self.per_thread:
            self.per_thread[thread] = lift(self.factory())
        return self.per_thread[thread].next_for(ctx)


def each_thread(factory: Callable[[], Any]) -> Gen:
    return EachThread(factory)


class OnNemesis(Gen):
    """Route a generator to the nemesis channel only - gen/nemesis
    (src/jepsen/etcdemo.clj:138). Client askers see Pending."""

    def __init__(self, gen):
        self.gen = lift(gen)

    def next_for(self, ctx: GenContext) -> NextResult:
        if ctx.process != NEMESIS:
            return Pending(None)
        return self.gen.next_for(ctx)


class OnClients(Gen):
    """Route to client workers only - gen/clients
    (src/jepsen/etcdemo.clj:136-137)."""

    def __init__(self, gen):
        self.gen = lift(gen)

    def next_for(self, ctx: GenContext) -> NextResult:
        if ctx.process == NEMESIS:
            return Pending(None)
        return self.gen.next_for(ctx)


class Phases(Gen):
    """Sequential phases with a full barrier between them - gen/phases
    (src/jepsen/etcdemo.clj:168-174). The runner sees the boundary through
    `barrier_pending()` and lets the ops in flight finish before the next
    phase starts."""

    def __init__(self, *gens):
        self.phases = [lift(g) for g in gens]
        self.index = 0
        self._need_barrier = False

    def barrier_pending(self) -> bool:
        return self._need_barrier

    def barrier_done(self):
        self._need_barrier = False

    def next_for(self, ctx: GenContext) -> NextResult:
        while self.index < len(self.phases):
            if self._need_barrier:
                return Pending(None)
            out = self.phases[self.index].next_for(ctx)
            if out is not None:
                return out
            # This asker found the phase exhausted; the next phase opens
            # when the runner confirms the barrier (all workers idle).
            self.index += 1
            self._need_barrier = self.index < len(self.phases)
        return None


# Lowercase constructors, as the jepsen namespace names them.
def mix(gens) -> Gen:
    return Mix(gens)


def limit(n: int, gen) -> Gen:
    return Limit(n, gen)


def time_limit(seconds: float, gen) -> Gen:
    return TimeLimit(seconds, gen)


def stagger(mean_seconds: float, gen) -> Gen:
    return Stagger(mean_seconds, gen)


def sleep(seconds: float) -> Gen:
    return Sleep(seconds)


def log(message: str) -> Gen:
    return Log(message)


def seq(*gens) -> Gen:
    return Seq(list(gens))


def repeat(fn: Callable) -> Gen:
    return Repeat(fn)


def nemesis_gen(gen) -> Gen:
    return OnNemesis(gen)


def clients_gen(gen) -> Gen:
    return OnClients(gen)


def phases(*gens) -> Phases:
    return Phases(*gens)
