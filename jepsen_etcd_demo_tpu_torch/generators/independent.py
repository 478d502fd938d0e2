"""jepsen.independent's concurrent-generator.

The reference spreads a single-key workload over many independent keys:
`independent/concurrent-generator 10 (range) (fn [k] ...)` - 10 worker
threads per key, each key's generator limited to :ops-per-key, groups
moving to a fresh key when theirs exhausts (src/jepsen/etcdemo.clj:120-125).
Emitted values become (key, value) tuples (:90), which
`IndependentChecker` splits per key: the batch axis of the check.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, Optional

from ..ops.op import Op
from .core import NEMESIS, Gen, GenContext, NextResult, Pending, lift


class tuple_gen(Gen):
    """Wrap a generator so each emitted op's value becomes (key, value)."""

    def __init__(self, key, gen):
        self.key = key
        self.gen = lift(gen)

    def next_for(self, ctx: GenContext) -> NextResult:
        out = self.gen.next_for(ctx)
        if isinstance(out, Op):
            out.value = (self.key, out.value)
        return out


class ConcurrentGenerator(Gen):
    """n workers per key; worker groups take keys from one shared stream.

    Group g = thread // n. Each group holds its own sub-generator
    (fn(key), tuple-wrapped); when it exhausts, the group takes the next
    key. Nemesis askers always see Pending: this feeds clients only."""

    def __init__(self, n: int, keys: Iterable, fn: Callable[[Any], Any]):
        if n <= 0:
            raise ValueError("n must be positive")
        self.n = n
        self.keys: Iterator = iter(keys)
        self.fn = fn
        self.group_gens: dict[int, Optional[Gen]] = {}
        self.exhausted_keys = False

    def _fresh(self) -> Optional[Gen]:
        try:
            key = next(self.keys)
        except StopIteration:
            self.exhausted_keys = True
            return None
        return tuple_gen(key, self.fn(key))

    def next_for(self, ctx: GenContext) -> NextResult:
        if ctx.process == NEMESIS:
            return Pending(None)
        # A process reincarnates as p + concurrency after an :info crash;
        # the group belongs to the worker thread, as in jepsen.
        conc = (ctx.test or {}).get("concurrency")
        thread = int(ctx.process) % int(conc) if conc else int(ctx.process)
        group = thread // self.n
        if group not in self.group_gens:
            self.group_gens[group] = self._fresh()
        while True:
            gen = self.group_gens[group]
            if gen is None:
                return None
            out = gen.next_for(ctx)
            if out is not None:
                return out
            self.group_gens[group] = self._fresh()


def concurrent_generator(n: int, keys: Iterable,
                         fn: Callable[[Any], Any]) -> Gen:
    return ConcurrentGenerator(n, keys, fn)
