"""Network partitions of the in-process fake cluster.

FakePartitionNemesis is the fake twin of the reference's
nemesis/partition-random-halves (src/jepsen/etcdemo.clj:164): on :start
it splits the nodes into a random minority and majority and isolates the
minority in the FakeKVStore; on :stop it heals. The fake models
reachability as one isolated set, so it can express random halves and a
single isolated node, but not bridge or ring shapes.
"""

from __future__ import annotations

import random

from ..ops.op import Op
from .base import Nemesis


def bisect_nodes(nodes: list[str], rng: random.Random
                 ) -> tuple[list[str], list[str]]:
    """A random minority/majority split (jepsen shuffles, then bisects;
    with n odd the first half is the minority)."""
    shuffled = list(nodes)
    rng.shuffle(shuffled)
    half = len(shuffled) // 2
    return shuffled[:half], shuffled[half:]


class FakePartitionNemesis(Nemesis):
    """Isolate a random minority of the FakeKVStore's nodes, with the real
    partitioner's op surface, so the reference's 5 s on / 5 s off schedule
    (src/jepsen/etcdemo.clj:138-143) runs unchanged."""

    def __init__(self, store, seed: int = 0):
        self.store = store
        self.rng = random.Random(seed)

    def _split(self, nodes: list[str]) -> tuple[list[str], list[str]]:
        """(isolated, rest); subclasses choose differently."""
        return bisect_nodes(nodes, self.rng)

    async def invoke(self, test: dict, op: Op) -> Op:
        if op.f == "start":
            minority, majority = self._split(test["nodes"])
            self.store.isolate(set(minority))
            value = {"isolated": minority, "majority": majority}
        elif op.f == "stop":
            self.store.heal()
            value = "network healed"
        else:
            value = f"unknown nemesis op {op.f}"
        return Op(type="info", f=op.f, value=value, process=op.process)

    async def teardown(self, test: dict) -> None:
        self.store.heal()


class FakeIsolatedNodeNemesis(FakePartitionNemesis):
    """Cut one random node off from the others."""

    def _split(self, nodes: list[str]) -> tuple[list[str], list[str]]:
        victim = self.rng.choice(list(nodes))
        return [victim], [n for n in nodes if n != victim]
