"""Network partitions.

PartitionRandomHalves is the reference's nemesis/partition-random-halves
(src/jepsen/etcdemo.clj:164): on :start it splits the nodes into a random
minority and majority and drops the traffic between them with iptables
over the control plane; on :stop it heals. The rest of jepsen.nemesis's
partition family runs on the same machinery with another "grudge" (node
-> the nodes it still reaches):

  * PartitionIsolatedNode: one random node cut off from every other;
  * PartitionBridge: two halves that cannot see each other and one
    bridge node both see (raft must not count it toward both quorums);
  * PartitionMajoritiesRing: every node sees a majority, no two nodes
    the same one (symmetric ring windows of the least radius that holds
    a majority), the classic raft split-brain shape.

FakePartitionNemesis and FakeIsolatedNodeNemesis do the first two to the
in-process FakeKVStore, which models reachability as one isolated set
and so cannot express the bridge or the ring.
"""

from __future__ import annotations

import random
from typing import Optional

from ..control.runner import runner_for
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


def random_halves(nodes: list[str], rng: random.Random
                  ) -> dict[str, list[str]]:
    """Each node -> the nodes it still reaches."""
    minority, majority = bisect_nodes(nodes, rng)
    reach = {}
    for n in minority:
        reach[n] = list(minority)
    for n in majority:
        reach[n] = list(majority)
    return reach


def isolated_node_grudge(nodes: list[str], rng: random.Random
                         ) -> dict[str, list[str]]:
    """One random node cut off from every peer."""
    victim = rng.choice(list(nodes))
    reach = {n: [p for p in nodes if p != victim] for n in nodes
             if n != victim}
    reach[victim] = [victim]
    return reach


def bridge_grudge(nodes: list[str], rng: random.Random
                  ) -> dict[str, list[str]]:
    """Two halves that cannot see each other; one bridge node sees, and
    is seen by, everyone. Needs n >= 3."""
    if len(nodes) < 3:
        raise ValueError("bridge partition needs >= 3 nodes")
    shuffled = list(nodes)
    rng.shuffle(shuffled)
    bridge = shuffled[0]
    rest = shuffled[1:]
    half = len(rest) // 2
    a, b = rest[:half], rest[half:]
    reach = {bridge: list(nodes)}
    for n in a:
        reach[n] = a + [bridge]
    for n in b:
        reach[n] = b + [bridge]
    return reach


def majorities_ring_grudge(nodes: list[str], rng: random.Random
                           ) -> dict[str, list[str]]:
    """Every node sees a majority; neighbours on the ring see shifted,
    overlapping majorities. The radius is the least h with 2h+1 >=
    majority(n); for n <= 3 the window is every node and nothing is cut
    (jepsen's edge too)."""
    ring = list(nodes)
    rng.shuffle(ring)
    n = len(ring)
    majority = n // 2 + 1
    h = (majority - 1 + 1) // 2        # ceil((majority-1)/2)
    reach = {}
    for i, node in enumerate(ring):
        reach[node] = sorted({ring[(i + d) % n]
                              for d in range(-h, h + 1)})
    return reach


class GrudgePartitioner(Nemesis):
    """An iptables partition over SSH, like jepsen's partitioner: :start
    computes a reachability map (the grudge) and drops every pair it
    cuts, on both ends; :stop flushes the rules. Subclasses pick the
    grudge."""

    #: grudge(nodes, rng) -> {node: reachable nodes (itself included)}
    grudge = staticmethod(random_halves)

    def __init__(self, seed: int = 0):
        self.rng = random.Random(seed)
        self.active: Optional[dict[str, list[str]]] = None

    async def setup(self, test: dict) -> None:
        await self._heal(test)

    async def invoke(self, test: dict, op: Op) -> Op:
        if op.f == "start":
            reach = type(self).grudge(test["nodes"], self.rng)
            await self._partition(test, reach)
            self.active = reach
            value = self.describe(reach)
        elif op.f == "stop":
            await self._heal(test)
            self.active = None
            value = "network healed"
        else:
            value = f"unknown nemesis op {op.f}"
        return Op(type="info", f=op.f, value=value, process=op.process)

    def describe(self, reach: dict[str, list[str]]):
        """The :info value recorded in the history."""
        return {"reachable": reach}

    async def teardown(self, test: dict) -> None:
        await self._heal(test)

    async def _partition(self, test: dict,
                         reach: dict[str, list[str]]) -> None:
        # Drop INPUT on both ends of every cut pair, so the cut stays
        # symmetric even if one side's rules fail to land.
        for node in test["nodes"]:
            r = runner_for(test, node)
            reachable = set(reach.get(node, [])) | {node}
            for peer in test["nodes"]:
                if peer != node and peer not in reachable:
                    await r.run(
                        f"iptables -A INPUT -s {peer} -j DROP -w", su=True,
                        check=False)

    async def _heal(self, test: dict) -> None:
        for node in test["nodes"]:
            r = runner_for(test, node)
            await r.run("iptables -F -w && iptables -X -w", su=True,
                        check=False)


class PartitionRandomHalves(GrudgePartitioner):
    """The reference's shape (src/jepsen/etcdemo.clj:164)."""

    grudge = staticmethod(random_halves)

    def describe(self, reach):
        # The history value the fake twin records too: isolated/majority.
        sides = sorted({frozenset(v) for v in reach.values()},
                       key=lambda s: (len(s), sorted(s)))
        if len(sides) == 1:               # n < 2: nothing is cut
            return {"isolated": [], "majority": sorted(sides[0])}
        return {"isolated": sorted(sides[0]),
                "majority": sorted(sides[-1])}


class PartitionIsolatedNode(GrudgePartitioner):
    grudge = staticmethod(isolated_node_grudge)

    def describe(self, reach):
        victim = next(n for n, v in reach.items() if v == [n])
        return {"isolated": [victim],
                "majority": sorted(n for n in reach if n != victim)}


class PartitionBridge(GrudgePartitioner):
    grudge = staticmethod(bridge_grudge)

    def describe(self, reach):
        bridge = max(reach, key=lambda n: len(reach[n]))
        return {"bridge": bridge, "reachable": reach}


class PartitionMajoritiesRing(GrudgePartitioner):
    grudge = staticmethod(majorities_ring_grudge)


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
