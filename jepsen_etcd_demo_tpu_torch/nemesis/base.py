"""Nemesis protocol: a special client on the fault plane.

Like jepsen.nemesis, a nemesis has a client's lifecycle (setup / invoke /
teardown) but its ops act on the environment, not the data. The runner
hands it the ops of the nemesis channel ({:f :start}/{:f :stop},
src/jepsen/etcdemo.clj:138-143)."""

from __future__ import annotations

import abc

from ..ops.op import Op


class Nemesis(abc.ABC):
    async def setup(self, test: dict) -> None:
        pass

    @abc.abstractmethod
    async def invoke(self, test: dict, op: Op) -> Op:
        """Execute the fault op; return its completion (:info with a
        description value, as jepsen nemeses do)."""

    async def teardown(self, test: dict) -> None:
        """Must leave the environment healed."""


class NoopNemesis(Nemesis):
    async def invoke(self, test: dict, op: Op) -> Op:
        return Op(type="info", f=op.f, value="noop", process=op.process)


def random_minority(rng, nodes: list) -> list:
    """A random non-empty subset of at most half the nodes, so a quorum
    always survives the fault."""
    n = rng.randrange(1, max(2, len(nodes) // 2 + 1))
    return rng.sample(list(nodes), n)
