"""Clock-skew nemesis of the fake cluster.

jepsen's nemesis/clock bumps node clocks and resets them on heal. The
fake twin records the skew on the in-process store (`store.clock_skew`),
so hermetic runs exercise the same ops; the fake register is
linearizable whatever the clocks say, so verdicts must stay valid.
"""

from __future__ import annotations

import random

from ..ops.op import Op
from .base import Nemesis, random_minority


class FakeClockSkewNemesis(Nemesis):
    """:start skews a random minority's clocks by up to +/- max_skew_s;
    :stop clears every skew."""

    def __init__(self, store, seed: int = 0, max_skew_s: float = 60.0):
        self.store = store
        self.rng = random.Random(seed)
        self.max_skew_s = max_skew_s
        if not hasattr(store, "clock_skew"):
            store.clock_skew = {}

    async def invoke(self, test: dict, op: Op) -> Op:
        if op.f == "start":
            for node in random_minority(self.rng, self.store.nodes):
                self.store.clock_skew[node] = self.rng.uniform(
                    -self.max_skew_s, self.max_skew_s)
            value = {"skewed": {k: round(v, 1) for k, v
                                in self.store.clock_skew.items()}}
        elif op.f == "stop":
            self.store.clock_skew.clear()
            value = "clocks restored"
        else:
            value = f"unknown nemesis op {op.f}"
        return Op(type="info", f=op.f, value=value, process=op.process)

    async def teardown(self, test: dict) -> None:
        self.store.clock_skew.clear()
