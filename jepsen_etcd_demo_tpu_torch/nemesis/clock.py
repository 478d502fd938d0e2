"""Clock-skew nemeses.

jepsen's nemesis/clock bumps node clocks and resets them on heal. The
harness timestamps histories on the client side, so the fault targets
the clock assumptions of the system under test (leases, TTLs, election
timeouts).

Real cluster: `date -s @<epoch+delta>` over the control plane (su),
recording each node's delta; :stop and teardown apply the inverse delta
to the node's current clock (it kept ticking while skewed, so setting an
absolute time back would lose the time that passed). The strobe variant
swings a minority's clocks back and forth in a short burst.

Fake cluster: the skew is recorded on the in-process store
(`store.clock_skew`), so hermetic runs exercise the same ops; the fake
register is linearizable whatever the clocks say, so verdicts must stay
valid.
"""

from __future__ import annotations

import asyncio
import random

from ..control.runner import runner_for
from ..ops.op import Op
from .base import Nemesis, random_minority


class ClockSkewNemesis(Nemesis):
    """:start skews a random minority's clocks by up to +/- max_skew_s;
    :stop applies the inverse deltas."""

    def __init__(self, seed: int = 0, max_skew_s: float = 60.0):
        self.rng = random.Random(seed)
        self.max_skew_s = max_skew_s
        self.applied: dict[str, float] = {}

    async def _shift(self, test: dict, node: str, delta_s: int) -> bool:
        """Shift the node's clock from its own current time; True iff
        the date command succeeded (a node without CAP_SYS_TIME or sudo
        must not be recorded as skewed, or the heal would skew it)."""
        r = runner_for(test, node)
        res = await r.run(
            f"date -s @$(( $(date +%s) + {delta_s} ))",
            su=True, check=False)
        return res.ok

    async def invoke(self, test: dict, op: Op) -> Op:
        if op.f == "start":
            for node in random_minority(self.rng, test["nodes"]):
                # Whole seconds, drawn once: the value applied, recorded
                # and inverted is the same (the shell would truncate a
                # float the history reported).
                delta = 0
                while delta == 0:
                    delta = self.rng.randint(-int(self.max_skew_s),
                                             int(self.max_skew_s))
                if await self._shift(test, node, delta):
                    self.applied[node] = self.applied.get(node, 0) + delta
            value = {"skewed": dict(self.applied)}
        elif op.f == "stop":
            await self._restore(test)
            value = "clocks restored"
        else:
            value = f"unknown nemesis op {op.f}"
        return Op(type="info", f=op.f, value=value, process=op.process)

    async def _restore(self, test: dict) -> None:
        for node, delta in list(self.applied.items()):
            if await self._shift(test, node, -delta):
                del self.applied[node]

    async def teardown(self, test: dict) -> None:
        await self._restore(test)


class ClockStrobeNemesis(ClockSkewNemesis):
    """jepsen's strobe-clock: swing a minority's clocks (+delta, -delta,
    ...) in a short burst instead of holding one skew, the shape that
    breaks lease and TTL logic that tolerates a constant offset but not
    a clock that will not advance monotonically.

    The burst is one shell program per node, run on the minority side by
    side. It ends by setting the wall clock from the monotonic clock
    (/proc/uptime), t0 + the elapsed monotonic time, under an EXIT trap,
    so an interrupted burst restores too: each `date -s` truncates
    fractions, and a plain balanced loop would leave the clock about
    2 * cycles * period_s behind. A SIGKILL of the remote shell can leave
    the half-cycle in flight skewed, as with jepsen's strobe. `applied`
    stays empty: the program restores itself."""

    def __init__(self, seed: int = 0, max_skew_s: float = 8.0,
                 cycles: int = 20, period_s: float = 0.1):
        super().__init__(seed=seed, max_skew_s=max_skew_s)
        self.cycles = cycles
        self.period_s = period_s

    def _burst_cmd(self, delta: int) -> str:
        return (
            "t0=$(date +%s.%N); m0=$(cut -d' ' -f1 /proc/uptime); "
            "restore() { m1=$(cut -d' ' -f1 /proc/uptime); "
            "date -s @$(awk -v t0=\"$t0\" -v m0=\"$m0\" -v m1=\"$m1\" "
            "'BEGIN{printf \"%.6f\", t0 + (m1 - m0)}') >/dev/null || :; }; "
            # Signals leave through `exit`, so the EXIT trap (the restore)
            # still runs; dash skips it on a bare TERM or HUP.
            "trap restore EXIT; trap 'exit 143' TERM HUP INT; "
            # Any failed set marks the burst failed, so a node without
            # CAP_SYS_TIME is not recorded as strobed (the loop's last
            # sleep would otherwise exit 0).
            f"fail=0; for i in $(seq {self.cycles}); do "
            f"date -s @$(( $(date +%s) + {delta} )) >/dev/null || fail=1; "
            f"sleep {self.period_s}; "
            f"date -s @$(( $(date +%s) - {delta} )) >/dev/null || fail=1; "
            f"sleep {self.period_s}; "
            "done; exit $fail")

    async def invoke(self, test: dict, op: Op) -> Op:
        if op.f != "start":
            return await super().invoke(test, op)
        # The deltas are drawn before the gather, so the rng's order does
        # not depend on how the tasks interleave.
        targets = [(node, self.rng.randint(1, max(1, int(self.max_skew_s))))
                   for node in random_minority(self.rng, test["nodes"])]
        timeout = 60.0 + 4 * self.cycles * self.period_s

        async def burst(node: str, delta: int) -> bool:
            r = runner_for(test, node)
            res = await r.run(self._burst_cmd(delta), su=True, check=False,
                              timeout_s=timeout)
            return res.ok

        # The minority strobes at once, not node after node.
        oks = await asyncio.gather(*(burst(n, d) for n, d in targets))
        value = {"strobed": {n: {"delta_s": d, "cycles": self.cycles}
                             for (n, d), ok in zip(targets, oks) if ok}}
        return Op(type="info", f=op.f, value=value, process=op.process)


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
