"""Process faults: kill and restart, pause and resume the DB daemon.

Beyond the reference demo, which only partitions, but of the jepsen
nemesis family (SURVEY.md §5.3: "partition first (same semantics), then
kill/pause")."""

from __future__ import annotations

import random

from ..control.runner import runner_for
from ..ops.op import Op
from .base import Nemesis, random_minority


class KillNemesis(Nemesis):
    """:start kills the DB daemon on a random minority; :stop restarts
    it."""

    def __init__(self, db, seed: int = 0):
        self.db = db
        self.rng = random.Random(seed)
        self.killed: list[str] = []

    async def invoke(self, test: dict, op: Op) -> Op:
        if op.f == "start":
            self.killed = random_minority(self.rng, test["nodes"])
            for node in self.killed:
                # Both legs go through the DB protocol (db.kill and
                # db.start), so any DB that implements them is killable.
                await self.db.kill(test, runner_for(test, node), node)
            value = {"killed": self.killed}
        elif op.f == "stop":
            for node in self.killed:
                # start, not setup: the binary and data dir survived the
                # kill, and a reinstall would only stretch the outage
                # (jepsen's db/kill! restart leg).
                await self.db.start(test, runner_for(test, node), node)
            value = {"restarted": self.killed}
            self.killed = []
        else:
            value = f"unknown nemesis op {op.f}"
        return Op(type="info", f=op.f, value=value, process=op.process)

    async def teardown(self, test: dict) -> None:
        pass


class PauseNemesis(Nemesis):
    """:start SIGSTOPs the daemon on a random minority; :stop SIGCONTs.

    `pidfile` is a path or a node -> path function: nodes sharing a host
    (db/etcd.py PORT_MAP) have pidfiles of their own, and a pause aimed
    at the shared path would hit nothing while the history recorded the
    fault."""

    def __init__(self, pidfile, seed: int = 0):
        self.pidfile = pidfile
        self.rng = random.Random(seed)
        self.paused: list[str] = []

    def _pidfile(self, node: str) -> str:
        return self.pidfile(node) if callable(self.pidfile) \
            else self.pidfile

    async def _signal(self, test: dict, node: str, sig: str) -> None:
        await runner_for(test, node).run(
            f"kill -{sig} $(cat {self._pidfile(node)})", su=True,
            check=False)

    async def invoke(self, test: dict, op: Op) -> Op:
        if op.f == "start":
            self.paused = random_minority(self.rng, test["nodes"])
            for node in self.paused:
                await self._signal(test, node, "STOP")
            value = {"paused": self.paused}
        elif op.f == "stop":
            for node in self.paused:
                await self._signal(test, node, "CONT")
            value = {"resumed": self.paused}
            self.paused = []
        else:
            value = f"unknown nemesis op {op.f}"
        return Op(type="info", f=op.f, value=value, process=op.process)

    async def teardown(self, test: dict) -> None:
        for node in self.paused:
            await self._signal(test, node, "CONT")
