"""The scenario factory's cluster fault planes: membership churn, disk
faults and lease skew. All three act on the in-process minietcd cluster
(campaign/cluster.MiniCluster), the campaign's live backend, through the
Nemesis protocol, so the composition schedules them as it schedules the
partition, kill and pause nemeses.

Each plane carries a bug of its own that the checker must falsify:

  * MemberChurnNemesis: healthy churn (standby members spawned and torn
    down over the shared store) stays linearizable; fork=True boots the
    standby from a copy of the store, a stale replica whose reads
    falsify.
  * DiskFaultNemesis: arms the KeyStore's env-gated persistence fault
    (db/minietcd.py): "disk-full" acks writes that never reach the
    snapshot, "corrupt-write" garbles the last value on its way to disk.
    :stop restarts the storage plane from disk, which brings the lost or
    invented state to the clients. The env gate is set for the fault
    window only and always restored.
  * LeaseSkewNemesis: gives a minority of members a frozen read lease
    (a leaseholder whose clock is off): their non-quorum reads answer
    from the old snapshot until :stop revokes it. Quorum reads pass the
    lease by, as etcd's q=true reads do.

The JAX package also records an `obs` fault event at each step; the port
has no span tracer.
"""

from __future__ import annotations

import os
import random

from ..db.minietcd import FAULT_HOOK_ENV
from ..ops.op import Op
from .base import Nemesis, random_minority


class MemberChurnNemesis(Nemesis):
    """:start tears down a random minority of members and spawns one
    standby in the place of each; :stop restores the membership. `fork`
    makes every spawned standby a stale replica."""

    def __init__(self, cluster, seed: int = 0, fork: bool = False):
        self.cluster = cluster
        self.rng = random.Random(seed)
        self.fork = fork
        self.churned: list[str] = []

    async def invoke(self, test: dict, op: Op) -> Op:
        if op.f == "start":
            self.churned = random_minority(self.rng,
                                           self.cluster.members())
            for node in self.churned:
                self.cluster.teardown_member(node)
                # The standby: the same node name, a fresh frontend.
                self.cluster.spawn_member(node, fork=self.fork)
            value = {"churned": self.churned, "fork": self.fork}
        elif op.f == "stop":
            for node in self.churned:
                # Heal: a faithful member over the shared store.
                self.cluster.spawn_member(node, fork=False)
            value = {"restored": self.churned}
            self.churned = []
        else:
            value = f"unknown nemesis op {op.f}"
        return Op(type="info", f=op.f, value=value, process=op.process)

    async def teardown(self, test: dict) -> None:
        for node in self.churned:
            self.cluster.spawn_member(node, fork=False)
        self.churned = []


class DiskFaultNemesis(Nemesis):
    """:start arms the KeyStore's persistence fault ("disk-full" or
    "corrupt-write") behind its env gate; :stop restarts the storage
    plane from disk and disarms it."""

    def __init__(self, cluster, mode: str = "disk-full", seed: int = 0):
        self.cluster = cluster
        self.mode = mode
        self.rng = random.Random(seed)
        self._env_prev: str | None = None
        self._armed = False

    def _arm(self) -> None:
        if not self._armed:
            self._env_prev = os.environ.get(FAULT_HOOK_ENV)
            os.environ[FAULT_HOOK_ENV] = "1"
            self._armed = True
        self.cluster.store.fault_mode = self.mode

    def _disarm(self) -> None:
        self.cluster.store.fault_mode = None
        if self._armed:
            if self._env_prev is None:
                os.environ.pop(FAULT_HOOK_ENV, None)
            else:
                os.environ[FAULT_HOOK_ENV] = self._env_prev
            self._armed = False

    async def invoke(self, test: dict, op: Op) -> Op:
        if op.f == "start":
            self._arm()
            value = {"disk_fault": self.mode}
        elif op.f == "stop":
            injected = self.cluster.store.faults_injected
            # Restart before disarming: restart_from_disk carries the
            # armed mode over to the fresh store, so a client write
            # racing this :stop cannot persist a healthy snapshot in
            # between and heal what the restart is there to show.
            self.cluster.restart_from_disk()
            self._disarm()
            value = {"restarted_after": self.mode, "injected": injected}
        else:
            value = f"unknown nemesis op {op.f}"
        return Op(type="info", f=op.f, value=value, process=op.process)

    async def teardown(self, test: dict) -> None:
        self._disarm()


class LeaseSkewNemesis(Nemesis):
    """:start freezes a read lease on a random minority of members, which
    then serve non-quorum reads from the old snapshot; :stop revokes
    every lease."""

    def __init__(self, cluster, seed: int = 0):
        self.cluster = cluster
        self.rng = random.Random(seed)
        self.leased: list[str] = []

    async def invoke(self, test: dict, op: Op) -> Op:
        if op.f == "start":
            self.leased = random_minority(self.rng,
                                          self.cluster.members())
            for node in self.leased:
                self.cluster.grant_lease(node)
            value = {"leased": self.leased}
        elif op.f == "stop":
            self.cluster.revoke_leases()
            value = {"revoked": self.leased}
            self.leased = []
        else:
            value = f"unknown nemesis op {op.f}"
        return Op(type="info", f=op.f, value=value, process=op.process)

    async def teardown(self, test: dict) -> None:
        self.cluster.revoke_leases()
        self.leased = []
