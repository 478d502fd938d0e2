"""Fault-injection (nemesis) layer: the jepsen.nemesis equivalent, driven
by :start/:stop ops on the nemesis generator channel
(src/jepsen/etcdemo.clj:138-143) and healed in the final phase (:170-171).

The real cluster's nemeses (the iptables partition family, kill, pause,
clock skew and strobe) act through the control plane; the fake twins of
the partition, isolated-node and clock nemeses act on the in-process
fake cluster."""

from .base import Nemesis, NoopNemesis  # noqa: F401
from .clock import (ClockSkewNemesis, ClockStrobeNemesis,  # noqa: F401
                    FakeClockSkewNemesis)
from .partition import (  # noqa: F401
    FakeIsolatedNodeNemesis, FakePartitionNemesis, GrudgePartitioner,
    PartitionBridge, PartitionIsolatedNode, PartitionMajoritiesRing,
    PartitionRandomHalves, bisect_nodes, random_halves,
)
from .process_faults import KillNemesis, PauseNemesis  # noqa: F401
