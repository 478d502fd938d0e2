"""Fault-injection (nemesis) layer: the jepsen.nemesis equivalent, driven
by :start/:stop ops on the nemesis generator channel
(src/jepsen/etcdemo.clj:138-143) and healed in the final phase (:170-171).

Only the nemeses of the fake cluster are ported (partition,
partition-node, clock, noop); the iptables, kill, pause and strobe
nemeses of the real-cluster path are not."""

from .base import Nemesis, NoopNemesis  # noqa: F401
from .clock import FakeClockSkewNemesis  # noqa: F401
from .partition import (FakeIsolatedNodeNemesis,  # noqa: F401
                        FakePartitionNemesis, bisect_nodes)
