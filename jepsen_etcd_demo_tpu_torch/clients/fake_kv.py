"""Hermetic in-process KV "cluster" with injectable consistency bugs.

The reference needs a real 5-node etcd cluster for every run. This fake
replicated store exposes the calls the demo makes through
verschlimmbesserung (get/reset/cas/swap, src/jepsen/etcdemo.clj:79-98,
set.clj:13-29), plus transactions and queues for the other workloads, and
the fault hooks the fake nemeses drive, so the whole pipeline (generator
-> client -> history -> checker) runs without a cluster.

Fault model:
  * Partition: the store keeps a set of isolated nodes. An op through an
    isolated node times out; a write-like op may still land first (with
    `partial_apply_prob`), which exercises the :info open-forever path.
  * Injectable bugs, to prove the checkers detect them:
      stale_read_prob         - non-quorum reads may return a stale
                                snapshot (quorum reads stay linearizable,
                                etcd's q=true, src/jepsen/etcdemo.clj:88)
      lost_write_prob         - acknowledged writes that never took effect
      duplicate_cas_prob      - a CAS acknowledged :fail that applied
      reorder_prob            - a dequeue pops a random position
      duplicate_delivery_prob - a dequeue returns the head without
                                removing it

Every random draw comes from one seeded `random.Random`, in the JAX
package's order, so one seed and one invocation script give the same
completions.
"""

from __future__ import annotations

import asyncio
import random
from typing import Any, Optional

from .base import (IndeterminateDequeue, NotFound, RetriesExhausted,
                   Timeout)


class FakeKVStore:
    """The simulated cluster: one logical linearizable map, plus a bounded
    list of past snapshots for stale reads."""

    def __init__(self, nodes: Optional[list[str]] = None,
                 seed: int = 0,
                 stale_read_prob: float = 0.0,
                 lost_write_prob: float = 0.0,
                 duplicate_cas_prob: float = 0.0,
                 reorder_prob: float = 0.0,
                 duplicate_delivery_prob: float = 0.0,
                 partial_apply_prob: float = 0.5,
                 op_delay_s: float = 0.0):
        self.nodes = nodes or ["n1", "n2", "n3", "n4", "n5"]
        self.data: dict[str, Any] = {}
        self.queues: dict[str, list[Any]] = {}
        self.snapshots: list[dict[str, Any]] = []
        self.isolated: set[str] = set()
        self.rng = random.Random(seed)
        self.stale_read_prob = stale_read_prob
        self.lost_write_prob = lost_write_prob
        self.duplicate_cas_prob = duplicate_cas_prob
        self.reorder_prob = reorder_prob
        self.duplicate_delivery_prob = duplicate_delivery_prob
        self.partial_apply_prob = partial_apply_prob
        self.op_delay_s = op_delay_s
        # A store lives for one test run, so this lock never outlives the
        # event loop of that run.
        self.lock = asyncio.Lock()

    # -- fault hooks (driven by the fake nemeses) -------------------------
    def isolate(self, nodes: set[str]):
        self.isolated = set(nodes)

    def heal(self):
        self.isolated = set()

    def _snapshot(self):
        self.snapshots.append(dict(self.data))
        if len(self.snapshots) > 64:
            self.snapshots.pop(0)

    async def _enter(self, node: str):
        if self.op_delay_s:
            await asyncio.sleep(self.op_delay_s * self.rng.random())
        if node in self.isolated:
            raise Timeout(f"node {node} partitioned")

    async def _done(self):
        if self.op_delay_s:
            await asyncio.sleep(self.op_delay_s * self.rng.random())

    def _maybe_timeout(self, node: str) -> bool:
        """True when `node` is isolated and the op goes ahead (to time out
        after applying); raises Timeout when it is isolated and the op
        does not apply."""
        maybe_timeout = node in self.isolated
        if maybe_timeout and self.rng.random() >= self.partial_apply_prob:
            raise Timeout(f"node {node} partitioned")
        return maybe_timeout

    # -- the register surface ---------------------------------------------
    async def get(self, node: str, key: str, quorum: bool = False) -> Any:
        await self._enter(node)
        async with self.lock:
            if (not quorum and self.snapshots
                    and self.rng.random() < self.stale_read_prob):
                snap = self.rng.choice(self.snapshots)
                return snap.get(key)
            return self.data.get(key)

    async def reset(self, node: str, key: str, value: Any) -> None:
        maybe_timeout = self._maybe_timeout(node)
        async with self.lock:
            self._snapshot()
            if self.rng.random() >= self.lost_write_prob:
                self.data[key] = value
        if maybe_timeout:
            raise Timeout(f"node {node} partitioned (op applied)")
        await self._done()

    async def cas(self, node: str, key: str, old: Any, new: Any) -> bool:
        maybe_timeout = self._maybe_timeout(node)
        async with self.lock:
            if key not in self.data:
                raise NotFound(key)
            applied = self.data[key] == old
            if applied:
                self._snapshot()
                # Lost-update bug: acknowledge but drop the update.
                if self.rng.random() >= self.lost_write_prob:
                    self.data[key] = new
            elif self.rng.random() < self.duplicate_cas_prob:
                self._snapshot()
                self.data[key] = new  # bug: acknowledged :fail, applied
        if maybe_timeout:
            raise Timeout(f"node {node} partitioned (op applied)")
        await self._done()
        return applied

    async def swap(self, node: str, key: str, fn) -> Any:
        """Atomic read-modify-write retry loop: verschlimmbesserung's swap!
        (set.clj:26-31 adds to the set with it)."""
        for _ in range(64):
            await self._enter(node)
            async with self.lock:
                if key not in self.data:
                    raise NotFound(key)
                cur = self.data[key]
            new = fn(cur)
            if await self.cas(node, key, cur, new):
                return new
        raise RetriesExhausted(
            "swap retry budget exhausted: 64 determinate CAS failures")

    # -- transactions (the elle workloads) --------------------------------
    async def txn(self, node: str, mops: list) -> list:
        """Atomic multi-key list-append transaction. Micro-ops:
        ("append", k, v) appends v to the list under k; ("r", k, None)
        reads it. lost_write_prob drops an acknowledged append,
        stale_read_prob serves a read from an old snapshot; a txn always
        reads its own earlier appends."""
        maybe_timeout = self._maybe_timeout(node)
        out = []
        written: set = set()
        async with self.lock:
            self._snapshot()
            for mop in mops:
                f, k, v = mop
                if f == "append":
                    if self.rng.random() >= self.lost_write_prob:
                        cur = self.data.get(k)
                        cur = () if not isinstance(cur, tuple) else cur
                        self.data[k] = cur + (v,)
                    written.add(k)
                    out.append(("append", k, v))
                elif f == "r":
                    src = self.data
                    if (k not in written and self.snapshots
                            and self.rng.random() < self.stale_read_prob):
                        src = self.rng.choice(self.snapshots)
                    cur = src.get(k)
                    cur = () if not isinstance(cur, tuple) else cur
                    out.append(("r", k, cur))
                else:
                    raise ValueError(f"unknown micro-op {f!r}")
        if maybe_timeout:
            raise Timeout(f"node {node} partitioned (txn applied)")
        await self._done()
        return out

    async def txn_register(self, node: str, mops: list) -> list:
        """Atomic multi-key register transaction (elle's rw-register).
        Micro-ops: ("w", k, v) writes register k; ("r", k, None) reads it
        (None = the initial nil). The same injected bugs as txn(), and the
        same read-your-writes, even of a write the store loses."""
        maybe_timeout = self._maybe_timeout(node)
        out = []
        overlay: dict = {}
        async with self.lock:
            self._snapshot()
            for mop in mops:
                f, k, v = mop
                if f == "w":
                    if self.rng.random() >= self.lost_write_prob:
                        self.data[k] = v
                    overlay[k] = v
                    out.append(("w", k, v))
                elif f == "r":
                    if k in overlay:
                        out.append(("r", k, overlay[k]))
                        continue
                    src = self.data
                    if (self.snapshots
                            and self.rng.random() < self.stale_read_prob):
                        src = self.rng.choice(self.snapshots)
                    out.append(("r", k, src.get(k)))
                else:
                    raise ValueError(f"unknown register micro-op {f!r}")
        if maybe_timeout:
            raise Timeout(f"node {node} partitioned (txn applied)")
        await self._done()
        return out

    # -- queues (the queue workload) --------------------------------------
    async def enqueue(self, node: str, key: str, value: Any) -> None:
        """Append to the queue under `key`; under a partition the op may
        land and then time out, as reset() does."""
        maybe_timeout = self._maybe_timeout(node)
        async with self.lock:
            self.queues.setdefault(key, []).append(value)
        if maybe_timeout:
            raise Timeout(f"node {node} partitioned (op applied)")
        await self._done()

    async def dequeue(self, node: str, key: str) -> Any:
        """Pop the queue head. Under a partition the pop may happen with
        its acknowledgement lost (IndeterminateDequeue, carrying the
        claimed element), else a plain Timeout before any effect.
        reorder_prob pops a random position, duplicate_delivery_prob
        returns the head without removing it."""
        maybe_timeout = self._maybe_timeout(node)
        async with self.lock:
            q = self.queues.get(key)
            if not q:
                if maybe_timeout:
                    raise Timeout(f"node {node} partitioned")
                raise NotFound(key)
            i = (self.rng.randrange(len(q))
                 if self.rng.random() < self.reorder_prob else 0)
            if self.rng.random() < self.duplicate_delivery_prob:
                got = q[i]
            else:
                got = q.pop(i)
        if maybe_timeout:
            raise IndeterminateDequeue(got)
        await self._done()
        return got
