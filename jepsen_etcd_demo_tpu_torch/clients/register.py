"""Register-workload clients: read / write / cas over a KV connection.

The mirror of the reference's Client record (src/jepsen/etcdemo.clj:76-108)
with its error mapping:
  * timeout on read        -> :fail (:error :timeout)     [:100-102]
  * timeout on write/cas   -> :info (indeterminate)       [:100-102]
  * key missing (etcd 100) -> :fail (:error :not-found)   [:104-105]
  * cas returned false     -> :fail                       [:95-98]
  * connection refused     -> :fail (the request never left)

Values are (key, value) independent tuples (:84, :90); reads parse the
stored string to an int, None for a missing key (:71-74, :87-90).
"""

from __future__ import annotations

from typing import Optional

from ..ops.op import Op
from .base import ClientError, ConnClient, NotFound, Timeout, completed


def parse_long(s: Optional[str]):
    """nil-passing string -> int (the reference's parse-long, :71-74)."""
    return None if s is None else int(s)


def _failed(op: Op, exc: Exception) -> Op:
    """The shared error mapping of the register clients."""
    if isinstance(exc, Timeout):
        if op.f == "read":
            return completed(op, "fail", error="timeout")
        return completed(op, "info", error="timeout")
    if isinstance(exc, NotFound):
        return completed(op, "fail", error="not-found")
    return completed(op, "fail", error=str(exc))


class RegisterClient(ConnClient):
    """conn_factory(test, node) -> an object with async get/reset/cas."""

    async def invoke(self, test: dict, op: Op) -> Op:
        k, v = op.value
        try:
            if op.f == "read":
                raw = await self.conn.get(str(k),
                                          quorum=bool(test.get("quorum")))
                return completed(op, "ok", value=(k, parse_long(raw)))
            if op.f == "write":
                await self.conn.reset(str(k), str(v))
                return completed(op, "ok")
            if op.f == "cas":
                old, new = v
                ok = await self.conn.cas(str(k), str(old), str(new))
                return completed(op, "ok" if ok else "fail")
            raise ValueError(f"unknown op f={op.f!r}")
        except (Timeout, ClientError) as e:
            return _failed(op, e)


class MultiRegisterClient(ConnClient):
    """Whole-store client of the multi-register workload: read (i, None)
    -> (i, v) and write (i, v) address register i of a small register
    file, stored under KV keys "r<i>". The values are not independent-key
    tuples: the whole run is one history against the multi-register
    model, so ordering across registers is checked too."""

    async def invoke(self, test: dict, op: Op) -> Op:
        i, v = op.value
        try:
            if op.f == "read":
                raw = await self.conn.get(f"r{i}",
                                          quorum=bool(test.get("quorum")))
                return completed(op, "ok", value=(i, parse_long(raw)))
            if op.f == "write":
                await self.conn.reset(f"r{i}", str(v))
                return completed(op, "ok")
            raise ValueError(f"unknown op f={op.f!r}")
        except (Timeout, ClientError) as e:
            return _failed(op, e)


class _BoundFakeConn:
    """A FakeKVStore bound to one node."""

    def __init__(self, store, node: str):
        self.store = store
        self.node = node

    async def get(self, key, quorum=False):
        return await self.store.get(self.node, key, quorum=quorum)

    async def reset(self, key, value):
        return await self.store.reset(self.node, key, value)

    async def cas(self, key, old, new):
        return await self.store.cas(self.node, key, old, new)

    async def swap(self, key, fn):
        return await self.store.swap(self.node, key, fn)

    async def txn(self, mops):
        return await self.store.txn(self.node, mops)

    async def txn_register(self, mops):
        return await self.store.txn_register(self.node, mops)

    async def enqueue(self, key, value):
        return await self.store.enqueue(self.node, key, value)

    async def dequeue(self, key):
        return await self.store.dequeue(self.node, key)


def fake_conn_factory(store):
    def factory(test, node):
        return _BoundFakeConn(store, node)
    return factory
