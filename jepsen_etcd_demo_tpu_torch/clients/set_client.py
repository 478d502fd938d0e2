"""Grow-only-set client: concurrent adds to one key, one final read.

The mirror of the reference SetClient (src/jepsen/etcdemo/set.clj:10-40):
one fixed key holds a serialized set; setup initialises it to the empty
set (:15-16); :add conj's through the connection's atomic swap (:26-31);
:read parses the stored set (:21-24). The set is stored as a sorted JSON
list, as the JAX package stores it.
"""

from __future__ import annotations

import json

from ..ops.op import Op
from .base import ClientError, ConnClient, NotFound, Timeout, completed

SET_KEY = "a-set"


def _dumps(s: set) -> str:
    return json.dumps(sorted(s))


def _loads(raw: str) -> set:
    return set(json.loads(raw))


async def init_key(conn, key: str, value: str, what: str) -> None:
    """Write `value` under `key` and read it back, retrying: setup must
    succeed even against a store with injected lost writes."""
    for _ in range(16):
        await conn.reset(key, value)
        if await conn.get(key, quorum=True) is not None:
            return
    raise RuntimeError(f"setup could not initialize the {what}")


class SetClient(ConnClient):
    async def setup(self, test: dict) -> None:
        await init_key(self.conn, SET_KEY, _dumps(set()), "set key")

    async def invoke(self, test: dict, op: Op) -> Op:
        try:
            if op.f == "read":
                raw = await self.conn.get(SET_KEY,
                                          quorum=bool(test.get("quorum")))
                if raw is None:
                    return completed(op, "fail", error="not-found")
                return completed(op, "ok", value=sorted(_loads(raw)))
            if op.f == "add":
                await self.conn.swap(
                    SET_KEY, lambda raw: _dumps(_loads(raw) | {op.value}))
                return completed(op, "ok")
            raise ValueError(f"unknown op f={op.f!r}")
        except Timeout:
            if op.f == "read":
                return completed(op, "fail", error="timeout")
            return completed(op, "info", error="timeout")
        except NotFound:
            return completed(op, "fail", error="not-found")
        except ClientError as e:
            return completed(op, "fail", error=str(e))
