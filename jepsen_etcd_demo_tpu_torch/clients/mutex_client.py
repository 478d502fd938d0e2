"""Mutex-workload client: acquire / release a distributed lock.

It drives the mutex model (models/mutex.py). The lock is a CAS register
on the store (acquire = cas 0 -> 1, release = cas 1 -> 0, the model's
own translation). A CAS that returned false is :fail; a timeout is :info
(the lock may have been taken or released).
"""

from __future__ import annotations

from ..ops.op import Op
from .base import ClientError, ConnClient, NotFound, Timeout, completed
from .set_client import init_key

LOCK_KEY = "a-lock"
UNLOCKED, LOCKED = "0", "1"


class MutexClient(ConnClient):
    """conn_factory(test, node) -> an object with async get/reset/cas."""

    async def setup(self, test: dict) -> None:
        await init_key(self.conn, LOCK_KEY, UNLOCKED, "lock")

    async def invoke(self, test: dict, op: Op) -> Op:
        try:
            if op.f == "acquire":
                ok = await self.conn.cas(LOCK_KEY, UNLOCKED, LOCKED)
            elif op.f == "release":
                ok = await self.conn.cas(LOCK_KEY, LOCKED, UNLOCKED)
            else:
                raise ValueError(f"unknown op f={op.f!r}")
            return completed(op, "ok" if ok else "fail")
        except Timeout:
            return completed(op, "info", error="timeout")
        except NotFound:
            return completed(op, "fail", error="not-found")
        except ClientError as e:
            return completed(op, "fail", error=str(e))
