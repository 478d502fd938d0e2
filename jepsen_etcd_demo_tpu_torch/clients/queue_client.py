"""Queue-workload client: enqueue / dequeue over independent per-key queues.

It drives the fifo-queue model (models/queues.py). The error mapping
follows the reference client's (src/jepsen/etcdemo.clj:100-105):
  * enqueue timeout       -> :info (indeterminate, like a register write)
  * dequeue timeout       -> :fail (raised only before any claim applied)
  * IndeterminateDequeue  -> :info carrying the claimed value, the one
    indeterminate dequeue the encoder accepts
  * empty queue           -> :fail :empty
"""

from __future__ import annotations

from ..ops.op import Op
from .base import (ClientError, ConnClient, IndeterminateDequeue, NotFound,
                   Timeout, completed)


class QueueClient(ConnClient):
    """conn_factory(test, node) -> an object with async enqueue/dequeue."""

    async def invoke(self, test: dict, op: Op) -> Op:
        k, v = op.value
        try:
            if op.f == "enqueue":
                await self.conn.enqueue(str(k), v)
                return completed(op, "ok")
            if op.f == "dequeue":
                got = await self.conn.dequeue(str(k))
                return completed(op, "ok", value=(k, got))
            raise ValueError(f"unknown op f={op.f!r}")
        except IndeterminateDequeue as e:
            return completed(op, "info", value=(k, e.value),
                             error="timeout")
        except Timeout:
            if op.f == "dequeue":
                return completed(op, "fail", error="timeout")
            return completed(op, "info", error="timeout")
        except NotFound:
            return completed(op, "fail", error="empty")
        except ClientError as e:
            return completed(op, "fail", error=str(e))
