"""Txn client of the elle workloads (list-append and rw-register).

The same protocol and error mapping as the register client
(src/jepsen/etcdemo.clj:76-108): a timeout on a txn that may have written
is indeterminate (:info); a read-only txn can safely :fail.
"""

from __future__ import annotations

from ..ops.op import Op
from .base import ClientError, ConnClient, Timeout, completed


class TxnClient(ConnClient):
    """conn_factory(test, node) -> a connection with the transactional
    method named by `method`: txn(mops) for list-append (micro-op
    "append"), txn_register(mops) for rw-register (micro-op "w")."""

    def __init__(self, conn_factory, conn=None, method: str = "txn"):
        super().__init__(conn_factory, conn)
        self.method = method

    async def open(self, test: dict, node: str) -> "TxnClient":
        c = await super().open(test, node)
        c.method = self.method
        return c

    def _check_conn(self, conn) -> None:
        if not hasattr(conn, self.method):
            raise RuntimeError(
                "txn workload requires a transactional connection "
                f"(conn {type(conn).__name__!r} has no {self.method}()); "
                "use --fake or a store with multi-key transactions")

    async def invoke(self, test: dict, op: Op) -> Op:
        if op.f != "txn":
            raise ValueError(f"unknown op f={op.f!r}")
        try:
            done = await getattr(self.conn, self.method)(list(op.value))
            return completed(op, "ok", value=done)
        except Timeout:
            writes = any(m[0] in ("append", "w") for m in op.value)
            return completed(op, "info" if writes else "fail",
                             error="timeout")
        except ClientError as e:
            return completed(op, "fail", error=str(e))
