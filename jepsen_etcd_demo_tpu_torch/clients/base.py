"""Client lifecycle protocol, the mirror of jepsen.client/Client.

Five methods, the seam the reference implements at
src/jepsen/etcdemo.clj:78-108: open / setup / invoke / close / teardown.
`invoke` is async (workers are asyncio tasks, jepsen's worker threads)
and returns the completed op.

Completion semantics the checkers depend on (src/jepsen/etcdemo.clj:100-105):
  * a definite failure completes :fail (the op did not happen);
  * an indeterminate failure (a timeout on a write or cas) completes :info:
    the op may have taken effect, and the checker keeps it open forever;
  * a read may complete :fail on timeout, since an unobserved read never
    constrains the model.
"""

from __future__ import annotations

import abc
from typing import Any

from ..ops.op import Op


class ClientError(Exception):
    """Definite failure: the op did not take effect."""


class NotFound(ClientError):
    """Key absent: the reference's etcd errorCode 100 edge
    (src/jepsen/etcdemo.clj:104-105)."""


class RetriesExhausted(ClientError):
    """A client-side retry loop (swap's CAS loop) spent its whole budget
    on determinate failures: no attempt applied, so the op as a whole did
    not take effect (:fail). An indeterminate attempt inside the loop
    raises Timeout out of it instead."""


class ConnectionRefused(ClientError):
    """The connection failed before any request byte was sent: a
    determinate failure, so it maps to :fail, not :info."""


class Timeout(Exception):
    """Indeterminate: the op may or may not have taken effect
    (the SocketTimeoutException edge, src/jepsen/etcdemo.clj:100-102)."""


class IndeterminateDequeue(Timeout):
    """A dequeue that timed out after its claim was applied: the removal
    is indeterminate forever, but the claimed value is known, which makes
    the op encodable as a pending-forever dequeue (models/queues.py)."""

    def __init__(self, value):
        super().__init__(f"indeterminate dequeue of {value!r}")
        self.value = value


class Client(abc.ABC):
    """Per-process client. The runner calls open() for a connected
    instance per logical process, setup() once per run, then invoke() per
    op; close()/teardown() on the way down."""

    async def open(self, test: dict, node: str) -> "Client":
        """Return a client connected to `node` (may be self)."""
        return self

    async def setup(self, test: dict) -> None:
        pass

    @abc.abstractmethod
    async def invoke(self, test: dict, op: Op) -> Op:
        """Execute op, return its completion (type ok/fail/info)."""

    async def close(self, test: dict) -> None:
        pass

    async def teardown(self, test: dict) -> None:
        pass


class ConnClient(Client):
    """A client whose per-process state is one connection from
    conn_factory(test, node). Subclasses implement invoke() (and setup()
    where the workload initialises data)."""

    def __init__(self, conn_factory, conn=None):
        self.conn_factory = conn_factory
        self.conn = conn

    async def open(self, test: dict, node: str) -> "ConnClient":
        conn = self.conn_factory(test, node)
        if hasattr(conn, "__await__"):
            conn = await conn
        self._check_conn(conn)
        return type(self)(self.conn_factory, conn)

    def _check_conn(self, conn) -> None:
        """Hook: fail fast on an incompatible connection."""

    async def close(self, test: dict) -> None:
        close = getattr(self.conn, "close", None)
        if close is not None:
            res = close()
            if hasattr(res, "__await__"):
                await res


def completed(op: Op, type_: str, value: Any = None, error: Any = None) -> Op:
    """The completion record of an invocation."""
    return Op(type=type_, f=op.f,
              value=op.value if value is None else value,
              process=op.process, error=error)
