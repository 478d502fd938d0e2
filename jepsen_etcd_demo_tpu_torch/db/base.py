"""DB lifecycle protocol, the mirror of jepsen.db/DB + db/LogFiles.

The reference reifies both at src/jepsen/etcdemo.clj:30-65: setup installs
and starts the database on one node, teardown stops and wipes it,
log_files names remote logs to collect into the store."""

from __future__ import annotations

import abc

from ..control.runner import Runner


class DB(abc.ABC):
    @abc.abstractmethod
    async def setup(self, test: dict, r: Runner, node: str) -> None:
        ...

    @abc.abstractmethod
    async def teardown(self, test: dict, r: Runner, node: str) -> None:
        ...

    def log_files(self, test: dict, node: str) -> list[str]:
        return []
