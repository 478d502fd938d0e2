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

    async def start(self, test: dict, r: Runner, node: str) -> None:
        """Restart a stopped daemon without reinstalling: the restart leg
        of jepsen's db/kill! cycle (the binary and data dir are still on
        the node). By default a whole setup."""
        await self.setup(test, r, node)

    async def kill(self, test: dict, r: Runner, node: str) -> None:
        """Kill the daemon, leaving the install and data in place (the
        kill leg of db/kill!; start() is its inverse). The kill nemesis
        drives both legs through this protocol."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement kill(); the kill "
            f"nemesis needs both db.kill and db.start")

    def log_files(self, test: dict, node: str) -> list[str]:
        return []
