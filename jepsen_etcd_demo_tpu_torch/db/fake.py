"""No-op DB for hermetic runs over the in-process FakeKVStore."""

from __future__ import annotations

from ..control.runner import Runner
from .base import DB


class FakeDB(DB):
    async def setup(self, test: dict, r: Runner, node: str) -> None:
        pass

    async def teardown(self, test: dict, r: Runner, node: str) -> None:
        pass
