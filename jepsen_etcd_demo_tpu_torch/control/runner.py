"""Command runners: run a node's commands as local subprocesses."""

from __future__ import annotations

import asyncio
import shlex
from dataclasses import dataclass
from typing import Optional, Sequence


def shellquote(arg) -> str:
    return shlex.quote(str(arg))


@dataclass
class CommandResult:
    argv: list[str]
    returncode: int
    stdout: str
    stderr: str

    @property
    def ok(self) -> bool:
        return self.returncode == 0


class CommandError(Exception):
    def __init__(self, result: CommandResult):
        self.result = result
        super().__init__(
            f"command {' '.join(result.argv)!r} exited "
            f"{result.returncode}: {result.stderr[-500:]}")


class Runner:
    """Run shell commands 'on a node'. su=True wraps with sudo
    (c/su, src/jepsen/etcdemo.clj:36)."""

    node: str = "local"

    async def run(self, cmd: str, su: bool = False, check: bool = True,
                  timeout_s: float = 120.0) -> CommandResult:
        raise NotImplementedError

    async def download(self, remote_path: str, local_path: str,
                       check: bool = False) -> CommandResult:
        """Copy a file off the node (db/LogFiles collection,
        src/jepsen/etcdemo.clj:62-64)."""
        raise NotImplementedError

    async def _spawn(self, argv: Sequence[str], check: bool,
                     timeout_s: float,
                     env: Optional[dict] = None) -> CommandResult:
        proc = await asyncio.create_subprocess_exec(
            *argv,
            stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.PIPE,
            env=env)
        try:
            out, err = await asyncio.wait_for(proc.communicate(), timeout_s)
        except asyncio.TimeoutError:
            proc.kill()
            await proc.wait()
            res = CommandResult(list(argv), -1, "",
                                f"timeout after {timeout_s}s")
            if check:
                raise CommandError(res)
            return res
        res = CommandResult(list(argv), proc.returncode or 0,
                            out.decode(errors="replace"),
                            err.decode(errors="replace"))
        if check and not res.ok:
            raise CommandError(res)
        return res


class LocalRunner(Runner):
    """Run on this host: the hermetic stand-in for a node. su is a no-op
    unless allowed, so tests never sudo."""

    def __init__(self, node: str = "local", allow_su: bool = False):
        self.node = node
        self.allow_su = allow_su

    async def run(self, cmd: str, su: bool = False, check: bool = True,
                  timeout_s: float = 120.0) -> CommandResult:
        if su and self.allow_su:
            cmd = f"sudo sh -c {shellquote(cmd)}"
        return await self._spawn(["sh", "-c", cmd], check, timeout_s)

    async def download(self, remote_path: str, local_path: str,
                       check: bool = False) -> CommandResult:
        return await self._spawn(["cp", remote_path, local_path], check,
                                 300.0)


def runner_for(test: dict, node: str) -> Runner:
    """The control-plane runner a test's config asks for. Only local mode
    (the fake cluster) exists here: the SSH runner of the real-cluster
    path is not ported."""
    if test.get("local_mode"):
        return LocalRunner(node)
    raise NotImplementedError(
        "the real-cluster path (SSH control) is not ported; run with "
        "--fake")
