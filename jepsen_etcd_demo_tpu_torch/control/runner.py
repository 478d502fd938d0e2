"""Command runners: SSH to a node, or run its commands on this host."""

from __future__ import annotations

import asyncio
import os
import shlex
import shutil
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


class SSHRunner(Runner):
    """Drive a node over the system ssh and scp binaries: the role of the
    reference's clj-ssh sessions (jepsen.etcdemo.iml:21,38), with the
    command quoted and wrapped in sudo when the user is not root."""

    def __init__(self, node: str, username: str = "root",
                 port: int = 22, private_key: Optional[str] = None,
                 password: Optional[str] = None,
                 connect_timeout_s: int = 10):
        self.node = node
        self.username = username
        self.port = port
        self.private_key = private_key
        self.password = password
        self.connect_timeout_s = connect_timeout_s

    def _common_opts(self) -> list[str]:
        # A password rides sshpass: OpenSSH takes none on argv or stdin,
        # and BatchMode=yes would turn off the prompt sshpass answers, so
        # BatchMode guards key auth only. Host keys are not checked: the
        # nodes of a test are machines built for it.
        opts = (["-o", "NumberOfPasswordPrompts=1"] if self.password
                else ["-o", "BatchMode=yes"])
        opts += ["-o", "StrictHostKeyChecking=no",
                 "-o", "UserKnownHostsFile=/dev/null",
                 "-o", "LogLevel=ERROR"]
        if self.private_key:
            opts += ["-i", self.private_key]
        return opts

    def _transport(self, argv: list[str]) -> tuple[list[str], Optional[dict]]:
        """The (argv, env) of one ssh or scp call. A password reaches
        sshpass through the environment (`-e`, SSHPASS), never argv,
        which every local `ps` shows."""
        if not self.password:
            return argv, None
        if shutil.which("sshpass") is None:
            raise RuntimeError(
                "--password auth rides the sshpass binary (OpenSSH "
                "refuses passwords on argv by design) and sshpass is "
                "not on PATH; install it or use --private-key")
        env = dict(os.environ, SSHPASS=self.password)
        return ["sshpass", "-e"] + argv, env

    def _ssh_argv(self, cmd: str) -> list[str]:
        return (["ssh", "-p", str(self.port),
                 "-o", f"ConnectTimeout={self.connect_timeout_s}"]
                + self._common_opts()
                + [f"{self.username}@{self.node}", cmd])

    async def run(self, cmd: str, su: bool = False, check: bool = True,
                  timeout_s: float = 120.0) -> CommandResult:
        if su and self.username != "root":
            cmd = f"sudo sh -c {shellquote(cmd)}"
        argv, env = self._transport(self._ssh_argv(cmd))
        return await self._spawn(argv, check, timeout_s, env)

    def _scp_argv(self, src: str, dst: str) -> list[str]:
        return ["scp", "-P", str(self.port)] + self._common_opts() + [src, dst]

    async def download(self, remote_path: str, local_path: str,
                       check: bool = False) -> CommandResult:
        argv, env = self._transport(self._scp_argv(
            f"{self.username}@{self.node}:{remote_path}", local_path))
        return await self._spawn(argv, check, 300.0, env)


def runner_for(test: dict, node: str) -> Runner:
    """The control-plane runner a test's config asks for: this host in
    local mode (the fake cluster), else ssh with test["ssh"]'s user,
    port, key and password."""
    if test.get("local_mode"):
        return LocalRunner(node)
    ssh = test.get("ssh", {})
    return SSHRunner(node,
                     username=ssh.get("username", "root"),
                     port=ssh.get("port", 22),
                     private_key=ssh.get("private_key"),
                     password=ssh.get("password"))
