"""etcd cluster orchestration and topology helpers.

The reference's db reify (src/jepsen/etcdemo.clj:25-65) and the URL
builders of support.clj (src/jepsen/etcdemo/support.clj:4-26): install
the release tarball, start the daemon with the full static-cluster flags
and wait for it to settle; teardown kills it and wipes the install;
etcd.log is the log collected into the store.

The JEPSEN_TPU_ETCD_* variables move a run off the reference's paths and
ports (a hermetic run on one host: db/minietcd.py's tarball, ports of its
own, several daemons side by side). They are read when the module is
imported: the environment travels to a CLI process, not across a
long-lived interpreter.
"""

from __future__ import annotations

import asyncio
import logging
import os

from ..control.daemon import install_archive, start_daemon, stop_daemon
from ..control.runner import Runner
from .base import DB

log = logging.getLogger(__name__)

DIR = os.environ.get("JEPSEN_TPU_ETCD_DIR", "/opt/etcd")   # reference :25
BINARY = "etcd"                         # :26
LOGFILE = f"{DIR}/etcd.log"             # :27
PIDFILE = f"{DIR}/etcd.pid"             # :28

PEER_PORT = int(os.environ.get(
    "JEPSEN_TPU_ETCD_PEER_PORT", "2380"))       # support.clj:9-12
CLIENT_PORT = int(os.environ.get(
    "JEPSEN_TPU_ETCD_CLIENT_PORT", "2379"))     # support.clj:14-17


def _parse_port_map(raw: str) -> dict[str, tuple[int, int]]:
    """JEPSEN_TPU_ETCD_PORT_MAP="n1=2379/2380,n2=2479/2480": client and
    peer ports per node, for daemons that share one host. A cluster of
    real hosts needs none: one port per host, the reference's model."""
    out = {}
    for part in raw.split(","):
        if not part.strip():
            continue
        node, ports = part.split("=")
        c, p = ports.split("/")
        out[node.strip()] = (int(c), int(p))
    return out


PORT_MAP = _parse_port_map(os.environ.get("JEPSEN_TPU_ETCD_PORT_MAP", ""))


def client_port_for(node: str) -> int:
    return PORT_MAP.get(node, (CLIENT_PORT, PEER_PORT))[0]


def peer_port_for(node: str) -> int:
    return PORT_MAP.get(node, (CLIENT_PORT, PEER_PORT))[1]


def pidfile_for(node: str) -> str:
    """A node of the port map has a pidfile of its own (with a shared one
    the second start_daemon would find the first daemon running); any
    other node the reference's path."""
    return f"{DIR}/etcd-{node}.pid" if node in PORT_MAP else PIDFILE


def logfile_for(node: str) -> str:
    return f"{DIR}/etcd-{node}.log" if node in PORT_MAP else LOGFILE


DEFAULT_VERSION = "v3.1.5"              # reference :162


def node_url(node: str, port: int) -> str:
    """The HTTP url of a node's port (support.clj:4-7)."""
    return f"http://{node}:{port}"


def peer_url(node: str) -> str:
    return node_url(node, peer_port_for(node))


def client_url(node: str) -> str:
    return node_url(node, client_port_for(node))


def initial_cluster(nodes: list[str]) -> str:
    """node=peer-url pairs joined by commas (support.clj:19-26)."""
    return ",".join(f"{n}={peer_url(n)}" for n in nodes)


def tarball_url(version: str) -> str:
    """The release tarball's location (reference :37-40);
    JEPSEN_TPU_ETCD_TARBALL replaces it (any scheme curl speaks, file://
    included)."""
    override = os.environ.get("JEPSEN_TPU_ETCD_TARBALL")
    if override:
        return override
    return (f"https://storage.googleapis.com/etcd/{version}/"
            f"etcd-{version}-linux-amd64.tar.gz")


class EtcdDB(DB):
    def __init__(self, version: str = DEFAULT_VERSION,
                 settle_s: float | None = None):
        self.version = version
        # The wait for the cluster to converge after a start (reference
        # :55); JEPSEN_TPU_ETCD_SETTLE_S shortens it for a one-member
        # stand-in.
        self.settle_s = (settle_s if settle_s is not None else float(
            os.environ.get("JEPSEN_TPU_ETCD_SETTLE_S", "10.0")))
        # Nodes of the port map share one host, one install dir and one
        # download path, so their installs take turns. One lock per
        # running loop: an asyncio.Lock binds to the loop that first
        # awaits it, and --test-count >= 2 runs each test under its own
        # asyncio.run.
        self._install_locks: dict[asyncio.AbstractEventLoop,
                                  asyncio.Lock] = {}

    def _install_lock(self) -> asyncio.Lock:
        loop = asyncio.get_running_loop()
        lock = self._install_locks.get(loop)
        if lock is None:
            lock = self._install_locks[loop] = asyncio.Lock()
        return lock

    async def setup(self, test: dict, r: Runner, node: str) -> None:
        log.info("installing etcd %s on %s", self.version, node)
        if node in PORT_MAP:
            async with self._install_lock():
                await install_archive(r, tarball_url(self.version), DIR)
        else:
            await install_archive(r, tarball_url(self.version), DIR)
        await self.start(test, r, node)

    async def start(self, test: dict, r: Runner, node: str) -> None:
        """Start (or restart) the daemon on the install and data dir that
        are there: the restart leg the kill nemesis drives, with no
        reinstall, as jepsen's db/start! does."""
        nodes = test["nodes"]
        await start_daemon(
            r, f"{DIR}/{BINARY}",
            ["--log-output", "stderr",
             "--name", node,
             "--listen-peer-urls", peer_url(node),
             "--listen-client-urls", client_url(node),
             "--advertise-client-urls", client_url(node),
             "--initial-cluster-state", "new",
             "--initial-advertise-peer-urls", peer_url(node),
             "--initial-cluster", initial_cluster(nodes)],
            logfile=logfile_for(node), pidfile=pidfile_for(node),
            chdir=DIR)
        await asyncio.sleep(self.settle_s)

    async def kill(self, test: dict, r: Runner, node: str) -> None:
        """SIGKILL by pidfile; the install and data dir stay (db/kill!)."""
        await stop_daemon(r, pidfile_for(node))

    async def teardown(self, test: dict, r: Runner, node: str) -> None:
        log.info("tearing down etcd on %s", node)
        await stop_daemon(r, pidfile_for(node))
        if node in PORT_MAP:
            # The install dir is shared and the nodes tear down side by
            # side: wiping all of it would delete a peer's pidfile before
            # its stop_daemon ran (leaving its daemon alive) and its log
            # before collection. Wipe only this node's state.
            await r.run(
                f"rm -rf {DIR}/{node}.etcd {pidfile_for(node)} "
                f"{logfile_for(node)}", su=True, check=False)
        else:
            await r.run(f"rm -rf {DIR}", su=True, check=False)

    def log_files(self, test: dict, node: str) -> list[str]:
        return [logfile_for(node)]
