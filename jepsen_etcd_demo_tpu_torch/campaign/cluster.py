"""MiniCluster: an in-process minietcd cluster for live campaign specs.

N members, each minietcd's HTTP handler (db/minietcd.py) served from an
ephemeral 127.0.0.1 port by a ThreadingHTTPServer on a thread of its
own, each holding a bound peer socket as the one-member server does.
The members share one KeyStore: a single-copy register behind N
frontends, so the healthy cluster is linearizable by construction and
what the checker finds is what the fault planes bend:

  * member churn (nemesis/cluster_faults.MemberChurnNemesis):
    spawn_member / teardown_member while the run goes on. Clients of a
    torn-down member get connection-refused (a determinate :fail), and
    healthy churn stays linearizable. Its bug is `fork=True`: the
    standby boots from a copy of the store, a stale replica.
  * disk faults (DiskFaultNemesis): the shared KeyStore's env-gated
    persistence fault plus `restart_from_disk()`, the crash-restart that
    brings lost acked writes or garbled values to the clients.
  * lease skew (LeaseSkewNemesis): `grant_lease(member)` freezes a
    snapshot the member serves non-quorum reads from; quorum reads pass
    it by, as etcd's q=true reads do.

`teardown_member` and `close` join every member's serve thread; `close`
is idempotent, and the campaign engine calls it in a finally.
"""

from __future__ import annotations

import socket
import threading
from http.server import ThreadingHTTPServer
from typing import Optional

from ..db.minietcd import KeyStore, _handler_for


class _MemberStore:
    """One member's view over the cluster store. The faithful path
    delegates every call to the shared KeyStore; the fault planes bend
    it per member: a forked standby serves its own stale KeyStore, a
    leased member answers non-quorum GETs from its frozen snapshot."""

    def __init__(self, cluster: "MiniCluster", name: str):
        self._cluster = cluster
        self._name = name

    def _store(self) -> KeyStore:
        return self._cluster.store_for(self._name)

    @property
    def index(self) -> int:
        return self._store().index

    def get(self, key: str, quorum: bool = False):
        lease = self._cluster.lease_snapshot(self._name)
        if lease is not None and not quorum:
            # The expired-lease read: answer from the frozen snapshot
            # (key missing there = etcd 100, like the real store).
            if key not in lease:
                return 404, {"errorCode": 100, "message": "Key not found",
                             "cause": f"/{key}", "index": self.index}
            v, idx = lease[key]
            return 200, {"action": "get",
                         "node": {"key": f"/{key}", "value": v,
                                  "modifiedIndex": idx,
                                  "createdIndex": idx}}
        return self._store().get(key)

    def put(self, key, value, prev_value, prev_index):
        return self._store().put(key, value, prev_value, prev_index)

    def post(self, key, value):
        return self._store().post(key, value)

    def delete(self, key, prev_index):
        return self._store().delete(key, prev_index)


class _Member:
    """One spawned frontend: HTTP server + serve thread + the bound
    standby-peer socket (the shape minietcd.main holds). `port` 0 =
    ephemeral; a respawn passes the node's previous port so clients
    pinned to the old URL reconnect (real churn heals in place)."""

    def __init__(self, name: str, handler_cls, port: int = 0):
        self.name = name
        self.server = ThreadingHTTPServer(("127.0.0.1", port), handler_cls)
        self.server.daemon_threads = True
        self.port = self.server.server_address[1]
        self.peer_sock = socket.socket()
        self.peer_sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.peer_sock.bind(("127.0.0.1", 0))
        self.peer_sock.listen(1)
        self.thread = threading.Thread(
            target=self.server.serve_forever,
            name=f"minicluster-{name}", daemon=True)
        self.thread.start()

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def close(self) -> None:
        self.server.shutdown()
        self.thread.join(timeout=5.0)
        self.server.server_close()
        self.peer_sock.close()


class MiniCluster:
    """The in-process cluster (module docstring). Node names map to the
    member CURRENTLY serving them; a torn-down node keeps its (now
    dead) last URL so clients see connection-refused, like real churn.
    """

    def __init__(self, nodes=("n1", "n2", "n3"),
                 data_dir: Optional[str] = None):
        self.data_dir = data_dir
        self.store = KeyStore(data_dir)
        self._lock = threading.Lock()
        # Guarded by self._lock:
        self._members: dict[str, _Member] = {}
        self._urls: dict[str, str] = {}      # last-known URL per node
        self._ports: dict[str, int] = {}     # last bound port per node
        self._forks: dict[str, KeyStore] = {}    # buggy standby stores
        self._leases: dict[str, dict] = {}       # frozen lease snapshots
        self._closed = False
        for n in nodes:
            self.spawn_member(n)

    # -- store routing (member handler threads) ---------------------------
    def store_for(self, name: str) -> KeyStore:
        with self._lock:
            return self._forks.get(name, self.store)

    def lease_snapshot(self, name: str) -> Optional[dict]:
        with self._lock:
            return self._leases.get(name)

    # -- membership (nemesis thread / event loop) -------------------------
    def members(self) -> list[str]:
        with self._lock:
            return sorted(self._members)

    def url(self, node: str) -> str:
        with self._lock:
            url = self._urls.get(node)
        if url is None:
            raise KeyError(f"unknown cluster node {node!r}")
        return url

    def spawn_member(self, name: str, fork: bool = False) -> str:
        """Spawn (or replace) the frontend serving `name` — ON the
        node's previous port when it had one, so worker clients pinned
        to the old URL reconnect after churn/heal like they would
        against a real restarted member (ephemeral fallback if the OS
        gave the port away meanwhile). fork=True is the seeded churn
        bug: the standby boots from a snapshot COPY of the store — a
        stale replica that never sees later writes."""
        forked: Optional[KeyStore] = None
        if fork:
            forked = KeyStore()
            with self._lock:
                store = self.store
            # Lock order: cluster lock strictly before the store lock.
            with store.lock:
                forked.data = dict(store.data)
                forked.index = store.index
        with self._lock:
            if self._closed:
                raise RuntimeError("cluster is closed")
            old = self._members.pop(name, None)
            port = self._ports.get(name, 0)
        # Join the old frontend outside the cluster lock (close() blocks
        # on the serve thread) and before its port is bound again.
        if old is not None:
            old.close()
        handler_cls = _handler_for(_MemberStore(self, name))
        try:
            member = _Member(name, handler_cls, port=port)
        except OSError:
            member = _Member(name, handler_cls)
        installed = False
        # The _ports write records the port the bind gave (the earlier
        # read was a hint with an ephemeral fallback); one spawner a node
        # at a time is the nemeses' protocol.
        with self._lock:
            if not self._closed:
                if forked is not None:
                    self._forks[name] = forked
                else:
                    self._forks.pop(name, None)
                self._members[name] = member
                self._urls[name] = member.url
                self._ports[name] = member.port
                installed = True
        if not installed:
            member.close()
            raise RuntimeError("cluster is closed")
        return member.url

    def teardown_member(self, name: str) -> None:
        """Remove a member. Its node keeps the dead URL: clients dial
        connection-refused until (and unless) a replacement spawns."""
        with self._lock:
            member = self._members.pop(name, None)
            self._forks.pop(name, None)
            self._leases.pop(name, None)
        if member is not None:
            member.close()

    # -- fault-plane hooks ------------------------------------------------
    def grant_lease(self, name: str) -> None:
        """Freeze `name`'s read lease at the current store state — the
        clock-skewed leaseholder serves non-quorum reads from it until
        revoke_leases()."""
        with self._lock:
            store = self.store
        # Lock order: cluster lock strictly before the store lock (the
        # handler threads take them in that order too via store_for).
        with store.lock:
            snap = dict(store.data)
        with self._lock:
            self._leases[name] = snap

    def revoke_leases(self) -> None:
        with self._lock:
            self._leases.clear()

    def restart_from_disk(self) -> None:
        """Crash-restart the storage plane: reload the shared KeyStore
        from its snapshot file (the DiskFaultNemesis restart leg —
        whatever the fault hook kept off the disk is now gone)."""
        if self.data_dir is None:
            raise RuntimeError("restart_from_disk needs a data_dir")
        with self._lock:
            mode = self.store.fault_mode
        fresh = KeyStore(self.data_dir)
        fresh.fault_mode = mode
        with self._lock:
            self.store = fresh

    # -- client plumbing --------------------------------------------------
    def conn_factory(self, timeout_s: float = 5.0):
        """conn_factory for compose_test: node name -> an EtcdClient
        dialing that node's current member URL (live HTTP through the
        real client, exactly the EtcdDB data plane without SSH)."""
        from ..clients.etcd import EtcdClient

        def factory(test, node):
            return EtcdClient(self.url(node), timeout_s=timeout_s)

        return factory

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            members = list(self._members.values())
            self._members.clear()
            self._leases.clear()
            self._forks.clear()
        for m in members:
            m.close()
