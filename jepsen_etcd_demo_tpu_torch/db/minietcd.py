"""minietcd: an etcd-argv-compatible single-member v2 server.

A real, spawnable process that stands in for the etcd binary where none
is installed, so the whole real-cluster path (`cli test` -> SSH control
-> tarball install -> daemon lifecycle -> HTTP clients -> check and
store) runs on one host. It serves the part of etcd's v2 keys API the
clients use (clients/etcd.py; src/jepsen/etcdemo.clj:79-98):

  GET    /v2/keys/<k>[?quorum=true]        value + modifiedIndex; a dir
                                           lists its nodes in order
  PUT    /v2/keys/<k> value=v              set; ?prevValue / ?prevIndex
                                           compare-and-set (errorCode 101)
  POST   /v2/keys/<dir> value=v            in-order key creation
  DELETE /v2/keys/<k>[?prevIndex=i]        compare-and-delete

with etcd's errorCodes 100 (key not found), 101 (compare failed), 102
(not a file) and 104 (not a directory), one global modifiedIndex, every
write persisted to --data-dir before it is acknowledged, and each
read-check-write under one lock: a one-member etcd is a linearizable
single-copy register, which is what makes a valid verdict against it
mean something.

It is not raft. Several minietcds pointed at each other are independent
stores (the parser takes --initial-cluster for argv compatibility and
serves only its own member), which a run over two of them shows as a
linearizability violation. It takes the flags EtcdDB passes plus
--data-dir, --enable-v2 and --version, holds the peer port as etcd does,
and `make_release_tarball` packages it in the layout of etcd's release
tarball, so EtcdDB installs and starts it unchanged through
JEPSEN_TPU_ETCD_TARBALL. Its snapshot (<data-dir>/minietcd.json) has the
JAX package's minietcd format, so either server loads the other's data
dir.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import sys
import tarfile
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

VERSION = "2.3.8-minietcd"   # a v2-era version string: probes parse it
#                              as (2, 3), so the v2 API is on by default

# The scenario factory's persistence fault plane
# (nemesis/cluster_faults.DiskFaultNemesis). A KeyStore's `fault_mode` is
# honoured only while this variable is set to a true value, so a stray
# attribute write cannot bend a production minietcd: the nemesis sets
# both, for its fault window only.
FAULT_HOOK_ENV = "JEPSEN_TPU_MINIETCD_FAULT_HOOK"
FAULT_DISK_FULL = "disk-full"          # acked writes never reach the disk
FAULT_CORRUPT_WRITE = "corrupt-write"  # the snapshot garbles the last value


def fault_hook_enabled() -> bool:
    return os.environ.get(FAULT_HOOK_ENV, "").lower() \
        in ("1", "true", "yes", "on")


def _garble(value: str) -> str:
    """On-disk corruption that stays in the op language: a numeric
    register value goes up by one (never the acked value, still
    encodable), anything else is reversed."""
    try:
        return str(int(value) + 1)
    except (TypeError, ValueError):
        return value[::-1] if value else "corrupt"


class KeyStore:
    """The single-copy store: key -> (value, modifiedIndex), one global
    index, one lock. Each read-check-write holds the lock for its whole
    critical section: compare-and-set atomicity under the server's
    per-request threads is what makes this a linearizable register."""

    def __init__(self, data_dir: str | None = None):
        self.data: dict[str, tuple[str, int]] = {}
        self.index = 0
        self.lock = threading.Lock()
        self.path = (os.path.join(data_dir, "minietcd.json")
                     if data_dir else None)
        # The fault plane (FAULT_HOOK_ENV): the persistence fault to
        # inject, and how many writes it has bent so far.
        self.fault_mode: str | None = None
        self.faults_injected = 0
        if self.path and os.path.exists(self.path):
            with open(self.path) as f:
                snap = json.load(f)
            self.index = snap["index"]
            self.data = {k: (v, i) for k, (v, i) in snap["keys"].items()}

    def _persist_locked(self) -> None:
        if not self.path:
            return
        mode = self.fault_mode if fault_hook_enabled() else None
        if mode == FAULT_DISK_FULL:
            # A server that swallows ENOSPC: the write is acked and served
            # from memory but never reaches the disk, so a restart from
            # the snapshot loses it.
            self.faults_injected += 1
            return
        data = self.data
        if mode == FAULT_CORRUPT_WRITE:
            # The snapshot garbles the most recently modified value on
            # its way to disk; memory stays right until a restart.
            data = dict(self.data)
            latest = max(data, key=lambda k: data[k][1], default=None)
            if latest is not None:
                v, idx = data[latest]
                data[latest] = (_garble(v), idx)
                self.faults_injected += 1
        # Replaced atomically: a kill -9 (the kill nemesis) leaves either
        # the old snapshot or the new one, never a torn file.
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(self.path))
        with os.fdopen(fd, "w") as f:
            json.dump({"index": self.index,
                       "keys": {k: list(v) for k, v in data.items()}},
                      f)
        os.replace(tmp, self.path)

    # Each method returns (status, body) in etcd v2's wire shape.

    def get(self, key: str, quorum: bool = False):
        # One copy is linearizable either way, so `quorum` changes
        # nothing here; the handler passes the client's ?quorum=true on.
        with self.lock:
            children = sorted(
                (idx, k, v) for k, (v, idx) in self.data.items()
                if k.startswith(key + "/"))
            if key not in self.data and not children:
                return 404, {"errorCode": 100, "message": "Key not found",
                             "cause": f"/{key}", "index": self.index}
            if children:
                return 200, {"action": "get", "node": {
                    "key": f"/{key}", "dir": True,
                    "nodes": [{"key": f"/{k}", "value": v,
                               "modifiedIndex": idx, "createdIndex": idx}
                              for idx, k, v in children]}}
            v, idx = self.data[key]
            return 200, {"action": "get",
                         "node": {"key": f"/{key}", "value": v,
                                  "modifiedIndex": idx,
                                  "createdIndex": idx}}

    def _write_conflict_locked(self, key: str, creating_dir: bool):
        """etcd refuses file/dir conflicts when writing: errorCode 102
        "Not a file" for a file over a dir, 104 "Not a directory" for a
        write under (or an in-order post to) a file. The caller holds the
        lock."""
        if not creating_dir and any(k.startswith(key + "/")
                                    for k in self.data):
            return 403, {"errorCode": 102, "message": "Not a file",
                         "cause": f"/{key}", "index": self.index}
        if creating_dir and key in self.data:
            return 400, {"errorCode": 104, "message": "Not a directory",
                         "cause": f"/{key}", "index": self.index}
        parts = key.split("/")
        for i in range(1, len(parts)):
            ancestor = "/".join(parts[:i])
            if ancestor in self.data:
                return 400, {"errorCode": 104,
                             "message": "Not a directory",
                             "cause": f"/{ancestor}", "index": self.index}
        return None

    def put(self, key: str, value: str, prev_value: str | None,
            prev_index: int | None):
        with self.lock:
            conflict = self._write_conflict_locked(key, creating_dir=False)
            if conflict is not None:
                return conflict
            if prev_value is not None or prev_index is not None:
                if key not in self.data:
                    return 404, {"errorCode": 100,
                                 "message": "Key not found",
                                 "cause": f"/{key}", "index": self.index}
                cur, idx = self.data[key]
                if ((prev_value is not None and prev_value != cur)
                        or (prev_index is not None and prev_index != idx)):
                    return 412, {"errorCode": 101,
                                 "message": "Compare failed",
                                 "cause": f"[{prev_value} != {cur}]",
                                 "index": self.index}
            self.index += 1
            self.data[key] = (value, self.index)
            self._persist_locked()
            return 200, {"action": "set",
                         "node": {"key": f"/{key}", "value": value,
                                  "modifiedIndex": self.index,
                                  "createdIndex": self.index}}

    def post(self, key: str, value: str):
        with self.lock:
            conflict = self._write_conflict_locked(key, creating_dir=True)
            if conflict is not None:
                return conflict
            self.index += 1
            # A zero-padded index as the name: the names sort in creation
            # order, which is etcd's order of in-order keys.
            node = f"{key}/{self.index:020d}"
            self.data[node] = (value, self.index)
            self._persist_locked()
            return 201, {"action": "create",
                         "node": {"key": f"/{node}", "value": value,
                                  "modifiedIndex": self.index,
                                  "createdIndex": self.index}}

    def delete(self, key: str, prev_index: int | None):
        with self.lock:
            if key not in self.data:
                return 404, {"errorCode": 100, "message": "Key not found",
                             "cause": f"/{key}", "index": self.index}
            v, idx = self.data[key]
            if prev_index is not None and prev_index != idx:
                return 412, {"errorCode": 101, "message": "Compare failed",
                             "cause": f"[{prev_index} != {idx}]",
                             "index": self.index}
            del self.data[key]
            self._persist_locked()
            return 200, {"action": "delete",
                         "node": {"key": f"/{key}", "value": v,
                                  "modifiedIndex": idx,
                                  "createdIndex": idx}}


def _handler_for(store: KeyStore):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):   # no request log: the daemon's
            pass                     # logfile gets lifecycle lines only

        def _key(self) -> str:
            return urlparse(self.path).path[len("/v2/keys/"):].strip("/")

        def _params(self) -> dict:
            return {k: v[0]
                    for k, v in parse_qs(urlparse(self.path).query).items()}

        def _form(self) -> dict:
            length = int(self.headers.get("Content-Length", 0))
            return {k: v[0] for k, v in
                    parse_qs(self.rfile.read(length).decode()).items()}

        def _reply(self, status: int, body: dict):
            payload = json.dumps(body).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("X-Etcd-Index", str(store.index))
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def do_GET(self):
            if urlparse(self.path).path in ("/health", "/version"):
                self._reply(200, {"etcdserver": VERSION,
                                  "health": "true"})
                return
            self._reply(*store.get(
                self._key(),
                quorum=self._params().get("quorum") == "true"))

        def do_PUT(self):
            # etcd v2 takes the fields from the form body or the query
            # string; both are merged (the form wins), so a client that
            # sends prevValue in the other place still gets a
            # compare-and-set, never an unconditional write.
            merged = {**self._params(), **self._form()}
            prev_index = merged.get("prevIndex")
            self._reply(*store.put(
                self._key(), merged.get("value", ""),
                merged.get("prevValue"),
                int(prev_index) if prev_index is not None else None))

        def do_POST(self):
            merged = {**self._params(), **self._form()}
            self._reply(*store.post(self._key(), merged.get("value", "")))

        def do_DELETE(self):
            # The same merge as do_PUT: a prevIndex in the body must not
            # turn the queue's compare-and-delete claim unconditional.
            merged = {**self._params(), **self._form()}
            prev_index = merged.get("prevIndex")
            self._reply(*store.delete(
                self._key(),
                int(prev_index) if prev_index is not None else None))

    return Handler


def _url_port(url: str, default: int) -> tuple[str, int]:
    u = urlparse(url if "//" in url else f"http://{url}")
    return u.hostname or "127.0.0.1", u.port or default


def build_parser() -> argparse.ArgumentParser:
    """The flags EtcdDB passes (db/etcd.py EtcdDB.start) and a few more.
    An unknown flag is an error, as in etcd, so argv drift in EtcdDB
    fails loudly."""
    p = argparse.ArgumentParser(prog="minietcd")
    p.add_argument("--name", default="default")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--listen-client-urls", default="http://127.0.0.1:2379")
    p.add_argument("--advertise-client-urls", default=None)
    p.add_argument("--listen-peer-urls", default="http://127.0.0.1:2380")
    p.add_argument("--initial-advertise-peer-urls", default=None)
    p.add_argument("--initial-cluster", default=None)
    p.add_argument("--initial-cluster-state", default="new")
    p.add_argument("--log-output", default=None)
    p.add_argument("--enable-v2", nargs="?", const="true", default="true")
    p.add_argument("--version", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.version:
        # The etcd binary's shape: a probe reads the "Version:" line.
        print(f"etcd Version: {VERSION}\nGit SHA: none\n"
              f"Go Version: none (python stand-in)")
        return 0
    # etcd's default data dir is <name>.etcd under the working directory,
    # which EtcdDB sets to the install dir: state survives a kill and
    # restart, and teardown's rm -rf of the install dir wipes it.
    data_dir = args.data_dir or f"{args.name}.etcd"
    os.makedirs(data_dir, exist_ok=True)
    t_start = time.monotonic()
    store = KeyStore(data_dir)
    host, port = _url_port(args.listen_client_urls, 2379)
    peer_host, peer_port = _url_port(args.listen_peer_urls, 2380)
    # Hold the peer port as etcd does: a second member on the same host
    # and port fails to bind instead of quietly starting a second store.
    peer_sock = socket.socket()
    peer_sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    peer_sock.bind((peer_host, peer_port))
    peer_sock.listen(1)
    server = ThreadingHTTPServer((host, port), _handler_for(store))
    server.daemon_threads = True
    # shutdown() waits for serve_forever, and the handler runs on the
    # serving thread: calling it inline would deadlock.
    signal.signal(signal.SIGTERM, lambda *a: threading.Thread(
        target=server.shutdown, daemon=True).start())
    ready_ms = (time.monotonic() - t_start) * 1e3
    print(f"minietcd {VERSION} member {args.name}: serving client "
          f"requests on http://{host}:{port} (peer {peer_port}, "
          f"data-dir {data_dir}, ready in {ready_ms:.1f} ms, "
          f"{len(store.data)} keys restored)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        peer_sock.close()
    return 0


# -- packaging: the release-tarball layout install_archive unpacks --------

LAUNCHER = """#!/bin/sh
# minietcd launcher: an etcd-argv-compatible stand-in (one member, v2).
PYTHONPATH={pkg_root}${{PYTHONPATH:+:$PYTHONPATH}} \\
  exec {python} -m jepsen_etcd_demo_tpu_torch.db.minietcd "$@"
"""


def write_launcher(dest: str) -> str:
    """Write an executable `etcd` at `dest` that runs this module with
    the running interpreter, this package importable."""
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    with open(dest, "w") as f:
        f.write(LAUNCHER.format(pkg_root=pkg_root, python=sys.executable))
    os.chmod(dest, 0o755)
    return dest


def make_release_tarball(dest: str, version: str = "v3.1.5") -> str:
    """A tar.gz at `dest` holding etcd-<version>-linux-amd64/etcd, the
    layout of etcd's release tarball (db/etcd.py tarball_url), so that
    install_archive's --strip-components=1 puts the launcher at
    <dir>/etcd."""
    top = f"etcd-{version}-linux-amd64"
    with tempfile.TemporaryDirectory() as td:
        launcher = write_launcher(os.path.join(td, "etcd"))
        with tarfile.open(dest, "w:gz") as tar:
            tar.add(launcher, arcname=f"{top}/etcd")
    return dest


if __name__ == "__main__":
    sys.exit(main())
