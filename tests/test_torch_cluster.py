"""The port's real-cluster path against the JAX package's, on the CPU.

  * the standard-library etcd client against the JAX package's httpx
    client, the same calls on a minietcd, and the error classes that
    decide :fail against :info (a refused connect, a silent listener, a
    reply cut short, a killed and restarted server);
  * command assembly through a recording runner: EtcdDB, the daemon
    helpers, the Debian prep, SSHRunner's argv and environment, every
    partition grudge and nemesis, the clock, strobe, kill and pause
    nemeses;
  * the composition (`etcd_test`, `pick_nemesis`) and the oracle backend;
  * whole `cli test` runs without --fake through ssh, scp and sshpass
    stand-ins on PATH against minietcd (tests/torch_cluster_util.py,
    which chip_smoke.py's phase `cluster` uses on the card), re-checked by the JAX package's
    analyze and the port's (sweeps and oracle).
"""

from __future__ import annotations

import asyncio
import json
import os
import random
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from jepsen_etcd_demo_tpu import compose as jcompose
from jepsen_etcd_demo_tpu.checkers import IndependentChecker as JInd
from jepsen_etcd_demo_tpu.checkers import Linearizable as JLin
from jepsen_etcd_demo_tpu.checkers import linearizable as jlinmod
from jepsen_etcd_demo_tpu.checkers import oracle as joracle
from jepsen_etcd_demo_tpu.cli import main as jcli
from jepsen_etcd_demo_tpu.clients import etcd as jclient
from jepsen_etcd_demo_tpu.control import daemon as jdaemon
from jepsen_etcd_demo_tpu.control import runner as jrunner
from jepsen_etcd_demo_tpu.db import debian as jdebian
from jepsen_etcd_demo_tpu.db import etcd as jetcd
from jepsen_etcd_demo_tpu.models import CASRegister as JM
from jepsen_etcd_demo_tpu.nemesis import clock as jclock
from jepsen_etcd_demo_tpu.nemesis import partition as jpart
from jepsen_etcd_demo_tpu.nemesis import process_faults as jproc
from jepsen_etcd_demo_tpu.ops.encode import encode_register_history as jenc
from jepsen_etcd_demo_tpu.ops.op import Op as JOp
from jepsen_etcd_demo_tpu.utils import fuzz as jfuzz
from jepsen_etcd_demo_tpu_torch import cli
from jepsen_etcd_demo_tpu_torch import compose as pcompose
from jepsen_etcd_demo_tpu_torch.checkers import IndependentChecker
from jepsen_etcd_demo_tpu_torch.checkers import Linearizable
from jepsen_etcd_demo_tpu_torch.checkers import linearizable as plinmod
from jepsen_etcd_demo_tpu_torch.checkers import oracle as poracle
from jepsen_etcd_demo_tpu_torch.clients import etcd as pclient
from jepsen_etcd_demo_tpu_torch.control import daemon as pdaemon
from jepsen_etcd_demo_tpu_torch.control import runner as prunner
from jepsen_etcd_demo_tpu_torch.db import debian as pdebian
from jepsen_etcd_demo_tpu_torch.db import etcd as petcd
from jepsen_etcd_demo_tpu_torch.db import minietcd as pmini
from jepsen_etcd_demo_tpu_torch.models import CASRegister as PM
from jepsen_etcd_demo_tpu_torch.nemesis import clock as pclock
from jepsen_etcd_demo_tpu_torch.nemesis import partition as ppart
from jepsen_etcd_demo_tpu_torch.nemesis import process_faults as pproc
from jepsen_etcd_demo_tpu_torch.ops.encode import encode_register_history
from jepsen_etcd_demo_tpu_torch.ops.op import Op as POp
from jepsen_etcd_demo_tpu_torch.runner import event_loop
from jepsen_etcd_demo_tpu_torch.utils import fuzz as pfuzz

from test_torch_harness import script
from test_torch_minietcd import Served
from torch_cluster_util import cluster_env, free_port
from torch_port_util import fuzz_pair, one_device  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
NODES5 = ["n1", "n2", "n3", "n4", "n5"]


# -- the etcd client ------------------------------------------------------

CLIENTS = {"jax": jclient, "port": pclient}


def drive(pkg: str, coro_fn, *args):
    """Run coro_fn(client module, *args): the port's on its select(2)
    loop, as `cli test` runs it."""
    mod = CLIENTS[pkg]
    if pkg == "port":
        return asyncio.run(coro_fn(mod, *args), loop_factory=event_loop)
    return asyncio.run(coro_fn(mod, *args))


async def five_calls(mod, port: int) -> list:
    c = mod.EtcdClient.connect("127.0.0.1", port=port)
    out = []

    async def call(name, *a):
        try:
            out.append((name, a[:1], "ok", await getattr(c, name)(*a)))
        except Exception as e:
            out.append((name, a[:1], type(e).__name__, str(e)))

    try:
        await call("get", "r")
        await call("get_with_index", "r", True)
        await call("reset", "r", 1)
        await call("get", "r", True)
        await call("get_with_index", "r")
        await call("cas", "r", 0, 2)
        await call("cas", "r", 1, 2)
        await call("cas", "ghost", 0, 1)
        await call("swap", "r", lambda v: int(v) + 5)
        await call("get", "r")
        for v in (1, 2, 3):
            await call("enqueue", "q", v)
        for _ in range(4):
            await call("dequeue", "q")
        await call("enqueue", "r", 9)            # 104: r is a file
        await call("reset", "q2/a", 1)
        await call("reset", "q2", 1)             # 102: q2 is a dir
        await call("swap", "missing", lambda v: v)
        await call("dequeue", "r")
    finally:
        await c.close()
    return out


def test_client_calls_match_the_jax_client():
    got = {}
    for pkg in CLIENTS:
        s = Served(pmini)
        try:
            got[pkg] = drive(pkg, five_calls, s.port)
        finally:
            s.close()
    assert got["port"] == got["jax"]
    kinds = {r[2] for r in got["port"]}
    assert {"ok", "NotFound", "EtcdError"} <= kinds


async def one_get(mod, port: int, timeout_s: float):
    c = mod.EtcdClient.connect("127.0.0.1", port=port, timeout_s=timeout_s)
    t0 = time.monotonic()
    try:
        await c.get("k")
        return "ok", time.monotonic() - t0
    except Exception as e:
        return type(e).__name__, time.monotonic() - t0
    finally:
        await c.close()


class Misbehaving:
    """A TCP server on a thread that reads each request and answers with
    `reply` (bytes, possibly cut short), then closes; reply None: never
    accept, a listener whose backlog takes the connection."""

    def __init__(self, reply):
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(8)
        self.sock.settimeout(0.05)
        self.port = self.sock.getsockname()[1]
        self.reply = reply
        self.stop = threading.Event()
        self.thread = None
        if reply is not None:
            self.thread = threading.Thread(target=self._serve, daemon=True)
            self.thread.start()

    def _serve(self):
        while not self.stop.is_set():
            try:
                conn, _ = self.sock.accept()
            except socket.timeout:
                continue
            conn.settimeout(5)
            try:
                with conn:
                    data = b""
                    while b"\r\n\r\n" not in data:
                        chunk = conn.recv(4096)
                        if not chunk:
                            break
                        data += chunk
                    conn.sendall(self.reply)
            except OSError:
                pass

    def close(self):
        self.stop.set()
        if self.thread is not None:
            self.thread.join(timeout=10)
            assert not self.thread.is_alive()
        self.sock.close()


@pytest.mark.parametrize("case,want", [
    ("closed-port", "ConnectionRefused"),
    ("silent-listener", "Timeout"),
    ("no-reply", "Timeout"),
    ("cut-headers", "Timeout"),
    ("cut-body", "Timeout"),
    ("bad-status", "Timeout"),
])
def test_error_classes_match_the_jax_client(case, want):
    """A connect refused before any byte was sent is determinate
    (ConnectionRefused, :fail); everything after a send is Timeout
    (:info), within the timeout."""
    replies = {
        "silent-listener": None,
        "no-reply": b"",
        "cut-headers": b"HTTP/1.1 200 OK\r\nContent-Le",
        "cut-body": (b"HTTP/1.1 200 OK\r\nContent-Type: application/json"
                     b"\r\nContent-Length: 100\r\n\r\n{\"node\""),
        "bad-status": b"SSH-2.0-OpenSSH\r\n\r\n",
    }
    got = {}
    for pkg in CLIENTS:
        if case == "closed-port":
            port, server = free_port(), None
        else:
            server = Misbehaving(replies[case])
            port = server.port
        try:
            got[pkg] = drive(pkg, one_get, port, 0.5)
        finally:
            if server is not None:
                server.close()
    assert got["port"][0] == got["jax"][0] == want
    assert got["port"][1] < 3.0


def spawn_minietcd(data_dir: Path, cport: int, pport: int):
    """A minietcd process on cport, returned once it logged that it
    serves there: the line proves this process bound the port (a port
    chosen in advance could have been taken since)."""
    p = subprocess.Popen(
        [sys.executable, "-m", "jepsen_etcd_demo_tpu_torch.db.minietcd",
         "--name", "m", "--data-dir", str(data_dir),
         "--listen-client-urls", f"http://127.0.0.1:{cport}",
         "--listen-peer-urls", f"http://127.0.0.1:{pport}"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    line = p.stdout.readline().decode()
    if "serving client requests" not in line:
        p.kill()
        rest = p.communicate(timeout=20)[0].decode()
        raise RuntimeError(f"minietcd did not start: {line}{rest}")
    return p


def kill9(p) -> None:
    p.send_signal(signal.SIGKILL)
    p.wait(timeout=20)
    p.stdout.close()


def open_fds() -> int:
    return len(os.listdir("/proc/self/fd"))


def test_kill_and_restart_of_a_spawned_minietcd(tmp_path):
    """One client per package over one keep-alive connection each: a
    call after a kill -9 is refused (:fail), a call after the restart
    succeeds on a new connection and reads the acknowledged writes back
    from the data dir; no socket stays open after close."""
    cport, pport = free_port(), free_port()
    server = spawn_minietcd(tmp_path, cport, pport)

    async def before(mod):
        c = mod.EtcdClient.connect("127.0.0.1", port=cport)
        await c.reset(f"{mod.__name__}", 7)
        return c, await c.get(f"{mod.__name__}")

    async def after(mod, c):
        out = []
        for _ in range(2):
            try:
                out.append(await c.get(f"{mod.__name__}"))
            except Exception as e:
                out.append(type(e).__name__)
        return out

    async def scenario(mod, stage):
        nonlocal server
        c, first = await before(mod)
        kill9(server)
        dead = await after(mod, c)
        server = spawn_minietcd(tmp_path, cport, pport)
        alive = await after(mod, c)
        await c.close()
        return first, dead, alive

    fds = open_fds()
    try:
        got = {pkg: drive(pkg, lambda mod: scenario(mod, pkg))
               for pkg in CLIENTS}
    finally:
        kill9(server)
    assert got["port"] == got["jax"] == (
        "7", ["ConnectionRefused", "ConnectionRefused"], ["7", "7"])
    assert open_fds() <= fds


def test_free_ports_are_distinct_and_below_the_ephemeral_range():
    """Runs side by side take their members' ports from free_port before
    the members bind them: every port it hands out is new, bindable, and
    below the range the kernel gives to bind(("", 0)) and to outgoing
    connections, so no other socket can take it meanwhile."""
    low = int(Path("/proc/sys/net/ipv4/ip_local_port_range").read_text()
              .split()[0])
    ports = [free_port() for _ in range(64)]
    assert len(set(ports)) == len(ports)
    assert all(1024 <= p < low for p in ports)
    for p in ports[:8]:
        with socket.socket() as s:
            s.bind(("127.0.0.1", p))


def test_no_socket_outlives_its_client(tmp_path):
    """Many clients, each closed after a call, on a live server (its own
    process) and on a refusing port: this process's descriptor count
    returns to where it started (the runner's select(2) loop cannot watch
    one past 1,024)."""
    live, dead = free_port(), free_port()
    server = spawn_minietcd(tmp_path, live, free_port())

    async def churn(mod):
        for i in range(200):
            c = mod.EtcdClient.connect("127.0.0.1",
                                       port=live if i % 2 else dead)
            try:
                await c.reset("k", i)
            except Exception:
                pass
            await c.close()

    try:
        drive("port", churn)
        fds = open_fds()
        drive("port", churn)
        assert open_fds() <= fds
    finally:
        kill9(server)


# -- command assembly -----------------------------------------------------

def norm(cmd: str) -> str:
    """The port's archive download lands in the node's $TMPDIR; the JAX
    package's in /tmp (ROADMAP C)."""
    return cmd.replace('"${TMPDIR:-/tmp}"/', "/tmp/")


class Rec:
    """A runner that records (node, command, su, check) and answers ok,
    or fails a command naming one of `fails`."""

    def __init__(self, node: str, log: list, fails=()):
        self.node, self.log, self.fails = node, log, fails

    async def run(self, cmd, su=False, check=True, timeout_s=120.0):
        self.log.append((self.node, norm(cmd), su, check))
        ok = not any(f in cmd for f in self.fails)
        return prunner.CommandResult(["sh", "-c", cmd], 0 if ok else 1,
                                     "", "")

    async def download(self, remote, local, check=False):
        self.log.append((self.node, "download", remote, local))


ETCD = {"jax": jetcd, "port": petcd}


@pytest.fixture
def etcd_env(monkeypatch):
    """Both packages' db/etcd.py on one install dir, tarball and ports;
    set(port_map) installs a port map in both."""
    monkeypatch.setenv("JEPSEN_TPU_ETCD_TARBALL", "file:///rel/etcd.tar.gz")
    for mod in ETCD.values():
        monkeypatch.setattr(mod, "DIR", "/scratch/etcd")
        monkeypatch.setattr(mod, "LOGFILE", "/scratch/etcd/etcd.log")
        monkeypatch.setattr(mod, "PIDFILE", "/scratch/etcd/etcd.pid")
        monkeypatch.setattr(mod, "CLIENT_PORT", 12379)
        monkeypatch.setattr(mod, "PEER_PORT", 12380)

    def set_map(raw: str):
        for mod in ETCD.values():
            monkeypatch.setattr(mod, "PORT_MAP", mod._parse_port_map(raw))

    set_map("")
    return set_map


@pytest.mark.parametrize("port_map", ["", "n1=2379/2380,n2=2479/2480"])
def test_etcd_db_commands_match(etcd_env, port_map):
    etcd_env(port_map)
    test = {"nodes": ["n1", "n2", "n3"]}
    logs = {}
    for pkg, mod in ETCD.items():
        log: list = []
        db = mod.EtcdDB(version="v3.1.5", settle_s=0)

        async def go():
            for n in test["nodes"]:
                r = Rec(n, log)
                await db.setup(test, r, n)
                await db.kill(test, r, n)
                await db.start(test, r, n)
                await db.teardown(test, r, n)
                log.append(db.log_files(test, n))

        asyncio.run(go())
        logs[pkg] = log
    assert logs["port"] == logs["jax"]
    assert any("--initial-cluster" in str(e) for e in logs["port"])


def test_daemon_helpers_match():
    logs = {}
    for pkg, mod in {"jax": jdaemon, "port": pdaemon}.items():
        log: list = []
        r = Rec("n1", log, fails=("kill -0",))

        async def go():
            await mod.install_archive(r, "file:///a b/etcd.tar.gz", "/d x")
            await mod.start_daemon(r, "/d x/etcd", ["--name", "n 1", 3],
                                   logfile="/d x/etcd.log",
                                   pidfile="/d x/etcd.pid", chdir="/d x",
                                   su=False)
            await mod.stop_daemon(r, "/d x/etcd.pid")

        asyncio.run(go())
        logs[pkg] = log
    assert logs["port"] == logs["jax"]


@pytest.mark.parametrize("fails", [(), ("command -v apt-get",),
                                   ("command -v procps",
                                    "command -v iptables")])
def test_debian_setup_commands_match(fails):
    logs = {}
    for pkg, mod in {"jax": jdebian, "port": pdebian}.items():
        log: list = []
        asyncio.run(mod.debian_setup(Rec("n1", log, fails), "n1"))
        logs[pkg] = log
    assert logs["port"] == logs["jax"]


SSH_CASES = {
    "key": dict(username="root", port=2222, private_key="/k/id"),
    "password": dict(username="root", password="pw"),
    "non-root": dict(username="admin", connect_timeout_s=3),
}


@pytest.mark.parametrize("case", sorted(SSH_CASES))
def test_ssh_runner_argv_and_env_match(case, monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name: f"/bin/{name}")
    calls = {}
    for pkg, mod in {"jax": jrunner, "port": prunner}.items():
        r = mod.SSHRunner("n1", **SSH_CASES[case])
        log: list = []

        async def spawn(argv, check, timeout_s, env=None, log=log):
            log.append((argv, check, timeout_s, env))
            return prunner.CommandResult(list(argv), 0, "", "")

        monkeypatch.setattr(r, "_spawn", spawn)

        async def go(r=r):
            await r.run("echo 'a b'", su=True)
            await r.run("ls", check=False, timeout_s=5)
            await r.download("/r/f", "/l/f", check=True)

        asyncio.run(go())
        calls[pkg] = log
    assert calls["port"] == calls["jax"]
    argv0, env0 = calls["port"][0][0], calls["port"][0][3]
    if case == "password":
        assert argv0[:2] == ["sshpass", "-e"] and "pw" not in argv0
        assert env0["SSHPASS"] == "pw"
    else:
        assert env0 is None
    assert ("sudo sh -c" in argv0[-1]) == (case == "non-root")


def test_ssh_password_without_sshpass_is_refused_alike(monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    msgs = []
    for mod in (jrunner, prunner):
        with pytest.raises(RuntimeError) as e:
            asyncio.run(mod.SSHRunner("n1", password="pw").run("ls"))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("test", [
    {"local_mode": True},
    {"ssh": {"username": "u", "port": 2200, "private_key": "/k",
             "password": None}},
    {}])
def test_runner_for_matches(test):
    """The same runner with the same settings. The JAX package's
    SSHRunner also keeps `strict` (host-key checking), which no caller
    sets; the port always runs as its default, False."""
    a, b = jrunner.runner_for(test, "n2"), prunner.runner_for(test, "n2")
    assert type(a).__name__ == type(b).__name__
    want = dict(vars(a))
    assert want.pop("strict", False) is False
    assert want == vars(b)


GRUDGES = ["random_halves", "isolated_node_grudge", "bridge_grudge",
           "majorities_ring_grudge"]
PARTITIONS = ["PartitionRandomHalves", "PartitionIsolatedNode",
              "PartitionBridge", "PartitionMajoritiesRing"]
OPS = {"jax": JOp, "port": POp}


def fault_run(pkg: str, nem, monkeypatch, mods, nodes, fs, fails=()):
    """Drive `nem` through setup, the nemesis ops fs and teardown with
    each module's runner_for recording: (commands, completions)."""
    log: list = []
    for mod in mods:
        monkeypatch.setattr(mod, "runner_for",
                            lambda test, node: Rec(node, log, fails))
    test = {"nodes": nodes}

    async def go():
        out = []
        await nem.setup(test)
        for f in fs:
            done = await nem.invoke(test, OPS[pkg](
                type="invoke", f=f, value=None, process="nemesis"))
            out.append((done.type, done.f, done.value))
        await nem.teardown(test)
        return out

    return log, asyncio.run(go())


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("n", [3, 5])
@pytest.mark.parametrize("kind", range(4))
def test_partition_grudges_and_commands_match(kind, n, seed, monkeypatch):
    nodes = NODES5[:n]
    assert getattr(ppart, GRUDGES[kind])(nodes, random.Random(seed)) == \
        getattr(jpart, GRUDGES[kind])(nodes, random.Random(seed))
    got = {}
    for pkg, mod in {"jax": jpart, "port": ppart}.items():
        nem = getattr(mod, PARTITIONS[kind])(seed=seed)
        got[pkg] = fault_run(pkg, nem, monkeypatch, [mod], nodes,
                             ["start", "stop", "start", "start", "stop"])
    assert got["port"] == got["jax"]
    assert sum("DROP" in c[1] for c in got["port"][0]) > 0 or \
        kind == 3 and n == 3


def test_bridge_needs_three_nodes():
    for mod in (jpart, ppart):
        with pytest.raises(ValueError, match=">= 3 nodes"):
            mod.bridge_grudge(["a", "b"], random.Random(0))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("kind", ["ClockSkewNemesis", "ClockStrobeNemesis"])
def test_clock_commands_match(kind, seed, monkeypatch):
    got = {}
    for pkg, mod in {"jax": jclock, "port": pclock}.items():
        nem = getattr(mod, kind)(seed=seed)
        # n2's date fails: it must not be recorded as skewed.
        got[pkg] = fault_run(pkg, nem, monkeypatch, [mod], NODES5,
                             ["start", "start", "stop", "start", "bogus"],
                             fails=("@$(( $(date +%s) + -",) if seed % 2
                             else ())
    assert got["port"] == got["jax"]
    if kind == "ClockStrobeNemesis":
        assert pclock.ClockStrobeNemesis()._burst_cmd(3) == \
            jclock.ClockStrobeNemesis()._burst_cmd(3)


class RecDB:
    def __init__(self, log):
        self.log = log

    async def kill(self, test, r, node):
        self.log.append(("kill", node, r.node))

    async def start(self, test, r, node):
        self.log.append(("start", node, r.node))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("kind", ["kill", "pause", "pause-fixed"])
def test_kill_and_pause_sequences_match(kind, seed, monkeypatch):
    got = {}
    for pkg, mod in {"jax": jproc, "port": pproc}.items():
        dbl: list = []
        if kind == "kill":
            nem = mod.KillNemesis(RecDB(dbl), seed=seed)
        else:
            nem = mod.PauseNemesis(
                (lambda n: f"/d/etcd-{n}.pid") if kind == "pause"
                else "/d/etcd.pid", seed=seed)
        log, out = fault_run(pkg, nem, monkeypatch, [mod], NODES5,
                             ["start", "stop", "start", "stop", "start",
                              "bogus"])
        got[pkg] = (log, out, dbl)
    assert got["port"] == got["jax"]


# -- composition ----------------------------------------------------------

NEMESIS_KINDS = ["partition", "partition-node", "partition-bridge",
                 "partition-ring", "clock", "clock-strobe", "kill", "pause",
                 "noop"]


@pytest.mark.parametrize("kind", NEMESIS_KINDS)
def test_etcd_test_maps_match(kind):
    opts = {"workload": "register", "time_limit": 0.5, "rate": 200.0,
            "nemesis_interval": 0.1, "recovery_wait": 0.05,
            "ops_per_key": 7, "seed": 3, "nemesis": kind, "device": "cpu",
            "version": "v3.4.0",
            "ssh": {"username": "u", "password": "pw", "port": 22,
                    "private_key": None}}
    jt, pt = jcompose.etcd_test(dict(opts)), pcompose.etcd_test(dict(opts))
    assert list(pt) == list(jt)
    for k in ("db", "nemesis", "client"):
        assert type(pt[k]).__name__ == type(jt[k]).__name__, k
    assert (pt["db"].version, pt["db"].settle_s) == \
        (jt["db"].version, jt["db"].settle_s)
    assert pt["ssh"] == jt["ssh"] and "local_mode" not in pt
    assert type(pt["client"].conn_factory(pt, "n1")).__name__ == \
        "EtcdClient"
    got = {pkg: script(t["generator"], pkg, seed=3, steps=400,
                       processes=list(range(10)) + ["nemesis"],
                       t_step=10**9 // 200)
           for pkg, t in (("jax", jt), ("port", pt))}
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("kind", NEMESIS_KINDS + ["bogus"])
def test_pick_nemesis_matches_both_registries(kind):
    from jepsen_etcd_demo_tpu.clients import fake_kv as jfake
    from jepsen_etcd_demo_tpu_torch.clients import fake_kv as pfake

    opts = {"nemesis": kind, "seed": 2}
    for store in (None, "fake"):
        outs = []
        for cmp, fake in ((jcompose, jfake), (pcompose, pfake)):
            try:
                nem = cmp.pick_nemesis(
                    opts, store=fake.FakeKVStore() if store else None,
                    db=object())
                outs.append(type(nem).__name__)
            except ValueError as e:
                outs.append(("ValueError", str(e)))
        assert outs[0] == outs[1], (store, outs)


# -- the oracle backend ---------------------------------------------------

ORACLE_FIELDS = ("valid", "dead_step", "max_frontier", "configs_explored",
                 "op_count", "backend", "failed_op")


@pytest.mark.parametrize("seed,mutate", [(30, False), (31, True),
                                         (32, True), (33, False),
                                         (34, True), (35, True)])
def test_oracle_backend_matches_jax(seed, mutate):
    hj, hp = fuzz_pair(seed, n_ops=40, n_procs=5, mutate=mutate)
    want = JLin(backend="oracle").check({}, hj)
    got = Linearizable(backend="oracle", device="cpu").check({}, hp)
    assert {f: got.get(f) for f in ORACLE_FIELDS} == \
        {f: want.get(f) for f in ORACLE_FIELDS}
    assert got["backend"] == "oracle"


@pytest.mark.parametrize("seed", [36, 37, 38])
def test_oracle_search_and_event_to_step_match_jax(seed):
    """check_events_oracle's whole result, and _event_to_step's return
    step of any event, as the JAX package's on one encoded history."""
    hj, hp = fuzz_pair(seed, n_ops=60, n_procs=6, p_info=0.1)
    je, pe = jenc(hj, k_slots=24), encode_register_history(hp, k_slots=24)
    assert poracle.check_events_oracle(pe, PM()).to_dict() == \
        joracle.check_events_oracle(je, JM()).to_dict()
    for ev in (-1, 0, 1, pe.n_events // 2, pe.n_events):
        assert plinmod._event_to_step(pe, ev) == \
            jlinmod._event_to_step(je, ev)


@pytest.mark.parametrize("seed", [40, 41])
def test_independent_oracle_backend_matches_jax(seed):
    rng_j, rng_p = random.Random(seed), random.Random(seed)
    per_j = [jfuzz.gen_register_history(rng_j, n_ops=30, n_procs=5)
             for _ in range(3)]
    per_p = [pfuzz.gen_register_history(rng_p, n_ops=30, n_procs=5)
             for _ in range(3)]
    per_j[1] = jfuzz.mutate_history(random.Random(seed + 1), per_j[1])
    per_p[1] = pfuzz.mutate_history(random.Random(seed + 1), per_p[1])
    want = JInd(JLin(backend="oracle")).check(
        {}, jfuzz.interleave_keyed(per_j))
    got = IndependentChecker(Linearizable(backend="oracle", device="cpu")) \
        .check({}, pfuzz.interleave_keyed(per_p))
    assert got["valid"] == want["valid"] and got["key_count"] == 3
    for k, r in got["results"].items():
        assert {f: r.get(f) for f in ORACLE_FIELDS} == \
            {f: want["results"][k].get(f) for f in ORACLE_FIELDS}


# -- whole runs through the CLI -------------------------------------------

def start_run(root: Path, flags: list, port_map: str | None = None):
    env = cluster_env(root, port_map)
    p = subprocess.Popen(
        [sys.executable, "-m", "jepsen_etcd_demo_tpu_torch.cli", "test",
         "-w", "register", "--store", str(root / "store"), "--seed", "5",
         "--device", "cpu", "--rate", "50", "--recovery-wait", "1",
         *flags],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    return p, root


def finish_run(started, timeout_s: float = 300):
    p, root = started
    try:
        out, err = p.communicate(timeout=timeout_s)
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate()
    runs = sorted((root / "store").glob("*/*/history.jsonl"))
    run_dir = runs[0].parent if runs else None
    return {"rc": p.returncode, "out": out, "err": err, "root": root,
            "run_dir": run_dir,
            "line": json.loads(out.strip().splitlines()[-1]) if out.strip()
            else None}


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Two `cli test` runs without --fake, side by side: (one) one node,
    the noop nemesis, a password; (two) two co-hosted minietcds posing
    as a cluster (they do not replicate: a broken cluster)."""
    one = start_run(tmp_path_factory.mktemp("one"),
                    ["--nodes", "localhost", "--nemesis", "noop",
                     "--time-limit", "3", "--concurrency", "5",
                     "--password", "sekrit-pw"])
    ports = [free_port() for _ in range(4)]
    two = start_run(tmp_path_factory.mktemp("two"),
                    ["--nodes", "localhost,127.0.0.1", "--nemesis", "noop",
                     "--time-limit", "3", "--concurrency", "4"],
                    port_map=(f"localhost={ports[0]}/{ports[1]},"
                              f"127.0.0.1={ports[2]}/{ports[3]}"))
    return {"one": finish_run(one), "two": finish_run(two)}


def test_cli_run_against_minietcd(cli_runs):
    r = cli_runs["one"]
    assert r["rc"] == 0, (r["out"][-1000:], r["err"][-3000:])
    assert r["line"]["valid"] is True
    run_dir = r["run_dir"]
    hist = [json.loads(ln) for ln in
            (run_dir / "history.jsonl").read_text().splitlines()]
    assert any(op["type"] == "ok" for op in hist)
    test_json = (run_dir / "test.json").read_text()
    assert "sekrit-pw" not in test_json and "<redacted>" in test_json
    assert "minietcd" in (run_dir / "localhost-etcd.log").read_text()
    assert_members_served(run_dir)
    etcd_dir = r["root"] / "opt" / "etcd"
    assert not etcd_dir.exists()
    asked = (r["root"] / "apt-get.log").read_text().splitlines()
    assert asked[0] == "-y update" and "procps" in asked[1]


def assert_members_served(run_dir: Path) -> None:
    """Every member's log has minietcd's "serving client requests" line:
    each bound the ports the run chose for it in advance."""
    logs = sorted(run_dir.glob("*-etcd*.log"))
    assert logs
    for log in logs:
        assert "serving client requests" in log.read_text(), log


def _copy(run_dir: Path, tmp_path: Path, name: str) -> Path:
    dst = tmp_path / name
    shutil.copytree(run_dir, dst)
    return dst


def linear_of(run_dir: Path, fields=("valid", "dead_step", "max_frontier",
                                     "configs_explored", "op_count")):
    res = json.loads((run_dir / "results.json").read_text())
    return res["valid"], {k: {f: v["linear"].get(f) for f in fields}
                          for k, v in res["indep"]["results"].items()}


@pytest.mark.parametrize("run", ["one", "two"])
def test_cli_runs_recheck_alike(cli_runs, run, tmp_path):
    """JAX analyze, the port's analyze on the CPU and its oracle backend
    give the run's verdict, key for key."""
    r = cli_runs[run]
    assert r["rc"] == (0 if run == "one" else 1), r["err"][-3000:]
    assert_members_served(r["run_dir"])
    stored = linear_of(r["run_dir"])
    jdir = _copy(r["run_dir"], tmp_path, "jax")
    assert jcli(["analyze", str(jdir)]) == r["rc"]
    pdir = _copy(r["run_dir"], tmp_path, "port")
    assert cli.main(["analyze", str(pdir), "--device", "cpu"]) == r["rc"]
    odir = _copy(r["run_dir"], tmp_path, "oracle")
    assert cli.main(["analyze", str(odir), "--device", "cpu",
                     "--backend", "oracle"]) == r["rc"]
    assert linear_of(pdir) == stored
    verdicts = ("valid", "dead_step", "op_count")
    assert linear_of(jdir, verdicts) == linear_of(pdir, verdicts)
    assert linear_of(odir, verdicts) == linear_of(pdir, verdicts)
    backends = {v["linear"]["backend"] for v in json.loads(
        (odir / "results.json").read_text())["indep"]["results"].values()}
    assert backends == {"oracle"}


def test_divergent_two_node_cluster_is_invalid(cli_runs):
    r = cli_runs["two"]
    assert r["rc"] == 1, (r["out"][-1000:], r["err"][-3000:])
    assert r["line"]["valid"] is False
    witnesses = sorted(r["run_dir"].glob("linear*.json"))
    assert witnesses, list(r["run_dir"].iterdir())
    w = json.loads(witnesses[0].read_text())
    assert w["valid"] is False and w.get("op")
    logs = {p.name for p in r["run_dir"].glob("*-etcd-*.log")}
    assert logs == {"localhost-etcd-localhost.log",
                    "127.0.0.1-etcd-127.0.0.1.log"}


def _nemesis_run(tmp_path, kind: str, limit: str):
    r = finish_run(start_run(tmp_path, [
        "--nodes", "localhost", "--nemesis", kind, "--time-limit", limit,
        "--concurrency", "5", "--rate", "20"]), timeout_s=600)
    assert r["rc"] == 0, (r["out"][-1000:], r["err"][-3000:])
    assert r["line"]["valid"] is True
    hist = [json.loads(ln) for ln in
            (r["run_dir"] / "history.jsonl").read_text().splitlines()]
    nem = [op for op in hist if op["process"] == "nemesis"
           and op["type"] == "info" and isinstance(op["value"], dict)]
    return hist, nem


@pytest.mark.slow
def test_kill_nemesis_against_minietcd(tmp_path):
    """kill -9 mid-run, db.start as the restart (no reinstall): acked
    writes survive in the data dir, ops are served before the first kill
    and after the first restart, and the history checks valid."""
    hist, nem = _nemesis_run(tmp_path, "kill", "32")
    assert any(op["value"].get("killed") == ["localhost"] for op in nem)
    restarts = [i for i, op in enumerate(hist)
                if op["process"] == "nemesis" and op["type"] == "info"
                and isinstance(op["value"], dict)
                and op["value"].get("restarted") == ["localhost"]]
    first_kill = next(i for i, op in enumerate(hist)
                      if op["process"] == "nemesis" and op["f"] == "start")
    assert restarts
    assert any(op["type"] == "ok" for op in hist[:first_kill])
    assert any(op["type"] == "ok" for op in hist[restarts[0]:])


@pytest.mark.slow
def test_pause_nemesis_against_minietcd(tmp_path):
    """SIGSTOP and SIGCONT by pidfile: the paused server takes
    connections and answers nothing (ops time out as :info), resumes
    without a restart, and the history checks valid."""
    hist, nem = _nemesis_run(tmp_path, "pause", "12")
    assert any(op["value"].get("paused") == ["localhost"] for op in nem)
    assert any(op["value"].get("resumed") == ["localhost"] for op in nem)
    assert any(op["type"] == "ok" for op in hist)
