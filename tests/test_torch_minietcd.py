"""The port's minietcd (db/minietcd.py) against the JAX package's: one
scripted request sequence over HTTP against each server, equal status
codes, headers and JSON bodies; snapshots that load in the other server;
the same flag surface, version line and release-tarball layout."""

from __future__ import annotations

import http.client
import json
import os
import tarfile
import threading
from http.server import ThreadingHTTPServer
from urllib.parse import urlencode

import pytest

from jepsen_etcd_demo_tpu.db import etcd as jetcd
from jepsen_etcd_demo_tpu.db import minietcd as jmini
from jepsen_etcd_demo_tpu_torch.db import etcd as petcd
from jepsen_etcd_demo_tpu_torch.db import minietcd as pmini

MODS = {"jax": jmini, "port": pmini}


class Served:
    """A server of `mod` on an ephemeral localhost port, in this
    process."""

    def __init__(self, mod, data_dir=None):
        self.store = mod.KeyStore(data_dir)
        self.server = ThreadingHTTPServer(("127.0.0.1", 0),
                                          mod._handler_for(self.store))
        self.server.daemon_threads = True
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()


# (method, path, query, form body)
SCRIPT = [
    ("GET", "/v2/keys/missing", {}, None),
    ("PUT", "/v2/keys/r0", {}, {"value": "1"}),
    ("GET", "/v2/keys/r0", {"quorum": "true"}, None),
    ("PUT", "/v2/keys/r0", {"prevValue": "0"}, {"value": "2"}),
    ("PUT", "/v2/keys/r0", {"prevValue": "1"}, {"value": "2"}),
    ("PUT", "/v2/keys/r0", {"prevIndex": "1"}, {"value": "3"}),
    ("PUT", "/v2/keys/r0", {"prevIndex": "2"}, {"value": "3"}),
    ("PUT", "/v2/keys/ghost", {"prevValue": "0"}, {"value": "1"}),
    # The compare field in the body, not the query: still a CAS.
    ("PUT", "/v2/keys/r0", {}, {"value": "4", "prevValue": "9"}),
    ("POST", "/v2/keys/q", {}, {"value": "a"}),
    ("POST", "/v2/keys/q", {}, {"value": "b"}),
    ("POST", "/v2/keys/q", {}, {"value": "c"}),
    ("GET", "/v2/keys/q", {"recursive": "true", "sorted": "true",
                           "quorum": "true"}, None),
    ("DELETE", "/v2/keys/q/00000000000000000004", {"prevIndex": "5"}, None),
    ("DELETE", "/v2/keys/q/00000000000000000004", {"prevIndex": "4"}, None),
    ("DELETE", "/v2/keys/q/00000000000000000004", {}, None),
    ("DELETE", "/v2/keys/q/00000000000000000005", {}, {"prevIndex": "4"}),
    ("GET", "/v2/keys/q", {}, None),
    ("PUT", "/v2/keys/q", {}, {"value": "x"}),          # 102 not a file
    ("POST", "/v2/keys/r0", {}, {"value": "x"}),        # 104 not a dir
    ("PUT", "/v2/keys/r0/sub", {}, {"value": "x"}),     # 104 under a file
    ("GET", "/health", {}, None),
    ("GET", "/version", {}, None),
]


def replay(port: int) -> list:
    """SCRIPT over one keep-alive connection: (status, X-Etcd-Index,
    Content-Type, body) per request."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    out = []
    try:
        for method, path, query, form in SCRIPT:
            url = path + (f"?{urlencode(query)}" if query else "")
            body = urlencode(form) if form is not None else None
            headers = ({"Content-Type": "application/x-www-form-urlencoded"}
                       if form is not None else {})
            conn.request(method, url, body=body, headers=headers)
            resp = conn.getresponse()
            out.append((resp.status, resp.getheader("X-Etcd-Index"),
                        resp.getheader("Content-Type"),
                        json.loads(resp.read())))
    finally:
        conn.close()
    return out


def test_scripted_requests_get_the_same_replies():
    got = {}
    for name, mod in MODS.items():
        s = Served(mod)
        try:
            got[name] = replay(s.port)
        finally:
            s.close()
    assert got["port"] == got["jax"]
    codes = [r[3].get("errorCode") for r in got["port"]]
    assert {100, 101, 102, 104} <= set(codes)
    assert [n["value"] for n in got["port"][12][3]["node"]["nodes"]] \
        == ["a", "b", "c"]


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_a_data_dir_loads_in_the_other_server(tmp_path, writer, reader):
    """The snapshot is the JAX format byte for byte: the state one server
    carried to disk is what the other serves after a restart."""
    dirs = {}
    for name in (writer, reader):
        d = tmp_path / name
        d.mkdir()
        st = MODS[name].KeyStore(str(d))
        st.put("k", "v", None, None)
        st.post("q", "x")
        st.post("q", "y")
        st.delete("q/00000000000000000002", 2)
        st.put("k", "w", "v", None)
        dirs[name] = d
    assert (dirs[writer] / "minietcd.json").read_bytes() == \
        (dirs[reader] / "minietcd.json").read_bytes()
    loaded = MODS[reader].KeyStore(str(dirs[writer]))
    assert (loaded.index, loaded.data) == (4, {
        "k": ("w", 4), "q/00000000000000000003": ("y", 3)})
    s = Served(MODS[reader], str(dirs[writer]))
    try:
        conn = http.client.HTTPConnection("127.0.0.1", s.port, timeout=10)
        conn.request("GET", "/v2/keys/k")
        assert json.loads(conn.getresponse().read())["node"] == {
            "key": "/k", "value": "w", "modifiedIndex": 4,
            "createdIndex": 4}
        conn.close()
    finally:
        s.close()


ETCDDB_ARGV = ["--log-output", "stderr", "--name", "n1",
               "--listen-peer-urls", "http://n1:2380",
               "--listen-client-urls", "http://n1:2379",
               "--advertise-client-urls", "http://n1:2379",
               "--initial-cluster-state", "new",
               "--initial-advertise-peer-urls", "http://n1:2380",
               "--initial-cluster", "n1=http://n1:2380"]


@pytest.mark.parametrize("argv", [
    ETCDDB_ARGV, [], ["--data-dir", "/d", "--enable-v2"],
    ["--enable-v2", "false", "--version"], ["--name", "x", "--version"]])
def test_flag_surface_parses_alike(argv):
    assert vars(pmini.build_parser().parse_args(argv)) == \
        vars(jmini.build_parser().parse_args(argv))


@pytest.mark.parametrize("argv", [["--no-such-flag", "x"],
                                  ["--initial-cluster"], ["positional"]])
def test_unknown_flags_are_rejected_alike(argv):
    for mod in MODS.values():
        with pytest.raises(SystemExit):
            mod.build_parser().parse_args(argv)


def test_version_line(capsys):
    out = {}
    for name, mod in MODS.items():
        assert mod.main(["--version"]) == 0
        out[name] = capsys.readouterr().out
    assert out["port"] == out["jax"] and pmini.VERSION == jmini.VERSION
    major, minor = pmini.VERSION.split(".")[:2]
    assert (int(major), int(minor)) < (3, 2)


@pytest.mark.parametrize("version", ["v3.1.5", "v3.4.0"])
def test_release_tarball_layout(tmp_path, version):
    names = {}
    for name, mod in MODS.items():
        tb = mod.make_release_tarball(str(tmp_path / f"{name}.tar.gz"),
                                      version)
        with tarfile.open(tb) as tar:
            names[name] = [m.name for m in tar.getmembers()]
            body = tar.extractfile(names[name][0]).read().decode()
        assert (name == "port") == (
            "jepsen_etcd_demo_tpu_torch.db.minietcd" in body)
    assert names["port"] == names["jax"] == [
        f"etcd-{version}-linux-amd64/etcd"]
    assert petcd.tarball_url(version) == jetcd.tarball_url(version)


def test_launcher_is_executable_and_names_the_port(tmp_path):
    p = pmini.write_launcher(str(tmp_path / "etcd"))
    assert os.access(p, os.X_OK)
    body = open(p).read()
    assert "-m jepsen_etcd_demo_tpu_torch.db.minietcd" in body
    j = open(jmini.write_launcher(str(tmp_path / "etcd-jax"))).read()

    def code(text):
        return [ln for ln in text.splitlines() if not ln.startswith("# ")]

    assert code(body) == code(j.replace(
        "jepsen_etcd_demo_tpu.db.minietcd",
        "jepsen_etcd_demo_tpu_torch.db.minietcd"))


@pytest.mark.parametrize("raw", ["", " , ", "n1=2379/2380, n2=2479/2480",
                                 "localhost=1/2,127.0.0.1=3/4"])
def test_port_map_and_topology_helpers(raw, monkeypatch):
    """The JEPSEN_TPU_ETCD_* resolution: per-node ports, pidfiles and
    logfiles under the port map, the reference's paths off it."""
    pm = petcd._parse_port_map(raw)
    assert pm == jetcd._parse_port_map(raw)
    for mod in (petcd, jetcd):
        monkeypatch.setattr(mod, "PORT_MAP", mod._parse_port_map(raw))
    for node in ("n1", "n2", "localhost", "127.0.0.1", "other"):
        for fn in ("client_port_for", "peer_port_for", "pidfile_for",
                   "logfile_for", "peer_url", "client_url"):
            assert getattr(petcd, fn)(node) == getattr(jetcd, fn)(node), fn
    nodes = ["n1", "n2", "other"]
    assert petcd.initial_cluster(nodes) == jetcd.initial_cluster(nodes)
    assert petcd.node_url("n", 1) == jetcd.node_url("n", 1)


@pytest.mark.parametrize("mode", ["disk-full", "corrupt-write"])
def test_fault_plane_snapshots_alike(tmp_path, monkeypatch, mode):
    """The env-gated persistence fault bends both servers' snapshots the
    same way, and neither without the gate."""
    monkeypatch.setenv(jmini.FAULT_HOOK_ENV, "1")
    assert pmini.FAULT_HOOK_ENV == jmini.FAULT_HOOK_ENV
    snaps = {}
    for name, mod in MODS.items():
        d = tmp_path / name
        d.mkdir()
        st = mod.KeyStore(str(d))
        st.put("a", "1", None, None)
        st.fault_mode = mode
        st.put("b", "7", None, None)
        st.put("a", "2", None, None)
        snaps[name] = ((d / "minietcd.json").read_text(), st.faults_injected,
                       mod.KeyStore(str(d)).data)
    assert snaps["port"] == snaps["jax"]
    assert snaps["port"][1] == 2


def test_fault_plane_starts_without_torch(tmp_path):
    """minietcd, its fault plane included, runs on the standard library:
    with torch blocked it serves, bends a snapshot and starts as a
    daemon's process would."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    code = (
        "import os, sys\n"
        "sys.modules['torch'] = None\n"
        "from jepsen_etcd_demo_tpu_torch.db import minietcd as m\n"
        "os.environ[m.FAULT_HOOK_ENV] = '1'\n"
        f"st = m.KeyStore({str(tmp_path)!r})\n"
        "st.put('k', '1', None, None)\n"
        "st.fault_mode = m.FAULT_DISK_FULL\n"
        "st.put('k', '2', None, None)\n"
        f"again = m.KeyStore({str(tmp_path)!r})\n"
        "assert again.data['k'][0] == '1' and st.faults_injected == 1\n"
        "assert not any(n == 'torch' or n.startswith('torch.')\n"
        "               for n, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0 and p.stdout.strip() == "ok", p.stderr[-3000:]
    p = subprocess.run(
        [sys.executable, "-c",
         "import runpy, sys; sys.modules['torch'] = None; "
         "sys.argv = ['minietcd', '--version']; "
         "runpy.run_module('jepsen_etcd_demo_tpu_torch.db.minietcd', "
         "run_name='__main__')"],
        cwd=root, capture_output=True, text=True, timeout=120)
    assert p.returncode == 0 and "minietcd" in p.stdout, p.stderr[-3000:]
