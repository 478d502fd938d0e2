"""The hermetic cluster of the port's real-cluster path, shared by the
CPU tests (tests/test_torch_cluster.py) and chip_smoke.py's phase
`cluster`: ssh, scp, sshpass and apt-get stand-ins on PATH, minietcd's
release tarball in place of etcd's, and the JEPSEN_TPU_ETCD_* variables
that put the install dir and the ports under one root. Imports neither
torch nor JAX."""

from __future__ import annotations

import os
import random
import socket
import sys
from pathlib import Path

# Stand-ins for the remote-control binaries: ssh runs the command here,
# scp copies here, sshpass insists on the SSHPASS variable (-e); apt-get
# installs nothing.
CLUSTER_SHIMS = {
    "ssh": r'''#!SHEBANG
"""ssh stand-in: run the remote command here with sh -c."""
import subprocess, sys
args, i, dest, cmd = sys.argv[1:], 0, None, None
while i < len(args):
    a = args[i]
    if a in ("-p", "-o", "-i"):
        i += 2
        continue
    if a.startswith("-"):
        i += 1
        continue
    dest = a
    cmd = args[i + 1] if i + 1 < len(args) else None
    break
if dest is None or cmd is None:
    sys.exit(255)
sys.exit(subprocess.run(["sh", "-c", cmd]).returncode)
''',
    "scp": r'''#!SHEBANG
"""scp stand-in: a local copy, user@host: prefixes stripped."""
import shutil, sys
args, i, paths = sys.argv[1:], 0, []
while i < len(args):
    a = args[i]
    if a in ("-P", "-o", "-i"):
        i += 2
        continue
    if a.startswith("-"):
        i += 1
        continue
    paths.append(a.split(":", 1)[1] if ("@" in a and ":" in a) else a)
    i += 1
if len(paths) != 2:
    sys.exit(255)
try:
    shutil.copyfile(paths[0], paths[1])
except OSError as e:
    print(e, file=sys.stderr)
    sys.exit(1)
sys.exit(0)
''',
    "sshpass": r'''#!SHEBANG
"""sshpass stand-in: the password must arrive in SSHPASS (-e)."""
import os, subprocess, sys
args = sys.argv[1:]
if not args or args[0] != "-e" or not os.environ.get("SSHPASS"):
    sys.exit(254)
sys.exit(subprocess.run(args[1:]).returncode)
''',
    "apt-get": '''#!/bin/sh
echo "$@" >> "$APT_LOG"
exit 100
''',
}


# The ports free_port has handed out in this process: never twice.
_HANDED_OUT: set[int] = set()


def _ephemeral_low() -> int:
    """The low end of the kernel's ephemeral port range (32768 by
    default), from which bind(("", 0)) and an outgoing connect take
    their ports."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            return int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 32768


def free_port() -> int:
    """A port nothing listens on now, distinct from every port this
    process handed out before. etcd's argv names its ports, so a run's
    are chosen before its members start, seconds before they bind. The
    port is drawn below the kernel's ephemeral range, so no bind to port
    0 and no outgoing connection of another process can take it in that
    gap; runs side by side (chip_smoke.py's phase `cluster`) each get
    their own. A member that finds its port taken fails to bind and
    never logs minietcd's "serving client requests" line, which the runs
    check for."""
    low = _ephemeral_low()
    if low > 11024:
        rng = random.SystemRandom()
        for _ in range(1000):
            port = rng.randrange(10000, low)
            if port in _HANDED_OUT:
                continue
            with socket.socket() as s:
                try:
                    s.bind(("127.0.0.1", port))
                except OSError:
                    continue
            _HANDED_OUT.add(port)
            return port
    while True:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        if port not in _HANDED_OUT:
            _HANDED_OUT.add(port)
            return port


def cluster_env(root: Path, port_map: str | None = None,
                settle_s: float = 3.0) -> dict:
    """The environment of a hermetic real-cluster run under `root`: the
    stand-ins first on PATH, minietcd's release tarball, an install dir,
    a TMPDIR, free ports and the wait after each start (settle_s);
    `port_map` puts several nodes on this host
    (JEPSEN_TPU_ETCD_PORT_MAP)."""
    from jepsen_etcd_demo_tpu_torch.db.minietcd import make_release_tarball

    shims = root / "bin"
    shims.mkdir(parents=True)
    for name, body in CLUSTER_SHIMS.items():
        p = shims / name
        p.write_text(body.replace("SHEBANG", sys.executable, 1))
        p.chmod(0o755)
    tarball = make_release_tarball(str(root / "etcd-rel.tar.gz"))
    env = dict(os.environ,
               PATH=f"{shims}{os.pathsep}{os.environ['PATH']}",
               TMPDIR=str(root),
               APT_LOG=str(root / "apt-get.log"),
               JEPSEN_TPU_ETCD_DIR=str(root / "opt" / "etcd"),
               JEPSEN_TPU_ETCD_TARBALL=f"file://{tarball}",
               JEPSEN_TPU_ETCD_SETTLE_S=str(settle_s),
               JEPSEN_TPU_ETCD_CLIENT_PORT=str(free_port()),
               JEPSEN_TPU_ETCD_PEER_PORT=str(free_port()))
    if port_map is not None:
        env["JEPSEN_TPU_ETCD_PORT_MAP"] = port_map
    return env
