"""Daemon and archive helpers, the jepsen.control.util equivalents:
cu/install-archive! (fetch and unpack a release tarball,
src/jepsen/etcdemo.clj:37-40), cu/start-daemon! (daemonize with pidfile,
logfile and working directory, :42-54), cu/stop-daemon! (kill by
pidfile, :59).
"""

from __future__ import annotations

from typing import Sequence

from .runner import Runner, shellquote


async def install_archive(r: Runner, url: str, dest_dir: str,
                          su: bool = True) -> None:
    """Fetch `url` (a tar.gz) and unpack it into dest_dir, dropping the
    top-level directory as cu/install-archive! does. The download lands
    in the node's $TMPDIR, /tmp when unset."""
    tmp = f'"${{TMPDIR:-/tmp}}"/jepsen-archive-{abs(hash(url)) % 10**8}.tar.gz'
    await r.run(
        f"mkdir -p {shellquote(dest_dir)} && "
        f"([ -f {tmp} ] || "
        f" wget -q -O {tmp} {shellquote(url)} || "
        f" curl -fsSL -o {tmp} {shellquote(url)}) && "
        f"tar xzf {tmp} -C {shellquote(dest_dir)} "
        f"--strip-components=1",
        su=su, timeout_s=600.0)


async def start_daemon(r: Runner, binary: str, args: Sequence,
                       logfile: str, pidfile: str, chdir: str,
                       su: bool = True) -> None:
    """Start `binary args...` as a daemon: setsid + nohup, stdout and
    stderr to logfile, its pid in pidfile. A live pidfile means it is
    already running (cu/start-daemon!)."""
    argstr = " ".join(shellquote(a) for a in args)
    await r.run(
        f"if [ -f {shellquote(pidfile)} ] && "
        f"kill -0 $(cat {shellquote(pidfile)}) 2>/dev/null; then "
        f"  echo already-running; "
        f"else "
        f"  cd {shellquote(chdir)} && "
        f"  setsid nohup {shellquote(binary)} {argstr} "
        f"  >> {shellquote(logfile)} 2>&1 < /dev/null & "
        f"  echo $! > {shellquote(pidfile)}; "
        f"fi",
        su=su, timeout_s=60.0)


async def stop_daemon(r: Runner, pidfile: str, su: bool = True) -> None:
    """SIGKILL the daemon by pidfile (cu/stop-daemon!) and remove the
    pidfile; nothing happens without one."""
    await r.run(
        f"if [ -f {shellquote(pidfile)} ]; then "
        f"  kill -9 $(cat {shellquote(pidfile)}) 2>/dev/null || true; "
        f"  rm -f {shellquote(pidfile)}; "
        f"fi",
        su=su, check=False, timeout_s=60.0)
