"""OS preparation, the jepsen.os.debian equivalent
(src/jepsen/etcdemo.clj:20,161): make sure the tools the archive install
and the fault injection use are on each node."""

from __future__ import annotations

import logging

from ..control.runner import Runner

log = logging.getLogger(__name__)

PACKAGES = ["curl", "wget", "tar", "iptables", "procps"]


async def debian_setup(r: Runner, node: str) -> None:
    res = await r.run("command -v apt-get", check=False)
    if not res.ok:
        log.info("%s: no apt-get; skipping OS prep", node)
        return
    missing = []
    for p in PACKAGES:
        have = await r.run(f"command -v {p}", check=False)
        if not have.ok:
            missing.append(p)
    if missing:
        log.info("%s: installing %s", node, missing)
        # A fresh node's package lists are stale or empty: update first,
        # as jepsen.os.debian does.
        await r.run("DEBIAN_FRONTEND=noninteractive apt-get -y update",
                    su=True, check=False, timeout_s=600.0)
        await r.run(
            "DEBIAN_FRONTEND=noninteractive apt-get -y install "
            + " ".join(missing),
            su=True, check=False, timeout_s=600.0)
