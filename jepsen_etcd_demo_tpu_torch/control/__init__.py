"""Remote-control plane: run commands on cluster nodes (jepsen.control and
control.util; src/jepsen/etcdemo.clj:36-60: c/su, c/exec,
cu/install-archive!, cu/start-daemon!, cu/stop-daemon!). The transport
is the system `ssh` binary; a LocalRunner runs the same commands on this
host for the fake cluster."""

from .daemon import (install_archive, start_daemon,  # noqa: F401
                     stop_daemon)
from .runner import (  # noqa: F401
    CommandError, CommandResult, LocalRunner, Runner, SSHRunner,
    runner_for, shellquote,
)
