"""Remote-control plane: run commands on cluster nodes (jepsen.control).

Only the local runner that hermetic runs use is ported; the SSH transport
of the real-cluster path is not."""

from .runner import (  # noqa: F401
    CommandError, CommandResult, LocalRunner, Runner, runner_for,
    shellquote,
)
