"""The run loop, the jepsen.core/run! equivalent: node setup, concurrent
client workers and the nemesis interpreting the generator, history
recording, phased shutdown, teardown, the check and the store."""

from .core import event_loop, interpret_generators, run_test  # noqa: F401
from .history import HistoryRecorder  # noqa: F401
