"""Checkers of the port: linearizability, independent keys, the oracle,
the set workload's durability check, the elle transactional checkers,
and the harness's compose, perf and timeline checkers."""

from .base import Checker, merge_valid  # noqa: F401
from .compose import Compose  # noqa: F401
from .elle import ElleChecker, ElleRwChecker, TxnEncodeError  # noqa: F401
from .independent import IndependentChecker, split_by_key  # noqa: F401
from .linearizable import Linearizable  # noqa: F401
from .perf import PerfChecker  # noqa: F401
from .set_checker import SetChecker  # noqa: F401
from .timeline import TimelineChecker  # noqa: F401
