"""Checkers of the port: linearizability, independent keys, the oracle,
the set workload's durability check, and the elle transactional
checkers."""

from .base import Checker, merge_valid  # noqa: F401
from .elle import ElleChecker, ElleRwChecker, TxnEncodeError  # noqa: F401
from .independent import IndependentChecker, split_by_key  # noqa: F401
from .linearizable import Linearizable  # noqa: F401
from .set_checker import SetChecker  # noqa: F401
