"""Checkers of the port: linearizability, independent keys, the oracle."""

from .base import Checker, merge_valid  # noqa: F401
from .independent import IndependentChecker, split_by_key  # noqa: F401
from .linearizable import Linearizable  # noqa: F401
