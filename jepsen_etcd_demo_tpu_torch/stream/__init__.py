"""The streaming check (`test --check-mode stream`): the recorded ops are
encoded and swept while the run goes on, and `--fail-fast` ends a run
once a check has failed. engine.py holds the linearizability session,
elle.py the transactional one."""

from .elle import ElleStreamSession
from .engine import KeyStream, StreamSession, session_for_test

__all__ = ["ElleStreamSession", "KeyStream", "StreamSession",
           "session_for_test"]
