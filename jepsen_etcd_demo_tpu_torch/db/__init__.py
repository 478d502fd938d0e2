"""DB orchestration layer: the jepsen.db protocol
(src/jepsen/etcdemo.clj:30-65). Only the no-op DB of the fake cluster is
ported; the etcd DB of the real-cluster path is not."""

from .base import DB  # noqa: F401
from .fake import FakeDB  # noqa: F401
