"""DB orchestration layer: the jepsen.db protocol
(src/jepsen/etcdemo.clj:30-65), the etcd DB of a real cluster with its
topology helpers, the OS preparation, and the no-op DB of the fake
cluster. db/minietcd.py is an etcd-compatible server that stands in for
etcd where no etcd binary is installed."""

from .base import DB  # noqa: F401
from .debian import debian_setup  # noqa: F401
from .etcd import (EtcdDB, client_url, initial_cluster,  # noqa: F401
                   node_url, peer_url)
from .fake import FakeDB  # noqa: F401
