"""Client layer: the five-method lifecycle protocol and the workloads'
clients over the in-process fake cluster (register client:
src/jepsen/etcdemo.clj:76-108; set client: src/jepsen/etcdemo/set.clj:10-40).
The real cluster's HTTP client is not ported."""

from .base import (Client, ClientError, ConnectionRefused,  # noqa: F401
                   NotFound, Timeout)
from .fake_kv import FakeKVStore  # noqa: F401
from .mutex_client import MutexClient  # noqa: F401
from .queue_client import QueueClient  # noqa: F401
from .register import (MultiRegisterClient, RegisterClient,  # noqa: F401
                       fake_conn_factory)
from .set_client import SetClient  # noqa: F401
from .txn import TxnClient  # noqa: F401
