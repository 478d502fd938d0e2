"""State-machine models the port checks for linearizability.

Each model has `step_py` (Python scalars, for the oracle) and `step`
(branchless torch, for the column-mask preparation and the sort search
on the device). States richer than a scalar (sets, queues, register
files) are bit-packed into one int32, so every model runs on the same
kernels.
"""

from .base import Model  # noqa: F401
from .cas_register import CASRegister  # noqa: F401
from .gset import GSet  # noqa: F401
from .multi_register import MultiRegister  # noqa: F401
from .mutex import Mutex  # noqa: F401
from .queues import FIFOQueue, UnorderedQueue  # noqa: F401
from .register import Register  # noqa: F401

REGISTRY = {
    "cas-register": CASRegister,
    "register": Register,
    "mutex": Mutex,
    "gset": GSet,
    "unordered-queue": UnorderedQueue,
    "fifo-queue": FIFOQueue,
    "multi-register": MultiRegister,
}


def get_model(name: str) -> Model:
    try:
        return REGISTRY[name]()
    except KeyError:
        raise KeyError(f"unknown model {name!r}; known: {sorted(REGISTRY)}")
