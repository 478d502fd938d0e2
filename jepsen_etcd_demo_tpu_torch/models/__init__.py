"""State-machine models the port checks for linearizability.

Each model has `step_py` (Python scalars, for the oracle) and `step`
(branchless torch, for the column-mask preparation on the device).
"""

from .base import Model  # noqa: F401
from .cas_register import CASRegister  # noqa: F401
from .register import Register  # noqa: F401

REGISTRY = {
    "cas-register": CASRegister,
    "register": Register,
}


def get_model(name: str) -> Model:
    try:
        return REGISTRY[name]()
    except KeyError:
        raise KeyError(f"unknown model {name!r}; known: {sorted(REGISTRY)}")
