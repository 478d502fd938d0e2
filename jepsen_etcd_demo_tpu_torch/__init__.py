"""PyTorch/CUDA port of the jepsen_etcd_demo_tpu linearizability checker.

The register linearizability check (host encoder -> dense subset-lattice
WGL sweep) runs on an NVIDIA H100 through one hand-written CUDA kernel
(csrc/wgl3_sweep.cu). Every module here imports torch and numpy only;
nothing of JAX and nothing of the JAX package.

Entry points take ``device=None``, which means ``cuda``: without a card
they raise instead of running on the host. Pass ``device="cpu"`` to run
the plain PyTorch version of the sweep on the host (the tests do).

Importing the package imports no torch: the minietcd server
(db/minietcd.py), which runs as its own process, starts on the standard
library alone.
"""


def __getattr__(name):
    if name == "resolve_device":
        from .device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
