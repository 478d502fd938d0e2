"""PyTorch/CUDA port of the jepsen_etcd_demo_tpu linearizability checker.

The register linearizability check (host encoder -> dense subset-lattice
WGL sweep) runs on an NVIDIA H100 through one hand-written CUDA kernel
(csrc/wgl3_sweep.cu). Every module here imports torch and numpy only;
nothing of JAX and nothing of the JAX package.

Entry points take ``device=None``, which means ``cuda``: without a card
they raise instead of running on the host. Pass ``device="cpu"`` to run
the plain PyTorch version of the sweep on the host (the tests do).
"""

from .device import resolve_device  # noqa: F401
