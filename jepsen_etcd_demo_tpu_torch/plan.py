"""Routing of the long (windowed) sweeps and of the sort ladder's chunks.

`plan_long_sweep` names the family a long history's windows run under on
a device, and the kernel label its result carries; `dispatch_long` runs
the history under it. The families:

    wgl3-cuda-resumable          csrc/wgl3_sweep.cu with a carry
    wgl3-cuda-global-resumable   its global tier: a table past 2^20 bits
                                 (the general path's dense-chunked rung)
    wgl3-cuda-sparse-resumable   csrc/wgl3_sparse.cu
    wgl3-plain-chunk             the plain dense sweep, window by window
    wgl3-plain-sparse-chunk      the plain sparse sweep, window by window

The sparse families are taken where ops/wgl3_kernels.sparse_selected
holds, on either device (never past K = 18, where the sparse kernel
stops). `plan_resumable` names the sort ladder's chunk family. The JAX
package's lattice-sharded family waits for the multi-device slice
(ROADMAP §A, multi-device).
"""

from __future__ import annotations

from dataclasses import dataclass

from .device import resolve_device
from .ops import wgl3
from .ops import wgl3_kernels as wk


@dataclass(frozen=True)
class LongPlan:
    family: str
    label: str       # the result's "kernel"
    sparse: bool


def plan_long_sweep(cfg: wgl3.DenseConfig, device=None) -> LongPlan:
    """The family a long sweep of this geometry runs under on `device`
    (None = cuda)."""
    on_card = resolve_device(device).type == "cuda"
    sparse = wk.sparse_selected(cfg)
    tier = ("sparse-" if sparse
            else "global-" if on_card and wk.global_tier(cfg) else "")
    family = ("wgl3-cuda-" if on_card else "wgl3-plain-") + tier \
        + ("resumable" if on_card else "chunk")
    label = ("wgl3-dense-cuda-" if on_card else "wgl3-dense-plain-") \
        + tier + "chunked"
    return LongPlan(family=family, label=label, sparse=sparse)


def plan_resumable(canon: bool = False) -> str:
    """The family of the sort ladder's chunks (ops/wgl2.
    check_steps_resumable), "-canon" when the history's frontier is
    canonicalised (ops/canon.py); torch ops on either device, as the JAX
    package's XLA chunks are. The result's "kernel" is
    "wgl2-sort-resumable" either way."""
    return "wgl2-chunk" + ("-canon" if canon else "")


def dispatch_long(rs, model, cfg: wgl3.DenseConfig, device=None,
                  time_budget_s: float | None = None) -> dict:
    """Run one long sweep under its planned family; the result is the
    long sweep's, with `kernel` and `plan_family` stamped on it."""
    plan = plan_long_sweep(cfg, device)
    if plan.sparse:
        out = wk.check_steps3_long_sparse(rs, model, cfg, device,
                                          time_budget_s=time_budget_s)
    else:
        out = wk.check_steps3_long(rs, model, cfg, device,
                                   time_budget_s=time_budget_s)
    out.setdefault("kernel", plan.label)
    out["plan_family"] = plan.family
    return out
