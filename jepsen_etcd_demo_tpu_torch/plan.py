"""Routing of the long (windowed) sweeps.

`plan_long_sweep` names the family a long history's windows run under on
a device, and the kernel label its result carries; `dispatch_long` runs
the history under it. The families:

    wgl3-cuda-resumable          csrc/wgl3_sweep.cu with a carry
    wgl3-cuda-sparse-resumable   csrc/wgl3_sparse.cu
    wgl3-plain-chunk             the plain dense sweep, window by window
    wgl3-plain-sparse-chunk      the plain sparse sweep, window by window

The sparse families are taken where ops/wgl3_kernels.sparse_selected
holds, on either device. The JAX package's lattice-sharded family waits
for the multi-device slice (ROADMAP A-11).
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
    family = ("wgl3-cuda-" if on_card else "wgl3-plain-") \
        + ("sparse-" if sparse else "") \
        + ("resumable" if on_card else "chunk")
    label = ("wgl3-dense-cuda" if on_card else "wgl3-dense-plain") \
        + ("-sparse" if sparse else "") + "-chunked"
    return LongPlan(family=family, label=label, sparse=sparse)


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
