"""The few kernel limits the dense check reads, with their defaults.

A frozen dataclass and nothing more: no environment overrides and no
tuned profiles. ``set_limits`` swaps the active instance (tests use it to
shrink a bound).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class KernelLimits:
    # Largest dense table (S * 2^K cells) the dense check builds per
    # history. Every admitted table is at most 2^20 bits = 128 KiB, which
    # is what lets the CUDA kernel hold it in one block's shared memory.
    dense_cell_budget: int = 1 << 20
    # Longest return-step scan one launch takes; longer histories need
    # the resumable sweep, which this port does not have yet.
    long_scan_max: int = 32768
    # Floor of the {2^k, 1.5*2^k} step-count buckets.
    step_bucket_floor: int = 32


_ACTIVE = KernelLimits()


def limits() -> KernelLimits:
    return _ACTIVE


def set_limits(new: KernelLimits) -> KernelLimits:
    """Install `new`; returns the previous instance for restoring."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, new
    return prev
