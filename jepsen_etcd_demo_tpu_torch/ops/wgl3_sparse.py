"""The density policy of the sparse sweep: whether a long history's
windows run through the sparse work-list kernel, and up to how many live
blocks a closure round of it stays sparse.

Only the policy lives here, the policy the JAX package's sparse engine
routes by (`sparse_plan`), within the envelope of the port's own kernel;
the long route (ops/wgl3_kernels.sparse_selected) takes the sparse kernel
wherever it holds. The sweep itself is csrc/wgl3_sparse.cu and its plain
version ops/wgl3.sweep_plain_sparse.
"""

from __future__ import annotations

from dataclasses import dataclass

from .limits import limits
from .wgl3 import SPARSE_BLOCK_WORDS, DenseConfig

# The work list's length in csrc/wgl3_sparse.cu (kMaxBlocks): the kernel
# takes tables of 2 to 64 blocks of 128 words a row, 13 <= K <= 18.
MAX_BLOCKS = 64


@dataclass(frozen=True)
class SparsePlan:
    blocks: int          # 128-word work-list blocks of a table row
    thresh_blocks: int   # live blocks up to which a closure round is sparse


def sparse_plan(cfg: DenseConfig) -> SparsePlan | None:
    """The sparse plan for this geometry under the active limits, or None
    when the sparse sweep stays off: sparse_mode=1 (dense only), a round
    cap below K (the sparse round order differs from the dense one, so a
    truncated closure could differ), a table row outside the kernel's
    2..64 blocks, or, in auto mode, a row narrower than sparse_min_words.
    Every round is sparse under sparse_mode=2; in auto mode a round with
    more than sparse_density_threshold_pct of the blocks live runs dense."""
    lim = limits()
    nb = cfg.n_words // SPARSE_BLOCK_WORDS
    if lim.sparse_mode == 1 or not 2 <= nb <= MAX_BLOCKS:
        return None
    if cfg.max_rounds and cfg.max_rounds < cfg.k_slots:
        return None
    if lim.sparse_mode == 2:
        return SparsePlan(blocks=nb, thresh_blocks=nb)
    if cfg.n_words < lim.sparse_min_words:
        return None
    return SparsePlan(blocks=nb, thresh_blocks=max(
        1, nb * lim.sparse_density_threshold_pct // 100))
