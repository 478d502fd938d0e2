"""Subsumption of the sort search's frontier over forever-pending ops.

A forever-pending op (an indeterminate op that never returns) may take
effect at any point after its invocation, or never. Two configs of one
step with the same state and the same fired bits outside the
forever-pending slots differ only in which of those ops they already
fired: the one that fired a subset can still do everything the other
can (every op the other may fire later is unfired in it too, and both
reach the same states by the same firings), so the other one adds
nothing to the search and is dropped. The verdict fields (`valid`,
`dead_step`) are those of the search without it, since a config is
dropped only while one that subsumes it stays in the frontier, and the
relation survives every firing and every prune (prunes address ops that
return, never a forever-pending slot). `max_frontier` shrinks.

This is what keeps a partitioned key decidable: a partition leaves tens
of indeterminate writes in a key, whose fired subsets (2^K of them, up
to the canonicalisation's symmetry) otherwise fill the frontier, while
the configs no other subsumes stay few.

The JAX package does not prune so: under the default limits the port's
sort-search `max_frontier` is smaller than the JAX package's on a
history with forever-pending ops. `limits.subsume_mode` 1 turns the
reduction off, and so does `dedup_mode` 1 (with the canonicalisation).
"""

from __future__ import annotations

import numpy as np
import torch

from .encode import ReturnSteps
from .limits import limits

# Pairs of configs compared at once (one chunk of the pairwise test).
PAIR_CHUNK = 1 << 22


def forever_masks(rs: ReturnSteps) -> np.ndarray | None:
    """int64[R, W] (uint32 words, slot j at bit j % 32 of word j // 32):
    at each return step, the slots whose op is active then and never
    returns again; None when no step has one."""
    n, K = rs.n_steps, rs.k_slots
    if n == 0:
        return None
    targets = np.asarray(rs.targets[:n])
    active = np.asarray(rs.slot_active[:n])
    last = np.full(K, -1, dtype=np.int64)
    for t, j in enumerate(targets):
        if 0 <= j < K:
            last[j] = t
    W = (K + 31) // 32
    out = np.zeros((rs.slot_tabs.shape[0], W), dtype=np.int64)
    t_idx = np.arange(n)[:, None]
    forever = active & (t_idx > last[None, :])            # [n, K]
    if not forever.any():
        return None
    for j in range(K):
        out[:n, j // 32] |= forever[:, j].astype(np.int64) << (j % 32)
    return out


def enabled() -> bool:
    """Subsumption is on under the active limits."""
    lim = limits()
    return lim.subsume_mode == 0 and lim.dedup_mode != 1


def history_forever_masks(rs: ReturnSteps, device) -> torch.Tensor | None:
    """The history's forever_masks on `device` under the active limits:
    None when subsumption is off."""
    if not enabled():
        return None
    out = forever_masks(rs)
    return None if out is None else torch.from_numpy(out).to(device)


def stacked_forever_masks(steps, r_cap: int, device) -> torch.Tensor | None:
    """The forever masks of a batch of histories of one width, padded to
    r_cap steps and stacked: int64[B, r_cap, W] on `device`, None when
    no history has one or subsumption is off."""
    if not enabled():
        return None
    masks = [forever_masks(s) for s in steps]
    if all(m is None for m in masks):
        return None
    W = (steps[0].k_slots + 31) // 32
    out = np.zeros((len(steps), r_cap, W), dtype=np.int64)
    for b, m in enumerate(masks):
        if m is not None:
            out[b, :m.shape[0]] = m
    return torch.from_numpy(out).to(device)


def _row_subsumed(states: torch.Tensor, masks: torch.Tensor,
                  pmask: torch.Tensor) -> torch.Tensor:
    """One history's unique configs int32[N], int64[N, W] under the
    forever mask int64[W] -> bool[N]: subsumed by another config."""
    N, W = masks.shape
    dev = masks.device
    rest = masks & ~pmask
    fired = masks & pmask
    # Group by (state, bits outside the forever slots): one lexsort.
    order = None
    for k in [rest[:, i] for i in range(W - 1, -1, -1)] + [states.long()]:
        kk = k if order is None else k[order]
        idx = torch.sort(kk, stable=True)[1]
        order = idx if order is None else order[idx]
    g_rest = rest[order]
    g_state = states[order]
    g_fired = fired[order]
    new_group = torch.ones(N, dtype=torch.bool, device=dev)
    new_group[1:] = ((g_state[1:] != g_state[:-1])
                     | (g_rest[1:] != g_rest[:-1]).any(-1))
    gid = new_group.long().cumsum(0) - 1
    starts = torch.nonzero(new_group)[:, 0]
    sizes = torch.diff(torch.cat([starts, torch.tensor([N], device=dev)]))
    size_of = sizes[gid]
    start_of = starts[gid]
    hits = torch.zeros(N, dtype=torch.int64, device=dev)
    multi = torch.nonzero(size_of > 1)[:, 0]
    if multi.numel() == 0:
        return hits > 0
    # Each member of a group of two or more against every member.
    i0 = 0
    while i0 < multi.numel():
        counts = size_of[multi[i0:]]
        take = int(torch.searchsorted(counts.cumsum(0),
                                      torch.tensor(PAIR_CHUNK, device=dev),
                                      right=True))
        rows = multi[i0:i0 + max(1, take)]
        reps = size_of[rows]
        a = torch.repeat_interleave(rows, reps)
        first = torch.repeat_interleave(reps.cumsum(0) - reps, reps)
        b = start_of[a] + torch.arange(a.numel(), device=dev) - first
        fa, fb = g_fired[a], g_fired[b]
        hit = ((fb & ~fa) == 0).all(-1) & (fb != fa).any(-1)
        hits.index_add_(0, a, hit.long())
        i0 += rows.numel()
    res = torch.zeros(N, dtype=torch.bool, device=dev)
    res[order] = hits > 0
    return res


def subsume(states: torch.Tensor, masks: torch.Tensor, valid: torch.Tensor,
            pmask: torch.Tensor) -> torch.Tensor:
    """Drop the subsumed configs of a batch of unique frontiers
    (int32[B, F], int64[B, F, W], bool[B, F]) under the step's forever
    masks int64[B, W] -> the new valid bool[B, F]."""
    out = valid.clone()
    for b in range(valid.shape[0]):
        if not bool(pmask[b].any()):
            continue
        rows = torch.nonzero(valid[b])[:, 0]
        if rows.numel() < 2:
            continue
        hit = _row_subsumed(states[b, rows], masks[b, rows], pmask[b])
        out[b, rows[hit]] = False
    return out
