"""Frontier canonicalisation of the sort search: symmetry reduction over
equal-effect forever-pending ops.

When two pending ops have identical encoded rows (same ``(f, a1, a2,
rv)``) and neither ever returns in the rest of the history, firing
either one first reaches the same model state, and no later prune can
tell them apart (prunes address ops by slot, and these slots are never a
target again). Only the count of fired ops per such class matters, so a
config is rewritten to the representative with its class's fired bits in
the class's lowest slots, and the sort-dedup then merges the symmetric
configs: ``C(n, k)`` masks collapse to ``n + 1``. The verdict fields
(``valid``, ``survived``, ``overflow``, ``dead_step``) are those of the
search without it; ``max_frontier`` shrinks, which is the point.

The JAX package states the rewrite as a compare-exchange network per step
(``canon_pairs``: ``i32[R, P, 2]``, a selection-sort network over each
class's slots). On 0/1 keys a selection network packs the set bits into
the lowest slots, so the port applies each step's network in one pass:
``pair_classes`` turns a step's pairs into its classes, and
``canon_keys_packed`` / ``canon_masks_words`` count each class's fired
bits and set that many of its lowest slots, which gives the network's
output bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .encode import ReturnSteps
from .limits import limits

# The exchange network rides the scan inputs with a static per-step pair
# capacity P (a power of two, at least this).
PAIR_CAP_FLOOR = 4


def pair_capacity(n_pairs: int) -> int:
    """Per-step pair capacity for a history whose densest step has
    `n_pairs` exchanges: the next power of two, floor PAIR_CAP_FLOOR."""
    cap = PAIR_CAP_FLOOR
    while cap < n_pairs:
        cap *= 2
    return cap


def _selection_network(slots: list[int]) -> list[tuple[int, int]]:
    """Selection-sort network over one class's slots (ascending):
    CE(lo, hi) for every lo < hi, c*(c-1)/2 exchanges."""
    out = []
    for i in range(len(slots) - 1):
        for k in range(i + 1, len(slots)):
            out.append((slots[i], slots[k]))
    return out


def canon_pairs(rs: ReturnSteps,
                max_bit: int | None = None) -> np.ndarray | None:
    """The per-step compare-exchange network ``int32[R, P, 2]`` of this
    history, or None when no step has a symmetry to reduce.

    A pair ``(lo, hi)`` at step ``t`` says that slots ``lo < hi`` hold
    equal-effect ops that are both forever-pending from ``t`` on (active
    at ``t``, never again a target). Pads are ``(-1, -1)``. ``max_bit``
    drops pairs touching slot bits >= it. Eligibility is monotone in
    ``t``, so the network is constant over at most K+1 segments."""
    R = rs.slot_tabs.shape[0]
    K = rs.k_slots
    n = rs.n_steps
    if n == 0:
        return None
    targets = np.asarray(rs.targets[:n])
    active = np.asarray(rs.slot_active[:n])
    tabs = np.asarray(rs.slot_tabs[:n])
    # forever_from[j]: first step from which slot j never returns again.
    forever_from = np.zeros(K, dtype=np.int64)
    for t, j in enumerate(targets):
        if 0 <= j < K:
            forever_from[j] = t + 1
    # start[j]: first step where slot j is both active and past its last
    # return (-1: never forever-pending).
    start = np.full(K, -1, dtype=np.int64)
    for j in range(K):
        f0 = int(forever_from[j])
        if f0 >= n:
            continue
        tail = active[f0:, j]
        hit = np.argmax(tail)
        if tail[hit]:
            start[j] = f0 + int(hit)
    eligible = [j for j in range(K) if start[j] >= 0]
    if len(eligible) < 2:
        return None
    boundaries = sorted({int(start[j]) for j in eligible})
    seg_pairs: list[tuple[int, list[tuple[int, int]]]] = []
    max_pairs = 0
    for b in boundaries:
        live = [j for j in eligible if start[j] <= b]
        by_row: dict[tuple, list[int]] = {}
        for j in live:
            by_row.setdefault(tuple(tabs[start[j], j].tolist()),
                              []).append(j)
        pairs: list[tuple[int, int]] = []
        for slots in by_row.values():
            if len(slots) >= 2:
                pairs.extend(_selection_network(sorted(slots)))
        if max_bit is not None:
            pairs = [(lo, hi) for lo, hi in pairs
                     if lo < max_bit and hi < max_bit]
        seg_pairs.append((b, pairs))
        max_pairs = max(max_pairs, len(pairs))
    if max_pairs == 0:
        return None
    P = pair_capacity(max_pairs)
    out = np.full((R, P, 2), -1, dtype=np.int32)
    for i, (b, pairs) in enumerate(seg_pairs):
        if not pairs:
            continue
        end = seg_pairs[i + 1][0] if i + 1 < len(seg_pairs) else n
        row = np.full((P, 2), -1, dtype=np.int32)
        row[:len(pairs)] = np.asarray(pairs, dtype=np.int32)
        out[b:end] = row
    return out


def history_canon_pairs(rs: ReturnSteps, max_bit: int | None = None,
                        table: bool = False):
    """The history's exchange network under the active limits: None when
    dedup is off (dedup_mode=1), or for a table sweep (`table`) unless
    forced (dedup_mode=2), or when the history has no symmetry. In auto
    mode the sort ladder takes it and the table sweeps do not."""
    lim = limits()
    if lim.dedup_mode == 1 or (table and lim.dedup_mode != 2):
        return None
    return canon_pairs(rs, max_bit=max_bit)


@dataclass(frozen=True)
class StepClasses:
    """One step's symmetry classes as the rewrite reads them, on a device:
    same float32[K, K] (slots i, j in one class), rank int64[K] (a
    slot's place in its class, ascending) and member bool[K]."""
    same: torch.Tensor
    rank: torch.Tensor
    member: torch.Tensor


def pair_classes(pairs: np.ndarray, k_slots: int, device) -> StepClasses:
    """A step's pairs int32[P, 2] (pads -1) -> its classes: the slots the
    pairs connect."""
    parent = list(range(k_slots))

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    member = np.zeros(k_slots, bool)
    for lo, hi in np.asarray(pairs).tolist():
        if lo < 0:
            continue
        member[lo] = member[hi] = True
        parent[find(hi)] = find(lo)
    root = np.array([find(j) for j in range(k_slots)])
    same = (root[:, None] == root[None, :]) & member[:, None] \
        & member[None, :]
    rank = np.array([int((same[j, :j]).sum()) for j in range(k_slots)])
    return StepClasses(
        same=torch.from_numpy(same.astype(np.float32)).to(device),
        rank=torch.from_numpy(rank.astype(np.int64)).to(device),
        member=torch.from_numpy(member).to(device))


def history_classes(pairs: np.ndarray, k_slots: int, device
                    ) -> tuple[list[StepClasses | None], np.ndarray]:
    """A history's network int32[R, P, 2] -> (the distinct steps' classes,
    None where a step has no pair, and int64[R]: each step's index into
    that list)."""
    keys: dict[bytes, int] = {}
    table: list[StepClasses | None] = []
    index = np.zeros(pairs.shape[0], np.int64)
    for r in range(pairs.shape[0]):
        key = pairs[r].tobytes()
        if key not in keys:
            keys[key] = len(table)
            table.append(pair_classes(pairs[r], k_slots, device)
                         if (pairs[r, :, 0] >= 0).any() else None)
        index[r] = keys[key]
    return table, index


def batch_classes(steps, r_cap: int, device
                  ) -> tuple[StepClasses, torch.Tensor] | None:
    """The classes of a batch of histories of one width, for the batched
    sort tiers: (every distinct step's classes stacked, with an empty
    class set first: same float32[M, K, K], rank int64[M, K], member
    bool[M, K]; int64[B, r_cap], each step's index into them), or None
    when no history has a symmetry."""
    K = steps[0].k_slots
    tables = [(np.zeros((K, K), np.float32), np.zeros(K, np.int64),
               np.zeros(K, bool))]
    index = np.zeros((len(steps), r_cap), np.int64)
    for b, rs in enumerate(steps):
        pairs = canon_pairs(rs)
        if pairs is None:
            continue
        table, idx = history_classes(pairs[:rs.n_steps], K, "cpu")
        ids = []
        for c in table:
            ids.append(0 if c is None else len(tables))
            if c is not None:
                tables.append((c.same.numpy(), c.rank.numpy(),
                               c.member.numpy()))
        index[b, :rs.n_steps] = np.asarray(ids)[idx]
    if len(tables) == 1:
        return None
    same, rank, member = (torch.from_numpy(np.stack(a)).to(device)
                          for a in zip(*tables))
    return (StepClasses(same=same, rank=rank, member=member),
            torch.from_numpy(index).to(device))


def step_batch_classes(table: StepClasses, index: torch.Tensor
                       ) -> StepClasses:
    """The batch's classes at one step: index int64[B] into batch_classes'
    table -> same [B, K, K], rank [B, K], member [B, K]."""
    return StepClasses(same=table.same[index], rank=table.rank[index],
                       member=table.member[index])


def _pack_low(bits: torch.Tensor, cls: StepClasses) -> torch.Tensor:
    """bits int64[..., K] of 0/1 -> each class's set bits moved to its
    lowest slots (other slots unchanged). Batched classes (same
    [B, K, K]) take bits int64[B, N, K]."""
    rank, member = cls.rank, cls.member
    if cls.same.dim() == 3:
        rank, member = rank[:, None, :], member[:, None, :]
    counts = torch.matmul(bits.to(torch.float32), cls.same)  # [..., K]
    packed = (rank < counts.round().to(torch.int64)).to(torch.int64)
    return torch.where(member, packed, bits)


def canon_keys_packed(keys: torch.Tensor, cls: StepClasses, sbits: int,
                      invalid: int) -> torch.Tensor:
    """Canonicalise packed sort keys int64[..., N] (``state | mask <<
    sbits``, uint32 bit patterns): the step's network applied to every
    key but the `invalid` sentinel."""
    K = cls.rank.shape[-1]
    shifts = torch.arange(K, device=keys.device) + sbits
    bits = (keys[..., None] >> shifts) & 1
    new = (_pack_low(bits, cls) << shifts).sum(-1)
    field = ((1 << K) - 1) << sbits
    return torch.where(keys == invalid, keys, (keys & ~field) | new)


def canon_masks_words(masks: torch.Tensor, cls: StepClasses
                      ) -> torch.Tensor:
    """Canonicalise explicit mask rows int64[..., N, W] (uint32 words,
    slot j at bit j % 32 of word j // 32): the step's network applied to
    every row."""
    K = cls.rank.shape[-1]
    W = masks.shape[-1]
    j = torch.arange(K, device=masks.device)
    word, bit = j // 32, j % 32
    bits = (masks[..., word] >> bit) & 1                  # [..., N, K]
    new = _pack_low(bits, cls) << bit
    out = []
    for w in range(W):
        sel = word == w
        keep = masks[..., w] & ~int(
            sum(1 << int(b) for b in bit[sel].tolist()))
        out.append(keep | new[..., sel].sum(-1))
    return torch.stack(out, dim=-1)
