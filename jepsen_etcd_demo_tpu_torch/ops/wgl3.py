"""WGL linearizability search over the dense subset lattice, in PyTorch.

The frontier of the search is the dense characteristic function

    table: bits[S, 2^K]   table[s, m] == "config (state s - offset,
                           linearized mask m) is reachable"

with S bounding the model's reachable states (known from the history's
values) and K the pending-op slot count. The mask axis is packed 32
configs per 32-bit word: the low 5 mask bits index a bit inside a word,
the high K-5 bits index one of W = 2^(K-5) words. Each return step

  * closes the table under firing pending ops (Gauss-Seidel sweeps over
    the K slots until nothing changes). Firing slot j ORs every source
    state's words into its successor state's row, with mask bit j set: an
    in-word shift by 2^j for j < 5, a move from word w to word
    w + 2^(j-5) for j >= 5. Configs that already fired the returning op
    (bit t set) are banked: they stay but are never expanded;
  * counts the converged table (max_frontier, configs_explored);
  * prunes at the returning slot t: keep configs with bit t set,
    re-addressed with bit t clear. An empty table means the history is
    not linearizable at this step.

This module holds the host half (geometry, bucketing, batching, result
assembly) and the plain PyTorch versions of the sweeps: the dense sweep
(`sweep_plain`, resumable through `sweep_plain_carry`) and the sparse
work-list sweep (`sweep_plain_sparse`). The CUDA kernels that run the same
sweeps on the card, and the routes that send histories to them, are in
ops/wgl3_kernels.py.

A resumable sweep carries (table, meta) from one window of return steps
to the next: the table int64[B, S, W] and meta int64[B, 5] =
[dead, dead_step, max_frontier, configs_explored, offset], where offset
is the global index of the window's first step (dead_step is global) and
configs_explored wraps as a 32-bit accumulator. The sparse sweep's meta
adds [live_sum, sparse_steps, real_steps] (int64[B, 8]).

torch has no shifts on uint32 and no popcount, so the plain version keeps
each 32-config word in an int64 and masks it to 32 bits after a left
shift, and counts bits with a SWAR popcount.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..models.base import Model
from .encode import (EncodedHistory, ReturnSteps, encode_return_steps,
                     reslot_events)
from .limits import limits


@dataclass(frozen=True)
class DenseConfig:
    k_slots: int          # K: mask width; the mask axis is 2^K
    n_states: int         # S: state axis (covers every reachable state)
    state_offset: int     # state value -> row index shift (NIL=-1 -> 0)
    max_rounds: int = 0   # closure sweep bound; default k_slots

    @property
    def n_masks(self) -> int:
        return 1 << self.k_slots

    @property
    def n_words(self) -> int:
        return 1 << (self.k_slots - 5)

    @property
    def rounds(self) -> int:
        return self.max_rounds or self.k_slots


def dense_config(model: Model, k_slots: int, max_value: int,
                 budget: int | None = None) -> DenseConfig | None:
    """DenseConfig for this (model, history), or None when infeasible.

    Feasible iff the model's states are bounded by the history's values,
    S <= 32, K >= 5 (32 configs per word) and S * 2^K fits the cell
    budget: `budget`, by default limits().dense_cell_budget (the general
    path's dense-chunked rung passes dense_cell_budget_chunked). S is
    rounded up to a multiple of 4."""
    if budget is None:
        budget = limits().dense_cell_budget
    if not model.packable_states or k_slots < 5:
        return None
    s = model.state_bound(max_value) + 1
    s = (s + 3) // 4 * 4
    if s > 32 or s * (1 << k_slots) > budget:
        return None
    return DenseConfig(k_slots=k_slots, n_states=s,
                       state_offset=model.state_offset)


def init_row(model: Model, cfg: DenseConfig) -> int:
    """Table row of the model's initial state."""
    return int(model.init_state()) + cfg.state_offset


# _LO_MASK[j] (j < 5): the bit positions p in 0..31 whose index has bit j
# CLEAR, i.e. the in-word configs that have not fired slot j.
_LO_MASK = tuple(
    sum(1 << p for p in range(32) if not (p >> j) & 1) for j in range(5))
_WORD = 0xFFFFFFFF


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit value held in an int64 tensor (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _WORD) >> 24


def step_rows(model: Model, cfg: DenseConfig, slot_tabs: torch.Tensor,
              slot_active: torch.Tensor):
    """Fire every slot from every state row: slot_tabs int32[..., K, 4],
    slot_active bool[..., K] -> (ok bool[..., K, S], next row
    int64[..., K, S]). ok says the firing is legal and lands inside the
    table."""
    S, off = cfg.n_states, cfg.state_offset
    state = torch.arange(S, dtype=torch.int32, device=slot_tabs.device) - off
    f, a1, a2, rv = (slot_tabs[..., i, None] for i in range(4))
    legal, nxt = model.step(state, f, a1, a2, rv)
    nxt_row = nxt.to(torch.int64) + off
    ok = legal & (nxt_row >= 0) & (nxt_row < S) & slot_active[..., None]
    return ok, nxt_row


def transitions(model: Model, cfg: DenseConfig, slot_tabs: torch.Tensor,
                slot_active: torch.Tensor) -> torch.Tensor:
    """Per-slot transition matrices over the state axis:
    bool[..., K, S, S'], trans[..., j, s, s'] says that firing slot j from
    state row s is legal and lands in state row s'."""
    ok, nxt_row = step_rows(model, cfg, slot_tabs, slot_active)
    s_ids = torch.arange(cfg.n_states, device=slot_tabs.device)
    return ok[..., None] & (nxt_row[..., None] == s_ids)


def _or_reduce(tj: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """out[b, s', ...] = OR over s of (tj[b, s, s'] ? src[b, s, ...] : 0),
    as a pairwise OR tree over the source axis."""
    pad = (1,) * (src.dim() - 2)
    m = torch.where(tj.reshape(tj.shape + pad), src[:, :, None], 0)
    while m.shape[1] > 1:
        if m.shape[1] % 2:
            m = torch.cat([m, torch.zeros_like(m[:, :1])], dim=1)
        h = m.shape[1] // 2
        m = m[:, :h] | m[:, h:]
    return m[:, 0]


def _allowed(t: torch.Tensor, w_idx: torch.Tensor) -> torch.Tensor:
    """int64[B, W]: per word, the configs with mask bit t[b] CLEAR."""
    lo = torch.tensor(_LO_MASK, dtype=torch.int64, device=t.device)
    in_word = lo[t.clamp(max=4)][:, None].expand(-1, w_idx.shape[0])
    word_ok = ((w_idx[None, :] >> (t - 5).clamp(min=0)[:, None]) & 1) == 0
    word_level = torch.where(word_ok, _WORD, 0)
    return torch.where((t < 5)[:, None], in_word, word_level)


def firing_slots(tr: torch.Tensor) -> list[int]:
    """The slots j with any transition in tr bool[..., K, S, S'] (in any
    history of a batch), ascending. Firing any other slot ORs in nothing,
    so a sweep over these alone gives the same table."""
    K = tr.shape[-3]
    fires = tr.reshape(-1, K, tr.shape[-2] * tr.shape[-1]).any(-1).any(0)
    return torch.nonzero(fires).flatten().tolist()


def _sweep(T: torch.Tensor, allowed: torch.Tensor, tr: torch.Tensor,
           slots: list[int]) -> torch.Tensor:
    """One Gauss-Seidel sweep: fire each of `slots` (firing_slots of tr)
    once, in slot order, so chains within the sweep propagate.
    T int64[B, S, W], tr bool[B, K, S, S']."""
    B, S, W = T.shape
    for j in slots:
        src = T & allowed[:, None, :]
        if j < 5:
            fired = _or_reduce(tr[:, j], src & _LO_MASK[j])
            T = T | ((fired << (1 << j)) & _WORD)
        else:
            lo_w, hi = 1 << (j - 5), W >> (j - 4)
            Tr = T.reshape(B, S, hi, 2, lo_w)
            fired = _or_reduce(tr[:, j],
                               src.reshape(B, S, hi, 2, lo_w)[:, :, :, 0, :])
            T = torch.stack([Tr[:, :, :, 0, :], Tr[:, :, :, 1, :] | fired],
                            dim=3).reshape(B, S, W)
    return T


def _prune(T: torch.Tensor, t: torch.Tensor, allowed: torch.Tensor,
           w_idx: torch.Tensor) -> torch.Tensor:
    """Keep configs that linearized slot t, re-addressed with bit t clear:
    an in-word shift down for t < 5, a word gather for t >= 5."""
    B, S, W = T.shape
    one = torch.ones_like(t)
    shift = torch.where(t < 5, one << t.clamp(max=4), 0)
    wsel = torch.where((t < 5)[:, None], w_idx[None, :],
                       w_idx[None, :] | (one << (t - 5).clamp(min=0))[:, None])
    g = T.gather(2, wsel[:, None, :].expand(B, S, W))
    return (g >> shift[:, None, None]) & allowed[:, None, :]


def fresh_carry(cfg: DenseConfig, row0: int, batch: int, device,
                width: int = 5) -> tuple[torch.Tensor, torch.Tensor]:
    """The carry a search starts from: the initial config (state row
    row0, empty mask) and meta [0, -1, 1, 0, 0] (+ zeros up to `width`)."""
    T = torch.zeros((batch, cfg.n_states, cfg.n_words), dtype=torch.int64,
                    device=device)
    T[:, row0, 0] = 1
    meta = torch.tensor([0, -1, 1, 0, 0] + [0] * (width - 5),
                        dtype=torch.int64, device=device)
    return T, meta.repeat(batch, 1)


def sweep_plain_carry(trans: torch.Tensor, targets: torch.Tensor,
                      cfg: DenseConfig, T: torch.Tensor, meta: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """One window of the plain dense sweep over a batch: trans
    bool[B, R, K, S, S'], targets int[B, R] (-1 = pad, always a suffix),
    carry (T int64[B, S, W], meta int64[B, 5]) -> the next carry, with
    meta's offset advanced by each history's real steps. The closure runs
    until a sweep changes nothing; a monotone operator has one least
    fixpoint above the step's starting table, so the sweep order does not
    change the result."""
    B, R = targets.shape
    dev = targets.device
    W = cfg.n_words
    dead = meta[:, 0] != 0
    dead_step = meta[:, 1].clone()
    maxf = meta[:, 2].clone()
    cfgs = meta[:, 3].clone()
    offset = meta[:, 4]
    w_idx = torch.arange(W, dtype=torch.int64, device=dev)
    tg = targets.to(torch.int64)
    for r in range(R):
        real = tg[:, r] >= 0
        # Pads are a suffix and death is sticky: once no history is both
        # real and alive at this step, none is at a later one.
        if not bool((real & ~dead).any()):
            break
        t = tg[:, r].clamp(min=0)
        allowed = _allowed(t, w_idx)
        tr = trans[:, r]
        slots = firing_slots(tr)
        Tc = T
        while True:
            Tn = _sweep(Tc, allowed, tr, slots)
            if torch.equal(Tn, Tc):
                break
            Tc = Tn
        Tc = torch.where(real[:, None, None], Tc, T)
        n = torch.where(real, popcount32(Tc).sum(dim=(1, 2)), 0)
        pruned = _prune(Tc, t, allowed, w_idx)
        died = real & ~dead & ~(pruned != 0).any(dim=(1, 2))
        dead_step = torch.where(died, offset + r, dead_step)
        dead |= died
        T = torch.where(real[:, None, None], pruned, T)
        T = torch.where(dead[:, None, None], 0, T)
        maxf = torch.maximum(maxf, n)
        cfgs += n
    ln = (tg >= 0).sum(dim=1)
    return T, torch.stack([dead.to(torch.int64), dead_step, maxf,
                           wrap_i32(cfgs), offset + ln], dim=-1)


def pack_meta(meta: torch.Tensor) -> torch.Tensor:
    """Carry meta int[B, >=5] -> int32[B, 5] in PACKED_FIELDS order."""
    return torch.stack([(meta[:, 0] == 0).to(torch.int64),
                        torch.zeros_like(meta[:, 0]), meta[:, 1].long(),
                        meta[:, 2].long(), meta[:, 3].long()],
                       dim=-1).to(torch.int32)


def sweep_plain(trans: torch.Tensor, targets: torch.Tensor, cfg: DenseConfig,
                row0: int) -> torch.Tensor:
    """The plain sweep over a batch from a fresh start: trans
    bool[B, R, K, S, S'], targets int[B, R] -> int32[B, 5] in
    PACKED_FIELDS order."""
    T, meta = fresh_carry(cfg, row0, targets.shape[0], targets.device)
    return pack_meta(sweep_plain_carry(trans, targets, cfg, T, meta)[1])


# -- the sparse work-list sweep ---------------------------------------------

SPARSE_BLOCK_WORDS = 128      # words per work-list block
_BLOCK_SLOTS = 12             # slots j < 12 stay inside a 128-word block


def block_live(T: torch.Tensor, nb: int) -> torch.Tensor:
    """bool[nb]: the 128-word blocks of table T [S, W] holding any config."""
    return (T.reshape(T.shape[0], nb, -1) != 0).any(dim=2).any(dim=0)


def _sparse_round(T: torch.Tensor, live: list, allowed: torch.Tensor,
                  tr: torch.Tensor, slots: list[int]) -> torch.Tensor:
    """One closure round over the live blocks only, T int64[S, W],
    allowed int64[W], tr bool[K, S, S'] whose firing slots are `slots`.

    Blocks are taken in ascending order, as a sequential sweep of the
    work list would take them: each live block first receives what its
    lower neighbours (its index with one bit cleared) fired into it, then
    closes under slots j < 12 in slot order, and its result is what it
    fires for slots j >= 12 into block bi | 1 << (j - 12). Every block's
    sources have one bit fewer set, so blocks with the same bit count are
    independent and go together, one level per bit count."""
    S, W = T.shape
    nb = W // SPARSE_BLOCK_WORDS
    fires = set(slots)
    in_block = [j for j in slots if j < _BLOCK_SLOTS]
    Tb = T.reshape(S, nb, SPARSE_BLOCK_WORDS).clone()
    ab = allowed.reshape(nb, SPARSE_BLOCK_WORDS)
    bits = nb.bit_length() - 1
    for level in range(bits + 1):
        blocks = [bi for bi in range(nb) if bin(bi).count("1") == level]
        for bi in blocks:
            for bb in range(bits):
                p = bi ^ (1 << bb)
                if (bi >> bb) & 1 and live[p] \
                        and _BLOCK_SLOTS + bb in fires:
                    src = Tb[:, p] & ab[p]
                    Tb[:, bi] |= _or_reduce(tr[None, _BLOCK_SLOTS + bb],
                                            src[None])[0]
        expand = [bi for bi in blocks if live[bi]]
        if expand:
            idx = torch.tensor(expand, device=T.device)
            blk = _sweep(Tb[:, idx].transpose(0, 1), ab[idx],
                         tr[None].expand(len(expand), -1, -1, -1), in_block)
            Tb[:, idx] = blk.transpose(0, 1)
    return Tb.reshape(S, W)


def sweep_plain_sparse(trans: torch.Tensor, targets: torch.Tensor,
                       cfg: DenseConfig, T: torch.Tensor, meta: torch.Tensor,
                       thresh_blocks: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """One window of the plain sparse work-list sweep: the arguments of
    sweep_plain_carry with meta int64[B, 8]. Each closure round probes
    the 128-word blocks; with at most `thresh_blocks` live it sweeps only
    those (_sparse_round), otherwise it runs a dense round. Rounds stop
    when one changes nothing or after cfg.rounds rounds (K rounds always
    reach the fixpoint: a firing sets one of K slot bits). Telemetry per
    real step: live blocks of the converged table (live_sum), whether
    every round was sparse (sparse_steps), and the step itself
    (real_steps); a dead table's steps count as one sparse round each."""
    B, R = targets.shape
    dev = targets.device
    W = cfg.n_words
    nb = W // SPARSE_BLOCK_WORDS
    w_idx = torch.arange(W, dtype=torch.int64, device=dev)
    T_out, meta_out = T.clone(), meta.clone()
    for b in range(B):
        Tb = T[b]
        (dead, dead_step, maxf, cfgs, off, live_sum, sp_steps,
         real_steps) = (int(x) for x in meta[b].tolist())
        steps = int((targets[b] >= 0).sum())
        for r in range(steps):
            if dead:
                sp_steps += steps - r
                real_steps += steps - r
                break
            t = int(targets[b, r])
            allowed = _allowed(torch.tensor([t], device=dev), w_idx)[0]
            tr = trans[b, r]
            slots = firing_slots(tr)
            rounds = sp_rounds = 0
            changed = True
            while changed and rounds < cfg.rounds:
                live = block_live(Tb, nb).tolist()
                take = sum(live) <= thresh_blocks
                if take:
                    Tn = _sparse_round(Tb, live, allowed, tr, slots)
                else:
                    Tn = _sweep(Tb[None], allowed[None], tr[None], slots)[0]
                changed = not torch.equal(Tn, Tb)
                Tb = Tn
                rounds += 1
                sp_rounds += int(take)
            n = int(popcount32(Tb).sum())
            live_sum += int(block_live(Tb, nb).sum())
            sp_steps += int(sp_rounds == rounds)
            real_steps += 1
            maxf = max(maxf, n)
            cfgs += n
            pruned = _prune(Tb[None], torch.tensor([t], device=dev),
                            allowed[None], w_idx)[0]
            if not bool((pruned != 0).any()):
                dead, dead_step = 1, off + r
                pruned = torch.zeros_like(pruned)
            Tb = pruned
        T_out[b] = Tb
        meta_out[b] = torch.tensor(
            [dead, dead_step, maxf, wrap_i32(torch.tensor(cfgs)).item(),
             off + steps, live_sum, sp_steps, real_steps], device=dev)
    return T_out, meta_out


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the same values wrapped to 32-bit two's complement, as the
    Pallas kernels' i32 configs_explored accumulator wraps past 2^31."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2**31, x - 2**32, x)


def words64(T: torch.Tensor) -> torch.Tensor:
    """Table words as uint32 bit patterns in int32 -> int64 values."""
    return T.to(torch.int64) & _WORD


def words32(T: torch.Tensor) -> torch.Tensor:
    """int64 table words -> the same uint32 bit patterns in int32."""
    return wrap_i32(T).to(torch.int32)


def table_configs(table, cfg: DenseConfig) -> list[tuple[int, int]]:
    """The configs a table [S, W] (uint32 words, numpy or torch) holds, as
    (state value, linearized mask), by state row, word, then bit."""
    table = np.asarray(table).astype(np.uint32)
    configs = []
    for srow in range(cfg.n_states):
        for w in np.nonzero(table[srow])[0]:
            bits = int(table[srow, w])
            while bits:
                b = bits & -bits
                configs.append((srow - cfg.state_offset,
                                int(w) * 32 + b.bit_length() - 1))
                bits ^= b
    return configs


def recover_table3(rs: ReturnSteps, model: Model, cfg: DenseConfig,
                   upto_step: int, device=None) -> list[tuple[int, int]]:
    """The exact reachable config set after the first `upto_step` return
    steps: the resumable dense sweep runs that far (on the card through
    its kernel unless `device` is the CPU), and the carried table is read
    back and decoded. The counterexample witness replays from here
    (checkers/witness.py)."""
    from . import wgl3_kernels

    T, _meta = wgl3_kernels.run_chain(rs, model, cfg, device,
                                      upto=upto_step)
    return table_configs(T[0].cpu().numpy().view(np.uint32), cfg)


def sweep_summary(live_sum: float, real_steps: int, sparse_steps: int,
                  tiling: tuple[int, int]) -> dict:
    """The sweep-mode and occupancy record of a long sweep's result: how
    many steps ran all-sparse closures and the mean live-tile ratio of
    the converged tables over `tiling` = (tile_words, n_tiles) (the JAX
    package's record, field for field; the work list holds every block,
    so no round is ever forced dense by an overflow)."""
    tile, n_tiles = tiling
    real = max(0, int(real_steps))
    sparse = min(max(0, int(sparse_steps)), real)
    dense = real - sparse
    if real == 0 or sparse == 0:
        mode = "dense"
    elif dense == 0:
        mode = "sparse"
    else:
        mode = "mixed"
    ratio = (float(live_sum) / (real * n_tiles)) if real else 0.0
    return {"mode": mode,
            "live_tile_ratio": round(min(max(ratio, 0.0), 1.0), 4),
            "steps_sparse": sparse, "steps_dense": dense,
            "tiles": n_tiles, "tile_words": tile, "overflow_rounds": 0}


def check_batch_plain(slot_tabs: torch.Tensor, slot_active: torch.Tensor,
                      targets: torch.Tensor, model: Model,
                      cfg: DenseConfig) -> torch.Tensor:
    """The plain PyTorch version of the dense sweep, on whatever device the
    inputs lie: slot_tabs int32[B,R,K,4], slot_active bool[B,R,K],
    targets int32[B,R] -> int32[B, 5] (PACKED_FIELDS)."""
    _require_converging_cap(cfg)
    return sweep_plain(transitions(model, cfg, slot_tabs, slot_active),
                       targets, cfg, init_row(model, cfg))


def _require_converging_cap(cfg: DenseConfig) -> None:
    """The sweeps here run to the fixpoint; a cap below k_slots would
    truncate the closure, which only the JAX package's XLA kernel models."""
    if cfg.max_rounds and cfg.max_rounds < cfg.k_slots:
        raise ValueError(
            f"max_rounds={cfg.max_rounds} < k_slots={cfg.k_slots} would "
            f"truncate the closure; the port runs every sweep to its "
            f"fixpoint")


# -- host-side batching ----------------------------------------------------

def tight_k_for_pending(max_pending: int) -> int:
    """Smallest mask width serving this max_pending, rounded up to even,
    floor 6."""
    return max(6, (max_pending + 1) // 2 * 2)


def tight_k_slots(enc: EncodedHistory) -> int:
    return tight_k_for_pending(enc.max_pending)


def step_bucket(n_steps: int, floor: int | None = None) -> int:
    """Pad scan lengths to {2^k, 1.5*2^k} buckets (at most 33% pads), from
    `floor` (default limits().step_bucket_floor)."""
    r = limits().step_bucket_floor if floor is None else floor
    while r < n_steps:
        if r + r // 2 >= n_steps:
            return r + r // 2
        r *= 2
    return r


def batch_steps3(encs: Sequence[EncodedHistory], model: Model,
                 cfg: DenseConfig | None = None, device=None):
    """Host half of a batched launch: tighten, reslot and encode a batch
    into per-history ReturnSteps under one shared geometry (expanded on
    `device` under encode_mode 2), and the bucketed common step count.
    Raises ValueError when no shared dense geometry exists."""
    k = max(tight_k_slots(e) for e in encs)
    if cfg is None:
        cfg = dense_config(model, k, max(e.max_value for e in encs))
    if cfg is None:
        raise ValueError("dense kernel infeasible for this batch")
    steps = [encode_return_steps(
        reslot_events(e, k) if e.k_slots != k else e, device) for e in encs]
    r_cap = step_bucket(max(s.n_steps for s in steps))
    return cfg, steps, r_cap


def stack_steps3(steps: Sequence[ReturnSteps], r_cap: int, device):
    """Pad to the common step count (ReturnSteps.pad_into), stack, and put
    the arrays on `device`: (slot_tabs int32[B,R,K,4], slot_active
    bool[B,R,K], targets int32[B,R]).

    For a card the arrays are filled in pinned host memory and copied
    with non_blocking=True: the copy is queued behind the stream's
    earlier kernels instead of holding the host until they end (PyTorch's
    pinned-memory cache reuses a buffer only once its copy is done)."""
    dev = torch.device(device)
    pin = dev.type == "cuda"
    B, K = len(steps), steps[0].k_slots
    tabs = torch.empty((B, r_cap, K, 4), dtype=torch.int32, pin_memory=pin)
    act = torch.empty((B, r_cap, K), dtype=torch.bool, pin_memory=pin)
    tgt = torch.empty((B, r_cap), dtype=torch.int32, pin_memory=pin)
    tn, an, gn = tabs.numpy(), act.numpy(), tgt.numpy()
    for i, s in enumerate(steps):
        s.pad_into(tn[i], an[i], gn[i])
    return tuple(x.to(dev, non_blocking=pin) for x in (tabs, act, tgt))


# -- packed results --------------------------------------------------------

PACKED_FIELDS = ("survived", "overflow", "dead_step", "max_frontier",
                 "configs_explored")


def verdict(result: dict) -> bool | str:
    """Tri-state validity: a surviving search proves linearizability; a
    dead one refutes it unless configs were dropped (overflow)."""
    if bool(result["survived"]):
        return True
    return "unknown" if bool(result["overflow"]) else False


def unpack_np(arr) -> dict:
    """np int32[..., 5] -> dict of per-field arrays (PACKED_FIELDS)."""
    arr = np.asarray(arr)
    return {"survived": arr[..., 0] != 0, "overflow": arr[..., 1] != 0,
            "dead_step": arr[..., 2], "max_frontier": arr[..., 3],
            "configs_explored": arr[..., 4]}


def assemble_batch_results(out: dict, steps, cfg: DenseConfig) -> list[dict]:
    """Unpacked [B] arrays -> one result dict per history."""
    results = []
    for i, s in enumerate(steps):
        one = {k: out[k][i].item() for k in out}
        one["valid"] = verdict(one)
        one["op_count"] = s.n_ops
        one["configs_explored"] = int(one["configs_explored"])
        one["table_cells"] = cfg.n_states * cfg.n_masks
        results.append(one)
    return results
