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
assembly) and the plain PyTorch version of the sweep, `check_batch_plain`.
The CUDA kernel that runs the same sweep on the card, and the route that
sends batches to it, are in ops/wgl3_kernels.py.

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


def dense_config(model: Model, k_slots: int,
                 max_value: int) -> DenseConfig | None:
    """DenseConfig for this (model, history), or None when infeasible.

    Feasible iff the model's states are bounded by the history's values,
    S <= 32, K >= 5 (32 configs per word) and S * 2^K fits the cell
    budget. S is rounded up to a multiple of 4."""
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


def _sweep(T: torch.Tensor, allowed: torch.Tensor,
           tr: torch.Tensor) -> torch.Tensor:
    """One Gauss-Seidel sweep: fire each slot once, in slot order, so
    chains within the sweep propagate. T int64[B, S, W], tr bool[B, K, S, S']."""
    B, S, W = T.shape
    K = tr.shape[1]
    for j in range(K):
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


def sweep_plain(trans: torch.Tensor, targets: torch.Tensor, cfg: DenseConfig,
                row0: int) -> torch.Tensor:
    """The plain sweep over a batch: trans bool[B, R, K, S, S'], targets
    int[B, R] (-1 = pad, always a suffix) -> int32[B, 5] in PACKED_FIELDS
    order. The closure runs until a sweep changes nothing; a monotone
    operator has one least fixpoint above the step's starting table, so
    the sweep order does not change the result."""
    B, R = targets.shape
    dev = targets.device
    W = cfg.n_words
    T = torch.zeros((B, cfg.n_states, W), dtype=torch.int64, device=dev)
    T[:, row0, 0] = 1
    dead = torch.zeros(B, dtype=torch.bool, device=dev)
    dead_step = torch.full((B,), -1, dtype=torch.int64, device=dev)
    maxf = torch.ones(B, dtype=torch.int64, device=dev)
    cfgs = torch.zeros(B, dtype=torch.int64, device=dev)
    w_idx = torch.arange(W, dtype=torch.int64, device=dev)
    tg = targets.to(torch.int64)
    for r in range(R):
        real = tg[:, r] >= 0
        if not bool(real.any()):
            break                       # only pads remain, in every row
        t = tg[:, r].clamp(min=0)
        allowed = _allowed(t, w_idx)
        tr = trans[:, r]
        Tc = T
        while True:
            Tn = _sweep(Tc, allowed, tr)
            if torch.equal(Tn, Tc):
                break
            Tc = Tn
        Tc = torch.where(real[:, None, None], Tc, T)
        n = torch.where(real, popcount32(Tc).sum(dim=(1, 2)), 0)
        pruned = _prune(Tc, t, allowed, w_idx)
        died = real & ~dead & ~(pruned != 0).any(dim=(1, 2))
        dead_step = torch.where(died, r, dead_step)
        dead |= died
        T = torch.where(real[:, None, None], pruned, T)
        T = torch.where(dead[:, None, None], 0, T)
        maxf = torch.maximum(maxf, n)
        cfgs += n
    return torch.stack([(~dead).to(torch.int64), torch.zeros_like(cfgs),
                        dead_step, maxf, wrap_i32(cfgs)],
                       dim=-1).to(torch.int32)


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the same values wrapped to 32-bit two's complement, as the
    Pallas kernels' i32 configs_explored accumulator wraps past 2^31."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2**31, x - 2**32, x)


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


def step_bucket(n_steps: int) -> int:
    """Pad scan lengths to {2^k, 1.5*2^k} buckets (at most 33% pads)."""
    r = limits().step_bucket_floor
    while r < n_steps:
        if r + r // 2 >= n_steps:
            return r + r // 2
        r *= 2
    return r


def batch_steps3(encs: Sequence[EncodedHistory], model: Model,
                 cfg: DenseConfig | None = None):
    """Host half of a batched launch: tighten, reslot and encode a batch
    into per-history ReturnSteps under one shared geometry, and the
    bucketed common step count. Raises ValueError when no shared dense
    geometry exists."""
    k = max(tight_k_slots(e) for e in encs)
    if cfg is None:
        cfg = dense_config(model, k, max(e.max_value for e in encs))
    if cfg is None:
        raise ValueError("dense kernel infeasible for this batch")
    steps = [encode_return_steps(
        reslot_events(e, k) if e.k_slots != k else e) for e in encs]
    r_cap = step_bucket(max(s.n_steps for s in steps))
    return cfg, steps, r_cap


def stack_steps3(steps: Sequence[ReturnSteps], r_cap: int, device):
    """Pad to the common step count, stack, and put the arrays on
    `device`: (slot_tabs int32[B,R,K,4], slot_active bool[B,R,K],
    targets int32[B,R])."""
    padded = [s.padded_to(r_cap) for s in steps]
    tabs = np.stack([p.slot_tabs for p in padded])
    act = np.stack([p.slot_active for p in padded])
    tgt = np.stack([p.targets for p in padded])
    dev = torch.device(device)
    return (torch.from_numpy(tabs).to(dev), torch.from_numpy(act).to(dev),
            torch.from_numpy(tgt).to(dev))


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
