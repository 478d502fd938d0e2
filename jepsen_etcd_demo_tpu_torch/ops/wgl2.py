"""The sort search: WGL linearizability over an explicit frontier, the
general path for histories whose dense table would be too large.

The frontier is a fixed-capacity set of configs (state, linearized mask):
states int32[B, F], masks int64[B, F, W] (uint32 words kept in int64;
slot j is bit j % 32 of word j // 32) and valid bool[B, F], for B
histories in lockstep. Each return step closes the frontier under firing
pending ops, round by round (every valid config fires every legal,
active, unfired slot; configs that already fired the returning op are
banked and never expanded), sorting and deduplicating the configs after
each round until their count stops growing, then prunes at the returning
slot. When a round finds more unique configs than the capacity f_cap,
the extra ones are dropped and the step records an overflow: a
surviving search is still a proof, a dead one is then "unknown".

`check_steps_resumable` runs one history in chunks of 256 steps with the
frontier checkpointed at every chunk boundary: an overflowing chunk runs
again from its checkpoint at 4x the capacity, until the frontier fits or
the capacity passes f_cap_max (MemoryError). The checkpoint of the chunk
the search died in can be kept for the witness
(checkers/witness.reconstruct_witness_from_sort_checkpoint).
`check_steps_batch` runs a batch at one capacity, the batched tiers of
the general path (wgl3_kernels._batch_general).

The JAX package runs this search with XLA, outside any Pallas kernel, and
so does the port: torch ops on the card (sort, cumsum, scatter). The
frontier after every step equals the JAX carry bit for bit: the sort
order is the same (invalid flag, then state, then mask word 0, word 1,
...) and, where (state, mask) fits one uint32 key, the packed dedup sorts
the keys twice with 0xFFFFFFFF as the invalid key, as there. That holds
with subsumption off (`limits.subsume_mode` 1): by default a step over
forever-pending ops also drops the configs another subsumes
(ops/subsume.py), which the JAX package does not.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch

from ..carry import frontier_to_numpy
from ..device import resolve_device
from ..models.base import Model
from .encode import EncodedHistory, ReturnSteps, encode_return_steps
from .limits import limits

PACKED_INVALID = 0xFFFFFFFF
_WORD = 0xFFFFFFFF
DEFAULT_CHUNK = 256   # return steps per chunk = checkpoint granularity

# Work of the resumable search since the last reset, per frontier
# capacity: {f_cap: [return steps run, host-clock seconds]}, reruns after
# an overflow included (each chunk ends in a host sync, so the seconds
# cover the device's work). chip_smoke.py reads it for the seconds a step.
stats: dict[int, list] = {}


def reset_stats() -> None:
    stats.clear()


@dataclass(frozen=True)
class WGLConfig:
    """Sort-search geometry."""
    k_slots: int = 32       # pending-op slot capacity (mask width)
    f_cap: int = 256        # frontier capacity after dedup
    # > 0: (state + state_offset) fits these bits and the packed dedup
    # sorts one uint32 key per config (see packable).
    state_bits: int = 0

    @property
    def words(self) -> int:
        return (self.k_slots + 31) // 32


class SearchBudgetExceeded(MemoryError):
    """The resumable search ran out of wall-clock time. A MemoryError, so
    callers take the same exact-or-unknown fallback as for capacity."""


class Carry(NamedTuple):
    states: torch.Tensor        # int32[B, F]
    masks: torch.Tensor         # int64[B, F, W] (uint32 words)
    valid: torch.Tensor         # bool[B, F]
    dead: torch.Tensor          # bool[B]
    overflow: torch.Tensor      # bool[B]
    dead_step: torch.Tensor     # int64[B] (return-step index, -1 alive)
    max_frontier: torch.Tensor  # int64[B]


def packable(model: Model, cfg: WGLConfig) -> bool:
    """(state, mask) fits one uint32 key: bounded states (cfg.state_bits,
    from the history's values) and one mask word with headroom."""
    return (cfg.state_bits > 0 and model.packable_states
            and cfg.state_bits + cfg.k_slots <= 31)


def make_config(model: Model, k_slots: int, f_cap: int,
                max_value: int) -> WGLConfig:
    """WGLConfig with the packing bits of the history's real values,
    rounded up to a multiple of 4 where the headroom allows, and 0 when
    the key cannot be packed at all."""
    bits = model.pack_bits(max_value)
    if bits:
        rounded = (bits + 3) // 4 * 4
        if rounded + k_slots <= 31:
            bits = rounded
        elif bits + k_slots > 31:
            bits = 0
    return WGLConfig(k_slots, f_cap, state_bits=bits)


def config_for(rs: ReturnSteps, model: Model, f_cap: int) -> WGLConfig:
    return make_config(model, rs.k_slots, f_cap, rs.max_value)


def sort_k_slots(enc: EncodedHistory) -> int:
    """Slot-table width of the sort search for this history: its real
    concurrency rounded up to a multiple of 4, floor 8."""
    return max(8, (enc.max_pending + 3) // 4 * 4)


def _slot_constants(cfg: WGLConfig, device):
    k, w = cfg.k_slots, cfg.words
    j = torch.arange(k, device=device)
    word, bit = j // 32, j % 32
    bitmask = torch.zeros((k, w), dtype=torch.int64, device=device)
    bitmask[j, word] = torch.ones_like(j) << bit
    return word, bit, bitmask


def _lexsort(keys: list[torch.Tensor]) -> torch.Tensor:
    """Row-wise order of int64[B, N] keys, the last key primary (numpy's
    lexsort), by stable sorts from the least significant key up."""
    order = None
    for k in keys:
        kk = k if order is None else k.gather(1, order)
        idx = torch.sort(kk, dim=1, stable=True)[1]
        order = idx if order is None else order.gather(1, idx)
    return order


def _dedup(states, masks, valid, f_cap: int):
    """Sort rows by (valid first, state, mask words), keep the unique
    valid rows, compacted into a fresh frontier of capacity f_cap:
    int32[B, N], int64[B, N, W], bool[B, N] -> (states, masks, valid,
    n_unique int64[B])."""
    B, N, W = masks.shape
    dev = masks.device
    hi = (~valid).to(torch.int64) << 33 | (states.to(torch.int64) + 2**31)
    order = _lexsort([masks[..., i] for i in range(W - 1, -1, -1)] + [hi])
    s_states = states.gather(1, order)
    s_masks = masks.gather(1, order[..., None].expand(B, N, W))
    s_valid = valid.gather(1, order)
    eq_prev = torch.zeros_like(s_valid)
    eq_prev[:, 1:] = ((s_states[:, 1:] == s_states[:, :-1])
                      & (s_masks[:, 1:] == s_masks[:, :-1]).all(-1))
    unique = s_valid & ~eq_prev
    n_unique = unique.sum(1)
    pos = unique.to(torch.int64).cumsum(1) - 1
    dest = torch.where(unique & (pos < f_cap), pos, f_cap)
    new_states = torch.zeros((B, f_cap + 1), dtype=states.dtype, device=dev
                             ).scatter_(1, dest, s_states)[:, :f_cap]
    new_masks = torch.zeros((B, f_cap + 1, W), dtype=torch.int64, device=dev
                            ).scatter_(1, dest[..., None].expand(B, N, W),
                                       s_masks)[:, :f_cap]
    new_valid = (torch.arange(f_cap, device=dev)[None, :]
                 < n_unique.clamp(max=f_cap)[:, None])
    return new_states, new_masks, new_valid, n_unique


def _dedup_packed(keys: torch.Tensor, f_cap: int):
    """Single-key dedup of int64[B, N] uint32 keys: sort (the invalid key
    sorts last), blank each duplicate to the invalid key, and sort again,
    so the unique keys fill the first n_unique places in ascending order.
    -> (keys int64[B, f_cap], n_unique int64[B])."""
    s = torch.sort(keys, dim=1)[0]
    eq_prev = torch.zeros_like(s, dtype=torch.bool)
    eq_prev[:, 1:] = s[:, 1:] == s[:, :-1]
    unique = (s != PACKED_INVALID) & ~eq_prev
    out = torch.sort(torch.where(unique, s, PACKED_INVALID), dim=1)[0]
    return out[:, :f_cap], unique.sum(1)


def make_step_fn2(model: Model, cfg: WGLConfig, device):
    """The search's step over a batch: step(carry, slot_tab int32[B,K,4],
    slot_active bool[B,K], target int32[B], idx, classes) -> the next
    carry. `idx` is the step's index in the history (dead_step); with
    `classes` (ops/canon.StepClasses of this step) every expansion round
    canonicalises the frontier and the candidates before the dedup."""
    from .canon import canon_keys_packed, canon_masks_words
    from .subsume import subsume

    word_of, bit_of, slot_bitmask = _slot_constants(cfg, device)
    f_cap, W = cfg.f_cap, cfg.words
    use_packed = packable(model, cfg)
    sbits, soff = cfg.state_bits, model.state_offset

    def pack(states, mask_word, valid):
        key = (((states.to(torch.int64) + soff) & _WORD)
               | ((mask_word << sbits) & _WORD))
        return torch.where(valid, key, PACKED_INVALID)

    def unpack(keys):
        valid = keys != PACKED_INVALID
        states = ((keys & ((1 << sbits) - 1)) - soff).to(torch.int32)
        masks = (keys >> sbits)[..., None]
        return (torch.where(valid, states, 0),
                torch.where(valid[..., None], masks, 0), valid)

    def step(carry: Carry, slot_tab, slot_active, target, idx: int,
             classes=None, forever=None) -> Carry:
        B, F = carry.valid.shape
        is_pad = target < 0
        tgt = target.clamp(min=0).to(torch.int64)
        t_word, t_bit = tgt // 32, tgt % 32
        f, a1, a2, rv = (slot_tab[:, None, :, i] for i in range(4))

        def candidates(s, m, v):
            legal, nxt = model.step(s[:, :, None], f, a1, a2, rv)
            tw = m.gather(2, t_word[:, None, None].expand(-1, m.shape[1], 1))
            not_done = ((tw[..., 0] >> t_bit[:, None]) & 1) == 0
            unfired = ((m[:, :, word_of] >> bit_of) & 1) == 0
            cand = (v[:, :, None] & not_done[:, :, None]
                    & ~is_pad[:, None, None] & slot_active[:, None, :]
                    & unfired & legal)
            return nxt, cand

        def expand_once(s, m, v):
            nxt, cand = candidates(s, m, v)
            if forever is not None:
                return expand_subsumed(s, m, v, nxt, cand)
            if use_packed:
                cand_words = m[:, :, None, 0] | slot_bitmask[None, None, :, 0]
                keys = torch.cat([pack(s, m[..., 0], v),
                                  pack(nxt.reshape(B, -1),
                                       cand_words.reshape(B, -1),
                                       cand.reshape(B, -1))], dim=1)
                if classes is not None:
                    keys = canon_keys_packed(keys, classes, sbits,
                                             PACKED_INVALID)
                keys, n_unique = _dedup_packed(keys, f_cap)
                s2, m2, v2 = unpack(keys)
                return s2, m2, v2, n_unique
            cand_masks = m[:, :, None, :] | slot_bitmask[None, None]
            all_s = torch.cat([s, nxt.reshape(B, -1)], dim=1)
            all_m = torch.cat([m, cand_masks.reshape(B, -1, W)], dim=1)
            all_v = torch.cat([v, cand.reshape(B, -1)], dim=1)
            if classes is not None:
                all_m = canon_masks_words(all_m, classes)
            return _dedup(all_s, all_m, all_v, f_cap)

        def expand_subsumed(s, m, v, nxt, cand):
            # Every unique config first, the subsumed ones dropped, then
            # the capacity: only configs no other subsumes overflow.
            cand_masks = m[:, :, None, :] | slot_bitmask[None, None]
            all_s = torch.cat([s, nxt.reshape(B, -1)], dim=1)
            all_m = torch.cat([m, cand_masks.reshape(B, -1, W)], dim=1)
            all_v = torch.cat([v, cand.reshape(B, -1)], dim=1)
            # The live rows first and the rest cut: few of the F * (K + 1)
            # candidates fire.
            live = torch.sort((~all_v).to(torch.uint8), dim=1,
                              stable=True)[1][:, :max(1, int(
                                  all_v.sum(1).max()))]
            all_s, all_v = all_s.gather(1, live), all_v.gather(1, live)
            all_m = all_m.gather(1, live[..., None].expand(-1, -1, W))
            if classes is not None:
                all_m = canon_masks_words(all_m, classes)
            u_s, u_m, u_v, _n = _dedup(all_s, all_m, all_v, all_s.shape[1])
            u_v = subsume(u_s, u_m, u_v, forever)
            return _dedup(u_s, u_m, u_v, f_cap)

        def same_set(s, m, v, s2, m2, v2):
            """Both frontiers hold the same configs (sorted, compacted)."""
            return (((s == s2) & (m == m2).all(-1)) | ~(v | v2)).all(1) \
                & (v == v2).all(1)

        s, m, v = carry.states, carry.masks, carry.valid
        n = v.sum(1)
        overflow = carry.overflow
        changed = ~is_pad
        it = torch.zeros_like(n)
        while True:
            # K rounds close any frontier: each fires one more of K slots.
            active = changed & (it < cfg.k_slots)
            if not bool(active.any()):
                break
            s2, m2, v2, n_unique = expand_once(s, m, v)
            n_now = n_unique.clamp(max=f_cap)
            # Subsumption can replace configs without growing the count.
            grew = (n_now > n if forever is None
                    else ~same_set(s, m, v, s2, m2, v2))
            if bool(active.all()):
                s, m, v = s2, m2, v2
                overflow = overflow | (n_unique > f_cap)
                changed = grew
                n = n_now
            else:
                a1d = active[:, None]
                s = torch.where(a1d, s2, s)
                m = torch.where(a1d[..., None], m2, m)
                v = torch.where(a1d, v2, v)
                overflow = torch.where(active, overflow | (n_unique > f_cap),
                                       overflow)
                changed = torch.where(active, grew, changed)
                n = torch.where(active, n_now, n)
            it = it + active.to(it.dtype)

        tw = m.gather(2, t_word[:, None, None].expand(-1, F, 1))[..., 0]
        has_bit = ((tw >> t_bit[:, None]) & 1) == 1
        keep = v & (is_pad[:, None] | has_bit)
        cleared = torch.where(is_pad[:, None, None], m,
                              m & ~slot_bitmask[tgt][:, None, :])
        died = ~is_pad & ~carry.dead & ~keep.any(1)
        dead = carry.dead | died
        return Carry(
            states=s, masks=cleared, valid=keep & ~dead[:, None], dead=dead,
            overflow=overflow,
            dead_step=torch.where(died & (carry.dead_step < 0), idx,
                                  carry.dead_step),
            max_frontier=torch.maximum(carry.max_frontier, n))

    return step


def _init_carry2(model: Model, cfg: WGLConfig, batch: int, dev) -> Carry:
    F, W = cfg.f_cap, cfg.words
    states = torch.zeros((batch, F), dtype=torch.int32, device=dev)
    states[:, 0] = int(model.init_state())
    valid = torch.zeros((batch, F), dtype=torch.bool, device=dev)
    valid[:, 0] = True
    return Carry(
        states=states,
        masks=torch.zeros((batch, F, W), dtype=torch.int64, device=dev),
        valid=valid,
        dead=torch.zeros(batch, dtype=torch.bool, device=dev),
        overflow=torch.zeros(batch, dtype=torch.bool, device=dev),
        dead_step=torch.full((batch,), -1, dtype=torch.int64, device=dev),
        max_frontier=torch.ones(batch, dtype=torch.int64, device=dev))


def _migrate_carry(carry: Carry, f_new: int) -> Carry:
    """Grow a checkpoint's frontier capacity to f_new (escalation)."""
    pad = f_new - carry.states.shape[1]
    return carry._replace(
        states=torch.nn.functional.pad(carry.states, (0, pad)),
        masks=torch.nn.functional.pad(carry.masks, (0, 0, 0, pad)),
        valid=torch.nn.functional.pad(carry.valid, (0, pad)))


def _step_inputs(rs: ReturnSteps, dev, n: int | None = None):
    n = rs.n_steps if n is None else n
    return tuple(torch.from_numpy(np.ascontiguousarray(a[:n])).to(dev)
                 for a in (rs.slot_tabs, rs.slot_active, rs.targets))


def check_steps_batch(slot_tabs: torch.Tensor, slot_active: torch.Tensor,
                      targets: torch.Tensor, model: Model, cfg: WGLConfig,
                      forever: torch.Tensor | None = None,
                      classes=None) -> dict[str, torch.Tensor]:
    """The whole scan of a batch at one capacity, on the inputs' device:
    slot_tabs int32[B,R,K,4], slot_active bool[B,R,K], targets int32[B,R]
    (-1 = pad, a suffix) -> {survived, overflow, dead_step, max_frontier}
    tensors [B]. With `forever` (int64[B,R,W], ops/subsume) each step
    drops the subsumed configs, canonicalised first under `classes`
    (ops/canon.batch_classes) when given. Stops once every history is
    dead or past its steps (a pad or a step after death changes none of
    the fields)."""
    from .canon import step_batch_classes

    B, R = targets.shape
    dev = targets.device
    step = make_step_fn2(model, cfg, dev)
    carry = _init_carry2(model, cfg, B, dev)
    steps = (targets >= 0).sum(1)
    for r in range(R):
        live = (~carry.dead) & (steps > r)
        if not bool(live.any()):
            break
        pm = (None if forever is None or not bool(forever[:, r].any())
              else forever[:, r])
        cls = (None if pm is None or classes is None
               else step_batch_classes(classes[0], classes[1][:, r]))
        carry = step(carry, slot_tabs[:, r], slot_active[:, r],
                     targets[:, r], r, cls, pm)
    return {"survived": ~carry.dead, "overflow": carry.overflow,
            "dead_step": carry.dead_step, "max_frontier": carry.max_frontier}


def check_steps_resumable(rs: ReturnSteps, model: Model | None = None,
                          f_cap: int = 256, chunk: int = DEFAULT_CHUNK,
                          f_cap_max: int = 1 << 20,
                          time_budget_s: float | None = None,
                          keep_death_checkpoint: bool = False,
                          device=None) -> dict[str, Any]:
    """Exact verdict of one history by chunked search with checkpointed
    capacity escalation, on `device` (None = cuda).

    Chunks of `chunk` return steps run from the frontier at their start;
    a chunk that overflows runs again from that checkpoint at 4x the
    capacity, until it fits or the capacity passes f_cap_max
    (MemoryError). `time_budget_s` bounds the wall time: at a chunk
    boundary past it, SearchBudgetExceeded. With keep_death_checkpoint,
    an invalid result carries `death_checkpoint` = (states int32[F],
    masks uint32[F, W], valid bool[F], step): the exact frontier at the
    start of the chunk the search died in."""
    from .canon import history_canon_pairs, history_classes
    from .subsume import history_forever_masks

    if model is None:
        from ..models import CASRegister
        model = CASRegister()
    dev = resolve_device(device)
    t0 = time.monotonic()
    n = rs.n_steps
    tabs, act, tgt = _step_inputs(rs, dev)
    pairs = history_canon_pairs(rs)
    classes = (None if pairs is None
               else history_classes(pairs[:n], rs.k_slots, dev))
    forever = history_forever_masks(rs, dev)
    cfg = config_for(rs, model, f_cap)
    carry = _init_carry2(model, cfg, 1, dev)
    escalations = 0
    death_ckpt = None
    chunk_starts = list(range(0, max(n, 1), chunk))

    def budget_check(c0: int) -> None:
        if (time_budget_s is not None
                and time.monotonic() - t0 > time_budget_s):
            raise SearchBudgetExceeded(
                f"WGL search exceeded its {time_budget_s:.0f}s time budget "
                f"at return step {c0} (chunk boundary {c0 // chunk} of "
                f"{len(chunk_starts)}, chunk={chunk}; f_cap={f_cap} of "
                f"f_cap_max={f_cap_max}, escalations={escalations}); the "
                f"frontier is growing combinatorially. Raise the budget "
                f"(time_budget_s; None = unbounded) to search longer")

    def run_chunk(c0: int, pre: Carry) -> Carry:
        t1 = time.perf_counter()
        step = make_step_fn2(model, cfg, dev)
        out = pre
        r = c0
        while r < min(c0 + chunk, n):
            cls = None if classes is None else classes[0][classes[1][r]]
            pm = (None if forever is None or not bool(forever[r].any())
                  else forever[r:r + 1])
            out = step(out, tabs[r:r + 1], act[r:r + 1], tgt[r:r + 1], r,
                       cls, pm)
            r += 1
            # A chunk that overflowed runs again; one that died is done.
            if any(torch.cat([out.dead, out.overflow]).tolist()):
                break
        work = stats.setdefault(cfg.f_cap, [0, 0.0])
        work[0] += r - c0
        work[1] += time.perf_counter() - t1
        return out

    for c0 in chunk_starts:
        budget_check(c0)
        pre = carry
        out = run_chunk(c0, pre)
        if bool(out.overflow[0]):
            while True:
                f_cap *= 4
                escalations += 1
                if f_cap > f_cap_max:
                    raise MemoryError(
                        f"WGL frontier exceeds f_cap_max={f_cap_max} at "
                        f"return step {c0} (chunk boundary {c0 // chunk} "
                        f"of {len(chunk_starts)}, chunk={chunk}; "
                        f"escalations={escalations}); the dense-chunked "
                        f"sweep has no frontier capacity")
                cfg = config_for(rs, model, f_cap)
                pre = _migrate_carry(pre, f_cap)
                budget_check(c0)
                out = run_chunk(c0, pre)
                if not bool(out.overflow[0]):
                    break
        carry = out
        if bool(out.dead[0]):
            if keep_death_checkpoint:
                death_ckpt = frontier_to_numpy(*pre[:3]) + (c0,)
            break
    from ..plan import plan_resumable

    dead = bool(carry.dead[0])
    res = {"plan_family": plan_resumable(classes is not None),
           "survived": not dead, "overflow": False, "n_steps": n,
           "dead_step": int(carry.dead_step[0]),
           "max_frontier": int(carry.max_frontier[0]),
           "f_cap": f_cap, "escalations": escalations, "valid": not dead}
    if death_ckpt is not None:
        res["death_checkpoint"] = death_ckpt
    return res


def checkpoint_configs(states, masks, valid) -> list[tuple[int, int]]:
    """Host view of a checkpoint frontier: (state, mask as an int) per
    valid row, mask words combined little-endian."""
    states, masks, valid = (np.asarray(a) for a in (states, masks, valid))
    out = []
    for i in np.nonzero(valid)[0]:
        m = 0
        for j in range(masks.shape[1]):
            m |= int(masks[i, j]) << (32 * j)
        out.append((int(states[i]), m))
    return out


def check_encoded_resumable(enc: EncodedHistory, model: Model | None = None,
                            f_cap: int = 256, f_cap_max: int = 1 << 20,
                            time_budget_s: float | None = None,
                            keep_death_checkpoint: bool = False,
                            device=None) -> dict[str, Any]:
    """The sort search of one encoded history at its real concurrency
    (sort_k_slots), on `device` (None = cuda). Raises MemoryError when the
    frontier outgrows f_cap_max (the dense-chunked rung then takes it)."""
    from .encode import reslot_events

    if model is None:
        from ..models import CASRegister
        model = CASRegister()
    tight = sort_k_slots(enc)
    if tight < enc.k_slots:
        enc = reslot_events(enc, tight)
    # The escalation loop checks f_cap_max only after an overflow, so the
    # starting capacity is clamped too.
    f_cap = max(4, min(f_cap, f_cap_max))
    out = check_steps_resumable(encode_return_steps(enc, device), model,
                                f_cap=f_cap, f_cap_max=f_cap_max,
                                time_budget_s=time_budget_s,
                                keep_death_checkpoint=keep_death_checkpoint,
                                device=device)
    out["op_count"] = enc.n_ops
    return out
