"""The sweeps on the card: column-mask prep, the CUDA kernels' wrappers,
and the routes that send encoded histories to them.

Four wrappers, one per kernel entry:
  * `dense_sweep`: csrc/wgl3_sweep.cu over a batch, whole scan per
    history (replaces the JAX package's per-history and grouped Pallas
    sweeps);
  * `dense_sweep_resumable`: the same kernel over one window of a long
    history, its table and metadata carried in and out (replaces the
    resumable Pallas sweep);
  * `dense_sweep_global`: the same kernel's global tier, one window of
    one history whose table (past 2^20 bits, up to 2^26) is split over
    the shared memories of a thread-block cluster: the general path's
    dense-chunked rung (the resumable Pallas sweep at the tables the JAX
    package's chunked budget admits);
  * `sparse_sweep_resumable`: csrc/wgl3_sparse.cu, the window sweep whose
    closure rounds visit only the live 128-word blocks (replaces the
    sparse work-list Pallas sweep).
For CUDA tensors each launches its kernel or raises; for CPU tensors it
runs the kernel's plain PyTorch version (ops/wgl3.py), the only reason
being that the tensors lie on the host.

Carries on the device side: table int32[B, S, W] (uint32 bit patterns)
and meta int32[B, 5] (dense) or int32[B, 8] (sparse), laid out as
ops/wgl3.py describes. The kernels update a carry in place; callers use
the carry a wrapper returns.
"""

from __future__ import annotations

import ctypes
import threading
import time
from functools import partial
from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..models.base import Model
from . import wgl3
from .encode import EncodedHistory, ReturnSteps
from .limits import limits
from .wgl3_sparse import MAX_BLOCKS, sparse_plan

# Kernel launches since the last reset, per wrapper: each wrapper adds one
# where it launches its kernel and nowhere else. chip_smoke.py reads them
# to show which kernels the main path ran on. dense_sweep counts every
# fresh sweep; dense_sweep_grouped counts those of them that swept one of
# the corpus scheduler's buckets (the JAX package's grouped kernel), so
# the difference is the single-history route's.
launches = {"dense_sweep": 0, "dense_sweep_grouped": 0,
            "dense_sweep_resumable": 0, "dense_sweep_global": 0,
            "sparse_sweep_resumable": 0}

# Table sizes in bits (S * 2^K): up to SHARED_TABLE_BITS a table lives in
# one block's shared memory (128 KiB); past it, up to GLOBAL_TABLE_BITS
# (8 MiB), in the shared memories of the global tier's blocks.
SHARED_TABLE_BITS = 1 << 20
GLOBAL_TABLE_BITS = 1 << 26
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    # ln, tg, cm, out, Tio, meta, B, R, S, K, row0, stream
    "wgl3_sweep": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # ln, tg, cm, Tio, meta, B, R, S, K, rounds, thresh, stream
    "wgl3_sparse": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # ln, tg, cm, T, meta, flags, R, S, K, stream
    "wgl3_sweep_global": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
}
# Where csrc/wgl3_sweep.cu's register route keeps a step's slot table, as
# its wgl3_sweep_launch_slot_table takes it: None leaves it to the
# launcher's rule (registers for a batch of fewer histories than the card
# has SMs, the step ring otherwise); "registers" or "ring" forces one. Both
# give the same result; chip_smoke.py times the two.
SLOT_TABLES = {None: 0, "registers": 1, "ring": 2}


_launches_lock = threading.Lock()


def reset_launches() -> None:
    with _launches_lock:
        for name in launches:
            launches[name] = 0


def launch_counts() -> dict:
    """A copy of `launches`, read under its lock."""
    with _launches_lock:
        return dict(launches)


def _count(*names: str) -> None:
    """Add one launch to each of `names`: under a lock, since the checking
    daemon launches from its executor thread and its sessions' consumer
    threads at once."""
    with _launches_lock:
        for name in names:
            launches[name] += 1


def prepare_colmask(model: Model, cfg: wgl3.DenseConfig,
                    slot_tabs: torch.Tensor, slot_active: torch.Tensor,
                    targets: torch.Tensor):
    """Transition matrices -> bit-packed column masks, on the inputs'
    device.

    slot_tabs int32[B,R,K,4], slot_active bool[B,R,K], targets int32[B,R]
    -> (ln int32[B], tg int32[B,R], cm int32[B,R,S,K]). Bit s of
    cm[b, r, s', j] says that firing slot j moves state row s to row s';
    the words are uint32 bit patterns kept in int32 (torch has no uint32
    shifts). `ln` counts each history's real return steps (pads are -1 and
    always a suffix), which bounds the kernel's scan."""
    S = cfg.n_states
    ok, nxt_row = wgl3.step_rows(model, cfg, slot_tabs, slot_active)
    bits = torch.where(
        ok, torch.ones_like(nxt_row) << torch.arange(S, device=ok.device), 0)
    cm = torch.zeros_like(bits).scatter_add_(
        -1, nxt_row.clamp(0, S - 1), bits)          # [B,R,K,S'], distinct bits
    cm = torch.where(cm >= 2**31, cm - 2**32, cm).to(torch.int32)
    cm = cm.transpose(-1, -2).contiguous()          # [B,R,S',K]
    tg = targets.to(torch.int32).contiguous()
    ln = (tg >= 0).sum(dim=1, dtype=torch.int32)
    return ln, tg, cm


def colmask_transitions(cm: torch.Tensor) -> torch.Tensor:
    """Inverse of the packing: cm int32[B,R,S',K] -> bool[B,R,K,S,S']."""
    S = cm.shape[2]
    s_ids = torch.arange(S, dtype=torch.int32, device=cm.device)
    cols = cm.transpose(-1, -2)[..., None, :]       # [B,R,K,1,S']
    return ((cols >> s_ids[:, None]) & 1) != 0


def sweep_reference(ln: torch.Tensor, tg: torch.Tensor, cm: torch.Tensor,
                    cfg: wgl3.DenseConfig, row0: int) -> torch.Tensor:
    """dense_sweep's plain PyTorch version, on the inputs' device."""
    del ln  # implied by the -1 pads of tg
    return wgl3.sweep_plain(colmask_transitions(cm), tg, cfg, row0)


def resumable_reference(ln, tg, cm, cfg: wgl3.DenseConfig, T: torch.Tensor,
                        meta: torch.Tensor):
    """dense_sweep_resumable's plain version: a new carry, on the inputs'
    device (the given carry is left as it was)."""
    del ln
    T64, m64 = wgl3.sweep_plain_carry(colmask_transitions(cm), tg, cfg,
                                      wgl3.words64(T), meta.long())
    return wgl3.words32(T64), m64.to(torch.int32)


def sparse_reference(ln, tg, cm, cfg: wgl3.DenseConfig, T: torch.Tensor,
                     meta: torch.Tensor, thresh_blocks: int):
    """sparse_sweep_resumable's plain version: a new carry, on the inputs'
    device (the given carry is left as it was)."""
    del ln
    T64, m64 = wgl3.sweep_plain_sparse(colmask_transitions(cm), tg, cfg,
                                       wgl3.words64(T), meta.long(),
                                       thresh_blocks)
    return wgl3.words32(T64), m64.to(torch.int32)


def global_tier(cfg: wgl3.DenseConfig) -> bool:
    """The table is past one block's shared memory: the resumable sweep
    takes the global tier (dense_sweep_global)."""
    return cfg.n_states * cfg.n_masks > SHARED_TABLE_BITS


def check_geometry(cfg: wgl3.DenseConfig, tier: str = "shared") -> None:
    """Raise on a geometry the kernels do not take: K >= 5, S <= 32 and a
    table of at most 2^20 bits (128 KiB of shared memory), or with tier
    "global" more than 2^20 and at most 2^26 bits."""
    K, S = cfg.k_slots, cfg.n_states
    bits = S * (1 << K)
    lo, hi = ((SHARED_TABLE_BITS, GLOBAL_TABLE_BITS) if tier == "global"
              else (0, SHARED_TABLE_BITS))
    if K < 5 or S < 1 or S > 32 or not lo < bits <= hi:
        raise ValueError(
            f"wgl3_sweep ({tier}) takes 5 <= K, S <= 32 and "
            f"{lo} < S * 2^K <= {hi}; got K={K}, S={S}")
    wgl3._require_converging_cap(cfg)


def _launch(name: str, *args) -> None:
    from . import build

    if name == "wgl3_sweep_global":
        build.launcher("wgl3_sweep", _ARGTYPES[name],
                       "wgl3_sweep_global_launch")(*args)
        return
    build.launcher(name, _ARGTYPES[name])(*args)


def _launch_sweep(slot_table: str | None, *args) -> None:
    """csrc/wgl3_sweep.cu's wgl3_sweep_launch, or with `slot_table` set
    its wgl3_sweep_launch_slot_table; args as _ARGTYPES["wgl3_sweep"]."""
    if slot_table is None:
        _launch("wgl3_sweep", *args)
        return
    from . import build

    types = _ARGTYPES["wgl3_sweep"]
    build.launcher("wgl3_sweep", types[:-1] + [_I, _P],
                   "wgl3_sweep_launch_slot_table")(
        *args[:-1], SLOT_TABLES[slot_table], args[-1])


def _check_slot_table(slot_table) -> None:
    if slot_table not in SLOT_TABLES:
        raise ValueError(f"slot_table is one of {sorted(SLOT_TABLES, key=str)}"
                         f"; got {slot_table!r}")


def _device_of(cfg: wgl3.DenseConfig, ln, tg, cm, carry=()) -> str:
    """Check the operands' shapes and placement: 'cpu' when every tensor
    lies on the host, 'cuda' when all lie on one card as contiguous int32
    (what the kernels read); raises otherwise."""
    B, R = tg.shape
    if tuple(cm.shape) != (B, R, cfg.n_states, cfg.k_slots) \
            or tuple(ln.shape) != (B,):
        raise ValueError(
            f"shape mismatch: ln {tuple(ln.shape)}, tg {tuple(tg.shape)}, "
            f"cm {tuple(cm.shape)} for K={cfg.k_slots}, S={cfg.n_states}")
    if carry:
        T, meta = carry
        if tuple(T.shape) != (B, cfg.n_states, cfg.n_words) \
                or meta.dim() != 2 or meta.shape[0] != B:
            raise ValueError(f"carry shape mismatch: T {tuple(T.shape)}, "
                             f"meta {tuple(meta.shape)}")
    xs = (ln, tg, cm, *carry)
    devs = {x.device.type for x in xs}
    if devs == {"cpu"}:
        return "cpu"
    if devs != {"cuda"} or len({x.device for x in xs}) != 1:
        raise ValueError(f"operands must lie on one CUDA device or all on "
                         f"the CPU; got {[x.device for x in xs]}")
    for x in xs:
        if x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError("kernel operands must be contiguous int32 "
                             "tensors")
    return "cuda"


def card_global_geometry(n_states: int, k_slots: int) -> tuple[int, int]:
    """(blocks, cluster) that csrc/wgl3_sweep.cu's launcher picks for the
    global tier on the current card (its global_geometry: a cluster of 16
    blocks at 2^21 bits, as many blocks as clusters of 16 the card holds,
    up to 64, past it; cluster 0 when the card cannot hold the grid)."""
    from . import build

    fn = build.load("wgl3_sweep").wgl3_sweep_global_geometry
    fn.argtypes = [_I, _I, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 2)()
    rc = fn(n_states, k_slots, out)
    if rc != 0:
        raise RuntimeError(f"wgl3_sweep_global_geometry failed (code {rc})")
    return out[0], out[1]


def _stream(x: torch.Tensor):
    return torch.cuda.current_stream(x.device).cuda_stream


def dense_sweep(ln: torch.Tensor, tg: torch.Tensor, cm: torch.Tensor,
                cfg: wgl3.DenseConfig, row0: int, *,
                slot_table: str | None = None,
                grouped: bool = False) -> torch.Tensor:
    """Run the dense sweep from a fresh start: ln int32[B], tg int32[B,R],
    cm int32[B,R,S,K] -> int32[B, 5] in wgl3.PACKED_FIELDS order.

    On CUDA tensors this launches csrc/wgl3_sweep.cu on the current stream
    (it raises on anything the kernel does not take), its register route's
    slot table where `slot_table` says (SLOT_TABLES); on CPU tensors it
    runs the plain version. `grouped` marks a launch of a corpus
    scheduler's bucket, which launches["dense_sweep_grouped"] counts as
    well."""
    check_geometry(cfg)
    _check_slot_table(slot_table)
    if not 0 <= row0 < cfg.n_states:
        raise ValueError(f"initial row {row0} outside S={cfg.n_states}")
    if _device_of(cfg, ln, tg, cm) == "cpu":
        return sweep_reference(ln, tg, cm, cfg, row0)
    B, R = tg.shape
    out = torch.empty((B, 5), dtype=torch.int32, device=cm.device)
    with torch.cuda.device(cm.device):
        _launch_sweep(slot_table, ln.data_ptr(), tg.data_ptr(),
                      cm.data_ptr(), out.data_ptr(), None, None, B, R,
                      cfg.n_states, cfg.k_slots, row0, _stream(cm))
    _count("dense_sweep", *(("dense_sweep_grouped",) if grouped else ()))
    return out


def dense_sweep_resumable(ln: torch.Tensor, tg: torch.Tensor,
                          cm: torch.Tensor, cfg: wgl3.DenseConfig,
                          T: torch.Tensor, meta: torch.Tensor, *,
                          slot_table: str | None = None):
    """One window of the dense sweep from a carry: ln, tg, cm and
    slot_table as for dense_sweep, T int32[B,S,W], meta int32[B,5] -> the
    next (T, meta).

    On CUDA tensors this launches csrc/wgl3_sweep.cu with its carry
    pointers set, and the kernel updates T and meta in place; on CPU
    tensors it runs the plain version."""
    check_geometry(cfg)
    _check_slot_table(slot_table)
    if meta.shape[-1] != 5:
        raise ValueError(f"dense meta has 5 slots; got {tuple(meta.shape)}")
    if _device_of(cfg, ln, tg, cm, (T, meta)) == "cpu":
        return resumable_reference(ln, tg, cm, cfg, T, meta)
    B, R = tg.shape
    with torch.cuda.device(cm.device):
        _launch_sweep(slot_table, ln.data_ptr(), tg.data_ptr(),
                      cm.data_ptr(), None, T.data_ptr(), meta.data_ptr(), B,
                      R, cfg.n_states, cfg.k_slots, 0, _stream(cm))
    _count("dense_sweep_resumable")
    return T, meta


def dense_sweep_global(ln: torch.Tensor, tg: torch.Tensor, cm: torch.Tensor,
                       cfg: wgl3.DenseConfig, T: torch.Tensor,
                       meta: torch.Tensor):
    """One window of the dense sweep of ONE history whose table is past
    2^20 bits: as dense_sweep_resumable with B = 1.

    On CUDA tensors this launches csrc/wgl3_sweep.cu's global tier (the
    table split over the shared memories of a cluster of blocks, or of a
    few clusters behind a grid barrier; card_global_geometry), which
    updates T and meta in place; on CPU tensors it runs the plain
    version."""
    check_geometry(cfg, "global")
    if meta.shape[-1] != 5 or tg.shape[0] != 1:
        raise ValueError(f"the global tier takes one history and 5 meta "
                         f"slots; got tg {tuple(tg.shape)}, meta "
                         f"{tuple(meta.shape)}")
    if _device_of(cfg, ln, tg, cm, (T, meta)) == "cpu":
        return resumable_reference(ln, tg, cm, cfg, T, meta)
    flags = torch.zeros(9, dtype=torch.int32, device=cm.device)
    with torch.cuda.device(cm.device):
        _launch("wgl3_sweep_global", ln.data_ptr(), tg.data_ptr(),
                cm.data_ptr(), T.data_ptr(), meta.data_ptr(),
                flags.data_ptr(), tg.shape[1], cfg.n_states, cfg.k_slots,
                _stream(cm))
    _count("dense_sweep_global")
    return T, meta


def sparse_sweep_resumable(ln: torch.Tensor, tg: torch.Tensor,
                           cm: torch.Tensor, cfg: wgl3.DenseConfig,
                           T: torch.Tensor, meta: torch.Tensor,
                           thresh_blocks: int):
    """One window of the sparse work-list sweep from a carry: as
    dense_sweep_resumable with meta int32[B,8]; a closure round with at
    most `thresh_blocks` live blocks sweeps only those.

    On CUDA tensors this launches csrc/wgl3_sparse.cu, which updates T and
    meta in place; on CPU tensors it runs the plain version."""
    check_geometry(cfg)
    nb = cfg.n_words // wgl3.SPARSE_BLOCK_WORDS
    if not 2 <= nb <= MAX_BLOCKS:
        raise ValueError(f"wgl3_sparse takes 13 <= K <= 18 (2 to 64 blocks "
                         f"of 128 words); got K={cfg.k_slots}")
    if meta.shape[-1] != 8:
        raise ValueError(f"sparse meta has 8 slots; got {tuple(meta.shape)}")
    if _device_of(cfg, ln, tg, cm, (T, meta)) == "cpu":
        return sparse_reference(ln, tg, cm, cfg, T, meta, thresh_blocks)
    B, R = tg.shape
    with torch.cuda.device(cm.device):
        _launch("wgl3_sparse", ln.data_ptr(), tg.data_ptr(), cm.data_ptr(),
                T.data_ptr(), meta.data_ptr(), B, R, cfg.n_states,
                cfg.k_slots, cfg.rounds, thresh_blocks, _stream(cm))
    _count("sparse_sweep_resumable")
    return T, meta


# -- the long route ----------------------------------------------------------

def long_window(lim=None) -> int:
    """Steps per window of the resumable sweeps: the largest step bucket
    within limits().long_window_steps (the cap itself below 64)."""
    lim = lim or limits()
    window = lim.long_window_steps
    if window >= 64:
        b = 64
        while wgl3.step_bucket(b + 1) <= lim.long_window_steps:
            b = wgl3.step_bucket(b + 1)
        window = b
    return window


def sparse_selected(cfg: wgl3.DenseConfig) -> bool:
    """The long route takes the sparse kernel where the density policy
    (ops/wgl3_sparse.sparse_plan) selects the sparse sweep."""
    return sparse_plan(cfg) is not None


class BudgetExhausted(Exception):
    """The long sweep's time budget ran out before the window starting at
    return step `step`."""

    def __init__(self, step: int, budget_s: float):
        super().__init__(f"long sweep exceeded its {budget_s:.0f}s time "
                         f"budget at return step {step}")
        self.step = step


def start_carry(model: Model, cfg: wgl3.DenseConfig, device=None,
                sparse: bool = False):
    """The kernels' carry of a fresh search on `device` (None = cuda):
    table int32[1,S,W] and meta int32[1,5] (int32[1,8] when `sparse`)."""
    T, meta = wgl3.fresh_carry(cfg, wgl3.init_row(model, cfg), 1,
                               resolve_device(device), 8 if sparse else 5)
    return wgl3.words32(T), meta.to(torch.int32)


def prepare_steps(rs: ReturnSteps, model: Model, cfg: wgl3.DenseConfig,
                  device=None, start: int = 0, stop: int | None = None):
    """Return steps [start, stop) of rs as the resumable sweeps read them,
    prepared on `device` (None = cuda) in one copy: (tg int32[1,n],
    cm int32[1,n,S,K])."""
    dev = resolve_device(device)
    sl = slice(start, rs.n_steps if stop is None else stop)
    tabs, act, tgt = (torch.from_numpy(np.ascontiguousarray(a[None, sl]))
                      .to(dev)
                      for a in (rs.slot_tabs, rs.slot_active, rs.targets))
    _ln, tg, cm = prepare_colmask(model, cfg, tabs, act, tgt)
    return tg, cm


def window_sweep(sweep, tg: torch.Tensor, cm: torch.Tensor,
                 cfg: wgl3.DenseConfig, carry, window: int, *,
                 step0: int = 0, t0: float | None = None,
                 time_budget_s: float | None = None):
    """Sweep prepared steps (prepare_steps) window by window from `carry`
    through `sweep`, a resumable wrapper or its plain version called as
    sweep(ln, tg, cm, cfg, T, meta); yields the carry after each window.

    The windows chain on one stream without a host sync. With a time
    budget (counted from `t0`) each window ends in a synchronize, and
    BudgetExhausted is raised before a window that would start past it
    (`step0` is the first step's index in the history)."""
    T, meta = carry
    n = tg.shape[1]
    starts = range(0, n, window)
    lns = torch.tensor([min(window, n - w0) for w0 in starts],
                       dtype=torch.int32, device=tg.device)
    for i, w0 in enumerate(starts):
        if (time_budget_s is not None
                and time.monotonic() - t0 > time_budget_s):
            raise BudgetExhausted(step0 + w0, time_budget_s)
        win = slice(w0, w0 + window)
        T, meta = sweep(lns[i:i + 1], tg[:, win], cm[:, win], cfg, T, meta)
        if time_budget_s is not None and tg.device.type == "cuda":
            torch.cuda.synchronize(tg.device)
        yield T, meta


def run_chain(rs: ReturnSteps, model: Model, cfg: wgl3.DenseConfig,
              device=None, *, sparse: bool = False, upto: int | None = None,
              carry=None, time_budget_s: float | None = None):
    """Sweep rs's return steps (the first `upto` of them) in windows of
    long_window() steps through the resumable dense or sparse wrapper on
    `device` (None = cuda); returns the final carry (T, meta).

    The column masks of the whole history are prepared on the device once
    (prepare_steps) and the windows run through window_sweep. A `carry`
    resumes where its meta's offset says. The sparse sweep takes its
    live-block threshold from the density policy."""
    t0 = time.monotonic()
    dev = resolve_device(device)
    if sparse:
        plan = sparse_plan(cfg)
        if plan is None:
            raise ValueError(f"the sparse sweep is off for k_slots="
                             f"{cfg.k_slots} under the active limits")
        sweep = partial(sparse_sweep_resumable,
                        thresh_blocks=plan.thresh_blocks)
    elif global_tier(cfg):
        sweep = dense_sweep_global
    else:
        sweep = dense_sweep_resumable
    if carry is None:
        carry = start_carry(model, cfg, "cpu", sparse)
    start = int(carry[1][0, 4])
    T, meta = (x.to(dev).contiguous() for x in carry)
    n = rs.n_steps if upto is None else min(upto, rs.n_steps)
    if start >= n:
        return T, meta
    tg, cm = prepare_steps(rs, model, cfg, dev, start, n)
    for T, meta in window_sweep(sweep, tg, cm, cfg, (T, meta), long_window(),
                                step0=start, t0=t0,
                                time_budget_s=time_budget_s):
        pass
    return T, meta


def stream_chunk(carry, tabs: np.ndarray, act: np.ndarray, tgt: np.ndarray,
                 model: Model, cfg: wgl3.DenseConfig):
    """One streamed chunk of a key's return steps (stream/engine.py): the
    host arrays tabs int32[C,K,4], act bool[C,K], tgt int32[C] (-1 pads
    form a suffix) go to the carry's device, are prepared there
    (prepare_colmask) and swept from `carry` (T int32[1,S,W], meta
    int32[1,5]) by the resumable dense sweep, or by its global tier
    where the table is past 2^20 bits; returns the next carry.

    On the card the kernel updates the carry in place; on the CPU the
    plain version returns a new one. Pads leave the carry untouched: the
    sweep advances meta's step offset by the chunk's real steps only, so
    a padded chunk keeps every later dead_step where the post-hoc sweep
    puts it."""
    T, meta = carry
    dev = T.device
    x = (torch.from_numpy(np.ascontiguousarray(a)[None]).to(dev)
         for a in (tabs, act, tgt))
    ln, tg, cm = prepare_colmask(model, cfg, *x)
    sweep = dense_sweep_global if global_tier(cfg) else dense_sweep_resumable
    return sweep(ln, tg, cm, cfg, T, meta)


def long_result(meta_row) -> dict:
    """A chain's final meta -> the long sweep's result dict. The i32
    configs_explored accumulator wraps across windows; a negative final
    count saturates to 2^31 - 1, as the JAX package's long sweeps do."""
    m = [int(x) for x in meta_row]
    cfgs = m[3] if m[3] >= 0 else 2**31 - 1
    res = {"survived": m[0] == 0, "overflow": False, "dead_step": m[1],
           "max_frontier": m[2], "configs_explored": cfgs}
    res["valid"] = wgl3.verdict(res)
    return res


def _exhausted(e: BudgetExhausted) -> dict:
    return {"valid": "unknown", "survived": False, "overflow": True,
            "dead_step": -1, "max_frontier": -1, "configs_explored": -1,
            "kernel": "exhausted", "error": str(e)}


def _empty_history() -> dict:
    # The initial state trivially survives an empty history.
    return {"survived": True, "overflow": False, "dead_step": -1,
            "max_frontier": 1, "configs_explored": 0, "valid": True}


def check_steps3_long(rs: ReturnSteps, model: Model, cfg: wgl3.DenseConfig,
                      device=None, time_budget_s: float | None = None
                      ) -> dict:
    """One history of any length through the resumable dense sweep, on
    `device` (None = cuda). On budget expiry the result is the tri-state
    "unknown" with overflow set."""
    resolve_device(device)
    if rs.n_steps == 0:
        return _empty_history()
    try:
        _T, meta = run_chain(rs, model, cfg, device,
                             time_budget_s=time_budget_s)
    except BudgetExhausted as e:
        return _exhausted(e)
    return long_result(meta[0].cpu().tolist())


def check_steps3_long_sparse(rs: ReturnSteps, model: Model,
                             cfg: wgl3.DenseConfig, device=None,
                             time_budget_s: float | None = None) -> dict:
    """check_steps3_long through the sparse work-list sweep, with the
    sweep record (sweep mode and live-tile ratio over 128-word blocks)."""
    plan = sparse_plan(cfg)
    if plan is None:
        raise ValueError(f"the sparse sweep is off for k_slots="
                         f"{cfg.k_slots} under the active limits")
    dev = resolve_device(device)
    if rs.n_steps == 0:
        return _empty_history()
    try:
        _T, meta = run_chain(rs, model, cfg, dev, sparse=True,
                             time_budget_s=time_budget_s)
    except BudgetExhausted as e:
        return _exhausted(e)
    m = meta[0].cpu().tolist()
    res = long_result(m)
    res["kernel"] = ("wgl3-dense-cuda-sparse-chunked" if dev.type == "cuda"
                     else "wgl3-dense-plain-sparse-chunked")
    res["sweep"] = wgl3.sweep_summary(
        live_sum=float(max(0, m[5])), real_steps=m[7], sparse_steps=m[6],
        tiling=(wgl3.SPARSE_BLOCK_WORDS, plan.blocks))
    res["live_tile_ratio"] = res["sweep"]["live_tile_ratio"]
    return res


def run_long_dense(rs: ReturnSteps, model: Model, cfg: wgl3.DenseConfig,
                   device=None, time_budget_s: float | None = None) -> dict:
    """One dense-feasible history longer than a scan: the planned long
    sweep (plan.dispatch_long), its result in the batch schema."""
    from ..plan import dispatch_long

    one = dispatch_long(rs, model, cfg, device, time_budget_s=time_budget_s)
    one["op_count"] = rs.n_ops
    one["table_cells"] = cfg.n_states * cfg.n_masks
    return one


# -- the general path --------------------------------------------------------

def check_encoded_general(enc: EncodedHistory, model: Model,
                          f_cap: int = 256, f_cap_max: int | None = None,
                          time_budget_s: float | None = None,
                          device=None) -> dict:
    """The exact ladder for a history outside the dense budget (wide
    pending sets, huge values), on `device` (None = cuda):

      1. the resumable sort search (ops/wgl2.py), its capacity escalated
         4x per overflow up to f_cap_max;
      2. when the frontier outgrows that, or the time runs out there, the
         dense sweep under the chunked budget (dense_cell_budget_chunked,
         up to 2^26 bits: the global tier on the card), window by window
         with the remaining time;
      3. when no such table exists, the tri-state "unknown".

    One clock runs for the whole ladder. The result's "kernel" names the
    rung that decided it; an invalid verdict of the sort rung carries the
    search's death checkpoint for the witness."""
    from ..plan import dispatch_long
    from . import wgl2
    from .encode import encode_return_steps, reslot_events

    t0 = time.monotonic()
    tight = wgl2.sort_k_slots(enc)
    lim = limits()
    cfg_dense = wgl3.dense_config(model, tight, enc.max_value,
                                  budget=lim.dense_cell_budget_chunked)
    if f_cap_max is None:
        f_cap_max = 1 << 20
        if cfg_dense is not None:
            # Past cells / (K + 1) live configs a sort round sorts more
            # keys than the dense sweep touches bits: stop the ladder there.
            cells = cfg_dense.n_states * cfg_dense.n_masks
            f_cap_max = min(f_cap_max, max(f_cap, cells // (tight + 1)))

    def dense_chunked(enc):
        remaining = (None if time_budget_s is None else
                     time_budget_s - (time.monotonic() - t0))
        if remaining is not None and remaining <= 0.5:
            return {"valid": "unknown", "survived": False, "overflow": True,
                    "dead_step": -1, "max_frontier": -1,
                    "configs_explored": -1, "op_count": enc.n_ops,
                    "f_cap": cfg_dense.n_states * cfg_dense.n_masks,
                    "escalations": 0, "kernel": "exhausted",
                    "error": f"sort ladder consumed the whole "
                             f"{time_budget_s:.0f}s budget; dense-chunked "
                             f"rung not started"}
        if enc.k_slots != tight:
            enc = reslot_events(enc, tight)
        out = dispatch_long(encode_return_steps(enc, device), model,
                            cfg_dense, device, time_budget_s=remaining)
        out["op_count"] = enc.n_ops
        out["f_cap"] = cfg_dense.n_states * cfg_dense.n_masks
        out["escalations"] = 0
        return out

    try:
        out = wgl2.check_encoded_resumable(enc, model, f_cap=f_cap,
                                           f_cap_max=f_cap_max,
                                           time_budget_s=time_budget_s,
                                           keep_death_checkpoint=True,
                                           device=device)
        out["kernel"] = "wgl2-sort-resumable"
        return out
    except MemoryError as e:
        if cfg_dense is None:
            return {"valid": "unknown", "survived": False, "overflow": True,
                    "dead_step": -1, "max_frontier": -1,
                    "op_count": enc.n_ops, "f_cap": f_cap_max,
                    "escalations": -1, "kernel": "exhausted",
                    "error": str(e)}
        return dense_chunked(enc)


# First capacity of a history's ladder after the batched tiers proved
# `top` overflows: LADDER_SEED_FACTOR * top (check_batch_encoded_auto and
# the independent checker's f_cap_floor).
LADDER_SEED_FACTOR = 4

# Capacities of the batched sort tiers of a batch's general histories:
# typical frontiers are tiny, and a history that overflows runs again in
# the next tier's batch.
GENERAL_TIERS = (64, 256, 1024)


def ladder_tail(encs, model: Model, results: list, kernels: set,
                too_long: Sequence[int],
                overflow_seeds: Sequence[tuple[int, int]], device=None,
                time_budget_s: float | None = None) -> None:
    """The general histories left after the batched tiers, one ladder
    each: too-long ones from the start, tier-proven overflows from the
    capacity `seed` past every tier."""
    for i in too_long:
        one = check_encoded_general(encs[i], model, device=device,
                                    time_budget_s=time_budget_s)
        results[i] = one
        kernels.add(one["kernel"])
    for i, seed in overflow_seeds:
        one = check_encoded_general(encs[i], model, f_cap=seed,
                                    device=device,
                                    time_budget_s=time_budget_s)
        results[i] = one
        kernels.add(one["kernel"])


def _batch_general(encs, idxs, model: Model, results: list, kernels: set,
                   f_cap: int = 256, device=None
                   ) -> tuple[list[int], list[int], int]:
    """The batched pass over a batch's general histories `idxs`: the sort
    search of all of them in lockstep (ops/wgl2.check_steps_batch) at the
    capacities of GENERAL_TIERS (and `f_cap` when larger), each tier
    taking the histories the one before left "unknown". Exact results
    land in `results`; returns (overflowed, too_long, top tier):
    `overflowed` stayed unknown at every tier, `too_long` are longer than
    one scan (long_scan_max) and were not run. Launches are chunked so
    batch * f_cap * (k + 1) stays within sort_row_budget and the stacked
    slot tables within stack_element_budget."""
    from . import wgl2
    from .encode import encode_return_steps, reslot_events
    from .canon import batch_classes
    from .subsume import stacked_forever_masks

    dev = resolve_device(device)
    sub = [(i, encs[i]) for i in idxs]
    k = max(wgl2.sort_k_slots(e) for _, e in sub)
    max_value = max(e.max_value for _, e in sub)
    lim = limits()
    steps, too_long = [], []
    for i, e in sub:
        rs = encode_return_steps(reslot_events(e, k) if e.k_slots != k
                                 else e, dev)
        if rs.n_steps > lim.long_scan_max:
            too_long.append(i)
        else:
            steps.append((i, rs))
    if not steps:
        return [], too_long, GENERAL_TIERS[-1]
    r_cap = min(wgl3.step_bucket(max(1, max(s.n_steps for _, s in steps))),
                lim.long_scan_max)
    cap_max = max(GENERAL_TIERS[0], lim.sort_row_budget // (k + 1))
    tiers = sorted({min(t, cap_max) for t in (*GENERAL_TIERS, f_cap)})

    def launch(tier_steps, tier_cap):
        cfg = wgl2.make_config(model, k, tier_cap, max_value)
        chunk = max(1, min(
            lim.sort_row_budget // (tier_cap * (k + 1)),
            lim.stack_element_budget // max(1, r_cap * (k + 1))))
        overflowed = []
        for c0 in range(0, len(tier_steps), chunk):
            part = tier_steps[c0:c0 + chunk]
            tabs, act, tgt = wgl3.stack_steps3([s for _, s in part], r_cap,
                                               dev)
            forever = stacked_forever_masks([s for _, s in part], r_cap,
                                            dev)
            classes = (None if forever is None else
                       batch_classes([s for _, s in part], r_cap, dev))
            out = {name: v.cpu().tolist() for name, v in
                   wgl2.check_steps_batch(tabs, act, tgt, model, cfg,
                                          forever, classes).items()}
            for j, (i, s) in enumerate(part):
                one = {name: out[name][j] for name in out}
                v = wgl3.verdict(one)
                if v == "unknown":
                    overflowed.append((i, s))
                    continue
                results[i] = {
                    "valid": v, "survived": one["survived"],
                    "overflow": one["overflow"],
                    "dead_step": one["dead_step"],
                    "max_frontier": one["max_frontier"], "op_count": s.n_ops,
                    "f_cap": tier_cap, "escalations": 0,
                    "kernel": "wgl2-sort-batched"}
                kernels.add("wgl2-sort-batched")
        return overflowed

    remaining = steps
    for tier_cap in tiers:
        remaining = launch(remaining, tier_cap)
        if not remaining:
            break
    return [i for i, _ in remaining], too_long, tiers[-1]


# -- routing ---------------------------------------------------------------

def partition_dense(encs: Sequence[EncodedHistory], model: Model
                    ) -> tuple[list[int], list[int]]:
    """Per-history dense feasibility split: (dense_idx, general_idx)."""
    dense_idx, general_idx = [], []
    for i, e in enumerate(encs):
        ok = wgl3.dense_config(model, wgl3.tight_k_slots(e), e.max_value)
        (dense_idx if ok is not None else general_idx).append(i)
    return dense_idx, general_idx


def check_batch_encoded_auto(encs: Sequence[EncodedHistory],
                             model: Model | None = None, device=None,
                             timings: dict | None = None,
                             time_budget_s: float | None = None
                             ) -> tuple[list[dict], str]:
    """Check a batch of encoded histories on `device` (None = cuda);
    returns (per-history results, kernel name, "mixed" when the histories
    split across routes).

    The batch is partitioned by dense feasibility (partition_dense). The
    dense histories run under one shared geometry: in one launch of the
    dense sweep when their bucketed step count fits one scan
    (long_scan_max), else one at a time through the long route
    (run_long_dense, each bounded by `time_budget_s`). The others take the
    general path: the batched sort tiers (_batch_general), then a ladder
    each for what the tiers left (ladder_tail, bounded by
    `time_budget_s`).

    When `timings` is a dict, each stage of the dense half synchronizes
    the device at its end and the dict gets the stage's host-clock
    seconds under its name."""
    dev = resolve_device(device)
    if model is None:
        from ..models import CASRegister
        model = CASRegister()
    if not encs:
        return [], "none"
    t0 = time.perf_counter()

    def lap(stage: str) -> None:
        nonlocal t0
        if timings is None:
            return
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        timings[stage] = now - t0
        t0 = now

    dense_idx, general_idx = partition_dense(encs, model)
    results: list = [None] * len(encs)
    kernels: set[str] = set()
    if dense_idx:
        sub = [encs[i] for i in dense_idx]
        try:
            cfg, steps, r_cap = wgl3.batch_steps3(sub, model, device=dev)
        except ValueError:
            # Each is feasible alone but no one geometry serves them all:
            # they take the general path.
            general_idx = sorted(general_idx + dense_idx)
            dense_idx = []
        else:
            lap("batch_steps3")
            if r_cap > limits().long_scan_max:
                for i, s in zip(dense_idx, steps):
                    one = run_long_dense(s, model, cfg, dev, time_budget_s)
                    results[i] = one
                    kernels.add(one["kernel"])
                lap("long_sweep")
            else:
                tabs, act, tgt = wgl3.stack_steps3(steps, r_cap, dev)
                lap("stack_h2d")
                ln, tg, cm = prepare_colmask(model, cfg, tabs, act, tgt)
                lap("prepare_colmask")
                packed = dense_sweep(ln, tg, cm, cfg,
                                     wgl3.init_row(model, cfg))
                lap("kernel")
                batch_out = wgl3.assemble_batch_results(
                    wgl3.unpack_np(packed.cpu().numpy()), steps, cfg)
                lap("fetch_assemble")
                for i, one in zip(dense_idx, batch_out):
                    results[i] = one
                kernels.add("wgl3-dense-cuda" if dev.type == "cuda"
                            else "wgl3-dense-plain")
    if general_idx:
        overflowed, too_long, top = _batch_general(encs, general_idx, model,
                                                   results, kernels,
                                                   device=dev)
        # The tiers proved capacities up to `top` overflow for these: their
        # ladders start past every dead rung.
        ladder_tail(encs, model, results, kernels, too_long,
                    [(i, LADDER_SEED_FACTOR * top) for i in overflowed],
                    dev, time_budget_s)
    return results, (kernels.pop() if len(kernels) == 1 else "mixed")
