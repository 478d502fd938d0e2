"""The dense sweep on the card: column-mask prep, the CUDA kernel's
wrapper, and the route that sends a batch of encoded histories to it.

`dense_sweep` is the wrapper of csrc/wgl3_sweep.cu, the one kernel that
replaces the JAX package's two Pallas sweeps (per-history and grouped).
For CUDA tensors it launches the kernel or raises; for CPU tensors it runs
the kernel's plain PyTorch version (ops/wgl3.sweep_plain), the only reason
being that the tensors lie on the host.
"""

from __future__ import annotations

import ctypes
import time
from typing import Sequence

import torch

from ..device import resolve_device
from ..models.base import Model
from . import wgl3
from .encode import EncodedHistory
from .limits import limits

# Kernel launches since the last reset (the wrapper adds one per launch and
# nowhere else); chip_smoke.py reads it to show the main path ran on the
# kernel.
launches = 0

_LIB = None


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
    """The kernel's plain PyTorch version, on the inputs' device."""
    del ln  # implied by the -1 pads of tg
    return wgl3.sweep_plain(colmask_transitions(cm), tg, cfg, row0)


def check_geometry(cfg: wgl3.DenseConfig) -> None:
    """Raise on a geometry the kernel does not take: K >= 5, S <= 32 and a
    table of at most 2^20 bits (128 KiB of shared memory)."""
    K, S = cfg.k_slots, cfg.n_states
    if K < 5 or S < 1 or S > 32 or S * (1 << K) > (1 << 20):
        raise ValueError(
            f"wgl3_sweep takes 5 <= K, S <= 32 and S * 2^K <= 2^20; got "
            f"K={K}, S={S}")
    wgl3._require_converging_cap(cfg)


def _lib():
    global _LIB
    if _LIB is None:
        from . import build

        lib = build.load("wgl3_sweep")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.wgl3_sweep_launch.argtypes = [p, p, p, p, i, i, i, i, i, p]
        lib.wgl3_sweep_launch.restype = i
        lib.wgl3_sweep_error_string.argtypes = [i]
        lib.wgl3_sweep_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def dense_sweep(ln: torch.Tensor, tg: torch.Tensor, cm: torch.Tensor,
                cfg: wgl3.DenseConfig, row0: int) -> torch.Tensor:
    """Run the dense sweep: ln int32[B], tg int32[B,R], cm int32[B,R,S,K]
    -> int32[B, 5] in wgl3.PACKED_FIELDS order.

    On CUDA tensors this launches csrc/wgl3_sweep.cu on the current stream
    (it raises on anything the kernel does not take); on CPU tensors it
    runs the plain version."""
    global launches
    check_geometry(cfg)
    B, R = tg.shape
    if tuple(cm.shape) != (B, R, cfg.n_states, cfg.k_slots) \
            or tuple(ln.shape) != (B,):
        raise ValueError(
            f"shape mismatch: ln {tuple(ln.shape)}, tg {tuple(tg.shape)}, "
            f"cm {tuple(cm.shape)} for K={cfg.k_slots}, S={cfg.n_states}")
    if not 0 <= row0 < cfg.n_states:
        raise ValueError(f"initial row {row0} outside S={cfg.n_states}")
    devs = {x.device.type for x in (ln, tg, cm)}
    if devs == {"cpu"}:
        return sweep_reference(ln, tg, cm, cfg, row0)
    if devs != {"cuda"} or len({x.device for x in (ln, tg, cm)}) != 1:
        raise ValueError(f"ln, tg and cm must lie on one CUDA device or "
                         f"all on the CPU; got {[x.device for x in (ln, tg, cm)]}")
    for name, x in (("ln", ln), ("tg", tg), ("cm", cm)):
        if x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor")
    lib = _lib()
    out = torch.empty((B, 5), dtype=torch.int32, device=cm.device)
    stream = torch.cuda.current_stream(cm.device).cuda_stream
    with torch.cuda.device(cm.device):
        rc = lib.wgl3_sweep_launch(ln.data_ptr(), tg.data_ptr(),
                                   cm.data_ptr(), out.data_ptr(), B, R,
                                   cfg.n_states, cfg.k_slots, row0, stream)
    if rc != 0:
        raise RuntimeError(
            f"wgl3_sweep launch failed: "
            f"{lib.wgl3_sweep_error_string(rc).decode()} (code {rc})")
    launches += 1
    return out


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
                             timings: dict | None = None
                             ) -> tuple[list[dict], str]:
    """Check a batch of encoded histories in one launch of the dense sweep
    on `device` (None = cuda); returns (per-history results, kernel name).

    Histories outside this slice raise NotImplementedError: those that are
    not dense-feasible (the sort-ladder general path, ROADMAP A-5) and
    those longer than one scan (the resumable sweep, ROADMAP A-4).

    When `timings` is a dict, each stage synchronizes the device at its
    end and the dict gets the stage's host-clock seconds under its name."""
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

    _dense_idx, general_idx = partition_dense(encs, model)
    if general_idx:
        raise NotImplementedError(
            f"{len(general_idx)} histories are not dense-feasible (more "
            f"pending ops or larger values than a 2^20-cell table holds); "
            f"the sort-ladder general path is ROADMAP A-5")
    try:
        cfg, steps, r_cap = wgl3.batch_steps3(encs, model)
    except ValueError as e:
        raise NotImplementedError(
            f"no shared dense geometry for this batch ({e}); the "
            f"sort-ladder general path is ROADMAP A-5") from e
    if r_cap > limits().long_scan_max:
        raise NotImplementedError(
            f"{r_cap} return steps exceed one scan (long_scan_max="
            f"{limits().long_scan_max}); the resumable sweep is ROADMAP A-4")
    lap("batch_steps3")
    tabs, act, tgt = wgl3.stack_steps3(steps, r_cap, dev)
    lap("stack_h2d")
    ln, tg, cm = prepare_colmask(model, cfg, tabs, act, tgt)
    lap("prepare_colmask")
    packed = dense_sweep(ln, tg, cm, cfg, wgl3.init_row(model, cfg))
    lap("kernel")
    results = wgl3.assemble_batch_results(
        wgl3.unpack_np(packed.cpu().numpy()), steps, cfg)
    lap("fetch_assemble")
    return results, ("wgl3-dense-cuda" if dev.type == "cuda"
                     else "wgl3-dense-plain")
