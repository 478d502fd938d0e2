"""The int32 ALU-peak probe: csrc/alu_peak.cu, its plain version, and the
card's measured int32 word-op rate.

The port of the JAX package's `bench.py` `_peak_microbench` (its Pallas
kernel at bench.py:125): 8 independent chains a_k = x + k per input word,
each iteration applying xor 0x9E3779B9, or with itself shifted left by
one, and 0x7FFFFFFF and add the iteration index, then the OR of the
chains. Its word-ops, ITERS * 8 * 5 per word, over the device seconds are
the yardstick that chip_smoke.py divides the sweep kernels' int32
operations by (`bound_measured_ms`), beside the data-sheet rate.

Nothing here writes a file: the probe takes milliseconds and runs anew
wherever it is needed.
"""

from __future__ import annotations

import ctypes

import torch

from ..device import resolve_device

# bench.py's iteration count, chains per word and word-ops per chain and
# iteration (xor, shift, or, and, add).
ITERS = 200_000
CHAINS = 8
OPS = 5
# Threads (words) per SM of a launch that fills the card: one 1024-thread
# block on each SM.
THREADS_PER_SM = 1024

_XOR = 0x9E3779B9
_AND = 0x7FFFFFFF
_MASK32 = 0xFFFFFFFF

# Kernel launches since the last reset: alu_peak adds one where it launches
# csrc/alu_peak.cu and nowhere else.
launches = {"alu_peak": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
# x, out, n, iters, stream
_ARGTYPES = [_P, _P, _I, _I, _P]


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def word_ops(n: int, iters: int) -> int:
    """Word-ops of one probe over n words, counted as bench.py counts
    them: iters * 8 chains * 5 ops * n."""
    return iters * CHAINS * OPS * n


def probe_input(n: int, device) -> torch.Tensor:
    """The probe's input words, 0..n-1 as bench.py's arange (uint32 bit
    patterns in an int32 tensor) on `device`."""
    return torch.arange(n, dtype=torch.int32, device=device)


def alu_peak_reference(x: torch.Tensor, iters: int) -> torch.Tensor:
    """The probe's plain version on x's device: x int32[n] (uint32 bit
    patterns) -> int32[n]. The same arithmetic in int64 masked to 32 bits
    (torch has no uint32 shifts)."""
    a = (x.long() & _MASK32)[None, :] + torch.arange(
        CHAINS, dtype=torch.int64, device=x.device)[:, None]
    a &= _MASK32
    # After the and, a < 2^31, and i < 2^31: the add never passes 2^32,
    # so the loop needs no mask of its own.
    for i in range(iters):
        a ^= _XOR
        a |= a << 1
        a &= _AND
        a += i
    acc = a[0]
    for k in range(1, CHAINS):
        acc = acc | a[k]
    return torch.where(acc >= 2**31, acc - 2**32, acc).to(torch.int32)


def _run(x: torch.Tensor, iters: int) -> torch.Tensor:
    """csrc/alu_peak.cu over x int32[n] on x's card, or the plain version
    when x lies on the CPU."""
    if x.dtype != torch.int32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError("the probe takes a contiguous int32[n] input")
    if iters < 0:
        raise ValueError(f"iters must be >= 0; got {iters}")
    if x.device.type == "cpu":
        return alu_peak_reference(x, iters)
    from . import build

    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        build.launcher("alu_peak", _ARGTYPES)(
            x.data_ptr(), out.data_ptr(), x.numel(), iters,
            torch.cuda.current_stream(x.device).cuda_stream)
    launches["alu_peak"] += 1
    return out


def alu_peak(n: int, iters: int = ITERS, device=None):
    """The probe over n words on `device` (None = cuda): (out int32[n],
    its word-ops). On the card it launches csrc/alu_peak.cu; with
    device='cpu' it runs the plain version."""
    dev = resolve_device(device)
    return _run(probe_input(n, dev), iters), word_ops(n, iters)


def measure_peak(device=None, iters: int = ITERS, reps: int = 3) -> dict:
    """The card's int32 word-op rate, timed with CUDA events: the probe
    over THREADS_PER_SM words per SM (the whole card), then over one SM's
    words (one block, one SM). Each is the mean of `reps` launches after a
    warm-up. A measurement needs the card: device='cpu' raises."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("measure_peak times the card; there is no CPU "
                         "measurement")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    res = {"sms": sms, "threads_per_sm": THREADS_PER_SM, "iters": iters}
    for name, n in (("card", sms * THREADS_PER_SM), ("sm", THREADS_PER_SM)):
        x = probe_input(n, dev)
        _run(x, iters)
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            out = _run(x, iters)
        end.record()
        torch.cuda.synchronize(dev)
        ms = start.elapsed_time(end) / reps
        res[f"{name}_ms"] = ms
        res[f"{name}_word_ops"] = word_ops(n, iters)
        res[f"{name}_word_ops_per_s"] = word_ops(n, iters) / (ms / 1e3)
        res[f"{name}_out"] = out
    return res
