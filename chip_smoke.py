"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase, one card
    python3 chip_smoke.py --phases kernel  # a subset, for debugging
    python3 chip_smoke.py --phases cluster # the real-cluster path alone
    python3 chip_smoke.py --phases serve   # checking as a service alone

Drives the port's main paths through the entry points a user calls, on
the card. The register linearizability check, at the sizes of the JAX
package's baseline and long-history lanes: a 1024-history corpus of
150-op histories at concurrency 10, one 10k-op history, the 100k-op
history of the `bench_long` recipe (68,734 return steps, five windows of
the resumable sweep) and an invalid mutant of it, a 50k-op history at
concurrency 16 and a 50k-op history whose frontier spans two of its 16
blocks, each through the sparse work-list sweep and the dense one, and
10 independent keys of 1000 ops. The general path for histories no
default dense table holds: the sweep's global tier (tables split over
thread-block clusters) against its plain version at every size it takes,
2^21 to 2^26 bits, then
partitioned histories (1000 and 10,000 ops with indeterminate ops piling
up, 7,000 ops of huge values, an invalid mutant with its
sort-checkpoint witness, 10 keys split between the dense launch and the
sort tiers). First it measures the card's int32 ALU
peak with the port of bench.py's probe (csrc/alu_peak.cu), the yardstick
beside the data-sheet rate. The elle list-append check: the JAX
package's elle lane (10k txns) under the dense, auto and tiled routes,
and a 12,000-txn history in the shape of Jepsen's append generator whose
one big dependency component takes the tiled closure and its accumulate
kernel, and a mutant with a ww cycle in that component certified against
the host Tarjan route. The other models: 10,000-op gset histories on
the sweep's register and shared routes at 32 states, 1,000-op mutex and
multi-register histories, the queue workload (100 keys x 20 ops) and an
unordered-queue history of 31 enqueues, each valid and mutated; the
device encoder bit-identical to the host expansion; `cli analyze` on
every workload. Last, whole Jepsen tests through `cli test --fake`, the
reference's `lein run test -w register`: the tutorial default (30 s at
10 Hz under partitions) and about 10,000 ops over ~100 keys, each checked
on the card through the batched dense sweep, stale reads, and every other
workload healthy and with injected faults, each run directory re-checked
by `analyze` on the host. Then the streaming check (`--check-mode
stream`): the 100k-op history and its mutant fed op by op into a
session, the JAX package's streaming lane, keys on the shared route and
the global tier, each against the post-hoc check, and whole tests in
stream mode and with --fail-fast. Then phase `cluster`, the real-cluster
path, `cli test` without --fake: etcd installed and started over SSH on
a "node" that is this host (minietcd, db/minietcd.py, in etcd's place;
ssh, scp and sshpass stand-ins; an apt-get stand-in that installs
nothing), the register workload at 200 Hz under (c1) no fault, with
password auth, (c2) kill -9 and restart, (c3) SIGSTOP and SIGCONT, and
(c4) two co-hosted members that do not replicate, which the check must
find invalid; each checked on the card, re-checked by `analyze --device
cpu`, (c1) and (c4) also by `analyze --backend oracle`. Phase `serve`
(between replay and stream) is checking as a service: `cli serve
--check` as a subprocess on
the card, 8 tenants on 8 threads each POSTing 128 corpus-shaped
histories of 150 ops (every 16th a mutant), a 10k-op history submitted
without waiting and polled, a streaming session fed that history in
1,000-op POSTs and a keyed one of 10 keys x 1,000 ops; every verdict
against this process's own check, the daemon healthy with no failed
batch, every verdict a run in its store, and its launches by
route read from /serve/stats. It builds the
CUDA kernels from csrc/ (one nvcc per source, side by side), holds each
exactly equal to its plain PyTorch version on the card, checks verdicts
against the host oracle, the whole-scan kernel and the other routes, and
shows through the launch counters that each main path ran on its
kernel.

Output: one JSON line per phase; then the card's name and power limit as
nvidia-smi reports them; then one JSON line describing each kernel (a
record whose bound counts int32 operations also gives `bound_measured_ms`,
the same operations over the measured peak; a record of the register
route gives `slot_table_ms`, its time with the step's slot table in
registers and read from the step ring); and last {"ok": true,
"device": {...}}. Any failure raises and exits nonzero.
Without a CUDA device it prints no result and exits 1.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import functools
import json
import os
import random
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple

import torch

ROOT = Path(__file__).resolve().parent
PHASES = ("peak", "kernel", "long_kernel", "general_kernel", "elle_kernel",
          "corpus", "single", "long", "sparse", "independent", "general",
          "families", "encode", "elle", "cli", "test", "replay", "serve",
          "stream", "cluster")
LIBS = ("alu_peak", "wgl3_sweep", "wgl3_sparse", "elle_accumulate")
CSRC = "jepsen_etcd_demo_tpu_torch/csrc"
PALLAS = "jepsen_etcd_demo_tpu/ops/wgl3_pallas.py"
# record name -> (source, TPU kernel it replaces)
KERNELS = {"alu_peak": (f"{CSRC}/alu_peak.cu", "bench.py:125"),
           "wgl3_sweep[corpus]": (f"{CSRC}/wgl3_sweep.cu", f"{PALLAS}:1132"),
           "wgl3_sweep[replay]": (f"{CSRC}/wgl3_sweep.cu", f"{PALLAS}:1132"),
           "wgl3_sweep[single]": (f"{CSRC}/wgl3_sweep.cu", f"{PALLAS}:169"),
           "wgl3_sweep[resume]": (f"{CSRC}/wgl3_sweep.cu", f"{PALLAS}:366"),
           "wgl3_sweep[resume,shared]": (f"{CSRC}/wgl3_sweep.cu",
                                         f"{PALLAS}:366"),
           "wgl3_sweep[global]": (f"{CSRC}/wgl3_sweep.cu", f"{PALLAS}:366"),
           "wgl3_sparse": (f"{CSRC}/wgl3_sparse.cu", f"{PALLAS}:610"),
           "wgl3_sparse[few-block]": (f"{CSRC}/wgl3_sparse.cu",
                                      f"{PALLAS}:610"),
           "elle_accumulate": (f"{CSRC}/elle_accumulate.cu",
                               "jepsen_etcd_demo_tpu/ops/cycles_tiled.py:211")}
# The general path's histories (cas-register, 10 processes, values 0-4
# unless said): (a) one partitioned key of 1000 ops (BASELINE.json
# configs[1]) with at least 10 indeterminate ops and a tight K of 17-20,
# the first seed from GENERAL_SEED that has them; (b) 10,000 ops at p_info
# 0.001, seed 1 (configs[3] under partitions), under a 240 s budget; (c)
# 7,000 ops writing values 0..99,999 (unpacked sort keys at its K=16);
# (d) invalid mutants of (a); (e) 10 keys x 1000 ops (configs[2]), keys
# 8-9 past the dense budget (one settles on the global tier, one on the
# sort tiers).
GENERAL_OPS, GENERAL_P_INFO, GENERAL_SEED = 1_000, 0.016, 0x6E0
STRESS_OPS, STRESS_P_INFO, STRESS_SEED, STRESS_BUDGET_S = 10_000, 0.001, 1, 240
HUGE_OPS, HUGE_VALUES, HUGE_SEED = 7_000, 100_000, 0xC0
# Geometries (S, K) of the global tier's check: every size it takes,
# 2^21 to 2^26 bits.
GLOBAL_GEOMS = ((8, 18), (8, 19), (8, 20), (8, 21), (8, 22), (8, 23))
# (d)'s mutant dies within WITNESS_LAG steps past a sort chunk boundary,
# so its witness replays a short window from the sort checkpoint.
WITNESS_LAG = 4
# Sizes of the long paths (the bench_long recipe and the sparse lane).
LONG_OPS, SPARSE_OPS = 100_000, 50_000
LONG_DEAD_AFTER = 40_000     # the long mutant dies past this return step
# Steps of the 100k history's first window over which phase `long` holds
# the resumable dense kernel against its plain version (a quarter of a
# full window: the plain run sets the time).
LONG_CHECK_STEPS = 4096
# Steps of the 50k history's first window over which phase `sparse` holds
# the sparse kernel and the dense shared-memory route against their plain
# versions (an eighth of a full window: the plain runs set the time).
SPARSE_CHECK_STEPS = 2048
# The few-block history (phase sparse): its ops, its timed steps, and its
# timed steps re-slotted to K=17.
FEW_OPS, FEW_CHECK_STEPS, FEW_K17_STEPS = 50_000, 1024, 256
# The elle pool history: one weak component of ~12,000 txns, past
# elle_dense_max_nodes, so the auto route takes the tiled closure.
POOL_TXNS, POOL_SEED = 12_000, 0xA11E
# Its certified mutant: the first mutate_append_txns seed from 0xBAD whose
# mutant has a ww cycle (a duplicated element in a key's longest read).
POOL_MUTANT_SEED = 0xBCB
# H100 SXM data-sheet rates: HBM3 at 3.35 TB/s; int32 issue = the 67
# TFLOP/s float32 rate (FMA = 2 ops, 128 lanes per SM) over 4, since an SM
# has 64 int32 lanes and an integer op counts once.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
# Dense int8 tensor-core rate of the H100 SXM data sheet.
INT8_OPS_PER_S = 1979e12
# Iterations of the probe's exactness check against its plain version at
# the card's full width (the timed run uses bench.py's 200,000).
PEAK_CHECK_ITERS = 300


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi(query: str = "name,power.limit") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def issue_rate(sms: int) -> tuple[float, float]:
    """(thread-instructions per second the card can issue at its maximum
    SM clock: one warp instruction per clock on each of an SM's 4
    schedulers, the clock in MHz) from nvidia-smi."""
    mhz = float(smi("clocks.max.sm").split()[0])
    return sms * 4 * 32 * mhz * 1e6, mhz


def cuda_ms(fn, reps: int, warm: bool = True):
    """(mean device milliseconds of fn() over reps, last result), timed
    with CUDA events after one warm-up call when `warm`."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def popcount32(x):
    """Set bits of each uint32 of a numpy array (SWAR)."""
    x = x.astype("uint64")
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


class Bound(NamedTuple):
    """A kernel's least time on this card: `ms`, the larger of `bytes_ms`
    (bytes over the HBM rate) and its operations over their data-sheet
    rate; `by` names the larger. `int32_ops` is the int32 operations
    counted, or None when the operations are not on the int32 rate."""
    ms: float
    by: str
    bytes_ms: float
    int32_ops: float | None

    @staticmethod
    def of(t_ops: float, t_bytes: float, int32_ops=None) -> "Bound":
        if t_ops >= t_bytes:
            return Bound(t_ops, "operations", t_bytes, int32_ops)
        return Bound(t_bytes, "bytes", t_bytes, int32_ops)

    def measured_ms(self, peak_ops_per_s: float | None) -> float | None:
        """The same bound with the int32 operations over the measured
        peak in place of the data-sheet rate (None without either)."""
        if self.int32_ops is None or not peak_ops_per_s:
            return None
        return max(self.bytes_ms, self.int32_ops / peak_ops_per_s * 1e3)


def bound(cfg, inputs, dead_step, launches: int = 1, carry: bool = False,
          live_frac: float = 1.0) -> Bound:
    """Least time for the sweep's work on this card, counted from this
    run's data. Only the steps each history needs (up to its death) count;
    each reads its column masks and target once. Its closure is at least
    one sweep, in which each nonzero column mask cm[b,r,d,j] with m bits
    costs m+1 int32 operations (m gathering ORs, one fused AND/OR merge)
    on each word slot j may fire from: W words for j < 5, the W/2 source
    words for j >= 5, half of either when the target t >= 5 banks the
    words with bit t set (not for j == t, whose sources all have it
    clear). Each step adds a popcount pass (popc and add) and a prune pass
    over the S*W words. For the sparse sweep the closure's words are cut
    to the live share of the blocks (`live_frac`, from its telemetry). A
    carried table is read and written once per launch. The larger of
    bytes over the HBM rate and int32 operations over the card's int32
    rate."""
    import numpy as np

    S, K, W = cfg.n_states, cfg.k_slots, cfg.n_words
    ln, tg, cm = (x.cpu().numpy() for x in inputs)
    dead = np.asarray(dead_step, dtype=np.int64)
    need = np.where(dead >= 0, dead + 1, ln.astype(np.int64))     # [B]
    live = np.arange(tg.shape[1])[None, :] < need[:, None]        # [B,R]
    t = np.where(live, tg, 0).astype(np.int64)[:, :, None]        # [B,R,1]
    j = np.arange(K)[None, None, :]                               # [1,1,K]
    words = np.where(j < 5, W, W // 2)
    words = np.where((t >= 5) & (j != t), words // 2, words)      # [B,R,K]
    bits = popcount32(cm.view(np.uint32))                         # [B,R,S,K]
    per_mask = np.where(bits > 0, bits + 1, 0).sum(axis=2)        # [B,R,K]
    sweep = (per_mask * words).sum(axis=2)                        # [B,R]
    steps = int(live.sum())
    ops = int(sweep[live].sum()) * live_frac + steps * 3 * S * W
    b = len(ln)
    nbytes = steps * (S * K + 1) * 4 + b * 4 + b * 5 * 4
    if carry:
        nbytes += launches * b * 2 * (S * W + 8) * 4
    return Bound.of(ops / INT32_OPS_PER_S * 1e3,
                    nbytes / HBM_BYTES_PER_S * 1e3, ops)


def prepared(encs, model, dev):
    from jepsen_etcd_demo_tpu_torch.ops import wgl3, wgl3_kernels as wk

    cfg, steps, r_cap = wgl3.batch_steps3(encs, model)
    arrays = wgl3.stack_steps3(steps, r_cap, dev)
    return cfg, wk.prepare_colmask(model, cfg, *arrays)


def record(name, launches, err, ms, plain_ms, b: Bound) -> dict:
    """A kernels-line record (without bound_measured_ms, which main()
    adds from the record's Bound once the peak is known)."""
    source, replaces = KERNELS[name]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b.ms,
            "bound_by": b.by, "library_ms": None}


def kernels_line(kernels, peak_ops_per_s) -> list[dict]:
    """The kernels line from (record, Bound) pairs: each record with its
    bound_measured_ms (the int32 operations over the measured peak)."""
    return [{**rec, "bound_measured_ms": b.measured_ms(peak_ops_per_s)}
            for rec, b in kernels]


def register_route(cfg) -> bool:
    """Whether csrc/wgl3_sweep.cu's launcher keeps cfg's table in one
    warp's registers (its wgl3_sweep_register_route), else in shared
    memory."""
    from jepsen_etcd_demo_tpu_torch.ops import build

    fn = build.load("wgl3_sweep").wgl3_sweep_register_route
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return bool(fn(cfg.n_states, cfg.k_slots))


def slot_table_ms(run, want, reps) -> dict:
    """{slot table: device ms} of run(slot_table) for each forced slot
    table of the register route, each result exactly equal to `want` (the
    plain version's); timing launches, made after the main path's counts
    were read."""
    out = {}
    for where in ("registers", "ring"):
        ms, got = cuda_ms(lambda: run(where), reps)
        got = got if isinstance(got, tuple) else (got,)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), where
        out[where] = ms
    return out


def kernel_record(name, cfg, inputs, row0, launches, reps):
    """Whole-scan kernel vs plain on the card (exact), times and bound:
    (record, Bound)."""
    from jepsen_etcd_demo_tpu_torch.ops import wgl3_kernels as wk

    ln, tg, cm = inputs
    ms, got = cuda_ms(lambda: wk.dense_sweep(ln, tg, cm, cfg, row0), reps)
    # The plain version has nothing to compile: its one timed run is also
    # the run the kernel is held against.
    plain_ms, want = cuda_ms(
        lambda: wk.sweep_reference(ln, tg, cm, cfg, row0), 1, warm=False)
    err = int((got.long() - want.long()).abs().max().item())
    assert err == 0, f"{name}: kernel and plain version differ by {err}"
    b = bound(cfg, inputs, got[:, 2].cpu().numpy())
    rec = record(name, launches, err, ms, plain_ms, b)
    if register_route(cfg):
        rec["slot_table_ms"] = slot_table_ms(lambda where: wk.dense_sweep(
            ln, tg, cm, cfg, row0, slot_table=where), (want,), reps)
    return rec, b


def sweeps(sparse: bool, thresh: int = 0):
    """(kernel wrapper, plain version) of the resumable dense or sparse
    sweep, as the route's window loop (wk.window_sweep) calls them."""
    from functools import partial

    from jepsen_etcd_demo_tpu_torch.ops import wgl3_kernels as wk

    if sparse:
        return (partial(wk.sparse_sweep_resumable, thresh_blocks=thresh),
                partial(wk.sparse_reference, thresh_blocks=thresh))
    return wk.dense_sweep_resumable, wk.resumable_reference


def last(chain):
    out = None
    for out in chain:
        pass
    return out


def window_record(name, model, cfg, rs, dev, sparse, thresh, launches,
                  reps, window: int | None = None):
    """The first window of the long route (`window` steps of rs, by
    default a full long_window()) through the resumable kernel and its
    plain version on the card, from a fresh carry: exactly equal table and
    meta; times and bound: (record, Bound)."""
    from jepsen_etcd_demo_tpu_torch.ops import wgl3_kernels as wk

    window = window or wk.long_window()
    tg, cm = wk.prepare_steps(rs, model, cfg, dev, 0, window)
    T0, m0 = wk.start_carry(model, cfg, dev, sparse)
    kernel, plain = sweeps(sparse, thresh)

    def run(sweep):
        return last(wk.window_sweep(sweep, tg, cm, cfg,
                                    (T0.clone(), m0.clone()), window))

    ms, (Tk, mk) = cuda_ms(lambda: run(kernel), reps)
    # One timed run of the plain version, also the one the kernel is held
    # against.
    plain_ms, (Tp, mp) = cuda_ms(lambda: run(plain), 1, warm=False)
    err = max(int((Tk.long() - Tp.long()).abs().max().item()),
              int((mk.long() - mp.long()).abs().max().item()))
    assert err == 0, f"{name}: kernel and plain version differ by {err}"
    m = mk[0].tolist()
    live_frac = m[5] / max(1, m[7] * cfg.n_words // 128) if sparse else 1.0
    ln = torch.tensor([tg.shape[1]], dtype=torch.int32, device=tg.device)
    b = bound(cfg, (ln, tg, cm), [m[1]], 1, True, live_frac)
    rec = record(name, launches, err, ms, plain_ms, b)
    if not sparse and register_route(cfg):
        rec["slot_table_ms"] = slot_table_ms(lambda where: run(
            functools.partial(wk.dense_sweep_resumable, slot_table=where)),
            (Tp, mp), reps)
    return rec, b


def sass_text(name: str) -> str:
    """cuobjdump -sass of the built library of csrc/<name>.cu (cuobjdump
    from nvcc's toolkit)."""
    from jepsen_etcd_demo_tpu_torch.ops import build

    tool = Path(build.nvcc()).with_name("cuobjdump")
    return subprocess.run([str(tool), "-sass", str(build.library_path(name))],
                          capture_output=True, text=True,
                          check=True).stdout


_SASS_LINE = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def sass_loop(sass: str, function: str, unroll: int) -> dict:
    """The hot loop of the function whose (mangled) name contains
    `function`, in cuobjdump -sass text: the largest body between a
    backward branch and its target. Returns its SASS instructions per
    source iteration (body / unroll) and the opcodes' counts per
    iteration (the base opcode, before the first dot). Raises when the
    function or a backward branch is missing."""
    lines, inside = [], False
    for ln in sass.splitlines():
        if "Function :" in ln:
            inside = function in ln.split("Function :")[1]
            continue
        if inside:
            m = _SASS_LINE.search(ln)
            if m:
                lines.append((int(m.group(1), 16), m.group(3), m.group(4)))
    if not lines:
        raise ValueError(f"no SASS for function {function}")
    best = None
    for addr, op, args in lines:
        if op.split(".")[0] != "BRA":
            continue
        tgt = re.search(r"0x([0-9a-f]+)", args)
        if tgt is None or int(tgt.group(1), 16) >= addr:
            continue
        lo = int(tgt.group(1), 16)
        body = [o for a, o, _ in lines if lo <= a <= addr]
        if best is None or len(body) > len(best):
            best = body
    if best is None:
        raise ValueError(f"no backward branch in {function}")
    opcodes: dict[str, float] = {}
    for op in best:
        base = op.split(".")[0]
        opcodes[base] = opcodes.get(base, 0) + 1 / unroll
    return {"body_instructions": len(best), "unroll": unroll,
            "per_iteration": len(best) / unroll,
            "opcodes_per_iteration": dict(sorted(opcodes.items()))}


def probe_bound(instructions: float, issue_per_s: float,
                nbytes: int) -> Bound:
    """The probe's least time: its SASS instructions over the card's
    issue rate (the probe is the int32 yardstick itself, so its bound is
    not on that rate and has no bound_measured_ms), or its bytes over the
    HBM rate; the larger."""
    return Bound.of(instructions / issue_per_s * 1e3,
                    nbytes / HBM_BYTES_PER_S * 1e3)


def phase_peak(dev, kernels, peak) -> None:
    """The int32 ALU-peak probe (the port of bench.py's, kernel body at
    bench.py:125): timed at bench.py's 200,000 iterations over the whole
    card and over one SM; held exactly against its plain version at a few
    hundred iterations and, timed once, at the full count; its loop's
    SASS read back from the built library, so the word-op rate (counted as
    bench.py counts it) stands beside the instruction rate, and its bound
    is its instructions over the issue rate."""
    from jepsen_etcd_demo_tpu_torch.ops import build, peak as pk

    pk.reset_launches()
    got = pk.measure_peak(dev)
    n_launch = pk.launches["alu_peak"]
    assert n_launch > 0, "the probe did not launch its kernel"
    n = got["sms"] * pk.THREADS_PER_SM
    small, _ops = pk.alu_peak(n, PEAK_CHECK_ITERS, dev)
    want = pk.alu_peak_reference(pk.probe_input(n, dev), PEAK_CHECK_ITERS)
    torch.cuda.synchronize()
    assert torch.equal(small, want), "probe and plain version differ"
    # One timed run of the plain version at the full count, also the run
    # the timed kernel's output is held against.
    plain_ms, plain = cuda_ms(lambda: pk.alu_peak_reference(
        pk.probe_input(n, dev), pk.ITERS), 1, warm=False)
    err = int((got["card_out"].long() - plain.long()).abs().max().item())
    assert err == 0, f"alu_peak: kernel and plain version differ by {err}"

    unroll = build.load("alu_peak").alu_peak_unroll
    unroll.restype = ctypes.c_int
    loop = sass_loop(sass_text("alu_peak"), "alu_peak_kernel", unroll())
    # Unmerged chains take at least 3 instructions each an iteration (the
    # xor, the shift-or-and, the add can fuse no further).
    assert loop["per_iteration"] >= 3 * pk.CHAINS, loop
    word_ops_per_iter = pk.CHAINS * pk.OPS
    instr = {k: got[f"{k}_word_ops_per_s"] * loop["per_iteration"]
             / word_ops_per_iter for k in ("card", "sm")}
    issue, mhz = issue_rate(got["sms"])
    assert instr["card"] <= issue, (instr, issue)
    peak.update(card=got["card_word_ops_per_s"], sm=got["sm_word_ops_per_s"])
    b = probe_bound(loop["per_iteration"] * pk.ITERS * n, issue, 2 * n * 4)
    kernels.append((record("alu_peak", n_launch, err, got["card_ms"],
                           plain_ms, b), b))
    emit({"phase": "peak", "ok": True, "sms": got["sms"],
          "threads_per_sm": got["threads_per_sm"], "iters": got["iters"],
          "card_ms": got["card_ms"], "sm_ms": got["sm_ms"],
          "card_word_ops_per_s": got["card_word_ops_per_s"],
          "sm_word_ops_per_s": got["sm_word_ops_per_s"],
          "spec_int32_ops_per_s": INT32_OPS_PER_S,
          "card_word_ops_pct_of_spec":
              100 * got["card_word_ops_per_s"] / INT32_OPS_PER_S,
          "sass_per_iteration": loop["per_iteration"],
          "word_ops_per_iteration": word_ops_per_iter,
          "sass_opcodes_per_iteration": loop["opcodes_per_iteration"],
          "card_sass_instr_per_s": instr["card"],
          "sm_sass_instr_per_s": instr["sm"],
          "max_sm_clock_mhz": mhz, "issue_instr_per_s": issue,
          "card_sass_instr_pct_of_issue": 100 * instr["card"] / issue,
          "bound_ms": b.ms, "bound_pct_of_ms": 100 * b.ms / got["card_ms"],
          "launches": n_launch, "check_iters": PEAK_CHECK_ITERS,
          "plain_ms": plain_ms})


def phase_kernel(dev) -> None:
    """The whole-scan kernel against its plain version on the card, over
    every geometry class dense_config admits, ragged batches with pads."""
    from jepsen_etcd_demo_tpu_torch.models import CASRegister
    from jepsen_etcd_demo_tpu_torch.ops import wgl3, wgl3_kernels as wk
    from jepsen_etcd_demo_tpu_torch.ops.encode import (
        encode_register_history, encode_return_steps)
    from jepsen_etcd_demo_tpu_torch.utils.fuzz import (gen_register_history,
                                                       mutate_history)

    model = CASRegister()
    geoms = [(4, 5), (4, 12), (4, 18), (8, 6), (8, 12), (8, 17), (16, 8),
             (16, 16), (32, 10), (32, 15)]
    rows = []
    for S, K in geoms:
        cfg = wgl3.DenseConfig(k_slots=K, n_states=S,
                               state_offset=model.state_offset)
        rng = random.Random(S * 100 + K)
        n_max = 60 if K >= 15 else 120
        steps = [encode_return_steps(encode_register_history([], k_slots=K))]
        for i in range(5):
            h = gen_register_history(rng, n_ops=n_max * (i + 2) // 6,
                                     n_procs=min(K, 12) if i % 2 else K,
                                     value_range=S - 1, p_info=0.0)
            if i in (1, 3):
                h = mutate_history(rng, h, value_range=S - 1)
            steps.append(encode_return_steps(
                encode_register_history(h, k_slots=K)))
        r_cap = wgl3.step_bucket(max(s.n_steps for s in steps))
        arrays = wgl3.stack_steps3(steps, r_cap, dev)
        ln, tg, cm = wk.prepare_colmask(model, cfg, *arrays)
        row0 = wgl3.init_row(model, cfg)
        got = wk.dense_sweep(ln, tg, cm, cfg, row0)
        want = wk.sweep_reference(ln, tg, cm, cfg, row0)
        ring = wk.dense_sweep(ln, tg, cm, cfg, row0, slot_table="ring")
        torch.cuda.synchronize()
        assert torch.equal(got, want), (S, K, got.tolist(), want.tolist())
        assert torch.equal(ring, want), (S, K, ring.tolist(), want.tolist())
        rows.append({"S": S, "K": K, "histories": len(steps),
                     "r_cap": r_cap,
                     "table": "registers" if register_route(cfg)
                              else "shared",
                     "dead": int((got[:, 0] == 0).sum().item()),
                     "max_frontier": int(got[:, 3].max().item())})
    emit({"phase": "kernel_vs_plain", "ok": True, "geometries": rows})


def crowded_history(S: int, K: int, n_ops: int, seed: int, mutate: bool):
    """A history at mask width K whose pending ops reach slot min(K, 13)-1
    (indeterminate writes stay pending, so the high slots and, from K=13,
    the block bits of the table are used), values within S states."""
    from jepsen_etcd_demo_tpu_torch.ops.encode import (
        SlotOverflow, encode_register_history, encode_return_steps)
    from jepsen_etcd_demo_tpu_torch.utils.fuzz import (gen_register_history,
                                                       mutate_history)

    for i in range(500):
        rng = random.Random(seed + i)
        h = gen_register_history(rng, n_ops=n_ops, n_procs=min(K, 10),
                                 value_range=S - 1, p_info=0.06)
        if mutate:
            h = mutate_history(rng, h, value_range=S - 1)
        try:
            enc = encode_register_history(h, k_slots=K)
        except SlotOverflow:
            continue
        if enc.max_pending >= min(K, 13):
            return encode_return_steps(enc)
    raise AssertionError(f"no history fills K={K}")


def phase_long_kernel(dev) -> None:
    """The resumable dense kernel (K=5..17) and the sparse kernel
    (K=13..18, every round sparse and the auto threshold) against their
    plain versions on the card, over chains of 32-step windows through the
    route's window loop: exactly equal table and meta after every window
    (the seams between windows)."""
    from jepsen_etcd_demo_tpu_torch.models import CASRegister
    from jepsen_etcd_demo_tpu_torch.ops import wgl3, wgl3_kernels as wk

    model = CASRegister()
    window = 32
    dense = [(4, 5), (8, 9), (32, 11), (8, 13), (32, 15), (4, 17), (8, 17)]
    sparse = [(8, 13), (32, 14), (4, 15), (8, 16), (8, 17), (4, 18)]
    rows = []
    for sp, geoms in ((False, dense), (True, sparse)):
        for S, K in geoms:
            cfg = wgl3.DenseConfig(k_slots=K, n_states=S,
                                   state_offset=model.state_offset)
            nb = cfg.n_words // 128
            for mutate in (False, True):
                rs = crowded_history(S, K, 130, S * 1000 + K * 10, mutate)
                tg, cm = wk.prepare_steps(rs, model, cfg, dev)
                for thresh in ((nb, max(1, nb // 4)) if sp else (0,)):
                    chains = zip(*(
                        wk.window_sweep(fn, tg, cm, cfg,
                                        wk.start_carry(model, cfg, dev, sp),
                                        window)
                        for fn in sweeps(sp, thresh)))
                    for n_win, ((Tk, mk), (Tp, mp)) in enumerate(chains, 1):
                        torch.cuda.synchronize()
                        assert torch.equal(Tk, Tp) and torch.equal(mk, mp), \
                            (S, K, mutate, thresh, n_win, mk.tolist(),
                             mp.tolist())
                    assert n_win >= 3
                    m = mk[0].tolist()
                    rows.append({"kernel": "sparse" if sp else "resume",
                                 "table": None if sp else (
                                     "registers" if register_route(cfg)
                                     else "shared"),
                                 "S": S, "K": K, "mutant": mutate,
                                 "thresh": thresh, "windows": n_win,
                                 "steps": rs.n_steps, "dead_step": m[1],
                                 "max_frontier": m[2],
                                 "sparse_steps": m[6] if sp else None,
                                 "live_sum": m[5] if sp else None})
    assert any(r["dead_step"] >= 0 for r in rows)
    emit({"phase": "long_kernel_vs_plain", "ok": True, "window": window,
          "chains": rows})


def wide_history(S: int, K: int, n_ops: int, seed: int):
    """Return steps at mask width K of the first history (seeds seed,
    seed+1, ...) whose pending ops fill all K slots (10 processes,
    indeterminate writes piling up), values within S states, cut after
    the first step with K pending ops plus as many again."""
    from jepsen_etcd_demo_tpu_torch.ops.encode import (
        SlotOverflow, encode_register_history, encode_return_steps)
    from jepsen_etcd_demo_tpu_torch.utils.fuzz import gen_register_history

    # About K - 8 of the write and cas completions (60% of the ops) are
    # indeterminate.
    p_info = (K - 8) / (0.6 * n_ops)
    for i in range(500):
        h = gen_register_history(random.Random(seed + i), n_ops=n_ops,
                                 n_procs=10, value_range=S - 1,
                                 p_info=p_info)
        try:
            enc = encode_register_history(h, k_slots=K)
        except SlotOverflow:
            continue
        if enc.max_pending == K:
            rs = encode_return_steps(enc)
            full = int(rs.slot_active.sum(1).argmax())
            n = min(rs.n_steps, 2 * full + 1)
            return type(rs)(rs.slot_tabs[:n], rs.slot_active[:n],
                            rs.targets[:n], n, rs.n_ops, K, rs.max_pending,
                            rs.max_value)
    raise AssertionError(f"no history fills K={K}")


def phase_general_kernel(dev, kernels, global_rec) -> None:
    """The resumable sweep's global tier (tables past 2^20 bits, split
    over the shared memories of a thread-block cluster or of a few) against
    its plain version on the card, exactly equal table and meta, at every
    size the tier takes: 2^21 to 2^26 bits (S=8, K=18 to 23), one window
    over the return steps of a history whose pending ops fill every slot.
    Each row names the blocks and cluster size the launcher chose
    (wgl3_kernels.card_global_geometry)."""
    from jepsen_etcd_demo_tpu_torch.models import CASRegister
    from jepsen_etcd_demo_tpu_torch.ops import wgl3, wgl3_kernels as wk

    model = CASRegister()
    rows = []
    for S, K in GLOBAL_GEOMS:
        cfg = wgl3.DenseConfig(k_slots=K, n_states=S,
                               state_offset=model.state_offset)
        rs = wide_history(S, K, 700, 0x61B0 + K)
        tg, cm = wk.prepare_steps(rs, model, cfg, dev)
        carry = wk.start_carry(model, cfg, dev)

        def run(sweep):
            return last(wk.window_sweep(sweep, tg, cm, cfg,
                                        tuple(x.clone() for x in carry),
                                        rs.n_steps))

        ms, (Tk, mk) = cuda_ms(lambda: run(wk.dense_sweep_global), 2)
        plain_ms, (Tp, mp) = cuda_ms(lambda: run(wk.resumable_reference), 1,
                                     warm=False)
        err = max(int((Tk.long() - Tp.long()).abs().max().item()),
                  int((mk.long() - mp.long()).abs().max().item()))
        assert err == 0, (S, K, mk.tolist(), mp.tolist())
        fired = sorted({int(j) for j in torch.nonzero(
            (cm != 0).any(2).any(0).any(0)).flatten().tolist()})
        assert fired == list(range(K)), (S, K, fired)
        m = mk[0].tolist()
        ln = torch.tensor([rs.n_steps], dtype=torch.int32, device=dev)
        b = bound(cfg, (ln, tg, cm), [m[1]], 1, True)
        blocks, cluster = wk.card_global_geometry(S, K)
        assert cluster >= 1, (S, K, blocks, cluster)
        rows.append({"S": S, "K": K, "bits": S << K, "blocks": blocks,
                     "cluster": cluster, "grid_barrier": blocks > cluster,
                     "steps": rs.n_steps,
                     "dead_step": m[1], "max_frontier": m[2],
                     "configs_explored": m[3], "kernel_ms": ms,
                     "us_per_step": ms * 1e3 / rs.n_steps,
                     "plain_ms": plain_ms, "bound_ms": b.ms,
                     "bound_by": b.by})
        if K == GLOBAL_GEOMS[-1][1]:
            # The kernels line keeps the top of the envelope; its launches
            # are the general phase's main-path count (0 until it runs).
            global_rec["pair"] = (record("wgl3_sweep[global]", 0, err, ms,
                                         plain_ms, b), b)
    if "pair" in global_rec:
        kernels.append(global_rec["pair"])
    emit({"phase": "general_kernel_vs_plain", "ok": True, "geometries": rows})


def invalid_mutant(h, seed: int):
    """The first mutant of h (seeds seed, seed+1, ...) the host oracle
    finds not linearizable."""
    from jepsen_etcd_demo_tpu_torch.checkers.oracle import check_events_oracle
    from jepsen_etcd_demo_tpu_torch.models import CASRegister
    from jepsen_etcd_demo_tpu_torch.ops.encode import encode_register_history
    from jepsen_etcd_demo_tpu_torch.utils.fuzz import mutate_history

    for i in range(100):
        m = mutate_history(random.Random(seed + i), h)
        enc = encode_register_history(m, k_slots=32)
        if not check_events_oracle(enc, CASRegister()).valid:
            return m
    raise AssertionError("no invalid mutant found")


@functools.lru_cache(maxsize=1)
def make_corpus():
    """The BASELINE.json configs[4] corpus (1,024 histories of 150 ops at
    concurrency 10), made once a run: (histories, encodings, the mutants'
    encodings, the mutants)."""
    from jepsen_etcd_demo_tpu_torch.ops.encode import encode_register_history
    from jepsen_etcd_demo_tpu_torch.utils.fuzz import (gen_register_history,
                                                       mutate_history)

    rng = random.Random(0xBE7C)
    hists = [gen_register_history(rng, n_ops=150, n_procs=10, p_info=0.002)
             for _ in range(1024)]
    mrng = random.Random(0xBE7D)
    mutants = [mutate_history(mrng, h) for h in hists]
    enc = [encode_register_history(h, k_slots=32) for h in hists]
    menc = [encode_register_history(h, k_slots=32) for h in mutants]
    return hists, enc, menc, mutants


def phase_corpus(dev, kernels) -> None:
    from jepsen_etcd_demo_tpu_torch.checkers.oracle import check_events_oracle
    from jepsen_etcd_demo_tpu_torch.models import CASRegister
    from jepsen_etcd_demo_tpu_torch.ops import wgl3, wgl3_kernels as wk

    model = CASRegister()
    t0 = time.perf_counter()
    _hists, enc, menc, _mutants = make_corpus()
    encode_s = time.perf_counter() - t0
    wk.check_batch_encoded_auto(enc[:16], model, dev)   # warm-up
    torch.cuda.synchronize()

    wk.reset_launches()
    split: dict[str, float] = {}
    t0 = time.perf_counter()
    res, kname = wk.check_batch_encoded_auto(enc, model, dev, timings=split)
    check_s = time.perf_counter() - t0
    n_launch = wk.launches["dense_sweep"]
    assert n_launch > 0, "corpus check did not launch the kernel"
    assert all(r["valid"] is True for r in res), "a valid history failed"

    wk.reset_launches()
    mres, _ = wk.check_batch_encoded_auto(menc, model, dev)
    assert wk.launches["dense_sweep"] > 0
    cfg, (ln, tg, cm) = prepared(menc, model, dev)
    plain = wgl3.unpack_np(wk.sweep_reference(
        ln, tg, cm, cfg, wgl3.init_row(model, cfg)).cpu().numpy())
    for i, r in enumerate(mres):
        want = {"valid": bool(plain["survived"][i]),
                "dead_step": int(plain["dead_step"][i]),
                "max_frontier": int(plain["max_frontier"][i]),
                "configs_explored": int(plain["configs_explored"][i])}
        assert all(r[f] == v for f, v in want.items()), (i, r, want)
    # Verdicts and death points against the independent host oracle.
    for e, r in list(zip(enc, res))[:48] + list(zip(menc, mres))[:48]:
        o = check_events_oracle(e, model)
        assert o.valid == r["valid"] and o.dead_step(e) == r["dead_step"]

    cfg, inputs = prepared(enc, model, dev)
    rec, b = kernel_record("wgl3_sweep[corpus]", cfg, inputs,
                           wgl3.init_row(model, cfg), n_launch, reps=20)
    kernels.append((rec, b))
    emit({"phase": "corpus", "ok": True, "histories": len(enc),
          "kernel": kname, "launches": n_launch,
          "k_slots": cfg.k_slots, "n_states": cfg.n_states,
          "r_cap": int(inputs[1].shape[1]),
          "invalid_mutants": sum(1 for r in mres if r["valid"] is False),
          "encode_s": encode_s, "check_s": check_s,
          "histories_per_s": len(enc) / check_s,
          "check_split_s": split,
          "kernel_ms": rec["ms"],
          "kernel_histories_per_s": len(enc) / (rec["ms"] / 1e3)})


def phase_single(dev, kernels) -> None:
    from jepsen_etcd_demo_tpu_torch.checkers import Linearizable
    from jepsen_etcd_demo_tpu_torch.models import CASRegister
    from jepsen_etcd_demo_tpu_torch.ops import wgl3, wgl3_kernels as wk
    from jepsen_etcd_demo_tpu_torch.ops.encode import encode_register_history
    from jepsen_etcd_demo_tpu_torch.utils.fuzz import gen_register_history

    model = CASRegister()
    h = gen_register_history(random.Random(0x10C0 + 10_000), n_ops=10_000,
                             n_procs=10, p_info=0.0005)
    lin = Linearizable(model, device=dev)
    lin.check({}, h[:200])                                  # warm-up
    torch.cuda.synchronize()
    wk.reset_launches()
    t0 = time.perf_counter()
    res = lin.check({}, h)
    torch.cuda.synchronize()
    check_s = time.perf_counter() - t0
    n_launch = wk.launches["dense_sweep"]
    assert n_launch > 0, "single-history check did not launch the kernel"
    assert res["valid"] is True, res

    enc = encode_register_history(h, k_slots=64)
    cfg, inputs = prepared([enc], model, dev)
    rec, b = kernel_record("wgl3_sweep[single]", cfg, inputs,
                           wgl3.init_row(model, cfg), n_launch, reps=3)
    assert res["max_frontier"] > 0
    kernels.append((rec, b))
    emit({"phase": "single_10k", "ok": True, "ops": 10_000,
          "steps": int(inputs[0][0].item()), "k_slots": cfg.k_slots,
          "launches": n_launch, "check_s": check_s,
          "kernel_ms": rec["ms"], "max_frontier": res["max_frontier"],
          "configs_explored": res["configs_explored"]})


def long_setup(model, n_ops: int, n_procs: int, seed: int):
    """(history, encoding, geometry, return steps) of a generated long
    history, and the encode seconds."""
    from jepsen_etcd_demo_tpu_torch.checkers import Linearizable
    from jepsen_etcd_demo_tpu_torch.ops import wgl3
    from jepsen_etcd_demo_tpu_torch.ops.encode import (encode_return_steps,
                                                       reslot_events)
    from jepsen_etcd_demo_tpu_torch.utils.fuzz import gen_register_history

    h = gen_register_history(random.Random(seed), n_ops=n_ops,
                             n_procs=n_procs, p_info=0.0)
    t0 = time.perf_counter()
    enc = Linearizable(model, device="cpu").encode(h)
    encode_s = time.perf_counter() - t0
    k = wgl3.tight_k_slots(enc)
    cfg = wgl3.dense_config(model, k, enc.max_value)
    rs = encode_return_steps(reslot_events(enc, k))
    return h, enc, cfg, rs, encode_s


def whole_scan(model, enc, dev, reps: int = 0):
    """One launch of the whole-scan kernel on the history's inputs: its
    result fields, and its device milliseconds when `reps` > 0."""
    from jepsen_etcd_demo_tpu_torch.ops import wgl3, wgl3_kernels as wk

    cfg, (ln, tg, cm) = prepared([enc], model, dev)
    row0 = wgl3.init_row(model, cfg)
    if reps:
        ms, packed = cuda_ms(lambda: wk.dense_sweep(ln, tg, cm, cfg, row0),
                             reps)
    else:
        ms, packed = None, wk.dense_sweep(ln, tg, cm, cfg, row0)
    one = wgl3.unpack_np(packed.cpu().numpy())
    return {"valid": bool(one["survived"][0]),
            "dead_step": int(one["dead_step"][0]),
            "max_frontier": int(one["max_frontier"][0]),
            "configs_explored": int(one["configs_explored"][0])}, ms


def late_mutant(h, after_frac: float):
    """h with the first ok read past `after_frac` of the history reading
    5, a value no write of the generator (values 0..4) ever stores: the
    search dies at that read's return, the geometry unchanged."""
    from jepsen_etcd_demo_tpu_torch.ops.op import Op

    out = [Op(**op.__dict__) for op in h]
    i = next(i for i in range(int(after_frac * len(out)), len(out))
             if out[i].type == "ok" and out[i].f == "read")
    out[i].value = 5
    return out


def phase_long(dev, kernels) -> None:
    """The 100k-op history (the bench_long recipe) and a late-dying
    mutant of it through Linearizable on the card: five windows of the
    resumable dense kernel, every field equal to one launch of the
    whole-scan kernel, and the mutant's witness from the ladder."""
    from jepsen_etcd_demo_tpu_torch.checkers import Linearizable
    from jepsen_etcd_demo_tpu_torch.models import CASRegister
    from jepsen_etcd_demo_tpu_torch.ops import wgl3_kernels as wk

    model = CASRegister()
    h, enc, cfg, rs, encode_s = long_setup(model, LONG_OPS, 10,
                                           0x10C0 + LONG_OPS)
    windows = -(-rs.n_steps // wk.long_window())
    lin = Linearizable(model, device=dev)
    wk.run_chain(rs, model, cfg, dev, upto=64)              # warm-up
    torch.cuda.synchronize()
    wk.reset_launches()
    t0 = time.perf_counter()
    res = lin.check({}, h)
    torch.cuda.synchronize()
    check_s = time.perf_counter() - t0
    counts = dict(wk.launches)
    assert counts["dense_sweep_resumable"] == windows, counts
    assert res["valid"] is True, res
    fields = ("valid", "dead_step", "max_frontier", "configs_explored")
    scan, scan_ms = whole_scan(model, enc, dev, reps=1)
    assert all(res[f] == scan[f] for f in fields), (res, scan)

    # The check's split: host encode, the batch prep on the host, then
    # the copy to the card with the column-mask prep, and the kernels.
    split: dict[str, float] = {}
    wk.check_batch_encoded_auto([enc], model, dev, timings=split)
    t0 = time.perf_counter()
    tg, cm = wk.prepare_steps(rs, model, cfg, dev)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    carry = wk.start_carry(model, cfg, dev)
    kernel_ms, (_T, m) = cuda_ms(lambda: last(wk.window_sweep(
        wk.dense_sweep_resumable, tg, cm, cfg,
        tuple(x.clone() for x in carry), wk.long_window())), 2)
    assert m[0].tolist()[:4] == [0, -1, res["max_frontier"],
                                 res["configs_explored"]]
    del tg, cm

    rec, b = window_record("wgl3_sweep[resume]", model, cfg, rs, dev, False,
                           0, counts["dense_sweep_resumable"], reps=3,
                           window=LONG_CHECK_STEPS)
    kernels.append((rec, b))

    mutant = late_mutant(h, 0.62)
    wk.reset_launches()
    with tempfile.TemporaryDirectory() as store:
        t0 = time.perf_counter()
        bad = lin.check({}, mutant, {"store_dir": store})
        torch.cuda.synchronize()
        bad_s = time.perf_counter() - t0
        witness = json.loads((Path(store) / bad["witness_file"]).read_text())
    bad_counts = dict(wk.launches)
    assert bad_counts["dense_sweep_resumable"] > 0, bad_counts
    bad_scan, _ = whole_scan(model, lin.encode(mutant), dev)
    assert bad["valid"] is False and bad["dead_step"] > LONG_DEAD_AFTER, bad
    assert all(bad[f] == bad_scan[f] for f in fields), (bad, bad_scan)
    assert bad.get("failed_op") == "read -> 5", bad
    rung = "windowed" if "window_start_step" in witness else "full"
    emit({"phase": "long_100k", "ok": True, "ops": LONG_OPS,
          "steps": rs.n_steps, "k_slots": cfg.k_slots,
          "n_states": cfg.n_states, "window": wk.long_window(),
          "launches": counts, "kernel": res.get("backend"),
          "encode_s": encode_s, "check_s": check_s,
          "check_split_s": split, "prep_s": prep_s, "kernel_ms": kernel_ms,
          "whole_scan_kernel_ms": scan_ms,
          "max_frontier": res["max_frontier"],
          "configs_explored": res["configs_explored"],
          "window_kernel_ms": rec["ms"], "window_plain_ms": rec["plain_ms"],
          "window_check_steps": LONG_CHECK_STEPS,
          "mutant": {"dead_step": bad["dead_step"],
                     "failed_op": bad["failed_op"], "witness_rung": rung,
                     "window_start_step": witness.get("window_start_step"),
                     "check_s": bad_s, "launches": bad_counts}})


def few_block_history(n_ops: int, seed: int):
    """A register history at K=16 whose frontier spans two of the table's
    16 blocks of 128 words: twelve reads held pending at the start take
    slots 0..11 while an indeterminate write (slot 12) and three
    indeterminate cas ops expecting 6, a value no op writes (slots 13-15:
    they never fire), are invoked; then n_ops ops at concurrency 10 reuse
    slots 0..11. Configs with bit 12 set lie in block 1, none has bits
    13-15 set."""
    from jepsen_etcd_demo_tpu_torch.ops.op import Op
    from jepsen_etcd_demo_tpu_torch.utils.fuzz import gen_register_history

    reads = range(200, 212)
    dead = [Op(type="invoke", f="cas", value=(6, 6), process=301 + p)
            for p in range(3)]
    h = [Op(type="invoke", f="read", value=None, process=p) for p in reads]
    h += [Op(type="invoke", f="write", value=0, process=300), *dead]
    h += [Op(type="ok", f="read", value=None, process=p) for p in reads]
    h += gen_register_history(random.Random(seed), n_ops=n_ops, n_procs=10,
                              p_info=0.0)
    h += [Op(type="info", f="write", value=0, process=300)]
    h += [Op(type="info", f=op.f, value=op.value, process=op.process)
          for op in dead]
    return h


def sparse_pair(dev, model, h, enc, cfg, rs, steps: int, name: str):
    """History h through Linearizable twice: under sparse_mode=2 on the
    sparse kernel, then under the default limits on the resumable dense
    kernel (its shared-memory route); the verdict fields agree. Each
    kernel is held against its plain version on the first `steps` steps.
    Returns the sparse record's pair, the dense one's and the phase line's
    fields."""
    from dataclasses import replace

    from jepsen_etcd_demo_tpu_torch.checkers import Linearizable
    from jepsen_etcd_demo_tpu_torch.ops import wgl3_kernels as wk
    from jepsen_etcd_demo_tpu_torch.ops.limits import limits, set_limits

    assert cfg.k_slots == 16 and rs.n_steps > limits().long_scan_max
    lin = Linearizable(model, device=dev)
    runs, stats = {}, {}
    base = limits()
    try:
        for mode in (2, 0):
            set_limits(replace(base, sparse_mode=mode))
            wk.run_chain(rs, model, cfg, dev, upto=64,
                         sparse=wk.sparse_selected(cfg))   # warm-up
            torch.cuda.synchronize()
            wk.reset_launches()
            t0 = time.perf_counter()
            res = lin.check({}, h)
            torch.cuda.synchronize()
            runs[mode] = (res, time.perf_counter() - t0, dict(wk.launches))
            split: dict[str, float] = {}
            one = wk.check_batch_encoded_auto([enc], model, dev,
                                              timings=split)[0][0]
            stats[mode] = {"check_split_s": split,
                           "kernel": one["kernel"],
                           "sweep": one.get("sweep")}
    finally:
        set_limits(base)
    nb = cfg.n_words // 128
    assert not register_route(cfg)
    rec, b = window_record(name, model, cfg, rs, dev, True, nb,
                           runs[2][2]["sparse_sweep_resumable"], reps=2,
                           window=steps)
    drec, db = window_record("wgl3_sweep[resume,shared]", model, cfg, rs,
                             dev, False, 0,
                             runs[0][2]["dense_sweep_resumable"], reps=2,
                             window=steps)
    (sparse_res, sparse_s, sparse_counts) = runs[2]
    (dense_res, dense_s, dense_counts) = runs[0]
    assert sparse_counts["sparse_sweep_resumable"] > 0, sparse_counts
    assert sparse_counts["dense_sweep_resumable"] == 0, sparse_counts
    assert dense_counts["dense_sweep_resumable"] > 0, dense_counts
    assert dense_counts["sparse_sweep_resumable"] == 0, dense_counts
    fields = ("valid", "dead_step", "max_frontier", "configs_explored")
    assert all(sparse_res[f] == dense_res[f] for f in fields), \
        (sparse_res, dense_res)
    assert sparse_res["valid"] is True
    line = {"steps": rs.n_steps, "k_slots": cfg.k_slots,
            "n_states": cfg.n_states, "blocks": nb,
            "sparse_mode2": {"check_s": sparse_s, "launches": sparse_counts,
                             **stats[2]},
            "default": {"check_s": dense_s, "launches": dense_counts,
                        **stats[0]},
            "max_frontier": dense_res["max_frontier"],
            "configs_explored": dense_res["configs_explored"],
            "check_steps": steps,
            "window_kernel_ms": rec["ms"], "window_plain_ms": rec["plain_ms"],
            "us_per_step": rec["ms"] * 1e3 / steps,
            "dense_window_kernel_ms": drec["ms"],
            "dense_window_plain_ms": drec["plain_ms"],
            "dense_us_per_step": drec["ms"] * 1e3 / steps}
    return (rec, b), (drec, db), line


def phase_sparse(dev, kernels) -> None:
    """Two long histories at K=16 (16 blocks of 128 words), each through
    sparse_pair: 50k ops at concurrency 16 (a quarter of the blocks live),
    and the few-block history (two live blocks). The sparse kernel and the
    dense shared-memory route are timed on the first SPARSE_CHECK_STEPS
    and FEW_CHECK_STEPS steps, and on the few-block history's first
    FEW_K17_STEPS steps at K=17 (two of 32 blocks live), each held against
    its plain version."""
    from dataclasses import replace

    from jepsen_etcd_demo_tpu_torch.checkers import Linearizable
    from jepsen_etcd_demo_tpu_torch.models import CASRegister
    from jepsen_etcd_demo_tpu_torch.ops import wgl3
    from jepsen_etcd_demo_tpu_torch.ops.encode import (encode_return_steps,
                                                       reslot_events)

    model = CASRegister()
    h, enc, cfg, rs, encode_s = long_setup(model, SPARSE_OPS, 16,
                                            0x10C0 + SPARSE_OPS)
    sparse, dense, line = sparse_pair(dev, model, h, enc, cfg, rs,
                                      SPARSE_CHECK_STEPS, "wgl3_sparse")
    kernels += [sparse, dense]
    emit({"phase": "sparse_50k", "ok": True, "ops": SPARSE_OPS,
          "encode_s": encode_s, **line})
    h = few_block_history(FEW_OPS, 0xFE0B)
    enc = Linearizable(model, device="cpu").encode(h)
    k = wgl3.tight_k_slots(enc)
    cfg = wgl3.dense_config(model, k, enc.max_value)
    rs = encode_return_steps(reslot_events(enc, k))
    sparse, _dense, line = sparse_pair(dev, model, h, enc, cfg, rs,
                                       FEW_CHECK_STEPS,
                                       "wgl3_sparse[few-block]")
    live = line["sparse_mode2"]["sweep"]["live_tile_ratio"]
    assert live <= 2 / 16, live
    kernels.append(sparse)
    # The same history at K=17 (32 blocks, the widest table of S=8 the
    # sparse kernel takes): two blocks of 32 live.
    cfg17 = replace(cfg, k_slots=17)
    rs17 = encode_return_steps(reslot_events(enc, 17))
    k17 = {}
    for name, is_sparse, thresh in (("wgl3_sparse[few-block]", True, 32),
                                    ("wgl3_sweep[resume,shared]", False, 0)):
        rec, _ = window_record(name, model, cfg17, rs17, dev, is_sparse,
                               thresh, 0, reps=2, window=FEW_K17_STEPS)
        k17[name] = rec["ms"] * 1e3 / FEW_K17_STEPS
    emit({"phase": "sparse_few_block", "ok": True, "ops": FEW_OPS, **line,
          "k17_steps": FEW_K17_STEPS, "k17_us_per_step": k17})


def phase_independent(dev) -> None:
    from jepsen_etcd_demo_tpu_torch.checkers import (IndependentChecker,
                                                     Linearizable)
    from jepsen_etcd_demo_tpu_torch.ops import wgl3_kernels as wk
    from jepsen_etcd_demo_tpu_torch.utils.fuzz import (gen_register_history,
                                                       interleave_keyed)

    rng = random.Random(0x1D)
    per_key = [gen_register_history(rng, n_ops=1000, n_procs=10,
                                    p_info=0.002) for _ in range(10)]
    per_key[3] = invalid_mutant(per_key[3], 0x1D3)
    ops = interleave_keyed(per_key)
    wk.reset_launches()
    t0 = time.perf_counter()
    got = IndependentChecker(Linearizable(device=dev)).check({}, ops)
    torch.cuda.synchronize()
    check_s = time.perf_counter() - t0
    n_launch = wk.launches["dense_sweep"]
    assert n_launch > 0, "independent check did not launch the kernel"
    want = IndependentChecker(Linearizable(device="cpu")).check({}, ops)
    fields = ("valid", "dead_step", "max_frontier", "configs_explored",
              "failed_op")
    for k, r in got["results"].items():
        assert all(r.get(f) == want["results"][k].get(f) for f in fields), k
    assert got["valid"] == want["valid"] is False
    assert got["results"]["3"]["failed_op"]
    emit({"phase": "independent", "ok": True, "keys": got["key_count"],
          "ops_per_key": 1000, "valid": got["valid"], "launches": n_launch,
          "invalid_keys": sorted(k for k, r in got["results"].items()
                                 if r["valid"] is False),
          "check_s": check_s,
          "split": independent_split(dev, ops, {
              k for k, r in got["results"].items() if r["valid"] is False})})


def independent_split(dev, ops, invalid: set, reps: int = 3) -> dict:
    """Where phase `independent`'s check_s goes, warm, `reps` times in
    turn: the whole checker through the scheduler ("sched") and with the
    route before it put back ("auto": check_batch_encoded_auto); then
    the checker's parts: encoding every key, the dense half of each route
    on the same encodings stage by stage, each stage synchronized (the
    auto route's own `timings`; the scheduler's stages replayed with its
    functions, and its launch's staging copy from pageable memory as the
    route before it made it), and the own check of each `invalid` key
    (witness included). Not counted: the phase's counts are read before
    it."""
    import numpy as np

    from jepsen_etcd_demo_tpu_torch import sched
    from jepsen_etcd_demo_tpu_torch.checkers import (IndependentChecker,
                                                     Linearizable,
                                                     split_by_key)
    from jepsen_etcd_demo_tpu_torch.ops import wgl3, wgl3_kernels as wk
    from jepsen_etcd_demo_tpu_torch.ops.encode import (encode_return_steps,
                                                       reslot_events)
    from jepsen_etcd_demo_tpu_torch.sched import engine

    def auto_corpus(encs, model=None, f_cap=256, device=None,
                    time_budget_s=None):
        res, kernel = wk.check_batch_encoded_auto(
            encs, model, device, time_budget_s=time_budget_s)
        return res, kernel, {}

    def sched_stages(encs, model) -> dict:
        t, t0 = {}, [time.perf_counter()]

        def lap(stage):
            torch.cuda.synchronize()
            now = time.perf_counter()
            t[stage] = t.get(stage, 0.0) + now - t0[0]
            t0[0] = now

        dense_idx, _g = wk.partition_dense(encs, model)
        k = max(wgl3.tight_k_slots(encs[i]) for i in dense_idx)
        cfg = wgl3.dense_config(model, k,
                                max(encs[i].max_value for i in dense_idx))
        lap("partition_dense")
        steps = [encode_return_steps(reslot_events(encs[i], k)
                                     if encs[i].k_slots != k else encs[i],
                                     dev) for i in dense_idx]
        lap("return_steps")
        buckets: dict[int, list] = {}
        for s, r in zip(steps, engine.assign_step_buckets(
                [s.n_steps for s in steps])):
            buckets.setdefault(r, []).append(s)
        rows, shapes = [], []
        for r, part in sorted(buckets.items()):
            b = engine._batch_bucket(len(part), len(part) + 64)
            padded = part + [engine._pad_rs(k)] * (b - len(part))
            shapes.append([b, r])
            arrays = wgl3.stack_steps3(padded, r, dev)
            lap("stack_h2d")
            ln, tg, cm = wk.prepare_colmask(model, cfg, *arrays)
            lap("prepare_colmask")
            rows.append(wk.dense_sweep(ln, tg, cm, cfg,
                                       wgl3.init_row(model, cfg))[:len(part)])
            lap("kernel")
            # The route before the scheduler staged from pageable memory.
            padded_np = [p.padded_to(r) for p in padded]
            _pageable = [torch.from_numpy(np.stack(
                [getattr(p, f) for p in padded_np])).to(dev)
                for f in ("slot_tabs", "slot_active", "targets")]
            lap("stack_h2d_pageable")
        wgl3.assemble_batch_results(
            wgl3.unpack_np(torch.cat(rows).cpu().numpy()),
            [s for _r, part in sorted(buckets.items()) for s in part], cfg)
        lap("fetch_assemble")
        t["shapes"] = shapes
        return t

    lin = Linearizable(device=dev)
    keyed = split_by_key(ops)
    real = sched.check_corpus
    out = {"check_s": {"sched": [], "auto": []}, "encode_keys_s": [],
           "dense": {"sched": [], "auto": []}, "invalid_keys_s": []}
    for _ in range(reps):
        t0 = time.perf_counter()
        encs = [lin.encode(keyed[k]) for k in sorted(keyed, key=str)]
        out["encode_keys_s"].append(time.perf_counter() - t0)
        for route in ("sched", "auto"):
            sched.check_corpus = real if route == "sched" else auto_corpus
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                IndependentChecker(Linearizable(device=dev)).check({}, ops)
                torch.cuda.synchronize()
                out["check_s"][route].append(time.perf_counter() - t0)
            finally:
                sched.check_corpus = real
        timings: dict = {}
        wk.check_batch_encoded_auto(encs, lin.model, dev, timings=timings)
        out["dense"]["auto"].append(timings)
        out["dense"]["sched"].append(sched_stages(encs, lin.model))
        t0 = time.perf_counter()
        for k in keyed:
            if str(k) in invalid:
                Linearizable(device=dev).check({}, keyed[k])
        torch.cuda.synchronize()
        out["invalid_keys_s"].append(time.perf_counter() - t0)
    return out


def partitioned_history(n_ops: int, p_info: float, seed: int, k_lo: int,
                        k_hi: int, min_info: int):
    """(history, seed) of the first history from `seed` at `p_info` with at
    least `min_info` indeterminate ops and a tight K in [k_lo, k_hi]."""
    from jepsen_etcd_demo_tpu_torch.ops import wgl3
    from jepsen_etcd_demo_tpu_torch.ops.encode import encode_register_history
    from jepsen_etcd_demo_tpu_torch.utils.fuzz import gen_register_history

    for i in range(200):
        h = gen_register_history(random.Random(seed + i), n_ops=n_ops,
                                 n_procs=10, p_info=p_info)
        enc = encode_register_history(h, k_slots=64)
        if (sum(op.type == "info" for op in h) >= min_info
                and k_lo <= wgl3.tight_k_slots(enc) <= k_hi):
            return h, seed + i
    raise AssertionError(f"no history with tight K in {k_lo}..{k_hi}")


def general_check(lin, h, **extra):
    """One check through `lin` on the card with the launch counters and
    the sort search's work (wgl2.stats) reset just before it: a row of
    what phase `general` prints, and the result."""
    from jepsen_etcd_demo_tpu_torch.ops import wgl2, wgl3, wgl3_kernels as wk

    t0 = time.perf_counter()
    enc = lin.encode(h)
    encode_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    wk.reset_launches()
    wgl2.reset_stats()
    t0 = time.perf_counter()
    res = lin.check({}, h, extra.pop("opts", None))
    torch.cuda.synchronize()
    check_s = time.perf_counter() - t0
    sort = {f: {"steps": n, "s": sec, "s_per_step": sec / max(1, n)}
            for f, (n, sec) in sorted(wgl2.stats.items())}
    row = {"ops": sum(op.type == "invoke" for op in h),
           "info": sum(op.type == "info" for op in h),
           "events": enc.n_events, "max_pending": enc.max_pending,
           "tight_k": wgl3.tight_k_slots(enc),
           "sort_k": wgl2.sort_k_slots(enc), "encode_s": encode_s,
           "check_s": check_s, "valid": res["valid"],
           "kernel": res.get("kernel", res.get("backend")),
           "f_cap": res.get("f_cap"), "escalations": res.get("escalations"),
           "max_frontier": res.get("max_frontier"),
           "dead_step": res.get("dead_step"), "launches": dict(wk.launches),
           "sort_steps": sort, **extra}
    return row, res, enc


def dense_rung(model, enc, dev):
    """The general path's dense-chunked rung run directly on a history:
    the resumable sweep under the chunked budget at the sort width."""
    from jepsen_etcd_demo_tpu_torch import plan
    from jepsen_etcd_demo_tpu_torch.ops import wgl2, wgl3
    from jepsen_etcd_demo_tpu_torch.ops.encode import (encode_return_steps,
                                                       reslot_events)
    from jepsen_etcd_demo_tpu_torch.ops.limits import limits

    k = wgl2.sort_k_slots(enc)
    cfg = wgl3.dense_config(model, k, enc.max_value,
                            budget=limits().dense_cell_budget_chunked)
    t0 = time.perf_counter()
    out = plan.dispatch_long(encode_return_steps(reslot_events(enc, k)),
                             model, cfg, dev)
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
    return out


def phase_general(dev, global_rec) -> None:
    """The general path on the card at full size, through Linearizable,
    IndependentChecker and check_batch_encoded_auto (histories a-e of
    GENERAL_OPS..): verdicts held against the dense-chunked rung run
    directly or the single-key path, the mutant's witness from the
    sort-checkpoint rung, the global tier's launches on the main path.
    The sort search runs without subsumption (limits.subsume_mode 1, the
    JAX package's search): with it, these partitioned keys never outgrow
    the sort ladder, and the rungs past it would go unused (phase `test`
    runs the default)."""
    from dataclasses import replace

    from jepsen_etcd_demo_tpu_torch.ops.limits import limits, set_limits

    prev = set_limits(replace(limits(), subsume_mode=1))
    try:
        general_paths(dev, global_rec)
    finally:
        set_limits(prev)


def general_paths(dev, global_rec) -> None:
    """phase_general's histories a-e."""
    from jepsen_etcd_demo_tpu_torch.checkers import (IndependentChecker,
                                                     Linearizable)
    from jepsen_etcd_demo_tpu_torch.checkers import witness
    from jepsen_etcd_demo_tpu_torch.models import CASRegister
    from jepsen_etcd_demo_tpu_torch.ops import wgl2, wgl3, wgl3_kernels as wk
    from jepsen_etcd_demo_tpu_torch.utils.fuzz import (gen_register_history,
                                                       interleave_keyed,
                                                       mutate_history)

    model = CASRegister()
    lin = Linearizable(model, device=dev)
    lin.check({}, gen_register_history(random.Random(5), n_ops=300,
                                       n_procs=10, p_info=0.03))  # warm-up

    def done(name: str, row: dict) -> None:
        emit({"phase": f"general_{name}", "ok": True, **row})

    # (a) one partitioned key; the ladder against the dense rung directly.
    h_a, seed_a = partitioned_history(GENERAL_OPS, GENERAL_P_INFO,
                                      GENERAL_SEED, 17, 20, 10)
    row, res, enc_a = general_check(lin, h_a, seed=seed_a)
    direct = dense_rung(model, enc_a, dev)
    assert res["valid"] is True and direct["valid"] is True, (res, direct)
    assert res["dead_step"] == direct["dead_step"], (res, direct)
    row["dense_rung"] = {k: direct[k] for k in (
        "valid", "dead_step", "max_frontier", "configs_explored", "kernel",
        "seconds")}
    done("a", row)
    global_launches = row["launches"]["dense_sweep_global"]

    # (d) invalid mutants of (a): the first whose dense rung dies within
    # WITNESS_LAG steps after a sort chunk boundary past the first, so the
    # sort checkpoint is not the start and its replay window is short.
    for i in range(400):
        h_d = mutate_history(random.Random(0xD0 + i), h_a)
        d_direct = dense_rung(model, lin.encode(h_d), dev)
        if d_direct["valid"] is False \
                and d_direct["dead_step"] >= wgl2.DEFAULT_CHUNK \
                and d_direct["dead_step"] % wgl2.DEFAULT_CHUNK < WITNESS_LAG:
            break
    else:
        raise AssertionError("no mutant of (a) dies just past a chunk")
    with tempfile.TemporaryDirectory() as store:
        row, res, enc_d = general_check(lin, h_d, seed=0xD0 + i,
                                        opts={"store_dir": store})
        w_lin = json.loads((Path(store) / res["witness_file"]).read_text())
    assert res["valid"] is False, res
    assert res["dead_step"] == d_direct["dead_step"], (res, d_direct)
    # Linearizable's witness ladder reaches the sort-checkpoint rung only
    # when the windowed rung finds no dense table; this history has one,
    # so the rung runs here on the ladder's own death checkpoint.
    ladder = wk.check_encoded_general(enc_d, model, device=dev)
    t0 = time.perf_counter()
    w = witness.reconstruct_witness_from_sort_checkpoint(
        enc_d, model, lin.model.prepare_history(h_d),
        checkpoint=ladder.get("death_checkpoint"),
        dead_step=res["dead_step"], device=dev)
    w_s = time.perf_counter() - t0
    assert w is not None and w.get("witness") != "skipped", w
    assert w["dead_step"] == res["dead_step"], (w["dead_step"], res)
    if res.get("failed_op"):
        assert w["op"] == res["failed_op"], (w["op"], res["failed_op"])
    row["dense_rung_dead_step"] = d_direct["dead_step"]
    row["witness"] = {
        "linearizable": (res.get("witness_detail") if res.get("witness") ==
                         "skipped" else "windowed" if "window_start_step"
                         in w_lin else "full"),
        "sort_checkpoint": {"op": w["op"], "seconds": w_s,
                            "window_start_step": w["window_start_step"],
                            "from_checkpoint": "death_checkpoint" in ladder,
                            "ladder_kernel": ladder["kernel"]}}
    done("d", row)
    global_launches += row["launches"]["dense_sweep_global"]

    # (b) configs[3]'s length under partitions, with a time budget.
    h_b = gen_register_history(random.Random(STRESS_SEED), n_ops=STRESS_OPS,
                               n_procs=10, p_info=STRESS_P_INFO)
    row, res, enc_b = general_check(lin, h_b)
    assert res["valid"] is not False, res
    t0 = time.perf_counter()
    wgl2.reset_stats()
    ladder = wk.check_encoded_general(enc_b, model, device=dev,
                                      time_budget_s=STRESS_BUDGET_S)
    torch.cuda.synchronize()
    assert ladder["valid"] is not False, ladder
    row["ladder"] = {"check_s": time.perf_counter() - t0,
                     "valid": ladder["valid"], "kernel": ladder["kernel"],
                     "f_cap": ladder.get("f_cap"),
                     "escalations": ladder.get("escalations"),
                     "max_frontier": ladder.get("max_frontier"),
                     "sort_steps": {f: {"steps": n, "s": sec,
                                        "s_per_step": sec / max(1, n)}
                                    for f, (n, sec)
                                    in sorted(wgl2.stats.items())}}
    done("b", row)

    # (c) huge values: S > 32, no dense rung, unpacked sort keys.
    h_c = gen_register_history(random.Random(HUGE_SEED), n_ops=HUGE_OPS,
                               n_procs=10, p_info=STRESS_P_INFO,
                               value_range=HUGE_VALUES)
    row, res, enc_c = general_check(lin, h_c)
    k_c = wgl2.sort_k_slots(enc_c)
    assert not wgl2.packable(model, wgl2.make_config(model, k_c, 4,
                                                     enc_c.max_value))
    assert wgl3.dense_config(model, wgl3.tight_k_slots(enc_c),
                             enc_c.max_value) is None
    assert res["valid"] in (True, False), res
    done("c", row)

    # (e) 10 keys x 1000 ops, keys 8-9 past the dense budget.
    rng = random.Random(0xE0)
    per_key = [gen_register_history(rng, n_ops=1000, n_procs=10,
                                    p_info=0.002) for _ in range(8)]
    for j in range(2):
        per_key.append(partitioned_history(1000, 0.012,
                                           GENERAL_SEED + 100 * (j + 1),
                                           18, 20, 6)[0])
    ops = interleave_keyed(per_key)
    encs = [lin.encode(h) for h in per_key]
    wk.reset_launches()
    t0 = time.perf_counter()
    batch, kernel = wk.check_batch_encoded_auto(encs, model, dev)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    batch_counts = dict(wk.launches)
    global_launches += batch_counts["dense_sweep_global"]
    # The dense half's results carry no kernel name of their own.
    settled = [r.get("kernel", "wgl3-dense-cuda") for r in batch]
    assert kernel == "mixed" and batch_counts["dense_sweep"] > 0, \
        (kernel, batch_counts)
    assert "wgl3-dense-cuda" in settled and any(
        t != "wgl3-dense-cuda" for t in settled), settled
    singles = [lin.check({}, h) for h in per_key]
    for j, (b_one, one) in enumerate(zip(batch, singles)):
        assert b_one["valid"] == one["valid"], (j, b_one, one)
        assert b_one["dead_step"] == one["dead_step"], (j, b_one, one)
    t0 = time.perf_counter()
    ind = IndependentChecker(lin).check({}, ops)
    torch.cuda.synchronize()
    ind_s = time.perf_counter() - t0
    for j, one in enumerate(singles):
        got = ind["results"][str(j)]
        assert got["valid"] == one["valid"], (j, got, one)
    done("e", {"keys": len(per_key), "batch_s": batch_s,
                "batch_launches": batch_counts, "kernel": kernel,
                "tight_k": [wgl3.tight_k_slots(e) for e in encs],
                "settled_in": settled,
                "f_cap": [r.get("f_cap", r.get("table_cells"))
                          for r in batch],
                "independent_s": ind_s, "valid": ind["valid"]})
    assert global_launches > 0, "the general path never ran the global tier"
    if "pair" in global_rec:
        global_rec["pair"][0]["launches"] = global_launches
    emit({"phase": "general", "ok": True,
          "global_launches": global_launches})


def pool_txns(n_txns: int, seed: int, active: int = 3, max_ops: int = 4,
              p_read: float = 0.5, max_writes: int = 32) -> list[tuple]:
    """A list-append history in the shape of Jepsen's append generator:
    `active` live keys, 1..max_ops micro-ops a txn, reads with p_read, and
    a key retired for a fresh one after max_writes appends. The txns run
    serially against a store with unique append values, so the history is
    anomaly-free by construction. ("ok", [micro-op, ...]) tuples, as
    utils.fuzz.gen_append_txns returns."""
    rng = random.Random(seed)
    store: dict = {}
    pool = [f"k{i}" for i in range(active)]
    fresh = active
    txns = []
    for _ in range(n_txns):
        mops = []
        for _ in range(1 + rng.randrange(max_ops)):
            slot = rng.randrange(active)
            k = pool[slot]
            if rng.random() < p_read:
                mops.append(("r", k, store.get(k, ())))
                continue
            store[k] = store.get(k, ()) + (len(store.get(k, ())) + 1,)
            mops.append(("append", k, len(store[k])))
            if len(store[k]) >= max_writes:
                pool[slot], fresh = f"k{fresh}", fresh + 1
        txns.append(("ok", mops))
    return txns


def edges(h):
    """The (ww, wr, rw) edge matrices (bool[N, N]) of a txn history, by
    the checker's own inference."""
    from jepsen_etcd_demo_tpu_torch.checkers.elle import ElleGraph, _pair_txns

    graph = ElleGraph()
    for t in _pair_txns(h):
        graph.add_txn(*t)
    return graph.edge_matrices()


def largest_component(full):
    """The subgraph of full bool[N, N] on its largest weak component."""
    import numpy as np

    from jepsen_etcd_demo_tpu_torch.ops import cycles

    comp = max(cycles.weak_components(full), key=len)
    return full[np.ix_(comp, comp)]


@functools.cache
def pool_graph(n_txns: int = POOL_TXNS, seed: int = POOL_SEED):
    """The pool history's ops, its dependency graph ww|wr|rw (bool[N, N])
    and its largest weak component as a subgraph; built once."""
    from jepsen_etcd_demo_tpu_torch.utils.fuzz import append_txn_ops

    h = append_txn_ops(pool_txns(n_txns, seed))
    ww, wr, rw = edges(h)
    full = ww | wr | rw
    return h, full, largest_component(full)


def accumulate_cases(dev):
    """(name, R_flat f32[nbb, T, T], work int32[3, G]) geometries of the
    accumulate: an empty list, one product, all nb^3 products at nb=8
    and T=256 (each destination takes nb), T=128 and T=512, with zero-sink
    entries (index nbb) mixed in; random 0/1 tiles, every third empty."""
    g = torch.Generator().manual_seed(0xE11A)

    def grid(nb, T):
        R = (torch.rand((nb * nb, T, T), generator=g) < 0.01).float()
        R[1::3] = 0.0
        return R.to(dev)

    def products(nb, sel, sink=0):
        i, k, j = sel // (nb * nb), (sel // nb) % nb, sel % nb
        w = torch.stack([i * nb + k, k * nb + j, i * nb + j])
        w = torch.cat([w, torch.full((3, sink), nb * nb)], dim=1)
        return w.to(torch.int32).to(dev)

    every = torch.arange(8 ** 3)
    yield "empty", grid(2, 256), products(2, torch.arange(0))
    yield "one", grid(2, 256), products(2, torch.tensor([6]))
    yield "all_nb8_T256", grid(8, 256), products(
        8, every[torch.randperm(every.numel(), generator=g)])
    yield "half_nb6_T128", grid(6, 128), products(
        6, torch.randperm(216, generator=g)[:108], sink=7)
    yield "all_nb3_T512", grid(3, 512), products(3, torch.arange(27), 2)


def accumulate_bound(work, nbb: int, T: int) -> Bound:
    """Least time of one accumulate on this card, from the work list: the
    unique operand tiles read and destination tiles written over the HBM
    rate, against 2 T^3 operations a product over the int8 tensor-core
    rate (0/1 operands are exact in int8); the larger."""
    sa, sb, dd = work.long()
    live = (sa < nbb) & (sb < nbb)
    tiles = (torch.unique(torch.cat([sa[live], sb[live]])).numel()
             + torch.unique(dd[live]).numel())
    return Bound.of(2 * T ** 3 * int(live.sum()) / INT8_OPS_PER_S * 1e3,
                    tiles * T * T * 4 / HBM_BYTES_PER_S * 1e3)


def pool_round_inputs(dev):
    """The grids that enter the sparse rounds of the pool component's
    closure (kernel route): [(round index, R f32[nb, nb, T, T])]."""
    from jepsen_etcd_demo_tpu_torch.ops import cycles_tiled as ct

    _h, _full, sub = pool_graph()
    R = ct.grid_from_adj(sub, ct._tile(), dev)
    out = []
    for r, (kind, R_next, _row) in enumerate(ct.closure_rounds(R)):
        if kind == "sparse":
            out.append((r, R))
        R = R_next
    return out


def phase_elle_kernel(dev, elle_rec) -> None:
    """The accumulate kernel against its plain version on the card, exact
    equality of acc: the synthetic geometries, then the work lists of the
    pool history's real sparse rounds 0 and 3. Times the round-3 list
    through the wrapper, and its launch alone (the destination lists and
    the zeroed output made beforehand, outside the count)."""
    from jepsen_etcd_demo_tpu_torch.ops import build, cycles_tiled as ct

    rows = []
    cases = list(accumulate_cases(dev))
    rounds = dict(pool_round_inputs(dev))
    assert 0 in rounds and 3 in rounds, sorted(rounds)
    for r in (0, 3):
        R = rounds[r]
        nb, T = R.shape[0], R.shape[-1]
        cases.append((f"pool_round{r}", R.reshape(nb * nb, T, T),
                      ct.work_list(R)))
    err = 0
    for name, R_flat, work in cases:
        got = ct.tile_accumulate(R_flat, work)
        want = ct.tile_accumulate_reference(R_flat, work)
        torch.cuda.synchronize()
        err = max(err, float((got - want).abs().max()))
        assert torch.equal(got, want), name
        rows.append({"case": name, "nbb": R_flat.shape[0],
                     "T": R_flat.shape[-1], "products": work.shape[1],
                     "destinations": int(torch.unique(work[2]).numel()),
                     "sum": float(got.sum())})
    name, R_flat, work = cases[-1]
    ms, _ = cuda_ms(lambda: ct.tile_accumulate(R_flat, work), 10)
    plain_ms, _ = cuda_ms(lambda: ct.tile_accumulate_reference(R_flat, work),
                          3)
    nbb, T = R_flat.shape[0], R_flat.shape[-1]
    sa, sb, dst, off = ct.destination_lists(work, nbb)
    out = torch.zeros((nbb + 1, T, T), device=dev)
    launch = build.launcher("elle_accumulate", ct._ARGTYPES)
    launch_ms, _ = cuda_ms(lambda: launch(
        R_flat.data_ptr(), sa.data_ptr(), sb.data_ptr(), dst.data_ptr(),
        off.data_ptr(), out.data_ptr(), dst.numel(), T,
        torch.cuda.current_stream().cuda_stream), 10)
    assert torch.equal(out, ct.tile_accumulate_reference(R_flat, work))
    elle_rec.update(err=err, ms=ms, plain_ms=plain_ms,
                    bound=accumulate_bound(work, R_flat.shape[0],
                                           R_flat.shape[-1]))
    emit({"phase": "elle_kernel_vs_plain", "ok": True, "cases": rows,
          "pool_sparse_rounds": sorted(rounds), "round3_kernel_ms": ms,
          "round3_launch_ms": launch_ms, "round3_plain_ms": plain_ms})


def lane_txns():
    """The JAX package's elle bench lane (bench.py `bench_elle`): 100 keys
    x 100 single-append-or-read txns, each key's txns contiguous."""
    from jepsen_etcd_demo_tpu_torch.utils.fuzz import gen_append_txns

    rng = random.Random(0xE11E)
    txns = []
    for k in range(100):
        txns.extend(gen_append_txns(rng, n_txns=100, n_keys=1, max_len=1,
                                    first_key=k))
    return txns


def timed_check(checker, history, **knobs):
    """(result, seconds, route counts, accumulate launches, the check's
    own stage seconds) of one check under the given limits."""
    from dataclasses import replace

    from jepsen_etcd_demo_tpu_torch.ops import cycles, cycles_tiled as ct
    from jepsen_etcd_demo_tpu_torch.ops.limits import limits, set_limits

    prev = set_limits(replace(limits(), **knobs))
    try:
        cycles.reset_counts()
        ct.reset_launches()
        stages: dict[str, float] = {}
        t0 = time.perf_counter()
        res = checker.check({}, history, timings=stages)
        torch.cuda.synchronize()
        return (res, time.perf_counter() - t0, dict(cycles.counts),
                ct.launches["tile_accumulate"], stages)
    finally:
        set_limits(prev)


def cycle_mutant(txns, seed: int, tries: int = 64):
    """The first mutate_append_txns mutant of txns (seeds seed, seed+1,
    ...) whose ww|wr graph has a cycle by the host Tarjan SCC: invalid,
    with a G0 or G1c cycle that the checker names from closures alone
    (G-single and G2-item need a reachability query per rw edge, a BFS
    from every node on the host route). Returns (history, its dependency
    graph ww|wr|rw bool[N, N])."""
    from jepsen_etcd_demo_tpu_torch.ops import cycles
    from jepsen_etcd_demo_tpu_torch.utils.fuzz import (append_txn_ops,
                                                       mutate_append_txns)

    for i in range(tries):
        h = append_txn_ops(mutate_append_txns(random.Random(seed + i), txns))
        ww, wr, rw = edges(h)
        if cycles._host_cycle_mask(ww | wr).any():
            return h, ww | wr | rw
    raise AssertionError("no mutant with a ww|wr cycle found")


def phase_elle(dev, elle_rec) -> None:
    """(a) The JAX elle lane's 10k-txn history through ElleChecker under
    elle_mode 1, 0 and 2: valid and equal. (b) The 12,000-txn pool history
    at default limits: the auto route takes the tiled closure and its
    kernel; the closure with the kernel and with the plain version
    converge to the same grid and stats. A mutant with a ww cycle in the
    big component: invalid, its check equal to the host Tarjan route's,
    and its component's cycle mask through the tiled closure (kernel and
    plain) equal to the host SCC's."""
    import numpy as np

    from jepsen_etcd_demo_tpu_torch.checkers import ElleChecker
    from jepsen_etcd_demo_tpu_torch.ops import cycles, cycles_tiled as ct
    from jepsen_etcd_demo_tpu_torch.utils.fuzz import append_txn_ops

    checker = ElleChecker(device=dev)
    lane = append_txn_ops(lane_txns())
    timed_check(checker, lane[:400])                        # warm-up
    routes = {}
    for name, mode in (("dense", 1), ("auto", 0), ("tiled", 2)):
        res, s, counts, n, _stages = timed_check(checker, lane,
                                                 elle_mode=mode)
        routes[name] = {"result": res, "check_s": s, "counts": counts,
                        "launches": n}
    ref = routes["dense"]["result"]
    assert ref["valid"] is True, ref
    assert all(r["result"] == ref for r in routes.values())
    assert routes["tiled"]["launches"] > 0
    ww, wr, rw = edges(lane)
    _R, _cyc, lane_stats = ct.closure_tiled(ww | wr | rw, dev)
    emit({"phase": "elle_lane", "ok": True, "txns": ref["txn_count"],
          "edge_counts": ref["edge_counts"],
          "routes": {k: {f: v for f, v in r.items() if f != "result"}
                     for k, r in routes.items()},
          "tiled_stats": lane_stats})

    # (b) The pool history, at default limits.
    h, full, sub = pool_graph()
    res, check_s, counts, n_launch, stages = timed_check(checker, h)
    assert res["valid"] is True, res["anomaly_types"]
    assert counts["graphs_tiled"] > 0 and counts["tiled_rounds_sparse"] > 0
    assert n_launch > 0, "the pool check did not launch the kernel"
    elle_rec["launches"] = n_launch

    def kernel_and_plain(adj):
        """The tiled closure of adj with the kernel and with the plain
        version: equal grids, cycle masks and stats; (cycle mask, stats,
        kernel closure s, plain closure s, the converged grid)."""
        runs = {}
        for name, acc in (("kernel", ct.tile_accumulate),
                          ("plain", ct.tile_accumulate_reference)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            R, cyc, st = ct.closure_tiled(adj, dev, accumulate=acc)
            torch.cuda.synchronize()
            runs[name] = (R, cyc, st, time.perf_counter() - t0)
        (Rk, ck, sk, tk), (Rp, cp, sp, tp) = runs["kernel"], runs["plain"]
        assert torch.equal(Rk, Rp) and sk == sp and np.array_equal(ck, cp)
        return ck, sk, tk, tp, Rk

    cyc, stats, closure_s, plain_closure_s, R = kernel_and_plain(sub)
    assert not cyc.any()
    R = ct.grid_to_matrix(R)
    dense_ms, _ = cuda_ms(lambda: torch.clamp_max(R + R @ R, 1.0), 3)
    del R

    # The mutant: the card's default route (the big component through the
    # tiled kernel, with a cycle in it) against the host Tarjan route.
    mutant, mfull = cycle_mutant(pool_txns(POOL_TXNS, POOL_SEED),
                                 POOL_MUTANT_SEED)
    bad, bad_s, bcounts, bad_launch, bad_stages = timed_check(checker,
                                                              mutant)
    assert bad["valid"] is False and {"G0", "G1c"} & set(
        bad["anomaly_types"]), bad["anomaly_types"]
    assert bcounts["graphs_tiled"] > 0 and bad_launch > 0, bcounts
    tarjan, tarjan_s, tcounts, _n, _st = timed_check(
        checker, mutant, elle_mode=0, elle_cell_budget=1 << 12)
    assert tcounts["graphs_oracle"] > 0 and tcounts["graphs_tiled"] == 0
    assert bad == tarjan, (bad["anomaly_types"], tarjan["anomaly_types"])
    msub = largest_component(mfull)
    t0 = time.perf_counter()
    host = cycles._host_cycle_mask(msub)
    host_s = time.perf_counter() - t0
    cycles.reset_counts()
    assert np.array_equal(cycles.cycle_mask(msub, device=dev), host)
    assert cycles.counts["graphs_tiled"] == 1, cycles.counts
    mcyc, mstats, mclosure_s, _plain_s, _grid = kernel_and_plain(msub)
    assert host.any() and np.array_equal(mcyc, host)
    emit({"phase": "elle_pool", "ok": True, "txns": res["txn_count"],
          "edge_counts": res["edge_counts"], "component": sub.shape[0],
          "check_s": check_s, "counts": counts, "launches": n_launch,
          "closure_stats": stats, "stages": stages,
          "closure_kernel_s": closure_s,
          "closure_plain_s": plain_closure_s,
          "dense_round_matmul_ms": dense_ms,
          "mutant": {"seed": POOL_MUTANT_SEED,
                     "anomaly_types": bad["anomaly_types"],
                     "check_s": bad_s, "counts": bcounts,
                     "launches": bad_launch, "stages": bad_stages,
                     "tarjan_check_s": tarjan_s, "tarjan_counts": tcounts,
                     "component": msub.shape[0],
                     "cycle_nodes": int(host.sum()),
                     "closure_stats": mstats,
                     "closure_kernel_s": mclosure_s,
                     "host_scc_s": host_s}})


def elle_record(elle_rec):
    rec = record("elle_accumulate", elle_rec.get("launches", 0),
                 elle_rec["err"], elle_rec["ms"], elle_rec["plain_ms"],
                 elle_rec["bound"])
    # The plain version is cuBLAS's batched product and index_add_: the
    # library's own way to compute this function.
    rec["library_ms"] = elle_rec["plain_ms"]
    return rec, elle_rec["bound"]


# -- the other models (mutex, gset, both queues, multi-register) -----------

# Phase `families`: each history through the entry point a user calls,
# on the card, its invalid mutant too. gset: 10,000 ops at 10 processes
# over values 0-4 (BASELINE.json configs[3]'s size on the gset
# workload's value domain, compose.py:244-270), with no indeterminate
# add (K = 10 at S = 32: the sweep's register route) and with three
# (seed FAMILY_SEED + 1002 at GSET_P_INFO: K = 14, the shared route).
# At p_info 0.002 the indeterminate adds pile up to K = 26 and the sort
# search took 578.9 s on the H100 (PERF.md §6), so that history is not
# run here. Mutex 1,000 ops at p_info 0.005; multi-register 1,000
# ops over 3 registers (configs[1]'s size) at MULTIREG_P_INFO, two
# indeterminate writes (at configs[1]'s 0.016 the frontier passes the
# sort search's 2^20 cap and the answer is "unknown"); the queue
# workload's shape (100 keys x 20 ops, 10 processes, fifo-queue of
# capacity 10); one unordered-queue history of 31 enqueues.
FAMILY_SEED = 0xFA0
GSET_OPS, MUTEX_OPS, MULTIREG_OPS = 10_000, 1_000, 1_000
GSET_P_INFO, MULTIREG_P_INFO = 0.0003, 0.002
QUEUE_KEYS, QUEUE_OPS = 100, 20


def mutex_history(n_ops: int, n_procs: int, p_info: float, seed: int):
    """A valid mutex history from the port's _gen_history over a
    simulated lock: an acquire is granted when the lock is free and a
    release when it is held, else the op fails; either may end
    indeterminate."""
    from jepsen_etcd_demo_tpu_torch.utils.fuzz import _gen_history

    def choose(rng):
        return ("acquire" if rng.random() < 0.5 else "release"), None

    def linearize(sim, f, _v):
        want = f == "acquire"
        if sim["locked"] == want:
            return False, None
        sim["locked"] = want
        return True, None

    return _gen_history(random.Random(seed), n_ops, n_procs, choose,
                        linearize, lambda f: True, {"locked": False}, p_info)


def oracle_valid(model, h):
    """(valid, dead_step) of the host oracle on h (after the model's op
    translation)."""
    from jepsen_etcd_demo_tpu_torch.checkers import Linearizable
    from jepsen_etcd_demo_tpu_torch.checkers.oracle import check_events_oracle

    enc = Linearizable(model, device="cpu").encode(h)
    o = check_events_oracle(enc, model)
    return o.valid, o.dead_step(enc)


def double_grant(model, h):
    """The first of h's ok releases whose turning into :fail the host
    oracle finds not linearizable: the lock is then granted while held."""
    from jepsen_etcd_demo_tpu_torch.ops.op import Op

    for i, op in enumerate(h):
        if op.type == "ok" and op.f == "release":
            m = [Op(**vars(o)) for o in h]
            m[i].type = "fail"
            if not oracle_valid(model, m)[0]:
                return m
    raise AssertionError("no double grant is invalid")


def certified_mutant(model, h, family: str, seed: int):
    """The first mutate_family_history mutant of h (seeds seed, seed+1,
    ...) that is not linearizable: by the host oracle, or, for gset, by
    construction (an element an ok add put in the set before the read
    began is missing from the read; the oracle cannot follow 10,000 ops
    with many indeterminate adds)."""
    from jepsen_etcd_demo_tpu_torch.utils.fuzz import mutate_family_history

    for i in range(200):
        m = mutate_family_history(random.Random(seed + i), h, family)
        if family != "gset":
            if not oracle_valid(model, m)[0]:
                return m
            continue
        j = next(j for j, (a, b) in enumerate(zip(h, m))
                 if a.value != b.value)
        gone = set(h[j].value) - set(m[j].value)
        inv = max(k for k in range(j) if h[k].process == h[j].process
                  and h[k].type == "invoke")
        if gone and any(h[k].type == "ok" and h[k].f == "add"
                        and h[k].value in gone for k in range(inv)):
            return m
    raise AssertionError(f"no invalid {family} mutant")


@functools.cache
def family_histories():
    """{label: (model name, valid history, invalid mutant)} of phase
    `families`."""
    from jepsen_etcd_demo_tpu_torch.models import get_model
    from jepsen_etcd_demo_tpu_torch.utils.fuzz import (gen_gset_history,
                                                       gen_multireg_history,
                                                       gen_queue_history)

    s = FAMILY_SEED
    out = {}
    for label, p_info, seed in (("gset-register-route", 0.0, s),
                                ("gset-shared-route", GSET_P_INFO,
                                 s + 1002)):
        h = gen_gset_history(random.Random(seed), n_ops=GSET_OPS,
                             n_procs=10, value_range=5, p_info=p_info)
        out[label] = ("gset", h, certified_mutant(get_model("gset"), h,
                                                  "gset", seed + 1))
    h = mutex_history(MUTEX_OPS, 10, 0.005, s + 2000)
    out["mutex"] = ("mutex", h, double_grant(get_model("mutex"), h))
    h = gen_multireg_history(random.Random(s + 3002), n_ops=MULTIREG_OPS,
                             n_procs=10, n_registers=3, value_range=5,
                             p_info=MULTIREG_P_INFO)
    out["multi-register"] = ("multi-register", h, certified_mutant(
        get_model("multi-register"), h, "multi-register", s + 3003))
    h = gen_queue_history(random.Random(s + 4000), n_ops=80, n_procs=10,
                          fifo=False)
    assert sum(op.type == "invoke" and op.f == "enqueue" for op in h) == 31
    out["unordered-queue"] = ("unordered-queue", h, certified_mutant(
        get_model("unordered-queue"), h, "unordered-queue", s + 4001))
    return out


def queue_workload():
    """(per-key histories, keyed history, mutated key): the queue
    workload's shape, one key replaced by an invalid mutant."""
    from jepsen_etcd_demo_tpu_torch.models import get_model
    from jepsen_etcd_demo_tpu_torch.utils.fuzz import (gen_queue_history,
                                                       interleave_keyed)

    rng = random.Random(FAMILY_SEED + 77)
    per_key = [gen_queue_history(rng, n_ops=QUEUE_OPS, n_procs=10,
                                 max_enqueues=10) for _ in range(QUEUE_KEYS)]
    bad = 3
    per_key[bad] = certified_mutant(get_model("fifo-queue"), per_key[bad],
                                    "fifo-queue", FAMILY_SEED + 78)
    return per_key, interleave_keyed(per_key), bad


# The words each model's failed_op starts with (its op language).
FAILED_OP_WORDS = {"gset": ("add(", "read ->"),
                   "mutex": ("acquire", "release"),
                   "multi-register": ("write(r", "read(r"),
                   "unordered-queue": ("enqueue(", "dequeue ->"),
                   "fifo-queue": ("enqueue(", "dequeue ->")}


def family_row(name, lin, h):
    """One check through `lin` (general_check) with the geometry and the
    route: S and the sweep's table route on the dense route, the sort
    key's state bits on the general path."""
    from jepsen_etcd_demo_tpu_torch.ops import wgl2, wgl3

    row, res, enc = general_check(lin, h)
    cfg = wgl3.dense_config(lin.model, row["tight_k"], enc.max_value)
    row["model"] = name
    if cfg is not None:
        row["n_states"] = cfg.n_states
        row["route"] = ("dense, register route" if register_route(cfg)
                        else "dense, shared route")
    else:
        bits = wgl2.make_config(lin.model, row["sort_k"], 1,
                                enc.max_value).state_bits
        row["route"] = f"general ({'packed' if bits else 'unpacked'} keys)"
        row["state_bits"] = bits
    return row, res, enc


def phase_families(dev) -> None:
    """The five other models on the card through Linearizable and
    IndependentChecker: every valid history checks
    valid, every mutant invalid with a failed_op in its model's language;
    the verdicts of histories of at most 1,000 ops equal the host
    oracle's, the dense gset ones the whole-scan kernel's."""
    from jepsen_etcd_demo_tpu_torch.checkers import (IndependentChecker,
                                                     Linearizable)
    from jepsen_etcd_demo_tpu_torch.ops import wgl3_kernels as wk
    from jepsen_etcd_demo_tpu_torch.utils.fuzz import interleave_keyed

    fields = ("valid", "dead_step", "max_frontier", "configs_explored")
    rows = []
    Linearizable("gset", device=dev).check(
        {}, family_histories()["gset-register-route"][1][:200])  # warm-up
    for label, (name, h, mutant) in family_histories().items():
        lin = Linearizable(name, device=dev)
        for kind, hist in (("valid", h), ("mutant", mutant)):
            row, res, enc = family_row(name, lin, hist)
            row.update(history=label, kind=kind)
            want = kind == "valid"
            assert res["valid"] is want, (label, kind, res)
            if not want and res.get("witness") == "skipped":
                # Every witness rung passed its effort cap (a frontier of
                # thousands of configs): the JAX package's ladder, too,
                # records the death point without a failed op then.
                row["witness"] = res["witness_detail"]
            elif not want:
                assert res["failed_op"].startswith(FAILED_OP_WORDS[name]), res
                row["failed_op"] = res["failed_op"]
            if label.startswith("gset-"):
                assert row["route"] == "dense, " + label[5:].replace(
                    "-", " "), row
            if "n_states" in row:
                assert row["launches"]["dense_sweep"] > 0, row
                if name == "gset":
                    scan, _ = whole_scan(lin.model, enc, dev)
                    assert all(res[f] == scan[f] for f in fields), \
                        (label, res, scan)
            if row["ops"] <= 1_000:
                o_valid, o_dead = oracle_valid(lin.model, hist)
                assert (o_valid, o_dead) == (res["valid"],
                                             res["dead_step"]), (label, res)
            rows.append(row)
            emit({"families_row": row})

    per_key, keyed, bad = queue_workload()
    checker = IndependentChecker(Linearizable("fifo-queue", device=dev))
    checker.check({}, interleave_keyed(per_key[:10]))         # warm-up
    torch.cuda.synchronize()
    wk.reset_launches()
    t0 = time.perf_counter()
    got = checker.check({}, keyed)
    torch.cuda.synchronize()
    check_s = time.perf_counter() - t0
    invalid = sorted(k for k, r in got["results"].items()
                     if r["valid"] is False)
    assert got["key_count"] == QUEUE_KEYS and invalid == [str(bad)], got
    for k, h in enumerate(per_key):
        r = got["results"][str(k)]
        assert (r["valid"], r["dead_step"]) == oracle_valid(
            checker.sub_checker.model, h), (k, r)
    failed = got["results"][str(bad)]["failed_op"]
    assert failed.startswith(FAILED_OP_WORDS["fifo-queue"]), failed
    emit({"phase": "families", "ok": True, "histories": len(rows) // 2,
          "queue_workload": {"keys": QUEUE_KEYS, "ops_per_key": QUEUE_OPS,
                             "check_s": check_s, "invalid_keys": invalid,
                             "failed_op": failed,
                             "backend": got["results"]["0"]["backend"],
                             "launches": dict(wk.launches)}})


def phase_encode(dev) -> None:
    """The device encoder (ops/encode_device.py) bit-identical to the host
    expansion on the corpus, the 100k-op history and each family history,
    with the host and device seconds of each after a warm-up; then the
    corpus check under encode_mode=2 beside the default."""
    from dataclasses import replace

    import numpy as np

    from jepsen_etcd_demo_tpu_torch.checkers import Linearizable
    from jepsen_etcd_demo_tpu_torch.models import CASRegister
    from jepsen_etcd_demo_tpu_torch.ops import wgl3_kernels as wk
    from jepsen_etcd_demo_tpu_torch.ops.encode import (
        _encode_return_steps_host)
    from jepsen_etcd_demo_tpu_torch.ops.encode_device import (
        encode_return_steps_device)
    from jepsen_etcd_demo_tpu_torch.ops.limits import limits, set_limits

    def both(encs):
        encode_return_steps_device(encs[0], dev)              # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = [_encode_return_steps_host(e) for e in encs]
        host_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = [encode_return_steps_device(e, dev) for e in encs]
        torch.cuda.synchronize()
        dev_s = time.perf_counter() - t0
        for a, b in zip(host, got):
            assert a.n_steps == b.n_steps
            for f in ("slot_tabs", "slot_active", "targets"):
                x, y = getattr(a, f), getattr(b, f)
                assert x.dtype == y.dtype and np.array_equal(x, y), f
        return {"histories": len(encs),
                "steps": sum(s.n_steps for s in host),
                "host_s": host_s, "device_s": dev_s}

    model = CASRegister()
    _hists, corpus, _menc, _mutants = make_corpus()
    rows = {"corpus": both(corpus)}
    _h, enc, _cfg, _rs, _s = long_setup(model, LONG_OPS, 10,
                                        0x10C0 + LONG_OPS)
    rows["long_100k"] = both([enc])
    for label, (name, h, _m) in family_histories().items():
        rows[label] = both([Linearizable(name, device="cpu").encode(h)])
    per_key, _keyed, _bad = queue_workload()
    lin = Linearizable("fifo-queue", device="cpu")
    rows["queue_workload"] = both([lin.encode(h) for h in per_key])

    def corpus_check(mode: int):
        prev = set_limits(replace(limits(), encode_mode=mode))
        try:
            t0 = time.perf_counter()
            res, _ = wk.check_batch_encoded_auto(corpus, model, dev)
            torch.cuda.synchronize()
            return time.perf_counter() - t0, res
        finally:
            set_limits(prev)

    corpus_check(2)                                           # warm-up
    times = {0: [], 2: []}
    for mode in (0, 2, 2, 0):
        sec, res = corpus_check(mode)
        times[mode].append(sec)
        if mode == 0:
            want = res
        assert [r["valid"] for r in res] == [True] * len(corpus)
    assert [r["max_frontier"] for r in res] == \
        [r["max_frontier"] for r in want]
    emit({"phase": "encode", "ok": True, "bit_identical": rows,
          "corpus_check_s": {"encode_mode=0": times[0],
                             "encode_mode=2": times[2]}})


def analyze_all(paths: dict) -> dict:
    """`cli analyze` on each {name: path}, the processes side by side:
    {name: (exit code, stdout, stderr)}."""
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "jepsen_etcd_demo_tpu_torch.cli", "analyze",
         str(path)], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for name, path in paths.items()}
    out = {}
    try:
        for name, p in procs.items():
            stdout, stderr = p.communicate(timeout=600)
            out[name] = (p.returncode, stdout, stderr)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def set_history(n_adds: int, seed: int, lose: bool):
    """A set workload run: adds 0..n_adds-1 from 10 processes (about 2%
    indeterminate, half of those landing), then one final read of what
    landed; with `lose`, the final read misses the first acknowledged
    add."""
    from jepsen_etcd_demo_tpu_torch.ops.op import Op

    rng = random.Random(seed)
    h, landed = [], []
    for v in range(n_adds):
        typ = "info" if rng.random() < 0.02 else "ok"
        h += [Op(type="invoke", f="add", value=v, process=v % 10),
              Op(type=typ, f="add", value=v, process=v % 10)]
        if typ == "ok" or rng.random() < 0.5:
            landed.append(v)
    if lose:
        landed.remove(next(op.value for op in h if op.type == "ok"))
    return h + [Op(type="invoke", f="read", value=None, process=10),
                Op(type="ok", f="read", value=landed, process=10)]


def cli_family_runs(seed: int) -> dict:
    """{name: (workload, history)} of phase_cli's runs of the other
    workloads, each valid and invalid."""
    from jepsen_etcd_demo_tpu_torch.models import get_model
    from jepsen_etcd_demo_tpu_torch.utils.fuzz import (gen_gset_history,
                                                       gen_multireg_history,
                                                       gen_queue_history,
                                                       interleave_keyed)

    runs = {"set_valid": ("set", set_history(200, seed, False)),
            "set_invalid": ("set", set_history(200, seed, True))}
    h = gen_gset_history(random.Random(seed + 1), n_ops=200, n_procs=10,
                         p_info=0.0)
    runs["gset_valid"] = ("gset", h)
    runs["gset_invalid"] = ("gset", certified_mutant(get_model("gset"), h,
                                                     "gset", seed + 2))
    h = mutex_history(200, 10, 0.005, seed + 3)
    runs["mutex_valid"] = ("mutex", h)
    runs["mutex_invalid"] = ("mutex", double_grant(get_model("mutex"), h))
    h = gen_multireg_history(random.Random(seed + 4), n_ops=200, n_procs=10,
                             p_info=0.016)
    runs["multiregister_valid"] = ("multiregister", h)
    runs["multiregister_invalid"] = ("multiregister", certified_mutant(
        get_model("multi-register"), h, "multi-register", seed + 5))
    rng = random.Random(seed + 6)
    per_key = [gen_queue_history(rng, n_ops=QUEUE_OPS, n_procs=10)
               for _ in range(10)]
    runs["queue_valid"] = ("queue", interleave_keyed(per_key))
    per_key[4] = certified_mutant(get_model("fifo-queue"), per_key[4],
                                  "fifo-queue", seed + 7)
    runs["queue_invalid"] = ("queue", interleave_keyed(per_key))
    return runs


def phase_cli() -> None:
    """`cli analyze` on stored run directories (history.jsonl, and a
    test.json naming the workload except for the register runs) of
    register, append, set, gset, mutex, multiregister and queue runs,
    valid and invalid: exit codes 0 and 1, only {"valid"} on stdout, the
    checkers' fields from the results.json analyze writes."""
    from jepsen_etcd_demo_tpu_torch.ops.op import history_to_jsonl
    from jepsen_etcd_demo_tpu_torch.utils.fuzz import (append_txn_ops,
                                                       gen_register_history)

    rng = random.Random(0xC11)
    valid = gen_register_history(rng, n_ops=150, n_procs=10, p_info=0.002)
    invalid = invalid_mutant(valid, 0xC12)
    txns = pool_txns(600, 0xC13)
    append_bad, _full = cycle_mutant(txns, 0xC14)
    runs = {"valid": (None, valid), "invalid": (None, invalid),
            "append_valid": ("append", append_txn_ops(txns)),
            "append_invalid": ("append", append_bad),
            **cli_family_runs(0xC15)}
    want = {name: 0 if name.endswith("valid") and "invalid" not in name
            else 1 for name in runs}
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for name, (workload, h) in runs.items():
            paths[name] = run = Path(tmp) / name
            run.mkdir()
            (run / "history.jsonl").write_text(history_to_jsonl(h))
            if workload is not None:
                (run / "test.json").write_text(
                    json.dumps({"workload": workload}))
        got = analyze_all(paths)
        results = {name: json.loads((path / "results.json").read_text())
                   for name, path in paths.items()}
    for name, (rc, stdout, stderr) in got.items():
        assert rc == want[name], (name, rc, stdout[-2000:], stderr[-2000:])
        assert json.loads(stdout) == {"valid": rc == 0}, (name, stdout)
        res = results[name]
        assert res["valid"] is (rc == 0) and res["perf"]["valid"], name
        out = res["indep"]
        if name in ("invalid", "gset_invalid", "mutex_invalid"):
            assert out["linear"]["failed_op"], out
        if name == "multiregister_invalid":
            # A frontier of thousands of configs may pass every witness
            # rung's effort cap: then the witness is "skipped".
            assert (out["linear"].get("failed_op")
                    or out["linear"]["witness"] == "skipped"), out
        if name.startswith("append"):
            assert out["elle"]["backend"] == "torch-closure-cuda"
        if name.startswith("queue"):
            assert out["key_count"] == 10, out
        if name == "set_invalid":
            assert out["lost_count"] == 1, out
    emit({"phase": "cli_analyze", "ok": True,
          "exit_codes": {name: r[0] for name, r in got.items()}})


# Phase `test`: whole Jepsen tests through `cli test --fake`, each
# (name, flags, exit code). (a) is the tutorial default (BASELINE.json
# configs[0]) and (b) configs[3]'s size over many keys, both under the
# partition nemesis: a partition leaves some of their keys with tens of
# forever-pending writes, past the dense tables (the sort search decides
# them). The short runs' recovery wait is 1 s. The fake cluster records
# (b) as fast as the host's timers wake, not at the rate asked for: at
# 3000 Hz 9,704-13,364 ops in 6 s on the H100 machines' hosts, and 7,458
# on one, below TEST_MIN_OPS, so (b) asks for 4500 Hz. It keeps 6 s, so
# that its partition, which starts at 5 s, lasts 1 s: a 9 s run tripled
# the keys the sort search decides and quadrupled the CPU re-check.
TEST_RUNS = (
    ("a", ["-w", "register", "--time-limit", "30", "--rate", "10",
           "--concurrency", "10", "--recovery-wait", "1", "--seed", "1"], 0),
    ("b", ["-w", "register", "--time-limit", "6", "--rate", "4500",
           "--ops-per-key", "100", "--recovery-wait", "1", "--seed", "2"], 0),
    *((name, [*flags, "--time-limit", "2", "--recovery-wait", "1"], rc)
      for name, flags, rc in (
          ("c", ["-w", "register", "--stale-read-prob", "0.8",
                 "--no-nemesis", "--rate", "200"], 1),
          ("d", ["-w", "set", "--rate", "100"], 0),
          ("d_lost", ["-w", "set", "--rate", "100",
                      "--lost-write-prob", "0.3"], 1),
          *((f"e_{w}", ["-w", w, "--rate", "100",
                        *(["--nemesis", "noop"]
                          if w in ("mutex", "multiregister") else [])], 0)
            for w in ("queue", "multiregister", "gset", "mutex", "append",
                      "txnregister")),
          ("f_txnregister", ["-w", "txnregister", "--rate", "100",
                             "--stale-read-prob", "0.5", "--elle-realtime"],
           1),
          ("f_queue", ["-w", "queue", "--rate", "100",
                       "--reorder-prob", "0.5"], 1))),
)
TEST_MIN_OPS = {"b": 8_000}
LINEAR_FIELDS = ("valid", "dead_step", "max_frontier", "configs_explored",
                 "op_count")


def verdict_fields(res: dict) -> dict:
    """What analyze must reproduce of a run's results.json: the top-level
    valid and, per key (or for the whole history), the linear fields, or
    the elle / set checker's verdict."""
    indep = res["indep"]
    out = {"valid": res["valid"], "indep_valid": indep["valid"]}
    if "results" in indep:
        out["linear"] = {k: {f: r["linear"].get(f) for f in LINEAR_FIELDS}
                         for k, r in indep["results"].items()}
    elif "linear" in indep:
        out["linear"] = {f: indep["linear"].get(f) for f in LINEAR_FIELDS}
    elif "elle" in indep:
        out["elle"] = {f: indep["elle"].get(f)
                       for f in ("valid", "anomaly_types", "txn_count")}
    else:
        out["set"] = {f: indep.get(f) for f in ("lost_count", "ok_count")}
    return out


def key_routes(res: dict) -> dict:
    """{backend: keys} of a keyed run's linearizability results."""
    routes: dict = {}
    for r in res["indep"].get("results", {}).values():
        b = r["linear"].get("backend", "none")
        routes[b] = routes.get(b, 0) + 1
    return routes


def run_cli(argv: list[str]) -> tuple[int, list[str]]:
    """cli.main(argv) in this process: (exit code, its stdout lines)."""
    import contextlib
    import io

    from jepsen_etcd_demo_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue().splitlines()


@contextlib.contextmanager
def timed_checks(dev, composer: str = "fake_test"):
    """compose.<composer> (fake_test or etcd_test) patched so that each
    test it builds times its checker's check (ending in a device sync):
    yields the list the seconds are appended to."""
    from jepsen_etcd_demo_tpu_torch import compose

    make = getattr(compose, composer)
    seconds: list[float] = []

    def timed_make(*args, **kw):
        test = make(*args, **kw)
        check = test["checker"].check

        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return check(*args, **kw)
            finally:
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)

        test["checker"].check = timed
        return test

    setattr(compose, composer, timed_make)
    try:
        yield seconds
    finally:
        setattr(compose, composer, make)


def cli_test(root: Path, name: str, flags: list[str], dev,
             seconds: list[float]):
    """One `cli test --fake` run in this process, the launch counters set
    to 0 just before it: (exit code, its printed line, its results.json,
    its run directory, the `test_run` row)."""
    from jepsen_etcd_demo_tpu_torch.ops import wgl3_kernels as wk
    from jepsen_etcd_demo_tpu_torch.store import Store

    store = root / name
    argv = ["test", "--fake", *flags, "--store", str(store), "--device",
            dev.type]
    wk.reset_launches()
    seconds.clear()
    t0 = time.perf_counter()
    rc, lines = run_cli(argv)
    wall_s = time.perf_counter() - t0
    launches = dict(wk.launches)
    line = json.loads(lines[-1])
    run_dir = Store(store).latest().path
    res = json.loads((run_dir / "results.json").read_text())
    row = {"workload": flags[1], "flags": flags, "rc": rc,
           "valid": line["valid"], "op_count": line["op_count"],
           "run_seconds": line["run_seconds"], "wall_s": wall_s,
           "check_s": seconds[0],
           "key_count": res["indep"].get("key_count"),
           "routes": key_routes(res), "launches": launches}
    emit({"phase": "test_run", "name": name, **row})
    files = {p.name for p in run_dir.iterdir()}
    assert {"test.json", "history.jsonl", "results.json",
            "jepsen.log"} <= files, files
    return rc, line, res, run_dir, row


def recheck(name: str, run_dir: Path, rc: int, line: dict, want: dict,
            fields=verdict_fields, device: str = "cpu") -> float:
    """`analyze --device <device>` of a run directory: the run's exit code
    and verdict, and `fields` of the rewritten results.json equal to
    `want`; returns its seconds."""
    t0 = time.perf_counter()
    arc, alines = run_cli(["analyze", str(run_dir), "--device", device])
    seconds = time.perf_counter() - t0
    again = json.loads((run_dir / "results.json").read_text())
    assert arc == rc and json.loads(alines[-1]) == {
        "valid": line["valid"]}, (name, arc, alines)
    assert fields(again) == want, (name, again, want)
    emit({"phase": "test_recheck", "name": name, "device": device,
          "seconds": seconds})
    return seconds


def phase_test(dev, root: Path) -> dict:
    """Whole tests through the port's `test` verb (TEST_RUNS): the fake
    cluster records each history, the card checks it, the store under
    `root`/<run name> keeps the run directory (phase `replay` replays the
    stores of runs (a) and (b)). Each run's check is timed by wrapping the
    test's checker; the dense sweep's launches are counted per run. Every
    run directory is re-checked by `analyze --device cpu` (the plain
    versions), which must give the same verdicts and linear fields; run
    (c) also goes through `python -m jepsen_etcd_demo_tpu_torch.cli test`.
    Returns the rows by run name, each with its store."""
    rows = {}
    with timed_checks(dev) as seconds:
        for name, flags, want_rc in TEST_RUNS:
            rc, line, res, run_dir, row = cli_test(root, name, flags, dev,
                                                   seconds)
            assert rc == want_rc, (name, row, res)
            assert line["op_count"] >= TEST_MIN_OPS.get(name, 50), row
            if name in ("a", "b"):
                assert row["launches"]["dense_sweep"] >= 1, row
            if name == "c":
                bad = [r for r in res["indep"]["results"].values()
                       if r["valid"] is False]
                assert bad and bad[0]["linear"]["failed_op"], res
            row["recheck_s"] = recheck(name, run_dir, rc, line,
                                       verdict_fields(res))
            row["store"] = str(root / name)
            rows[name] = row
        sub = subprocess.run(
            [sys.executable, "-m", "jepsen_etcd_demo_tpu_torch.cli",
             "test", "--fake", *TEST_RUNS[2][1], "--store",
             str(root / "c_module"), "--device", dev.type],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        assert sub.returncode == 1, sub.stderr[-3000:]
        assert json.loads(sub.stdout.splitlines()[-1])["valid"] is False
    emit({"phase": "test", "ok": True,
          "exit_codes": {n: r["rc"] for n, r in rows.items()},
          "check_s": {n: rows[n]["check_s"] for n in ("a", "b")},
          "op_count": {n: rows[n]["op_count"] for n in ("a", "b")},
          "key_count": {n: rows[n]["key_count"] for n in ("a", "b")}})
    return rows


# Phase `replay`: corpus replay of a results store through `cli corpus`,
# every dense launch through the length-bucketed scheduler (sched/).
# (r1) the BASELINE.json configs[4] store ("Corpus replay: 1024 stored
# histories from store/"): make_corpus()'s histories as register runs of
# REPLAY_KEYS keys, written through the port's Store and
# write_encoded_tensor, with REPLAY_LONG_RUNS runs of keys at
# REPLAY_LONG_OPS ops (more step buckets; p_info 0 keeps their pending
# sets, and so their tables, as narrow as the corpus's) and one run of
# the first REPLAY_KEYS mutants; (r2) the corpus's runs (the long runs,
# stored without a JSONL history, moved out: their ~384,000 entries
# would double the phase's host time) encoded from the JSONL with a cold
# encode cache
# (`--reencode`, which never reads the cache), then, their tensors
# moved away, from the warm cache; (r3) phase `test`'s stores of runs
# (a) and (b).
REPLAY_KEYS = 16
REPLAY_LONG_RUNS, REPLAY_LONG_OPS, REPLAY_LONG_SEED = 4, (1_000, 5_000), 0x5EED
# The bucket launch held against the plain version: HOLD_REAL histories
# and HOLD_PADS all-pad lanes (b = 13, not a multiple of 4).
HOLD_REAL, HOLD_PADS = 10, 3


def write_replay_run(run, name: str, hists, encs) -> str:
    """One register run of len(hists) keys into the port's RunDir `run`:
    test.json, history.jsonl (the keys interleaved as (key, value) ops;
    not for the long runs, which (r2) leaves out and (r1) reads from
    their tensors), results.json with its key count, and each key's
    encoded tensor. Returns the run directory."""
    from jepsen_etcd_demo_tpu_torch.store import write_encoded_tensor
    from jepsen_etcd_demo_tpu_torch.utils.fuzz import interleave_keyed

    run.write_test({"name": name, "workload": "register"})
    if "long" not in name:
        run.write_history(interleave_keyed(hists))
    run.write_results({"indep": {"key_count": len(hists)}})
    for k, e in enumerate(encs):
        write_encoded_tensor(run.path, k, e, "cas-register")
    return str(run.path)


def replay_store(store: Path) -> dict:
    """The (r1) store; returns {run name: run directory}."""
    from jepsen_etcd_demo_tpu_torch.ops.encode import encode_register_history
    from jepsen_etcd_demo_tpu_torch.store import Store
    from jepsen_etcd_demo_tpu_torch.utils.fuzz import gen_register_history

    hists, enc, menc, mutants = make_corpus()
    rng = random.Random(REPLAY_LONG_SEED)
    longs = [gen_register_history(rng, n_ops=rng.randint(*REPLAY_LONG_OPS),
                                  n_procs=10, p_info=0.0)
             for _ in range(REPLAY_LONG_RUNS * REPLAY_KEYS)]
    lenc = [encode_register_history(h, k_slots=32) for h in longs]
    K = REPLAY_KEYS
    groups = [
        *((f"replay-{i // K:02d}", hists[i:i + K], enc[i:i + K])
          for i in range(0, len(hists), K)),
        *((f"replay-long-{i // K}", longs[i:i + K], lenc[i:i + K])
          for i in range(0, len(longs), K)),
        ("replay-mutants", mutants[:K], menc[:K])]
    # The run directories (and the store's symlinks) one by one, their
    # files from threads: the tensors' zlib compression releases the
    # interpreter lock.
    run_dirs = [Store(store).new_run(g[0]) for g in groups]
    with ThreadPoolExecutor(max_workers=8) as pool:
        paths = list(pool.map(lambda rg: write_replay_run(rg[0], *rg[1]),
                              zip(run_dirs, groups)))
    return {g[0]: p for g, p in zip(groups, paths)}


def corpus_cli(store, dev, *flags):
    """`cli corpus --device <dev>` in this process: (exit code, its JSON,
    seconds)."""
    t0 = time.perf_counter()
    rc, lines = run_cli(["corpus", str(store), "--device", dev.type, *flags])
    return rc, json.loads(lines[-1]), time.perf_counter() - t0


def corpus_entries(store, dev) -> list:
    """[(run, key, EncodedHistory)] of the store's register runs, in the
    order `cli corpus` checks them."""
    from jepsen_etcd_demo_tpu_torch import cli

    by_model, _runs, _tensors = cli.corpus_entries(argparse.Namespace(
        store_root=str(store), model="cas-register", reencode=False), dev)
    return by_model["cas-register"]


def hold_bucket_launch(dev, model) -> dict:
    """One bucket launch as the scheduler makes it, with b = HOLD_REAL +
    HOLD_PADS lanes (not a multiple of 4) at a step count a bucket above
    every real length: exactly equal to the plain version; each pad lane
    survives with no work and each real lane equals the pre-scheduler
    route's fields. Not counted: the main path's counts are set to 0
    after it."""
    from jepsen_etcd_demo_tpu_torch.ops import wgl3, wgl3_kernels as wk
    from jepsen_etcd_demo_tpu_torch.ops.encode import (encode_return_steps,
                                                       reslot_events)
    from jepsen_etcd_demo_tpu_torch.sched import engine

    _h, enc, menc, _m = make_corpus()
    pick = [e for pair in zip(enc, menc) for e in pair][:HOLD_REAL]
    k = max(wgl3.tight_k_slots(e) for e in pick)
    cfg = wgl3.dense_config(model, k, max(e.max_value for e in pick))
    steps = [encode_return_steps(reslot_events(e, k) if e.k_slots != k
                                 else e, dev) for e in pick]
    r = wgl3.step_bucket(2 * max(s.n_steps for s in steps) + 1)
    b = HOLD_REAL + HOLD_PADS
    padded = steps + [engine._pad_rs(k)] * HOLD_PADS
    ln, tg, cm = wk.prepare_colmask(model, cfg,
                                    *wgl3.stack_steps3(padded, r, dev))
    row0 = wgl3.init_row(model, cfg)
    got = engine.launch_bucket(model, cfg, padded, r, dev)
    want = wk.sweep_reference(ln, tg, cm, cfg, row0)
    assert torch.equal(got, wk.dense_sweep(ln, tg, cm, cfg, row0))
    err = int((got.long() - want.long()).abs().max().item())
    assert err == 0, f"bucket launch and plain version differ by {err}"
    assert got[HOLD_REAL:].tolist() == [[1, 0, -1, 1, 0]] * HOLD_PADS
    auto, _kname = wk.check_batch_encoded_auto(pick, model, dev)
    rows = wgl3.unpack_np(got.cpu().numpy())
    for i, a in enumerate(auto):
        assert (bool(rows["survived"][i]), int(rows["dead_step"][i]),
                int(rows["max_frontier"][i]),
                int(rows["configs_explored"][i])) == (
            a["survived"], a["dead_step"], a["max_frontier"],
            a["configs_explored"]), i
    return {"b": b, "r": r, "k_slots": k, "n_states": cfg.n_states,
            "invalid": int((~rows["survived"][:HOLD_REAL]).sum()),
            "max_abs_err": err}


def corpus_steps(entries, model, dev):
    """The scheduler's view of the store's dense histories: (shared
    geometry, each history's return steps under it)."""
    from jepsen_etcd_demo_tpu_torch.ops import wgl3
    from jepsen_etcd_demo_tpu_torch.ops.encode import (encode_return_steps,
                                                       reslot_events)

    encs = [e for _r, _k, e in entries]
    k = max(wgl3.tight_k_slots(e) for e in encs)
    cfg = wgl3.dense_config(model, k, max(e.max_value for e in encs))
    return cfg, [encode_return_steps(reslot_events(e, k) if e.k_slots != k
                                     else e, dev) for e in encs]


def bucket_record(cfg, steps, model, dev, launches: int):
    """The kernels-line record of the replay's largest bucket launch, at
    the main path's shape (all-pad lanes included): its inputs as the
    scheduler stacks them, the kernel exact against its plain version,
    timed, with its bound."""
    from jepsen_etcd_demo_tpu_torch.ops import wgl3, wgl3_kernels as wk
    from jepsen_etcd_demo_tpu_torch.ops.limits import limits
    from jepsen_etcd_demo_tpu_torch.sched import engine

    k = cfg.k_slots
    buckets: dict = {}
    for s, r in zip(steps, engine.assign_step_buckets(
            [s.n_steps for s in steps])):
        buckets.setdefault(r, []).append(s)
    r, part = max(buckets.items(), key=lambda kv: len(kv[1]))
    chunk = max(1, limits().stack_element_budget // (r * (k * 5 + 1)))
    part = part[:chunk]
    b = engine._batch_bucket(len(part), chunk)
    padded = part + [engine._pad_rs(k)] * (b - len(part))
    inputs = wk.prepare_colmask(model, cfg,
                                *wgl3.stack_steps3(padded, r, dev))
    rec, bnd = kernel_record("wgl3_sweep[replay]", cfg, inputs,
                             wgl3.init_row(model, cfg), launches, reps=20)
    rec["shape"] = {"b": b, "real": len(part), "r": r, "k_slots": k,
                    "n_states": cfg.n_states}
    return rec, bnd


def replay_tests(dev, test_rows: dict) -> dict:
    """(r3): `cli corpus` over phase `test`'s stores of runs (a) and (b):
    every key's verdict equals the run's results.json, the keys of the
    sort tiers included; {} when phase `test` did not run."""
    out = {}
    for name in ("a", "b"):
        store = test_rows.get(name, {}).get("store")
        if store is None:
            continue
        run = next(Path(store).glob("*/*/results.json")).parent
        res = json.loads((run / "results.json").read_text())["indep"]
        bad = {k for k, r in res["results"].items()
               if r["linear"]["valid"] is not True}
        rc, got, seconds = corpus_cli(store, dev)
        assert rc == (1 if bad else 0), (name, got)
        assert got["keys"] == got["from_tensors"] == res["key_count"], got
        assert {e["key"] for e in got["invalid"]} == bad, (name, got)
        routes = key_routes({"indep": res})
        out[name] = {"keys": got["keys"], "invalid": len(bad),
                     "routes": routes, "launches": got["launches"],
                     "kernel": got["kernel"], "wall_s": got["wall_s"],
                     "cli_s": seconds}
    return out


def phase_replay(dev, kernels, test_rows: dict) -> None:
    """Corpus replay (r1)-(r3) through `cli corpus` on the card; see the
    comment above REPLAY_KEYS."""
    from jepsen_etcd_demo_tpu_torch import sched
    from jepsen_etcd_demo_tpu_torch.checkers.oracle import check_events_oracle
    from jepsen_etcd_demo_tpu_torch.models import CASRegister
    from jepsen_etcd_demo_tpu_torch.ops import wgl3, wgl3_kernels as wk
    from jepsen_etcd_demo_tpu_torch.sched import engine
    from jepsen_etcd_demo_tpu_torch.store import encode_cache

    model = CASRegister()
    hold = hold_bucket_launch(dev, model)
    with tempfile.TemporaryDirectory() as tmp:
        store = Path(tmp) / "store"
        t0 = time.perf_counter()
        runs = replay_store(store)
        setup_s = time.perf_counter() - t0

        # (r1): the main path, its launch counts from 0.
        wk.reset_launches()
        rc, out, cli_s = corpus_cli(store, dev)
        launches = dict(wk.launches)
        n_keys = len(runs) * REPLAY_KEYS
        assert rc == 1 and out["valid"] is False, out
        assert out["keys"] == out["from_tensors"] == n_keys, out
        assert out["runs"] == len(runs) and out["kernel"] == \
            engine.kernel_label(dev), out
        assert launches["dense_sweep"] == out["launches"] > 0, launches
        _h, _e, menc, _m = make_corpus()
        rejected = {str(i) for i, e in enumerate(menc[:REPLAY_KEYS])
                    if not check_events_oracle(e, model).valid}
        assert rejected and {e["run"] for e in out["invalid"]} == {
            runs["replay-mutants"]}, out["invalid"]
        assert {e["key"] for e in out["invalid"]} == rejected, out

        # Every key's fields against the pre-scheduler route on the same
        # encodings, the short and the long runs apart (a slot past a
        # history's pending ops never fires, so the fields do not depend
        # on the shared width).
        entries = corpus_entries(store, dev)
        encs = [e for _r, _k, e in entries]
        t1 = time.perf_counter()
        res, kname, stats = sched.check_corpus(encs, model, device=dev)
        check_corpus_s = time.perf_counter() - t1
        assert stats["launches"] == out["launches"] and \
            stats["padding_waste"] == out["padding_waste"], (stats, out)
        long_runs = {p for n, p in runs.items() if "long" in n}
        for want_long in (False, True):
            idx = [i for i, (r, _k, _e) in enumerate(entries)
                   if (r in long_runs) == want_long]
            auto, _kn = wk.check_batch_encoded_auto(
                [entries[i][2] for i in idx], model, dev)
            for i, a in zip(idx, auto):
                for f in ("valid", "dead_step", "max_frontier",
                          "configs_explored", "op_count"):
                    assert res[i][f] == a[f], (entries[i][:2], f)
        cfg, steps = corpus_steps(entries, model, dev)
        kernels.append(bucket_record(cfg, steps, model, dev,
                                     launches["dense_sweep"]))
        # What one launch padded to the longest history (the route before
        # the scheduler) would have swept.
        single = len(steps) * wgl3.step_bucket(max(s.n_steps
                                                   for s in steps))

        # (r2): the corpus's runs (the long runs moved out of the store)
        # encoded from the JSONL, cold cache then warm.
        for name, path in runs.items():
            if "long" in name:
                shutil.move(str(Path(path).parent), tmp)
        n_r2 = n_keys - REPLAY_LONG_RUNS * REPLAY_KEYS
        encode_cache.reset_stats()
        rc2, cold, cold_s = corpus_cli(store, dev, "--reencode")
        cold_cache = encode_cache.stats()
        for npz in store.glob("*/*/history*.npz"):
            npz.unlink()
        encode_cache.reset_stats()
        rc3, warm, warm_s = corpus_cli(store, dev)
        warm_cache = encode_cache.stats()
        for o in (cold, warm):
            assert o["from_tensors"] == 0 and o["keys"] == n_r2, o
            assert o["invalid"] == out["invalid"], o
        assert rc2 == rc3 == rc and cold_cache["hits"] == 0
        assert warm_cache == {"hits": n_r2, "misses": 0,
                              "evictions": 0}, warm_cache
        phase_s = time.perf_counter() - t0
    r3 = replay_tests(dev, test_rows)
    emit({"phase": "replay", "ok": True, "runs": out["runs"],
          "histories": n_keys, "invalid": len(out["invalid"]),
          "kernel": out["kernel"], "wall_s": out["wall_s"],
          "histories_per_s": n_keys / out["wall_s"], "cli_s": cli_s,
          "launches": out["launches"], "buckets": stats["buckets"],
          "padding_waste": out["padding_waste"],
          "steps_real": stats["steps_real"],
          "steps_padded": stats["steps_padded"],
          "single_launch_steps_padded": single,
          "cache_hit_rate": out["cache_hit_rate"], "setup_s": setup_s,
          "check_corpus_s": check_corpus_s,
          "hold": hold,
          "reencode": {
              "keys": n_r2,
              "cold": {"encode_s": cold_s - cold["wall_s"],
                       "wall_s": cold["wall_s"], "cache": cold_cache},
              "warm": {"encode_s": warm_s - warm["wall_s"],
                       "wall_s": warm["wall_s"], "cache": warm_cache}},
          "tests": r3, "r1_r2_s": phase_s})


# Phase `stream`: the streaming check. (s1) the 100k-op history and its
# late mutant fed op by op into an unkeyed session, paced over
# STREAM_PACE_S in STREAM_BATCHES batches; (s2) the JAX package's
# streaming lane (bench.py:1314-1420: 16 keys x 400 ops, p_info 0.002,
# seed 0x57CA, chunks of 64 steps) through a keyed session; (s3) two keys
# whose tables take the shared-memory route and the global tier; whole
# tests (g)-(j) through `cli test --check-mode stream`: (g) is run (b)
# streamed, (h) run (c) with --fail-fast and a 60 s limit, (i) append,
# (j) txnregister with stale reads and --fail-fast (its rw-register
# checker does not stream, so it is checked post-hoc).
STREAM_PACE_S, STREAM_BATCHES = 10.0, 40
STREAM_LANE = {"keys": 16, "ops_per_key": 400, "p_info": 0.002,
               "seed": 0x57CA, "flush_ops": 64}
STREAM_RUNS = (
    ("g", [*TEST_RUNS[1][1], "--check-mode", "stream"], 0),
    ("h", [*TEST_RUNS[2][1][:-4], "--time-limit", "60", "--recovery-wait",
           "1", "--check-mode", "stream", "--fail-fast"], 1),
    ("i", ["-w", "append", "--rate", "100", "--time-limit", "2",
           "--recovery-wait", "1", "--check-mode", "stream"], 0),
    ("j", ["-w", "txnregister", "--rate", "100", "--stale-read-prob", "0.5",
           "--elle-realtime", "--time-limit", "2", "--recovery-wait", "1",
           "--check-mode", "stream", "--fail-fast"], 1),
)


def paced_feed(session, ops, batches: int, pace_s: float) -> float:
    """Feed ops into a session in `batches` batches spread over `pace_s`
    seconds, as a run's recorder would; returns the feed's seconds."""
    per = -(-len(ops) // batches)
    t0 = time.perf_counter()
    for i in range(batches):
        for op in ops[i * per:(i + 1) * per]:
            session.feed(op)
        time.sleep(max(0.0, t0 + (i + 1) * pace_s / batches
                       - time.perf_counter()))
    return time.perf_counter() - t0


def wide_keys(res: dict) -> set:
    """The keys a stream-mode run settled with a table past 2^20 bits."""
    return {k for k, r in res["indep"].get("results", {}).items()
            if r["linear"].get("f_cap", 0) > 1 << 20}


def stream_fields(res: dict, wide: set) -> dict:
    """verdict_fields, where each key of `wide` keeps only valid and
    dead_step: the post-hoc check takes the sort search for such a key,
    whose frontier differs from the dense table's."""
    out = verdict_fields(res)
    for k in wide:
        out["linear"][k] = {f: out["linear"][k][f]
                            for f in ("valid", "dead_step")}
    return out


# (g)'s host witness: `analyze --device cpu` of every G_HOST_EVERY-th of
# its keys (sorted) and its first G_HOST_WIDE wide keys, beside its whole
# re-check by `analyze` on the card (all of (g) on the host takes 60-160
# s of a host CPU).
G_HOST_EVERY, G_HOST_WIDE = 8, 2


def key_sample(res: dict, wide: set) -> set:
    """(g)'s host witness keys (results.json's key strings)."""
    keys = sorted(res["indep"]["results"],
                  key=lambda k: (len(k), k))
    return set(keys[G_HOST_EVERY - 1::G_HOST_EVERY]) \
        | set(sorted(wide, key=lambda k: (len(k), k))[:G_HOST_WIDE])


def sample_run(run_dir: Path, dest: Path, keys: set) -> Path:
    """A run directory with run_dir's test.json and the lines of its
    history.jsonl that belong to `keys`, in order (completions follow
    their process's pending invocation, as split_by_key routes them)."""
    dest.mkdir()
    shutil.copy(run_dir / "test.json", dest / "test.json")
    key_of: dict = {}
    kept = []
    for line in (run_dir / "history.jsonl").read_text().splitlines():
        if not line.strip():
            continue
        op = json.loads(line)
        if op["process"] == "nemesis":
            continue
        if op["type"] == "invoke":
            key = key_of[op["process"]] = str(op["value"][0])
        else:
            key = key_of.pop(op["process"], None)
        if key in keys:
            kept.append(line)
    (dest / "history.jsonl").write_text("\n".join(kept) + "\n")
    return dest


def stream_long(dev) -> dict:
    """(s1): the 100k-op history and its late mutant through an unkeyed
    StreamSession; the fields of the valid one equal Linearizable's
    post-hoc check on the card, the mutant is falsified before finalize
    with the whole-scan kernel's dead_step."""
    from jepsen_etcd_demo_tpu_torch.checkers import Linearizable
    from jepsen_etcd_demo_tpu_torch.models import CASRegister
    from jepsen_etcd_demo_tpu_torch.ops import wgl3_kernels as wk
    from jepsen_etcd_demo_tpu_torch.stream import StreamSession

    model = CASRegister()
    h, enc, cfg, rs, _encode_s = long_setup(model, LONG_OPS, 10,
                                            0x10C0 + LONG_OPS)
    fields = ("valid", "dead_step", "max_frontier", "configs_explored")
    wk.reset_launches()
    session = StreamSession(model, keyed=False, device=dev)
    feed_s = paced_feed(session, h, STREAM_BATCHES, STREAM_PACE_S)
    t0 = time.perf_counter()
    got = session.finalize()[None]
    drain_s = time.perf_counter() - t0
    launches = dict(wk.launches)
    stats = session.stats()
    lin = Linearizable(model, device=dev)
    t0 = time.perf_counter()
    post = lin.check({}, h)
    torch.cuda.synchronize()
    post_s = time.perf_counter() - t0
    assert all(got[f] == post[f] for f in fields), (got, post)
    assert got["valid"] is True and stats["chunks"] >= rs.n_steps // 256
    assert launches["dense_sweep_resumable"] >= stats["chunks"], launches

    mutant = late_mutant(h, 0.62)
    bad = StreamSession(model, keyed=False, device=dev)
    t0 = time.perf_counter()
    for op in mutant:
        bad.feed(op)
    while not bad.falsified() and time.perf_counter() - t0 < 120:
        time.sleep(0.01)
    falsified_s = time.perf_counter() - t0
    assert bad.falsified(), "the mutant was not falsified before finalize"
    bad_res = bad.finalize()[None]
    scan, _ms = whole_scan(model, lin.encode(mutant), dev)
    assert bad_res["valid"] is False and scan["valid"] is False
    assert bad_res["dead_step"] == scan["dead_step"] > LONG_DEAD_AFTER, \
        (bad_res, scan)
    row = {"ops": LONG_OPS, "steps": rs.n_steps, "k_slots": cfg.k_slots,
           "feed_s": feed_s, "drain_s": drain_s, "posthoc_check_s": post_s,
           "chunks": stats["chunks"], "restarts": stats["restarts"],
           "overlap_ratio": stats["overlap_ratio"],
           "encode_s": stats["encode_s"], "dispatch_s": stats["dispatch_s"],
           "launches": launches,
           "max_frontier": got["max_frontier"],
           "configs_explored": got["configs_explored"],
           "mutant": {"dead_step": bad_res["dead_step"],
                      "falsified_s": falsified_s,
                      "chunks": bad.stats()["chunks"]}}
    emit({"phase": "stream_s1", "ok": True, **row})
    return row


def stream_lane(dev) -> dict:
    """(s2): the JAX streaming lane's run through a keyed StreamSession
    at 64-step chunks: every key's fields equal the post-hoc
    IndependentChecker's on the card, and one key's final carry equals
    resumable_reference run on the same chunks on the card."""
    from dataclasses import replace

    from jepsen_etcd_demo_tpu_torch.checkers import (IndependentChecker,
                                                     Linearizable)
    from jepsen_etcd_demo_tpu_torch.models import CASRegister
    from jepsen_etcd_demo_tpu_torch.ops import wgl3_kernels as wk
    from jepsen_etcd_demo_tpu_torch.ops.encode import encode_return_steps
    from jepsen_etcd_demo_tpu_torch.ops.limits import limits, set_limits
    from jepsen_etcd_demo_tpu_torch.stream import StreamSession
    from jepsen_etcd_demo_tpu_torch.utils.fuzz import (gen_register_history,
                                                       interleave_keyed)

    model = CASRegister()
    lane = STREAM_LANE
    rng = random.Random(lane["seed"])
    per_key = [gen_register_history(rng, n_ops=lane["ops_per_key"],
                                    n_procs=10, p_info=lane["p_info"])
               for _ in range(lane["keys"])]
    ops = interleave_keyed(per_key)
    chunk = lane["flush_ops"]
    prev = set_limits(replace(limits(), stream_flush_ops=chunk))
    try:
        wk.reset_launches()
        session = StreamSession(model, keyed=True, device=dev)
        feed_s = paced_feed(session, ops, STREAM_BATCHES, 2.0)
        t0 = time.perf_counter()
        got = session.finalize()
        drain_s = time.perf_counter() - t0
        launches = dict(wk.launches)
    finally:
        set_limits(prev)
    t0 = time.perf_counter()
    post = IndependentChecker(Linearizable(model, device=dev)).check({}, ops)
    torch.cuda.synchronize()
    post_s = time.perf_counter() - t0
    fields = ("valid", "dead_step", "max_frontier", "configs_explored")
    assert set(got) == set(range(lane["keys"])), sorted(got)
    for k, r in got.items():
        assert all(r[f] == post["results"][str(k)][f] for f in fields), k
    assert launches["dense_sweep_resumable"] >= 1, launches
    # One key's carry against the plain version over the same chunks (the
    # key's last epoch: full chunks from step 0, then the padded tail).
    ks = session._streams[0]
    enc = got[0]["_enc"]
    rs = encode_return_steps(reslot(enc, ks.cfg.k_slots))
    T, meta = wk.start_carry(model, ks.cfg, dev)
    for c0 in range(0, rs.n_steps, chunk):
        n = min(chunk, rs.n_steps - c0)
        tabs = torch.zeros((1, chunk, ks.cfg.k_slots, 4), dtype=torch.int32)
        act = torch.zeros((1, chunk, ks.cfg.k_slots), dtype=torch.bool)
        tgt = torch.full((1, chunk), -1, dtype=torch.int32)
        tabs[0, :n] = torch.from_numpy(rs.slot_tabs[c0:c0 + n])
        act[0, :n] = torch.from_numpy(rs.slot_active[c0:c0 + n])
        tgt[0, :n] = torch.from_numpy(rs.targets[c0:c0 + n])
        ln, tg, cm = wk.prepare_colmask(model, ks.cfg, tabs.to(dev),
                                        act.to(dev), tgt.to(dev))
        T, meta = wk.resumable_reference(ln, tg, cm, ks.cfg, T, meta)
    assert torch.equal(T, ks.carry[0]) and torch.equal(meta, ks.carry[1]), \
        (meta.tolist(), ks.carry[1].tolist())
    stats = session.stats()
    row = {"keys": lane["keys"], "ops": len(ops), "chunk": chunk,
           "feed_s": feed_s, "drain_s": drain_s, "posthoc_check_s": post_s,
           "chunks": stats["chunks"], "restarts": stats["restarts"],
           "overlap_ratio": stats["overlap_ratio"], "launches": launches,
           "carry_key_chunks": ks.chunks, "carry_meta": meta[0].tolist()}
    emit({"phase": "stream_s2", "ok": True, **row})
    return row


def reslot(enc, k: int):
    from jepsen_etcd_demo_tpu_torch.ops.encode import reslot_events

    return reslot_events(enc, k) if enc.k_slots != k else enc


def stream_tiers(dev) -> dict:
    """(s3): a keyed session over a key at tight K 14-16 (the resumable
    sweep's shared-memory route) and one at K 18-22 (past 2^20 bits at
    S = 8: the global tier); each key's fields equal the post-hoc sweep
    of its whole history under the same geometry: Linearizable's for the
    first, the windowed dense-chunked sweep (the general path's dense
    rung) for the second."""
    from jepsen_etcd_demo_tpu_torch.checkers import Linearizable
    from jepsen_etcd_demo_tpu_torch.models import CASRegister
    from jepsen_etcd_demo_tpu_torch.ops import wgl3_kernels as wk
    from jepsen_etcd_demo_tpu_torch.ops.encode import encode_return_steps
    from jepsen_etcd_demo_tpu_torch.ops.limits import limits
    from jepsen_etcd_demo_tpu_torch.stream import StreamSession
    from jepsen_etcd_demo_tpu_torch.utils.fuzz import interleave_keyed

    model = CASRegister()
    shared, _ = partitioned_history(1000, 0.008, 0x5E0, 14, 16, 4)
    wide, _ = partitioned_history(1000, 0.016, GENERAL_SEED, 18, 22, 8)
    ops = interleave_keyed([shared, wide])
    wk.reset_launches()
    session = StreamSession(model, keyed=True, device=dev)
    for op in ops:
        session.feed(op)
    got = session.finalize()
    launches = dict(wk.launches)
    assert launches["dense_sweep_resumable"] >= 1, launches
    assert launches["dense_sweep_global"] >= 1, launches
    cfgs = {k: session._streams[k].cfg for k in (0, 1)}
    assert not wk.global_tier(cfgs[0]) and wk.global_tier(cfgs[1]), cfgs
    lin = Linearizable(model, device=dev)
    fields = ("valid", "dead_step", "max_frontier", "configs_explored")
    post = lin.check({}, shared)
    assert all(got[0][f] == post[f] for f in fields), (got[0], post)
    enc = reslot(lin.encode(wide), cfgs[1].k_slots)
    chunked = wk.check_steps3_long(encode_return_steps(enc), model, cfgs[1],
                                   dev)
    assert all(got[1][f] == chunked[f] for f in fields), (got[1], chunked)
    row = {"k_slots": [cfgs[k].k_slots for k in (0, 1)],
           "n_states": [cfgs[k].n_states for k in (0, 1)],
           "table_bits": [cfgs[k].n_states * cfgs[k].n_masks
                          for k in (0, 1)],
           "chunks": session.stats()["chunks"], "launches": launches,
           "budget_chunked": limits().dense_cell_budget_chunked,
           "valid": [got[k]["valid"] for k in (0, 1)],
           "max_frontier": [got[k]["max_frontier"] for k in (0, 1)]}
    emit({"phase": "stream_s3", "ok": True, **row})
    return row


def stream_run(root: Path, name: str, flags: list[str], want_rc: int, dev,
               seconds: list[float]):
    """One run of STREAM_RUNS through cli_test, with its exit code and
    what stream mode must show for it."""
    rc, line, res, run_dir, row = cli_test(root, name, flags, dev, seconds)
    assert rc == want_rc, (name, row, res)
    stream = res.get("stream", {})
    row["stream"] = stream
    emit({"phase": "stream_run", "name": name,
          "check_mode": res["check_mode"], "stream": stream})
    if name == "g":
        assert line["op_count"] >= TEST_MIN_OPS["b"], row
        assert res["check_mode"] == "stream" and stream["chunks"] >= 1, res
        assert row["launches"]["dense_sweep_resumable"] >= 1, row
    if name == "h":
        assert stream["failfast_aborted"] is True, stream
        assert line["run_seconds"] < 15, line
        bad = [r for r in res["indep"]["results"].values()
               if r["valid"] is False]
        assert bad and bad[0]["linear"]["failed_op"], res
    if name == "i":
        assert res["check_mode"] == "stream", res
        assert res["indep"]["elle"].get("streamed") is True, res
    return rc, line, res, run_dir, row


# Phase `serve`: `cli serve --check` as a subprocess on the card, at the
# defaults (coalesce 10 ms, batch 64), under (v1) 8 tenants on 8 threads,
# each POSTing 128 histories of 150 ops (cas-register, 10 processes,
# values 0-4: BASELINE.json configs[0] in the shape of the configs[4]
# corpus), every 16th a mutant, waiting for each verdict; (v2) one 10k-op
# history (configs[3], phase single's) submitted without waiting and
# polled; (v3) a streaming session fed that history in 1,000-op POSTs and
# a keyed session of 10 keys x 1,000 ops (configs[2], phase
# independent's), in 1,000-op POSTs. (v1)'s verdicts are held against
# the plain version of the sweep on the card (all 1,024) and against
# check_corpus on the host (every SERVE_HOST_EVERY-th history: the 64
# mutants; the plain version over all 1,024 takes minutes on a host CPU).
SERVE_TENANTS, SERVE_PER_TENANT, SERVE_OPS = 8, 128, 150
SERVE_HOST_EVERY = 16
SERVE_MUTANT_EVERY, SERVE_FEED_OPS = 16, 1_000
SERVE_LONG_OPS, SERVE_KEY_OPS = 10_000, 1_000


def serve_call(port: int, path: str, body=None, timeout: float = 600):
    """(status, JSON or text) of one request to the daemon."""
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        headers={"Content-Type": "application/json"} if data else {})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        text = r.read().decode()
        if r.headers.get_content_type() == "application/json":
            return r.status, json.loads(text)
        return r.status, text


def start_daemon(store: Path, dev, log_path: Path):
    """`cli serve --check --port 0` on `dev` as a subprocess: (process,
    ready line, seconds to the ready line). Raises with the daemon's log
    when it exits first."""
    import select

    t0 = time.perf_counter()
    log = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "jepsen_etcd_demo_tpu_torch.cli", "serve",
         "--check", "--port", "0", "--store", str(store),
         *(["--device", "cpu"] if dev.type == "cpu" else [])],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=log, text=True)
    log.close()
    ready, _, _ = select.select([proc.stdout], [], [], 300)
    line = proc.stdout.readline() if ready else ""
    if not line:
        proc.kill()
        proc.wait()
        raise AssertionError("serve --check gave no ready line:\n"
                             + log_path.read_text()[-3000:])
    return proc, json.loads(line), time.perf_counter() - t0


def serve_verdict(res: dict) -> tuple:
    return (res["valid"], int(res.get("dead_step", -1)),
            int(res["op_count"]))


def quantiles(values) -> tuple:
    """(p50, p99) of `values`, None for none."""
    xs = sorted(values)
    if not xs:
        return None, None
    return tuple(xs[min(len(xs) - 1, int(p * len(xs)))] for p in (0.5, 0.99))


def serve_part(name: str, before: dict, after: dict, rows: dict,
               latencies, requests: int, wall: float) -> dict:
    """One part's line: its requests, rate, latency quantiles (the
    daemon's submit to verdict), batches and launches (deltas of
    /serve/stats)."""
    sb, sa = before["scheduler"], after["scheduler"]
    lb, la = before["launches"], after["launches"]
    d = {k: la[k] - lb[k] for k in la}
    batches = sa["batches"] - sb["batches"]
    done = sa["requests_done"] - sb["requests_done"]
    p50, p99 = quantiles(latencies)
    out = {"phase": "serve_part", "part": name, "requests": requests,
           "wall_s": wall, "requests_per_s": requests / wall,
           "latency_p50_s": p50, "latency_p99_s": p99,
           "batches": batches,
           "batch_fill_avg": (done / batches / sa["max_batch"]
                              if batches else 0.0),
           "coalesced_requests": sa["coalesced_requests"]
           - sb["coalesced_requests"],
           "failed_requests": sa["failed_requests"]
           - sb["failed_requests"],
           "health": sa["health"],
           "bucket_launches": d["dense_sweep_grouped"],
           "single_launches": d["dense_sweep"] - d["dense_sweep_grouped"],
           "chunk_launches": d["dense_sweep_resumable"]
           + d["dense_sweep_global"], "launches": d, **rows}
    emit(out)
    return out


def serve_v1_histories():
    """(v1)'s histories: 128 a tenant, every 16th a mutant."""
    from jepsen_etcd_demo_tpu_torch.utils.fuzz import (gen_register_history,
                                                       mutate_history)

    rng, mrng = random.Random(0x5E7E), random.Random(0x5E7F)
    hists = [gen_register_history(rng, n_ops=SERVE_OPS, n_procs=10,
                                  p_info=0.002)
             for _ in range(SERVE_TENANTS * SERVE_PER_TENANT)]
    every = SERVE_MUTANT_EVERY
    hists[every - 1::every] = [mutate_history(mrng, h)
                               for h in hists[every - 1::every]]
    return hists


def serve_v1(port: int, hists) -> tuple[list, list, float]:
    """(v1): each tenant's thread POSTs its histories one at a time and
    waits for each verdict; (verdicts, each request's round trip as its
    tenant felt it: HTTP, parse and encode included, wall seconds)."""
    n = len(hists)
    bodies = [{"tenant": f"tenant-{i % SERVE_TENANTS}", "wait": True,
               "history": [json.loads(o.to_json()) for o in h]}
              for i, h in enumerate(hists)]
    verdicts: list = [None] * n
    roundtrips: list = [None] * n

    def tenant(t):
        for i in range(t, n, SERVE_TENANTS):
            t1 = time.perf_counter()
            status, verdicts[i] = serve_call(port, "/check", bodies[i])
            roundtrips[i] = time.perf_counter() - t1
            assert status == 200, (i, status)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(SERVE_TENANTS) as pool:
        list(pool.map(tenant, range(SERVE_TENANTS)))
    return verdicts, roundtrips, time.perf_counter() - t0


def serve_v2(port: int, h) -> tuple[dict, float]:
    """(v2): one history submitted without waiting, then polled."""
    ops = [json.loads(o.to_json()) for o in h]
    t0 = time.perf_counter()
    status, body = serve_call(port, "/check", {"tenant": "long",
                                               "wait": False,
                                               "history": ops})
    assert status == 202 and body["pending"], body
    while True:
        status, verdict = serve_call(port, f"/check/{body['request_id']}")
        if status == 200:
            return verdict, time.perf_counter() - t0
        time.sleep(0.01)


def serve_session(port: int, tenant: str, ops, keyed: bool) -> dict:
    """(v3): one streaming session fed `ops` in SERVE_FEED_OPS-op POSTs,
    then closed; its verdict."""
    status, sess = serve_call(port, "/serve/session",
                              {"tenant": tenant, "keyed": keyed})
    assert status == 201, sess
    feed = [json.loads(o.to_json()) for o in ops]
    for c in range(0, len(feed), SERVE_FEED_OPS):
        status, fed = serve_call(port, sess["ops"],
                                 {"ops": feed[c:c + SERVE_FEED_OPS]})
        assert status == 200, fed
    status, verdict = serve_call(port, sess["close"], {})
    assert status == 200 and verdict["streamed"] is True, verdict
    return verdict


def serve_plain_reference(encs, model, dev) -> list[tuple]:
    """(valid, dead_step, op_count) of each history by the plain version
    of the dense sweep (wgl3_kernels.sweep_reference) on `dev`, one batch
    under the histories' shared geometry."""
    from jepsen_etcd_demo_tpu_torch.ops import wgl3, wgl3_kernels as wk

    cfg, steps, r_cap = wgl3.batch_steps3(encs, model)
    ln, tg, cm = wk.prepare_colmask(model, cfg,
                                    *wgl3.stack_steps3(steps, r_cap, dev))
    rows = wk.sweep_reference(ln, tg, cm, cfg, wgl3.init_row(model, cfg))
    return [(r["valid"], int(r["dead_step"]), int(r["op_count"]))
            for r in wgl3.assemble_batch_results(
                wgl3.unpack_np(rows.cpu().numpy()), steps, cfg)]


def phase_serve(dev) -> dict:
    """`serve --check` on the card under (v1)-(v3); see SERVE_TENANTS.
    Every verdict is held against this process's own check of the same
    history, made after the traffic: (v1) the plain version of the sweep
    on the card for all, check_corpus on the host for every
    SERVE_HOST_EVERY-th; (v2) and (v3) the post-hoc Linearizable on the
    card, whose kernels phases single and long hold against their plain
    versions. Returns the daemon's launches by kernel record."""
    from jepsen_etcd_demo_tpu_torch.checkers import (IndependentChecker,
                                                     Linearizable)
    from jepsen_etcd_demo_tpu_torch.sched import check_corpus
    from jepsen_etcd_demo_tpu_torch.utils.fuzz import (gen_register_history,
                                                       interleave_keyed)

    hists = serve_v1_histories()
    long_h = gen_register_history(random.Random(0x10C0 + 10_000),
                                  n_ops=SERVE_LONG_OPS, n_procs=10,
                                  p_info=0.0005)
    rng = random.Random(0x1D)
    per_key = [gen_register_history(rng, n_ops=SERVE_KEY_OPS, n_procs=10,
                                    p_info=0.002) for _ in range(10)]
    per_key[3] = invalid_mutant(per_key[3], 0x1D3)
    keyed = interleave_keyed(per_key)
    parts, rows = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        store = Path(tmp) / "store"
        proc, ready, start_s = start_daemon(store, dev,
                                            Path(tmp) / "serve.log")
        try:
            port = ready["port"]
            assert ready["check"] is True and ready["warmed"] is True, ready
            stats = [serve_call(port, "/serve/stats")[1]]

            verdicts, roundtrips, v1_s = serve_v1(port, hists)
            stats.append(serve_call(port, "/serve/stats")[1])
            v2, v2_s = serve_v2(port, long_h)
            stats.append(serve_call(port, "/serve/stats")[1])
            t0 = time.perf_counter()
            sessions = {"stream": serve_session(port, "stream", long_h,
                                                False),
                        "stream-keyed": serve_session(port, "stream-keyed",
                                                      keyed, True)}
            v3_s = time.perf_counter() - t0
            stats.append(serve_call(port, "/serve/stats")[1])
            healthz = serve_call(port, "/healthz")[1]
            want_runs = len(verdicts) + 1 + len(sessions)
            deadline = time.monotonic() + 120
            while len(list((store / "serve").iterdir())) < want_runs \
                    and time.monotonic() < deadline:
                time.sleep(0.05)
            runs = len(list((store / "serve").iterdir()))
            index = serve_call(port, "/")[1]
            metrics = serve_call(port, "/metrics")[1]
        except BaseException:
            print(f"serve --check exit code {proc.poll()}; its log:\n"
                  + (Path(tmp) / "serve.log").read_text()[-4000:],
                  file=sys.stderr, flush=True)
            raise
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()

    # (v1) against the plain version on the card, and a share against
    # check_corpus on the host.
    lin_cpu = Linearizable(device="cpu")
    encs = [lin_cpu.encode(h) for h in hists]
    t0 = time.perf_counter()
    plain = serve_plain_reference(encs, lin_cpu.model, dev)
    rows["v1_plain_s"] = time.perf_counter() - t0
    host_idx = list(range(SERVE_HOST_EVERY - 1, len(encs), SERVE_HOST_EVERY))
    t0 = time.perf_counter()
    host, _k, _st = check_corpus([encs[i] for i in host_idx], device="cpu")
    rows["v1_host_s"] = time.perf_counter() - t0
    rows["v1_host_histories"] = len(host_idx)
    for i, (v, want) in enumerate(zip(verdicts, plain)):
        assert v["route"] == "torch", (i, v)
        assert serve_verdict(v) == want, (i, v, want)
    for i, r in zip(host_idx, host):
        assert serve_verdict(verdicts[i]) == (
            r["valid"], int(r["dead_step"]), encs[i].n_ops), (i, r)
    assert all(i in host_idx for i in range(SERVE_MUTANT_EVERY - 1,
                                            len(encs), SERVE_MUTANT_EVERY))
    # (v2) and the unkeyed session against the card's post-hoc check.
    t0 = time.perf_counter()
    want = serve_verdict(Linearizable(device=dev).check({}, long_h))
    rows["v2_reference_s"] = time.perf_counter() - t0
    assert v2["route"] == "torch" and serve_verdict(v2) == want, (v2, want)
    one = sessions["stream"]["keys"]["_"]
    assert serve_verdict(one) == want, (one, want)
    # The keyed session against the card's post-hoc independent check.
    t0 = time.perf_counter()
    got = IndependentChecker(Linearizable(device=dev)).check({}, keyed)
    rows["v3_reference_s"] = time.perf_counter() - t0
    keys = sessions["stream-keyed"]["keys"]
    assert set(keys) == set(got["results"]), (keys, got)
    for k, r in got["results"].items():
        assert serve_verdict(keys[k])[:2] == (
            r["valid"], int(r.get("dead_step", -1))), (k, keys[k], r)
    assert sessions["stream-keyed"]["valid"] is False

    # A key whose geometry grows restarts: its chunk count starts again,
    # and the stable prefix is swept once more.
    chunks = sum(s["stream"]["chunks"] for s in sessions.values())
    restarts = sum(s["stream"]["restarts"] for s in sessions.values())
    parts["v1"] = serve_part(
        "v1", stats[0], stats[1],
        {"invalid": sum(v["valid"] is False for v in verdicts),
         **dict(zip(("roundtrip_p50_s", "roundtrip_p99_s"),
                    quantiles(roundtrips))),
         "plain_reference_s": rows["v1_plain_s"],
         "host_reference_s": rows["v1_host_s"]},
        [v["latency_s"] for v in verdicts], len(verdicts), v1_s)
    parts["v2"] = serve_part("v2", stats[1], stats[2],
                             {"reference_s": rows["v2_reference_s"]},
                             [v2["latency_s"]], 1, v2_s)
    parts["v3"] = serve_part(
        "v3", stats[2], stats[3],
        {"sessions": len(sessions), "chunks": chunks, "restarts": restarts,
         "overlap_ratio": {n: s["stream"]["overlap_ratio"]
                           for n, s in sessions.items()},
         "reference_s": rows["v3_reference_s"]}, [], len(sessions), v3_s)

    # The daemon at the end: healthy, no failed batch, every verdict a run
    # in the store and a row of the index; on a card, coalesced batches on
    # the grouped route (fewer launches than requests), the lone 10k
    # request on the single one, every session chunk on the resumable one.
    sched = stats[3]["scheduler"]
    assert healthz["status"] == "healthy", healthz
    assert sched["failed_requests"] == 0 and sched["health"] == "healthy", \
        sched
    assert parts["v1"]["coalesced_requests"] > 0, parts["v1"]
    assert runs == want_runs, (runs, want_runs)
    assert index.count("<a href='/files/serve/") == want_runs
    assert "jepsen_tpu_serve_tenant_latency_seconds" in metrics
    if dev.type == "cuda":
        assert 0 < parts["v1"]["bucket_launches"] < len(verdicts), \
            parts["v1"]
        assert parts["v2"]["single_launches"] >= 1, parts["v2"]
        assert parts["v3"]["chunk_launches"] >= chunks > 0, parts["v3"]
    total = {k: sum(p["launches"][k] for p in parts.values())
             for k in parts["v1"]["launches"]}
    emit({"phase": "serve", "ok": True, "start_s": start_s,
          "warmup": healthz["serve"],
          "requests": sched["requests_done"], "batches": sched["batches"],
          "batch_fill_avg": sched["batch_fill_avg"],
          "coalesced_requests": sched["coalesced_requests"],
          "failed_requests": sched["failed_requests"],
          "health": healthz["status"],
          "kernel_cache": sched["kernel_cache"], "launches": total,
          "store_runs": runs, **rows})
    return {"wgl3_sweep[corpus]": total["dense_sweep_grouped"],
            "wgl3_sweep[single]": total["dense_sweep"]
            - total["dense_sweep_grouped"],
            "wgl3_sweep[resume]": total["dense_sweep_resumable"],
            "wgl3_sweep[global]": total["dense_sweep_global"]}


def phase_stream(dev, test_rows: dict) -> dict:
    """The streaming check on the card: whole test (g) through `cli test
    --check-mode stream`, re-checked post-hoc by `analyze` on the card and,
    on a fixed sample of its keys (key_sample), by `analyze --device cpu`
    in a subprocess beside s1-s3 and whole tests (h)-(j), each of which is
    re-checked by `analyze --device cpu` in this process. Returns the
    stream launches of the resumable sweep's routes."""
    rows = {}
    with timed_checks(dev) as seconds, \
            tempfile.TemporaryDirectory() as tmp:
        rc, line, res, run_dir, rows["g"] = stream_run(
            Path(tmp), *STREAM_RUNS[0], dev, seconds)
        wide = wide_keys(res)
        rows["g"]["wide_keys"] = len(wide)
        sample = key_sample(res, wide)
        sample_dir = sample_run(run_dir, Path(tmp) / "g_sample", sample)
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "jepsen_etcd_demo_tpu_torch.cli",
             "analyze", str(sample_dir), "--device", "cpu"],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            text=True)
        try:
            rows["g"]["recheck_s"] = recheck(
                "g", run_dir, rc, line, stream_fields(res, wide),
                fields=lambda again: stream_fields(again, wide),
                device=dev.type)
            s1 = stream_long(dev)
            s2 = stream_lane(dev)
            s3 = stream_tiers(dev)
            for name, flags, want_rc in STREAM_RUNS[1:]:
                arc, aline, ares, adir, rows[name] = stream_run(
                    Path(tmp), name, flags, want_rc, dev, seconds)
                rows[name]["recheck_s"] = recheck(name, adir, arc, aline,
                                                  verdict_fields(ares))
            out, _ = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        rows["g"]["host_witness_s"] = time.perf_counter() - t0
        # The sample's keys, by the host, equal the streamed verdicts.
        again = json.loads((sample_dir / "results.json").read_text())
        want = stream_fields(res, wide)["linear"]
        assert proc.returncode == 0 and json.loads(
            out.splitlines()[-1]) == {"valid": True}, out
        assert stream_fields(again, wide & sample)["linear"] == {
            k: want[k] for k in sample}, (again, sample)
        emit({"phase": "test_recheck", "name": "g_sample", "device": "cpu",
              "keys": len(sample), "wide_keys": len(wide & sample),
              "seconds": rows["g"]["host_witness_s"], "subprocess": True})
    g = rows["g"]
    emit({"phase": "stream", "ok": True,
          "exit_codes": {n: r["rc"] for n, r in rows.items()},
          "s1": {f: s1[f] for f in ("chunks", "restarts", "overlap_ratio",
                                    "drain_s", "posthoc_check_s")},
          "s2": {f: s2[f] for f in ("chunks", "overlap_ratio", "drain_s",
                                    "posthoc_check_s")},
          "g": {"op_count": g["op_count"], "check_s": g["check_s"],
                "drain_s": g["stream"]["drain_s"],
                "overlap_ratio": g["stream"]["overlap_ratio"],
                "wide_keys": g["wide_keys"],
                "host_witness_s": g["host_witness_s"],
                "b_check_s": test_rows.get("b", {}).get("check_s"),
                "b_op_count": test_rows.get("b", {}).get("op_count")},
          "h_run_seconds": rows["h"]["run_seconds"]})
    return {"wgl3_sweep[resume]": s1["launches"]["dense_sweep_resumable"],
            "wgl3_sweep[resume,shared]": s3["launches"]
            ["dense_sweep_resumable"],
            "wgl3_sweep[global]": s3["launches"]["dense_sweep_global"]}


# Phase `cluster`: the real-cluster path, `cli test` without --fake, the
# reference's own use (install etcd over SSH, drive clients against it
# while the nemesis kills or pauses it, check the history). It needs no
# etcd and no sshd: each run's `etcd` is minietcd (db/minietcd.py, one
# linearizable member), installed from its release-shaped tarball by
# EtcdDB over SSHRunner through ssh, scp and sshpass stand-ins on PATH
# (tests/torch_cluster_util.py, which the CPU tests share), and an `apt-get` stand-in records what the Debian prep
# asks for and installs nothing. The partition and clock nemeses would
# change the machine's iptables and clock, so no run takes them (the CPU
# tests hold their commands to the JAX package's). Runs, register
# workload, 10 workers asking 200 Hz: (c1) one node, noop, 10 s, ssh
# password auth; (c2) kill -9 and restart, 20 s; (c3) SIGSTOP and
# SIGCONT, 12 s; (c4) two co-hosted minietcds that do not replicate, a
# broken cluster the check must catch, 6 s. Each run is a process of its
# own (db/etcd.py reads its environment at import), the four side by
# side; each run directory is re-checked by `analyze --device cpu`, (c1)
# and (c4) also by `analyze --backend oracle`. A start settles 1 s (a
# minietcd listens within a second of its launch here); (c2) lasts 20 s,
# not the JAX kill lane's 32, to keep the script inside its time limit:
# kill at 5 s, restart at 10, served until the next kill at ~16.
CLUSTER_PASSWORD = "smoke-sekrit"
CLUSTER_COMMON = ["-w", "register", "--concurrency", "10", "--rate", "200",
                  "--recovery-wait", "2"]
CLUSTER_RUNS = (
    # (name, flags, exit code, co-hosted nodes)
    ("c1", ["--nodes", "localhost", "--nemesis", "noop", "--time-limit",
            "10", "--password", CLUSTER_PASSWORD], 0, False),
    ("c2", ["--nodes", "localhost", "--nemesis", "kill", "--time-limit",
            "20"], 0, False),
    ("c3", ["--nodes", "localhost", "--nemesis", "pause", "--time-limit",
            "12"], 0, False),
    ("c4", ["--nodes", "localhost,127.0.0.1", "--nemesis", "noop",
            "--time-limit", "6"], 1, True),
)
# A gate against a run that stalls, not against a slow host: half the
# fewest ops a run recorded on the H100 machine (NVIDIA H100 80GB HBM3,
# 700 W: c1 1,989, c2 3,959, c3 1,354, c4 1,209).
CLUSTER_MIN_OPS = {"c1": 994, "c2": 1979, "c3": 677, "c4": 604}


def cluster_util():
    """tests/torch_cluster_util.py (the stand-ins, cluster_env,
    free_port), loaded by path: the CPU tests share it."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_cluster_util", ROOT / "tests" / "torch_cluster_util.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cluster_child(out: str, argv: list[str]) -> int:
    """One run of phase `cluster` in its own process: `cli test` through
    cli.main, the launch counters set to 0 just before it and read just
    after, its check timed; writes {"rc", "launches", "check_s"} to
    `out`."""
    from jepsen_etcd_demo_tpu_torch import cli
    from jepsen_etcd_demo_tpu_torch.ops import wgl3_kernels as wk

    dev = torch.device(argv[argv.index("--device") + 1])
    with timed_checks(dev, "etcd_test") as seconds:
        wk.reset_launches()
        rc = cli.main(argv)
        launches = dict(wk.launches)
    Path(out).write_text(json.dumps({"rc": rc, "launches": launches,
                                     "check_s": seconds}))
    return rc


def kill_daemons(root: Path) -> list[int]:
    """SIGKILL every daemon whose pidfile is left under `root`'s install
    dir (teardown removes them; a failed run may not)."""
    killed = []
    for pidfile in (root / "opt" / "etcd").glob("*.pid"):
        try:
            pid = int(pidfile.read_text().strip())
            os.kill(pid, 9)
            killed.append(pid)
        except (ValueError, OSError):
            pass
    return killed


def nemesis_values(hist: list, key: str) -> list[int]:
    """Indices of the nemesis completions whose value names `key`."""
    return [i for i, op in enumerate(hist)
            if op["process"] == "nemesis" and op["type"] == "info"
            and isinstance(op["value"], dict) and op["value"].get(key)]


def check_cluster_run(name: str, rc: int, line: dict, res: dict,
                      run_dir: Path, root: Path) -> None:
    """What each run must show beyond its exit code and verdict."""
    hist = [json.loads(ln) for ln in
            (run_dir / "history.jsonl").read_text().splitlines()]
    assert any(op["type"] == "ok" for op in hist), name
    # Each member bound its own ports (free_port picks them in advance).
    member_logs = sorted(run_dir.glob("*-etcd*.log"))
    assert member_logs, name
    for log in member_logs:
        assert "serving client requests" in log.read_text(), (name, log)
    if name == "c1":
        test_json = (run_dir / "test.json").read_text()
        assert CLUSTER_PASSWORD not in test_json, name
        assert "<redacted>" in test_json, name
        assert "minietcd" in (run_dir / "localhost-etcd.log").read_text()
        assert not (root / "opt" / "etcd").exists(), "install dir left"
    if name == "c2":
        kills = nemesis_values(hist, "killed")
        restarts = nemesis_values(hist, "restarted")
        assert kills and restarts, name
        assert any(op["type"] == "ok" for op in hist[:kills[0]]), name
        assert any(op["type"] == "ok" for op in hist[restarts[0]:]), name
    if name == "c3":
        assert nemesis_values(hist, "paused"), name
        assert nemesis_values(hist, "resumed"), name
    if name == "c4":
        bad = [k for k, r in res["indep"]["results"].items()
               if r["valid"] is False]
        witnesses = sorted(run_dir.glob("linear*.json"))
        assert bad and witnesses, name
        w = json.loads(witnesses[0].read_text())
        assert w["valid"] is False and w.get("op"), w
        assert res["indep"]["results"][bad[0]]["linear"]["failed_op"]


def invalid_keys(res: dict) -> list:
    return sorted(k for k, r in res["indep"]["results"].items()
                  if r["valid"] is not True)


def phase_cluster(dev, root: Path) -> dict:
    """Runs (c1)-(c4) of CLUSTER_RUNS side by side, each in a process of
    its own through cluster_child, its check on `dev`; then each run
    directory re-checked in this process by `analyze --device cpu` (the
    same valid and linear fields) and (c1) and (c4) by `analyze --backend
    oracle` (the same valid and invalid keys). Returns the rows by run."""
    util = cluster_util()
    procs, rows, logs = {}, {}, []
    try:
        for name, flags, want_rc, cohosted in CLUSTER_RUNS:
            run_root = root / name
            port_map = None
            if cohosted:
                ports = [util.free_port() for _ in range(4)]
                port_map = (f"localhost={ports[0]}/{ports[1]},"
                            f"127.0.0.1={ports[2]}/{ports[3]}")
            env = util.cluster_env(run_root, port_map, settle_s=1.0)
            argv = ["test", *CLUSTER_COMMON, *flags,
                    "--store", str(run_root / "store"),
                    "--device", dev.type]
            logs.append(open(run_root / "child.log", "w"))
            procs[name] = (subprocess.Popen(
                [sys.executable, "-c",
                 "import sys, chip_smoke; sys.exit(chip_smoke."
                 "cluster_child(sys.argv[1], sys.argv[2:]))",
                 str(run_root / "child.json"), *argv],
                cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=logs[-1], text=True), time.perf_counter())
        for name, (p, t0) in procs.items():
            out, _ = p.communicate(timeout=300)
            rows[name] = {"wall_s": time.perf_counter() - t0, "out": out}
    finally:
        for name, (p, _t0) in procs.items():
            if p.poll() is None:
                p.kill()
                p.wait()
            left = kill_daemons(root / name)
            assert not left, (name, "daemons left", left)
        for f in logs:
            f.close()
    # Launches of the grouped sweep (the scheduler's buckets, row 2) and of
    # the single-history route (a key re-checked alone, row 1).
    grouped_total, single_total = 0, 0
    for name, flags, want_rc, _cohosted in CLUSTER_RUNS:
        run_root = root / name
        child = json.loads((run_root / "child.json").read_text()) \
            if (run_root / "child.json").is_file() else None
        assert child is not None, (name, (run_root / "child.log")
                                   .read_text()[-3000:])
        line = json.loads(rows[name]["out"].splitlines()[-1])
        run_dir = next((run_root / "store").glob("*/*/results.json")).parent
        res = json.loads((run_dir / "results.json").read_text())
        routes = key_routes(res)
        row = {"rc": child["rc"], "valid": line["valid"],
               "op_count": line["op_count"],
               "run_seconds": line["run_seconds"],
               "wall_s": rows[name]["wall_s"],
               "check_s": child["check_s"][0],
               "key_count": res["indep"].get("key_count"),
               "routes": routes, "launches": child["launches"],
               "apt_get": (run_root / "apt-get.log").read_text()
               .splitlines() if (run_root / "apt-get.log").is_file()
               else []}
        assert row["rc"] == want_rc, (name, row,
                                      (run_root / "child.log")
                                      .read_text()[-3000:])
        assert line["valid"] is (want_rc == 0), (name, row)
        assert line["op_count"] >= CLUSTER_MIN_OPS[name], row
        if dev.type == "cuda":
            # No fallback: every key was checked on the card, (c1)'s
            # through the dense sweep.
            assert all("cuda" in b for b in routes), routes
            assert name != "c1" or \
                row["launches"]["dense_sweep_grouped"] >= 1, row
        grouped_total += row["launches"]["dense_sweep_grouped"]
        single_total += (row["launches"]["dense_sweep"]
                         - row["launches"]["dense_sweep_grouped"])
        check_cluster_run(name, row["rc"], line, res, run_dir, run_root)
        row["recheck_s"] = recheck(name, run_dir, row["rc"], line,
                                   verdict_fields(res))
        if name in ("c1", "c4"):
            t0 = time.perf_counter()
            arc, alines = run_cli(["analyze", str(run_dir), "--backend",
                                   "oracle", "--device", dev.type])
            row["oracle_s"] = time.perf_counter() - t0
            again = json.loads((run_dir / "results.json").read_text())
            assert arc == row["rc"] and json.loads(alines[-1]) == {
                "valid": line["valid"]}, (name, arc, alines)
            assert invalid_keys(again) == invalid_keys(res), name
            assert set(key_routes(again)) == {"oracle"}, key_routes(again)
        emit({"phase": "cluster_run", "name": name, **row})
        rows[name] = row
    emit({"phase": "cluster", "ok": True,
          "exit_codes": {n: r["rc"] for n, r in rows.items()},
          "op_count": {n: r["op_count"] for n, r in rows.items()},
          "check_s": {n: r["check_s"] for n, r in rows.items()},
          "recheck_s": {n: r["recheck_s"] for n, r in rows.items()},
          "dense_sweep_launches": {"grouped": grouped_total,
                                   "single": single_total},
          "apt_get": {n: r["apt_get"] for n, r in rows.items()}})
    return {"wgl3_sweep[corpus]": grouped_total,
            "wgl3_sweep[single]": single_total}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)}")
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from jepsen_etcd_demo_tpu_torch.ops import build

    dev = torch.device("cuda")
    card = smi()
    t0 = time.perf_counter()
    build.load_all(LIBS)
    emit({"phase": "build", "ok": True, "seconds": time.perf_counter() - t0,
          "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "ptxas": {n: [ln for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln]
                    for n, log in build.build_log.items()}})
    kernels: list[tuple[dict, Bound]] = []
    elle_rec: dict = {}
    peak: dict = {}
    global_rec: dict = {}
    test_rows: dict = {}
    stream_launches: dict = {}
    cluster_launches: dict = {}
    serve_launches: dict = {}
    runs = {"peak": lambda: phase_peak(dev, kernels, peak),
            "kernel": lambda: phase_kernel(dev),
            "long_kernel": lambda: phase_long_kernel(dev),
            "general_kernel": lambda: phase_general_kernel(dev, kernels,
                                                           global_rec),
            "elle_kernel": lambda: phase_elle_kernel(dev, elle_rec),
            "corpus": lambda: phase_corpus(dev, kernels),
            "single": lambda: phase_single(dev, kernels),
            "long": lambda: phase_long(dev, kernels),
            "sparse": lambda: phase_sparse(dev, kernels),
            "independent": lambda: phase_independent(dev),
            "general": lambda: phase_general(dev, global_rec),
            "families": lambda: phase_families(dev),
            "encode": lambda: phase_encode(dev),
            "elle": lambda: phase_elle(dev, elle_rec),
            "cli": phase_cli,
            "test": lambda: test_rows.update(phase_test(dev, work / "test")),
            "replay": lambda: phase_replay(dev, kernels, test_rows),
            "serve": lambda: serve_launches.update(phase_serve(dev)),
            "stream": lambda: stream_launches.update(
                phase_stream(dev, test_rows)),
            "cluster": lambda: cluster_launches.update(
                phase_cluster(dev, work / "cluster"))}
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        for name in PHASES:
            if name in phases:
                t0 = time.perf_counter()
                runs[name]()
                emit({"phase_seconds": name, "s": time.perf_counter() - t0})
    if "ms" in elle_rec:
        kernels.append(elle_record(elle_rec))
    for rec, _b in kernels:
        if rec["name"] in stream_launches:
            rec["stream_launches"] = stream_launches[rec["name"]]
        if rec["name"] in cluster_launches:
            rec["cluster_launches"] = cluster_launches[rec["name"]]
        if rec["name"] in serve_launches:
            rec["serve_launches"] = serve_launches[rec["name"]]
    print(card, flush=True)
    emit({"kernels": kernels_line(kernels, peak.get("card"))})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    sys.exit(main())
