"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --phases kernel # a subset, for debugging

Drives the port's main paths, the register linearizability check,
through the entry points a user calls, on the card, at the sizes of the
JAX package's baseline and long-history lanes: a 1024-history corpus of
150-op histories at concurrency 10, one 10k-op history, the 100k-op
history of the `bench_long` recipe (68,734 return steps, five windows of
the resumable sweep) and an invalid mutant of it, a 50k-op history at
concurrency 16 through the sparse work-list sweep and the dense one, and
10 independent keys of 1000 ops. It builds the CUDA kernels from csrc/
(one nvcc per source, side by side), holds each exactly equal to its
plain PyTorch version on the card, checks verdicts against the host
oracle and the whole-scan kernel, and shows through the launch counters
that each main path ran on its kernel.

Output: one JSON line per phase; then the card's name and power limit as
nvidia-smi reports them; then one JSON line describing each kernel; and
last {"ok": true, "device": {...}}. Any failure raises and exits nonzero.
Without a CUDA device it prints no result and exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
PHASES = ("kernel", "long_kernel", "corpus", "single", "long", "sparse",
          "independent", "cli")
LIBS = ("wgl3_sweep", "wgl3_sparse")
CSRC = "jepsen_etcd_demo_tpu_torch/csrc"
PALLAS = "jepsen_etcd_demo_tpu/ops/wgl3_pallas.py"
# record name -> (source, TPU kernel it replaces)
KERNELS = {"wgl3_sweep[corpus]": (f"{CSRC}/wgl3_sweep.cu", f"{PALLAS}:1132"),
           "wgl3_sweep[single]": (f"{CSRC}/wgl3_sweep.cu", f"{PALLAS}:169"),
           "wgl3_sweep[resume]": (f"{CSRC}/wgl3_sweep.cu", f"{PALLAS}:366"),
           "wgl3_sparse": (f"{CSRC}/wgl3_sparse.cu", f"{PALLAS}:610")}
# Sizes of the long paths (the bench_long recipe and the sparse lane).
LONG_OPS, SPARSE_OPS = 100_000, 50_000
LONG_DEAD_AFTER = 40_000     # the long mutant dies past this return step
# H100 SXM data-sheet rates: HBM3 at 3.35 TB/s; int32 issue = the 67
# TFLOP/s float32 rate (FMA = 2 ops, 128 lanes per SM) over 4, since an SM
# has 64 int32 lanes and an integer op counts once.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


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


def bound(cfg, inputs, dead_step, launches: int = 1, carry: bool = False,
          live_frac: float = 1.0) -> tuple[float, str]:
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
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def prepared(encs, model, dev):
    from jepsen_etcd_demo_tpu_torch.ops import wgl3, wgl3_kernels as wk

    cfg, steps, r_cap = wgl3.batch_steps3(encs, model)
    arrays = wgl3.stack_steps3(steps, r_cap, dev)
    return cfg, wk.prepare_colmask(model, cfg, *arrays)


def record(name, launches, err, ms, plain_ms, bound_pair) -> dict:
    source, replaces = KERNELS[name]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_pair[0],
            "bound_by": bound_pair[1], "library_ms": None}


def kernel_record(name, cfg, inputs, row0, launches, reps) -> dict:
    """Whole-scan kernel vs plain on the card (exact), times and bound."""
    from jepsen_etcd_demo_tpu_torch.ops import wgl3_kernels as wk

    ln, tg, cm = inputs
    ms, got = cuda_ms(lambda: wk.dense_sweep(ln, tg, cm, cfg, row0), reps)
    # The plain version has nothing to compile: its one timed run is also
    # the run the kernel is held against.
    plain_ms, want = cuda_ms(
        lambda: wk.sweep_reference(ln, tg, cm, cfg, row0), 1, warm=False)
    err = int((got.long() - want.long()).abs().max().item())
    assert err == 0, f"{name}: kernel and plain version differ by {err}"
    return record(name, launches, err, ms, plain_ms,
                  bound(cfg, inputs, got[:, 2].cpu().numpy()))


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
                  reps) -> dict:
    """The first full window of the long route (long_window() steps of rs)
    through the resumable kernel and its plain version on the card, from
    a fresh carry: exactly equal table and meta; times and bound."""
    from jepsen_etcd_demo_tpu_torch.ops import wgl3_kernels as wk

    window = wk.long_window()
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
    return record(name, launches, err, ms, plain_ms,
                  bound(cfg, (ln, tg, cm), [m[1]], 1, True, live_frac))


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
        torch.cuda.synchronize()
        assert torch.equal(got, want), (S, K, got.tolist(), want.tolist())
        rows.append({"S": S, "K": K, "histories": len(steps),
                     "r_cap": r_cap,
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
                                 "S": S, "K": K, "mutant": mutate,
                                 "thresh": thresh, "windows": n_win,
                                 "steps": rs.n_steps, "dead_step": m[1],
                                 "max_frontier": m[2],
                                 "sparse_steps": m[6] if sp else None,
                                 "live_sum": m[5] if sp else None})
    assert any(r["dead_step"] >= 0 for r in rows)
    emit({"phase": "long_kernel_vs_plain", "ok": True, "window": window,
          "chains": rows})


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


def make_corpus():
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
    return hists, enc, menc


def phase_corpus(dev, kernels) -> None:
    from jepsen_etcd_demo_tpu_torch.checkers.oracle import check_events_oracle
    from jepsen_etcd_demo_tpu_torch.models import CASRegister
    from jepsen_etcd_demo_tpu_torch.ops import wgl3, wgl3_kernels as wk

    model = CASRegister()
    t0 = time.perf_counter()
    _hists, enc, menc = make_corpus()
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
    rec = kernel_record("wgl3_sweep[corpus]", cfg, inputs,
                        wgl3.init_row(model, cfg), n_launch, reps=20)
    kernels.append(rec)
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
    rec = kernel_record("wgl3_sweep[single]", cfg, inputs,
                        wgl3.init_row(model, cfg), n_launch, reps=3)
    assert res["max_frontier"] > 0
    kernels.append(rec)
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

    rec = window_record("wgl3_sweep[resume]", model, cfg, rs, dev, False, 0,
                        counts["dense_sweep_resumable"], reps=3)
    kernels.append(rec)

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
          "mutant": {"dead_step": bad["dead_step"],
                     "failed_op": bad["failed_op"], "witness_rung": rung,
                     "window_start_step": witness.get("window_start_step"),
                     "check_s": bad_s, "launches": bad_counts}})


def phase_sparse(dev, kernels) -> None:
    """A 50k-op history at concurrency 16 (K=16: 16 blocks of 128 words)
    through Linearizable twice: under sparse_mode=2 on the sparse kernel,
    then under the default limits on the resumable dense kernel; the
    verdict fields agree."""
    from dataclasses import replace

    from jepsen_etcd_demo_tpu_torch.checkers import Linearizable
    from jepsen_etcd_demo_tpu_torch.models import CASRegister
    from jepsen_etcd_demo_tpu_torch.ops import wgl3_kernels as wk
    from jepsen_etcd_demo_tpu_torch.ops.limits import limits, set_limits

    model = CASRegister()
    h, enc, cfg, rs, encode_s = long_setup(model, SPARSE_OPS, 16,
                                            0x10C0 + SPARSE_OPS)
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
    rec = window_record("wgl3_sparse", model, cfg, rs, dev, True, nb,
                        runs[2][2]["sparse_sweep_resumable"], reps=2)
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
    kernels.append(rec)
    emit({"phase": "sparse_50k", "ok": True, "ops": SPARSE_OPS,
          "steps": rs.n_steps, "k_slots": cfg.k_slots,
          "n_states": cfg.n_states, "blocks": cfg.n_words // 128,
          "encode_s": encode_s,
          "sparse_mode2": {"check_s": sparse_s, "launches": sparse_counts,
                           **stats[2]},
          "default": {"check_s": dense_s, "launches": dense_counts,
                      **stats[0]},
          "max_frontier": dense_res["max_frontier"],
          "configs_explored": dense_res["configs_explored"],
          "window_kernel_ms": rec["ms"], "window_plain_ms": rec["plain_ms"]})


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
          "check_s": check_s})


def phase_cli() -> None:
    from jepsen_etcd_demo_tpu_torch.ops.op import history_to_jsonl
    from jepsen_etcd_demo_tpu_torch.utils.fuzz import gen_register_history

    rng = random.Random(0xC11)
    valid = gen_register_history(rng, n_ops=150, n_procs=10, p_info=0.002)
    invalid = invalid_mutant(valid, 0xC12)
    rcs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, h, want in (("valid", valid, 0), ("invalid", invalid, 1)):
            path = Path(tmp) / f"{name}.jsonl"
            path.write_text(history_to_jsonl(h))
            p = subprocess.run(
                [sys.executable, "-m", "jepsen_etcd_demo_tpu_torch.cli",
                 "analyze", str(path)], cwd=ROOT, capture_output=True,
                text=True, timeout=600)
            rcs[name] = p.returncode
            assert p.returncode == want, (name, p.returncode, p.stdout,
                                          p.stderr[-2000:])
            if name == "invalid":
                assert json.loads(p.stdout)["failed_op"], p.stdout
    emit({"phase": "cli_analyze", "ok": True, "exit_codes": rcs})


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
    kernels: list[dict] = []
    runs = {"kernel": lambda: phase_kernel(dev),
            "long_kernel": lambda: phase_long_kernel(dev),
            "corpus": lambda: phase_corpus(dev, kernels),
            "single": lambda: phase_single(dev, kernels),
            "long": lambda: phase_long(dev, kernels),
            "sparse": lambda: phase_sparse(dev, kernels),
            "independent": lambda: phase_independent(dev),
            "cli": phase_cli}
    for name in PHASES:
        if name in phases:
            t0 = time.perf_counter()
            runs[name]()
            emit({"phase_seconds": name, "s": time.perf_counter() - t0})
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    sys.exit(main())
