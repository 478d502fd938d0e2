"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --phases kernel # a subset, for debugging

Drives the port's main path, the register linearizability check, through
the entry points a user calls, on the card, at the sizes of the JAX
package's baseline: a 1024-history corpus of 150-op histories at
concurrency 10, one 10k-op history, and 10 independent keys of 1000 ops.
It builds the CUDA kernel from csrc/, holds it exactly equal to its plain
PyTorch version on the card, checks verdicts against the host oracle, and
shows through the launch counter that the main path ran on the kernel.

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
PHASES = ("kernel", "corpus", "single", "independent", "cli")
SOURCE = "jepsen_etcd_demo_tpu_torch/csrc/wgl3_sweep.cu"
REPLACES = {"corpus": "jepsen_etcd_demo_tpu/ops/wgl3_pallas.py:1132",
            "single": "jepsen_etcd_demo_tpu/ops/wgl3_pallas.py:169"}
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


def bound(cfg, inputs, packed) -> tuple[float, str]:
    """Least time for the sweep's work on this card, counted from this
    run's data. Only the steps each history needs (up to its death) count;
    each reads its column masks and target once. Its closure is at least
    one sweep, in which each nonzero column mask cm[b,r,d,j] with m bits
    costs m+1 int32 operations (m gathering ORs, one fused AND/OR merge)
    on each word slot j may fire from: W words for j < 5, the W/2 source
    words for j >= 5, half of either when the target t >= 5 banks the
    words with bit t set (not for j == t, whose sources all have it
    clear). Each step adds a popcount pass (popc and add) and a prune pass
    over the S*W words. The larger of bytes over the HBM rate and int32
    operations over the int32 issue rate."""
    import numpy as np

    S, K, W = cfg.n_states, cfg.k_slots, cfg.n_words
    ln, tg, cm = (x.cpu().numpy() for x in inputs)
    dead = packed[:, 2].astype(np.int64)
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
    ops = int(sweep[live].sum()) + steps * 3 * S * W
    b = len(ln)
    nbytes = steps * (S * K + 1) * 4 + b * 4 + b * 5 * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def prepared(encs, model, dev):
    from jepsen_etcd_demo_tpu_torch.ops import wgl3, wgl3_kernels as wk

    cfg, steps, r_cap = wgl3.batch_steps3(encs, model)
    arrays = wgl3.stack_steps3(steps, r_cap, dev)
    return cfg, wk.prepare_colmask(model, cfg, *arrays)


def kernel_record(name, cfg, inputs, row0, launches, reps) -> dict:
    """Kernel vs plain on the card (exact), times and bound."""
    from jepsen_etcd_demo_tpu_torch.ops import wgl3_kernels as wk

    ln, tg, cm = inputs
    ms, got = cuda_ms(lambda: wk.dense_sweep(ln, tg, cm, cfg, row0), reps)
    # The plain version has nothing to compile: its one timed run is also
    # the run the kernel is held against.
    plain_ms, want = cuda_ms(
        lambda: wk.sweep_reference(ln, tg, cm, cfg, row0), 1, warm=False)
    err = int((got.long() - want.long()).abs().max().item())
    assert err == 0, f"{name}: kernel and plain version differ by {err}"
    bound_ms, bound_by = bound(cfg, inputs, got.cpu().numpy())
    return {"name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name.split("[")[1].rstrip("]")],
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


def phase_kernel(dev) -> None:
    """The kernel against its plain version on the card, over every
    geometry class dense_config admits, ragged batches with pads."""
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

    wk.launches = 0
    split: dict[str, float] = {}
    t0 = time.perf_counter()
    res, kname = wk.check_batch_encoded_auto(enc, model, dev, timings=split)
    check_s = time.perf_counter() - t0
    n_launch = wk.launches
    assert n_launch > 0, "corpus check did not launch the kernel"
    assert all(r["valid"] is True for r in res), "a valid history failed"

    wk.launches = 0
    mres, _ = wk.check_batch_encoded_auto(menc, model, dev)
    assert wk.launches > 0
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
    wk.launches = 0
    t0 = time.perf_counter()
    res = lin.check({}, h)
    torch.cuda.synchronize()
    check_s = time.perf_counter() - t0
    n_launch = wk.launches
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
    wk.launches = 0
    t0 = time.perf_counter()
    got = IndependentChecker(Linearizable(device=dev)).check({}, ops)
    torch.cuda.synchronize()
    check_s = time.perf_counter() - t0
    n_launch = wk.launches
    assert n_launch > 0, "independent check did not launch the kernel"
    want = IndependentChecker(Linearizable(device="cpu")).check({}, ops)
    fields = ("valid", "dead_step", "max_frontier", "configs_explored")
    for k, r in got["results"].items():
        assert all(r[f] == want["results"][k][f] for f in fields), k
    assert got["valid"] == want["valid"] is False
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
    build.load("wgl3_sweep")
    emit({"phase": "build", "ok": True, "seconds": time.perf_counter() - t0,
          "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "ptxas": {n: [ln for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln]
                    for n, log in build.build_log.items()}})
    kernels: list[dict] = []
    runs = {"kernel": lambda: phase_kernel(dev),
            "corpus": lambda: phase_corpus(dev, kernels),
            "single": lambda: phase_single(dev, kernels),
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
