"""The port's int32 ALU-peak probe (ops/peak.py) on the CPU.

The plain version `alu_peak_reference` is held exactly against a numpy
uint32 transcription of the Pallas kernel body of bench.py's
`_peak_microbench` (bench.py:125-140). That function itself cannot serve
as the reference: it reads and writes bench_baseline.json and times its
kernel from a profiler trace. The kernel, csrc/alu_peak.cu, runs only on
the card (tests/test_torch_cuda.py); here the wrapper runs its plain
version because its input lies on the CPU.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import chip_smoke
from jepsen_etcd_demo_tpu_torch.ops import peak as pk


def _bench_kernel_np(x: np.ndarray, iters: int) -> np.ndarray:
    """bench.py:125-140 in numpy uint32: 8 chains x + k, each iteration
    xor, or with the left shift by one, and, add the index; the OR."""
    accs = [x + np.uint32(k) for k in range(8)]
    for i in range(iters):
        out = []
        for a in accs:
            a = a ^ np.uint32(0x9E3779B9)
            a = a | (a << np.uint32(1))
            a = a & np.uint32(0x7FFFFFFF)
            a = a + np.uint32(i)
            out.append(a)
        accs = out
    acc = accs[0]
    for a in accs[1:]:
        acc = acc | a
    return acc


@pytest.mark.parametrize("seed,n,iters", [(0, 1024, 0), (1, 1024, 3),
                                          (2, 37, 50), (3, 256, 257),
                                          (4, 5, 600)])
def test_reference_equals_bench_kernel(seed, n, iters):
    x = np.random.default_rng(seed).integers(0, 2**32, size=n,
                                             dtype=np.uint32)
    want = _bench_kernel_np(x, iters)
    got = pk.alu_peak_reference(torch.from_numpy(x.view(np.int32)), iters)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_wrapper_on_cpu_runs_the_plain_version_of_benchs_input():
    """bench.py's own input, arange over u32[8,128], through the wrapper
    with device='cpu': the plain version, no launch counted."""
    pk.reset_launches()
    out, ops = pk.alu_peak(1024, 40, device="cpu")
    want = _bench_kernel_np(np.arange(1024, dtype=np.uint32), 40)
    np.testing.assert_array_equal(out.numpy().view(np.uint32), want)
    assert ops == 40 * 8 * 5 * 1024
    assert pk.launches["alu_peak"] == 0


def test_ops_count_is_benchs():
    # bench.py: peak = ITERS * UNROLL * OPS * SP * W / dev_s, with
    # ITERS, UNROLL, OPS, SP, W = 200_000, 8, 5, 8, 128.
    assert pk.ITERS == 200_000 and pk.CHAINS == 8 and pk.OPS == 5
    assert pk.word_ops(8 * 128, pk.ITERS) == 200_000 * 8 * 5 * 8 * 128
    assert pk.word_ops(0, 10) == 0
    assert pk.word_ops(3, 7) == 7 * 40 * 3


def test_measure_and_bad_inputs_raise_on_cpu():
    with pytest.raises(ValueError, match="times the card"):
        pk.measure_peak(device="cpu")
    with pytest.raises(ValueError, match="int32"):
        pk._run(torch.arange(4, dtype=torch.int64), 1)
    with pytest.raises(ValueError, match="iters"):
        pk._run(torch.arange(4, dtype=torch.int32), -1)


SASS = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_115alu_peak_kernelEPKjPjii
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   S2R R0, SR_CTAID.X ;
        /*0020*/              @!P0 BRA 0x90 ;
        /*0030*/                   LOP3.LUT R2, R2, 0x9e3779b9, RZ, 0x3c, !PT ;
        /*0040*/                   IMAD.SHL.U32 R3, R2, 0x2, RZ ;
        /*0050*/                   LOP3.LUT R2, R2, 0x7fffffff, R3, 0xe0, !PT ;
        /*0060*/                   IADD3 R2, R2, R4, RZ ;
        /*0070*/                   ISETP.NE.AND P0, PT, R4, R5, PT ;
        /*0080*/               @P0 BRA 0x30 ;
        /*0090*/                   LOP3.LUT R2, R2, 0x9e3779b9, RZ, 0x3c, !PT ;
        /*00a0*/                   IADD3 R2, R2, R4, RZ ;
        /*00b0*/               @P1 BRA 0x90 ;
        /*00c0*/                   STG.E [R6.64], R2 ;
        /*00d0*/                   EXIT ;
		Function : other_kernel
        /*0000*/                   IADD3 R2, R2, R4, RZ ;
        /*0010*/                   BRA 0x0 ;
"""


def test_sass_loop_takes_the_largest_backward_loop():
    got = chip_smoke.sass_loop(SASS, "alu_peak_kernel", 2)
    assert got["body_instructions"] == 6
    assert got["per_iteration"] == 3.0
    assert got["opcodes_per_iteration"] == {"BRA": 0.5, "IADD3": 0.5,
                                            "IMAD": 0.5, "ISETP": 0.5,
                                            "LOP3": 1.0}
    assert chip_smoke.sass_loop(SASS, "other_kernel",
                                1)["body_instructions"] == 2
    with pytest.raises(ValueError, match="no SASS"):
        chip_smoke.sass_loop(SASS, "missing_kernel", 1)
    with pytest.raises(ValueError, match="backward"):
        chip_smoke.sass_loop(SASS.replace("BRA 0x30", "BRA 0xf0")
                     .replace("BRA 0x90", "BRA 0xf0"), "alu_peak_kernel", 1)


def test_smoke_bound_counts_the_int32_operations():
    """chip_smoke's sweep bound keeps the int32 operations it divided by
    the data-sheet rate; the kernels line divides them again by the
    measured peak (bound_measured_ms), never below the byte time."""
    from jepsen_etcd_demo_tpu_torch.models import CASRegister
    from jepsen_etcd_demo_tpu_torch.ops import wgl3, wgl3_kernels as wk
    from jepsen_etcd_demo_tpu_torch.ops.encode import encode_register_history
    from jepsen_etcd_demo_tpu_torch.utils.fuzz import gen_register_history
    import random

    model = CASRegister()
    h = gen_register_history(random.Random(5), n_ops=80, n_procs=6,
                             p_info=0.0)
    enc = encode_register_history(h, k_slots=32)
    cfg, steps, r_cap = wgl3.batch_steps3([enc], model)
    ln, tg, cm = wk.prepare_colmask(model, cfg, *wgl3.stack_steps3(
        steps, r_cap, torch.device("cpu")))
    b = chip_smoke.bound(cfg, (ln, tg, cm), [-1])
    assert b.int32_ops > 0
    t_ops = b.int32_ops / chip_smoke.INT32_OPS_PER_S * 1e3
    assert b.ms == pytest.approx(max(t_ops, b.bytes_ms))
    assert b.by == ("operations" if t_ops >= b.bytes_ms else "bytes")
    # At twice the data-sheet rate the operations take half the time.
    assert b.measured_ms(2 * chip_smoke.INT32_OPS_PER_S) == pytest.approx(
        max(t_ops / 2, b.bytes_ms))
    assert b.measured_ms(None) is None
    rec = chip_smoke.record("wgl3_sweep[single]", 1, 0, 1.0, 2.0, b)
    assert rec["bound_ms"] == b.ms and rec["bound_by"] == b.by
    assert rec["replaces"].endswith("wgl3_pallas.py:169")
    # The kernels line adds bound_measured_ms from the record's Bound.
    line = chip_smoke.kernels_line([(rec, b)], 2 * chip_smoke.INT32_OPS_PER_S)
    assert line == [{**rec, "bound_measured_ms": b.measured_ms(
        2 * chip_smoke.INT32_OPS_PER_S)}]
    assert "bound_measured_ms" not in rec
    assert chip_smoke.kernels_line([(rec, b)], None)[0][
        "bound_measured_ms"] is None
    json.dumps(line)


@pytest.mark.parametrize("instr,issue,nbytes,by", [
    (41.75 * 200_000 * 135_168, 33.45408e12, 2 * 135_168 * 4, "operations"),
    (10.0, 1e12, 10**9, "bytes")])
def test_probe_bound_is_its_instructions_over_the_issue_rate(instr, issue,
                                                             nbytes, by):
    """The probe's bound counts its SASS instructions over the card's
    issue rate, not word-ops over the int32 rate it measures, so it has
    no bound_measured_ms."""
    b = chip_smoke.probe_bound(instr, issue, nbytes)
    t_bytes = nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3
    assert b.ms == pytest.approx(max(instr / issue * 1e3, t_bytes))
    assert b.by == by and b.int32_ops is None
    assert b.measured_ms(27e12) is None
    rec = chip_smoke.record("alu_peak", 8, 0, 40.0, 9000.0, b)
    assert rec["replaces"] == "bench.py:125" and rec["max_abs_err"] == 0
    assert chip_smoke.kernels_line([(rec, b)], 27e12)[0][
        "bound_measured_ms"] is None


@pytest.mark.parametrize("t_ops,t_bytes,by", [(2.0, 1.0, "operations"),
                                              (1.0, 2.0, "bytes")])
def test_smoke_bound_takes_the_larger_time(t_ops, t_bytes, by):
    b = chip_smoke.Bound.of(t_ops, t_bytes)
    assert (b.ms, b.by, b.bytes_ms) == (2.0, by, t_bytes)
    # Operations off the int32 rate (the accumulate's int8) have no
    # measured bound.
    assert b.measured_ms(1e12) is None
