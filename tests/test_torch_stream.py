"""The streaming check of the port (`test --check-mode stream`) against
the JAX package's, on the CPU (`device="cpu"`: the kernels' plain
versions): the incremental encoder, the WGL stream (KeyStream,
StreamSession, session_for_test), a JAX stream's carry finished in the
port, the elle stream, and whole runs with and without --fail-fast.
Every compared field must be equal: the tolerance is exact."""

from __future__ import annotations

import asyncio
import json
import random
import time
from dataclasses import replace

import numpy as np
import pytest

from jepsen_etcd_demo_tpu.checkers.elle import ElleChecker as JElle
from jepsen_etcd_demo_tpu.models import CASRegister as JCAS
from jepsen_etcd_demo_tpu.ops import encode as jenc
from jepsen_etcd_demo_tpu.ops import limits as jlimits
from jepsen_etcd_demo_tpu.ops.op import Op as JOp
from jepsen_etcd_demo_tpu.stream import ElleStreamSession as JElleStream
from jepsen_etcd_demo_tpu.stream import StreamSession as JSession
from jepsen_etcd_demo_tpu.stream.engine import KeyStream as JKeyStream
from jepsen_etcd_demo_tpu.utils import fuzz as jfuzz
from jepsen_etcd_demo_tpu_torch import carry, cli
from jepsen_etcd_demo_tpu_torch.checkers import (Compose, ElleChecker,
                                                 IndependentChecker,
                                                 Linearizable)
from jepsen_etcd_demo_tpu_torch.compose import fake_test
from jepsen_etcd_demo_tpu_torch.models import CASRegister
from jepsen_etcd_demo_tpu_torch.ops import encode as penc
from jepsen_etcd_demo_tpu_torch.ops import limits as plimits
from jepsen_etcd_demo_tpu_torch.ops import wgl3
from jepsen_etcd_demo_tpu_torch.ops import wgl3_kernels as wk
from jepsen_etcd_demo_tpu_torch.ops.op import Op as POp
from jepsen_etcd_demo_tpu_torch.runner import run_test
from jepsen_etcd_demo_tpu_torch.store import Store
from jepsen_etcd_demo_tpu_torch.stream import (ElleStreamSession, KeyStream,
                                               StreamSession,
                                               session_for_test)
from jepsen_etcd_demo_tpu_torch.utils import fuzz as pfuzz

from golden import GOLDEN
from torch_port_util import (edge_history, one_device,  # noqa: F401
                             pin, port_ops)

JMODEL, MODEL = JCAS(), CASRegister()
VERDICT = ("valid", "survived", "dead_step", "max_frontier",
           "configs_explored")
LINEAR = ("valid", "dead_step", "max_frontier", "configs_explored")


@pytest.fixture
def small(pin):
    """Chunks of 16 steps and a death poll after every chunk, in both
    packages, with the JAX package's search (no canonicalisation, no
    subsumption)."""
    pin(stream_flush_ops=16, stream_max_lag_chunks=1, dedup_mode=1)


def fuzz(seed: int, n_ops: int, n_procs: int, p_info: float,
         mutate: bool = False) -> list:
    h = jfuzz.gen_register_history(random.Random(seed), n_ops=n_ops,
                                   n_procs=n_procs, p_info=p_info)
    return jfuzz.mutate_history(random.Random(seed), h) if mutate else h


def jop(typ, f, value, process, **kw):
    return JOp(type=typ, f=f, value=value, process=process, **kw)


def posthoc(h) -> dict:
    """The port's post-hoc check of a JAX-package history."""
    return Linearizable(MODEL, device="cpu").check({}, port_ops(h))


def both_streams(h, flush_every: int = 0):
    """The history fed op by op into a JAX KeyStream and a port KeyStream
    (with flush_partial after every `flush_every`-th op): both finalized
    streams and their results."""
    js = JKeyStream(JMODEL, None, k_slots=24)
    ps = KeyStream(MODEL, None, k_slots=24, device="cpu")
    for i, (jo, po) in enumerate(zip(h, port_ops(h))):
        js.feed(jo, live=True)
        ps.feed(po, live=True)
        if flush_every and i % flush_every == 0:
            js.flush_partial(live=True)
            ps.flush_partial(live=True)
    return js, ps, js.finalize(), ps.finalize()


def assert_same_stream(js, ps, jres, pres):
    for f in VERDICT:
        assert pres[f] == jres[f], (f, pres[f], jres[f])
    assert np.array_equal(pres["_enc"].events, jres["_enc"].events)
    assert (ps.chunks, ps.restarts, ps.steps_done, ps.real_dispatched) == \
        (js.chunks, js.restarts, js.steps_done, js.real_dispatched)
    assert (ps.cfg.k_slots, ps.cfg.n_states) == \
        (js.cfg.k_slots, js.cfg.n_states)
    assert pres["table_cells"] == jres["table_cells"]


# -- the incremental encoder --------------------------------------------------

def feed_encoders(h):
    """Both packages' IncrementalEncoders over h, compared op by op: the
    same new rows, lag and watermark after every entry."""
    je, pe = jenc.IncrementalEncoder(JMODEL), penc.IncrementalEncoder(MODEL)
    for jo, po in zip(h, port_ops(h)):
        assert pe.append(po) == je.append(jo)
        assert (pe.lag(), pe.watermark()) == (je.lag(), je.watermark())
    assert pe.finalize() == je.finalize()
    return je, pe


def assert_encodings_equal(h, je, pe):
    post = penc.encode_history(port_ops(h), MODEL, k_slots=32)
    for got in (pe.encoded_history(32), je.encoded_history(32)):
        assert np.array_equal(got.events, post.events[: post.n_events])
        assert (got.n_events, got.n_ops, got.k_slots, got.max_pending,
                got.max_value) == (post.n_events, post.n_ops, post.k_slots,
                                   post.max_pending, post.max_value)


@pytest.mark.parametrize("name,hist,_valid", GOLDEN,
                         ids=[g[0] for g in GOLDEN])
def test_incremental_encoder_golden(name, hist, _valid):
    je, pe = feed_encoders(hist)
    assert_encodings_equal(hist, je, pe)


@pytest.mark.parametrize("seed", range(6))
def test_incremental_encoder_fuzz(seed):
    h = fuzz(seed, 250, 8, 0.02, mutate=bool(seed % 2))
    je, pe = feed_encoders(h)
    assert_encodings_equal(h, je, pe)
    assert pe.rows == je.rows


def test_watermark_pins_on_open_and_crashed_ops():
    """An open op pins the watermark: nothing at or after its invoke is
    stable until its completion, even a later op's completed pair; its
    info completion releases it and it stays pending forever."""
    h = [jop("invoke", "write", 1, 0), jop("invoke", "read", None, 1),
         jop("ok", "read", None, 1),
         jop("info", "write", 1, 0, error="timeout")]
    je, pe = jenc.IncrementalEncoder(), penc.IncrementalEncoder()
    for jo, po in zip(h[:3], port_ops(h[:3])):
        assert pe.append(po) == je.append(jo) == []
    assert pe.lag() == je.lag() == 3 and pe.rows == []
    rows = pe.append(port_ops(h[3:])[0])
    assert rows == je.append(h[3])
    assert [r[1] for r in rows] == [0, 1, 1] and pe.lag() == 0
    pe.finalize()
    ev = pe.encoded_history(32).events
    assert not ((ev[:, 0] == penc.EV_RETURN) & (ev[:, 1] == 0)).any()


def test_encoder_rejections_match():
    """The same EncodeErrors: a double invoke, a completion without an
    invoke, and a recorder seq that does not increase (an unstamped op is
    exempt)."""
    for enc_mod, Op in ((jenc, JOp), (penc, POp)):
        e = enc_mod.IncrementalEncoder()
        e.append(Op(type="invoke", f="read", value=None, process=0))
        with pytest.raises(enc_mod.EncodeError):
            e.append(Op(type="invoke", f="read", value=None, process=0))
        with pytest.raises(enc_mod.EncodeError):
            enc_mod.IncrementalEncoder().append(
                Op(type="ok", f="read", value=None, process=9))
        e = enc_mod.IncrementalEncoder()
        e.append(Op(type="invoke", f="read", value=None, process=0, seq=5))
        with pytest.raises(enc_mod.EncodeError, match="out-of-order feed"):
            e.append(Op(type="invoke", f="write", value=1, process=1, seq=5))
        e.append(Op(type="invoke", f="write", value=1, process=1, seq=6))
        e.append(Op(type="invoke", f="read", value=None, process=2))


# -- KeyStream ----------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_key_stream_matches_jax_and_posthoc(small, seed):
    """Valid and mutated histories: every verdict field, the encoding and
    the chunk counts equal the JAX stream's, and the verdict fields the
    port's post-hoc check."""
    h = fuzz(40 + seed, 240, 8, 0.01, mutate=seed >= 2)
    js, ps, jres, pres = both_streams(h)
    assert_same_stream(js, ps, jres, pres)
    assert ps.chunks >= 2
    post = posthoc(h)
    assert all(pres[f] == post[f] for f in LINEAR), (pres, post)
    assert pres["kernel"] == "wgl3-dense-plain-stream-chunked"


def test_geometry_restart(small):
    """Values and concurrency that grow mid-run restart the key under a
    bigger table; the fields still equal the JAX stream's and post-hoc."""
    h = []
    for i in range(24):
        h += [jop("invoke", "write", i % 3, 0), jop("ok", "write", i % 3, 0)]
    for i in range(28):
        v = 20 + i % 9
        h += [jop("invoke", "write", v, 0), jop("ok", "write", v, 0),
              jop("invoke", "read", None, 1), jop("ok", "read", v, 1)]
    js, ps, jres, pres = both_streams(h)
    assert ps.restarts >= 1
    assert_same_stream(js, ps, jres, pres)
    post = posthoc(h)
    assert all(pres[f] == post[f] for f in LINEAR)


def test_crashed_op_pins_every_chunk(small):
    """A long-open op that crashes late holds back every chunk until its
    info completion; the fields then equal the JAX stream's."""
    body = fuzz(7, 120, 6, 0.0)
    h = [jop("invoke", "write", 4, 9), *body,
         jop("info", "write", 4, 9, error="timeout")]
    ps = KeyStream(MODEL, None, device="cpu")
    lag = 0
    for po in port_ops(h[:-1]):
        ps.feed(po, live=True)
        lag = max(lag, ps.encoder.lag())
    assert ps.chunks == 0 and lag >= len(body)
    js, ps, jres, pres = both_streams(h)
    assert_same_stream(js, ps, jres, pres)


@pytest.mark.parametrize("seed", (7, 8))
def test_partial_flush(small, seed):
    """Padded partial chunks mid-stream (fail-fast's eager flush): the
    kernel advances the step offset by the real steps, so dead_step and
    every other field equal the JAX stream's and post-hoc's."""
    h = fuzz(seed, 180, 6, 0.01, mutate=seed % 2 == 0)
    js, ps, jres, pres = both_streams(h, flush_every=23)
    assert ps.steps_done > ps.real_dispatched
    assert_same_stream(js, ps, jres, pres)
    post = posthoc(h)
    assert all(pres[f] == post[f] for f in LINEAR)
    if seed % 2 == 0:
        assert pres["valid"] is False


def test_empty_and_return_free_histories(small):
    ps = KeyStream(MODEL, None, device="cpu")
    assert ps.finalize()["valid"] is True
    h = [jop("invoke", "write", 1, 0)]
    js, ps, jres, pres = both_streams(h)
    assert pres["valid"] is True and pres["op_count"] == 1
    assert all(pres[f] == jres[f] for f in VERDICT)


def test_restart_past_shared_tables_takes_the_global_tier(small,
                                                          monkeypatch):
    """A key whose pending ops grow past 2^20 table bits restarts on the
    global tier (its plain version here) with the JAX stream's fields;
    no 2^26-cell table holds the next size, so that key is left to the
    post-hoc check."""
    calls = {"dense_sweep_resumable": 0, "dense_sweep_global": 0}
    for name in calls:
        def counted(*a, _f=getattr(wk, name), _n=name, **kw):
            calls[_n] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(wk, name, counted)
    pre = []
    for i in range(16):
        pre += [jop("invoke", "write", i % 2, 100),
                jop("ok", "write", i % 2, 100)]
    h = pre + [replace(op, process=op.process + 200)
               for op in edge_history(19, 6, dies=True)]
    js, ps, jres, pres = both_streams(h)
    assert ps.restarts == 1 and wk.global_tier(ps.cfg)
    assert calls["dense_sweep_resumable"] >= 1
    assert calls["dense_sweep_global"] >= 1
    assert_same_stream(js, ps, jres, pres)
    assert pres["valid"] is False
    wide = pre + [replace(op, process=op.process + 200)
                  for op in edge_history(25, 6)]
    ps = KeyStream(MODEL, None, device="cpu")
    for po in port_ops(wide):
        ps.feed(po, live=True)
    assert ps.finalize() is None and ps.infeasible


def test_jax_stream_carry_finishes_in_the_port(small):
    """A stream started in the JAX engine and stopped mid-way: its carry
    through carry.stream_carry_from_numpy, swept on by the port over the
    rest of the steps, gives the JAX stream's final fields; and the way
    back gives the JAX carry's fields."""
    h = fuzz(11, 300, 6, 0.0, mutate=True)
    js = JKeyStream(JMODEL, None, k_slots=24)
    for jo in h[: len(h) // 2]:
        js.feed(jo, live=True)
    assert js.chunks >= 2
    cfg = wgl3.DenseConfig(k_slots=js.cfg.k_slots,
                           n_states=js.cfg.n_states,
                           state_offset=js.cfg.state_offset)
    T, meta = carry.stream_carry_from_numpy(
        np.asarray(js.carry.table), np.asarray(js.carry.dead),
        np.asarray(js.carry.dead_step), np.asarray(js.carry.max_frontier),
        None if js.parts is None else np.asarray(js.parts),
        js.real_dispatched, cfg)
    back = carry.stream_carry_to_numpy(T, meta, cfg)
    assert np.array_equal(back["table"], np.asarray(js.carry.table))
    assert back["real_dispatched"] == js.real_dispatched
    assert (back["dead"], back["dead_step"], back["max_frontier"]) == (
        bool(js.carry.dead), int(js.carry.dead_step),
        int(js.carry.max_frontier))
    assert back["parts"][0] == np.asarray(js.parts)[0]
    for jo in h[len(h) // 2:]:
        js.feed(jo, live=True)
    jres = js.finalize()
    assert (js.cfg.k_slots, js.cfg.n_states) == (cfg.k_slots, cfg.n_states)
    enc = penc.encode_history(port_ops(h), MODEL, k_slots=cfg.k_slots)
    rs = penc.encode_return_steps(enc)
    _T, meta = wk.run_chain(rs, MODEL, cfg, "cpu", carry=(T, meta))
    got = wk.long_result(meta[0].tolist())
    assert all(got[f] == jres[f] for f in VERDICT), (got, jres)
    assert got["valid"] is False


# -- StreamSession ------------------------------------------------------------

def test_keyed_session_multiplex(small):
    """A keyed session splits an interleaved independent-key stream as
    split_by_key does; each key's fields equal the JAX session's and the
    port's post-hoc check's, and the stats agree."""
    rng = random.Random(99)
    per_key = {}
    for k in range(4):
        h = jfuzz.gen_register_history(rng, n_ops=150, n_procs=6,
                                       p_info=0.005)
        per_key[k] = jfuzz.mutate_history(rng, h) if k == 3 else h
    ops = jfuzz.interleave_keyed(per_key, proc_stride=100)
    jsess = JSession(JMODEL, keyed=True, k_slots=24)
    psess = StreamSession(MODEL, keyed=True, device="cpu")
    for jo, po in zip(ops, port_ops(ops)):
        jsess.feed(jo)
        psess.feed(po)
    jres, pres = jsess.finalize(), psess.finalize()
    assert set(pres) == set(jres) == set(per_key)
    for k, h in per_key.items():
        assert all(pres[k][f] == jres[k][f] for f in VERDICT), k
        post = posthoc(h)
        assert all(pres[k][f] == post[f] for f in LINEAR), k
    assert pres[3]["valid"] is False
    js, ps = jsess.stats(), psess.stats()
    for f in ("keys", "streamed_keys", "chunks", "restarts", "steps_total",
              "failfast_aborted"):
        assert ps[f] == js[f], f
    assert ps["keys"] == 4 and ps["chunks"] >= 4


def test_unkeyed_session(small):
    h = fuzz(5, 200, 6, 0.01, mutate=True)
    psess = StreamSession(MODEL, keyed=False, device="cpu")
    jsess = JSession(JMODEL, keyed=False, k_slots=24)
    for jo, po in zip(h, port_ops(h)):
        jsess.feed(jo)
        psess.feed(po)
    pres, jres = psess.finalize()[None], jsess.finalize()[None]
    assert all(pres[f] == jres[f] for f in VERDICT)
    assert pres["valid"] is False
    assert psess.falsified() is jsess.falsified()


def test_session_abandons_unstreamable_shapes():
    """A keyed session fed an op without (key, value) gives up streaming
    (finalize None, a fallback record), as the JAX session does."""
    s = StreamSession(MODEL, keyed=True, device="cpu")
    s.feed(port_ops([jop("invoke", "write", 3, 0)])[0])
    assert s.finalize() is None and "fallback" in s.stats()


def test_session_for_test_topologies(tmp_path):
    """register streams keyed, gset whole; set and mutex (whose model
    rewrites the history) are checked post-hoc; append streams through
    the elle session, txnregister (rw-register) does not."""
    base = dict(store_root=str(tmp_path / "s"), time_limit=1, device="cpu")
    kinds = {}
    for w in ("register", "gset", "set", "mutex", "append", "txnregister"):
        s = session_for_test(fake_test(dict(base, workload=w)))
        kinds[w] = None if s is None else (type(s).__name__,
                                           getattr(s, "keyed", None))
        if s is not None:
            s.finalize()
    assert kinds == {"register": ("StreamSession", True),
                     "gset": ("StreamSession", False), "set": None,
                     "mutex": None, "append": ("ElleStreamSession", None),
                     "txnregister": None}


# -- the elle stream ----------------------------------------------------------

def elle_corpus(seed: int, n: int, txns: int):
    rng = random.Random(seed)
    out = []
    for i in range(n):
        t = pfuzz.gen_append_txns(rng, n_txns=txns, n_keys=4, max_len=3)
        if i % 2:
            t = pfuzz.mutate_append_txns(rng, t)
        out.append(pfuzz.append_txn_ops(t))
    return out


@pytest.mark.parametrize("realtime", [False, True])
def test_elle_stream_matches_posthoc_and_jax(realtime):
    """ElleStreamSession's result equals the post-hoc ElleChecker's, and
    every field but `backend` equals the JAX session's, valid and
    anomalous."""
    checker = ElleChecker(realtime=realtime, device="cpu")
    jchecker = JElle(realtime=realtime)
    seen = set()
    for h in elle_corpus(0x57E1 + realtime, n=6, txns=40):
        post = checker.check({}, h)
        s, js = ElleStreamSession(checker), JElleStream(jchecker)
        for op in h:
            s.feed(op)
            js.feed(JOp(**vars(op)))
        got, want = s.finalize()["elle"], js.finalize()["elle"]
        assert got.pop("streamed") is True and want.pop("streamed") is True
        assert got == post
        assert {k: v for k, v in got.items() if k != "backend"} == \
            {k: v for k, v in want.items() if k != "backend"}
        seen.add(got["valid"])
    assert seen == {True, False}


def test_elle_stream_falsifies_mid_run(pin):
    """An anomalous prefix trips falsified() before the input ends."""
    pin(elle_stream_flush=1)
    rng = random.Random(0xFA57)
    h = pfuzz.append_txn_ops(pfuzz.mutate_append_txns(
        rng, pfuzz.gen_append_txns(rng, n_txns=30, n_keys=2, max_len=3)))
    checker = ElleChecker(device="cpu")
    assert checker.check({}, h)["valid"] is False
    s = ElleStreamSession(checker)
    for op in h:
        s.feed(op)
    deadline = time.monotonic() + 10
    while not s.falsified() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert s.falsified()
    assert s.finalize()["elle"]["valid"] is False


# -- whole runs ---------------------------------------------------------------

def fast_opts(tmp_path, **kw):
    opts = {"time_limit": 1.5, "rate": 200.0, "ops_per_key": 40,
            "concurrency": 10, "recovery_wait": 0.1,
            "nemesis_interval": 0.3, "store_root": str(tmp_path / "store"),
            "seed": 1, "workload": "register", "no_nemesis": True,
            "device": "cpu", "check_mode": "stream"}
    opts.update(kw)
    return opts


def run(opts):
    test = fake_test(opts)
    return asyncio.run(run_test(test)), Store(test["store_root"]).latest()


def test_stream_run_settles_every_key_as_posthoc(tmp_path, small):
    """A stream-mode run: valid, every key settled from the stream, an
    encoded history for every key, and the post-hoc check of the stored
    history gives each key's fields."""
    result, rd = run(fast_opts(tmp_path))
    assert result["valid"] is True and result["check_mode"] == "stream"
    stream = result["stream"]
    assert stream["streamed_keys"] == result["indep"]["key_count"] > 0
    assert stream["failfast_aborted"] is False and stream["chunks"] >= 1
    per_key = result["indep"]["results"]
    assert {v["linear"]["backend"] for v in per_key.values()} == \
        {"torch-dense-streamed"}
    assert len(list(rd.path.glob("history-*.npz"))) == len(per_key)
    again = IndependentChecker(Compose({
        "linear": Linearizable("cas-register", device="cpu")})).check(
        {}, rd.read_history(), {})
    for k, sub in again["results"].items():
        assert {f: sub["linear"][f] for f in LINEAR} == \
            {f: per_key[str(k)]["linear"][f] for f in LINEAR}, k


def test_invalid_stream_run_keeps_its_witness(tmp_path, small):
    result, rd = run(fast_opts(tmp_path, stale_read_prob=0.8,
                               time_limit=2.0, seed=3))
    assert result["valid"] is False and result["check_mode"] == "stream"
    assert sorted(rd.path.glob("linear-*.json"))


def test_fail_fast_aborts_far_before_the_time_limit(tmp_path):
    """--fail-fast at the default stream knobs: the eager flush sweeps the
    keys the workload left, a key dies, the run ends long before its
    time limit, and the post-hoc check names the failed op."""
    result, _rd = run(fast_opts(tmp_path, fail_fast=True,
                                stale_read_prob=0.5, time_limit=30.0,
                                rate=300.0, seed=3))
    assert result["valid"] is False
    assert result["stream"]["failfast_aborted"] is True
    assert result["run_seconds"] < 15, result["run_seconds"]
    bad = [r for r in result["indep"]["results"].values()
           if r["valid"] is False]
    assert bad and bad[0]["linear"]["failed_op"]


def test_cli_test_stream_mode(tmp_path, capsys):
    """`cli test --check-mode stream --device cpu`: exit 0, and the run
    directory's results.json says stream; with --fail-fast and stale
    reads, exit 1 well inside the time limit."""
    store = tmp_path / "store"
    rc = cli.main(["test", "-w", "register", "--fake", "--device", "cpu",
                   "--time-limit", "1.5", "--rate", "200",
                   "--recovery-wait", "0.2", "--no-nemesis", "--store",
                   str(store), "--check-mode", "stream"])
    assert rc == 0
    res = json.loads((Store(store).latest().path / "results.json")
                     .read_text())
    assert res["check_mode"] == "stream" and res["stream"]["chunks"] >= 1
    rc = cli.main(["test", "-w", "register", "--fake", "--device", "cpu",
                   "--time-limit", "60", "--rate", "200",
                   "--recovery-wait", "0.2", "--no-nemesis",
                   "--stale-read-prob", "0.8", "--store", str(store),
                   "--check-mode", "stream", "--fail-fast"])
    out = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rc == 1 and out["valid"] is False and out["run_seconds"] < 15
    res = json.loads((Store(store).latest().path / "results.json")
                     .read_text())
    assert res["stream"]["failfast_aborted"] is True


def test_post_mode_is_unchanged(tmp_path):
    result, _rd = run(fast_opts(tmp_path, check_mode="post"))
    assert result["valid"] is True and result["check_mode"] == "post"
    assert "stream" not in result
    assert all("streamed" not in v["linear"]
               for v in result["indep"]["results"].values())


def test_limits_defaults_are_the_jax_packages():
    j, p = jlimits.KernelLimits(), plimits.KernelLimits()
    for f in ("stream_flush_ops", "stream_max_lag_chunks",
              "elle_stream_flush", "dense_cell_budget_chunked"):
        assert getattr(p, f) == getattr(j, f), f
