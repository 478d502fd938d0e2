"""The port's encode cache (store/encode_cache.py) against the JAX
package's: the same fingerprints, each package reading the other's
entries, refresh, an inactive cache, torn entries, the size-capped LRU
collection, and `analyze` with and without --no-encode-cache."""

from __future__ import annotations

import json
import os
import random
import time

import numpy as np
import pytest

from jepsen_etcd_demo_tpu.checkers import Linearizable as JLin
from jepsen_etcd_demo_tpu.models import get_model as jget_model
from jepsen_etcd_demo_tpu.store import encode_cache as jec
from jepsen_etcd_demo_tpu.utils import fuzz as jfuzz
from jepsen_etcd_demo_tpu_torch import cli
from jepsen_etcd_demo_tpu_torch.checkers import Linearizable
from jepsen_etcd_demo_tpu_torch.models import get_model as pget_model
from jepsen_etcd_demo_tpu_torch.ops.encode import encode_register_history
from jepsen_etcd_demo_tpu_torch.ops.op import Op as POp
from jepsen_etcd_demo_tpu_torch.ops.op import history_to_jsonl
from jepsen_etcd_demo_tpu_torch.store import encode_cache as pec
from jepsen_etcd_demo_tpu_torch.utils import fuzz as pfuzz

from golden import GOLDEN
from test_torch_families import GENS, gen_mutex_history
from torch_port_util import fuzz_pair, port_ops

MODEL = "cas-register"


def same_encoding(a, b) -> bool:
    return (np.array_equal(a.events[:a.n_events], b.events[:b.n_events])
            and (a.n_events, a.n_ops, a.k_slots, a.max_pending, a.max_value)
            == (b.n_events, b.n_ops, b.k_slots, b.max_pending, b.max_value))


@pytest.fixture(autouse=True)
def fresh_cache():
    """Both caches off and the port's counts at 0 around each test."""
    pprev, jprev = pec.activate(None), jec.activate(None)
    pec.reset_stats()
    yield
    pec.activate(*pprev)
    jec.activate(*jprev)


def translated_pair(model: str, hj, hp):
    """Each package's translated history (the cache key's input)."""
    return (jget_model(model).prepare_history(hj),
            pget_model(model).prepare_history(hp))


def family_pairs():
    """(model, JAX history, port history) from each package's own
    generator, for the golden cases, register fuzz, and every family."""
    out = [(MODEL, h, port_ops(h)) for _n, h, _v in GOLDEN]
    for seed in range(4):
        out.append((MODEL, *fuzz_pair(seed, n_ops=40, mutate=seed % 2 == 1)))
    for model, gen in GENS.items():
        out.append((model, gen(jfuzz, random.Random(7)),
                    gen(pfuzz, random.Random(7))))
    out.append(("mutex", gen_mutex_history(jfuzz, random.Random(7)),
                gen_mutex_history(pfuzz, random.Random(7))))
    return out


@pytest.mark.parametrize("case", range(len(GOLDEN) + 4 + len(GENS) + 1))
def test_fingerprint_equals_the_jax_packages(case):
    model, hj, hp = family_pairs()[case]
    tj, tp = translated_pair(model, hj, hp)
    for k in (24, 32):
        assert pec.history_fingerprint(tp, model, k) == \
            jec.history_fingerprint(tj, model, k)


def test_fingerprint_changes_with_content_model_slots_and_version(
        monkeypatch):
    rng = random.Random(0xF17)
    h = pfuzz.gen_register_history(rng, n_ops=20, n_procs=4)
    base = pec.history_fingerprint(h, MODEL, 24)
    assert base == pec.history_fingerprint(h, MODEL, 24)
    assert base != pec.history_fingerprint(h, MODEL, 32)
    assert base != pec.history_fingerprint(h, "register", 24)
    assert base != pec.history_fingerprint(
        pfuzz.mutate_history(rng, h), MODEL, 24)
    monkeypatch.setattr(pec, "ENCODING_VERSION", pec.ENCODING_VERSION + 1)
    assert base != pec.history_fingerprint(h, MODEL, 24)


def test_roundtrip_hit_is_bit_identical(tmp_path):
    h = pfuzz.gen_register_history(random.Random(0xE7C), n_ops=40,
                                   n_procs=5, p_info=0.02)
    lin = Linearizable(MODEL, device="cpu")
    cold = lin.encode(h)
    with pec.activated(tmp_path):
        first = lin.encode(h)     # a miss: writes the entry
        second = lin.encode(h)    # a hit: loads it
    assert (tmp_path / (pec.history_fingerprint(h, MODEL, lin.k_slots)
                        + ".npz")).is_file()
    assert same_encoding(first, cold) and same_encoding(second, cold)
    assert pec.stats() == {"hits": 1, "misses": 1, "evictions": 0}


def test_slot_escalation_is_cached_under_the_first_width(tmp_path):
    """A history past the first slot width is encoded at a doubled width
    and stored under the width asked for, as in the JAX package."""
    h = [POp(type=t, f="write", value=p % 5, process=p)
         for t in ("invoke", "ok") for p in range(30)]
    lin = Linearizable(MODEL, device="cpu")
    cold = lin.encode(h)
    assert cold.k_slots > lin.k_slots
    with pec.activated(tmp_path):
        lin.encode(h)
        hit = lin.encode(h)
    assert same_encoding(hit, cold) and pec.stats()["hits"] == 1


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_others_entries(tmp_path, writer):
    cases = family_pairs()
    cases = [cases[0], cases[len(GOLDEN)], cases[-2], cases[-1]]
    for model, hj, hp in cases:
        jlin, plin = JLin(model=model), Linearizable(model, device="cpu")
        with pec.activated(tmp_path), jec.activated(tmp_path):
            if writer == "jax":
                wrote = jlin.encode(hj)
                before = pec.stats()["hits"]
                got = plin.encode(hp)
                assert pec.stats()["hits"] == before + 1, model
            else:
                wrote = plin.encode(hp)
                got = jlin.encode(hj)
                tj, _tp = translated_pair(model, hj, hp)
                assert (tmp_path / (jec.history_fingerprint(
                    tj, model, jlin.k_slots) + ".npz")).is_file()
        assert same_encoding(got, wrote), model
    assert len(list(tmp_path.glob("*.npz"))) == len(cases)


def test_refresh_skips_lookups_but_writes(tmp_path):
    h = pfuzz.gen_register_history(random.Random(0x2E), n_ops=30, n_procs=4)
    lin = Linearizable(MODEL, device="cpu")
    path = tmp_path / (pec.history_fingerprint(h, MODEL, lin.k_slots)
                       + ".npz")
    with pec.activated(tmp_path):
        lin.encode(h)
    stale = os.stat(path).st_mtime_ns
    os.utime(path, ns=(stale - 10**9, stale - 10**9))
    with pec.activated(tmp_path, refresh=True):
        assert pec.lookup(h, MODEL, lin.k_slots) is None
        enc = lin.encode(h)
    assert os.stat(path).st_mtime_ns > stale - 10**9
    assert pec.stats() == {"hits": 0, "misses": 1, "evictions": 0}
    with pec.activated(tmp_path):
        assert same_encoding(pec.lookup(h, MODEL, lin.k_slots), enc)


def test_inactive_cache_does_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    h = pfuzz.gen_register_history(random.Random(0x0FF), n_ops=10,
                                   n_procs=3)
    assert pec.active_root() is None
    assert pec.lookup(h, MODEL, 24) is None
    pec.store(h, MODEL, 24, encode_register_history(h))
    Linearizable(MODEL, device="cpu").encode(h)
    assert list(tmp_path.iterdir()) == []
    assert pec.stats() == {"hits": 0, "misses": 0, "evictions": 0}


def test_torn_entry_is_a_miss(tmp_path):
    h = pfuzz.gen_register_history(random.Random(0x7E), n_ops=30, n_procs=4)
    lin = Linearizable(MODEL, device="cpu")
    cold = lin.encode(h)
    path = tmp_path / (pec.history_fingerprint(h, MODEL, lin.k_slots)
                       + ".npz")
    with pec.activated(tmp_path):
        lin.encode(h)
        path.write_bytes(path.read_bytes()[:40])
        assert pec.lookup(h, MODEL, lin.k_slots) is None
        again = lin.encode(h)          # a miss that writes a whole entry
        assert same_encoding(pec.lookup(h, MODEL, lin.k_slots), cold)
    assert same_encoding(again, cold)
    assert pec.stats()["misses"] == 3 and pec.stats()["hits"] == 1


def test_gc_evicts_least_recently_used(tmp_path):
    """As tests/test_spill.py's test of the JAX cache: a lookup hit
    protects the oldest entry from a collection down to half the size."""
    rng = random.Random(0x6C)
    hists = [pfuzz.gen_register_history(rng, n_ops=30, n_procs=3)
             for _ in range(6)]
    with pec.activated(tmp_path / "cache"):
        for i, h in enumerate(hists):
            pec.store(h, MODEL, 16, encode_register_history(h, k_slots=16))
            p = pec._entry_path(pec.history_fingerprint(h, MODEL, 16))
            t = time.time() - (len(hists) - i) * 1000
            os.utime(p, (t, t))
        size = pec._entry_path(
            pec.history_fingerprint(hists[0], MODEL, 16)).stat().st_size
        total_mb = size * len(hists) / (1 << 20)
        assert pec.lookup(hists[0], MODEL, 16) is not None
        evicted = pec.gc(cap_mb=total_mb / 2)
        assert evicted >= 2 and pec.stats()["evictions"] == evicted
        assert pec.lookup(hists[0], MODEL, 16) is not None
        assert pec.lookup(hists[1], MODEL, 16) is None
        assert pec.gc(cap_mb=0) == 0


def _run_dir(tmp_path, name: str):
    """A keyed register run directory (test.json, history.jsonl)."""
    rd = tmp_path / name
    rd.mkdir()
    hists = [pfuzz.gen_register_history(random.Random(s), n_ops=30,
                                        n_procs=4) for s in range(3)]
    keyed = []
    for k, h in enumerate(hists):
        for op in h:
            keyed.append(type(op)(**{**vars(op), "value": (k, op.value)}))
    (rd / "history.jsonl").write_text(history_to_jsonl(keyed))
    (rd / "test.json").write_text(json.dumps({"workload": "register"}))
    return rd


def test_analyze_keeps_the_cache_unless_told_not_to(tmp_path, capsys):
    off = _run_dir(tmp_path, "off")
    assert cli.main(["analyze", str(off), "--device", "cpu",
                     "--no-encode-cache"]) == 0
    assert not (off / pec.CACHE_DIRNAME).exists()
    assert (off / "results.json").is_file()

    on = _run_dir(tmp_path, "on")
    assert cli.main(["analyze", str(on), "--device", "cpu"]) == 0
    assert len(list((on / pec.CACHE_DIRNAME).glob("*.npz"))) == 3
    pec.reset_stats()
    assert cli.main(["analyze", str(on), "--device", "cpu",
                     "--sweep-mode", "dense"]) == 0
    assert pec.stats()["hits"] == 3
    assert pec.active_root() is None
    assert [json.loads(s) for s in capsys.readouterr().out.splitlines()] == \
        [{"valid": True}] * 3
