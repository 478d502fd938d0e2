"""The port's `corpus` verb on the CPU: the counterparts of the JAX
package's corpus tests (tests/test_cli_web.py) on stores that the port's
`cli test --fake` wrote at the same flags and seeds, the encode cache of
a replay, and the port's JSON against the JAX verb's on a store the JAX
package wrote."""

from __future__ import annotations

import contextlib
import io
import json
import shutil

import pytest

from jepsen_etcd_demo_tpu.cli import main as jcli
from jepsen_etcd_demo_tpu_torch import cli
from jepsen_etcd_demo_tpu_torch.store import encode_cache

from torch_port_util import one_device, pin

__all__ = ["one_device", "pin"]

FAST = ["--fake", "--no-nemesis", "--time-limit", "1.2", "--recovery-wait",
        "0.2", "--rate", "150"]


def test_run(main, store, workload: str, seed: int, *flags,
             time_limit: str = "1.2", device: bool = True) -> int:
    argv = ["test", "-w", workload, *FAST, "--store", store, "--seed",
            str(seed), *flags]
    argv[argv.index("--time-limit") + 1] = time_limit
    return main(argv + (["--device", "cpu"] if device else []))


test_run.__test__ = False


def corpus(capsys, store, *flags) -> tuple[int, dict]:
    rc = cli.main(["corpus", store, "--device", "cpu", *flags])
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def corpus_quiet(store, *flags) -> tuple[int, dict]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["corpus", str(store), "--device", "cpu", *flags])
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def register_store(tmp_path_factory):
    """(store, corpus (rc, JSON) after two healthy register runs, after a
    third with stale reads): the JAX package's corpus test's sequence."""
    store = tmp_path_factory.mktemp("corpus") / "store"
    with contextlib.redirect_stdout(io.StringIO()):
        assert test_run(cli.main, str(store), "register", 21) == 0
        assert test_run(cli.main, str(store), "register", 22) == 0
    two = corpus_quiet(store)
    with contextlib.redirect_stdout(io.StringIO()):
        assert test_run(cli.main, str(store), "register", 23,
                        "--stale-read-prob", "0.8") == 1
    return store, two, corpus_quiet(store)


def test_corpus_replay_batches_all_runs(register_store):
    """A healthy store of two register runs exits 0; a third run with
    stale reads flips the corpus verdict to 1 and names its keys."""
    store, (rc, out), (rc3, out3) = register_store
    assert rc == 0 and out["valid"] is True
    assert out["runs"] == 2 and out["keys"] >= 2
    assert out["kernel"] == "wgl3-dense-plain" and out["launches"] >= 1
    assert rc3 == 1 and out3["valid"] is False
    assert out3["invalid"] and out3["runs"] == 3
    bad = {e["run"] for e in out3["invalid"]}
    assert len(bad) == 1
    latest = (store / "latest").resolve()
    assert latest == (store / bad.pop()).resolve()
    results = json.loads((latest / "results.json").read_text())
    want = {k for k, r in results["indep"]["results"].items()
            if r["valid"] is not True}
    assert {e["key"] for e in out3["invalid"]} == want


def test_corpus_replay_routes_models_by_workload(tmp_path, capsys, pin):
    """Register and queue runs replay under their own models, from their
    stored tensors; --reencode gives the same verdict from the JSONL;
    a mutex run joins as one whole history; a reordering queue run flips
    the verdict and is named with its model."""
    store = str(tmp_path / "store")
    assert test_run(cli.main, store, "register", 31,
                    time_limit="1.0") == 0
    assert test_run(cli.main, store, "queue", 32, time_limit="1.0") == 0
    rc, out = corpus(capsys, store)
    assert rc == 0 and out["valid"] is True and out["runs"] == 2
    assert out["from_tensors"] == out["keys"] > 0
    rc, out2 = corpus(capsys, store, "--reencode")
    assert rc == 0 and out2["valid"] is True
    assert out2["from_tensors"] == 0 and out2["keys"] == out["keys"]

    assert test_run(cli.main, store, "mutex", 34, time_limit="1.0") == 0
    rc, out = corpus(capsys, store)
    assert rc == 0 and out["valid"] is True and out["runs"] == 3

    assert test_run(cli.main, store, "queue", 33, "--reorder-prob", "0.7",
                    time_limit="1.0") == 1
    rc, out = corpus(capsys, store)
    assert rc == 1 and out["valid"] is False
    assert any(e["model"] == "fifo-queue" for e in out["invalid"])


def test_warm_replay_encodes_nothing(register_store, tmp_path, capsys):
    """--reencode fills <store>/.encode-cache/ (it never reads it); a
    replay that must encode again (the tensors moved away) then hits the
    cache for every key, with the same verdicts. --no-encode-cache writes
    no cache."""
    store = tmp_path / "store"
    shutil.copytree(register_store[0], store, symlinks=True)
    rc0, cold = corpus(capsys, str(store), "--reencode", "--no-encode-cache")
    assert not (store / encode_cache.CACHE_DIRNAME).exists()
    encode_cache.reset_stats()
    rc, out = corpus(capsys, str(store), "--reencode")
    assert encode_cache.stats()["hits"] == 0
    assert len(list((store / encode_cache.CACHE_DIRNAME).glob("*.npz"))) \
        == out["keys"]
    for npz in store.glob("*/*/history*.npz"):
        npz.unlink()
    encode_cache.reset_stats()
    rc2, warm = corpus(capsys, str(store))
    assert encode_cache.stats() == {"hits": out["keys"], "misses": 0,
                                    "evictions": 0}
    assert rc0 == rc == rc2 == 1 and warm["from_tensors"] == 0
    for o in (out, warm):
        assert {k: o[k] for k in ("valid", "runs", "keys", "invalid")} == \
            {k: cold[k] for k in ("valid", "runs", "keys", "invalid")}


def test_cache_hit_rate_counts_repeated_launch_shapes(register_store,
                                                      capsys, monkeypatch):
    """cache_hit_rate is the share of this process's bucket launches
    whose shape it launched before: a second replay of the same store
    repeats every shape of the first."""
    from jepsen_etcd_demo_tpu_torch.sched import engine

    monkeypatch.setattr(engine, "_seen_shapes", set())
    monkeypatch.setattr(engine, "shape_counts", {"hits": 0, "misses": 0})
    store = str(register_store[0])
    _rc, first = corpus(capsys, store)
    n, h1 = first["launches"], engine.shape_counts["hits"]
    assert n >= 1 and engine.shape_counts["misses"] == n - h1
    assert first["cache_hit_rate"] == round(h1 / n, 4)
    _rc, second = corpus(capsys, store)
    assert second["launches"] == n
    assert engine.shape_counts == {"hits": h1 + n, "misses": n - h1}
    assert second["cache_hit_rate"] == round((h1 + n) / (2 * n), 4)


def test_corpus_json_equals_the_jax_verbs_on_a_jax_store(tmp_path, capsys,
                                                         pin):
    """On a store the JAX package wrote (a register run with stale reads
    and a queue run) the port's corpus JSON equals the JAX verb's
    on every key but kernel, wall_s and cache_hit_rate, from the stored
    tensors and under --reencode."""
    store = str(tmp_path / "jstore")
    assert test_run(jcli, store, "register", 52, "--stale-read-prob", "0.8",
                    device=False) == 1
    assert test_run(jcli, store, "queue", 53, device=False) == 0
    capsys.readouterr()
    skip = {"kernel", "wall_s", "cache_hit_rate"}
    for flags in ([], ["--reencode"]):
        jrc = jcli(["corpus", store, *flags])
        want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        rc, got = corpus(capsys, store, *flags)
        assert rc == jrc == 1
        assert set(got) == set(want)
        assert {k: v for k, v in got.items() if k not in skip} == \
            {k: v for k, v in want.items() if k not in skip}
        assert got["launches"] >= 1 and got["invalid"]


def test_corpus_without_a_card_refuses(tmp_path, capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert cli.main(["corpus", str(tmp_path)]) == 1
    captured = capsys.readouterr()
    assert json.loads(captured.out) == {"valid": "unknown"}
    assert "CUDA is not available" in captured.err


def test_empty_store(tmp_path, capsys):
    rc, out = corpus(capsys, str(tmp_path / "none"))
    assert rc == 0 and out == {"valid": True, "runs": 0, "keys": 0}
