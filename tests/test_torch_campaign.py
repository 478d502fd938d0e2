"""The scenario factory of the port (campaign/, nemesis/cluster_faults.py,
minietcd's fault plane, the serve scheduler's campaign tenant and
`cli campaign`) held against the JAX package's on the same seeds: equal
specs, identical virtual-time histories, equal signatures, shrinks,
banks and campaign reports. The JAX package runs as its own tests run it
on the CPU; the port checks on device="cpu" (the kernels' plain
versions). Every compared field must be exactly equal."""

from __future__ import annotations

import asyncio
import json
import os
import random
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from jepsen_etcd_demo_tpu import sched as jsched
from jepsen_etcd_demo_tpu.campaign import bank as jbank
from jepsen_etcd_demo_tpu.campaign import cluster as jcluster
from jepsen_etcd_demo_tpu.campaign import engine as jengine
from jepsen_etcd_demo_tpu.campaign import specs as jspecs
from jepsen_etcd_demo_tpu.campaign import triage as jtriage
from jepsen_etcd_demo_tpu.campaign import vclock as jvclock
from jepsen_etcd_demo_tpu.checkers.linearizable import Linearizable as JLin
from jepsen_etcd_demo_tpu.compose import fake_test as jfake_test
from jepsen_etcd_demo_tpu.nemesis import cluster_faults as jfaults
from jepsen_etcd_demo_tpu.ops.op import INVOKE, OK
from jepsen_etcd_demo_tpu.ops.op import Op as JOp
from jepsen_etcd_demo_tpu.runner.core import run_workload as jrun_workload
from jepsen_etcd_demo_tpu.utils import fuzz as jfuzz
from jepsen_etcd_demo_tpu_torch import obs, sched
from jepsen_etcd_demo_tpu_torch import cli
from jepsen_etcd_demo_tpu_torch.campaign import bank as pbank
from jepsen_etcd_demo_tpu_torch.campaign import cluster as pcluster
from jepsen_etcd_demo_tpu_torch.campaign import engine as pengine
from jepsen_etcd_demo_tpu_torch.campaign import specs as pspecs
from jepsen_etcd_demo_tpu_torch.campaign import triage as ptriage
from jepsen_etcd_demo_tpu_torch.campaign import vclock as pvclock
from jepsen_etcd_demo_tpu_torch.checkers.linearizable import \
    Linearizable as PLin
from jepsen_etcd_demo_tpu_torch.compose import fake_test as pfake_test
from jepsen_etcd_demo_tpu_torch.db import minietcd as pmini
from jepsen_etcd_demo_tpu_torch.nemesis import cluster_faults as pfaults
from jepsen_etcd_demo_tpu_torch.ops import wgl3_kernels as wk
from jepsen_etcd_demo_tpu_torch.runner.core import \
    run_workload as prun_workload

from torch_port_util import port_ops

ROOT = Path(__file__).resolve().parent.parent
JREG = JLin(model="cas-register").model
PREG = PLin("cas-register", device="cpu").model


def _jdirect(encs, model):
    return jsched.check_corpus(encs, model)[0]


def _pdirect(encs, model):
    return sched.check_corpus(encs, model, device="cpu")[0]


def _h(*rows):
    return [JOp(type=t, f=f, value=v, process=p, index=i)
            for i, (t, f, v, p) in enumerate(rows)]


def _json(history):
    return [op.to_json() for op in history]


def _seeded_invalid(seed: int, n_ops: int):
    """A register history both packages falsify (the JAX campaign test's
    recipe)."""
    probe = jtriage.make_check_batch(JREG, _jdirect)
    rng = random.Random(seed)
    for _ in range(32):
        cand = jfuzz.mutate_history(
            rng, jfuzz.gen_register_history(rng, n_ops=n_ops, n_procs=5,
                                            p_info=0.01))
        if probe([cand])[0]:
            return cand
    raise AssertionError("could not seed an invalid history")


# -- specs ------------------------------------------------------------------

@pytest.mark.parametrize("n,seed,families,bug_rate,live,scale", [
    (64, 42, None, 0.3, 4, 1.0),
    (64, 0, None, 0.25, 0, 1.0),
    (32, 2, ["register", "queue"], 1.0, 32, 0.5),
    (48, 7, ["gset", "multiregister"], 0.0, 2, 0.25),
    (20, 0xCA3, ["queue"], 0.6, 0, 2.0),
])
def test_sample_specs_equal_jax(n, seed, families, bug_rate, live, scale):
    kw = dict(families=families, bug_rate=bug_rate, live=live, scale=scale)
    want = [s.to_dict() for s in jspecs.sample_specs(n, seed, **kw)]
    got = [s.to_dict() for s in pspecs.sample_specs(n, seed, **kw)]
    assert got == want
    assert [s.test_opts() for s in pspecs.sample_specs(n, seed, **kw)] \
        == [s.test_opts() for s in jspecs.sample_specs(n, seed, **kw)]


def test_spec_seed_roundtrip_and_unknown_family():
    assert [pspecs.spec_seed(s, i) for s in (0, 5) for i in range(8)] \
        == [jspecs.spec_seed(s, i) for s in (0, 5) for i in range(8)]
    spec = pspecs.sample_specs(3, seed=9)[2]
    assert pspecs.ScenarioSpec.from_dict(spec.to_dict()) == spec
    assert pspecs.FAMILY_MODELS == jspecs.FAMILY_MODELS
    with pytest.raises(ValueError, match="unknown campaign famil"):
        pspecs.sample_specs(2, seed=0, families=["register", "mutex"])


# -- virtual time -----------------------------------------------------------

def _virtual_pair(jspec, pspec):
    jtest = jfake_test(jspec.test_opts())
    ptest = pfake_test({**pspec.test_opts(), "device": "cpu"})

    async def jmain(loop, recorder):
        return await jrun_workload(jtest, recorder)

    async def pmain(loop, recorder):
        return await prun_workload(ptest, recorder)

    return jvclock.run_virtual(jmain), pvclock.run_virtual(pmain)


@pytest.mark.parametrize("seed", [5, 11, 0xCA3])
def test_run_virtual_gives_identical_histories(seed):
    fams = ["register", "queue", "gset", "multiregister"]
    jss = jspecs.sample_specs(6, seed, families=fams, bug_rate=0.5,
                              scale=0.3)
    pss = pspecs.sample_specs(6, seed, families=fams, bug_rate=0.5,
                              scale=0.3)
    for jspec, pspec in zip(jss, pss):
        hj, hp = _virtual_pair(jspec, pspec)
        assert hp and _json(hp) == _json(hj), pspec


def test_virtual_loop_is_the_runners_selector_loop():
    """The sim loop wraps a select(2) selector, as runner.event_loop's
    does, and its clock moves only by would-be sleeps."""
    import selectors

    loop = pvclock.VirtualTimeLoop()
    try:
        assert isinstance(loop._selector._inner, selectors.SelectSelector)
        assert loop.time() == 0.0
        loop.run_until_complete(asyncio.sleep(30))
        assert loop.time() == pytest.approx(30.0, abs=1e-9)
    finally:
        loop.close()


# -- triage -----------------------------------------------------------------

def _sig_pair(h):
    jres = JLin(backend="jax").check({}, h)
    pres = PLin(device="cpu").check({}, port_ops(h))
    assert jres["valid"] is False and pres["valid"] is False
    js = jtriage.classify("register", JREG, h, jres)
    ps = ptriage.classify("register", PREG, port_ops(h), pres)
    assert ps.to_dict() == js.to_dict()
    return ps


def test_classify_same_anomaly_dedupes_different_split():
    s1 = _sig_pair(_h((INVOKE, "read", None, 0), (OK, "read", 4, 0)))
    s2 = _sig_pair(_h((INVOKE, "write", 1, 0), (OK, "write", 1, 0),
                      (INVOKE, "write", 2, 0), (OK, "write", 2, 0),
                      (INVOKE, "read", None, 1), (OK, "read", 1, 1)))
    cas = _sig_pair(_h((INVOKE, "write", 3, 0), (OK, "write", 3, 0),
                       (INVOKE, "cas", (1, 2), 0), (OK, "cas", (1, 2), 0)))
    assert s1.slug == s2.slug and s1.anomaly == "stale-read"
    assert cas.anomaly == "cas-divergence" and cas.slug != s1.slug


def test_logical_ops_and_partition_equal_jax():
    h = _seeded_invalid(0xD1, 40)
    assert [_json(g) for g in ptriage.logical_ops(port_ops(h))] \
        == [_json(g) for g in jtriage.logical_ops(h)]
    for n in (2, 3, 7):
        assert ptriage._partition(list(range(23)), n) \
            == jtriage._partition(list(range(23)), n)


def _recording(probe, seen):
    def check(histories):
        seen.append([_json(h) for h in histories])
        return probe(histories)
    return check


@pytest.mark.parametrize("seed,n_ops,max_checks", [
    (0xD0, 60, 4096), (0xD2, 90, 4096), (0xD0, 60, 2)])
def test_ddmin_shrink_equal_jax(seed, n_ops, max_checks):
    bad = _seeded_invalid(seed, n_ops)
    jseen, pseen = [], []
    jres = jtriage.ddmin_shrink(
        bad, _recording(jtriage.make_check_batch(JREG, _jdirect), jseen),
        max_checks=max_checks)
    pres = ptriage.ddmin_shrink(
        port_ops(bad),
        _recording(ptriage.make_check_batch(PREG, _pdirect, "cpu"), pseen),
        max_checks=max_checks)
    assert pseen == jseen                      # the same candidates
    assert _json(pres.minimal) == _json(jres.minimal)
    for f in ("from_ops", "to_ops", "rounds", "checks", "launches",
              "one_minimal", "budget_exhausted"):
        assert getattr(pres, f) == getattr(jres, f), f
    assert pres.budget_exhausted is (max_checks == 2)
    if not pres.budget_exhausted:
        assert pres.one_minimal


def test_verify_routes_agree_with_jax():
    bad = _seeded_invalid(0xD0, 60)
    jres = jtriage.ddmin_shrink(bad, jtriage.make_check_batch(JREG,
                                                             _jdirect))
    jv = jtriage.verify_routes(jres.minimal, JREG)
    pv = ptriage.verify_routes(port_ops(jres.minimal), PREG, "cpu")
    assert pv["identical"] is jv["identical"] is True
    for route in ("dense", "batched"):
        for f in ("valid", "dead_step", "max_frontier"):
            assert pv[route][f] == jv[route][f], (route, f)
    assert pv["oracle"] == jv["oracle"]
    assert pv["dense"]["kernel"] == "wgl3-dense-plain"


# -- bank -------------------------------------------------------------------

STALE = _h((INVOKE, "read", None, 0), (OK, "read", 4, 0))


def _bank(mod, classify, model, root, h, dead_step):
    sig = classify("register", model, h, {"dead_step": dead_step})
    return mod.bank_witness(root, sig, "cas-register", h,
                            expect={"valid": False, "dead_step": dead_step},
                            spec={"spec_id": 0}, campaign={"seed": 1},
                            shrink={})


def test_bank_content_hash_and_cross_package_replay(tmp_path):
    jp = _bank(jbank, jtriage.classify, JREG, tmp_path / "j", STALE, 0)
    pp = _bank(pbank, ptriage.classify, PREG, tmp_path / "p",
               port_ops(STALE), 0)
    assert pp.relative_to(tmp_path / "p") == jp.relative_to(tmp_path / "j")
    assert _bank(pbank, ptriage.classify, PREG, tmp_path / "p",
                 port_ops(STALE), 0) == pp            # idempotent
    body = {k: v for k, v in json.loads(pp.read_text()).items()
            if k != "banked_at"}
    assert body == {k: v for k, v in json.loads(jp.read_text()).items()
                    if k != "banked_at"}
    # Each package replays the other's bank.
    for root in (tmp_path / "j", tmp_path / "p"):
        got = pbank.replay_corpus(root, device="cpu")
        want = jbank.replay_corpus(root)
        assert got["ok"] is want["ok"] is True
        assert {k: got[k] for k in ("entries", "checked", "signatures")} \
            == {k: want[k] for k in ("entries", "checked", "signatures")} \
            == {"entries": 1, "checked": 1, "signatures": 1}
    assert pbank.bank_summary(tmp_path / "j") \
        == jbank.bank_summary(tmp_path / "p") \
        == {"signatures": {"register-cas-register-stale-read": 1},
            "total": 1}
    w = pbank.load_corpus(tmp_path / "j")[0]
    assert _json(w.history) == _json(STALE) and w.expect["valid"] is False


def test_replay_catches_drift_and_no_longer_falsifying(tmp_path):
    _bank(jbank, jtriage.classify, JREG, tmp_path / "drift", STALE, 7)
    valid = _h((INVOKE, "write", 1, 0), (OK, "write", 1, 0),
               (INVOKE, "read", None, 0), (OK, "read", 1, 0))
    _bank(jbank, jtriage.classify, JREG, tmp_path / "valid", valid, 0)
    for name, words in (("drift", "dead_step drifted"),
                        ("valid", "no longer falsifies")):
        got = pbank.replay_corpus(tmp_path / name, device="cpu")
        want = jbank.replay_corpus(tmp_path / name)
        assert got["ok"] is want["ok"] is False
        assert [f["error"] for f in got["failures"]] \
            == [f["error"] for f in want["failures"]]
        assert words in got["failures"][0]["error"]


# -- cluster fault planes ---------------------------------------------------

NEM_START = {"type": "info", "f": "start", "value": None,
             "process": "nemesis"}
NEM_STOP = {**NEM_START, "f": "stop"}


def _pkg(which):
    """(cluster module, faults module, Op class) of one package."""
    if which == "jax":
        return jcluster, jfaults, JOp
    from jepsen_etcd_demo_tpu_torch.ops.op import Op as POp

    return pcluster, pfaults, POp


def _read(cmod, cluster, node, quorum=False):
    status, body = cmod._MemberStore(cluster, node).get("k", quorum=quorum)
    assert status == 200, body
    return int(body["node"]["value"])


def _stale_check(observed):
    """Whether w1 -> w2 -> read(observed), sequential, is linearizable,
    by the port on the host and by the JAX package."""
    h = _h((INVOKE, "write", 1, 0), (OK, "write", 1, 0),
           (INVOKE, "write", 2, 0), (OK, "write", 2, 0),
           (INVOKE, "read", None, 1), (OK, "read", observed, 1))
    got = PLin(device="cpu").check({}, port_ops(h))["valid"]
    assert got == JLin(backend="jax").check({}, h)["valid"]
    return got


def _churn(which, fork):
    cmod, fmod, Op = _pkg(which)
    cluster = cmod.MiniCluster(nodes=("n1", "n2", "n3"))
    try:
        nem = fmod.MemberChurnNemesis(cluster, seed=3, fork=fork)
        cmod._MemberStore(cluster, "n1").put("k", "1", None, None)
        urls = {n: cluster.url(n) for n in cluster.members()}
        asyncio.run(nem.invoke({}, Op(**NEM_START)))
        churned = list(nem.churned)
        healthy = next(n for n in cluster.members() if n not in churned)
        cmod._MemberStore(cluster, healthy).put("k", "2", None, None)
        during = _read(cmod, cluster, churned[0])
        same_url = cluster.url(churned[0]) == urls[churned[0]]
        asyncio.run(nem.invoke({}, Op(**NEM_STOP)))
        return churned, during, _read(cmod, cluster, churned[0]), same_url
    finally:
        cluster.close()


@pytest.mark.parametrize("fork", [True, False])
def test_member_churn_as_jax(fork):
    got, want = _churn("port", fork), _churn("jax", fork)
    assert got == want
    churned, during, after, same_url = got
    assert churned and same_url and after == 2
    # A forked standby serves the stale 1, which the checker falsifies;
    # healthy churn serves the shared store.
    assert during == (1 if fork else 2)
    assert _stale_check(during) is (not fork)


def _disk(which, mode, root):
    cmod, fmod, Op = _pkg(which)
    root.mkdir()
    cluster = cmod.MiniCluster(nodes=("n1", "n2", "n3"), data_dir=str(root))
    try:
        nem = fmod.DiskFaultNemesis(cluster, mode=mode)
        m = cmod._MemberStore(cluster, "n1")
        m.put("k", "1", None, None)
        asyncio.run(nem.invoke({}, Op(**NEM_START)))
        m.put("k", "2", None, None)
        served = _read(cmod, cluster, "n1")
        stop = asyncio.run(nem.invoke({}, Op(**NEM_STOP)))
        after = _read(cmod, cluster, "n1")
        return (served, after, stop.value, cluster.store.fault_mode,
                fmod.FAULT_HOOK_ENV in os.environ)
    finally:
        cluster.close()


@pytest.mark.parametrize("mode,observed", [("disk-full", 1),
                                           ("corrupt-write", 3)])
def test_disk_faults_as_jax(tmp_path, mode, observed):
    got = _disk("port", mode, tmp_path / "p")
    assert got == _disk("jax", mode, tmp_path / "j")
    served, after, value, fault_mode, env_left = got
    # disk-full loses the acked write; corrupt-write invents a value.
    assert served == 2 and after == observed
    assert value == {"restarted_after": mode, "injected": 1}
    assert fault_mode is None and not env_left
    assert _stale_check(after) is False


def test_fault_mode_inert_without_env_gate(tmp_path, monkeypatch):
    monkeypatch.delenv(pmini.FAULT_HOOK_ENV, raising=False)
    assert pmini.FAULT_HOOK_ENV == "JEPSEN_TPU_MINIETCD_FAULT_HOOK"
    st = pmini.KeyStore(str(tmp_path))
    st.fault_mode = "disk-full"
    st.put("k", "9", None, None)
    assert pmini.KeyStore(str(tmp_path)).get("k")[1]["node"]["value"] == "9"
    assert st.faults_injected == 0 and not pmini.fault_hook_enabled()
    monkeypatch.setenv(pmini.FAULT_HOOK_ENV, "yes")
    assert pmini.fault_hook_enabled()
    assert [pmini._garble(v) for v in ("2", "ab", "")] \
        == ["3", "ba", "corrupt"]


def _lease(which):
    cmod, fmod, Op = _pkg(which)
    cluster = cmod.MiniCluster(nodes=("n1", "n2", "n3"))
    try:
        nem = fmod.LeaseSkewNemesis(cluster, seed=5)
        cmod._MemberStore(cluster, "n1").put("k", "1", None, None)
        asyncio.run(nem.invoke({}, Op(**NEM_START)))
        leased = list(nem.leased)
        cmod._MemberStore(cluster, "n2").put("k", "2", None, None)
        stale = _read(cmod, cluster, leased[0])
        quorum = _read(cmod, cluster, leased[0], quorum=True)
        asyncio.run(nem.invoke({}, Op(**NEM_STOP)))
        return leased, stale, quorum, _read(cmod, cluster, leased[0])
    finally:
        cluster.close()


def test_leased_member_serves_stale_reads_as_jax():
    got = _lease("port")
    assert got == _lease("jax")
    leased, stale, quorum, after = got
    assert leased and (stale, quorum, after) == (1, 2, 2)
    assert _stale_check(stale) is False


def test_live_spec_runs_over_http_with_its_fault_plane():
    """One live spec of each fault plane runs against the port's
    MiniCluster, its history keyed and checked on the host."""
    specs = pspecs.sample_specs(12, 0, bug_rate=0.6, live=12)
    seen = set()
    for spec in specs:
        if spec.nemesis in seen:
            continue
        seen.add(spec.nemesis)
        out = pengine._execute_live(spec, "cpu")
        assert out.error is None, (spec, out.error)
        assert out.ops > 0 and out.keyed, spec
    assert {"member-churn", "disk-full", "corrupt-write",
            "lease-skew"} <= seen


# -- the campaign -----------------------------------------------------------

def _verdict_view(report) -> dict:
    """The JAX campaign test's view: the report without its wall-clock
    fields and store paths."""
    d = report.to_dict()
    d.pop("wall_s"), d.pop("specs_per_sec")
    d["banked"] = sorted(os.path.basename(p) for p in d["banked"])
    return d


def test_run_campaign_equals_jax_on_both_routes(tmp_path):
    kw = dict(n_specs=16, seed=5, families=["register", "queue"],
              bug_rate=0.5, scale=0.3, workers=2)
    want = jengine.run_campaign(store_root=str(tmp_path / "j"), **kw)
    with obs.capture() as cap:
        got = pengine.run_campaign(store_root=str(tmp_path / "p"),
                                   device="cpu", **kw)
    assert _verdict_view(got) == _verdict_view(want)
    assert got.executed == 16 and got.run_errors == 0
    assert got.falsified_keys > 0 and got.banked
    assert all(s["verified_identical"] for s in got.shrinks)
    stats = obs.campaign_stats(cap.metrics)
    assert stats["specs"] == 16
    assert stats["runs_falsified"] == got.falsified_runs
    assert stats["banked"] == len(got.banked)
    assert stats["unique_signatures"] == len(got.signatures)
    assert stats["keys_checked"] == got.keys_checked
    # The serve route: the campaign as the scheduler's tenant.
    specs = pspecs.sample_specs(10, seed=21, bug_rate=0.6, scale=0.3)
    direct = pengine.run_campaign(specs=specs, seed=21, shrink=False,
                                  bank=False, device="cpu")
    serve = pengine.run_campaign(specs=specs, seed=21, shrink=False,
                                 bank=False, route="serve", device="cpu")
    jserve = jengine.run_campaign(
        specs=jspecs.sample_specs(10, seed=21, bug_rate=0.6, scale=0.3),
        seed=21, shrink=False, bank=False, route="serve")
    assert serve.route == "serve" and serve.sched == {}
    assert direct.falsified_keys == serve.falsified_keys \
        == jserve.falsified_keys > 0
    assert direct.signatures == serve.signatures == jserve.signatures


def test_campaign_stats_zero_without_capture():
    assert obs.campaign_stats() == {
        "specs": 0, "aborted_runs": 0, "keys_checked": 0,
        "keys_skipped_hard": 0, "runs_falsified": 0, "shrink_checks": 0,
        "shrink_launches": 0, "banked": 0, "replayed": 0,
        "replay_failures": 0, "unique_signatures": 0, "shrink_ratio": 0.0,
        "specs_per_sec": 0.0}


def test_submit_many_is_all_or_nothing():
    from jepsen_etcd_demo_tpu_torch.serve.scheduler import (
        CAMPAIGN_TENANT, CoalescingScheduler, Rejected)

    lin = PLin(device="cpu")
    encs = [lin.encode(port_ops(jfuzz.gen_register_history(
        random.Random(i), n_ops=20, n_procs=3))) for i in range(3)]
    s = CoalescingScheduler(coalesce_ms=2, max_inflight=2, device="cpu")
    try:
        assert CAMPAIGN_TENANT == "campaign"
        with pytest.raises(Rejected):
            s.submit_many(CAMPAIGN_TENANT, encs)
        reqs = s.submit_many(CAMPAIGN_TENANT, encs[:2])
        assert all(r.wait(60) for r in reqs)
        assert [r.result["valid"] for r in reqs] == [
            r["valid"] for r in _pdirect(encs[:2], lin.model)]
    finally:
        s.close()


# -- the CLI ----------------------------------------------------------------

def test_cli_campaign_smoke_replay_and_exit_codes(tmp_path, capsys):
    from jepsen_etcd_demo_tpu.cli.main import main as jmain

    argv = ["campaign", "--specs", "6", "--seed", "3", "--families",
            "register", "--scale", "0.3", "--store"]
    assert cli.main([*argv, str(tmp_path / "p"), "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jmain([*argv, str(tmp_path / "j")]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(want)
    for d in (got, want):
        d.pop("wall_s"), d.pop("specs_per_sec")
        d["banked"] = [os.path.basename(p) for p in d["banked"]]
    assert got == want and got["specs"] == got["executed"] == 6
    assert got["banked"]
    # The replay lane: exit 0, every banked witness checked.
    assert cli.main(["campaign", "--replay-corpus", "--store",
                     str(tmp_path / "p"), "--device", "cpu"]) == 0
    replay = json.loads(capsys.readouterr().out.strip())
    assert replay["ok"] and replay["checked"] == len(got["banked"])
    # A witness that no longer falsifies exits 1.
    w = next((tmp_path / "p" / "corpus").glob("*/*.json"))
    body = json.loads(w.read_text())
    body["history"] = "\n".join(l for l in body["history"].splitlines()
                                if '"read"' not in l) + "\n"
    w.write_text(json.dumps(body))
    assert cli.main(["campaign", "--replay-corpus", "--store",
                     str(tmp_path / "p"), "--device", "cpu"]) == 1
    assert json.loads(capsys.readouterr().out.strip())["ok"] is False
    # An unknown family exits 2.
    assert cli.main(["campaign", "--specs", "2", "--families", "mutex",
                     "--store", str(tmp_path / "x"), "--device", "cpu"]) == 2
    assert "unknown campaign families" in capsys.readouterr().err


def test_cli_campaign_without_card_exits_1_and_checks_nothing(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this pins the no-card path")
    for extra in ([], ["--replay-corpus"]):
        r = subprocess.run(
            [sys.executable, "-m", "jepsen_etcd_demo_tpu_torch.cli",
             "campaign", "--specs", "4", "--store", str(tmp_path), *extra],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        said = f"stdout: {r.stdout[-2000:]!r}\nstderr: {r.stderr[-2000:]!r}"
        assert r.returncode == 1, said
        assert r.stdout == "", said
        assert "CUDA is not available" in r.stderr, said
    assert not (tmp_path / "corpus").exists()


# -- on the card -------------------------------------------------------------

@pytest.mark.cuda
def test_one_wave_through_the_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    specs = pspecs.sample_specs(8, 5, families=["register"], bug_rate=0.5,
                                scale=0.3)
    wk.reset_launches()
    got = pengine.run_campaign(specs=specs, seed=5, shrink=False, bank=False)
    assert wk.launches["dense_sweep_grouped"] >= 1
    want = pengine.run_campaign(specs=specs, seed=5, shrink=False,
                                bank=False, device="cpu")
    assert got.falsified_keys == want.falsified_keys
    assert got.signatures == want.signatures
