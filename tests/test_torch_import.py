"""The port imports torch and numpy only: never jax, never the JAX
package, and its chip smoke script refuses to run without a card."""

from __future__ import annotations

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "jepsen_etcd_demo_tpu_torch"
PORT_FILES = sorted(str(p.relative_to(ROOT)) for p in PKG.rglob("*.py"))
PORT_MODULES = sorted(
    p.relative_to(ROOT).with_suffix("").as_posix().replace("/", ".")
    .removesuffix(".__init__") for p in PKG.rglob("*.py"))


def _imported_roots(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("rel", PORT_FILES + ["chip_smoke.py"])
def test_source_names_no_jax_import(rel):
    roots = _imported_roots(ROOT / rel)
    assert "jax" not in roots and "jaxlib" not in roots, rel
    assert "jepsen_etcd_demo_tpu" not in roots, rel


def test_every_module_imports_with_jax_blocked():
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jepsen_etcd_demo_tpu'\n"
        "             or m.startswith('jepsen_etcd_demo_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.startswith("ok")


def test_module_list_covers_the_slice():
    for m in ("jepsen_etcd_demo_tpu_torch.ops.wgl3_kernels",
              "jepsen_etcd_demo_tpu_torch.ops.wgl3_sparse",
              "jepsen_etcd_demo_tpu_torch.ops.build",
              "jepsen_etcd_demo_tpu_torch.checkers.independent",
              "jepsen_etcd_demo_tpu_torch.checkers.witness",
              "jepsen_etcd_demo_tpu_torch.carry",
              "jepsen_etcd_demo_tpu_torch.plan",
              "jepsen_etcd_demo_tpu_torch.cli",
              "jepsen_etcd_demo_tpu_torch.ops.cycles",
              "jepsen_etcd_demo_tpu_torch.ops.cycles_tiled",
              "jepsen_etcd_demo_tpu_torch.checkers.elle",
              "jepsen_etcd_demo_tpu_torch.ops.peak",
              "jepsen_etcd_demo_tpu_torch.ops.wgl2",
              "jepsen_etcd_demo_tpu_torch.ops.canon",
              "jepsen_etcd_demo_tpu_torch.ops.encode_device",
              "jepsen_etcd_demo_tpu_torch.models.gset",
              "jepsen_etcd_demo_tpu_torch.models.queues",
              "jepsen_etcd_demo_tpu_torch.models.multi_register",
              "jepsen_etcd_demo_tpu_torch.models.mutex",
              "jepsen_etcd_demo_tpu_torch.checkers.set_checker",
              "jepsen_etcd_demo_tpu_torch.checkers.compose",
              "jepsen_etcd_demo_tpu_torch.checkers.perf",
              "jepsen_etcd_demo_tpu_torch.checkers.timeline",
              "jepsen_etcd_demo_tpu_torch.stream.engine",
              "jepsen_etcd_demo_tpu_torch.stream.elle",
              "jepsen_etcd_demo_tpu_torch.store.encode_cache",
              "jepsen_etcd_demo_tpu_torch.sched",
              "jepsen_etcd_demo_tpu_torch.sched.engine",
              "jepsen_etcd_demo_tpu_torch.control.daemon",
              "jepsen_etcd_demo_tpu_torch.db.etcd",
              "jepsen_etcd_demo_tpu_torch.db.debian",
              "jepsen_etcd_demo_tpu_torch.db.minietcd",
              "jepsen_etcd_demo_tpu_torch.clients.etcd",
              "jepsen_etcd_demo_tpu_torch.nemesis.process_faults",
              "jepsen_etcd_demo_tpu_torch.obs",
              "jepsen_etcd_demo_tpu_torch.obs.metrics",
              "jepsen_etcd_demo_tpu_torch.obs.export",
              "jepsen_etcd_demo_tpu_torch.obs.health",
              "jepsen_etcd_demo_tpu_torch.obs.ledger",
              "jepsen_etcd_demo_tpu_torch.serve",
              "jepsen_etcd_demo_tpu_torch.serve.scheduler",
              "jepsen_etcd_demo_tpu_torch.serve.sessions",
              "jepsen_etcd_demo_tpu_torch.serve.daemon",
              "jepsen_etcd_demo_tpu_torch.web",
              "jepsen_etcd_demo_tpu_torch.web.server"):
        assert m in PORT_MODULES
    for src in ("wgl3_sweep.cu", "wgl3_sparse.cu", "wgl3_table.cuh",
                "elle_accumulate.cu", "alu_peak.cu"):
        assert (PKG / "csrc" / src).is_file(), src


def test_chip_smoke_without_card_prints_nothing_and_fails(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this pins the no-card path")
    p = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    p = subprocess.run([sys.executable, str(lone)], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_build_hashes_headers_and_reports_every_failed_source(tmp_path,
                                                              monkeypatch):
    """The library name covers the shared header, so an edited header
    rebuilds; load_all starts one compiler per missing library and raises
    with each failing source's output."""
    from jepsen_etcd_demo_tpu_torch.ops import build

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a", "b"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    (csrc / "t.cuh").write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    before = build.library_path("a")
    (csrc / "t.cuh").write_text("// v2\n")
    assert build.library_path("a") != before
    assert build.library_path("a") != build.library_path("b")

    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho \"stand-in compiler: $*\"\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "nvcc", lambda: str(fake))
    with pytest.raises(RuntimeError) as err:
        build.load_all(["a", "b"])
    msg = str(err.value)
    assert "a.cu (exit 3)" in msg and "b.cu (exit 3)" in msg
    assert "stand-in compiler" in build.build_log["b"]
    assert not list((tmp_path / "build").glob("*.so"))


HARNESS = ("generators", "clients", "db", "control", "nemesis", "runner",
           "store", "compose", "obs", "serve", "web")


@pytest.mark.parametrize("sub", HARNESS)
def test_harness_subpackages_import_no_jax(sub):
    """The run harness is the port's own copy: each subpackage exists and
    none of its files names jax or the JAX package (the blocked-import
    run above covers their imports)."""
    name = f"jepsen_etcd_demo_tpu_torch.{sub}"
    assert name in PORT_MODULES
    files = ([PKG / f"{sub}.py"] if (PKG / f"{sub}.py").is_file()
             else sorted((PKG / sub).glob("*.py")))
    assert files
    for f in files:
        roots = _imported_roots(f)
        assert not roots & {"jax", "jaxlib", "jepsen_etcd_demo_tpu"}, f


def test_cli_test_without_a_card_fails_before_any_op(tmp_path):
    """`test` resolves the device before the workload starts: with no card
    and no --device cpu it fails at once, and no run directory holds a
    recorded history."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this pins the no-card path")
    store = tmp_path / "store"
    p = subprocess.run(
        [sys.executable, "-m", "jepsen_etcd_demo_tpu_torch.cli", "test",
         "-w", "register", "--fake", "--time-limit", "30", "--store",
         str(store)], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA is not available" in p.stderr
    assert not store.exists() or not list(store.rglob("history.jsonl"))
