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
              "jepsen_etcd_demo_tpu_torch.ops.build",
              "jepsen_etcd_demo_tpu_torch.checkers.independent",
              "jepsen_etcd_demo_tpu_torch.carry",
              "jepsen_etcd_demo_tpu_torch.cli"):
        assert m in PORT_MODULES
    assert (PKG / "csrc" / "wgl3_sweep.cu").is_file()


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
