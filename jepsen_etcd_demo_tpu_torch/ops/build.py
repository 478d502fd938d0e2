"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with nvcc into a shared library with a
plain C interface, ``build/lib<name>-<hash>.so`` inside the package (a
directory git ignores). The hash covers the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header rebuilds and
an unchanged one loads the library already built. Nothing here includes
PyTorch's headers, so a build takes seconds; ``load_all`` starts the nvcc
of every source that needs one before it waits for any. Each source
exports ``<name>_launch`` (returns the CUDA error code, 0 when the kernel
was launched) and ``<name>_error_string``; ``launcher`` binds the pair.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# name -> ptxas report (registers, shared memory, spills) of the build
# this process ran; empty when the library was already built.
build_log: dict[str, str] = {}

_LIBS: dict[str, ctypes.CDLL] = {}
_LAUNCHERS: dict[str, object] = {}
# Guards _LIBS and _LAUNCHERS: the checking daemon binds and loads from its
# executor thread and its sessions' consumer threads at once. Reentrant,
# since launcher() loads under it.
_LOCK = threading.RLock()


def nvcc() -> str:
    """The nvcc binary: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    which = shutil.which("nvcc")
    if which:
        candidates.append(Path(which))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, compiled first if it is not
    built yet. Raises with nvcc's output when the build fails."""
    return load_all([name])[name]


def load_all(names) -> dict[str, ctypes.CDLL]:
    """load() every name; the sources that need a build compile side by
    side, one nvcc process each."""
    with _LOCK:
        todo = {n: library_path(n) for n in names
                if n not in _LIBS and not library_path(n).exists()}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {n: subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(_tmp(path)),
             str(CSRC_DIR / f"{n}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
            for n, path in todo.items()}
        failed = []
        for n, proc in procs.items():
            build_log[n] = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {n}.cu (exit "
                              f"{proc.returncode}):\n{build_log[n]}")
            else:
                os.replace(_tmp(todo[n]), todo[n])
        if failed:
            raise RuntimeError("\n".join(failed))
        for n in names:
            if n not in _LIBS:
                _LIBS[n] = ctypes.CDLL(str(library_path(n)))
        return {n: _LIBS[n] for n in names}


def _tmp(path: Path) -> Path:
    return path.with_name(f"{path.name}.{os.getpid()}.tmp")


def launcher(name: str, argtypes, entry: str | None = None):
    """csrc/<name>.cu's ``<name>_launch`` (or the export `entry`) bound
    with `argtypes` (each pointer and the stream a ctypes.c_void_p, each
    int a ctypes.c_int). Calling the result launches the kernel and raises
    RuntimeError with CUDA's message when the launch is refused."""
    entry = entry or f"{name}_launch"
    bound = _LAUNCHERS.get(entry)
    if bound is not None:
        return bound
    with _LOCK:
        if entry not in _LAUNCHERS:
            lib = load(name)
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            err = getattr(lib, f"{name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p

            def launch(*args) -> None:
                rc = fn(*args)
                if rc != 0:
                    raise RuntimeError(f"{entry} failed: "
                                       f"{err(rc).decode()} (code {rc})")

            _LAUNCHERS[entry] = launch
        return _LAUNCHERS[entry]
