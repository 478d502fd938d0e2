"""Store implementation: run directories, symlinks, (de)serialization."""

from __future__ import annotations

import json
import os
from datetime import datetime, timezone
from pathlib import Path
from typing import Optional

import numpy as np

from ..ops.op import Op, history_from_jsonl, history_to_jsonl

TEST_FILE = "test.json"
HISTORY_FILE = "history.jsonl"
RESULTS_FILE = "results.json"
# <store>/corpus/ holds a campaign's bank of witnesses, not runs.
CORPUS_DIRNAME = "corpus"


def _jsonable_test(test: dict) -> dict:
    """The test map holds live objects (client, checker, generator):
    persist the data fields and the repr of the rest, as jepsen prunes its
    test map. An ssh password never reaches disk."""
    out = {}
    for k, v in test.items():
        if isinstance(v, (str, int, float, bool, type(None), list, dict)):
            out[k] = v
        else:
            out[k] = repr(v)
    ssh = out.get("ssh")
    if isinstance(ssh, dict) and ssh.get("password"):
        out["ssh"] = {**ssh, "password": "<redacted>"}
    return out


class RunDir:
    def __init__(self, path: Path):
        self.path = Path(path)

    # -- writing ----------------------------------------------------------
    def write_run(self, test: dict, history: list[Op], result: dict) -> None:
        self.write_test(test)
        self.write_history(history)
        self.write_results(result)

    def write_test(self, test: dict) -> None:
        (self.path / TEST_FILE).write_text(
            json.dumps(_jsonable_test(test), indent=2, default=str))

    def write_history(self, history: list[Op]) -> None:
        (self.path / HISTORY_FILE).write_text(history_to_jsonl(history))

    def write_results(self, result: dict) -> None:
        (self.path / RESULTS_FILE).write_text(
            json.dumps(result, indent=2, default=str))

    def write_history_tensor(self, name: str, events: np.ndarray,
                             **meta) -> None:
        """Persist an encoded event tensor."""
        np.savez_compressed(self.path / f"{name}.npz", events=events,
                            **{k: np.asarray(v) for k, v in meta.items()})

    # -- reading ----------------------------------------------------------
    def read_history(self) -> list[Op]:
        return history_from_jsonl((self.path / HISTORY_FILE).read_text())

    def read_results(self) -> dict:
        return json.loads((self.path / RESULTS_FILE).read_text())

    def read_test(self) -> dict:
        return json.loads((self.path / TEST_FILE).read_text())


class Store:
    def __init__(self, root: str | Path = "store"):
        self.root = Path(root)

    def new_run(self, test_name: str) -> RunDir:
        ts = datetime.now(timezone.utc).strftime("%Y%m%dT%H%M%S.%f")[:-3] + "Z"
        path = self.root / test_name / ts
        path.mkdir(parents=True, exist_ok=True)
        self._symlink(self.root / test_name / "latest", ts)
        self._symlink(self.root / "latest", Path(test_name) / ts)
        self._symlink(self.root / "current", Path(test_name) / ts)
        return RunDir(path)

    @staticmethod
    def _symlink(link: Path, target) -> None:
        link.parent.mkdir(parents=True, exist_ok=True)
        if link.is_symlink() or link.exists():
            link.unlink()
        os.symlink(str(target), str(link))

    def latest(self, test_name: Optional[str] = None) -> Optional[RunDir]:
        link = (self.root / test_name / "latest" if test_name
                else self.root / "latest")
        if not link.exists():
            return None
        target = Path(os.readlink(str(link)))
        return RunDir(target if target.is_absolute() else link.parent / target)

    def runs(self) -> list[RunDir]:
        out = []
        if not self.root.exists():
            return out
        for test_dir in sorted(self.root.iterdir()):
            if not test_dir.is_dir() or test_dir.name in (
                    "latest", "current", CORPUS_DIRNAME):
                continue
            for run in sorted(test_dir.iterdir()):
                if run.is_dir() and not run.is_symlink():
                    out.append(RunDir(run))
        return out


def read_encoded_tensors(store_dir, model_name: str):
    """A run's per-key encoded tensors (the write_encoded_tensor files) as
    (key, EncodedHistory) pairs with string keys, in str-sorted key order.
    [] when there are none, when one fails to load (a truncated .npz),
    or when one was encoded under another model (then re-encode from the
    JSONL history)."""
    from ..ops.encode import EncodedHistory

    out = []
    for path in sorted(Path(store_dir).glob("history*.npz")):
        try:
            with np.load(path) as z:
                if str(z["model"]) != model_name:
                    return []
                name = path.stem
                key = name[len("history-"):] if "-" in name else None
                out.append((key, EncodedHistory.from_arrays(z)))
        except Exception:
            return []
    return out


def write_encoded_tensor(store_dir, key, enc, model_name: str) -> None:
    """Persist the checker's input beside the run: the encoded int32 event
    tensor of one key (`key` None: the whole history). Write-once: an
    existing file records what the run's own check consumed, and a later
    `analyze` under another model must not replace it."""
    name = "history" if key is None else f"history-{key}"
    if (Path(store_dir) / f"{name}.npz").exists():
        return
    arrays = enc.to_arrays()
    RunDir(store_dir).write_history_tensor(
        name, arrays.pop("events"), model=model_name, **arrays)
