"""The regression corpus: minimal witnesses under <store>/corpus/.

Each shrunk, route-verified counterexample a campaign finds is banked as
one JSON file,

    <store>/corpus/<signature-slug>/<content-hash>.json

holding the minimal history, what the checker must say of it (valid
false and its dead_step), the signature, and where it came from: the
ScenarioSpec, the campaign (seed, spec count, route) and the shrink
(ops before and after, rounds, candidate checks). The file name hashes
the signature, the model and the history, so running the same campaign
again banks the same files, not copies; `banked_at` is outside the hash.
The layout and the hash are the JAX package's, so a corpus either
package banked replays in the other.

`replay_corpus` is the regression lane: every banked witness checked
again, one corpus launch a model, each of which must still falsify at
its banked dead_step (`campaign --replay-corpus`).
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from datetime import datetime, timezone
from pathlib import Path
from typing import Optional

from ..ops.op import Op, history_from_jsonl, history_to_jsonl
from ..store.store import CORPUS_DIRNAME
from .triage import Signature

BANK_VERSION = 1


@dataclass
class BankedWitness:
    path: Path
    signature: dict
    model: str
    history: list[Op]
    expect: dict
    spec: dict
    campaign: dict
    shrink: dict

    @classmethod
    def load(cls, path: Path) -> "BankedWitness":
        d = json.loads(path.read_text())
        return cls(path=path, signature=d["signature"], model=d["model"],
                   history=history_from_jsonl(d["history"]),
                   expect=d["expect"], spec=d.get("spec", {}),
                   campaign=d.get("campaign", {}),
                   shrink=d.get("shrink", {}))


def corpus_root(store_root: str | Path) -> Path:
    return Path(store_root) / CORPUS_DIRNAME


def _content_hash(sig_slug: str, model: str, history_jsonl: str) -> str:
    h = hashlib.sha1()
    h.update(sig_slug.encode())
    h.update(model.encode())
    h.update(history_jsonl.encode())
    return h.hexdigest()[:16]


def bank_witness(store_root: str | Path, sig: Signature, model: str,
                 history: list[Op], expect: dict, spec: dict,
                 campaign: dict, shrink: dict) -> Path:
    """Persist one minimal witness; idempotent by content hash."""
    hist_jsonl = history_to_jsonl(history)
    name = _content_hash(sig.slug, model, hist_jsonl)
    out = corpus_root(store_root) / sig.slug / f"{name}.json"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({
        "version": BANK_VERSION,
        "signature": sig.to_dict(),
        "model": model,
        "history": hist_jsonl,
        "expect": expect,
        "spec": spec,
        "campaign": campaign,
        "shrink": shrink,
        "banked_at": datetime.now(timezone.utc).isoformat(),
    }, indent=2))
    return out


def load_corpus(store_root: str | Path) -> list[BankedWitness]:
    """Every banked witness, in (slug, hash) order. An unreadable entry
    is skipped with a note on stderr: the replay reports on the rest."""
    import sys

    root = corpus_root(store_root)
    out: list[BankedWitness] = []
    if not root.is_dir():
        return out
    for path in sorted(root.glob("*/*.json")):
        try:
            out.append(BankedWitness.load(path))
        except (ValueError, KeyError, OSError) as e:
            print(f"# skipping corpus entry {path}: {e}", file=sys.stderr)
    return out


def replay_corpus(store_root: str | Path, route_check=None,
                  device=None) -> dict:
    """Falsify the whole bank again: one corpus launch a model, through
    `route_check(encs, model) -> results` (by default sched.check_corpus
    on `device`, None = cuda). Returns the replay report; `ok` is False
    when a banked witness no longer falsifies (a checker regression, the
    event the bank exists to catch) or dies at another dead_step."""
    from .. import obs, sched
    from ..checkers.linearizable import Linearizable
    from ..device import resolve_device

    dev = resolve_device(device)
    if route_check is None:
        def route_check(encs, model):
            results, _kernel, _stats = sched.check_corpus(encs, model,
                                                          device=dev)
            return results

    entries = load_corpus(store_root)
    failures: list[dict] = []
    checked = 0
    by_model: dict[str, list[BankedWitness]] = {}
    for w in entries:
        by_model.setdefault(w.model, []).append(w)
    for model_name in sorted(by_model):
        group = by_model[model_name]
        lin = Linearizable(model_name, device=dev)
        encs, bank = [], []
        for w in group:
            try:
                encs.append(lin.encode(w.history))
                bank.append(w)
            except Exception as e:
                failures.append({"path": str(w.path),
                                 "error": f"encode: {e}"})
        if not encs:
            continue
        results = route_check(encs, lin.model)
        checked += len(encs)
        for w, one in zip(bank, results):
            if one.get("valid") is not False:
                failures.append({
                    "path": str(w.path),
                    "error": f"no longer falsifies (valid="
                             f"{one.get('valid')!r})"})
            elif int(one.get("dead_step", -1)) \
                    != int(w.expect.get("dead_step", -1)):
                failures.append({
                    "path": str(w.path),
                    "error": f"dead_step drifted: banked "
                             f"{w.expect.get('dead_step')} vs "
                             f"{one.get('dead_step')}"})
    m = obs.get_metrics()
    m.counter("campaign.replayed").add(checked)
    if failures:
        m.counter("campaign.replay_failures").add(len(failures))
    return {
        "ok": not failures,
        "entries": len(entries),
        "checked": checked,
        "signatures": len({w.signature.get("slug") for w in entries}),
        "failures": failures,
    }


def bank_summary(store_root: str | Path) -> Optional[dict]:
    """Witnesses a signature slug, from a directory listing (no JSON is
    read). None when there is no bank."""
    root = corpus_root(store_root)
    if not root.is_dir():
        return None
    per_sig = {d.name: len(list(d.glob("*.json")))
               for d in sorted(root.iterdir()) if d.is_dir()}
    per_sig = {k: v for k, v in per_sig.items() if v}
    if not per_sig:
        return None
    return {"signatures": per_sig, "total": sum(per_sig.values())}
