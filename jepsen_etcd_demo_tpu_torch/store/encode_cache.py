"""Content-addressed cache of encoded histories.

`analyze` and `corpus` re-encode the same stored histories every time
they replay a run. This cache keeps the encoder's output (the int32 event
tensor of `EncodedHistory.to_arrays`) under a sha256 of the encoder's
input: the translated ops' (type, f, value, process), the model name,
the first slot width asked for and `ENCODING_VERSION`. An unchanged
history loads its tensor instead of being paired and encoded again, and
a hit is bit-identical to a fresh encode.

The key and the entry files are the JAX package's, so the two packages
share one `.encode-cache/` directory.

The cache is off unless a CLI verb activates it (`analyze` under the run
directory, `corpus` under the store root; `--no-encode-cache` leaves it
off). Entries are npz files written atomically (a temporary file, then
`os.replace`), so concurrent replays race benignly; a torn or unreadable
entry is a miss, never a failure. Past `limits().encode_cache_cap_mb` the
least recently used entries (mtime order; a hit touches its entry) are
removed every `_GC_EVERY` stores. `stats()` gives the hit, miss and
eviction counts of this process.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
from contextlib import contextmanager
from pathlib import Path
from typing import Iterator, Optional, Sequence

import numpy as np

from ..ops.encode import ENCODING_VERSION, EncodedHistory
from ..ops.limits import limits

CACHE_DIRNAME = ".encode-cache"

_active_root: Optional[Path] = None
_refresh: bool = False

# Stores between two size-capped collections (gc() lists the whole
# directory, so store() pays it once every this many entries).
_GC_EVERY = 32
_stores_since_gc = 0

_counts = {"hits": 0, "misses": 0, "evictions": 0}


def activate(root: str | os.PathLike | None,
             refresh: bool = False) -> tuple[Optional[Path], bool]:
    """Point the cache at `root` (created at the first store); None turns
    it off. `refresh=True` skips lookups but still writes entries: the
    `--reencode` contract, which re-encodes everything from the source
    and replaces what the cache held. Returns the previous (root,
    refresh) for restoring."""
    global _active_root, _refresh
    prev = (_active_root, _refresh)
    _active_root = Path(root) if root is not None else None
    _refresh = bool(refresh)
    return prev


def active_root() -> Optional[Path]:
    return _active_root


@contextmanager
def activated(root: str | os.PathLike | None,
              refresh: bool = False) -> Iterator[None]:
    prev_root, prev_refresh = activate(root, refresh)
    try:
        yield
    finally:
        activate(prev_root, prev_refresh)


def stats() -> dict:
    """This process's hits, misses and evictions (a copy)."""
    return dict(_counts)


def reset_stats() -> None:
    for k in _counts:
        _counts[k] = 0


def history_fingerprint(history: Sequence, model_name: str,
                        k_slots: int) -> str:
    """sha256 over the fields the encoder reads (type, f, value, process;
    time and index never reach the tensor), the model, the first slot
    width and the encoder version (a layout change invalidates every
    entry). Equal to the JAX package's for the same history."""
    h = hashlib.sha256()
    h.update(f"v{ENCODING_VERSION}|{model_name}|{k_slots}".encode())
    for op in history:
        h.update(
            f"\n{op.type}|{op.f}|{op.value!r}|{op.process!r}".encode())
    return h.hexdigest()


def _entry_path(fingerprint: str) -> Optional[Path]:
    if _active_root is None:
        return None
    return _active_root / f"{fingerprint}.npz"


def lookup(history: Sequence, model_name: str,
           k_slots: int) -> Optional[EncodedHistory]:
    """The cached EncodedHistory of (history, model, k_slots), or None
    (cache off, refresh mode, a miss, or an unreadable entry)."""
    if _refresh or _active_root is None:
        return None
    path = _entry_path(history_fingerprint(history, model_name, k_slots))
    try:
        with np.load(path) as z:
            enc = EncodedHistory.from_arrays(z)
    except Exception:   # missing or torn entry: encode again, never fail
        _counts["misses"] += 1
        return None
    _counts["hits"] += 1
    try:
        # A hit is a use: the collection's LRU order is mtime order.
        os.utime(path)
    except OSError:
        pass
    return enc


def store(history: Sequence, model_name: str, k_slots: int,
          enc: EncodedHistory) -> None:
    """Write an encoding under its input's fingerprint (atomic replace)."""
    if _active_root is None:
        return
    path = _entry_path(history_fingerprint(history, model_name, k_slots))
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".npz")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez_compressed(f, **enc.to_arrays())
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
    except OSError:
        pass   # the cache saves time; it is never a reason to fail
    global _stores_since_gc
    _stores_since_gc += 1
    if _stores_since_gc >= _GC_EVERY:
        _stores_since_gc = 0
        gc()


def gc(cap_mb: Optional[float] = None) -> int:
    """Remove the least recently used entries (oldest mtime first) while
    the cache's files exceed `cap_mb` (default
    limits().encode_cache_cap_mb; 0 = no cap). An entry that vanished
    under a concurrent collection is skipped. Returns the evictions."""
    root = _active_root
    if root is None:
        return 0
    if cap_mb is None:
        cap_mb = limits().encode_cache_cap_mb
    if cap_mb <= 0:
        return 0
    cap = int(float(cap_mb) * (1 << 20))
    entries = []
    total = 0
    try:
        names = list(root.iterdir())
    except OSError:
        return 0
    for p in names:
        if not p.name.endswith(".npz"):
            continue
        try:
            st = p.stat()
        except OSError:
            continue
        entries.append((st.st_mtime, st.st_size, p))
        total += st.st_size
    evicted = 0
    for _, size, p in sorted(entries):
        if total <= cap:
            break
        try:
            p.unlink()
        except OSError:
            continue
        total -= size
        evicted += 1
    _counts["evictions"] += evicted
    return evicted
