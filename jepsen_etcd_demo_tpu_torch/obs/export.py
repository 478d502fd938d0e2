"""Prometheus text exposition of a metrics registry snapshot.

The exposition half of the JAX package's obs/export.py: the registry as
Prometheus text (text/plain; version=0.0.4), counters and gauges under
stable ``jepsen_tpu_*`` names, histograms as summaries with p50/p95/p99
quantile lines (the obs/metrics.py log-bucket sketch), and per-member
metric families split into a label instead of exploding the name space.
web/server.py serves it at ``/metrics``. The JAX module's subscription
bus (the live page's event stream) has no counterpart in the port yet.
"""

from __future__ import annotations

import re
from typing import Iterable, Optional

PROM_PREFIX = "jepsen_tpu_"
PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# Dotted metric families whose last component is an open-ended but
# bounded member set (kernel names, knob names, ledger buckets), exported
# as one Prometheus family with a label under a `_by_<label>` name, so it
# never collides with a plain metric of the same prefix:
# `wgl.compile_s.wgl3-chunk` ->
# `jepsen_tpu_wgl_compile_s_by_kernel{kernel="wgl3-chunk"}`. The JAX
# package's table, so one snapshot renders the same text in both.
LABELED_FAMILIES = {
    "wgl.compile_s": "kernel",
    "wgl.execute_s": "kernel",
    "wgl.kernel_flops": "kernel",
    "wgl.kernel_bytes": "kernel",
    "tune.probe_s": "knob",
    "tune.chosen": "knob",
    "ledger.bucket_s": "bucket",
}

_NAME_SUB = re.compile(r"[^a-zA-Z0-9_:]")
_QUANTILE_KEYS = (("p50", "0.5"), ("p95", "0.95"), ("p99", "0.99"))


def sanitize_metric_name(name: str) -> str:
    """Dotted registry name -> Prometheus metric name body: every
    character outside [a-zA-Z0-9_:] becomes '_', and a leading digit is
    prefixed so the result always matches the exposition grammar."""
    out = _NAME_SUB.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def sanitize_label_value(value: str) -> str:
    """Escape a label value per the exposition format (backslash,
    double-quote, newline)."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _family_of(name: str) -> tuple[str, Optional[str], Optional[str]]:
    """(exported family, label name, label value) — label parts None
    for plain (unlabeled) metrics; labeled families export under a
    `_by_<label>` name so they never collide with a plain metric."""
    for fam, label in LABELED_FAMILIES.items():
        if name.startswith(fam + ".") and len(name) > len(fam) + 1:
            return f"{fam}_by_{label}", label, name[len(fam) + 1:]
    return name, None, None


def _fmt(v) -> str:
    if v is None:
        return "NaN"
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def render_prometheus(snapshot: dict[str, dict],
                      extra_lines: Iterable[str] = ()) -> str:
    """A MetricsRegistry snapshot as Prometheus text exposition.

    Counters render as-is, gauges render their `last` (0 when never
    set — the pre-registered contract keys stay visible), histograms
    render as summaries: quantile lines from the log-bucket sketch plus
    `_sum` / `_count`. One `# TYPE` line per family, families sorted
    for a stable (diffable, goldenable) output. `extra_lines` lets the
    web layer append process-level series (health state, up)."""
    families: dict[str, dict] = {}   # prom name -> {type, lines: [...]}
    for name, rec in sorted(snapshot.items()):
        fam, label, member = _family_of(name)
        prom = PROM_PREFIX + sanitize_metric_name(fam)
        kind = rec.get("type")
        lbl = (f'{{{label}="{sanitize_label_value(member)}"}}'
               if label is not None else "")
        if kind == "counter":
            f = families.setdefault(prom, {"type": "counter", "lines": []})
            f["lines"].append(f"{prom}{lbl} {_fmt(rec.get('value', 0))}")
        elif kind == "gauge":
            f = families.setdefault(prom, {"type": "gauge", "lines": []})
            f["lines"].append(
                f"{prom}{lbl} {_fmt(rec.get('last') or 0)}")
        elif kind == "histogram":
            f = families.setdefault(prom, {"type": "summary", "lines": []})
            for key, q in _QUANTILE_KEYS:
                qlbl = (lbl[:-1] + f',quantile="{q}"}}') if lbl \
                    else f'{{quantile="{q}"}}'
                f["lines"].append(f"{prom}{qlbl} {_fmt(rec.get(key))}")
            f["lines"].append(f"{prom}_sum{lbl} {_fmt(rec.get('sum', 0))}")
            f["lines"].append(
                f"{prom}_count{lbl} {_fmt(rec.get('count', 0))}")
    out: list[str] = []
    for prom in sorted(families):
        out.append(f"# TYPE {prom} {families[prom]['type']}")
        out.extend(families[prom]["lines"])
    out.extend(extra_lines)
    return "\n".join(out) + "\n"
