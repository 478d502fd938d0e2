"""Performance checker: checker/perf.

The reference turns the timestamped history into latency-over-time (raw
and quantiles) and throughput charts in the run's store directory
(src/jepsen/etcdemo.clj:166). The result map carries the summary numbers
(`count`, `latency` mean and quantiles, `rate_hz`), equal to the JAX
package's for the same history, and is always valid: perf observes, it
asserts nothing. The three charts (latency-raw.png,
latency-quantiles.png, rate.png) are drawn only where matplotlib
imports; without it the result has no "charts" entry.
"""

from __future__ import annotations

import importlib.util
import logging
from collections import defaultdict
from pathlib import Path
from typing import Any, Sequence

import numpy as np

from ..ops.op import FAIL, INFO, INVOKE, OK, Op
from .base import Checker

log = logging.getLogger(__name__)

SECOND = 1_000_000_000
QUANTILES = [0.5, 0.95, 0.99, 1.0]
CHARTS = ["latency-raw.png", "latency-quantiles.png", "rate.png"]


def nemesis_windows(history: Sequence[Op]):
    """[(start_s, stop_s)] intervals where the nemesis was active (shaded
    on the charts); a start never stopped runs to the history's end."""
    out = []
    t_start = None
    t_max = 0.0
    for op in history:
        t = op.time / SECOND
        t_max = max(t_max, t)
        if op.process != "nemesis" or op.type == INVOKE:
            continue
        if op.f == "start" and t_start is None:
            t_start = t
        elif op.f == "stop" and t_start is not None:
            out.append((t_start, t))
            t_start = None
    if t_start is not None:
        out.append((t_start, t_max))
    return out


def latency_pairs(history: Sequence[Op]):
    """(f, completion type, invoke time ns, latency ns) per completed
    client op; nemesis ops excluded."""
    pending: dict[Any, Op] = {}
    out = []
    for op in history:
        if op.process == "nemesis":
            continue
        if op.type == INVOKE:
            pending[op.process] = op
        elif op.type in (OK, FAIL, INFO):
            inv = pending.pop(op.process, None)
            if inv is not None:
                out.append((op.f, op.type, inv.time, op.time - inv.time))
    return out


def charts_available() -> bool:
    return importlib.util.find_spec("matplotlib") is not None


class PerfChecker(Checker):
    def __init__(self, dt_s: float = 1.0):
        self.dt_s = dt_s  # rate-chart bucket width

    def check(self, test: dict, history: Sequence[Op],
              opts: dict | None = None) -> dict[str, Any]:
        pairs = latency_pairs(history)
        result: dict[str, Any] = {"valid": True, "count": len(pairs)}
        if pairs:
            lat_s = np.array([p[3] for p in pairs]) / SECOND
            result["latency"] = {
                "mean": float(lat_s.mean()),
                **{f"p{int(q * 100)}": float(np.quantile(lat_s, q))
                   for q in QUANTILES},
            }
            span = max(p[2] for p in pairs) / SECOND
            result["rate_hz"] = len(pairs) / max(span, 1e-9)
        store_dir = (opts or {}).get("store_dir")
        if store_dir and pairs and charts_available():
            try:
                self._render(Path(store_dir), pairs,
                             nemesis_windows(history))
                result["charts"] = list(CHARTS)
            except Exception as e:  # charts are best-effort observability
                log.warning("perf chart rendering failed: %s", e)
        return result

    def _render(self, store_dir: Path, pairs, windows=()) -> None:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        colors = {OK: "#2a9d43", FAIL: "#d43a2a", INFO: "#e9a820"}
        markers = {"read": "o", "write": "s", "cas": "^", "add": "s"}

        def shade(ax):
            for lo, hi in windows:
                ax.axvspan(lo, hi, color="#cccccc", alpha=0.4, zorder=0)

        def save(fig, ax, title, name):
            ax.set_xlabel("time (s)")
            shade(ax)
            ax.set_title(title)
            fig.savefig(store_dir / name, dpi=100, bbox_inches="tight")
            plt.close(fig)

        # latency-raw: every op, by f and outcome.
        fig, ax = plt.subplots(figsize=(10, 5))
        by = defaultdict(list)
        for f, typ, t_inv, lat in pairs:
            by[(f, typ)].append((t_inv / SECOND, lat / SECOND))
        for (f, typ), pts in sorted(by.items()):
            xs, ys = zip(*pts)
            ax.scatter(xs, ys, s=12, alpha=0.7, color=colors.get(typ, "gray"),
                       marker=markers.get(f, "x"), label=f"{f} {typ}")
        ax.set_yscale("log")
        ax.set_ylabel("latency (s)")
        ax.legend(fontsize=7, ncol=3)
        save(fig, ax, "latency raw", CHARTS[0])

        # latency quantiles over time windows.
        fig, ax = plt.subplots(figsize=(10, 5))
        t = np.array([p[2] for p in pairs]) / SECOND
        lat = np.array([p[3] for p in pairs]) / SECOND
        edges = np.arange(0, t.max() + self.dt_s, self.dt_s)
        for q in QUANTILES:
            xs, ys = [], []
            for lo, hi in zip(edges[:-1], edges[1:]):
                m = (t >= lo) & (t < hi)
                if m.any():
                    xs.append((lo + hi) / 2)
                    ys.append(np.quantile(lat[m], q))
            if xs:
                ax.plot(xs, ys, marker=".", label=f"p{int(q * 100)}")
        ax.set_yscale("log")
        ax.set_ylabel("latency (s)")
        ax.legend(fontsize=8)
        save(fig, ax, "latency quantiles", CHARTS[1])

        # rate: ops/s per outcome over time.
        fig, ax = plt.subplots(figsize=(10, 4))
        for typ in (OK, FAIL, INFO):
            ts = np.array([p[2] for p in pairs if p[1] == typ]) / SECOND
            if len(ts):
                hist, e = np.histogram(ts, bins=edges)
                ax.plot((e[:-1] + e[1:]) / 2, hist / self.dt_s,
                        color=colors[typ], label=typ)
        ax.set_ylabel("ops/s")
        ax.legend(fontsize=8)
        save(fig, ax, "throughput", CHARTS[2])
