"""HTML timeline checker: jepsen.checker.timeline/html.

A swimlane per process of every op (invoke -> complete bars coloured by
outcome), per key under the independent checker
(src/jepsen/etcdemo.clj:16,119), as a self-contained static HTML file,
byte for byte the JAX package's for the same history.
"""

from __future__ import annotations

import html
from pathlib import Path
from typing import Any, Sequence

from ..ops.op import FAIL, INFO, INVOKE, OK, Op
from .base import Checker

SECOND = 1_000_000_000

COLORS = {OK: "#6fbf73", FAIL: "#e57373", INFO: "#ffd54f", "open": "#b0bec5"}

CSS = """
body { font-family: sans-serif; background: #fafafa; }
.lane { position: relative; height: 22px; border-bottom: 1px solid #eee; }
.lane .label { position: absolute; left: 0; width: 90px; font-size: 11px;
               line-height: 22px; color: #555; }
.ops { position: absolute; left: 100px; right: 0; top: 0; bottom: 0; }
.op { position: absolute; height: 16px; top: 3px; border-radius: 3px;
      font-size: 9px; overflow: hidden; white-space: nowrap;
      line-height: 16px; padding: 0 2px; box-sizing: border-box; }
.axis { margin-left: 100px; font-size: 10px; color: #888; }
"""


class TimelineChecker(Checker):
    def __init__(self, filename: str = "timeline.html"):
        self.filename = filename

    def check(self, test: dict, history: Sequence[Op],
              opts: dict | None = None) -> dict[str, Any]:
        store_dir = (opts or {}).get("store_dir")
        key = (opts or {}).get("key")
        if store_dir:
            name = (f"timeline-{key}.html" if key is not None
                    else self.filename)
            Path(store_dir, name).write_text(render_timeline(history))
            return {"valid": True, "file": name}
        return {"valid": True}


def render_timeline(history: Sequence[Op]) -> str:
    """A swimlane per process; one bar per invocation, invoke to
    completion (to the end of the history when it never completed)."""
    pending: dict[Any, Op] = {}
    bars: dict[Any, list] = {}
    t_max = max((op.time for op in history), default=1)
    for op in history:
        if op.type == INVOKE:
            pending[op.process] = op
        elif op.type in (OK, FAIL, INFO):
            inv = pending.pop(op.process, None)
            if inv is not None:
                bars.setdefault(op.process, []).append(
                    (inv.time, op.time, op.type, inv.f, inv.value, op.value,
                     op.error))
    for proc, inv in pending.items():
        bars.setdefault(proc, []).append(
            (inv.time, t_max, "open", inv.f, inv.value, None, None))

    t_max = max(t_max, 1)
    lanes = []
    for proc in sorted(bars, key=str):
        divs = []
        for t0, t1, typ, f, vin, vout, err in bars[proc]:
            left = 100.0 * t0 / t_max
            width = max(0.15, 100.0 * (t1 - t0) / t_max)
            title = html.escape(
                f"{f} {vin!r} -> {typ}"
                + (f" {vout!r}" if vout is not None else "")
                + (f" ({err})" if err else ""))
            divs.append(
                f'<div class="op" style="left:{left:.3f}%;'
                f'width:{width:.3f}%;background:{COLORS.get(typ, "#ccc")}"'
                f' title="{title}">{html.escape(str(f))}</div>')
        lanes.append(
            f'<div class="lane"><div class="label">proc {proc}</div>'
            f'<div class="ops">{"".join(divs)}</div></div>')
    axis = (f'<div class="axis">0s … {t_max / SECOND:.2f}s'
            f' — green ok / red fail / yellow info / gray never-returned</div>')
    return (f"<!doctype html><html><head><meta charset='utf-8'>"
            f"<style>{CSS}</style><title>timeline</title></head>"
            f"<body><h3>operation timeline</h3>{axis}{''.join(lanes)}"
            f"</body></html>")
