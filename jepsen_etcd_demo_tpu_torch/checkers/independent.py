"""Independent-keys checker: the equivalent of ``independent/checker``.

A keyed history carries ``(key, value)`` tuples; it is split per key and
each key's history is checked on its own. With a Linearizable sub-checker
and more than one key, every key's history is encoded and all of them are
checked together: in ONE launch of the dense sweep (the key axis is the
batch axis), or, when a key is longer than one scan, one key after another
through the long sweep under the keys' shared geometry. A batched result
settles a key only when it is valid: an invalid or unknown key is checked
again on its own, which builds its counterexample witness.
"""

from __future__ import annotations

from typing import Any, Sequence

from ..ops.op import INVOKE, Op
from .base import Checker, merge_valid
from .linearizable import Linearizable


def split_by_key(history: Sequence[Op]) -> dict[Any, list[Op]]:
    """Split a tuple-valued history into per-key sub-histories.
    Invocations carry (key, v) tuples; completions are routed to the key
    of their process's pending invocation."""
    keyed: dict[Any, list[Op]] = {}
    key_of_process: dict[Any, Any] = {}
    for op in history:
        if op.process == "nemesis":
            continue
        if op.type == INVOKE:
            if not (isinstance(op.value, tuple) and len(op.value) == 2):
                raise ValueError(
                    f"independent history op without (key, value) tuple: {op}")
            k, v = op.value
            key_of_process[op.process] = k
        else:
            k = key_of_process.pop(op.process, None)
            if k is None:
                continue
            v = op.value[1] if (isinstance(op.value, tuple)
                                and len(op.value) == 2) else op.value
        sub = Op(type=op.type, f=op.f, value=v, process=op.process,
                 time=op.time, index=op.index, error=op.error, seq=op.seq)
        keyed.setdefault(k, []).append(sub)
    return keyed


class IndependentChecker(Checker):
    def __init__(self, sub_checker: Checker):
        self.sub_checker = sub_checker

    def check(self, test: dict, history: Sequence[Op],
              opts: dict | None = None) -> dict[str, Any]:
        keyed = split_by_key(history)
        if not keyed:
            return {"valid": True, "key_count": 0}
        batched: dict[Any, dict] = {}
        if len(keyed) > 1 and isinstance(self.sub_checker, Linearizable):
            batched = _batched_linearizable(self.sub_checker, keyed)
        results: dict[Any, dict] = {}
        for k in sorted(keyed, key=str):
            if batched.get(k, {}).get("valid") is True:
                results[k] = batched[k]
            else:
                results[k] = self.sub_checker.check(
                    test, keyed[k], {**(opts or {}), "key": k})
        valid = merge_valid([r.get("valid") for r in results.values()])
        return {"valid": valid, "key_count": len(keyed),
                "results": {str(k): v for k, v in results.items()}}


def _batched_linearizable(lin: Linearizable, keyed: dict[Any, list[Op]]
                          ) -> dict[Any, dict]:
    """All keys checked together when one table geometry serves them; {}
    otherwise (each key then takes the single-history path)."""
    from ..ops import wgl3, wgl3_kernels

    encs = {k: lin.encode(h) for k, h in keyed.items()}
    tight = max(wgl3.tight_k_slots(e) for e in encs.values())
    max_value = max(e.max_value for e in encs.values())
    if wgl3.dense_config(lin.model, tight, max_value) is None:
        return {}
    keys = list(encs)
    batch, _kernel = wgl3_kernels.check_batch_encoded_auto(
        [encs[k] for k in keys], lin.model, lin.device,
        time_budget_s=lin.time_budget_s)
    return {
        k: {"valid": one["valid"], "backend": lin.backend + "-batched",
            "op_count": one["op_count"], "dead_step": one["dead_step"],
            "max_frontier": one["max_frontier"],
            "configs_explored": one["configs_explored"],
            "overflow": one["overflow"], "f_cap": one["table_cells"]}
        for k, one in zip(keys, batch)
    }
