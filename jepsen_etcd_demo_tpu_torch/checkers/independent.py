"""Independent-keys checker: the equivalent of ``independent/checker``.

A keyed history carries ``(key, value)`` tuples; it is split per key and
each key's history is checked on its own. With a Linearizable sub-checker
and more than one key, every key's history is encoded and all of them are
checked together: in ONE launch of the dense sweep (the key axis is the
batch axis), or, when a key is longer than one scan, one key after another
through the long sweep under the keys' shared geometry. When no dense
table serves every key, all of them go through the batched sort tiers of
the general path instead. A batched result settles a key only when it is
valid: an invalid or unknown key is checked again on its own, which
builds its counterexample witness; a key the tiers left "unknown" starts
its own ladder past the capacities they proved too small (f_cap_floor).
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
            pre = batched.get(k, {})
            if pre.get("valid") is True:
                results[k] = pre
                continue
            sub_opts = {**(opts or {}), "key": k}
            if pre.get("f_cap_floor"):
                sub_opts["f_cap_floor"] = pre["f_cap_floor"]
            results[k] = self.sub_checker.check(test, keyed[k], sub_opts)
        valid = merge_valid([r.get("valid") for r in results.values()])
        return {"valid": valid, "key_count": len(keyed),
                "results": {str(k): v for k, v in results.items()}}


def _batched_linearizable(lin: Linearizable, keyed: dict[Any, list[Op]]
                          ) -> dict[Any, dict]:
    """All keys checked together: through the dense route when one table
    geometry serves them, else through the general path's batched sort
    tiers, where a key the tiers cannot settle gets an "unknown" entry
    with the f_cap_floor its own ladder starts from."""
    from ..ops import wgl3, wgl3_kernels

    encs = {k: lin.encode(h) for k, h in keyed.items()}
    tight = max(wgl3.tight_k_slots(e) for e in encs.values())
    max_value = max(e.max_value for e in encs.values())
    keys = list(encs)
    if wgl3.dense_config(lin.model, tight, max_value) is None:
        slots: list = [None] * len(keys)
        overflowed, _too_long, top = wgl3_kernels._batch_general(
            [encs[k] for k in keys], list(range(len(keys))), lin.model,
            slots, set(), f_cap=lin.f_cap, device=lin.device)
        out = {keys[i]: {"valid": "unknown", "f_cap_floor":
                         wgl3_kernels.LADDER_SEED_FACTOR * top}
               for i in overflowed}
        for k, one in zip(keys, slots):
            if one is not None:
                out[k] = {"valid": one["valid"],
                          "backend": f"torch-{lin.device.type}-batched",
                          "op_count": one["op_count"],
                          "dead_step": one["dead_step"],
                          "max_frontier": one["max_frontier"],
                          "overflow": one["overflow"],
                          "f_cap": one["f_cap"]}
        return out
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
