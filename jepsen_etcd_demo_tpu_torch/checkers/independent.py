"""Independent-keys checker: the equivalent of ``independent/checker``.

A keyed history carries ``(key, value)`` tuples; it is split per key and
each key's history is checked on its own. Where the sub-checker is a
Linearizable, or a Compose whose first-level entries include one (the
register workload's {"linear", "timeline"}), and there is more than one
key, every key's history is encoded and all of them are checked
together for each such entry: the keys a dense table holds through the
corpus scheduler (sched/engine.py) under their shared geometry, in
launches of the dense sweep bucketed by step count (the key axis is the
batch axis), a key longer than one scan through the long sweep; the
others (a partition's keys with tens of forever-pending writes) through
the batched sort tiers of the general path. The JAX package sends every
key to the sort tiers once one of them is past the dense tables. A
batched result settles a key only when it is valid: an invalid or
unknown key is checked again on its own, which builds its counterexample
witness; a key the tiers left "unknown" starts its own ladder past the
capacities they proved too small (f_cap_floor). Keys the run's
streaming check already settled valid (``opts["stream_results"]``) stay
out of the batched launch: their Linearizable takes the streamed
verdict. Every other composed checker (the timeline) runs per key. With
``opts["store_dir"]`` each key's encoded history is written there as
history-<key>.npz.
"""

from __future__ import annotations

from typing import Any, Sequence

from ..ops.op import INVOKE, Op
from .base import Checker, merge_valid
from .compose import Compose
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

    def _batchable(self) -> dict[str | None, Linearizable]:
        """The Linearizable checkers a batched launch serves, by result
        name: the sub-checker itself (None) or a Compose's first-level
        entries, those that search on the device; an oracle-backed one
        checks each key on its own."""
        if isinstance(self.sub_checker, Compose):
            subs = self.sub_checker.checkers.items()
        else:
            subs = [(None, self.sub_checker)]
        return {name: sub for name, sub in subs
                if isinstance(sub, Linearizable) and sub.backend == "torch"}

    def check(self, test: dict, history: Sequence[Op],
              opts: dict | None = None) -> dict[str, Any]:
        keyed = split_by_key(history)
        if not keyed:
            return {"valid": True, "key_count": 0}
        store_dir = (opts or {}).get("store_dir")
        streamed = (opts or {}).get("stream_results")
        batched: dict[str | None, dict[Any, dict]] = {}
        if len(keyed) > 1:
            for name, lin in self._batchable().items():
                rest = {k: h for k, h in keyed.items()
                        if lin.streamed_verdict(streamed, k) is None}
                batched[name] = (_batched_linearizable(lin, rest, store_dir)
                                 if rest else {})
        results = {k: self._check_key(test, keyed[k], opts, batched, k)
                   for k in sorted(keyed, key=str)}
        valid = merge_valid([r.get("valid") for r in results.values()])
        return {"valid": valid, "key_count": len(keyed),
                "results": {str(k): v for k, v in results.items()}}

    def _check_key(self, test, sub_history, opts, batched, key):
        opts = {**(opts or {}), "key": key}

        def pick(name, checker):
            pre = batched.get(name, {}).get(key, {})
            if pre.get("valid") is True:
                return pre
            sub_opts = opts
            if pre.get("f_cap_floor"):
                sub_opts = {**opts, "f_cap_floor": pre["f_cap_floor"]}
            return checker.check(test, sub_history, sub_opts)

        if not isinstance(self.sub_checker, Compose):
            return pick(None, self.sub_checker)
        sub_results = {name: pick(name, sub)
                       for name, sub in self.sub_checker.checkers.items()}
        return {"valid": merge_valid([r.get("valid")
                                      for r in sub_results.values()]),
                **sub_results}


def _batched_linearizable(lin: Linearizable, keyed: dict[Any, list[Op]],
                          store_dir=None) -> dict[Any, dict]:
    """All keys checked together: the keys a dense table holds through the
    corpus scheduler (sched.check_corpus: length-bucketed launches of the
    dense sweep under one geometry), the others through the general
    path's batched sort tiers, where a key the tiers cannot settle gets an
    "unknown" entry with the f_cap_floor its own ladder starts from."""
    from ..ops import wgl3_kernels

    encs = {k: lin.encode(h) for k, h in keyed.items()}
    if store_dir:
        from ..store.store import write_encoded_tensor

        for k, e in encs.items():
            # Empty encodings included: every key's input is stored.
            write_encoded_tensor(store_dir, k, e, lin.model.name)
    keys = list(encs)
    dense_idx, general_idx = wgl3_kernels.partition_dense(
        [encs[k] for k in keys], lin.model)
    out: dict[Any, dict] = {}
    if general_idx:
        slots: list = [None] * len(keys)
        overflowed, _too_long, top = wgl3_kernels._batch_general(
            [encs[k] for k in keys], general_idx, lin.model,
            slots, set(), f_cap=lin.f_cap, device=lin.device)
        out.update({keys[i]: {"valid": "unknown", "f_cap_floor":
                              wgl3_kernels.LADDER_SEED_FACTOR * top}
                    for i in overflowed})
        for i in general_idx:
            one = slots[i]
            if one is not None:
                out[keys[i]] = {"valid": one["valid"],
                                "backend": f"torch-{lin.device.type}-batched",
                                "op_count": one["op_count"],
                                "dead_step": one["dead_step"],
                                "max_frontier": one["max_frontier"],
                                "overflow": one["overflow"],
                                "f_cap": one["f_cap"]}
    if dense_idx:
        from .. import sched

        batch, _kernel, _stats = sched.check_corpus(
            [encs[keys[i]] for i in dense_idx], lin.model, f_cap=lin.f_cap,
            device=lin.device, time_budget_s=lin.time_budget_s)
        out.update({
            keys[i]: {"valid": one["valid"],
                      "backend": lin.dense_backend + "-batched",
                      "op_count": one["op_count"],
                      "dead_step": one["dead_step"],
                      "max_frontier": one["max_frontier"],
                      "configs_explored": one["configs_explored"],
                      "overflow": one["overflow"],
                      "f_cap": one["table_cells"]}
            for i, one in zip(dense_idx, batch)})
    return out
