"""Length-bucketed corpus scheduler: the batched check of many histories.

`wgl3_kernels.check_batch_encoded_auto` pads every dense history of a
batch to the longest one's step count, so one long history makes every
other history's launch long. Here the dense histories are grouped into
{2^k, 1.5*2^k} buckets of their return-step counts (from
limits().step_bucket_floor, so a bucket pads under 1.5x past the floor),
the batch axis of each launch is padded to a bucket too (from
limits().batch_bucket_floor, with all-pad 0-step histories whose rows are
dropped), and each bucket is launched through the dense sweep
(csrc/wgl3_sweep.cu). Every bucket is launched before any result is
read back, in one copy at the end, so the host stacks and copies bucket
N+1 while the card sweeps bucket N (stack_steps3 stages through pinned
memory).

The routing is check_batch_encoded_auto's: histories past one scan
(long_scan_max) take the long route one by one, and histories no dense
table holds, or that share no geometry, the general path (the batched
sort tiers, then a ladder each). The scheduler changes how the dense
majority is padded and launched, never which kernel checks what, so
results are those of the unbatched path.

The JAX package's sched/engine.py, without its telemetry (spans, the
scaling ledger, the health supervisor), its mesh sharding
(lpt_shard_order) and its executor thread (submit_corpus): the port has
none of these yet, nor a caller of the last.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..ops import wgl3
from ..ops import wgl3_kernels as wk
from ..ops.encode import (EV_RETURN, ReturnSteps, encode_return_steps,
                          reslot_events)
from ..ops.limits import limits


def assign_step_buckets(step_counts: Sequence[int]) -> list[int]:
    """The padded-length bucket of each count: a function of the count and
    the active limits only, so a count lands in the same bucket wherever
    it sits in the corpus."""
    floor = limits().step_bucket_floor
    return [wgl3.step_bucket(int(n), floor=floor) for n in step_counts]


def _batch_bucket(n: int, cap: int) -> int:
    """The batch-axis bucket of n histories: {2^k, 1.5*2^k} from the batch
    floor, at most the launch-size cap `cap` (and never below n)."""
    b = min(wgl3.step_bucket(n, floor=limits().batch_bucket_floor), cap)
    return max(b, n)


def _pad_rs(k_slots: int) -> ReturnSteps:
    """An all-pad (0-step) history for batch padding: its lane survives
    with no work, and its row is dropped."""
    return ReturnSteps(
        slot_tabs=np.zeros((0, k_slots, 4), np.int32),
        slot_active=np.zeros((0, k_slots), bool),
        targets=np.zeros((0,), np.int32),
        n_steps=0, n_ops=0, k_slots=k_slots, max_pending=0, max_value=0)


def kernel_label(device: torch.device) -> str:
    """The `kernel` of a bucketed launch's results on `device`."""
    return "wgl3-dense-cuda" if device.type == "cuda" else "wgl3-dense-plain"


def launch_bucket(model, cfg: wgl3.DenseConfig,
                  steps: Sequence[ReturnSteps], r: int, device
                  ) -> torch.Tensor:
    """The launch of one bucket: the histories of `steps` padded to r
    return steps, stacked and copied to the device (wgl3.stack_steps3),
    prepared there (wgl3_kernels.prepare_colmask) and swept by
    wgl3_kernels.dense_sweep. Returns the device's int32[len(steps), 5]
    rows (wgl3.PACKED_FIELDS) without waiting for them."""
    arrays = wgl3.stack_steps3(steps, r, device)
    ln, tg, cm = wk.prepare_colmask(model, cfg, *arrays)
    return wk.dense_sweep(ln, tg, cm, cfg, wgl3.init_row(model, cfg),
                          grouped=True)


# The launch shapes (kernel, model name, K, S, b, r) this process has
# launched, and how many launches found their shape already seen: their
# share is `corpus`'s cache_hit_rate. The JAX package counts reuse of a
# compiled checker there; the port builds each kernel once per process
# (ops/build.py), so here it counts repeated shapes only.
_seen_shapes: set[tuple] = set()
shape_counts = {"hits": 0, "misses": 0}


def _note_shape(shape: tuple) -> None:
    if shape in _seen_shapes:
        shape_counts["hits"] += 1
    else:
        _seen_shapes.add(shape)
        shape_counts["misses"] += 1


def shape_hit_rate() -> float:
    """Launches whose shape was seen before, over all bucket launches of
    this process (0.0 before the first)."""
    n = shape_counts["hits"] + shape_counts["misses"]
    return shape_counts["hits"] / n if n else 0.0


class _Stats:
    """One call's accounting."""

    def __init__(self):
        self.steps_real = 0
        self.steps_padded = 0
        self.launches = 0
        self.buckets: dict[int, int] = {}
        self.sweep_steps_sparse = 0
        self.sweep_steps_dense = 0
        self.configs_pruned = 0
        self.sparse_overflow_rounds = 0

    def record_sweep(self, result: dict) -> None:
        """Fold a long sweep's sparse-sweep record and frontier-dedup
        counts into the totals."""
        sweep = result.get("sweep")
        dedup = result.get("dedup")
        if isinstance(sweep, dict):
            self.sweep_steps_sparse += int(sweep.get("steps_sparse", 0))
            self.sweep_steps_dense += int(sweep.get("steps_dense", 0))
            self.sparse_overflow_rounds += int(
                sweep.get("overflow_rounds", 0))
        if isinstance(dedup, dict):
            self.configs_pruned += int(dedup.get("configs_pruned", 0))

    def record_launch(self, real: int, b: int, r: int) -> None:
        self.steps_real += real
        self.steps_padded += b * r
        self.launches += 1
        self.buckets[r] = self.buckets.get(r, 0) + 1

    def to_dict(self) -> dict:
        return {
            "launches": self.launches,
            "buckets": sorted(self.buckets.items()),
            "steps_real": self.steps_real,
            "steps_padded": self.steps_padded,
            "padding_waste": (round(self.steps_padded / self.steps_real, 4)
                              if self.steps_real else 0.0),
            "sweep_steps_sparse": self.sweep_steps_sparse,
            "sweep_steps_dense": self.sweep_steps_dense,
            "configs_pruned": self.configs_pruned,
            "sparse_overflow_rounds": self.sparse_overflow_rounds,
        }


#: The numeric stats fields a consumer of several calls sums (`corpus`
#: over its models); padding_waste is derived from the summed steps.
FOLDABLE_STATS = ("launches", "steps_real", "steps_padded",
                  "sweep_steps_sparse", "sweep_steps_dense",
                  "configs_pruned", "sparse_overflow_rounds")


def fold_stats(total: dict, stats: dict) -> dict:
    """Add one check_corpus stats dict into a running total."""
    for f in FOLDABLE_STATS:
        total[f] = total.get(f, 0) + int(stats.get(f, 0) or 0)
    return total


def check_corpus(encs: Sequence, model=None, f_cap: int = 256, device=None,
                 time_budget_s: float | None = None
                 ) -> tuple[list[dict], str, dict]:
    """Check a corpus of encoded histories on `device` (None = cuda)
    through the bucketed scheduler; returns (results in the order of
    `encs`, the kernel name, "mixed" when the histories split across
    routes, the stats dict). `time_budget_s` bounds each long sweep and
    each ladder, as in check_batch_encoded_auto. One history or none
    takes check_batch_encoded_auto itself: there is nothing to bucket."""
    dev = resolve_device(device)
    if model is None:
        from ..models import CASRegister

        model = CASRegister()
    stats = _Stats()
    if len(encs) <= 1:
        results, kernel = wk.check_batch_encoded_auto(
            encs, model, dev, time_budget_s=time_budget_s)
        return results, kernel, stats.to_dict()

    results: list[Any] = [None] * len(encs)
    kernels: set[str] = set()
    dense_idx, general_idx = wk.partition_dense(encs, model)
    if dense_idx:
        k = max(wgl3.tight_k_slots(encs[i]) for i in dense_idx)
        cfg = wgl3.dense_config(model, k,
                                max(encs[i].max_value for i in dense_idx))
        if cfg is None:
            # Each is feasible alone but no one geometry serves them all:
            # they take the general path, as in the auto router.
            general_idx = sorted(general_idx + dense_idx)
        else:
            _check_dense(encs, dense_idx, model, cfg, results, kernels,
                         stats, dev, time_budget_s)
    if general_idx:
        _check_general(encs, general_idx, model, results, kernels, f_cap,
                       dev, time_budget_s)
    kernel = kernels.pop() if len(kernels) == 1 else (
        "mixed" if kernels else "none")
    return results, kernel, stats.to_dict()


def _check_dense(encs, dense_idx, model, cfg: wgl3.DenseConfig,
                 results: list, kernels: set, stats: _Stats, dev,
                 time_budget_s) -> None:
    """The dense partition under its shared geometry: the long histories
    one by one through the long route, the others in bucketed launches."""
    lim = limits()
    k = cfg.k_slots
    steps_of: dict[int, ReturnSteps] = {}
    long_idx, short_idx = [], []
    for i in dense_idx:
        e = encs[i]
        rs = encode_return_steps(reslot_events(e, k) if e.k_slots != k
                                 else e, dev)
        steps_of[i] = rs
        (long_idx if rs.n_steps > lim.long_scan_max
         else short_idx).append(i)

    for i in long_idx:
        one = wk.run_long_dense(steps_of[i], model, cfg, dev, time_budget_s)
        results[i] = one
        kernels.add(one["kernel"])
        stats.record_sweep(one)

    buckets: dict[int, list[int]] = {}
    for i, r in zip(short_idx, assign_step_buckets(
            [steps_of[i].n_steps for i in short_idx])):
        buckets.setdefault(r, []).append(i)
    label = kernel_label(dev)
    launched: list[tuple[list[int], torch.Tensor]] = []
    for r in sorted(buckets):
        idxs = buckets[r]
        # Launch-size cap: one launch's stacked slot tables stay within
        # the stacked-element budget.
        chunk = max(1, lim.stack_element_budget // max(1, r * (k * 5 + 1)))
        for c0 in range(0, len(idxs), chunk):
            part = idxs[c0:c0 + chunk]
            part_steps = [steps_of[i] for i in part]
            b = _batch_bucket(len(part), chunk)
            _note_shape((label, model.name, k, cfg.n_states, b, r))
            rows = launch_bucket(
                model, cfg, part_steps + [_pad_rs(k)] * (b - len(part)), r,
                dev)
            launched.append((part, rows[:len(part)]))
            stats.record_launch(sum(s.n_steps for s in part_steps), b, r)
            kernels.add(label)
    if not launched:
        return
    # One read back of every launch's rows, after the last launch.
    order = [i for part, _rows in launched for i in part]
    host = torch.cat([rows for _part, rows in launched]).cpu().numpy()
    for i, one in zip(order, wgl3.assemble_batch_results(
            wgl3.unpack_np(host), [steps_of[i] for i in order], cfg)):
        results[i] = one


def _check_general(encs, general_idx, model, results: list, kernels: set,
                   f_cap: int, dev, time_budget_s) -> None:
    """The general partition: the batched sort tiers, grouped by the
    bucket of each history's return count so short histories do not pad
    to the longest, then a ladder each for what the tiers left."""
    def return_count(e) -> int:
        ev = np.asarray(e.events[: e.n_events])
        return int((ev[:, 0] == EV_RETURN).sum()) if e.n_events else 0

    groups: dict[int, list[int]] = {}
    for i, r in zip(general_idx, assign_step_buckets(
            [return_count(encs[i]) for i in general_idx])):
        groups.setdefault(r, []).append(i)
    overflow_seeds: list[tuple[int, int]] = []
    too_long_all: list[int] = []
    for r in sorted(groups):
        overflowed, too_long, top = wk._batch_general(
            encs, groups[r], model, results, kernels, f_cap=f_cap,
            device=dev)
        overflow_seeds.extend(
            (i, wk.LADDER_SEED_FACTOR * top) for i in overflowed)
        too_long_all.extend(too_long)
    wk.ladder_tail(encs, model, results, kernels, too_long_all,
                   overflow_seeds, dev, time_budget_s)
