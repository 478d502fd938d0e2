"""sched: the corpus scheduler.

  * engine.py - the length-bucketed batch scheduler over a corpus or a
                run's independent keys (check_corpus), with the launch
                shapes behind `corpus`'s cache_hit_rate

The JAX package's sched/ also warms XLA compilations at startup
(warmup.py), caches compiled checkers (compile_cache.py), packs launches
over a mesh (lpt_shard_order) and runs corpora on an executor thread
(submit_corpus, with pipeline.py's helpers); the port has no XLA, no
mesh and no caller of an executor yet.
"""

from .engine import (FOLDABLE_STATS, assign_step_buckets, check_corpus,
                     fold_stats, shape_hit_rate)

__all__ = [
    "FOLDABLE_STATS",
    "assign_step_buckets",
    "check_corpus",
    "fold_stats",
    "shape_hit_rate",
]
