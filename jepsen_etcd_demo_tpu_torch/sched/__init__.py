"""sched: the corpus scheduler.

  * engine.py - the length-bucketed batch scheduler over a corpus or a
                run's independent keys (check_corpus), with the launch
                shapes behind `corpus`'s cache_hit_rate, and its face on
                one worker thread (submit_corpus), which the checking
                daemon (serve/) awaits

The JAX package's sched/ also warms XLA compilations at startup
(warmup.py), caches compiled checkers (compile_cache.py), packs launches
over a mesh (lpt_shard_order) and keeps launches in flight
(pipeline.py); the port has no XLA and no mesh, and its launch window
comes with the out-of-core chunk loop.
"""

from .engine import (FOLDABLE_STATS, assign_step_buckets, check_corpus,
                     corpus_executor, fold_stats, shape_hit_rate,
                     submit_corpus)

__all__ = [
    "FOLDABLE_STATS",
    "assign_step_buckets",
    "check_corpus",
    "corpus_executor",
    "fold_stats",
    "shape_hit_rate",
    "submit_corpus",
]
