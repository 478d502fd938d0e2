"""The kernel limits the dense check, the sort ladder, the elle closure,
the streaming check and the checking daemon read, with their defaults
(the JAX package's).

A frozen dataclass and nothing more: no environment overrides and no
tuned profiles. ``set_limits`` swaps the active instance (tests use it to
shrink a bound).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class KernelLimits:
    # Largest dense table (S * 2^K cells) the dense check builds per
    # history. Every admitted table is at most 2^20 bits = 128 KiB, which
    # is what lets the CUDA kernels hold it in one block's shared memory.
    dense_cell_budget: int = 1 << 20
    # Larger table budget of the general path's dense-chunked rung
    # (wgl3_kernels.check_encoded_general): a history past the sort
    # ladder's capacity is swept window by window over a table of up to
    # 2^26 bits = 8 MiB, which csrc/wgl3_sweep.cu's global tier splits
    # over the shared memories of thread-block clusters past 2^20 bits.
    dense_cell_budget_chunked: int = 1 << 26
    # Longest return-step scan one launch of the batch sweep takes;
    # longer histories take the resumable sweep, one window at a time.
    long_scan_max: int = 32768
    # Floor of the {2^k, 1.5*2^k} step-count buckets.
    step_bucket_floor: int = 32
    # Return steps per launch of the resumable sweeps (rounded down to a
    # step bucket, see wgl3_kernels.long_window); the table and metadata
    # carry from one window's launch to the next.
    long_window_steps: int = 16384
    # Sweep mode of the long sweeps: 0 = auto (the sparse work-list kernel
    # where the density policy selects it), 1 = dense only, 2 = prefer
    # sparse (every closure round sweeps only live blocks).
    sparse_mode: int = 0
    # Words a table row (2^K / 32) must span before auto mode selects the
    # sparse sweep: the JAX package's default, 2048 tiles of 8 words. No
    # row the dense budget admits is that wide (K <= 18: 8192 words), so
    # auto mode runs dense unless this is lowered.
    sparse_min_words: int = 16384
    # Live-block share, in percent, above which a closure round of the
    # sparse sweep runs dense instead (auto mode).
    sparse_density_threshold_pct: int = 25
    # Sort rows (f_cap * (k_slots + 1) keys) per launch of the batched sort
    # search (wgl3_kernels._batch_general chunks its batch under it).
    sort_row_budget: int = 1 << 21
    # Frontier canonicalisation of the sort search (ops/canon.py): 0 =
    # auto (on for the resumable sort ladder, off for table sweeps), 1 =
    # off, 2 = force.
    dedup_mode: int = 0
    # Subsumption of the sort search's frontier over forever-pending ops
    # (ops/subsume.py), batched tiers and ladder alike: 0 = on unless
    # dedup_mode is 1, 1 = off (the JAX package's search).
    subsume_mode: int = 0
    # Stacked-batch element budget: a batched launch of the elle closure
    # stacks at most this many f32 cells, a batched sort search at most
    # this many slot-table rows (both chunk above it), the device encoder
    # at most this many one-hot cells (events x slots).
    stack_element_budget: int = 1 << 26
    # Where encode_return_steps expands events into return steps: 0 =
    # auto, 1 = the host always, 2 = the device (ops/encode_device.py)
    # whenever device_encode_feasible. The JAX package's auto takes the
    # device only on its mesh-sharded batch lane, which the port does not
    # have yet, so auto takes the host. Every mode gives the same rows.
    encode_mode: int = 0

    # -- the corpus scheduler (sched/) and the encode cache --
    # Floor of the {2^k, 1.5*2^k} batch-axis buckets the scheduler pads
    # its launches to with all-pad (0-step) histories.
    batch_bucket_floor: int = 8
    # On-disk cap (MiB) of the encode cache (store/encode_cache.py): past
    # it the least recently used entries are removed; 0 = no cap.
    encode_cache_cap_mb: int = 2048

    # -- the elle closure engine (ops/cycles.py, ops/cycles_tiled.py) --
    # Route: 0 = auto (dense squaring up to elle_dense_max_nodes, weak
    # components above it: small ones batched, big ones tiled), 1 = dense
    # only, 2 = tiled only. Every route gives the same verdicts.
    elle_mode: int = 0
    # Largest graph (nodes) the auto route closes as one dense matrix.
    elle_dense_max_nodes: int = 2048
    # Tile edge of the tiled closure, rounded down to a multiple of 128.
    elle_tile: int = 256
    # Floor of the {2^k, 1.5*2^k} batch buckets of batched closures.
    elle_batch_floor: int = 8
    # Tile products a sparse round of the tiled closure may take; a round
    # with more runs as one dense matrix product.
    elle_worklist_cap: int = 4096
    # Eligible-product share (percent of nb^3) above which a tiled round
    # runs dense.
    elle_density_threshold_pct: int = 35
    # Largest padded matrix (n_pad^2 cells) a closure puts on the card;
    # past it the graph takes the exact host Tarjan/SCC oracle.
    elle_cell_budget: int = 1 << 28

    # -- the streaming check (stream/) --
    # Completed txns between two re-checks of the streaming elle
    # session's growing dependency graph (1..65,536).
    elle_stream_flush: int = 64
    # Stable return steps per streamed chunk: one resumable sweep launch
    # per key each time this many accumulate (8..65,536). Verdicts do not
    # depend on it (the carry chains exactly).
    stream_flush_ops: int = 256
    # Chunks dispatched between two reads of a key's death flag, so the
    # fail-fast lag is at most stream_max_lag_chunks * stream_flush_ops
    # return steps (1..64).
    stream_max_lag_chunks: int = 4

    # -- the checking daemon (serve/) --
    # Max-linger of the coalescing scheduler (serve/scheduler.py): after
    # the first pending request arrives, the dispatcher waits up to this
    # many milliseconds for more to join the same bucketed launches
    # (0..1000; 0 dispatches what is queued at once).
    serve_coalesce_ms: int = 10
    # Most requests one coalesced batch carries (1..4096); the batch still
    # splits into the scheduler's step buckets downstream.
    serve_max_batch: int = 64
    # Per-tenant bound of admitted, unfinished requests (1..4096): past it
    # a submission is refused with HTTP 429 until verdicts drain.
    serve_max_inflight: int = 256


_ACTIVE = KernelLimits()


def limits() -> KernelLimits:
    return _ACTIVE


def set_limits(new: KernelLimits) -> KernelLimits:
    """Install `new`; returns the previous instance for restoring."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, new
    return prev
