"""Carry state across from the JAX package's arrays.

This system has no weights; what the two packages share is the encoded
history, mid-search the resumable sweep's carry, and elle's tiled
closure grid.

``encoded_from_numpy`` takes the JAX package's encoding as numpy (the
dict its ``EncodedHistory.to_arrays`` returns: ``events`` and the scalar
fields) and builds the port's ``EncodedHistory``, so one encoding can be
fed to both packages.

``table_from_numpy`` takes the outputs of one of the JAX package's
resumable Pallas windows (the table u32[1, Sp, W], rows padded to a
multiple of 8, and the next metadata i32[1, 5] or i32[1, 8]) and builds
the port's carry, so a long sweep started in JAX finishes in the port
(``ops/wgl3_kernels.run_chain(..., carry=...)``). ``table_to_numpy``
pads a port carry back to the JAX layout.

``stream_carry_from_numpy`` takes a key's carry in the JAX package's
streaming check (``stream/engine.KeyStream``: its table u32[S, W], dead
flag, dead_step, max_frontier, the f32 partial sums of its chunks and the
real steps it swept) and builds the port's ``(T, meta)``, so a stream
started in JAX goes on in the port (``wgl3_kernels.stream_chunk``, or
``run_chain(..., carry=...)`` over the rest of the steps);
``stream_carry_to_numpy`` is the way back.

``frontier_from_numpy`` takes a frontier of the JAX package's sort
search (``ops/wgl2.py``: states i32[F], masks u32[F, W], valid bool[F],
as in its carry and its death checkpoint) and builds the port's (states
int32[1, F], masks int64[1, F, W] holding the same uint32 words, valid
bool[1, F]); ``frontier_to_numpy`` is the way back, so the two searches'
frontiers compare bit for bit.

``tiles_from_numpy`` takes the JAX package's tiled closure grid
(``ops/cycles_tiled.closure_tiled``'s f32[nb, nb, T, T], as numpy) of an
n-node graph and builds the port's grid, which has the same layout;
``tiles_to_numpy`` is the way back.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.encode import EVENT_WIDTH, EncodedHistory
from .ops.wgl3 import DenseConfig


def encoded_from_numpy(fields: dict[str, np.ndarray]) -> EncodedHistory:
    events = np.asarray(fields["events"], dtype=np.int32).reshape(
        -1, EVENT_WIDTH)
    n_events = int(fields.get("n_events", events.shape[0]))
    return EncodedHistory(events=events, n_events=n_events,
                          n_ops=int(fields["n_ops"]),
                          k_slots=int(fields["k_slots"]),
                          max_pending=int(fields["max_pending"]),
                          max_value=int(fields.get("max_value", 0)))


def _padded_rows(cfg: DenseConfig) -> int:
    return max(8, (cfg.n_states + 7) // 8 * 8)


def table_from_numpy(table, meta, cfg: DenseConfig
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """JAX window outputs -> the port's carry on the CPU: (T int32[1,S,W]
    holding the same uint32 bit patterns, meta int32[1,5] or int32[1,8]).
    Raises when the table's padding rows hold configs or a shape does not
    match the geometry."""
    table = np.asarray(table).astype(np.uint32)
    meta = np.asarray(meta).astype(np.int32).reshape(1, -1)
    S, W = cfg.n_states, cfg.n_words
    if table.shape != (1, _padded_rows(cfg), W) or meta.shape[1] not in (5, 8):
        raise ValueError(f"JAX carry shapes {table.shape}, {meta.shape} do "
                         f"not match K={cfg.k_slots}, S={S}")
    if table[:, S:].any():
        raise ValueError("the JAX table holds configs in its padding rows")
    T = torch.from_numpy(np.ascontiguousarray(table[:, :S]).view(np.int32))
    return T.clone(), torch.from_numpy(meta.copy())


def table_to_numpy(T: torch.Tensor, meta: torch.Tensor, cfg: DenseConfig
                   ) -> tuple[np.ndarray, np.ndarray]:
    """The port's carry -> the JAX window layout: (u32[1, Sp, W] with zero
    padding rows, i32[1, 5 or 8])."""
    table = np.zeros((1, _padded_rows(cfg), cfg.n_words), np.uint32)
    table[:, :cfg.n_states] = T.cpu().numpy().view(np.uint32)
    return table, meta.cpu().numpy().astype(np.int32)


def stream_carry_from_numpy(table, dead, dead_step, max_frontier, parts,
                            real_dispatched: int, cfg: DenseConfig
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """A JAX KeyStream's carry -> the port's on the CPU: (T int32[1,S,W]
    holding the table's uint32 bit patterns, meta int32[1,5] = [dead,
    dead_step, max_frontier, configs_explored, real steps swept]).
    `parts` is the chunks' summed partials [configs_explored,
    live_tile_sum, real_steps] (None before the first chunk); its
    configs_explored is clipped to the i32 range, as the JAX finalize
    does (exact below 2^24, where f32 sums are). Raises when the table
    does not match the geometry."""
    table = np.asarray(table).astype(np.uint32)
    if table.shape != (cfg.n_states, cfg.n_words):
        raise ValueError(f"JAX stream table {table.shape} does not match "
                         f"K={cfg.k_slots}, S={cfg.n_states}")
    cfgs = 0 if parts is None else int(
        np.clip(np.asarray(parts, np.float32)[0], 0, 2**31 - 1))
    meta = np.array([[int(bool(dead)), int(dead_step), int(max_frontier),
                      cfgs, int(real_dispatched)]], np.int32)
    T = torch.from_numpy(np.ascontiguousarray(table[None]).view(np.int32))
    return T.clone(), torch.from_numpy(meta)


def stream_carry_to_numpy(T: torch.Tensor, meta: torch.Tensor,
                          cfg: DenseConfig) -> dict:
    """The port's stream carry -> the JAX KeyStream's fields as numpy:
    table u32[S, W], dead, dead_step, max_frontier, parts f32[3] and
    real_dispatched. The port keeps no live-tile sum, so parts[1] is 0;
    parts[2], the real steps, is meta's offset."""
    m = [int(x) for x in meta.reshape(-1)[:5].tolist()]
    table = T.reshape(cfg.n_states, cfg.n_words).cpu().numpy()
    return {"table": table.view(np.uint32).copy(),
            "dead": np.bool_(m[0] != 0), "dead_step": np.int32(m[1]),
            "max_frontier": np.int32(m[2]),
            "parts": np.array([m[3] if m[3] >= 0 else 2**31 - 1, 0, m[4]],
                              np.float32),
            "real_dispatched": m[4]}


def frontier_from_numpy(states, masks, valid
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A JAX sort frontier (states i32[F], masks u32[F, W], valid bool[F])
    -> the port's on the CPU: (int32[1, F], int64[1, F, W], bool[1, F]).
    Raises when the shapes disagree."""
    states = np.asarray(states)
    masks = np.asarray(masks)
    valid = np.asarray(valid)
    F = states.shape[0]
    if states.shape != (F,) or masks.ndim != 2 or masks.shape[0] != F \
            or valid.shape != (F,):
        raise ValueError(f"JAX frontier shapes {states.shape}, "
                         f"{masks.shape}, {valid.shape} do not agree")
    return (torch.from_numpy(states.astype(np.int32)[None].copy()),
            torch.from_numpy(masks.astype(np.uint32).astype(np.int64)[None]),
            torch.from_numpy(valid.astype(bool)[None].copy()))


def frontier_to_numpy(states: torch.Tensor, masks: torch.Tensor,
                      valid: torch.Tensor
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The port's one-history frontier -> the JAX layout: (states i32[F],
    masks u32[F, W], valid bool[F])."""
    return (states[0].cpu().numpy().astype(np.int32),
            masks[0].cpu().numpy().astype(np.uint32),
            valid[0].cpu().numpy().astype(bool))


def tiles_from_numpy(grid, n: int) -> torch.Tensor:
    """A JAX tiled-closure grid f32[nb, nb, T, T] of an n-node graph ->
    the port's grid (same layout) on the CPU. Raises when the shape does
    not fit n, an entry is not 0 or 1, or the padding past node n - 1
    holds an edge."""
    grid = np.asarray(grid)
    if grid.ndim != 4 or grid.shape[0] != grid.shape[1] \
            or grid.shape[2] != grid.shape[3] or grid.shape[2] % 128 \
            or grid.shape[0] != max(1, -(-n // grid.shape[2])):
        raise ValueError(f"JAX grid shape {grid.shape} does not fit a "
                         f"{n}-node graph")
    grid = grid.astype(np.float32)
    if not np.isin(grid, (0.0, 1.0)).all():
        raise ValueError("the JAX grid holds entries other than 0 and 1")
    nb, T = grid.shape[0], grid.shape[2]
    full = grid.transpose(0, 2, 1, 3).reshape(nb * T, nb * T)
    if full[n:].any() or full[:, n:].any():
        raise ValueError("the JAX grid holds edges in its padding")
    return torch.from_numpy(np.ascontiguousarray(grid)).clone()


def tiles_to_numpy(R: torch.Tensor) -> np.ndarray:
    """The port's grid -> the JAX layout, f32[nb, nb, T, T] numpy."""
    return R.detach().cpu().numpy().astype(np.float32)
