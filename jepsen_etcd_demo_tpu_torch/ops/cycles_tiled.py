"""Blocked, sparsity-aware transitive closure: elle's big-graph route.

The reachability matrix lives on the card as an [nb, nb] grid of T x T
f32 tiles, R f32[nb, nb, T, T] (T = limits().elle_tile rounded down to a
multiple of 128; the JAX package's layout). Each squaring round computes

    R' = min(R + R @ R, 1)

either densely (one `torch.matmul` of the whole padded matrix) or over
the block products R[i,k] @ R[k,j] whose two operand tiles are live:

  * Occupancy. A tile is live when any entry is nonzero; the eligible
    products are {(i,k,j) : occ[i,k] and occ[k,j]}. A product with an
    empty operand is zero, so the sparse round equals the dense one.
  * The crossover. A round whose eligible count exceeds
    limits().elle_worklist_cap, or whose share of the nb^3 products
    exceeds elle_density_threshold_pct, runs dense.
  * The fixpoint exit. Each round ends in one small fetch,
    [changed, next eligible count, occupied tiles]; the loop stops at the
    first round that changes nothing, after ceil(log2 n_pad) at most.

A sparse round's product-accumulate, acc[d] = sum of the products into
destination tile d, is `tile_accumulate`: on CUDA tensors it launches
csrc/elle_accumulate.cu (the port of the JAX package's Pallas
`_pallas_accumulate`), on CPU tensors it runs its plain version
`tile_accumulate_reference`. The round loop takes the accumulate function
as an argument, so the same loop runs with the kernel or the plain
version. Every round computes exactly min(R + R @ R, 1) (0/1 entries,
sums below 2^24), so the grid, the cycle mask and the round statistics
equal the JAX package's bit for bit.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..device import resolve_device
from .cycles import counts
from .limits import limits

# Kernel launches since the last reset: tile_accumulate adds one where it
# launches csrc/elle_accumulate.cu and nowhere else.
launches = {"tile_accumulate": 0}

# Products the plain version multiplies per batched product (bounds the
# gathered operands: 2 x 512 x 256 KB at T=256).
PLAIN_CHUNK = 512

_P, _I = ctypes.c_void_p, ctypes.c_int
# R, sa, sb, dst, off, out, n_dst, T, stream
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _I, _I, _P]


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _tile() -> int:
    """The tile edge: elle_tile rounded down to a multiple of 128."""
    return max(128, limits().elle_tile // 128 * 128)


def _check_accumulate(R_flat: torch.Tensor, work: torch.Tensor) -> str:
    """'cpu' or 'cuda' after checking the operands: R_flat f32[nbb, T, T]
    contiguous, work int32[3, G] on the same device."""
    if R_flat.dim() != 3 or R_flat.shape[1] != R_flat.shape[2] \
            or R_flat.shape[1] % 128:
        raise ValueError(f"R_flat must be f32[nbb, T, T] with T a multiple "
                         f"of 128; got {tuple(R_flat.shape)}")
    if work.dim() != 2 or work.shape[0] != 3:
        raise ValueError(f"work must be int32[3, G]; got {tuple(work.shape)}")
    if R_flat.device != work.device:
        raise ValueError(f"R_flat on {R_flat.device}, work on {work.device}")
    if R_flat.device.type == "cpu":
        return "cpu"
    if R_flat.device.type != "cuda":
        raise ValueError(f"unsupported device {R_flat.device}")
    if R_flat.dtype != torch.float32 or work.dtype != torch.int32 \
            or not R_flat.is_contiguous():
        raise ValueError("the kernel takes a contiguous f32 grid and an "
                         "int32 work list")
    return "cuda"


def tile_accumulate_reference(R_flat: torch.Tensor, work: torch.Tensor
                              ) -> torch.Tensor:
    """tile_accumulate's plain version: gather both operand tiles, batched
    product, index_add_ into the destinations (PLAIN_CHUNK products at a
    time), on the inputs' device."""
    nbb, T = R_flat.shape[0], R_flat.shape[-1]
    Rz = torch.cat([R_flat, R_flat.new_zeros((1, T, T))])
    acc = R_flat.new_zeros((nbb + 1, T, T))
    sa, sb, dd = work.long()
    for g0 in range(0, sa.numel(), PLAIN_CHUNK):
        g = slice(g0, g0 + PLAIN_CHUNK)
        acc.index_add_(0, dd[g], torch.bmm(Rz[sa[g]], Rz[sb[g]]))
    return acc


def destination_lists(work: torch.Tensor, nbb: int):
    """The destination-major form of a work list, on its device: (sa, sb
    int32[P] sorted by destination, dst int32[D] the live destinations,
    off int32[D+1] CSR offsets: destination dst[i] takes products
    off[i]..off[i+1]). Entries with a zero-sink operand (index nbb)
    contribute nothing and are dropped."""
    sa, sb, dd = work
    keep = (sa < nbb) & (sb < nbb)
    sa, sb, dd = sa[keep], sb[keep], dd[keep]
    dd, order = torch.sort(dd, stable=True)
    dst, per = torch.unique_consecutive(dd, return_counts=True)
    off = torch.zeros(dst.numel() + 1, dtype=torch.int32, device=work.device)
    off[1:] = torch.cumsum(per, 0)
    return (sa[order].contiguous(), sb[order].contiguous(),
            dst.to(torch.int32).contiguous(), off)


def tile_accumulate(R_flat: torch.Tensor, work: torch.Tensor) -> torch.Tensor:
    """One sparse round's product-accumulate. R_flat f32[nbb, T, T] is the
    tile grid; Rz is R_flat with a zero tile appended at index nbb. work
    int32[3, G] holds (sa, sb, dd) per product, indices in [0, nbb]. Returns
    acc f32[nbb + 1, T, T] with acc[d] = sum over g with dd[g] = d of
    Rz[sa[g]] @ Rz[sb[g]].

    On CUDA tensors this launches csrc/elle_accumulate.cu on the current
    stream (it raises on anything the kernel does not take); on CPU
    tensors it runs the plain version."""
    if _check_accumulate(R_flat, work) == "cpu":
        return tile_accumulate_reference(R_flat, work)
    nbb, T = R_flat.shape[0], R_flat.shape[-1]
    out = torch.zeros((nbb + 1, T, T), dtype=torch.float32,
                      device=R_flat.device)
    sa, sb, dst, off = destination_lists(work, nbb)
    if dst.numel() == 0:
        return out
    from . import build

    with torch.cuda.device(R_flat.device):
        build.launcher("elle_accumulate", _ARGTYPES)(
            R_flat.data_ptr(), sa.data_ptr(), sb.data_ptr(), dst.data_ptr(),
            off.data_ptr(), out.data_ptr(), dst.numel(), T,
            torch.cuda.current_stream(R_flat.device).cuda_stream)
    launches["tile_accumulate"] += 1
    return out


# -- the round loop -----------------------------------------------------------

def grid_from_adj(adj: np.ndarray, T: int, dev: torch.device) -> torch.Tensor:
    """adj bool[N, N] -> R f32[nb, nb, T, T] on dev, zero-padded."""
    n = adj.shape[0]
    nb = max(1, -(-n // T))
    R = torch.zeros((nb * T, nb * T), dtype=torch.float32, device=dev)
    src, dst = (torch.from_numpy(x).to(dev) for x in np.nonzero(adj))
    R[src, dst] = 1.0
    return R.reshape(nb, T, nb, T).permute(0, 2, 1, 3).contiguous()


def grid_to_matrix(R: torch.Tensor) -> torch.Tensor:
    nb, T = R.shape[0], R.shape[-1]
    return R.permute(0, 2, 1, 3).reshape(nb * T, nb * T)


def _stats(R: torch.Tensor, changed: torch.Tensor) -> torch.Tensor:
    """[changed, eligible products of the next round, occupied tiles] as
    one int64[3] (the eligible count is sum over k of the live tiles in
    column k times those in row k)."""
    occ = (R.amax(dim=(2, 3)) > 0).long()
    eligible = (occ.sum(0) * occ.sum(1)).sum()
    return torch.stack([changed.long(), eligible, occ.sum()])


def work_list(R: torch.Tensor) -> torch.Tensor:
    """The eligible products of R's grid as int32[3, G] (sa, sb, dd), in
    ascending (i, k, j) order."""
    nb = R.shape[0]
    occ = R.amax(dim=(2, 3)) > 0
    eligible = occ[:, :, None] & occ[None, :, :]
    flat = torch.nonzero(eligible.reshape(-1))[:, 0]
    ii, kk, jj = flat // (nb * nb), (flat // nb) % nb, flat % nb
    return torch.stack([ii * nb + kk, kk * nb + jj, ii * nb + jj]).to(
        torch.int32)


def dense_round(R: torch.Tensor):
    """The whole-matrix squaring through the tile layout: (R', stats)."""
    nb, T = R.shape[0], R.shape[-1]
    Rf = grid_to_matrix(R)
    Rf2 = torch.clamp_max(Rf + Rf @ Rf, 1.0)
    R_new = Rf2.reshape(nb, T, nb, T).permute(0, 2, 1, 3).contiguous()
    return R_new, _stats(R_new, (R_new != R).any())


def sparse_round(R: torch.Tensor, accumulate):
    """One round over the eligible tile products through `accumulate`
    (tile_accumulate or its plain version): (R', stats)."""
    nb, T = R.shape[0], R.shape[-1]
    acc = accumulate(R.reshape(nb * nb, T, T), work_list(R))
    R_new = torch.clamp_max(R + acc[:nb * nb].reshape(nb, nb, T, T), 1.0)
    return R_new, _stats(R_new, (R_new != R).any())


def closure_rounds(R: torch.Tensor, accumulate=None):
    """The fixpoint loop over the grid R f32[nb, nb, T, T]: rounds until
    one changes nothing, ceil(log2(nb * T)) at most. Yields (kind,
    "sparse" or "dense"; the grid after the round; its stats row
    [changed, next round's eligible products, occupied tiles]) per round.
    Sparse rounds call `accumulate` (default tile_accumulate); the tally
    goes to cycles.counts."""
    accumulate = accumulate or tile_accumulate
    nb, T = R.shape[0], R.shape[-1]
    lim = limits()
    nb3 = nb * nb * nb
    row = _stats(R, torch.ones((), dtype=torch.bool,
                               device=R.device)).tolist()
    for _ in range(max(1, int(np.ceil(np.log2(nb * T))))):
        if not row[0]:
            return
        count = row[1]
        if count > lim.elle_worklist_cap \
                or 100.0 * count / nb3 > lim.elle_density_threshold_pct:
            kind, (R, srow) = "dense", dense_round(R)
        else:
            kind, (R, srow) = "sparse", sparse_round(R, accumulate)
        counts[f"tiled_rounds_{kind}"] += 1
        row = srow.tolist()
        yield kind, R, row


def closure_tiled(adj: np.ndarray, device=None, accumulate=None
                  ) -> tuple[torch.Tensor, np.ndarray, dict]:
    """The blocked fixpoint closure of adj bool[N, N]: (R f32[nb, nb, T, T],
    the converged grid on the device; cycle mask bool[N]; stats with the
    JAX package's fields). Sparse rounds call `accumulate` (default
    tile_accumulate)."""
    dev = resolve_device(device)
    n = adj.shape[0]
    T = _tile()
    R = grid_from_adj(adj, T, dev)
    nb = R.shape[0]
    counts["graphs_tiled"] += 1
    stats = {"rounds": 0, "rounds_sparse": 0, "rounds_dense": 0,
             "tile": T, "nb": nb}
    for kind, R, row in closure_rounds(R, accumulate):
        stats["rounds"] += 1
        stats[f"rounds_{kind}"] += 1
    stats["occupied_tiles"] = row[2]
    # Only the diagonal comes back: the nb diagonal tiles' diagonals.
    ar = torch.arange(nb, device=dev)
    diag = torch.diagonal(R[ar, ar], dim1=-2, dim2=-1).reshape(-1)
    return R, (diag[:n] > 0.5).cpu().numpy(), stats


def cycle_mask_tiled(adj: np.ndarray, device=None) -> np.ndarray:
    """bool[N] cycle mask through the tiled closure."""
    return closure_tiled(adj, device)[1]


def reach_and_cycles_tiled(adj: np.ndarray, device=None
                           ) -> tuple[np.ndarray, np.ndarray]:
    """(reach bool[N, N], cycle mask bool[N]) through the tiled closure:
    the whole grid comes back to the host."""
    n = adj.shape[0]
    R, cyc, _stats_ = closure_tiled(adj, device)
    return (grid_to_matrix(R)[:n, :n] > 0.5).cpu().numpy(), cyc
