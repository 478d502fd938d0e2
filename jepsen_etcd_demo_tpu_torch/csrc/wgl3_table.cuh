// Table algebra shared by the dense sweep (wgl3_sweep.cu) and the sparse
// work-list sweep (wgl3_sparse.cu): a thread block holds one history's
// reachability table in shared memory. The step inputs come through a
// ring filled by cp.async, and a slot fires into the destination rows it
// has a transition to only.
//
// The table is uint32[S][W], W = 2^(K-5): bit p of word w of row s is the
// config (state row s, linearized mask w*32 + p). cms[d*K + j] is the
// column mask of the current step: bit s says that firing slot j moves
// state row s to row d.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace wgl3 {

// Configs whose in-word index has bit j clear (j < 5).
__device__ __forceinline__ uint32_t lo_mask(int j) {
  switch (j) {
    case 0: return 0x55555555u;
    case 1: return 0x33333333u;
    case 2: return 0x0F0F0F0Fu;
    case 3: return 0x00FF00FFu;
    default: return 0x0000FFFFu;
  }
}

// Per word w: the configs with mask bit t clear (may still fire; those
// with bit t set are banked and never expanded).
__device__ __forceinline__ uint32_t allowed_word(int w, int t) {
  if (t < 5) return lo_mask(t);
  return ((w >> (t - 5)) & 1) ? 0u : 0xFFFFFFFFu;
}

__device__ __forceinline__ uint32_t gather_sources(const uint32_t* T, int W,
                                                   int w, uint32_t m) {
  uint32_t acc = 0;
  while (m) {
    const int s = __ffs(m) - 1;
    m &= m - 1;
    acc |= T[s * W + w];
  }
  return acc;
}

// Prune at the returning slot t, in place: keep the configs that fired t,
// re-addressed with bit t clear. Every word is rewritten, so a table with
// no survivor is all zero afterwards. Returns whether this thread kept a
// config (the caller reduces it with __syncthreads_or).
__device__ inline int prune_table(uint32_t* T, int S, int W, int t) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  int alive = 0;
  if (t < 5) {
    const int sh = 1 << t;
    const uint32_t lo = lo_mask(t);
    for (int i = tid; i < S * W; i += nt) {
      const uint32_t v = (T[i] >> sh) & lo;
      T[i] = v;
      alive |= (v != 0u);
    }
  } else {
    const int sh = t - 5;
    const int dlt = 1 << sh;
    const int half = W >> 1;
    for (int i = tid; i < S * half; i += nt) {
      const int s = i / half;
      const int k = i - s * half;
      const int ws = ((k >> sh) << (sh + 1)) | (k & (dlt - 1));
      const uint32_t v = T[s * W + (ws | dlt)];
      T[s * W + ws] = v;
      T[s * W + (ws | dlt)] = 0u;
      alive |= (v != 0u);
    }
  }
  return alive;
}

// -- staged step inputs ------------------------------------------------------
//
// A ring of kRing step slots in shared memory, each S*K + 1 words: the
// step's target slot, then its S*K column masks. The copies are cp.async
// (one commit group per step, in step order), so a step's inputs arrive
// while earlier steps are swept; a consumer waits for its step's group
// with cp_async_wait<kRing - 1>() and a barrier (warp or block) that makes
// every thread's copies visible.

constexpr int kRing = 4;

__device__ __forceinline__ void cp_async4(uint32_t* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// This thread's share (words i0, i0 + stride, ...) of the copies of step r
// into `slot`; the caller commits the group.
__device__ __forceinline__ void stage_step(uint32_t* slot, const int* tgb,
                                           const uint32_t* cmb, int r, int SK,
                                           int i0, int stride) {
  for (int i = i0; i <= SK; i += stride) {
    if (i == 0)
      cp_async4(slot, tgb + r);
    else
      cp_async4(slot + i, cmb + (size_t)r * SK + (i - 1));
  }
}

// The destinations slot `lane` has a transition to: bit d set when
// cms[d*K + lane] is nonzero (0 for lanes >= K). Lane j of every warp
// holds slot j's; __shfl_sync hands it to the warp.
__device__ __forceinline__ uint32_t slot_destinations(const uint32_t* cms,
                                                      int S, int K, int lane) {
  uint32_t nz = 0u;
  if (lane < K)
    for (int d = 0; d < S; ++d) nz |= (cms[d * K + lane] != 0u ? 1u : 0u) << d;
  return nz;
}

// Fires slot j < 5 (a shift by 2^j inside word w) from the configs of
// word w with mask bit j clear, into the rows set in `nz`; returns whether
// a word changed.
__device__ __forceinline__ int fire_in_word_nz(uint32_t* T,
                                               const uint32_t* cms, int K,
                                               int W, int w, int j, int t,
                                               uint32_t nz) {
  const uint32_t a = allowed_word(w, t) & lo_mask(j);
  if (!a) return 0;
  const int sh = 1 << j;
  int changed = 0;
  while (nz) {
    const int d = __ffs(nz) - 1;
    nz &= nz - 1;
    const uint32_t m = cms[d * K + j];
    if (!m) continue;
    const uint32_t fired = gather_sources(T, W, w, m) & a;
    const uint32_t old = T[d * W + w];
    const uint32_t nv = old | (fired << sh);
    if (nv != old) {
      T[d * W + w] = nv;
      changed = 1;
    }
  }
  return changed;
}

// Fires slot j >= 5 from source word ws into destination word wd of the
// rows set in `nz`: wd = ws | 2^(j-5) inside the table, or the matching
// word of another 128-word block for the sparse sweep's block slots. The
// configs fired have the slot's bit set, the sources have it clear, so
// nothing races.
__device__ __forceinline__ int fire_across_nz(uint32_t* T, const uint32_t* cms,
                                              int K, int W, int ws, int wd,
                                              int j, int t, uint32_t nz) {
  const uint32_t a = allowed_word(ws, t);
  if (!a) return 0;
  int changed = 0;
  while (nz) {
    const int d = __ffs(nz) - 1;
    nz &= nz - 1;
    const uint32_t m = cms[d * K + j];
    if (!m) continue;
    const uint32_t fired = gather_sources(T, W, ws, m) & a;
    const uint32_t old = T[d * W + wd];
    const uint32_t nv = old | fired;
    if (nv != old) {
      T[d * W + wd] = nv;
      changed = 1;
    }
  }
  return changed;
}

// One sweep of the K slots over the whole table in shared memory, called
// by every thread of the block. A thread first closes the word columns it
// owns (w = tid, tid + nt, ...; all S rows) under the in-word slots 0..4,
// with no barrier between them, counting the columns' configs before it
// touches them; then the slots j >= 5 with a transition run one at a time,
// a barrier before each. `nz` is this lane's slot_destinations. Returns
// whether this thread changed a word (the caller ends the sweep with
// __syncthreads_or); cnt gets the set bits of its columns at the sweep's
// start, which, in the sweep that changes nothing, is its share of the
// converged table.
__device__ __forceinline__ int dense_sweep_staged(uint32_t* T,
                                                  const uint32_t* cms, int S,
                                                  int K, int W, int t,
                                                  uint32_t nz,
                                                  unsigned int& cnt) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  uint32_t nzin[5];
#pragma unroll
  for (int j = 0; j < 5; ++j) nzin[j] = __shfl_sync(0xFFFFFFFFu, nz, j);
  int changed = 0;
  unsigned int c = 0u;
  for (int w = tid; w < W; w += nt) {
    for (int s = 0; s < S; ++s) c += __popc(T[s * W + w]);
#pragma unroll
    for (int j = 0; j < 5; ++j)
      if (nzin[j]) changed |= fire_in_word_nz(T, cms, K, W, w, j, t, nzin[j]);
  }
  cnt = c;
  for (int j = 5; j < K; ++j) {
    const uint32_t nzj = __shfl_sync(0xFFFFFFFFu, nz, j);
    if (!nzj) continue;  // block-uniform: the masks are the block's
    __syncthreads();
    const int sh = j - 5;
    const int dlt = 1 << sh;
    for (int i = tid; i < (W >> 1); i += nt) {
      const int ws = ((i >> sh) << (sh + 1)) | (i & (dlt - 1));
      changed |= fire_across_nz(T, cms, K, W, ws, ws | dlt, j, t, nzj);
    }
  }
  return changed;
}

}  // namespace wgl3
