// Dense subset-lattice WGL sweep for Hopper (sm_90a).
//
// Replaces three Pallas TPU kernels of the JAX package
// (jepsen_etcd_demo_tpu/ops/wgl3_pallas.py):
//   _kernel_body               one history per program, whole scan;
//   _kernel_body_grouped       G histories per program in lockstep;
//   _kernel_body(resume=True)  one window of a long history's scan, the
//                              table and metadata carried in and out.
// All three compute the same function per history, and so does this
// kernel: it runs a history's return-step scan with the reachability
// table held on chip. The third also sweeps the general path's
// dense-chunked tables (2^20 < S * 2^K <= 2^26 bits), which no block's
// shared memory holds: the global tier below splits those over the
// shared memories of a cluster of blocks, or of a few clusters.
//
// Layout (ops/wgl3_kernels.py prepares it):
//   ln   int32[B]          real (non-pad) return steps of each history
//   tg   int32[B, R]       target slot of each return step; -1 = pad (suffix)
//   cm   uint32[B, R, S, K] column masks: bit s of cm[b, r, s', j] says that
//                          firing slot j moves state row s to row s'
//   out  int32[B, 5]       survived, overflow (always 0), dead_step,
//                          max_frontier, configs_explored (may be null)
//   Tio  uint32[B, S, W]   carried table (null: fresh start)
//   meta int32[B, 5]       carried [dead, dead_step, max_frontier,
//                          configs_explored, offset] (null with Tio)
// With a carry the history loads Tio and meta, runs its ln steps with
// dead_step = offset + r, and writes the table and the next meta (offset
// advanced by ln) back in place: history b's warp or block alone touches
// its carry. A window that starts dead only advances the offset.
//
// The function. Each step closes the table under the K slots with the
// configs whose mask has the target bit t set banked (never expanded),
// counts the closed table, prunes at t and stops the scan at the first
// empty table. Firing slot j < 5 shifts inside a word; slot j >= 5 moves
// configs from word w (bit j-5 clear) to word w + 2^(j-5). With the
// banking mask fixed the closure is a monotone operator with one least
// fixpoint above the step's starting table: any order of firings that
// runs until nothing changes reaches it, so the counts equal the XLA and
// Pallas kernels' exactly. They are taken on the converged table only.
//
// Design. Two routes, chosen per geometry by the launcher:
//   * Registers (S' * NR <= 32, S' = S rounded up to a power of two, NR =
//     max(1, W/32) words per row and lane; K <= 12 at S = 8): one warp per
//     history, the whole table in its registers. Lane L owns the word
//     columns w = L + 32q (q < NR) of every row. Slot j < 5 is a shift
//     inside a register; 5 <= j < 10 pairs lanes L and L ^ 2^(j-5)
//     (__shfl_xor_sync of the fired words); j >= 10 pairs registers q and
//     q | 2^(j-10) of one lane. The slot loop is unrolled at compile
//     time. The step's slot table (each slot's destination rows and column
//     masks) is read in one of two ways: shuffled once per step into every
//     lane's registers, so a sweep reads neither shared memory nor
//     shuffles for it, or read by each sweep from the step's ring slot (a
//     shuffle and a broadcast shared load per slot, no per-step set-up).
//     The launcher picks by slot_table_in_registers(); both give the same
//     result. The fixpoint test is __any_sync and the count
//     __reduce_add_sync: no block barrier at all. A corpus packs kWarps
//     histories per block, one per warp.
//   * Shared memory (larger tables): one block of up to 1024 threads per
//     history, the table in shared memory. A sweep closes each thread's
//     word columns under slots 0..4 without a barrier, then the slots
//     j >= 5 that have a transition, a barrier before each; the count is
//     taken during the sweep (the last sweep changes nothing) and summed
//     with one shared atomic per warp (wgl3_table.cuh).
//   * Global (tables past 2^20 bits, one history a launch): G blocks of
//     up to 1024 threads in clusters of C (16 on the H100), each block
//     holding a slice of the word columns of every row in its shared
//     memory for the whole window. A block closes its slice under slots
//     0..4 and the slots inside the slice until nothing changes, before
//     any exchange; the slots that cross two blocks of a cluster read the
//     partner's slice through distributed shared memory, behind cluster
//     barriers (barrier.cluster arrive.release / wait.acquire); only the
//     slots that cross two clusters go through device memory behind a
//     grid barrier (a cooperative launch with a cluster dimension), which
//     also carries the fixpoint flag. A table of 2^21 bits is one
//     cluster, so its launch has no grid barrier at all; from 2^22 bits
//     the grid holds more than one cluster.
// The routes iterate only the destinations a slot has a transition to
// (usually one: the model is deterministic), and both read their step
// inputs from a ring in shared memory that cp.async fills kRing steps
// ahead, so no step waits on device memory.
//
// What bounds it on this card. A step is a chain of dependent sweeps over
// a table of a few KB: latency (shuffles, shared-memory loads, barriers
// on the shared route) and integer issue, not device memory (a history's
// inputs are read once). A lone history runs on one SM; a corpus of B
// histories fills the 132 SMs. Splitting one large table over a cluster
// of blocks is done only past 2^20 bits, by the global tier, whose steps
// wait on its cluster barriers (about 0.8 us on the H100) and, from 2^22
// bits, its grid barriers (about 1.2 us), one of each a pass.

#include <cooperative_groups.h>

#include "wgl3_table.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarps = 4;  // histories per block on the register route

// -- the register route ------------------------------------------------------

// g[q] = OR of T[s][q] over the rows s set in m.
template <int SP, int NR>
__device__ __forceinline__ void gather_regs(uint32_t (&T)[SP][NR],
                                            uint32_t m, uint32_t (&g)[NR]) {
#pragma unroll
  for (int q = 0; q < NR; ++q) g[q] = 0u;
#pragma unroll
  for (int s = 0; s < SP; ++s) {
    if ((m >> s) & 1u) {
#pragma unroll
      for (int q = 0; q < NR; ++q) g[q] |= T[s][q];
    }
  }
}

// Fires slot J into row d from the rows set in m: the configs with mask
// bit J clear and not banked (a) move to bit J set. J < 5 shifts inside a
// register; 5 <= J < 10 hands the fired words to lane L ^ 2^(J-5) (only
// lanes with that bit set take them); J >= 10 moves register q to
// q | 2^(J-10). Returns whether T changed.
template <int J, int SP, int NR>
__device__ __forceinline__ int fire_slot(uint32_t (&T)[SP][NR],
                                         const uint32_t (&a)[NR], int lane,
                                         int d, uint32_t m) {
  uint32_t g[NR];
  gather_regs<SP, NR>(T, m, g);
  uint32_t f[NR];
  if constexpr (J < 5) {
#pragma unroll
    for (int q = 0; q < NR; ++q)
      f[q] = (g[q] & a[q] & wgl3::lo_mask(J)) << (1 << J);
  } else if constexpr (J < 10) {
    const bool dst = (lane >> (J - 5)) & 1;
#pragma unroll
    for (int q = 0; q < NR; ++q) {
      const uint32_t v = __shfl_xor_sync(kFull, g[q] & a[q], 1 << (J - 5));
      f[q] = dst ? v : 0u;
    }
  } else {
    constexpr int B = 1 << (J - 10);
#pragma unroll
    for (int q = 0; q < NR; ++q)
      f[q] = (q & B) ? (g[q & ~B] & a[q & ~B]) : 0u;
  }
  int changed = 0;
#pragma unroll
  for (int s = 0; s < SP; ++s) {
    if (s != d) continue;
#pragma unroll
    for (int q = 0; q < NR; ++q) {
      const uint32_t nv = T[s][q] | f[q];
      changed |= nv != T[s][q];
      T[s][q] = nv;
    }
  }
  return changed;
}

// One Gauss-Seidel sweep of slots J.. K-1 in order. With REGS the step's
// slot table is in registers: slot j's first destination row dk[j] with
// its column mask mk[j] (0: no transition), and its other destination rows
// rk[j] (rare: the model is deterministic), whose masks come from shared
// memory. Without, slot j's destination rows come from lane j's nz and
// every mask from the ring slot cms.
template <int J, int KMAX, bool REGS, int SP, int NR>
__device__ __forceinline__ int sweep_slots(uint32_t (&T)[SP][NR],
                                           const uint32_t (&a)[NR], int lane,
                                           int K, const uint32_t* cms,
                                           uint32_t nz,
                                           const int (&dk)[KMAX],
                                           const uint32_t (&mk)[KMAX],
                                           const uint32_t (&rk)[KMAX]) {
  if constexpr (J >= KMAX) {
    return 0;
  } else {
    if (J >= K) return 0;
    int changed = 0;
    uint32_t rest;
    if constexpr (REGS) {
      if (mk[J]) changed |= fire_slot<J>(T, a, lane, dk[J], mk[J]);
      rest = rk[J];
    } else {
      rest = __shfl_sync(kFull, nz, J);
    }
    for (uint32_t r = rest; r; r &= r - 1) {
      const int d = __ffs(r) - 1;
      changed |= fire_slot<J>(T, a, lane, d, cms[d * K + J]);
    }
    return changed |
           sweep_slots<J + 1, KMAX, REGS>(T, a, lane, K, cms, nz, dk, mk, rk);
  }
}

// Prune at t >= 10: registers q | B move down to q, and q | B empties.
template <int B, int SP, int NR>
__device__ __forceinline__ void prune_regs(uint32_t (&T)[SP][NR]) {
  if constexpr (B < NR) {
#pragma unroll
    for (int s = 0; s < SP; ++s)
#pragma unroll
      for (int q = 0; q < NR; ++q) {
        if (q & B) continue;
        T[s][q] = T[s][q | B];
        T[s][q | B] = 0u;
      }
  }
}

template <int SP, int NR, bool REGS,
          int KMAX = 10 + (NR > 1) + (NR > 2) + (NR > 4)>
__global__ void __launch_bounds__(kWarps * 32)
sweep_warp_kernel(const int* __restrict__ ln, const int* __restrict__ tg,
                  const uint32_t* __restrict__ cm, int* __restrict__ out,
                  uint32_t* Tio, int* meta, int B, int R, int S, int K,
                  int row0) {
  extern __shared__ uint32_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;  // no block barrier on this route
  const int W = 1 << (K - 5);
  const int SK = S * K;
  uint32_t* ring = smem + (size_t)warp * wgl3::kRing * (SK + 1);

  int dead = 0;
  int dead_step = -1;
  int maxf = 1;
  int offset = 0;
  // configs_explored accumulates as 32-bit two's complement and wraps
  // past 2^31, as the Pallas kernels' i32 accumulator does.
  unsigned int cfgs = 0u;
  uint32_t* Tb = Tio ? Tio + (size_t)b * S * W : nullptr;
  uint32_t T[SP][NR];
#pragma unroll
  for (int s = 0; s < SP; ++s)
#pragma unroll
    for (int q = 0; q < NR; ++q) {
      const int w = lane + 32 * q;
      T[s][q] = Tb ? (s < S && w < W ? Tb[s * W + w] : 0u)
                   : (s == row0 && w == 0 ? 1u : 0u);
    }
  if (Tb) {
    const int* m = meta + (size_t)b * 5;
    dead = m[0];
    dead_step = m[1];
    maxf = m[2];
    cfgs = (unsigned int)m[3];
    offset = m[4];
  }

  const int steps = ln[b];
  const int* tgb = tg + (size_t)b * R;
  const uint32_t* cmb = cm + (size_t)b * R * SK;
  const int live_steps = dead ? 0 : steps;
#pragma unroll
  for (int q = 0; q < wgl3::kRing; ++q) {
    if (q < live_steps)
      wgl3::stage_step(ring + q * (SK + 1), tgb, cmb, q, SK, lane, 32);
    wgl3::cp_async_commit();
  }

  for (int r = 0; r < live_steps; ++r) {
    wgl3::cp_async_wait<wgl3::kRing - 1>();
    __syncwarp();
    uint32_t* slot = ring + (r % wgl3::kRing) * (SK + 1);
    const int t = (int)slot[0];
    const uint32_t* cms = slot + 1;
    uint32_t a[NR];
#pragma unroll
    for (int q = 0; q < NR; ++q) a[q] = wgl3::allowed_word(lane + 32 * q, t);
    // The step's slot table, built by lane j for slot j (and, with REGS,
    // shuffled to every lane's registers once per step).
    const uint32_t nz = wgl3::slot_destinations(cms, S, K, lane);
    int dk[KMAX];
    uint32_t mk[KMAX], rk[KMAX];
    if constexpr (REGS) {
      const int d0 = nz ? __ffs(nz) - 1 : 0;
      const uint32_t m0 = nz ? cms[d0 * K + lane] : 0u;
      const uint32_t rest = nz & (nz - 1);
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        dk[j] = __shfl_sync(kFull, d0, j);
        mk[j] = __shfl_sync(kFull, m0, j);
        rk[j] = __shfl_sync(kFull, rest, j);
      }
    }
    while (__any_sync(kFull, sweep_slots<0, KMAX, REGS>(T, a, lane, K, cms,
                                                         nz, dk, mk, rk))) {
    }

    // Frontier size of the converged table (banked configs included).
    unsigned int c = 0u;
#pragma unroll
    for (int s = 0; s < SP; ++s)
#pragma unroll
      for (int q = 0; q < NR; ++q) c += __popc(T[s][q]);
    const int n = (int)__reduce_add_sync(kFull, c);
    maxf = n > maxf ? n : maxf;
    cfgs += (unsigned int)n;

    // Prune at t: keep the configs that fired t, bit t cleared.
    if (t < 5) {
      const int sh = 1 << t;
      const uint32_t lm = wgl3::lo_mask(t);
#pragma unroll
      for (int s = 0; s < SP; ++s)
#pragma unroll
        for (int q = 0; q < NR; ++q) T[s][q] = (T[s][q] >> sh) & lm;
    } else if (t < 10) {
      const int bit = 1 << (t - 5);
      const bool keep = (lane & bit) == 0;
#pragma unroll
      for (int s = 0; s < SP; ++s) {
        if (s >= S) break;
#pragma unroll
        for (int q = 0; q < NR; ++q) {
          const uint32_t v = __shfl_xor_sync(kFull, T[s][q], bit);
          T[s][q] = keep ? v : 0u;
        }
      }
    } else {
      switch (t - 10) {
        case 0: prune_regs<1>(T); break;
        case 1: prune_regs<2>(T); break;
        default: prune_regs<4>(T); break;
      }
    }
    uint32_t any = 0u;
#pragma unroll
    for (int s = 0; s < SP; ++s)
#pragma unroll
      for (int q = 0; q < NR; ++q) any |= T[s][q];
    // An empty table ends the search (and is all zero).
    if (!__any_sync(kFull, any != 0u)) {
      dead = 1;
      dead_step = offset + r;
      break;
    }
    __syncwarp();  // every lane is done with this slot before it refills
    if (r + wgl3::kRing < live_steps)
      wgl3::stage_step(slot, tgb, cmb, r + wgl3::kRing, SK, lane, 32);
    wgl3::cp_async_commit();
  }
  wgl3::cp_async_wait<0>();

  if (lane == 0) {
    if (out) {
      int* o = out + (size_t)b * 5;
      o[0] = dead ? 0 : 1;
      o[1] = 0;
      o[2] = dead_step;
      o[3] = maxf;
      o[4] = (int)cfgs;
    }
    if (Tb) {
      int* m = meta + (size_t)b * 5;
      m[0] = dead;
      m[1] = dead_step;
      m[2] = maxf;
      m[3] = (int)cfgs;
      m[4] = offset + steps;
    }
  }
  if (Tb) {
#pragma unroll
    for (int s = 0; s < SP; ++s)
#pragma unroll
      for (int q = 0; q < NR; ++q) {
        const int w = lane + 32 * q;
        if (s < S && w < W) Tb[s * W + w] = T[s][q];
      }
  }
}

// -- the shared-memory route -------------------------------------------------

__global__ void __launch_bounds__(1024, 1)
sweep_block_kernel(const int* __restrict__ ln, const int* __restrict__ tg,
                   const uint32_t* __restrict__ cm, int* __restrict__ out,
                   uint32_t* Tio, int* meta, int R, int S, int K, int row0) {
  extern __shared__ uint32_t smem[];
  __shared__ unsigned int count[2];  // per step parity, one add per warp
  const int W = 1 << (K - 5);
  const int SK = S * K;
  uint32_t* T = smem;           // [S][W]
  uint32_t* ring = smem + S * W;  // [kRing][SK + 1]
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;

  int dead = 0;
  int dead_step = -1;
  int maxf = 1;
  int offset = 0;
  unsigned int cfgs = 0u;  // wraps as an i32 accumulator
  uint32_t* Tb = Tio ? Tio + (size_t)b * S * W : nullptr;
  if (Tb) {
    const int* m = meta + (size_t)b * 5;
    dead = m[0];
    dead_step = m[1];
    maxf = m[2];
    cfgs = (unsigned int)m[3];
    offset = m[4];
    for (int i = tid; i < S * W; i += nt) T[i] = Tb[i];
  } else {
    for (int i = tid; i < S * W; i += nt)
      T[i] = i == row0 * W ? 1u : 0u;
  }
  if (tid == 0) count[0] = count[1] = 0u;

  const int steps = ln[b];
  const int* tgb = tg + (size_t)b * R;
  const uint32_t* cmb = cm + (size_t)b * R * SK;
  const int live_steps = dead ? 0 : steps;
  for (int q = 0; q < wgl3::kRing; ++q) {
    if (q < live_steps)
      wgl3::stage_step(ring + q * (SK + 1), tgb, cmb, q, SK, tid, nt);
    wgl3::cp_async_commit();
  }

  for (int r = 0; r < live_steps; ++r) {
    wgl3::cp_async_wait<wgl3::kRing - 1>();
    __syncthreads();  // step r's inputs (and the table) are in place
    uint32_t* slot = ring + (r % wgl3::kRing) * (SK + 1);
    const int t = (int)slot[0];
    const uint32_t* cms = slot + 1;
    const uint32_t nz = wgl3::slot_destinations(cms, S, K, lane);
    unsigned int c;
    while (__syncthreads_or(
        wgl3::dense_sweep_staged(T, cms, S, K, W, t, nz, c))) {
    }
    c = __reduce_add_sync(kFull, c);
    if (lane == 0) atomicAdd(&count[r & 1], c);
    const int alive = __syncthreads_or(wgl3::prune_table(T, S, W, t));
    if (tid == 0) {
      // Frontier size of the converged table (banked configs included).
      const int n = (int)count[r & 1];
      count[r & 1] = 0u;  // next added to two steps (and barriers) later
      maxf = n > maxf ? n : maxf;
      cfgs += (unsigned int)n;
    }
    if (!alive) {  // an empty table ends the search (and is all zero)
      dead = 1;
      dead_step = offset + r;
      break;
    }
    // The sweeps are done with this slot (the barrier above): refill it.
    if (r + wgl3::kRing < live_steps)
      wgl3::stage_step(slot, tgb, cmb, r + wgl3::kRing, SK, tid, nt);
    wgl3::cp_async_commit();
  }
  wgl3::cp_async_wait<0>();

  __syncthreads();
  if (tid == 0) {
    if (out) {
      int* o = out + (size_t)b * 5;
      o[0] = dead ? 0 : 1;
      o[1] = 0;
      o[2] = dead_step;
      o[3] = maxf;
      o[4] = (int)cfgs;
    }
    if (Tb) {
      int* m = meta + (size_t)b * 5;
      m[0] = dead;
      m[1] = dead_step;
      m[2] = maxf;
      m[3] = (int)cfgs;
      m[4] = offset + steps;
    }
  }
  if (Tb)
    for (int i = tid; i < S * W; i += nt) Tb[i] = T[i];
}

// -- the global tier: slices in shared memory, clusters over DSMEM ----------

constexpr int kGlobalMaxThreads = 1024;
constexpr int kGlobalMaxCluster = 16;           // non-portable on H100
constexpr int kGlobalSliceBytes = 128 * 1024;   // a block's slice, at most
constexpr long long kGlobalMinSliceBits = 1 << 17;  // and, if it can, at least
constexpr int kGlobalMaxBlocks = 64;  // one a SM in clusters of 16 on the H100

// barrier.cluster with release on arrival and acquire on wait: every
// thread of every block of the cluster arrives, and no thread passes
// before all did; shared-memory writes before it (local or remote) are
// seen after it.
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// OR of the source rows set in m of word column i of a slice with row
// stride `stride`: this block's slice, a cluster partner's (a pointer from
// map_shared_rank), or the table in device memory (through L2).
template <bool DEVICE>
__device__ __forceinline__ uint32_t gather_slice(const uint32_t* P,
                                                 int stride, int i,
                                                 uint32_t m) {
  uint32_t acc = 0u;
  while (m) {
    const int s = __ffs(m) - 1;
    m &= m - 1;
    acc |= DEVICE ? __ldcg(P + (size_t)s * stride + i)
                  : P[(size_t)s * stride + i];
  }
  return acc;
}

// Fires slot j into this block's word column `id` of the rows set in nz
// from the source column `is` of slice P (row stride `stride`), whose
// global word index is gs. j < 5 shifts inside the word (is == id).
// Only this block's slice is written, so a remote or device source is
// read and never written. Returns whether a word changed.
template <bool DEVICE>
__device__ __forceinline__ int fire_slice(uint32_t* Ts, const uint32_t* P,
                                          int stride, const uint32_t* cms,
                                          int K, int Wb, int is, int id,
                                          int gs, int j, int t, uint32_t nz) {
  uint32_t a = wgl3::allowed_word(gs, t);
  int sh = 0;
  if (j < 5) {
    a &= wgl3::lo_mask(j);
    sh = 1 << j;
  }
  if (!a) return 0;
  int changed = 0;
  while (nz) {
    const int d = __ffs(nz) - 1;
    nz &= nz - 1;
    const uint32_t fired =
        (gather_slice<DEVICE>(P, stride, is, cms[d * K + j]) & a) << sh;
    const uint32_t old = Ts[d * Wb + id];
    const uint32_t nv = old | fired;
    if (nv != old) {
      Ts[d * Wb + id] = nv;
      changed = 1;
    }
  }
  return changed;
}

// One window of one history over a table T uint32[S, W] in device memory,
// updated in place with meta int32[5] (the carry of the resume option).
//
// Block g of the G-block grid (clusters of C blocks, rank g % C) holds word
// columns [g * Wb, (g + 1) * Wb) of every row in shared memory for the
// whole window, Ts[S][Wb]; T is read at the start and written at the end.
// A slot j >= 5 pairs word w (bit j-5 clear) with w + 2^(j-5): inside a
// slice while 2^(j-5) < Wb (a local slot), between two blocks of one
// cluster while 2^(j-5) < Wb * C (a cluster slot), between two clusters
// past that (a grid slot; only with GRID, G > C).
//
// A step closes the table in passes. Pass p:
//   1. local fixpoint: the block sweeps its slice under slots 0..4 and the
//      local slots until a sweep changes nothing (__syncthreads_or), and
//      counts the slice in that last sweep;
//   2. with GRID: a cluster barrier, then each block whose rank has a
//      cluster slot's bit set pulls the slot's sources from its partner's
//      slice through distributed shared memory; the blocks that are a grid
//      slot's sources copy its source rows into T (st.cg);
//   3. the pass is published: whether the block changed a word since the
//      previous publication, and its count, are added to the cluster's
//      (without GRID: rank 0's shared memory, one cluster barrier) or the
//      grid's (flags in device memory, one grid barrier) three rotating
//      places, so none is cleared while a block still reads it;
//   4. if no block changed a word since the previous publication, and it
//      was not the step's first (whose pulls have not run), the step's
//      table is closed: every firing since then read a table that did not
//      change, so the count is the converged table's; so it is after the
//      first pass when no crossing slot fires this step. Otherwise the
//      pulls
//      that wait for this barrier run (without GRID the cluster slots;
//      with GRID the grid slots, read from T), and their changes are
//      published by the next pass.
// The closure is monotone and every firing only ORs in configs of its
// least fixpoint, so a pull that reads a partner's slice while the partner
// writes it is harmless; the pass that ends the closure wrote nothing.
// The prune moves a crossing slot's words to its partner: a cluster
// partner's slice through DSMEM, a grid partner's columns of T, read back
// after the step's barrier; the same barrier reduces the survival flag.
// Each pull writes the word columns this thread owns (w = tid, tid + nt,
// ...), the columns the next local sweep starts on, so no block barrier
// sits between them.
template <bool GRID>
__global__ void __launch_bounds__(kGlobalMaxThreads, 1)
sweep_global_kernel(const int* __restrict__ ln, const int* __restrict__ tg,
                    const uint32_t* __restrict__ cm, uint32_t* T, int* meta,
                    int* flags, int R, int S, int K) {
  cg::cluster_group cl = cg::this_cluster();
  extern __shared__ uint32_t smem[];
  __shared__ unsigned int cflag[3], ccount[3], calive[3];  // rank 0: cluster
  __shared__ unsigned int bcnt, bchg;
  const int W = 1 << (K - 5);
  const int SK = S * K;
  const int G = gridDim.x;
  const int Wb = W / G;
  const int C = (int)cl.num_blocks();
  const int rank = (int)cl.block_rank();
  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int w0 = g * Wb;
  uint32_t* Ts = smem;            // [S][Wb]
  uint32_t* ring = smem + S * Wb;  // [kRing][SK + 1]
  // Slots j < jc stay in the slice, j < jg in the cluster.
  const int jc = 5 + (31 - __clz(Wb));
  const int jg = jc + (31 - __clz(C));
  unsigned int* rflag = cl.map_shared_rank(cflag, 0);
  unsigned int* rcount = cl.map_shared_rank(ccount, 0);
  unsigned int* ralive = cl.map_shared_rank(calive, 0);
  int* gchg = flags;
  unsigned int* gcnt = (unsigned int*)flags + 3;
  int* galv = flags + 6;

  int dead = meta[0];
  int dead_step = meta[1];
  int maxf = meta[2];
  unsigned int cfgs = (unsigned int)meta[3];  // wraps as an i32 accumulator
  const int offset = meta[4];
  for (int i = tid; i < Wb; i += nt)
    for (int s = 0; s < S; ++s) Ts[s * Wb + i] = T[(size_t)s * W + w0 + i];
  if (tid < 3) cflag[tid] = ccount[tid] = calive[tid] = 0u;
  if (tid == 0) bcnt = bchg = 0u;

  const int steps = ln[0];
  const int live_steps = dead ? 0 : steps;
  for (int q = 0; q < wgl3::kRing; ++q) {
    if (q < live_steps)
      wgl3::stage_step(ring + q * (SK + 1), tg, cm, q, SK, tid, nt);
    wgl3::cp_async_commit();
  }
  cluster_barrier();  // rank 0's places are zero before any block adds

  int pass = 0;
  for (int r = 0; r < live_steps; ++r) {
    wgl3::cp_async_wait<wgl3::kRing - 1>();
    __syncthreads();  // step r's inputs are in place
    uint32_t* slot = ring + (r % wgl3::kRing) * (SK + 1);
    const int t = (int)slot[0];
    const uint32_t* cms = slot + 1;
    const uint32_t nz = wgl3::slot_destinations(cms, S, K, lane);
    uint32_t nzin[5];
#pragma unroll
    for (int j = 0; j < 5; ++j) nzin[j] = __shfl_sync(kFull, nz, j);
    // Whether a cluster slot or any crossing slot fires (grid-uniform),
    // and the rows that are a source of a grid slot this block feeds.
    int cluster_fires = 0, cross_fires = 0;
    for (int j = jc; j < K; ++j) {
      const int f = __shfl_sync(kFull, nz, j) != 0u;
      cross_fires |= f;
      if (j < jg) cluster_fires |= f;
    }
    uint32_t grid_rows = 0u;
    if (GRID)
      for (int j = jg; j < K; ++j) {
        const uint32_t nzj = __shfl_sync(kFull, nz, j);
        if (nzj && !((g >> (j - jc)) & 1))
          for (int d = 0; d < S; ++d)
            if ((nzj >> d) & 1u) grid_rows |= cms[d * K + j];
      }
    int pend = 0;  // this thread changed a word since the last publication
    unsigned int n = 0u;
    for (int step_pass = 0;; ++step_pass) {
      // 1. Local fixpoint; c is this thread's count of its columns at the
      // start of the last sweep, which changed nothing.
      int changed = 0;
      unsigned int c;
      while (true) {
        int ch = 0;
        c = 0u;
        for (int i = tid; i < Wb; i += nt) {
          for (int s = 0; s < S; ++s) c += __popc(Ts[s * Wb + i]);
#pragma unroll
          for (int j = 0; j < 5; ++j)
            if (nzin[j])
              ch |= fire_slice<false>(Ts, Ts, Wb, cms, K, Wb, i, i, w0 + i,
                                      j, t, nzin[j]);
        }
        for (int j = 5; j < jc && j < K; ++j) {
          const uint32_t nzj = __shfl_sync(kFull, nz, j);
          if (!nzj) continue;  // block-uniform: the masks are the block's
          __syncthreads();
          const int sh = j - 5;
          const int dlt = 1 << sh;
          for (int i = tid; i < (Wb >> 1); i += nt) {
            const int is = ((i >> sh) << (sh + 1)) | (i & (dlt - 1));
            ch |= fire_slice<false>(Ts, Ts, Wb, cms, K, Wb, is, is | dlt,
                                    w0 + is, j, t, nzj);
          }
        }
        if (!__syncthreads_or(ch)) break;
        changed = 1;
      }
      c = __reduce_add_sync(kFull, c);
      if (__any_sync(kFull, pend) && lane == 0) atomicOr(&bchg, 1u);
      if (lane == 0) atomicAdd(&bcnt, c);
      pend = 0;
      // 2. With GRID: cluster pulls after a cluster barrier, then the grid
      // slots' source rows go to T.
      if (GRID) {
        if (cluster_fires) {
          cluster_barrier();
          for (int j = jc; j < jg && j < K; ++j) {
            const uint32_t nzj = __shfl_sync(kFull, nz, j);
            const int bit = 1 << (j - jc);
            if (!nzj || !(rank & bit)) continue;
            const uint32_t* P = cl.map_shared_rank(Ts, rank ^ bit);
            const int dlt = 1 << (j - 5);
            for (int i = tid; i < Wb; i += nt)
              pend |= fire_slice<false>(Ts, P, Wb, cms, K, Wb, i, i,
                                        (w0 + i) ^ dlt, j, t, nzj);
          }
          if (__any_sync(kFull, pend) && lane == 0) atomicOr(&bchg, 1u);
          pend = 0;
        }
        for (uint32_t m = grid_rows; m; m &= m - 1) {
          const int s = __ffs(m) - 1;
          for (int i = tid; i < Wb; i += nt)
            __stcg(T + (size_t)s * W + w0 + i, Ts[s * Wb + i]);
        }
      }
      // 3. Publish.
      __syncthreads();  // bcnt and bchg are complete
      const int k = pass % 3;
      if (tid == 0) {
        // With no crossing slot firing, the closed slices are the closed
        // table; otherwise the step's first pass never ends it, since the
        // pulls it waits for have not run yet.
        const unsigned int any =
            cross_fires && (step_pass == 0 || changed || bchg);
        if (GRID) {
          if (any) atomicOr(gchg + k, 1);
          atomicAdd(gcnt + k, bcnt);
        } else {
          if (any) atomicOr(rflag + k, 1u);
          atomicAdd(rcount + k, bcnt);
        }
        bcnt = bchg = 0u;
      }
      int again;
      if (GRID) {
        cg::this_grid().sync();
        again = __ldcg(gchg + k);
        n = __ldcg(gcnt + k);
        if (g == 0 && tid == 0) {
          atomicExch(gchg + (pass + 2) % 3, 0);
          atomicExch(gcnt + (pass + 2) % 3, 0u);
        }
      } else {
        cluster_barrier();
        again = (int)*(volatile unsigned int*)(rflag + k);
        n = *(volatile unsigned int*)(rcount + k);
        if (rank == 0 && tid == 0) {
          cflag[(pass + 2) % 3] = 0u;
          ccount[(pass + 2) % 3] = 0u;
        }
      }
      ++pass;
      if (!again) break;
      // 4. The pulls this barrier waited for.
      const int j0 = GRID ? jg : jc;
      const int j1 = GRID ? K : (jg < K ? jg : K);
      for (int j = j0; j < j1; ++j) {
        const uint32_t nzj = __shfl_sync(kFull, nz, j);
        const int bit = 1 << (j - jc);  // of the block index (rank in C)
        if (!nzj || !(g & bit)) continue;
        const int dlt = 1 << (j - 5);
        if (GRID) {
          for (int i = tid; i < Wb; i += nt)
            pend |= fire_slice<true>(Ts, T, W, cms, K, Wb, (w0 + i) ^ dlt, i,
                                     (w0 + i) ^ dlt, j, t, nzj);
        } else {
          const uint32_t* P = cl.map_shared_rank(Ts, rank ^ bit);
          for (int i = tid; i < Wb; i += nt)
            pend |= fire_slice<false>(Ts, P, Wb, cms, K, Wb, i, i,
                                      (w0 + i) ^ dlt, j, t, nzj);
        }
      }
    }
    // Frontier size of the converged table (banked configs included).
    maxf = (int)n > maxf ? (int)n : maxf;
    cfgs += n;

    // Prune at t: keep the configs that fired t, bit t cleared; every word
    // is rewritten, so a table with no survivor is all zero.
    int alive = 0;
    const int dlt = t < 5 ? 0 : 1 << (t - 5);
    const int bit = t < jc ? 0 : 1 << (t - jc);
    if (t < 5) {
      const int sh = 1 << t;
      const uint32_t lo = wgl3::lo_mask(t);
      for (int i = tid; i < S * Wb; i += nt) {
        const uint32_t v = (Ts[i] >> sh) & lo;
        Ts[i] = v;
        alive |= v != 0u;
      }
    } else if (t < jc) {
      const int sh = t - 5;
      for (int i = tid; i < S * (Wb >> 1); i += nt) {
        const int s = i / (Wb >> 1);
        const int k = i - s * (Wb >> 1);
        const int is = ((k >> sh) << (sh + 1)) | (k & (dlt - 1));
        const uint32_t v = Ts[s * Wb + (is | dlt)];
        Ts[s * Wb + is] = v;
        Ts[s * Wb + (is | dlt)] = 0u;
        alive |= v != 0u;
      }
    } else if (g & bit) {
      // This block holds the configs with bit t set: they move to the
      // partner's slice (its own words are all overwritten), this one
      // empties.
      uint32_t* P = t < jg ? cl.map_shared_rank(Ts, rank ^ bit) : nullptr;
      for (int i = tid; i < Wb; i += nt)
        for (int s = 0; s < S; ++s) {
          const uint32_t v = Ts[s * Wb + i];
          if (P)
            P[s * Wb + i] = v;
          else
            __stcg(T + (size_t)s * W + ((w0 + i) ^ dlt), v);
          Ts[s * Wb + i] = 0u;
          alive |= v != 0u;
        }
    }
    alive = __syncthreads_or(alive);
    const int k = r % 3;
    int survived;
    if (GRID) {
      if (tid == 0 && alive) atomicOr(galv + k, 1);
      // DSMEM pushes are seen after the cluster barrier, the device
      // memory ones after the grid barrier.
      asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
      cg::this_grid().sync();
      asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
      survived = __ldcg(galv + k);
      if (g == 0 && tid == 0) atomicExch(galv + (r + 2) % 3, 0);
      if (t >= jg && !(g & bit))  // the grid partner wrote this slice
        for (int i = tid; i < Wb; i += nt)
          for (int s = 0; s < S; ++s)
            Ts[s * Wb + i] = __ldcg(T + (size_t)s * W + w0 + i);
    } else {
      if (tid == 0 && alive) atomicOr(ralive + k, 1u);
      cluster_barrier();
      survived = (int)*(volatile unsigned int*)(ralive + k);
      if (rank == 0 && tid == 0) calive[(r + 2) % 3] = 0u;
    }
    if (!survived) {  // an empty table ends the search
      dead = 1;
      dead_step = offset + r;
      break;
    }
    __syncthreads();  // the block is done with this ring slot: refill it
    if (r + wgl3::kRing < live_steps)
      wgl3::stage_step(slot, tg, cm, r + wgl3::kRing, SK, tid, nt);
    wgl3::cp_async_commit();
  }
  wgl3::cp_async_wait<0>();
  // Every block has read meta and T, and no block reads another's slice
  // any more.
  if (GRID) cg::this_grid().sync();
  cluster_barrier();
  for (int i = tid; i < Wb; i += nt)
    for (int s = 0; s < S; ++s) T[(size_t)s * W + w0 + i] = Ts[s * Wb + i];
  if (g == 0 && tid == 0) {
    meta[0] = dead;
    meta[1] = dead_step;
    meta[2] = maxf;
    meta[3] = (int)cfgs;
    meta[4] = offset + steps;
  }
}

size_t global_smem(int S, int K, int G) {
  const int Wb = (1 << (K - 5)) / G;
  return (size_t)(S * Wb + wgl3::kRing * (S * K + 1)) * sizeof(uint32_t);
}

// Clusters of C blocks of the global tier's kernel for G blocks that the
// card holds at once (cudaOccupancyMaxActiveClusters).
cudaError_t resident_clusters(int S, int K, int G, int C, int* clusters) {
  const void* fn = G > C ? (const void*)sweep_global_kernel<true>
                         : (const void*)sweep_global_kernel<false>;
  const size_t smem = global_smem(S, K, G);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  const int Wb = (1 << (K - 5)) / G;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(Wb < kGlobalMaxThreads ? Wb : kGlobalMaxThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(clusters, fn, &cfg);
}

// The global tier's geometry for (S, K): G blocks, clusters of C. A step's
// time follows the integer work of its sweeps on each SM more than its
// barriers, so G is as large as the card holds in clusters of
// kGlobalMaxCluster, up to kGlobalMaxBlocks, down to slices of
// kGlobalMinSliceBits (one cluster for a table of 2^21 bits) and up to
// slices of kGlobalSliceBytes. C is the largest power of two up to
// kGlobalMaxCluster and G of which G / C clusters are resident at once.
// G > C needs a grid barrier, so then the launch is cooperative.
// tests/test_torch_general.py global_geometry is the same rule in Python.
cudaError_t global_geometry(int S, int K, int* blocks, int* cluster) {
  const long long bits = (long long)S << K;
  int lo = (int)(bits / 8 / kGlobalSliceBytes);
  if (lo < kGlobalMaxCluster) lo = kGlobalMaxCluster;
  int G = (int)(bits / kGlobalMinSliceBits);
  if (G > kGlobalMaxBlocks) G = kGlobalMaxBlocks;
  if (G < lo) G = lo;
  cudaError_t e = cudaSuccess;
  for (; G > lo; G >>= 1) {  // the most blocks clusters of 16 hold
    int clusters = 0;
    e = resident_clusters(S, K, G, kGlobalMaxCluster, &clusters);
    if (e != cudaSuccess) return e;
    if ((long long)clusters * kGlobalMaxCluster >= G) break;
  }
  *blocks = G;
  *cluster = 0;
  for (int C = G < kGlobalMaxCluster ? G : kGlobalMaxCluster; C >= 1;
       C >>= 1) {
    int clusters = 0;
    e = resident_clusters(S, K, G, C, &clusters);
    if (e != cudaSuccess) return e;
    if ((long long)clusters * C >= G) {
      *cluster = C;
      return cudaSuccess;
    }
  }
  return cudaSuccess;  // *cluster == 0: the card cannot hold the grid
}

int launch_global(const void* ln, const void* tg, const void* cm, void* T,
                  void* meta, void* flags, int R, int S, int K,
                  cudaStream_t st) {
  if (S < 1 || S > 32 || K < 11 || K > 31 || !T || !meta || !flags)
    return (int)cudaErrorInvalidValue;
  int G = 0, C = 0;
  cudaError_t e = global_geometry(S, K, &G, &C);
  if (e != cudaSuccess) return (int)e;
  const int Wb = (1 << (K - 5)) / G;
  if (C < 1 || (size_t)S * Wb * 4 > (size_t)kGlobalSliceBytes)
    return (int)cudaErrorInvalidConfiguration;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.gridDim = dim3(G);
  cfg.blockDim = dim3(Wb < kGlobalMaxThreads ? Wb : kGlobalMaxThreads);
  cfg.dynamicSmemBytes = global_smem(S, K, G);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = G > C ? 2 : 1;
  const int* lnp = (const int*)ln;
  const int* tgp = (const int*)tg;
  const uint32_t* cmp = (const uint32_t*)cm;
  uint32_t* Tp = (uint32_t*)T;
  int* mp = (int*)meta;
  int* fp = (int*)flags;
  e = G > C ? cudaLaunchKernelEx(&cfg, sweep_global_kernel<true>, lnp, tgp,
                                 cmp, Tp, mp, fp, R, S, K)
            : cudaLaunchKernelEx(&cfg, sweep_global_kernel<false>, lnp, tgp,
                                 cmp, Tp, mp, fp, R, S, K);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// -- launch geometry ---------------------------------------------------------

int padded_states(int S) {
  int p = 4;
  while (p < S) p <<= 1;
  return p;
}

int regs_per_row(int K) {
  const int W = 1 << (K - 5);
  return W < 32 ? 1 : W / 32;
}

// 1: the register route takes (S, K); 0: the shared-memory route.
int register_route(int S, int K) {
  return padded_states(S) * regs_per_row(K) <= 32;
}

// Where the register route keeps a step's slot table: true registers,
// false the ring slot. slot_table 1 or 2 forces registers or the ring; 0
// takes the rule. Registers shorten each sweep's dependent chain, which
// sets the time of a launch with fewer histories than the card has SMs
// (a warp alone on its SM); the ring saves each step's 3 * KMAX
// shuffles, which cost issue slots once the SMs are shared by many
// histories. On an H100 (700 W) registers ran 6-8% faster for one long
// history at K=10 and K=12, the ring 11% faster for 1,024 short ones.
cudaError_t slot_table_in_registers(int B, int slot_table, bool* regs) {
  if (slot_table != 0) {
    *regs = slot_table == 1;
    return cudaSuccess;
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *regs = B < sms;
  return e;
}

template <int SP, int NR, bool REGS>
cudaError_t launch_warp(const void* ln, const void* tg, const void* cm,
                        void* out, void* Tio, void* meta, int B, int R, int S,
                        int K, int row0, cudaStream_t stream) {
  const int warps = B < kWarps ? B : kWarps;
  const size_t smem =
      (size_t)warps * wgl3::kRing * (S * K + 1) * sizeof(uint32_t);
  cudaError_t e = cudaFuncSetAttribute(
      sweep_warp_kernel<SP, NR, REGS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  sweep_warp_kernel<SP, NR, REGS>
      <<<(B + kWarps - 1) / kWarps, warps * 32, smem, stream>>>(
          (const int*)ln, (const int*)tg, (const uint32_t*)cm, (int*)out,
          (uint32_t*)Tio, (int*)meta, B, R, S, K, row0);
  return cudaSuccess;
}

int launch(const void* ln, const void* tg, const void* cm, void* out,
           void* Tio, void* meta, int B, int R, int S, int K, int row0,
           int slot_table, cudaStream_t st) {
  if ((Tio == nullptr) != (meta == nullptr) || S < 1 || S > 32 || K < 5 ||
      slot_table < 0 || slot_table > 2)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaGetLastError();
  cudaError_t e = cudaSuccess;
  if (register_route(S, K)) {
    bool regs = true;
    e = slot_table_in_registers(B, slot_table, &regs);
    if (e != cudaSuccess) return (int)e;
    const int key = (padded_states(S) * 100 + regs_per_row(K)) * 2 + regs;
#define WGL3_WARP(SP, NR, REGS)                                               \
  case (SP * 100 + NR) * 2 + REGS:                                            \
    e = launch_warp<SP, NR, REGS>(ln, tg, cm, out, Tio, meta, B, R, S, K,     \
                                  row0, st);                                  \
    break;
#define WGL3_WARP2(SP, NR) WGL3_WARP(SP, NR, true) WGL3_WARP(SP, NR, false)
    switch (key) {
      WGL3_WARP2(4, 1)
      WGL3_WARP2(8, 1)
      WGL3_WARP2(16, 1)
      WGL3_WARP2(32, 1)
      WGL3_WARP2(4, 2)
      WGL3_WARP2(8, 2)
      WGL3_WARP2(16, 2)
      WGL3_WARP2(4, 4)
      WGL3_WARP2(8, 4)
      WGL3_WARP2(4, 8)
      default: return (int)cudaErrorInvalidValue;
    }
#undef WGL3_WARP2
#undef WGL3_WARP
  } else {
    const int W = 1 << (K - 5);
    const size_t smem =
        (size_t)(S * W + wgl3::kRing * (S * K + 1)) * sizeof(uint32_t);
    e = cudaFuncSetAttribute(sweep_block_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e == cudaSuccess) {
      const int threads = W < 32 ? 32 : (W > 1024 ? 1024 : W);
      sweep_block_kernel<<<B, threads, smem, st>>>(
          (const int*)ln, (const int*)tg, (const uint32_t*)cm, (int*)out,
          (uint32_t*)Tio, (int*)meta, R, S, K, row0);
    }
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 = launched). Tio and
// meta are both null (fresh start) or both set (resume, in place).
int wgl3_sweep_launch(const void* ln, const void* tg, const void* cm,
                      void* out, void* Tio, void* meta, int B, int R, int S,
                      int K, int row0, void* stream) {
  return launch(ln, tg, cm, out, Tio, meta, B, R, S, K, row0, 0,
                (cudaStream_t)stream);
}

// wgl3_sweep_launch with the register route's slot table forced: 1 in
// registers, 2 read from the ring slot (0: the launcher's rule). The
// shared-memory route ignores it.
int wgl3_sweep_launch_slot_table(const void* ln, const void* tg,
                                 const void* cm, void* out, void* Tio,
                                 void* meta, int B, int R, int S, int K,
                                 int row0, int slot_table, void* stream) {
  return launch(ln, tg, cm, out, Tio, meta, B, R, S, K, row0, slot_table,
                (cudaStream_t)stream);
}

// One window of one history through the global tier, in place: T
// uint32[S, 2^(K-5)] and meta int32[5] in device memory, flags int32[9]
// zeroed by the caller, ln int32[1], tg int32[R], cm uint32[R, S, K], in
// global_geometry's blocks and clusters. Returns cudaGetLastError() after
// the launch (0 = launched).
int wgl3_sweep_global_launch(const void* ln, const void* tg, const void* cm,
                             void* T, void* meta, void* flags, int R, int S,
                             int K, void* stream) {
  return launch_global(ln, tg, cm, T, meta, flags, R, S, K,
                       (cudaStream_t)stream);
}

// The global tier's geometry for (S, K) on this card: out[0] blocks,
// out[1] cluster size (0 when the card cannot hold the grid). Returns the
// CUDA error code (0 = queried).
int wgl3_sweep_global_geometry(int S, int K, int* out) {
  return (int)global_geometry(S, K, out, out + 1);
}

// 1 when (S, K) takes the register route, 0 for the shared-memory route.
int wgl3_sweep_register_route(int S, int K) { return register_route(S, K); }

const char* wgl3_sweep_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
