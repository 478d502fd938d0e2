// Sparse work-list WGL sweep for Hopper (sm_90a): one resumable window of
// a long history's scan, each closure round sweeping only the live
// 128-word blocks of the table.
//
// Replaces the Pallas TPU kernel _kernel_body_sparse_resumable of
// jepsen_etcd_demo_tpu/ops/wgl3_pallas.py, and computes the same function
// round for round, so its telemetry matches as well as its verdict.
//
// Layout (ops/wgl3_kernels.py prepares it; as wgl3_sweep.cu with a carry):
//   ln   int32[B]           real return steps of each history's window
//   tg   int32[B, R]        target slot of each return step; -1 = pad
//   cm   uint32[B, R, S, K] column masks
//   Tio  uint32[B, S, W]    carried table, updated in place
//   meta int32[B, 8]        [dead, dead_step, max_frontier,
//                           configs_explored, offset, live_sum,
//                           sparse_steps, real_steps], updated in place
// W = 2^(K-5) >= 256 words, so the table spans nb = W / 128 >= 2 blocks;
// mask bits 0..11 address configs inside a block, bits 12.. the block.
//
// Design. One thread block per history, table and step masks in shared
// memory (at most 2^20 bits, 128 KiB). Each closure round
//   1. probes the blocks: one warp per block ORs its S x 128 words and
//      __any_sync says whether the block holds a config;
//   2. with at most thresh live blocks, sweeps only those, in the order a
//      sequential pass over the ascending work list would: block bi
//      receives what its lower neighbours bi - 2^b fired for slot 12 + b,
//      closes under slots 0..11 in slot order, and what it then holds is
//      what it fires into bi + 2^b. The sources of a block have one bit
//      fewer set, so the blocks of one bit count run together, one warp
//      each (__syncwarp between slots), one level per bit count with a
//      barrier between levels. A block outside the work list receives
//      but does not expand;
//   3. otherwise runs one dense Gauss-Seidel sweep of all K slots.
// Rounds stop when one changes nothing or after `rounds` (= K) rounds,
// which always reach the fixpoint. After the fixpoint the live blocks are
// counted again (live_sum); a step counts as sparse when every round was.
//
// What bounds it on this card: barrier and shared-memory latency of a
// chain of dependent rounds on one SM, as for the dense sweep; a sparse
// round pays one barrier per level instead of one per slot, and touches
// only the live blocks' words.

#include "wgl3_table.cuh"

namespace {

constexpr int kBlockWords = 128;
constexpr int kBlockSlots = 12;   // slots j < 12 stay inside a block
constexpr int kMaxBlocks = 64;

// live[bi] = block bi holds a config; returns the live count (all threads).
__device__ int probe_blocks(const uint32_t* T, int S, int W, int nb,
                            int* live) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int bi = warp; bi < nb; bi += nwarps) {
    uint32_t acc = 0u;
    for (int s = 0; s < S; ++s) {
      const uint32_t* row = T + s * W + bi * kBlockWords;
      acc |= row[lane] | row[lane + 32] | row[lane + 64] | row[lane + 96];
    }
    const int any = __any_sync(0xFFFFFFFFu, acc != 0u);
    if (lane == 0) live[bi] = any;
  }
  __syncthreads();
  int cnt = 0;
  for (int bi = 0; bi < nb; ++bi) cnt += live[bi];
  return cnt;
}

// Block bi's closure under slots 0..11 in slot order, by one warp.
__device__ int close_block(uint32_t* T, const uint32_t* cms, int S, int K,
                           int W, int bi, int t, int lane) {
  int changed = 0;
  const int base = bi * kBlockWords;
  const int k_in = K < kBlockSlots ? K : kBlockSlots;
  for (int j = 0; j < k_in; ++j) {
    if (j < 5) {
      for (int k = 0; k < 4; ++k)
        changed |= wgl3::fire_in_word(T, cms, S, K, W, base + lane + 32 * k,
                                      j, t);
    } else {
      const int sh = j - 5;
      const int dlt = 1 << sh;
      for (int k = 0; k < 2; ++k) {
        const int i = lane + 32 * k;
        const int ws = base + (((i >> sh) << (sh + 1)) | (i & (dlt - 1)));
        changed |= wgl3::fire_across(T, cms, S, K, W, ws, ws | dlt, j, t);
      }
    }
    __syncwarp();
  }
  return changed;
}

// One sparse round over the live blocks (see the design note above).
__device__ int sparse_round(uint32_t* T, const uint32_t* cms, const int* live,
                            int S, int K, int W, int nb, int t) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int bits = __ffs(nb) - 1;
  int changed = 0;
  for (int level = 0; level <= bits; ++level) {
    int q = 0;
    for (int bi = 0; bi < nb; ++bi) {
      if (__popc(bi) != level) continue;
      if ((q++ % nwarps) != warp) continue;
      for (int bb = 0; bb < bits; ++bb) {
        const int p = bi ^ (1 << bb);
        if (!((bi >> bb) & 1) || !live[p]) continue;
        for (int k = 0; k < 4; ++k) {
          const int w = lane + 32 * k;
          changed |= wgl3::fire_across(T, cms, S, K, W, p * kBlockWords + w,
                                       bi * kBlockWords + w, kBlockSlots + bb,
                                       t);
        }
      }
      __syncwarp();
      if (live[bi]) changed |= close_block(T, cms, S, K, W, bi, t, lane);
    }
    __syncthreads();
  }
  return changed;
}

__global__ void wgl3_sparse_kernel(const int* __restrict__ ln,
                                   const int* __restrict__ tg,
                                   const uint32_t* __restrict__ cm,
                                   uint32_t* Tio, int* meta, int R, int S,
                                   int K, int rounds, int thresh) {
  extern __shared__ uint32_t smem[];
  __shared__ unsigned int red[32];
  __shared__ int live[kMaxBlocks];
  const int W = 1 << (K - 5);
  const int nb = W / kBlockWords;
  uint32_t* T = smem;            // [S][W]
  uint32_t* cms = smem + S * W;  // [S][K]
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  uint32_t* Tb = Tio + (size_t)b * S * W;
  int* m = meta + (size_t)b * 8;
  int dead = m[0];
  int dead_step = m[1];
  int maxf = m[2];
  unsigned int cfgs = (unsigned int)m[3];  // wraps as an i32 accumulator
  const int offset = m[4];
  int live_sum = m[5];
  int sparse_steps = m[6];
  int real_steps = m[7];
  for (int i = tid; i < S * W; i += nt) T[i] = Tb[i];

  const int steps = ln[b];
  const int* tgb = tg + (size_t)b * R;
  const uint32_t* cmb = cm + (size_t)b * R * S * K;
  int r = 0;
  for (; r < steps && !dead; ++r) {
    const int t = tgb[r];
    wgl3::load_step_masks(cms, cmb, r, S, K);
    int n_rounds = 0;
    int sparse_rounds = 0;
    int changed = 1;
    while (changed && n_rounds < rounds) {
      const int take = probe_blocks(T, S, W, nb, live) <= thresh;
      const int ch = take ? sparse_round(T, cms, live, S, K, W, nb, t)
                          : wgl3::dense_sweep(T, cms, S, K, W, t);
      changed = __syncthreads_or(ch);
      ++n_rounds;
      sparse_rounds += take;
    }
    const int n = (int)wgl3::count_table(T, S * W, red);
    live_sum += probe_blocks(T, S, W, nb, live);
    sparse_steps += sparse_rounds == n_rounds;
    ++real_steps;
    maxf = n > maxf ? n : maxf;
    cfgs += (unsigned int)n;
    if (!__syncthreads_or(wgl3::prune_table(T, S, W, t))) {
      dead = 1;
      dead_step = offset + r;
    }
  }
  // The steps of a dead table: each is one empty round, and sparse.
  sparse_steps += steps - r;
  real_steps += steps - r;

  __syncthreads();
  if (tid == 0) {
    m[0] = dead;
    m[1] = dead_step;
    m[2] = maxf;
    m[3] = (int)cfgs;
    m[4] = offset + steps;
    m[5] = live_sum;
    m[6] = sparse_steps;
    m[7] = real_steps;
  }
  for (int i = tid; i < S * W; i += nt) Tb[i] = T[i];
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a table of fewer than 2 or more than 64
// blocks.
int wgl3_sparse_launch(const void* ln, const void* tg, const void* cm,
                       void* Tio, void* meta, int B, int R, int S, int K,
                       int rounds, int thresh, void* stream) {
  const int W = 1 << (K - 5);
  const int nb = W / kBlockWords;
  if (nb < 2 || nb > kMaxBlocks) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(S * W + S * K) * sizeof(uint32_t);
  cudaError_t e = cudaFuncSetAttribute(
      wgl3_sparse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (B > 0) {
    wgl3_sparse_kernel<<<B, 256, smem, (cudaStream_t)stream>>>(
        (const int*)ln, (const int*)tg, (const uint32_t*)cm, (uint32_t*)Tio,
        (int*)meta, R, S, K, rounds, thresh);
  }
  return (int)cudaGetLastError();
}

const char* wgl3_sparse_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
