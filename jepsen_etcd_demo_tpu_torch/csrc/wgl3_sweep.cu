// Dense subset-lattice WGL sweep for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   jepsen_etcd_demo_tpu/ops/wgl3_pallas.py  _kernel_body          (one
//     history per program) and
//   jepsen_etcd_demo_tpu/ops/wgl3_pallas.py  _kernel_body_grouped  (G
//     histories per program in lockstep).
// Both compute the same function per history, and so does this kernel: it
// runs a history's whole return-step scan with the reachability table held
// on chip, and writes the five PACKED_FIELDS of the result.
//
// Layout (ops/wgl3_kernels.py prepares it):
//   ln  int32[B]          real (non-pad) return steps of each history
//   tg  int32[B, R]       target slot of each return step; -1 = pad (suffix)
//   cm  uint32[B, R, S, K] column masks: bit s of cm[b, r, s', j] says that
//                         firing slot j moves state row s to row s'
//   out int32[B, 5]       survived, overflow (always 0), dead_step,
//                         max_frontier, configs_explored
// The table is uint32[S][W], W = 2^(K-5): bit p of word w is the config
// whose linearized mask is w*32 + p.
//
// Design. One thread block per history; grid = B. The table lives in
// shared memory for the whole scan: dense_config admits at most 2^20
// cells, so a table is at most 128 KiB and fits one block (above 48 KB
// the launcher raises the dynamic shared-memory limit). Each step loads
// its S*K column masks into shared memory, then runs Gauss-Seidel sweeps
// over the K slots until a __syncthreads_or finds that no word changed,
// counts the converged table with __popc and a block reduction, prunes at
// the target slot, and stops the scan at the first empty table.
//   * Firing slot j < 5 stays inside a word (shift by 2^j): a thread owns
//     a word column w for all S rows, so nothing races.
//   * Firing slot j >= 5 moves configs from word w (bit j-5 clear) to word
//     w + 2^(j-5): source and destination columns are disjoint, so a
//     thread owns one such pair and ORs in place.
//   * With the banking mask fixed, the closure is a monotone operator and
//     has one least fixpoint above the step's starting table. Any order of
//     firings that runs until nothing changes reaches it, so the counts
//     equal the XLA and Pallas kernels' exactly.
//   * A column mask usually has one or two bits set (the model is
//     deterministic), so a thread iterates only the set bits; the masks are
//     block-uniform, so the loop does not diverge.
//
// What bounds it on this card. Every step is a chain of dependent sweeps,
// each ending in a barrier, over a table of a few KB: the sweep is bound
// by shared-memory bandwidth, integer issue and barrier latency, not by
// device memory (a history's inputs are read once). A lone history runs
// on one SM; a corpus of B histories fills the 132 SMs with B blocks. This
// first design keeps every step's work inside one block and does not yet
// split a lone history's table across SMs or prefetch the next step's
// masks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

__global__ void wgl3_sweep_kernel(const int* __restrict__ ln,
                                  const int* __restrict__ tg,
                                  const uint32_t* __restrict__ cm,
                                  int* __restrict__ out, int R, int S, int K,
                                  int row0) {
  extern __shared__ uint32_t smem[];
  __shared__ unsigned int red[32];
  const int W = 1 << (K - 5);
  const int half = W >> 1;
  uint32_t* T = smem;            // [S][W]
  uint32_t* cms = smem + S * W;  // [S][K] column masks of the current step
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = (nt + 31) >> 5;

  for (int i = tid; i < S * W; i += nt) T[i] = 0u;
  __syncthreads();
  if (tid == 0) T[row0 * W] = 1u;

  const int steps = ln[b];
  const int* tgb = tg + (size_t)b * R;
  const uint32_t* cmb = cm + (size_t)b * R * S * K;
  int dead_step = -1;
  int maxf = 1;
  // configs_explored accumulates as 32-bit two's complement and wraps
  // past 2^31, as the Pallas kernels' i32 accumulator does.
  unsigned int cfgs = 0u;

  for (int r = 0; r < steps; ++r) {
    const int t = tgb[r];
    __syncthreads();  // the previous step is done with cms and T
    for (int i = tid; i < S * K; i += nt) cms[i] = cmb[(size_t)r * S * K + i];
    __syncthreads();

    // Closure: sweeps over the K slots until one changes nothing.
    for (;;) {
      int changed = 0;
      for (int j = 0; j < K; ++j) {
        if (j < 5) {
          const uint32_t lo = lo_mask(j);
          const int sh = 1 << j;
          for (int w = tid; w < W; w += nt) {
            const uint32_t a = allowed_word(w, t) & lo;
            if (!a) continue;
            for (int d = 0; d < S; ++d) {
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
          }
        } else {
          const int sh = j - 5;
          const int dlt = 1 << sh;
          for (int i = tid; i < half; i += nt) {
            const int ws = ((i >> sh) << (sh + 1)) | (i & (dlt - 1));
            const uint32_t a = allowed_word(ws, t);
            if (!a) continue;
            for (int d = 0; d < S; ++d) {
              const uint32_t m = cms[d * K + j];
              if (!m) continue;
              const uint32_t fired = gather_sources(T, W, ws, m) & a;
              const uint32_t old = T[d * W + (ws | dlt)];
              const uint32_t nv = old | fired;
              if (nv != old) {
                T[d * W + (ws | dlt)] = nv;
                changed = 1;
              }
            }
          }
        }
        __syncthreads();
      }
      if (!__syncthreads_or(changed)) break;
    }

    // Frontier size of the converged table (banked configs included).
    unsigned int cnt = 0;
    for (int i = tid; i < S * W; i += nt) cnt += __popc(T[i]);
    for (int o = 16; o > 0; o >>= 1) cnt += __shfl_down_sync(0xFFFFFFFFu, cnt, o);
    if (lane == 0) red[warp] = cnt;
    __syncthreads();
    if (warp == 0) {
      unsigned int v = lane < nwarps ? red[lane] : 0u;
      for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, o);
      if (lane == 0) red[0] = v;
    }
    __syncthreads();
    const int n = (int)red[0];
    maxf = n > maxf ? n : maxf;
    cfgs += (unsigned int)n;

    // Prune at t: keep configs that fired t, re-addressed with bit t clear.
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
    if (!__syncthreads_or(alive)) {
      dead_step = r;
      break;
    }
  }

  if (tid == 0) {
    int* o = out + (size_t)b * 5;
    o[0] = dead_step < 0 ? 1 : 0;
    o[1] = 0;
    o[2] = dead_step;
    o[3] = maxf;
    o[4] = (int)cfgs;
  }
}

// Threads per block: one per word column, at least a warp, at most 256.
int sweep_threads(int K) {
  const int W = 1 << (K - 5);
  return W < 32 ? 32 : (W > 256 ? 256 : W);
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
int wgl3_sweep_launch(const void* ln, const void* tg, const void* cm,
                      void* out, int B, int R, int S, int K, int row0,
                      void* stream) {
  const int W = 1 << (K - 5);
  const size_t smem = (size_t)(S * W + S * K) * sizeof(uint32_t);
  cudaError_t e = cudaFuncSetAttribute(
      wgl3_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (B > 0) {
    wgl3_sweep_kernel<<<B, sweep_threads(K), smem,
                        (cudaStream_t)stream>>>(
        (const int*)ln, (const int*)tg, (const uint32_t*)cm, (int*)out, R, S,
        K, row0);
  }
  return (int)cudaGetLastError();
}

const char* wgl3_sweep_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
