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
// table held on chip.
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
// With a carry the block loads Tio and meta, runs its ln steps with
// dead_step = offset + r, and writes the table and the next meta (offset
// advanced by ln) back in place: block b alone touches history b's carry.
// A window that starts dead only advances the offset.
//
// Design. One thread block per history; grid = B. The table lives in
// shared memory for the whole scan: dense_config admits at most 2^20
// cells, so a table is at most 128 KiB and fits one block (above 48 KB
// the launcher raises the dynamic shared-memory limit). Each step loads
// its S*K column masks into shared memory, then runs Gauss-Seidel sweeps
// over the K slots until a __syncthreads_or finds that no word changed,
// counts the converged table with __popc and a block reduction, prunes at
// the target slot, and stops the scan at the first empty table. The table
// algebra is in wgl3_table.cuh.
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
// masks; a long history's windows run one after another on one SM.

#include "wgl3_table.cuh"

namespace {

__global__ void wgl3_sweep_kernel(const int* __restrict__ ln,
                                  const int* __restrict__ tg,
                                  const uint32_t* __restrict__ cm,
                                  int* __restrict__ out, uint32_t* Tio,
                                  int* meta, int R, int S, int K, int row0) {
  extern __shared__ uint32_t smem[];
  __shared__ unsigned int red[32];
  const int W = 1 << (K - 5);
  uint32_t* T = smem;            // [S][W]
  uint32_t* cms = smem + S * W;  // [S][K] column masks of the current step
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  int dead = 0;
  int dead_step = -1;
  int maxf = 1;
  int offset = 0;
  // configs_explored accumulates as 32-bit two's complement and wraps
  // past 2^31, as the Pallas kernels' i32 accumulator does.
  unsigned int cfgs = 0u;
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
    for (int i = tid; i < S * W; i += nt) T[i] = 0u;
    __syncthreads();
    if (tid == 0) T[row0 * W] = 1u;
  }

  const int steps = ln[b];
  const int* tgb = tg + (size_t)b * R;
  const uint32_t* cmb = cm + (size_t)b * R * S * K;

  for (int r = 0; r < steps && !dead; ++r) {
    const int t = tgb[r];
    wgl3::load_step_masks(cms, cmb, r, S, K);
    while (__syncthreads_or(wgl3::dense_sweep(T, cms, S, K, W, t))) {
    }
    // Frontier size of the converged table (banked configs included).
    const int n = (int)wgl3::count_table(T, S * W, red);
    maxf = n > maxf ? n : maxf;
    cfgs += (unsigned int)n;
    // Prune at t; an empty table ends the search (and is all zero).
    if (!__syncthreads_or(wgl3::prune_table(T, S, W, t))) {
      dead = 1;
      dead_step = offset + r;
    }
  }

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

// Threads per block: one per word column, at least a warp, at most 256.
int sweep_threads(int K) {
  const int W = 1 << (K - 5);
  return W < 32 ? 32 : (W > 256 ? 256 : W);
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 = launched). Tio and
// meta are both null (fresh start) or both set (resume, in place).
int wgl3_sweep_launch(const void* ln, const void* tg, const void* cm,
                      void* out, void* Tio, void* meta, int B, int R, int S,
                      int K, int row0, void* stream) {
  if ((Tio == nullptr) != (meta == nullptr))
    return (int)cudaErrorInvalidValue;
  const int W = 1 << (K - 5);
  const size_t smem = (size_t)(S * W + S * K) * sizeof(uint32_t);
  cudaError_t e = cudaFuncSetAttribute(
      wgl3_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (B > 0) {
    wgl3_sweep_kernel<<<B, sweep_threads(K), smem,
                        (cudaStream_t)stream>>>(
        (const int*)ln, (const int*)tg, (const uint32_t*)cm, (int*)out,
        (uint32_t*)Tio, (int*)meta, R, S, K, row0);
  }
  return (int)cudaGetLastError();
}

const char* wgl3_sweep_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
