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
// The function. Each closure round looks at the live blocks (those
// holding a config) as the round starts;
//   * with at most thresh live, it sweeps only those, in the order a
//     sequential pass over the ascending work list would: block bi
//     receives what its live lower neighbours bi - 2^b fire for slot
//     12 + b, then, if live, closes under slots 0..11 once in slot order,
//     and what it then holds is what it fires into bi + 2^b. A block's
//     sources have one bit fewer set, so the blocks of one bit count (a
//     level) run together, one level after the other. A block outside the
//     work list receives but does not expand;
//   * otherwise it runs one dense Gauss-Seidel sweep of all K slots.
// Rounds stop when one changes nothing or after `rounds` (= K) rounds,
// which always reach the fixpoint. live_sum adds the converged table's
// live blocks; a step counts as sparse when every round was.
//
// Design. One block of 1024 threads per history; table, step ring and
// the block's bookkeeping in shared memory (at most 2^20 bits, 128 KiB).
//   * Step inputs come through the 4-step cp.async ring of the dense
//     routes (wgl3_table.cuh), so no step waits on device memory.
//   * The live blocks are a 64-bit mask that no round probes: within a
//     step's closure the table only gains configs, so a live block stays
//     live, and a round adds the blocks whose words it changed (a warp OR
//     and one shared atomic per warp). The mask is taken afresh only
//     after the prune, which counts the converged table in the same pass
//     over the live blocks only.
//   * The levels (the blocks of each bit count) are masks built once per
//     launch; a round intersects them with its work list.
//   * A level's blocks go to groups of 4 warps (8 groups), one block a
//     group at a time: 128 threads, one word column each for slots 0..4
//     and one word pair each for slots 5..11, synchronised by a named
//     barrier of the group's 128 threads (bar.sync id, 128); the block
//     synchronises only between levels.
//
// What bounds it on this card: as for the dense sweep, the chain of
// dependent rounds on one SM (barrier and shared-memory latency), not
// device memory; a sparse round pays a group barrier per firing slot of a
// live block and a block barrier per level, and touches only the live
// blocks' words and those they fire into.

#include "wgl3_table.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kBlockWords = 128;
constexpr int kBlockSlots = 12;   // slots j < 12 stay inside a block
constexpr int kMaxBlocks = 64;
constexpr int kThreads = 1024;
constexpr int kGroupWarps = 4;    // warps that sweep one block together
constexpr int kGroupThreads = kGroupWarps * 32;
constexpr int kGroups = kThreads / kGroupThreads;

typedef unsigned long long u64;

// Named barrier `group + 1` of the group's 128 threads (0 is
// __syncthreads').
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(group + 1), "n"(kGroupThreads)
               : "memory");
}

// Blocks (bit bi) whose index has bit b set.
__device__ __forceinline__ u64 has_bit(int b) {
  switch (b) {
    case 0: return 0xAAAAAAAAAAAAAAAAull;
    case 1: return 0xCCCCCCCCCCCCCCCCull;
    case 2: return 0xF0F0F0F0F0F0F0F0ull;
    case 3: return 0xFF00FF00FF00FF00ull;
    case 4: return 0xFFFF0000FFFF0000ull;
    default: return 0xFFFFFFFF00000000ull;
  }
}

__device__ __forceinline__ int nth_bit(u64 m, int q) {
  for (; q > 0; --q) m &= m - 1;
  return __ffsll((long long)m) - 1;
}

// ORs this thread's written blocks into *pub, one atomic per warp; every
// lane of the warp calls it.
__device__ __forceinline__ void publish(u64* pub, u64 wrote) {
  const unsigned lo = __reduce_or_sync(kFull, (unsigned)wrote);
  const unsigned hi = __reduce_or_sync(kFull, (unsigned)(wrote >> 32));
  if ((threadIdx.x & 31) == 0 && (lo | hi))
    atomicOr(pub, ((u64)hi << 32) | lo);
}

// One dense round: every slot once, in slot order (wgl3_table.cuh's
// staged sweep without its count).
__device__ int dense_round(uint32_t* T, const uint32_t* cms,
                           const uint32_t* snz, int K, int W, int t,
                           u64& wrote) {
  const int tid = threadIdx.x;
  int changed = 0;
  for (int w = tid; w < W; w += kThreads) {
    int cw = 0;
    for (int j = 0; j < 5; ++j)
      if (snz[j]) cw |= wgl3::fire_in_word_nz(T, cms, K, W, w, j, t, snz[j]);
    if (cw) wrote |= 1ull << (w / kBlockWords);
    changed |= cw;
  }
  for (int j = 5; j < K; ++j) {
    const uint32_t nzj = snz[j];
    if (!nzj) continue;  // block-uniform
    __syncthreads();
    const int sh = j - 5;
    const int dlt = 1 << sh;
    for (int i = tid; i < (W >> 1); i += kThreads) {
      const int ws = ((i >> sh) << (sh + 1)) | (i & (dlt - 1));
      if (wgl3::fire_across_nz(T, cms, K, W, ws, ws | dlt, j, t, nzj)) {
        changed = 1;
        wrote |= 1ull << ((ws | dlt) / kBlockWords);
      }
    }
  }
  return changed;
}

// One sparse round over the live blocks `live` (see the note above).
__device__ int sparse_round(uint32_t* T, const uint32_t* cms,
                            const uint32_t* snz, const u64* levels, int K,
                            int W, int bits, int t, u64 live, u64& wrote) {
  const int group = threadIdx.x / kGroupThreads;
  const int gt = threadIdx.x % kGroupThreads;  // this thread's word
  // Blocks that receive: bit b set and the partner with it clear live.
  u64 recv = 0ull;
  for (int b = 0; b < bits; ++b)
    if (snz[kBlockSlots + b]) recv |= (live << (1 << b)) & has_bit(b);
  const u64 work = live | recv;
  int changed = 0;
  for (int level = 0; level <= bits; ++level) {
    const u64 items = levels[level] & work;
    if (!items) continue;  // block-uniform
    const int n_items = __popcll(items);
    for (int q = group; q < n_items; q += kGroups) {
      const int bi = nth_bit(items, q);
      const int base = bi * kBlockWords;
      int cb = 0;
      if ((recv >> bi) & 1ull) {
        for (int b = 0; b < bits; ++b) {
          const int p = bi ^ (1 << b);
          const uint32_t nzj = snz[kBlockSlots + b];
          if (!((bi >> b) & 1) || !((live >> p) & 1ull) || !nzj) continue;
          cb |= wgl3::fire_across_nz(T, cms, K, W, p * kBlockWords + gt,
                                     base + gt, kBlockSlots + b, t, nzj);
        }
      }
      if ((live >> bi) & 1ull) {
        // Slots 0..4 on this thread's word, which it received itself;
        // then slots 5..11, a group barrier before each.
        for (int j = 0; j < 5; ++j)
          if (snz[j])
            cb |= wgl3::fire_in_word_nz(T, cms, K, W, base + gt, j, t,
                                        snz[j]);
        for (int j = 5; j < kBlockSlots; ++j) {
          const uint32_t nzj = snz[j];
          if (!nzj) continue;  // group-uniform
          group_sync(group);
          const int sh = j - 5;
          const int dlt = 1 << sh;
          if (gt < (kBlockWords >> 1)) {
            const int ws =
                base + (((gt >> sh) << (sh + 1)) | (gt & (dlt - 1)));
            cb |= wgl3::fire_across_nz(T, cms, K, W, ws, ws | dlt, j, t, nzj);
          }
        }
      }
      if (cb) wrote |= 1ull << bi;
      changed |= cb;
    }
    __syncthreads();  // the level is done before the next one reads it
  }
  return changed;
}

__global__ void __launch_bounds__(kThreads, 1)
wgl3_sparse_kernel(const int* __restrict__ ln, const int* __restrict__ tg,
                   const uint32_t* __restrict__ cm, uint32_t* Tio, int* meta,
                   int R, int S, int K, int rounds, int thresh) {
  extern __shared__ uint32_t smem[];
  __shared__ u64 pub[3];         // blocks written, three rotating places
  __shared__ u64 levels[8];      // blocks of each bit count
  __shared__ uint32_t snz[32];   // each slot's destination rows this step
  __shared__ unsigned int count[2];
  const int W = 1 << (K - 5);
  const int nb = W / kBlockWords;
  const int bits = __ffs(nb) - 1;
  const int SK = S * K;
  uint32_t* T = smem;              // [S][W]
  uint32_t* ring = smem + S * W;   // [kRing][SK + 1]
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;

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
  if (tid < 3) pub[tid] = 0ull;
  if (tid < 2) count[tid] = 0u;
  if (tid <= bits) {
    u64 lv = 0ull;
    for (int bi = 0; bi < nb; ++bi)
      if (__popc(bi) == tid) lv |= 1ull << bi;
    levels[tid] = lv;
  }
  __syncthreads();
  u64 wrote = 0ull;
  for (int i = tid; i < S * W; i += kThreads) {
    const uint32_t v = Tb[i];
    T[i] = v;
    if (v) wrote |= 1ull << ((i & (W - 1)) / kBlockWords);
  }
  int ev = 0;  // publications so far: event e uses pub[e % 3]
  publish(&pub[0], wrote);

  const int steps = ln[b];
  const int* tgb = tg + (size_t)b * R;
  const uint32_t* cmb = cm + (size_t)b * R * SK;
  const int live_steps = dead ? 0 : steps;
  for (int q = 0; q < wgl3::kRing; ++q) {
    if (q < live_steps)
      wgl3::stage_step(ring + q * (SK + 1), tgb, cmb, q, SK, tid, kThreads);
    wgl3::cp_async_commit();
  }
  __syncthreads();
  // A publication is read after the barrier that follows it; the place
  // two ahead was read before the previous barrier, so it is cleared.
  u64 live = pub[0];
  if (tid == 0) pub[2] = 0ull;
  ev = 1;

  int r = 0;
  for (; r < live_steps; ++r) {
    wgl3::cp_async_wait<wgl3::kRing - 1>();
    __syncthreads();  // step r's inputs are in place
    uint32_t* slot = ring + (r % wgl3::kRing) * (SK + 1);
    const int t = (int)slot[0];
    const uint32_t* cms = slot + 1;
    if (tid < 32) snz[lane] = wgl3::slot_destinations(cms, S, K, lane);
    __syncthreads();
    int n_rounds = 0;
    int sparse_rounds = 0;
    int changed = 1;
    while (changed && n_rounds < rounds) {
      const int take = __popcll(live) <= thresh;
      wrote = 0ull;
      const int ch =
          take ? sparse_round(T, cms, snz, levels, K, W, bits, t, live, wrote)
               : dense_round(T, cms, snz, K, W, t, wrote);
      publish(&pub[ev % 3], wrote);
      changed = __syncthreads_or(ch);
      live |= pub[ev % 3];
      if (tid == 0) pub[(ev + 2) % 3] = 0ull;
      ++ev;
      ++n_rounds;
      sparse_rounds += take;
    }
    const int live_blocks = __popcll(live);

    // Count the converged table and prune at t in one pass over the live
    // blocks (the others are empty and stay so): keep the configs that
    // fired t, bit t cleared. Group g takes the pass's g-th, (g + 8)-th,
    // ... block (for t >= 12, the pair of blocks bi and bi + 2^(t-12), bi
    // receiving bi + 2^(t-12)'s words), thread gt word column gt of every
    // row. The blocks left holding a config are the next step's live ones.
    unsigned int c = 0u;
    wrote = 0ull;
    const int group = tid / kGroupThreads;
    const int gt = tid % kGroupThreads;
    const int span = t < kBlockSlots ? 0 : 1 << (t - kBlockSlots);
    const u64 items =
        span ? (live & ~has_bit(t - kBlockSlots)) |
                   ((live & has_bit(t - kBlockSlots)) >> span)
             : live;
    const int n_items = __popcll(items);
    for (int q = group; q < n_items; q += kGroups) {
      const int bi = nth_bit(items, q);
      const int base = bi * kBlockWords;
      int kept = 0;
      if (t < 5) {
        const int sh = 1 << t;
        const uint32_t lo = wgl3::lo_mask(t);
        for (int s = 0; s < S; ++s) {
          uint32_t* p = T + s * W + base + gt;
          const uint32_t v = *p;
          c += __popc(v);
          *p = (v >> sh) & lo;
          kept |= *p != 0u;
        }
      } else if (!span) {
        const int sh = t - 5;
        const int dlt = 1 << sh;
        if (gt < (kBlockWords >> 1)) {
          const int ws = base + (((gt >> sh) << (sh + 1)) | (gt & (dlt - 1)));
          for (int s = 0; s < S; ++s) {
            const uint32_t lo = T[s * W + ws];
            const uint32_t v = T[s * W + (ws | dlt)];
            c += __popc(lo) + __popc(v);
            T[s * W + ws] = v;
            T[s * W + (ws | dlt)] = 0u;
            kept |= v != 0u;
          }
        }
      } else {
        const int hi = base + span * kBlockWords;
        for (int s = 0; s < S; ++s) {
          const uint32_t lo = T[s * W + base + gt];
          const uint32_t v = T[s * W + hi + gt];
          c += __popc(lo) + __popc(v);
          T[s * W + base + gt] = v;
          T[s * W + hi + gt] = 0u;
          kept |= v != 0u;
        }
      }
      if (kept) wrote |= 1ull << bi;
    }
    c = __reduce_add_sync(kFull, c);
    if (lane == 0) atomicAdd(&count[r & 1], c);
    publish(&pub[ev % 3], wrote);
    __syncthreads();
    live = pub[ev % 3];
    if (tid == 0) {
      pub[(ev + 2) % 3] = 0ull;
      // Frontier size of the converged table (banked configs included).
      const int n = (int)count[r & 1];
      count[r & 1] = 0u;  // next added to two steps (and barriers) later
      maxf = n > maxf ? n : maxf;
      cfgs += (unsigned int)n;
      live_sum += live_blocks;
      sparse_steps += sparse_rounds == n_rounds;
      ++real_steps;
    }
    ++ev;
    if (!live) {  // an empty table ends the search
      dead = 1;
      dead_step = offset + r;
      ++r;
      break;
    }
    // The rounds are done with this ring slot (the barrier above).
    if (r + wgl3::kRing < live_steps)
      wgl3::stage_step(slot, tgb, cmb, r + wgl3::kRing, SK, tid, kThreads);
    wgl3::cp_async_commit();
  }
  wgl3::cp_async_wait<0>();
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
  for (int i = tid; i < S * W; i += kThreads) Tb[i] = T[i];
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
  if (nb < 2 || nb > kMaxBlocks || S < 1 || S > 32)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)(S * W + wgl3::kRing * (S * K + 1)) * sizeof(uint32_t);
  cudaError_t e = cudaFuncSetAttribute(
      wgl3_sparse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (B > 0) {
    wgl3_sparse_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
        (const int*)ln, (const int*)tg, (const uint32_t*)cm, (uint32_t*)Tio,
        (int*)meta, R, S, K, rounds, thresh);
  }
  return (int)cudaGetLastError();
}

const char* wgl3_sparse_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
