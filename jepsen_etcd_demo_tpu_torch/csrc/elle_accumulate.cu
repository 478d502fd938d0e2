// Blocked product-accumulate of one sparse round of elle's tiled
// transitive closure, for Hopper (sm_90a), on the int8 tensor cores.
//
// Replaces the Pallas TPU kernel `_pallas_accumulate` of the JAX package
// (jepsen_etcd_demo_tpu/ops/cycles_tiled.py, kernel body at :211). Both
// compute, for a work list of tile products (sa, sb, dd) over the grid of
// T x T f32 tiles R,
//     acc[d] = sum over g with dd[g] = d of R[sa[g]] @ R[sb[g]],
// in a round of R' = min(R + R @ R, 1). Entries are 0/1, so they are exact
// in int8, and every sum is an integer of at most T x (products of one
// destination), far below 2^24: the int32 sums convert to f32 exactly and
// the kernel equals its plain version bit for bit.
//
// Layout (ops/cycles_tiled.py `destination_lists` prepares it):
//   R    f32[nbb, T, T]      the tile grid, row-major tiles
//   sa   int32[P]            left operand tile of each product,
//   sb   int32[P]            right operand tile, both sorted by destination
//   dst  int32[D]            the live destination tiles, each once
//   off  int32[D + 1]        products off[i] .. off[i+1] go to dst[i]
//   out  f32[nbb + 1, T, T]  zeroed by the caller; the kernel writes the
//                            live destinations' tiles
//
// Design. The Pallas kernel walks a destination-sorted list one grid step
// per product, with one zero-init entry per destination, so that each
// output block is zeroed once and stays resident in VMEM while its
// products accumulate. Blocks on Hopper run in parallel and carry nothing
// from one to the next, so the wrapper makes the list destination-major
// (CSR offsets, on the card) instead: one thread block owns one
// destination and one 128 x 128 sub-tile of it (the whole tile at T =
// 128), sums its products in int32 registers, and writes the sub-tile
// once; destinations with no product stay zero. Grid = (D, (T/128)^2),
// 256 threads (8 warps, 2 x 4, each a 64 x 32 warp tile of 4 x 4
// mma.sync.m16n8k32 s8 products with s32 accumulators).
// The operands stream in K-chunks of 32, every product's chunks one
// sequence: cp.async copies the f32 chunks (A 128 x 32, B 32 x 128) into a
// ring of kStages stages, kStages - 1 chunks ahead of the one in use; each
// chunk is converted to s8 in shared memory (A row-major, B transposed so
// that both fragments are 32-bit loads along k, rows padded to 36 bytes
// against bank conflicts), then multiplied. No second copy of the grid is
// made: the conversion happens as the chunk is staged.
//
// What bounds it on this card. The least time is the larger of the unique
// tiles read and written over the HBM rate and 2 T^3 operations a product
// over the int8 tensor-core rate; chip_smoke.py counts both from the
// round's work list. Each operand tile is re-read once per 128 x 128
// output sub-tile (4 times at T = 256, mostly from L2) as f32, so the
// kernel moves 4 bytes an entry where the tensor cores need one: bound by
// the staging traffic and the conversion, not by the mma rate. wgmma with
// TMA-fed operands is the next step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSub = 128;      // output sub-tile edge
constexpr int kChunk = 32;     // K-chunk (one m16n8k32 k-step)
constexpr int kStages = 3;     // cp.async ring depth
constexpr int kThreads = 256;  // 8 warps
constexpr int kRowWords = 9;   // s8 tile row: 32 bytes + 4 of padding

struct Smem {
  float a[kStages][kSub][kChunk];   // A chunks, row-major (rows x k)
  float b[kStages][kChunk][kSub];   // B chunks, row-major (k x cols)
  uint32_t as[kSub * kRowWords];    // A in s8, [row][k]
  uint32_t bt[kSub * kRowWords];    // B in s8, transposed: [col][k]
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
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

// Four f32 entries (exact small integers) -> four s8 in one word, the
// first in the low byte.
__device__ __forceinline__ uint32_t pack_s8(float x0, float x1, float x2,
                                            float x3) {
  return ((uint32_t)__float2int_rn(x0) & 0xFFu) |
         (((uint32_t)__float2int_rn(x1) & 0xFFu) << 8) |
         (((uint32_t)__float2int_rn(x2) & 0xFFu) << 16) |
         ((uint32_t)__float2int_rn(x3) << 24);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads, 2)
elle_accumulate_kernel(const float* __restrict__ R,
                       const int* __restrict__ sa,
                       const int* __restrict__ sb,
                       const int* __restrict__ dst,
                       const int* __restrict__ off, float* __restrict__ out,
                       int T) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int per_row = T / kSub;
  const int row0 = (blockIdx.y / per_row) * kSub;
  const int col0 = (blockIdx.y % per_row) * kSub;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // mma groupID
  const int q = lane & 3;   // mma threadID_in_group
  const int wm = (warp >> 2) * 64;  // warp tile origin in the sub-tile
  const int wn = (warp & 3) * 32;
  const size_t tile = (size_t)T * T;
  const int p0 = off[blockIdx.x];
  const int per_prod = T / kChunk;
  const int chunks = (off[blockIdx.x + 1] - p0) * per_prod;

  // Copies chunk c (product p0 + c / per_prod, k-offset k0) into its
  // stage; one commit group per call, empty past the last chunk.
  auto issue = [&](int c) {
    if (c < chunks) {
      const int p = p0 + c / per_prod;
      const int k0 = (c % per_prod) * kChunk;
      const int st = c % kStages;
      const float* A = R + (size_t)sa[p] * tile + (size_t)row0 * T + k0;
      const float* B = R + (size_t)sb[p] * tile + (size_t)k0 * T + col0;
#pragma unroll
      for (int i = tid; i < kSub * kChunk / 4; i += kThreads) {
        const int r = i / (kChunk / 4);
        const int c4 = (i % (kChunk / 4)) * 4;
        cp_async16(&sm.a[st][r][c4], A + (size_t)r * T + c4);
      }
#pragma unroll
      for (int i = tid; i < kChunk * kSub / 4; i += kThreads) {
        const int r = i / (kSub / 4);
        const int c4 = (i % (kSub / 4)) * 4;
        cp_async16(&sm.b[st][r][c4], B + (size_t)r * T + c4);
      }
    }
    cp_async_commit();
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) issue(c);

  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kStages - 2>();
    // Chunk c has landed for every thread; every warp is done with the
    // s8 tiles of chunk c - 1 and with stage (c - 1) % kStages.
    __syncthreads();
    issue(c + kStages - 1);
    const int st = c % kStages;
    // A: 128 rows x 8 words of 4 k; B: 128 cols x 8 words of 4 k.
#pragma unroll
    for (int i = tid; i < kSub * kChunk / 4; i += kThreads) {
      const int r = i / (kChunk / 4);
      const int w = i % (kChunk / 4);
      const float4 v = *reinterpret_cast<const float4*>(&sm.a[st][r][4 * w]);
      sm.as[r * kRowWords + w] = pack_s8(v.x, v.y, v.z, v.w);
    }
#pragma unroll
    for (int i = tid; i < kSub * kChunk / 4; i += kThreads) {
      const int n = i % kSub;
      const int w = i / kSub;
      sm.bt[n * kRowWords + w] =
          pack_s8(sm.b[st][4 * w][n], sm.b[st][4 * w + 1][n],
                  sm.b[st][4 * w + 2][n], sm.b[st][4 * w + 3][n]);
    }
    __syncthreads();
    uint32_t af[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t* ar = sm.as + (wm + 16 * i + g) * kRowWords + q;
      af[i][0] = ar[0];
      af[i][1] = ar[8 * kRowWords];
      af[i][2] = ar[4];
      af[i][3] = ar[8 * kRowWords + 4];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t* br = sm.bt + (wn + 8 * j + g) * kRowWords + q;
      const uint32_t b0 = br[0];
      const uint32_t b1 = br[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) mma_s8(acc[i][j], af[i], b0, b1);
    }
  }
  cp_async_wait<0>();

  float* O = out + (size_t)dst[blockIdx.x] * tile + (size_t)row0 * T + col0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = wm + 16 * i + g;
      const int cc = wn + 8 * j + 2 * q;
      float* o = O + (size_t)r * T + cc;
      *reinterpret_cast<float2*>(o) =
          make_float2((float)acc[i][j][0], (float)acc[i][j][1]);
      *reinterpret_cast<float2*>(o + 8 * (size_t)T) =
          make_float2((float)acc[i][j][2], (float)acc[i][j][3]);
    }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 = launched). T must
// be a positive multiple of 128 (the port's tiles are).
int elle_accumulate_launch(const void* R, const void* sa, const void* sb,
                           const void* dst, const void* off, void* out,
                           int n_dst, int T, void* stream) {
  if (T <= 0 || T % kSub != 0 || n_dst < 0)
    return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(Smem);
  cudaError_t e = cudaFuncSetAttribute(
      elle_accumulate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  if (n_dst > 0) {
    const dim3 grid(n_dst, (T / kSub) * (T / kSub));
    elle_accumulate_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)R, (const int*)sa, (const int*)sb, (const int*)dst,
        (const int*)off, (float*)out, T);
  }
  return (int)cudaGetLastError();
}

const char* elle_accumulate_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
