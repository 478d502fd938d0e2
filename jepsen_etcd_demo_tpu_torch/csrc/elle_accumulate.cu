// Blocked product-accumulate of one sparse round of elle's tiled
// transitive closure, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_pallas_accumulate` of the JAX package
// (jepsen_etcd_demo_tpu/ops/cycles_tiled.py, kernel body at :211). Both
// compute, for a work list of tile products (sa, sb, dd) over the grid of
// T x T f32 tiles R,
//     acc[d] = sum over g with dd[g] = d of R[sa[g]] @ R[sb[g]],
// in a round of R' = min(R + R @ R, 1). Entries are 0/1 and every sum is
// an integer below 2^24, so any summation order gives the same f32 result
// exactly: the kernel equals its plain version bit for bit.
//
// Layout (ops/cycles_tiled.py `destination_lists` prepares it):
//   R    f32[nbb, T, T]      the tile grid, row-major tiles
//   sa   int32[P]            left operand tile of each product,
//   sb   int32[P]            right operand tile, both sorted by destination
//   dst  int32[D]            the live destination tiles
//   off  int32[D + 1]        products off[i] .. off[i+1] go to dst[i]
//   out  f32[nbb + 1, T, T]  zeroed by the caller; the kernel writes the
//                            sub-tiles of the live destinations once
//
// Design. The Pallas kernel walks a destination-sorted list one grid step
// per product, with one zero-init entry per destination, so that each
// output block is zeroed once and stays resident in VMEM while its
// products accumulate. Blocks on Hopper run in parallel and carry nothing
// from one to the next, so the list is made destination-major on the host
// side (CSR offsets) instead: one thread block owns one live destination
// tile and one 64 x 64 sub-tile of it, sums that destination's products in
// registers, and writes once. No atomics, no init pass; destinations with
// no product stay zero. Grid = (D, (T/64)^2), 256 threads, each holding a
// 4 x 4 block of the sub-tile (rows ty + 16i, columns tx + 16j). For each
// product the operands stream through shared memory in K-chunks of 32: the
// A chunk (64 rows x 32) stored transposed with a row stride of 65 floats,
// which makes the transposing stores conflict-free, the B chunk (32 x 64)
// stored as loaded. FP32 FMAs on the CUDA cores.
//
// What bounds it on this card. The least time is the larger of the unique
// tiles read and written over the HBM rate and 2 T^3 operations a product
// over the int8 tensor-core rate (0/1 is exact in int8); chip_smoke.py
// counts both from the round's work list. This first version runs on the
// FP32 cores, 30 times below the int8 rate, and re-reads each operand
// tile once per 64 x 64 output sub-tile (through L2), so it is bound by
// FP32 arithmetic and shared-memory traffic. Tensor cores (mma / wgmma on
// int8 or bf16) and TMA staging are the next steps.

#include <cuda_runtime.h>

namespace {

constexpr int kSub = 64;      // output sub-tile edge
constexpr int kChunk = 32;    // K-chunk
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
elle_accumulate_kernel(const float* __restrict__ R,
                       const int* __restrict__ sa,
                       const int* __restrict__ sb,
                       const int* __restrict__ dst,
                       const int* __restrict__ off, float* __restrict__ out,
                       int T) {
  __shared__ float As[kChunk][kSub + 1];                 // As[k][row]
  __shared__ __align__(16) float Bs[kChunk][kSub + 4];   // Bs[k][col]

  const int per_row = T / kSub;
  const int row0 = (blockIdx.y / per_row) * kSub;
  const int col0 = (blockIdx.y % per_row) * kSub;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const size_t tile = (size_t)T * T;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int p1 = off[blockIdx.x + 1];
  for (int p = off[blockIdx.x]; p < p1; ++p) {
    const float* A = R + (size_t)sa[p] * tile + (size_t)row0 * T;
    const float* B = R + (size_t)sb[p] * tile + col0;
    for (int k0 = 0; k0 < T; k0 += kChunk) {
      // A chunk: 64 rows x 32 columns = 512 float4, two per thread.
#pragma unroll
      for (int i = threadIdx.x; i < kSub * kChunk / 4; i += kThreads) {
        const int r = i / (kChunk / 4);
        const int c = (i % (kChunk / 4)) * 4;
        const float4 v =
            *reinterpret_cast<const float4*>(A + (size_t)r * T + k0 + c);
        As[c + 0][r] = v.x;
        As[c + 1][r] = v.y;
        As[c + 2][r] = v.z;
        As[c + 3][r] = v.w;
      }
      // B chunk: 32 rows x 64 columns = 512 float4, two per thread.
#pragma unroll
      for (int i = threadIdx.x; i < kChunk * kSub / 4; i += kThreads) {
        const int r = i / (kSub / 4);
        const int c = (i % (kSub / 4)) * 4;
        *reinterpret_cast<float4*>(&Bs[r][c]) =
            *reinterpret_cast<const float4*>(B + (size_t)(k0 + r) * T + c);
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  float* O = out + (size_t)dst[blockIdx.x] * tile + (size_t)row0 * T + col0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      O[(size_t)(ty + 16 * i) * T + tx + 16 * j] = acc[i][j];
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 = launched). T must
// be a multiple of 64 (the port's tiles are multiples of 128).
int elle_accumulate_launch(const void* R, const void* sa, const void* sb,
                           const void* dst, const void* off, void* out,
                           int n_dst, int T, void* stream) {
  if (T <= 0 || T % kSub != 0 || n_dst < 0)
    return (int)cudaErrorInvalidValue;
  if (n_dst > 0) {
    const dim3 grid(n_dst, (T / kSub) * (T / kSub));
    elle_accumulate_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)R, (const int*)sa, (const int*)sb, (const int*)dst,
        (const int*)off, (float*)out, T);
  }
  return (int)cudaGetLastError();
}

const char* elle_accumulate_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
