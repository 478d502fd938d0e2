// Int32 ALU-peak probe for Hopper (sm_90a): the yardstick of the port's
// integer kernels.
//
// Replaces the Pallas TPU kernel of bench.py `_peak_microbench` (kernel
// body at bench.py:125, pallas_call at :144). Both run 8 independent
// chains a_k = x + k per input word and apply, `iters` times,
//     a ^= 0x9E3779B9; a |= a << 1; a &= 0x7FFFFFFF; a += i
// (i the iteration index, uint32 arithmetic), then write the OR of the 8
// chains. 5 word-ops per chain and iteration, counted as bench.py counts
// them: iters * 8 * 5 per input word. The loop touches no memory: it is
// the best case for the sweep kernels' xor/shift/or/and/add mix.
//
// Layout: x uint32[n] (one word per thread), out uint32[n].
//
// Design. One thread per word, its 8 chains in registers; 1024-thread
// blocks, so a launch of n = 1024 x (number of SMs) words puts one block
// (32 warps, 8 per scheduler, each with 8 independent chains) on every SM
// and measures the card, and n = 1024 measures one SM. The loop-carried
// `+ i` keeps the compiler from folding iterations; the chains differ in
// their start value, so none can be merged. The loop is unrolled
// kUnroll times (exported, so the SASS reading divides by it).
//
// What bounds it on this card: integer issue, by construction. nvcc fuses
// the ops (xor and the or/and pair each become one LOP3, the shift an SHF
// or an IMAD.SHL on the FMA pipe), so an iteration of the 8 chains is
// fewer than 40 SASS instructions: the word-op rate counted as bench.py
// counts it can exceed the data-sheet int32 issue rate. chip_smoke.py
// reads the SASS of this library (cuobjdump) and reports the instruction
// rate beside the word-op rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChains = 8;
constexpr int kThreads = 1024;
constexpr int kUnroll = 4;

__global__ void __launch_bounds__(kThreads)
alu_peak_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                int n, int iters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t x0 = x[i];
  uint32_t a[kChains];
#pragma unroll
  for (int k = 0; k < kChains; ++k) a[k] = x0 + (uint32_t)k;
#pragma unroll kUnroll
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < kChains; ++k) {
      uint32_t v = a[k] ^ 0x9E3779B9u;
      v |= v << 1;
      v &= 0x7FFFFFFFu;
      a[k] = v + (uint32_t)it;
    }
  }
  uint32_t acc = a[0];
#pragma unroll
  for (int k = 1; k < kChains; ++k) acc |= a[k];
  out[i] = acc;
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
int alu_peak_launch(const void* x, void* out, int n, int iters,
                    void* stream) {
  if (n < 0 || iters < 0) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    alu_peak_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                      (cudaStream_t)stream>>>((const uint32_t*)x,
                                              (uint32_t*)out, n, iters);
  }
  return (int)cudaGetLastError();
}

// The unroll factor of the iteration loop (the SASS loop body holds this
// many iterations).
int alu_peak_unroll(void) { return kUnroll; }

const char* alu_peak_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
