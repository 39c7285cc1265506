// Shared definitions of the grouped interleaved rANS kernels.
//
// State law (vcf_tpu/entropy/rans.py np_encode_grouped/np_decode_grouped):
// 32-bit states, 15-bit probabilities (sum of freqs = 2^15), 16-bit
// renormalization words, lower bound RANS_L = 2^16.
//
// Tables: one (G, 256) uint32 array per call, entry = f | (cum << 16).
// f <= 2^15 and cum < 2^15, so both fit 16 bits; one load fetches both.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace vcf {

constexpr int K_PROB = 15;
constexpr uint32_t PROB_MASK = (1u << K_PROB) - 1u;
constexpr uint32_t RANS_L = 1u << 16;
constexpr int SHIFT_EMIT = 32 - K_PROB;  // x >= f * 2^17  <=>  (x >> 17) >= f

// Exclusive prefix sum of `v` over the whole block; `*total` gets the
// block sum.  Every thread of the block must call it (it synchronizes),
// blockDim.x must be a multiple of 32 and at most 1024.  `scratch` holds
// at least 33 ints of shared memory and may be reused right after return.
__device__ __forceinline__ int block_exclusive_scan(int v, int* total,
                                                    int* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < n_warps ? scratch[lane] : 0;
    int wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, wi, o);
      if (lane >= o) wi += y;
    }
    if (lane < n_warps) scratch[lane] = wi - w;  // exclusive warp offsets
    if (lane == 31) scratch[32] = wi;            // block total
  }
  __syncthreads();
  const int out = scratch[warp] + incl - v;
  *total = scratch[32];
  __syncthreads();
  return out;
}

}  // namespace vcf
