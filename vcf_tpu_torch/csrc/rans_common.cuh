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
#include <cstring>
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

// Asynchronous copies global -> shared (K1's symbol tiles).  A thread's
// cp_async16 calls between two cp_async_commit calls form one group;
// cp_async_wait<N> returns once all but the N newest groups of the thread
// have landed, and a __syncthreads after it makes them visible to the
// block.  dst and src are 16-byte aligned.  The copy bypasses L1 (.cg):
// every symbol is read once.  The host branch (the g++ mock) copies at
// once, so commit and wait have nothing to do there.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(d), "l"(src) : "memory");
#else
  memcpy(dst, src, 16);
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;" ::: "memory");
#endif
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
#endif
}

// Decoupled look-back (K2 over tiles, K3 over the blocks of one step).
//
// Each block owns one 64-bit descriptor: status << 32 | value, status
// LB_EMPTY (zeroed by the launch code's memset), LB_AGGREGATE (value =
// the block's own count) or LB_INCLUSIVE (value = the prefix through the
// block).  Status and value travel in one aligned 64-bit word, written by
// one store and read by one load, both strong (relaxed) at GPU scope: a
// 64-bit access is single-copy atomic, so a reader sees a status only
// with its value, and asm volatile keeps every read of a spin in L2.  No
// other data passes through a descriptor (the value is the prefix), so
// release/acquire would order nothing more, and on the H100 it made K3
// and K2 slower (lookback_ab.py, PERF.md).  A block takes its virtual
// index from an atomic ticket (`lb_ticket`), not from blockIdx.x: it then
// waits only on blocks that were already running when it started, so the
// spin below cannot deadlock whatever order the hardware schedules blocks
// in.  Values stay below 2^31.
constexpr uint32_t LB_EMPTY = 0;
constexpr uint32_t LB_AGGREGATE = 1;
constexpr uint32_t LB_INCLUSIVE = 2;

__device__ __forceinline__ unsigned long long lb_load(
    const unsigned long long* p) {
#ifdef __CUDA_ARCH__
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
#else
  return __atomic_load_n(p, __ATOMIC_RELAXED);
#endif
}

__device__ __forceinline__ void lb_publish(unsigned long long* p,
                                           uint32_t status, uint32_t value) {
  const unsigned long long v = ((unsigned long long)status << 32) | value;
#ifdef __CUDA_ARCH__
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
#else
  __atomic_store_n(p, v, __ATOMIC_RELAXED);
#endif
}

__device__ __forceinline__ int lb_flag(const int* p) {
#ifdef __CUDA_ARCH__
  int v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
#else
  return __atomic_load_n(p, __ATOMIC_RELAXED);
#endif
}

// The block's virtual index; every thread of the block must call it.
__device__ __forceinline__ int lb_ticket(int* ticket, int* s_slot) {
  if (threadIdx.x == 0) *s_slot = atomicAdd(ticket, 1);
  __syncthreads();
  return *s_slot;
}

// The exclusive prefix of block `vb` over desc[0, vb).  Called by one
// whole warp, it returns the same value in every lane.  Lane i reads
// desc[top - i]: a window of 32 predecessors, nearest first.  The window
// is summed up to its first INCLUSIVE; every descriptor up to that one
// must have been published at least as AGGREGATE, else the warp reads
// the window again.  Without an INCLUSIVE it moves 32 blocks back.  A
// non-null `abort` is polled while waiting: -1 once it is non-zero.  It
// only ends an error path early: a caller must publish every descriptor a
// later block waits on, also on its way out (rans_decode.cu says how K3
// does).
__device__ __forceinline__ long long lb_exclusive(
    const unsigned long long* desc, int vb, const int* abort) {
  const int lane = threadIdx.x & 31;
  long long excl = 0;
  for (int top = vb - 1; top >= 0; top -= 32) {
    const int j = top - lane;
    unsigned long long d;
    uint32_t upto;  // lanes up to the first INCLUSIVE (all if none)
    bool done;
    while (true) {
      // before desc[0] counts as an INCLUSIVE of 0
      d = j >= 0 ? lb_load(desc + j)
                 : (unsigned long long)LB_INCLUSIVE << 32;
      const uint32_t st = (uint32_t)(d >> 32);
      const uint32_t incl = __ballot_sync(0xffffffffu, st == LB_INCLUSIVE);
      const uint32_t empty = __ballot_sync(0xffffffffu, st == LB_EMPTY);
      done = incl != 0;
      upto = done ? ((incl & (0u - incl)) << 1) - 1u : 0xffffffffu;
      if (!(empty & upto)) break;
      if (abort != nullptr && __any_sync(0xffffffffu, lb_flag(abort) != 0))
        return -1;
    }
    long long v = (upto >> lane) & 1u ? (long long)(uint32_t)d : 0;
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    excl += v;
    if (done) break;
  }
  return excl;
}

// Publish AGGREGATE (unless block 0), look back, publish INCLUSIVE;
// returns the exclusive prefix, or -1 on abort.  One whole warp.
__device__ __forceinline__ long long lb_scan(unsigned long long* desc, int vb,
                                             uint32_t total,
                                             const int* abort) {
  const int lane = threadIdx.x & 31;
  long long excl = 0;
  if (vb > 0) {
    if (lane == 0) lb_publish(desc + vb, LB_AGGREGATE, total);
    excl = lb_exclusive(desc, vb, abort);
  }
  if (excl >= 0 && lane == 0)
    lb_publish(desc + vb, LB_INCLUSIVE, (uint32_t)(excl + total));
  return excl;
}

}  // namespace vcf
