// K3 rans_decode_grouped: the grouped interleaved rANS wire decoder.
//
// Replaces vcf_tpu/ops/pallas/rans_decode.py:pallas_decode_grouped and
// its XLA pre-pass build_windows.  Each step t, every lane resolves its
// symbol (slot = x & 0x7FFF against its group's cumulative table),
// updates x = f * (x >> 15) + slot - cum, and, when x < 2^16, reads the
// next word of the stream: lane s reads words[ptr_t + rank_t(s)], where
// rank_t(s) counts the renormalizing lanes s' < s over ALL S lanes.
//
// What bounds it: that rank is a dependency across every lane at every
// step.  This first design runs the whole decode in ONE block of 1024
// threads, so the rank is one block-wide scan per step and ptr is carried
// in the kernel: no counts sidecar is needed (the dense v0 stream has
// none) and no cross-block synchronization exists.  Thread k owns the
// contiguous lanes [k * P, k * P + P), P = ceil(S / 1024), so the scan
// runs once per step over per-thread counts.  The price is that one SM
// does all the work: the decode is bound by that SM's instruction rate
// (a binary search of 8 shared-memory probes per symbol), not by memory.
// A decode over many blocks (look-back chained per step, or a cooperative
// grid sync) is the next step.
//
// Tables: all G groups' (f, cum) pairs in dynamic shared memory (64 KB
// for G = 64); states: a global scratch laid out so that the threads of
// a warp touch consecutive words.  When the v2 per-step counts are given,
// each step's renormalization total is checked against them; any
// mismatch, a read past the end of the words, or words left over set the
// error word, which the wrapper turns into an exception.

#include "rans_common.cuh"

namespace vcf {

constexpr int DEC_THREADS = 1024;
constexpr int DEC_SCRATCH_INTS = 64;  // scan scratch ahead of the tables
constexpr size_t DEC_SMEM_MAX = 200 * 1024;

enum DecodeError : int {
  kOk = 0,
  kCountMismatch = 1,  // step total differs from the counts sidecar
  kOverrun = 2,        // a step would read past the last word
  kUnderrun = 3,       // words left over after the last step
};

__global__ void __launch_bounds__(DEC_THREADS)
rans_decode_grouped_kernel(const uint16_t* __restrict__ words,
                           long long n_words,
                           const uint32_t* __restrict__ states_in,  // (S,)
                           uint32_t* __restrict__ xs,  // (P * 1024,) scratch
                           const uint32_t* __restrict__ tab,  // (G, 256)
                           int use_smem,
                           const int32_t* __restrict__ counts,  // (L,) or null
                           uint8_t* __restrict__ out,           // (L, S)
                           int32_t* __restrict__ err,  // (2,): code, step
                           int S, int L, int sg, int G) {
  extern __shared__ uint32_t smem[];
  int* scratch = (int*)smem;
  uint32_t* s_tab = smem + DEC_SCRATCH_INTS;
  if (use_smem) {
    for (int i = threadIdx.x; i < G * 256; i += blockDim.x) s_tab[i] = tab[i];
  }
  const uint32_t* T = use_smem ? s_tab : tab;
  const int nt = blockDim.x;
  const int per = (S + nt - 1) / nt;
  const int lo = min((int)threadIdx.x * per, S);
  const int hi = min(lo + per, S);
  // lane lo + j lives at xs[j * nt + threadIdx.x]: coalesced per warp
  for (int j = 0; j < hi - lo; ++j) xs[j * nt + threadIdx.x] = states_in[lo + j];
  __syncthreads();

  long long ptr = 0;
  int code = kOk;
  int t = 0;
  for (; t < L; ++t) {
    int cnt = 0;
    for (int j = 0; j < hi - lo; ++j) {
      const int s = lo + j;
      uint32_t x = xs[j * nt + threadIdx.x];
      const uint32_t* tg = T + (s / sg) * 256;
      const uint32_t slot = x & PROB_MASK;
      // largest v with cum[v] <= slot (cum[0] = 0; never passes 255)
      int v = 0;
#pragma unroll
      for (int step = 128; step >= 1; step >>= 1)
        if ((tg[v + step] >> 16) <= slot) v += step;
      const uint32_t e = tg[v];
      x = (e & 0xFFFFu) * (x >> K_PROB) + slot - (e >> 16);
      out[(size_t)t * S + s] = (uint8_t)v;
      cnt += x < RANS_L;
      xs[j * nt + threadIdx.x] = x;
    }
    int total;
    long long p = ptr + block_exclusive_scan(cnt, &total, scratch);
    // total is the same in every thread, so every thread leaves together
    if (counts != nullptr && total != counts[t]) {
      code = kCountMismatch;
      break;
    }
    if (ptr + total > n_words) {
      code = kOverrun;
      break;
    }
    for (int j = 0; j < hi - lo; ++j) {
      const uint32_t x = xs[j * nt + threadIdx.x];
      if (x < RANS_L) xs[j * nt + threadIdx.x] = (x << 16) | words[p++];
    }
    ptr += total;
  }
  if (code == kOk && ptr != n_words) code = kUnderrun;
  if (threadIdx.x == 0 && code != kOk) {
    err[0] = code;
    err[1] = t;
  }
}

}  // namespace vcf

extern "C" {

int vcf_rans_decode_threads(void) { return vcf::DEC_THREADS; }

// words (n_words,) u16; states (S,) u32; xs scratch of
// ceil(S / threads) * threads u32; tab (G, 256) packed f | cum << 16;
// counts (L,) i32 or NULL; out (L, S) u8; err (2,) i32 zeroed by the
// caller.  Returns the first CUDA error of the attribute call or launch.
int vcf_rans_decode_grouped(const void* words, long long n_words,
                            const void* states, void* xs, const void* tab,
                            const void* counts, void* out, void* err, int S,
                            int L, int G, void* stream) {
  const size_t tab_bytes = (size_t)G * 256 * sizeof(uint32_t);
  const size_t scratch_bytes = vcf::DEC_SCRATCH_INTS * sizeof(int);
  const int use_smem = scratch_bytes + tab_bytes <= vcf::DEC_SMEM_MAX;
  const size_t smem = scratch_bytes + (use_smem ? tab_bytes : 0);
  int rc = (int)cudaFuncSetAttribute(
      vcf::rans_decode_grouped_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc) return rc;
  vcf::rans_decode_grouped_kernel<<<1, vcf::DEC_THREADS, smem,
                                    (cudaStream_t)stream>>>(
      (const uint16_t*)words, n_words, (const uint32_t*)states,
      (uint32_t*)xs, (const uint32_t*)tab, use_smem,
      (const int32_t*)counts, (uint8_t*)out, (int32_t*)err, S, L, S / G, G);
  return (int)cudaGetLastError();
}

}  // extern "C"
