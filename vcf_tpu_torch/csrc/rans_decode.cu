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
//
// K3 has two modes, a template parameter: order 0 (above) and the order-1
// context mode `rans_decode_ctx`, which replaces
// vcf_tpu/ops/pallas/rans_ctx.py:pallas_decode_ctx with its XLA pre-pass
// build_windows.  The table of a lane's step is picked by the class of
// the symbol the lane decoded one step before, cls_lut[prev] (prev starts
// at 128, class 0, as in the encoder), so each lane stays one chain and
// the routing is order 0's.  prev lives in a per-lane byte scratch laid
// out like the states.  The context tables do not fit in shared memory
// the way order 0 keeps them (4 bytes an entry: 256 KiB at G = 64 with 4
// classes), so the context mode keeps only the cumulative rows: 257 u16
// entries per (group, class), the row's total 2^15 last, and
// f = cum[v + 1] - cum[v].  That is 128.5 KiB at G = 64 with 4 classes
// and 130 KiB at G = 17 with 15, in shared memory; G = 64 with 15 classes
// (482 KiB) keeps the rows in global memory, where the 8-probe search
// reads them through L1 and L2 (vcf_rans_decode_ctx_smem says which mode
// a shape takes).  The TPU's class-select and bucket matmuls are gone.

#include "rans_common.cuh"

namespace vcf {

constexpr int DEC_THREADS = 1024;
constexpr int DEC_SCRATCH_INTS = 64;  // scan scratch ahead of the tables
constexpr int DEC_LUT_INTS = 64;      // the context mode's 256-byte class LUT
constexpr size_t DEC_SMEM_MAX = 200 * 1024;
constexpr int CUM_ROW = 257;          // u16 entries per context-mode row

enum DecodeError : int {
  kOk = 0,
  kCountMismatch = 1,  // step total differs from the counts sidecar
  kOverrun = 2,        // a step would read past the last word
  kUnderrun = 3,       // words left over after the last step
};

// CTX = false: order 0, tab (G, 256) u32 packed f | cum << 16.
// CTX = true: the context mode, tab (G, n_ctx, 257) u16 cumulative rows,
// cls_lut (256,) the class of each previous symbol, prev a per-lane byte
// scratch laid out like xs.
template <bool CTX>
__global__ void __launch_bounds__(DEC_THREADS)
rans_decode_kernel(const uint16_t* __restrict__ words, long long n_words,
                   const uint32_t* __restrict__ states_in,  // (S,)
                   uint32_t* __restrict__ xs,   // (P * 1024,) scratch
                   uint8_t* __restrict__ prev,  // (P * 1024,), CTX only
                   const void* __restrict__ tab, const uint8_t* cls_lut,
                   int use_smem,
                   const int32_t* __restrict__ counts,  // (L,) or null
                   uint8_t* __restrict__ out,           // (L, S)
                   int32_t* __restrict__ err,  // (2,): code, step
                   int S, int L, int sg, int G, int n_ctx) {
  extern __shared__ uint32_t smem[];
  int* scratch = (int*)smem;
  uint8_t* s_lut = (uint8_t*)(smem + DEC_SCRATCH_INTS);
  void* s_tab = smem + DEC_SCRATCH_INTS + (CTX ? DEC_LUT_INTS : 0);
  const int n_tab_words =
      CTX ? (G * n_ctx * CUM_ROW + 1) / 2 : G * 256;  // in u32 words
  if (use_smem) {
    for (int i = threadIdx.x; i < n_tab_words; i += blockDim.x)
      ((uint32_t*)s_tab)[i] = ((const uint32_t*)tab)[i];
  }
  if constexpr (CTX) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) s_lut[i] = cls_lut[i];
  }
  const void* T = use_smem ? s_tab : tab;
  const int nt = blockDim.x;
  const int per = (S + nt - 1) / nt;
  const int lo = min((int)threadIdx.x * per, S);
  const int hi = min(lo + per, S);
  // lane lo + j lives at xs[j * nt + threadIdx.x]: coalesced per warp
  for (int j = 0; j < hi - lo; ++j) {
    xs[j * nt + threadIdx.x] = states_in[lo + j];
    if constexpr (CTX) prev[j * nt + threadIdx.x] = 128;
  }
  __syncthreads();

  long long ptr = 0;
  int code = kOk;
  int t = 0;
  for (; t < L; ++t) {
    int cnt = 0;
    for (int j = 0; j < hi - lo; ++j) {
      const int s = lo + j;
      uint32_t x = xs[j * nt + threadIdx.x];
      const uint32_t slot = x & PROB_MASK;
      // largest v with cum[v] <= slot (cum[0] = 0; never passes 255)
      int v = 0;
      if constexpr (CTX) {
        const uint8_t pv = prev[j * nt + threadIdx.x];
        const uint16_t* row = (const uint16_t*)T +
            ((size_t)(s / sg) * n_ctx + s_lut[pv]) * CUM_ROW;
#pragma unroll
        for (int step = 128; step >= 1; step >>= 1)
          if (row[v + step] <= slot) v += step;
        const uint32_t cum = row[v];
        x = ((uint32_t)row[v + 1] - cum) * (x >> K_PROB) + slot - cum;
        prev[j * nt + threadIdx.x] = (uint8_t)v;
      } else {
        const uint32_t* tg = (const uint32_t*)T + (s / sg) * 256;
#pragma unroll
        for (int step = 128; step >= 1; step >>= 1)
          if ((tg[v + step] >> 16) <= slot) v += step;
        const uint32_t e = tg[v];
        x = (e & 0xFFFFu) * (x >> K_PROB) + slot - (e >> 16);
      }
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

// Shared-memory bytes of the tables, and whether they fit.
inline size_t table_bytes(int G, int n_ctx, bool ctx) {
  return ctx ? (size_t)((G * n_ctx * CUM_ROW + 1) / 2) * sizeof(uint32_t)
             : (size_t)G * 256 * sizeof(uint32_t);
}

inline size_t fixed_bytes(bool ctx) {
  return (DEC_SCRATCH_INTS + (ctx ? DEC_LUT_INTS : 0)) * sizeof(int);
}

inline bool tables_fit(int G, int n_ctx, bool ctx) {
  return fixed_bytes(ctx) + table_bytes(G, n_ctx, ctx) <= DEC_SMEM_MAX;
}

template <bool CTX>
int launch_decode(const void* words, long long n_words, const void* states,
                  void* xs, void* prev, const void* tab, const void* cls_lut,
                  const void* counts, void* out, void* err, int S, int L,
                  int G, int n_ctx, void* stream) {
  const int use_smem = tables_fit(G, n_ctx, CTX);
  const size_t smem =
      fixed_bytes(CTX) + (use_smem ? table_bytes(G, n_ctx, CTX) : 0);
  int rc = (int)cudaFuncSetAttribute(
      rans_decode_kernel<CTX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (rc) return rc;
  rans_decode_kernel<CTX><<<1, DEC_THREADS, smem, (cudaStream_t)stream>>>(
      (const uint16_t*)words, n_words, (const uint32_t*)states,
      (uint32_t*)xs, (uint8_t*)prev, tab, (const uint8_t*)cls_lut, use_smem,
      (const int32_t*)counts, (uint8_t*)out, (int32_t*)err, S, L, S / G, G,
      n_ctx);
  return (int)cudaGetLastError();
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
  return vcf::launch_decode<false>(words, n_words, states, xs, nullptr, tab,
                                   nullptr, counts, out, err, S, L, G, 1,
                                   stream);
}

// 1 when the context mode keeps the (G, n_ctx, 257) rows in shared
// memory, 0 when it reads them from global memory.
int vcf_rans_decode_ctx_smem(int G, int n_ctx) {
  return vcf::tables_fit(G, n_ctx, true) ? 1 : 0;
}

// The context mode: prev a u8 scratch of the size of xs; tab
// (G, n_ctx, 257) u16 cumulative rows (row total last); cls_lut (256,) u8
// classes in [0, n_ctx); the rest as vcf_rans_decode_grouped.
int vcf_rans_decode_ctx(const void* words, long long n_words,
                        const void* states, void* xs, void* prev,
                        const void* tab, const void* cls_lut,
                        const void* counts, void* out, void* err, int S,
                        int L, int G, int n_ctx, void* stream) {
  return vcf::launch_decode<true>(words, n_words, states, xs, prev, tab,
                                  cls_lut, counts, out, err, S, L, G, n_ctx,
                                  stream);
}

}  // extern "C"
