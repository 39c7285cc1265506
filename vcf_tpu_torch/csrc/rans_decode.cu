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
// step; the symbols themselves are cheap (the routing-free grid decode of
// rans_grid.cu does them in under a millisecond at S = 65536, L = 765).
// Two kernels:
//
// `rans_decode_lookback_kernel`, launched whenever the per-step counts of
// a v2 sidecar are given (every grans/cgrans stream): with them every
// block knows ptr_t = counts[0] + ... + counts[t - 1] itself, and only the
// rank within a step crosses blocks.  One lane per thread, blocks of
// LB_LANES = 128 lanes (512 blocks at S = 65536; 128, 256 and 512 were
// measured on the H100 with lookback_ab.py, and 128 was the fastest),
// state and previous symbol in registers.  Each step every lane resolves its symbol, writes out[t, s]
// and sets its flag x < RANS_L; the block ranks its flags (ballot/popc and
// a sum over its warps in shared memory), publishes its AGGREGATE for
// step t at once, before any word is read, so no block waits on another's
// word loads; then one warp looks back over the step-t descriptors of the
// blocks before it (rans_common.cuh), publishes INCLUSIVE, and each
// renormalizing lane reads words[ptr_t + prefix + rank].  A step costs
// about two dependent L2 round trips: the look-back, then the word load.
// One descriptor per (step, block), an (L, blocks) array: a ring is not
// safe, since block b may run any number of steps ahead of block b + 1,
// which still reads b's older descriptors.  The tables of the groups a
// block's lanes span sit in shared memory (1 KiB a group at order 0, 257
// u16 entries per (group, class) in the context mode: 7.5 KiB a group at
// 15 classes); only blocks that span more groups than fit (small sg) read
// them from global memory.
//
// Errors, as the one-block kernel reports them: the block with the last
// lane sees every step's total in step order (its look-back covers all S
// lanes), so it alone decides: code 1 at the first step whose total
// differs from counts[t]; code 2 at the first step whose counts end past
// n_words (every block stops at that step after publishing, so its total
// is still complete); code 3 if the counts end short of n_words.  No
// block can wait forever on one that left early: only the last block
// leaves on a mismatch, and no block waits on it; on an overrun every
// block leaves at the same step (ptr and counts[t] are the same in all),
// each after it published INCLUSIVE there.  So the abort flag the last
// block sets on an error, polled in every spin, only ends the error path
// early: the other blocks stop at their next wait instead of decoding the
// remaining steps.  No word outside [0, n_words) is ever loaded: on a
// corrupt stream a rank can point past the step's counted words, and such
// a lane keeps its state (the step reports an error anyway).
//
// `rans_decode_kernel`, the first design, for the dense v0 stream of
// RANSCodec, which has no counts: ONE block of 1024 threads carries ptr
// itself, the rank is one block-wide scan per step, and no state crosses
// blocks.  Thread k owns the contiguous lanes [k * P, k * P + P),
// P = ceil(S / 1024), and keeps their states in a global scratch laid out
// so that the threads of a warp touch consecutive words (and, in the
// context mode, their previous symbols in a byte scratch).  One SM does
// all the work: a binary search of 8 shared-memory probes per symbol.
//
// Both have two modes, a template parameter: order 0 (tab (G, 256) u32
// f | cum << 16) and the order-1 context mode `rans_decode_ctx`, which
// replaces vcf_tpu/ops/pallas/rans_ctx.py:pallas_decode_ctx with its XLA
// pre-pass build_windows.  There the table of a lane's step is picked by
// the class of the symbol the lane decoded one step before, cls_lut[prev]
// (prev starts at 128, class 0, as in the encoder), so each lane stays one
// chain and the routing is order 0's.  The context mode keeps only the
// cumulative rows: 257 u16 entries per (group, class), the row's total
// 2^15 last, and f = cum[v + 1] - cum[v].  The one-block kernel holds all
// G groups' rows in shared memory when they fit 200 KiB (G = 64 with 4
// classes: 128.5 KiB), else reads them from global memory (G = 64 with 15
// classes: 482 KiB).  The TPU's class-select and bucket matmuls are gone.

#include <algorithm>

#include "rans_common.cuh"

namespace vcf {

constexpr int DEC_THREADS = 1024;
constexpr int DEC_SCRATCH_INTS = 64;  // scan scratch ahead of the tables
constexpr int DEC_LUT_INTS = 64;      // the context mode's 256-byte class LUT
constexpr size_t DEC_SMEM_MAX = 200 * 1024;
constexpr int CUM_ROW = 257;          // u16 entries per context-mode row
constexpr int LB_LANES = 128;         // lanes (threads) of a look-back block
constexpr int LB_WARPS = LB_LANES / 32;
constexpr size_t LB_SMEM_LIMIT = 48 * 1024;

enum DecodeError : int {
  kOk = 0,
  kCountMismatch = 1,  // step total differs from the counts sidecar
  kOverrun = 2,        // a step would read past the last word
  kUnderrun = 3,       // words left over after the last step
};

// The symbol of slot in its table (largest v with cum[v] <= slot; cum[0]
// = 0, never passes 255) and the state after it.  CTX: `t` points at the
// lane's (group, class) row of 257 u16; else at its group's 256 packed u32.
template <bool CTX>
__device__ __forceinline__ int resolve(const void* t, uint32_t& x) {
  const uint32_t slot = x & PROB_MASK;
  int v = 0;
  if constexpr (CTX) {
    const uint16_t* row = (const uint16_t*)t;
#pragma unroll
    for (int step = 128; step >= 1; step >>= 1)
      if (row[v + step] <= slot) v += step;
    const uint32_t cum = row[v];
    x = ((uint32_t)row[v + 1] - cum) * (x >> K_PROB) + slot - cum;
  } else {
    const uint32_t* tg = (const uint32_t*)t;
#pragma unroll
    for (int step = 128; step >= 1; step >>= 1)
      if ((tg[v + step] >> 16) <= slot) v += step;
    const uint32_t e = tg[v];
    x = (e & 0xFFFFu) * (x >> K_PROB) + slot - (e >> 16);
  }
  return v;
}

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
                   uint8_t* __restrict__ out,  // (L, S)
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
      int v;
      if constexpr (CTX) {
        const uint8_t pv = prev[j * nt + threadIdx.x];
        v = resolve<true>((const uint16_t*)T +
                              ((size_t)(s / sg) * n_ctx + s_lut[pv]) * CUM_ROW,
                          x);
        prev[j * nt + threadIdx.x] = (uint8_t)v;
      } else {
        v = resolve<false>((const uint32_t*)T + (s / sg) * 256, x);
      }
      out[(size_t)t * S + s] = (uint8_t)v;
      cnt += x < RANS_L;
      xs[j * nt + threadIdx.x] = x;
    }
    int total;
    long long p = ptr + block_exclusive_scan(cnt, &total, scratch);
    // total is the same in every thread, so every thread leaves together
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

// CTX and tab as rans_decode_kernel; desc the (L, gridDim.x) descriptors
// and hdr[0] the ticket, hdr[1] the abort flag, all zeroed before launch.
template <bool CTX>
__global__ void __launch_bounds__(LB_LANES)
rans_decode_lookback_kernel(const uint16_t* __restrict__ words,
                            long long n_words,
                            const uint32_t* __restrict__ states_in,  // (S,)
                            const void* __restrict__ tab,
                            const uint8_t* __restrict__ cls_lut, int use_smem,
                            const int32_t* __restrict__ counts,  // (L,)
                            uint8_t* __restrict__ out,           // (L, S)
                            int32_t* __restrict__ err,  // (2,): code, step
                            unsigned long long* __restrict__ desc,
                            int* __restrict__ hdr, int S, int L, int sg,
                            int n_ctx) {
  extern __shared__ uint32_t s_tab[];
  __shared__ uint8_t s_lut[CTX ? 256 : 1];
  __shared__ int s_warp[LB_WARPS];  // renormalizing lanes per warp
  __shared__ long long s_prefix;
  __shared__ int s_code;
  __shared__ int s_vb;
  const int nb = gridDim.x;
  const int vb = lb_ticket(&hdr[0], &s_vb);
  const int s0 = vb * LB_LANES;
  const int s = s0 + threadIdx.x;
  const bool live = s < S;
  // table entries per group: u16 rows (CTX) or u32 entries
  const int per_group = CTX ? n_ctx * CUM_ROW : 256;
  if (use_smem && s0 < S) {
    // the groups this block's lanes span, contiguous in the table
    const int g_lo = s0 / sg;
    const int n =
        ((min(s0 + LB_LANES, S) - 1) / sg - g_lo + 1) * per_group;
    const size_t from = (size_t)g_lo * per_group;
    for (int i = threadIdx.x; i < n; i += LB_LANES) {
      if constexpr (CTX)
        ((uint16_t*)s_tab)[i] = ((const uint16_t*)tab)[from + i];
      else
        s_tab[i] = ((const uint32_t*)tab)[from + i];
    }
  }
  if constexpr (CTX) {
    for (int i = threadIdx.x; i < 256; i += LB_LANES) s_lut[i] = cls_lut[i];
  }
  if (threadIdx.x == 0) s_code = kOk;
  __syncthreads();
  const int gi = live ? (use_smem ? s / sg - s0 / sg : s / sg) : 0;
  const void* T = use_smem ? (const void*)s_tab : tab;
  uint32_t x = live ? states_in[s] : 0u;
  uint32_t pv = 128;  // CTX: the symbol before step 0 has class 0
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t below_me = (1u << lane) - 1u;
  const bool last = vb == nb - 1;
  long long ptr = 0;  // counts[0] + ... + counts[t - 1]
  int t = 0;
  int cnt_next = L > 0 ? counts[0] : 0;
  for (; t < L; ++t) {
    const int cnt = cnt_next;
    if (t + 1 < L) cnt_next = counts[t + 1];
    bool renorm = false;
    if (live) {
      int v;
      if constexpr (CTX) {
        v = resolve<true>((const uint16_t*)T +
                              ((size_t)gi * n_ctx + s_lut[pv]) * CUM_ROW,
                          x);
        pv = (uint32_t)v;
      } else {
        v = resolve<false>((const uint32_t*)T + (size_t)gi * 256, x);
      }
      out[(size_t)t * S + s] = (uint8_t)v;
      renorm = x < RANS_L;
    }
    const uint32_t ballot = __ballot_sync(0xffffffffu, renorm);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int below = 0, total = 0;
#pragma unroll
    for (int w = 0; w < LB_WARPS; ++w) {
      const int c = s_warp[w];
      below += w < warp ? c : 0;
      total += c;
    }
    // this step's counted words end past the stream: every block stops
    // here after publishing, so the last block still sees a full total
    const bool overrun = ptr + cnt > n_words;
    if (warp == 0) {
      const long long excl =
          lb_scan(desc + (size_t)t * nb, vb, (uint32_t)total, &hdr[1]);
      if (lane == 0) {
        s_prefix = excl;
        const bool mismatch = excl + total != cnt;
        if (last && (mismatch || overrun)) {
          s_code = mismatch ? kCountMismatch : kOverrun;
          atomicExch(&hdr[1], 1);
        }
      }
    }
    __syncthreads();
    const long long prefix = s_prefix;
    if (prefix < 0 || s_code != kOk || overrun) break;
    if (renorm) {
      const long long at = ptr + prefix + below + __popc(ballot & below_me);
      if ((unsigned long long)at < (unsigned long long)n_words)
        x = (x << 16) | words[at];
    }
    ptr += cnt;
  }
  if (last && threadIdx.x == 0) {
    int code = s_code;
    if (code == kOk && ptr != n_words) code = kUnderrun;
    if (code != kOk) {
      err[0] = code;
      err[1] = t;
    }
  }
}

// Shared-memory bytes of the one-block kernel's tables, and whether they
// fit.
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
                  void* out, void* err, int S, int L, int G, int n_ctx,
                  void* stream) {
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
      (uint8_t*)out, (int32_t*)err, S, L, S / G, G, n_ctx);
  return (int)cudaGetLastError();
}

// Shared-memory bytes of the tables a look-back block needs: the groups
// its LB_LANES consecutive lanes can span.  n_ctx = 0 is order 0.
inline size_t lookback_table_bytes(int S, int G, int n_ctx) {
  const int sg = std::max(S / G, 1);
  const int span = std::min(G, (LB_LANES + sg - 1) / sg + 1);
  return (size_t)span * (n_ctx ? (size_t)n_ctx * CUM_ROW * 2 : 1024);
}

int launch_lookback(const void* words, long long n_words, const void* states,
                    const void* tab, const void* cls_lut, const void* counts,
                    void* out, void* err, void* scratch, int S, int L, int G,
                    int n_ctx, void* stream) {
  if (G < 1 || S < 0 || L < 0 || S % G) return (int)cudaErrorInvalidValue;
  const int blocks = std::max(1, (S + LB_LANES - 1) / LB_LANES);
  cudaStream_t st = (cudaStream_t)stream;
  // scratch: (L, blocks) descriptors, then the ticket and the abort flag
  unsigned long long* desc = (unsigned long long*)scratch;
  int* hdr = (int*)(desc + (size_t)L * blocks);
  int rc = (int)cudaMemsetAsync(
      scratch, 0, (size_t)L * blocks * sizeof(unsigned long long) +
                      2 * sizeof(int), st);
  if (rc) return rc;
  const size_t smem = lookback_table_bytes(S, G, n_ctx);
  const int use_smem = smem <= LB_SMEM_LIMIT;
  const size_t dyn = use_smem ? smem : 0;
  if (n_ctx) {
    rans_decode_lookback_kernel<true><<<blocks, LB_LANES, dyn, st>>>(
        (const uint16_t*)words, n_words, (const uint32_t*)states, tab,
        (const uint8_t*)cls_lut, use_smem, (const int32_t*)counts,
        (uint8_t*)out, (int32_t*)err, desc, hdr, S, L, S / G, n_ctx);
  } else {
    rans_decode_lookback_kernel<false><<<blocks, LB_LANES, dyn, st>>>(
        (const uint16_t*)words, n_words, (const uint32_t*)states, tab,
        nullptr, use_smem, (const int32_t*)counts, (uint8_t*)out,
        (int32_t*)err, desc, hdr, S, L, S / G, 1);
  }
  return (int)cudaGetLastError();
}

}  // namespace vcf

extern "C" {

int vcf_rans_decode_threads(void) { return vcf::DEC_THREADS; }

// The one-block kernel (no counts): words (n_words,) u16; states (S,)
// u32; xs scratch of ceil(S / threads) * threads u32; tab (G, 256) packed
// f | cum << 16; out (L, S) u8; err (2,) i32 zeroed by the caller.
// Returns the first CUDA error of the attribute call or launch.
int vcf_rans_decode_grouped(const void* words, long long n_words,
                            const void* states, void* xs, const void* tab,
                            void* out, void* err, int S, int L, int G,
                            void* stream) {
  return vcf::launch_decode<false>(words, n_words, states, xs, nullptr, tab,
                                   nullptr, out, err, S, L, G, 1, stream);
}

// 1 when the one-block context mode keeps the (G, n_ctx, 257) rows in
// shared memory, 0 when it reads them from global memory.
int vcf_rans_decode_ctx_smem(int G, int n_ctx) {
  return vcf::tables_fit(G, n_ctx, true) ? 1 : 0;
}

// The one-block context mode: prev a u8 scratch of the size of xs; tab
// (G, n_ctx, 257) u16 cumulative rows (row total last); cls_lut (256,) u8
// classes in [0, n_ctx); the rest as vcf_rans_decode_grouped.
int vcf_rans_decode_ctx(const void* words, long long n_words,
                        const void* states, void* xs, void* prev,
                        const void* tab, const void* cls_lut, void* out,
                        void* err, int S, int L, int G, int n_ctx,
                        void* stream) {
  return vcf::launch_decode<true>(words, n_words, states, xs, prev, tab,
                                  cls_lut, out, err, S, L, G, n_ctx, stream);
}

// Lanes (threads) of a look-back block.
int vcf_rans_decode_lookback_lanes(void) { return vcf::LB_LANES; }

// 1 when a look-back block keeps its groups' tables in shared memory, 0
// when it reads them from global memory (n_ctx = 0: order 0).
int vcf_rans_decode_lookback_smem(int S, int G, int n_ctx) {
  if (G < 1) return 0;
  return vcf::lookback_table_bytes(S, G, n_ctx) <= vcf::LB_SMEM_LIMIT;
}

// The look-back kernel (counts given), both modes: n_ctx = 0 is order 0
// (tab (G, 256) packed, cls_lut unused), else the context mode (tab and
// cls_lut as vcf_rans_decode_ctx).  counts (L,) i32; scratch of
// L * ceil(S / vcf_rans_decode_lookback_lanes()) u64 then 2 i32, zeroed
// here by one memset on the stream.  words, states, out, err
// as vcf_rans_decode_grouped.  Returns the first CUDA error of the memset or
// launch.
int vcf_rans_decode_lookback(const void* words, long long n_words,
                             const void* states, const void* tab,
                             const void* cls_lut, const void* counts,
                             void* out, void* err, void* scratch, int S,
                             int L, int G, int n_ctx, void* stream) {
  return vcf::launch_lookback(words, n_words, states, tab, cls_lut, counts,
                              out, err, scratch, S, L, G, n_ctx, stream);
}

}  // extern "C"
