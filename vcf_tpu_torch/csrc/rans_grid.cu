// The routing-free grid decode: `rans_decode_grouped_grid` (order 0) and
// `rans_decode_ctx_grid` (order-1 context), one kernel with two modes.
//
// Replaces vcf_tpu/ops/pallas/rans_decode.py:pallas_decode_grouped_grid
// and vcf_tpu/ops/pallas/rans_ctx.py:pallas_decode_ctx_grid.  Both decode
// straight from the encoder's raw (L, S) grid of (emit << 16) | low16
// (K1's output).  The decoder's renormalization flag at step t equals the
// encoder's emit flag at step t, lane for lane, so lane s reads
// raw[t, s] & 0xFFFF and nothing else: no rank, no stream pointer, no
// dependency between lanes.  That is what K3 cannot have: its word at
// step t sits at a rank over all S lanes, which ties it to one block.
//
// Design: one thread per lane, many blocks, the walk over t inside the
// thread with the state in a register.  At step t a warp reads and writes
// 32 consecutive lanes, so the raw words come in coalesced and the
// symbols of the (L, S) output go out coalesced; the raw word of a step
// does not depend on the state, so its load is issued ahead of the symbol
// search.  A block's lanes span one group, or two where a group boundary
// falls inside the block (sg not a multiple of the block size), and the
// block keeps the tables of the groups it spans in shared memory: 1 KiB a
// group for order 0 (256 entries f | cum << 16, K1's packing), and for
// the context mode the group's n_ctx cumulative rows of 257 u16 (the row
// total last, K3's context layout): 2 KiB a group at 4 classes, 7.5 KiB
// at 15, so unlike K3's context mode the tables stay in shared memory at
// G = 64 with 15 classes too.  Only blocks that span more groups than fit
// 48 KiB (small sg) read the tables from global memory.  The symbol is
// found by an 8-probe binary search of the cumulative entries, as in K3.
// In the context mode the lane's previous symbol stays in a register,
// 128 (class 0) before step 0, and picks the row through the 256-byte
// class lookup table.
//
// What bounds it: memory traffic, the 4-byte raw grid read once and the
// 1-byte symbols written once (200.5 MB + 50.1 MB at S = 65536,
// L = 765).  The chain through the state is 765 steps long per lane;
// with 65536 lanes the card holds about 16 warps per SM, so the walk is
// latency bound unless the loads run ahead of the search.
//
// Checks: a lane whose renormalization flag differs from the grid's emit
// flag at some step, or whose state does not end at RANS_L (the encoder's
// initial state), sets err[0]; the wrapper raises.  The TPU kernels check
// neither.

#include <algorithm>

#include "rans_common.cuh"

namespace vcf {

constexpr int GRID_THREADS = 128;
constexpr size_t GRID_SMEM_LIMIT = 48 * 1024;
constexpr int GRID_CUM_ROW = 257;  // u16 entries per context-mode row

// CTX = false: tab (G, 256) u32 packed f | cum << 16.
// CTX = true: tab (G, n_ctx, 257) u16 cumulative rows, cls_lut (256,) the
// class of each previous symbol.
template <bool CTX>
__global__ void __launch_bounds__(GRID_THREADS)
rans_grid_decode_kernel(const int32_t* __restrict__ raw,      // (L, S)
                        const uint32_t* __restrict__ states,  // (S,)
                        const void* __restrict__ tab,
                        const uint8_t* __restrict__ cls_lut,
                        uint8_t* __restrict__ out,  // (L, S)
                        int32_t* __restrict__ err,  // (1,)
                        int S, int L, int sg, int n_ctx, int use_smem) {
  extern __shared__ uint32_t s_tab[];
  __shared__ uint8_t s_lut[CTX ? 256 : 1];
  // table entries per group: u16 rows (CTX) or u32 entries
  const int per_group = CTX ? n_ctx * GRID_CUM_ROW : 256;
  const int s0 = blockIdx.x * blockDim.x;
  const int g_lo = s0 / sg;
  if (use_smem) {
    const int g_hi = (min(s0 + (int)blockDim.x, S) - 1) / sg;
    const int n = (g_hi - g_lo + 1) * per_group;
    const size_t from = (size_t)g_lo * per_group;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      if constexpr (CTX)
        ((uint16_t*)s_tab)[i] = ((const uint16_t*)tab)[from + i];
      else
        s_tab[i] = ((const uint32_t*)tab)[from + i];
    }
  }
  if constexpr (CTX) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) s_lut[i] = cls_lut[i];
  }
  __syncthreads();
  const int s = s0 + threadIdx.x;
  if (s >= S) return;
  const int gi = use_smem ? s / sg - g_lo : s / sg;
  const void* T = use_smem ? (const void*)s_tab : tab;
  uint32_t x = states[s];
  uint32_t prev = 128;  // CTX: the symbol before step 0 has class 0
  bool bad = false;
  uint32_t word = L > 0 ? (uint32_t)raw[s] : 0u;
  for (int t = 0; t < L; ++t) {
    const size_t at = (size_t)t * S + s;
    const uint32_t next = t + 1 < L ? (uint32_t)raw[at + S] : 0u;
    const uint32_t slot = x & PROB_MASK;
    // largest v with cum[v] <= slot (cum[0] = 0; never passes 255)
    int v = 0;
    if constexpr (CTX) {
      const uint16_t* row = (const uint16_t*)T +
          ((size_t)gi * n_ctx + s_lut[prev]) * GRID_CUM_ROW;
#pragma unroll
      for (int step = 128; step >= 1; step >>= 1)
        if (row[v + step] <= slot) v += step;
      const uint32_t cum = row[v];
      x = ((uint32_t)row[v + 1] - cum) * (x >> K_PROB) + slot - cum;
      prev = (uint32_t)v;
    } else {
      const uint32_t* tg = (const uint32_t*)T + (size_t)gi * 256;
#pragma unroll
      for (int step = 128; step >= 1; step >>= 1)
        if ((tg[v + step] >> 16) <= slot) v += step;
      const uint32_t e = tg[v];
      x = (e & 0xFFFFu) * (x >> K_PROB) + slot - (e >> 16);
    }
    out[at] = (uint8_t)v;
    const bool renorm = x < RANS_L;
    bad |= renorm != ((word >> 16) != 0u);
    if (renorm) x = (x << 16) | (word & 0xFFFFu);
    word = next;
  }
  if (bad || x != RANS_L) err[0] = 1;
}

template <bool CTX>
int launch_grid_decode(const void* raw, const void* states, const void* tab,
                       const void* cls_lut, void* out, void* err, int S,
                       int L, int G, int n_ctx, void* stream) {
  if (G < 1 || S % G || (CTX && n_ctx < 1)) return (int)cudaErrorInvalidValue;
  const int sg = S / G;
  const int blocks = (S + GRID_THREADS - 1) / GRID_THREADS;
  // the most groups one block's GRID_THREADS consecutive lanes can span
  const int span = std::min(G, (GRID_THREADS + sg - 1) / sg + 1);
  const size_t smem = (size_t)span * (CTX ? n_ctx * GRID_CUM_ROW * 2 : 1024);
  const int use_smem = smem <= GRID_SMEM_LIMIT;
  rans_grid_decode_kernel<CTX><<<blocks, GRID_THREADS, use_smem ? smem : 0,
                                 (cudaStream_t)stream>>>(
      (const int32_t*)raw, (const uint32_t*)states, tab,
      (const uint8_t*)cls_lut, (uint8_t*)out, (int32_t*)err, S, L, sg, n_ctx,
      use_smem);
  return (int)cudaGetLastError();
}

}  // namespace vcf

extern "C" {

// raw (L, S) i32 grid from K1; states (S,) u32; tab (G, 256) packed
// f | cum << 16; out (L, S) u8; err (1,) i32 zeroed by the caller.
// Returns cudaGetLastError() after the launch.
int vcf_rans_decode_grid(const void* raw, const void* states, const void* tab,
                         void* out, void* err, int S, int L, int G,
                         void* stream) {
  return vcf::launch_grid_decode<false>(raw, states, tab, nullptr, out, err,
                                        S, L, G, 1, stream);
}

// The context mode: tab (G, n_ctx, 257) u16 cumulative rows (row total
// last); cls_lut (256,) u8 classes in [0, n_ctx); the rest as above.
int vcf_rans_decode_ctx_grid(const void* raw, const void* states,
                             const void* tab, const void* cls_lut, void* out,
                             void* err, int S, int L, int G, int n_ctx,
                             void* stream) {
  return vcf::launch_grid_decode<true>(raw, states, tab, cls_lut, out, err, S,
                                       L, G, n_ctx, stream);
}

}  // extern "C"
