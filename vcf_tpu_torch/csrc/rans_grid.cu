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
// What bounds it: memory traffic, the 4-byte raw grid read once and the
// 1-byte symbols written once (200.5 MB + 50.1 MB at S = 65536, L = 765:
// 0.0749 ms at 3.35 TB/s; 106.5 MB + 26.6 MB on the DWT grid, S = 8704,
// L = 3060: 0.0398 ms).  Each lane is one chain through its state, L
// steps long, and only the lanes run in parallel: on the DWT grid (about
// 2 warps an SM) the chain's latency is the limit.
//
// Design: one thread per lane, the walk over t inside the thread with the
// state in a register, and nothing on the chain but shared memory and
// arithmetic:
// - raw-word tiles staged ahead of the chain: a block copies GRID_TILE
//   steps x its lanes of the (L, S) grid into shared memory with 16-byte
//   cp.async copies, GRID_STAGES stages, so the next tile is in flight
//   while the lanes walk the current one, and no step waits on global
//   memory.  A grid that cannot take 16-byte copies (S % 4 != 0 or a
//   misaligned grid) stages its tiles by plain loads (chosen by shape, as
//   K1's `vec`); then a tile waits one round trip, a step never;
// - a short symbol lookup: per (group[, class]) table row a bucket table,
//   bucket b (slots b << shift ..) -> the largest v with cum[v] <=
//   b << shift, built by the block from the row in shared memory (a
//   binary search a run of GRID_RUN buckets, then a walk).  A slot's
//   symbol lies between the bucket's entry and the next bucket's, so a
//   step reads two bucket bytes and searches only that range: on the
//   DWT grid no lane of a warp searches at 96.6% of its steps.  The
//   8-probe binary search of dependent loads is gone from the chain.  In the context mode the class of the symbol just decoded is
//   looked up while its entry is read;
// - the shift picked at launch (`grid_plan`): the least from 3 to 8 whose
//   tables fit GRID_TABLE_BUDGET (24 KiB), so four 128-lane blocks still
//   share an SM: 8 slots a bucket for order 0 and 4 classes at 3e and on
//   the DWT grid, 32 for 15 classes.  Smaller buckets were faster at
//   every shape until the tables cost blocks an SM;
// - lanes a block picked at launch (the most of 128, 64, 32 that still
//   gives every SM a block), so S = 8704 runs 136 blocks of 64 lanes
//   instead of 68 of 128;
// - the tables of the groups a block spans in shared memory after the
//   tile stages: order 0 a row of 256 packed entries f | cum << 16 (K1's
//   packing, 1 KiB), the context mode n_ctx cumulative rows of 257 u16
//   (the row total last, K3's context layout), each with its bucket row.
//   Blocks that span so many groups that no shift fits the budget (small
//   sg) read the tables from global memory and search all 256 symbols (8
//   probes), as the first design did.  Past 48 KiB in all the launch opts
//   in to more shared memory, and a refused opt-in is an error.
// Stores stay one byte a lane a step, so a warp writes 32 consecutive
// bytes (one sector) a step.
//
// Timed and dropped (grid_ab.py --variants, in turns, H100): 64 slots a
// bucket at every shape (the first form), a full slot -> symbol table
// (one bucket a slot: fewer blocks an SM), the search over all 256
// symbols on the staged tiles, the search with the warp's lanes in step
// (a vote a step), unrolled guarded probes, 16- and 64-step tiles, three
// stages, fewer steps' words read ahead.  What limits it now: the search
// loop itself.  Entered on 3.4% of the DWT grid's warp-steps, its
// presence costs ~2.9x there (timing-only variants without it: 0.25
// against 0.71 ms), and a forward branch or a select in its place costs
// only the second bucket byte's load; no exact loop-free form that fits
// was found.
//
// Checks: a lane whose renormalization flag differs from the grid's emit
// flag at some step, or whose state does not end at RANS_L (the encoder's
// initial state), sets err[0]; the wrapper raises.  The TPU kernels check
// neither.

#include <algorithm>

#include "rans_common.cuh"

namespace vcf {

constexpr int GRID_LANES = 128;    // most lanes (threads) of a block
constexpr int GRID_TILE = 32;      // steps of a staged raw-word tile
constexpr int GRID_STAGES = 2;     // tiles staged at once
constexpr int GRID_UNROLL = 8;     // steps whose words are read ahead
constexpr int GRID_SHIFT_MIN = 3;  // 2^shift slots a bucket: the least
constexpr int GRID_SHIFT_MAX = 8;  //   shift whose tables fit the budget
constexpr int GRID_RUN = 16;       // buckets a thread fills per search
constexpr int GRID_CUM_ROW = 257;  // u16 entries per context-mode row
constexpr size_t GRID_TABLE_BUDGET = 24 * 1024;  // a block's tables
constexpr size_t GRID_SMEM_LIMIT = 48 * 1024;    // past it, the opt-in

// bytes of a bucket row of 2^shift slots a bucket: one byte a bucket, the
// sentinel 255 after the last, padded to 4 bytes
__host__ __device__ constexpr int grid_bucket_row(int shift) {
  return (1 << (K_PROB - shift)) + 4;
}

// bytes of one table row: 256 packed u32 entries or 257 u16 cum entries
template <bool CTX>
__host__ __device__ constexpr int grid_table_row() {
  return CTX ? GRID_CUM_ROW * 2 : 256 * 4;
}

// cum[v] of a table row (v <= 255; the context row also has v = 256)
template <bool CTX>
__device__ __forceinline__ uint32_t cum_at(const void* row, int v) {
  if constexpr (CTX)
    return ((const uint16_t*)row)[v];
  else
    return ((const uint32_t*)row)[v] >> 16;
}

// f and cum of symbol v of a table row
template <bool CTX>
__device__ __forceinline__ void entry_at(const void* row, int v, uint32_t& f,
                                         uint32_t& c) {
  if constexpr (CTX) {
    const uint16_t* r = (const uint16_t*)row;
    c = r[v];
    f = (uint32_t)r[v + 1] - c;
  } else {
    const uint32_t e = ((const uint32_t*)row)[v];
    f = e & 0xFFFFu;
    c = e >> 16;
  }
}

// Stage the raw words of steps [t0, t0 + rows) of the block's lanes
// [s0, s0 + blockDim.x) into buf: row k holds step t0 + k, one word a
// lane.  vec: 16-byte cp.async copies (S % 4 == 0 and a 16-byte aligned
// grid, so a 4-lane chunk lies wholly inside or outside [0, S); chunks
// past S are left unwritten, their lanes never read); else plain loads.
__device__ __forceinline__ void stage_words(int32_t* buf,
                                            const int32_t* __restrict__ raw,
                                            int S, int s0, int t0, int rows,
                                            int vec) {
  const int lanes = blockDim.x;
  if (vec) {
    // a row is lanes / 4 chunks, so one pass of the block covers 4 rows
    const int per_row = lanes / 4;
    const int q = threadIdx.x % per_row;
    const int s = s0 + 4 * q;
    if (s < S) {
      for (int k = threadIdx.x / per_row; k < rows; k += 4)
        cp_async16(buf + k * lanes + 4 * q, raw + (size_t)(t0 + k) * S + s);
    }
  } else {
    const int s = s0 + threadIdx.x;
    if (s < S) {
      for (int k = 0; k < rows; ++k)
        buf[k * lanes + threadIdx.x] = raw[(size_t)(t0 + k) * S + s];
    }
  }
}

// Fill the bucket rows of `rows` table rows (row r at tabs + r * row
// bytes, its bucket row at bkt + r * bucket-row bytes): bucket b holds
// the largest v with cum[v] <= b << shift, the entry after the last 255.
template <bool CTX>
__device__ __forceinline__ void build_buckets(const uint8_t* tabs,
                                              uint8_t* bkt, int rows,
                                              int shift) {
  const int nb = 1 << (K_PROB - shift);  // >= 2^7 > GRID_RUN
  const int runs = nb / GRID_RUN;
  for (int i = threadIdx.x; i < rows * runs; i += blockDim.x) {
    const int r = i / runs;
    const int b0 = (i % runs) * GRID_RUN;
    const void* row = tabs + (size_t)r * grid_table_row<CTX>();
    const uint32_t first = (uint32_t)b0 << shift;
    int v = 0;
#pragma unroll
    for (int step = 128; step >= 1; step >>= 1)
      if (cum_at<CTX>(row, v + step) <= first) v += step;
    uint8_t* out = bkt + r * grid_bucket_row(shift) + b0;
    for (int b = 0; b < GRID_RUN; ++b) {
      const uint32_t slot = (uint32_t)(b0 + b) << shift;
      while (v < 255 && cum_at<CTX>(row, v + 1) <= slot) ++v;
      out[b] = (uint8_t)v;
    }
  }
  for (int r = threadIdx.x; r < rows; r += blockDim.x)
    bkt[r * grid_bucket_row(shift) + nb] = 255;
}

// The symbol of `slot` in a table row: the largest v with cum[v] <= slot.
// SMEM: searched between the slot's bucket entry and the next one (on the
// main path's grids 3-6% of a warp's steps search at all); else over all
// 256 symbols (8 probes).
template <bool CTX, bool SMEM>
__device__ __forceinline__ int find_symbol(const void* row,
                                           const uint8_t* brow,
                                           uint32_t slot, int shift) {
  int v = 0, hi = 255;
  if constexpr (SMEM) {
    const int b = (int)(slot >> shift);
    v = brow[b];
    hi = brow[b + 1];
  }
  while (v < hi) {
    const int mid = (v + hi + 1) >> 1;
    if (cum_at<CTX>(row, mid) <= slot)
      v = mid;
    else
      hi = mid - 1;
  }
  return v;
}

// CTX = false: tab (G, 256) u32 packed f | cum << 16.
// CTX = true: tab (G, n_ctx, 257) u16 cumulative rows, cls_lut (256,) the
// class of each previous symbol.
// SMEM: the tables of the groups the block spans (and their bucket rows)
// in shared memory after the tile stages; else read from global memory.
template <bool CTX, bool SMEM>
__global__ void __launch_bounds__(GRID_LANES)
rans_grid_decode_kernel(const int32_t* __restrict__ raw,      // (L, S)
                        const uint32_t* __restrict__ states,  // (S,)
                        const void* __restrict__ tab,
                        const uint8_t* __restrict__ cls_lut,
                        uint8_t* __restrict__ out,  // (L, S)
                        int32_t* __restrict__ err,  // (1,)
                        int S, int L, int sg, int n_ctx, int shift,
                        int vec) {
  extern __shared__ __align__(16) int32_t s_dyn[];
  __shared__ uint8_t s_lut[CTX ? 256 : 1];
  const int lanes = blockDim.x;
  const int stage = GRID_TILE * lanes;  // words a stage
  const int per_group = CTX ? n_ctx : 1;  // table rows a group
  uint8_t* s_tab = reinterpret_cast<uint8_t*>(s_dyn + GRID_STAGES * stage);
  const int s0 = blockIdx.x * lanes;
  const int s = s0 + threadIdx.x;
  const int g_lo = s0 / sg;
  const int n_rows = ((min(s0 + lanes, S) - 1) / sg - g_lo + 1) * per_group;
  uint8_t* s_bkt = s_tab + (size_t)n_rows * grid_table_row<CTX>();
  // the first tiles go in flight before the tables are read
  const int n_tiles = (L + GRID_TILE - 1) / GRID_TILE;
  for (int j = 0; j < GRID_STAGES - 1; ++j) {
    if (j < n_tiles)
      stage_words(s_dyn + j * stage, raw, S, s0, j * GRID_TILE,
                  min(GRID_TILE, L - j * GRID_TILE), vec);
    cp_async_commit();
  }
  if constexpr (CTX) {
    for (int i = threadIdx.x; i < 256; i += lanes) s_lut[i] = cls_lut[i];
  }
  if constexpr (SMEM) {
    // the groups this block's lanes span, contiguous in the table
    const size_t from = (size_t)g_lo * per_group;
    if constexpr (CTX) {
      const uint16_t* src = (const uint16_t*)tab + from * GRID_CUM_ROW;
      for (int i = threadIdx.x; i < n_rows * GRID_CUM_ROW; i += lanes)
        ((uint16_t*)s_tab)[i] = src[i];
    } else {
      const uint32_t* src = (const uint32_t*)tab + from * 256;
      for (int i = threadIdx.x; i < n_rows * 256; i += lanes)
        ((uint32_t*)s_tab)[i] = src[i];
    }
    __syncthreads();
    build_buckets<CTX>(s_tab, s_bkt, n_rows, shift);
  }
  const bool live = s < S;
  // the lane's group's first row: in shared memory or in the table
  const int gi = SMEM ? min(s, S - 1) / sg - g_lo : min(s, S - 1) / sg;
  const uint8_t* t_grp = SMEM ? s_tab : (const uint8_t*)tab;
  t_grp += (size_t)gi * per_group * grid_table_row<CTX>();
  const int b_row = grid_bucket_row(shift);
  const uint8_t* b_grp = s_bkt + (size_t)(SMEM ? gi : 0) * per_group * b_row;
  uint32_t x = live ? states[s] : RANS_L;
  bool bad = false;
  int cls = 0;
  for (int j = 0; j < n_tiles; ++j) {
    // tile j + STAGES - 1 goes in flight, then tile j must have landed
    const int jn = j + GRID_STAGES - 1;
    if (jn < n_tiles)
      stage_words(s_dyn + (jn % GRID_STAGES) * stage, raw, S, s0,
                  jn * GRID_TILE, min(GRID_TILE, L - jn * GRID_TILE), vec);
    cp_async_commit();
    cp_async_wait<GRID_STAGES - 1>();
    __syncthreads();  // the tile (first time: tables, buckets, LUT) visible
    if (live) {
      if constexpr (CTX) {
        if (j == 0) cls = s_lut[128];  // the symbol before step 0
      }
      const int t0 = j * GRID_TILE;
      const int rows = min(GRID_TILE, L - t0);
      const int32_t* col = s_dyn + (j % GRID_STAGES) * stage + threadIdx.x;
      uint8_t* o = out + (size_t)t0 * S + s;
      // one step of the chain: word w renormalizes, o_t takes the symbol
      auto step = [&](uint32_t w, uint8_t* o_t) {
        const uint8_t* row = t_grp + cls * grid_table_row<CTX>();
        const uint8_t* brow = b_grp + cls * b_row;
        const uint32_t slot = x & PROB_MASK;
        const int v = find_symbol<CTX, SMEM>(row, brow, slot, shift);
        uint32_t f, c;
        entry_at<CTX>(row, v, f, c);
        if constexpr (CTX) cls = s_lut[v];
        x = f * (x >> K_PROB) + slot - c;
        *o_t = (uint8_t)v;
        const bool renorm = x < RANS_L;
        bad |= renorm != ((w >> 16) != 0u);
        if (renorm) x = (x << 16) | (w & 0xFFFFu);
      };
      int k = 0;
      for (; k + GRID_UNROLL <= rows; k += GRID_UNROLL) {
        uint32_t w[GRID_UNROLL];
#pragma unroll
        for (int u = 0; u < GRID_UNROLL; ++u)
          w[u] = (uint32_t)col[(k + u) * lanes];
#pragma unroll
        for (int u = 0; u < GRID_UNROLL; ++u)
          step(w[u], o + (size_t)(k + u) * S);
      }
      for (; k < rows; ++k) step((uint32_t)col[k * lanes], o + (size_t)k * S);
    }
    __syncthreads();  // every lane is done with the stage the next refills
  }
  if (live && (bad || x != RANS_L)) err[0] = 1;
}

// The grid decode's launch shape for S lanes in G groups (n_ctx 0: order
// 0).
struct GridPlan {
  int lanes;         // a block's lanes: the most of 128, 64, 32 that still
                     // gives every SM a block (S = 65536: 128; S = 8704,
                     // the DWT grid: 64)
  bool smem_tables;  // the spanned groups' tables and buckets fit the
                     // budget at some shift (else: global memory)
  int shift;         // 2^shift slots a bucket: the least from 3 to 8 whose
                     // tables fit 24 KiB, so 4 blocks of 128 lanes share
                     // an SM (3e: 3 for order 0 and 4 classes, 5 for 15)
  int tile;          // steps of a staged tile
  size_t smem;       // dynamic shared memory: tile stages (+ tables)
};

int grid_plan(int S, int G, int n_ctx, GridPlan* p) {
  if (S < 1 || G < 1 || S % G || n_ctx < 0) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (err) return err;
  p->lanes = GRID_LANES;
  while (p->lanes > 32 && (S + p->lanes - 1) / p->lanes < sms) p->lanes >>= 1;
  const int sg = S / G;
  // most groups one block spans: its first lane sits at a multiple of
  // `lanes`, so at most gcd(lanes, sg) lanes before a group's end
  int d = p->lanes, e = sg;
  while (e) {
    const int r = d % e;
    d = e;
    e = r;
  }
  const int span = std::min(G, (sg - d + p->lanes - 1) / sg + 1);
  const int rows = span * (n_ctx ? n_ctx : 1);
  const int table = n_ctx ? grid_table_row<true>() : grid_table_row<false>();
  size_t tables = 0;
  for (p->shift = GRID_SHIFT_MIN; p->shift <= GRID_SHIFT_MAX; ++p->shift) {
    tables = (size_t)rows * (table + grid_bucket_row(p->shift));
    if (tables <= GRID_TABLE_BUDGET) break;
  }
  p->smem_tables = p->shift <= GRID_SHIFT_MAX;
  if (!p->smem_tables) p->shift = GRID_SHIFT_MAX;  // unused
  p->tile = GRID_TILE;
  p->smem = (size_t)GRID_STAGES * GRID_TILE * p->lanes * sizeof(int32_t) +
            (p->smem_tables ? tables : 0);
  return 0;
}

template <bool CTX, bool SMEM>
int launch_grid_smem(const void* raw, const void* states, const void* tab,
                     const void* cls_lut, void* out, void* err, int S, int L,
                     int sg, int n_ctx, const GridPlan& p, void* stream) {
  const auto kernel = rans_grid_decode_kernel<CTX, SMEM>;
  if (p.smem > GRID_SMEM_LIMIT) {
    const int e = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (e) return e;
  }
  const int vec = S % 4 == 0 && (uintptr_t)raw % 16 == 0;
  kernel<<<(S + p.lanes - 1) / p.lanes, p.lanes, p.smem,
           (cudaStream_t)stream>>>(
      (const int32_t*)raw, (const uint32_t*)states, tab,
      (const uint8_t*)cls_lut, (uint8_t*)out, (int32_t*)err, S, L, sg, n_ctx,
      p.shift, vec);
  return (int)cudaGetLastError();
}

template <bool CTX>
int launch_grid_decode(const void* raw, const void* states, const void* tab,
                       const void* cls_lut, void* out, void* err, int S,
                       int L, int G, int n_ctx, void* stream) {
  if (L < 0 || (CTX && n_ctx < 1)) return (int)cudaErrorInvalidValue;
  GridPlan p;
  const int e = grid_plan(S, G, CTX ? n_ctx : 0, &p);
  if (e) return e;
  const int sg = S / G;
  if (p.smem_tables)
    return launch_grid_smem<CTX, true>(raw, states, tab, cls_lut, out, err, S,
                                       L, sg, n_ctx, p, stream);
  return launch_grid_smem<CTX, false>(raw, states, tab, cls_lut, out, err, S,
                                      L, sg, n_ctx, p, stream);
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

// The grid decode's plan for S lanes in G groups (n_ctx 0: order 0) into
// out[5]: lanes a block, 1 if the tables are in shared memory, log2 of
// the slots a bucket, steps a tile, dynamic shared memory bytes.  Returns
// a CUDA error or 0.
int vcf_rans_decode_grid_plan(int S, int G, int n_ctx, void* out) {
  vcf::GridPlan p;
  const int err = vcf::grid_plan(S, G, n_ctx, &p);
  if (err) return err;
  int* o = (int*)out;
  o[0] = p.lanes;
  o[1] = p.smem_tables ? 1 : 0;
  o[2] = p.shift;
  o[3] = p.tile;
  o[4] = (int)p.smem;
  return 0;
}

}  // extern "C"
