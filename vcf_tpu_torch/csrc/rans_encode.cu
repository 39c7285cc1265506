// K1 rans_encode_grouped and K2 rans_compact: the grouped interleaved
// rANS encoder as two passes, the same split as the TPU library path.
//
// K1 replaces vcf_tpu/ops/pallas/rans_encode.py:pallas_encode_grouped_raw
// and, given the transposed view of (L, S) lanes (its (L, S) copy is
// then no copy), pallas_encode_grouped_raw_u8.
// One thread per lane walks its L symbols newest first and writes the raw
// grid word (emit << 16) | (x & 0xFFFF) of decode step t, plus the final
// state.  What bounds it: the per-lane dependency chain through the state
// (a 32-bit division per symbol) and 5 bytes of memory traffic per
// symbol.  The design keeps the state in a register, reads symbols from
// an (L, S) copy so a warp's per-step loads and stores are contiguous,
// and keeps the block's tables in shared memory.  The TPU kernel's bf16
// byte-split table fetch and f32 reciprocal with correction rounds are
// gone: Hopper has exact integer division and per-thread table loads.
//
// K1 has two modes, a template parameter: order 0 (above) and the order-1
// context mode `rans_encode_ctx`, which replaces
// vcf_tpu/ops/pallas/rans_ctx.py:pallas_encode_ctx_raw and
// pallas_encode_ctx_raw_u8 (one output, two TPU input layouts).  In the
// context mode each group has n_ctx tables of 256 entries, and the table
// of symbol t is picked by the class of the lane's previous symbol,
// cls_lut[syms[t - 1]] (a 256-entry lookup table covers 4 and 15
// classes alike); symbol 0 takes the class of 128, which is class 0.  The
// walk from t = L - 1 down loads each symbol once: the symbol read as the
// previous one at step t is the symbol of step t - 1.  The TPU's
// byte-split bf16 (class x hi-nibble) matmul fetch and its 2-bit packed
// class plane are gone: the class is one shared-memory byte lookup.  A
// block's groups keep their n_ctx tables in shared memory (8 KiB at 4
// classes, 30 KiB at 15, for the two groups a 128-lane block can touch);
// small sg, whose blocks span many groups, reads the tables from global
// memory (use_smem = 0), as order 0 does.
//
// K2 replaces vcf_tpu/ops/pallas/rans_encode.py:finish_stream_pallas.
// It is a stream compaction of the (L, S) raw grid, row-major over the
// flagged entries, into the wire words.  What bounds it: memory traffic
// (it reads the 4-byte grid twice and writes 2 bytes per word).  The
// design is three kernels: per-tile flag counts, one block that scans the
// tile counts, and a scatter in which each tile recomputes its flags and
// places its words with a block-wide scan.  It replaces the TPU's
// butterfly compaction per chunk plus stitch scan.  CUDA and not Triton:
// the scatter carries a running offset through the rounds of a tile and
// ranks each round with a shuffle scan over the block, and the middle
// pass is a single-block scan that leaves the total on the device.  Both
// are direct in CUDA; Triton's block model has no ordered scan across
// programs, so it would need the same three launches with less control
// over the order of the writes.
//
// K2 has a row mode, `rans_compact_rows`: K1 followed by it is
// `rans_encode_rows`, which replaces the compacting encodes
// vcf_tpu/ops/pallas/rans_encode.py:pallas_encode_grouped and
// pallas_encode_grouped_u8 (one output, two TPU input layouts).  Row t
// of the output holds the words that decode step t reads, in lane order,
// as a prefix; the rest of the row is left unwritten (the TPU kernels
// leave it unspecified too), and counts[t] is the prefix length.  The prefix is per
// row, so one block owns a row and carries its running offset through
// rounds of blockDim lanes, each ranked by a block scan: no offset
// crosses blocks, and one launch does it.  The TPU's per-step in-kernel
// compaction (matmul ranks, carry-hi packing) is not carried over: the
// per-step prefix across all S lanes is a grid-wide dependency that K1's
// one-thread-per-lane walk cannot carry, so it stays a second pass.
// What bounds it: memory traffic, the 4-byte grid read once and the
// 2-byte words and the counts written once.

#include <algorithm>

#include "rans_common.cuh"

namespace vcf {

constexpr int ENC_THREADS = 128;
constexpr int CMP_THREADS = 256;
constexpr int CMP_ROUNDS = 16;
constexpr int CMP_TILE = CMP_THREADS * CMP_ROUNDS;  // grid entries per block
constexpr int SCAN_THREADS = 1024;
constexpr int ROW_THREADS = 1024;
constexpr int STATIC_SMEM_LIMIT = 48 * 1024;

// CTX = false: order 0, tab (G, 256).  CTX = true: the context mode, tab
// (G, n_ctx, 256) and cls_lut (256,) the class of each previous symbol.
template <bool CTX>
__global__ void __launch_bounds__(ENC_THREADS)
rans_encode_kernel(const uint8_t* __restrict__ syms,     // (L, S)
                   const uint32_t* __restrict__ tab,     // (G, rows)
                   const uint8_t* __restrict__ cls_lut,  // (256,), CTX only
                   int32_t* __restrict__ raw,            // (L, S)
                   uint32_t* __restrict__ states,        // (S,)
                   int S, int L, int sg, int n_ctx, int use_smem) {
  extern __shared__ uint32_t s_tab[];
  __shared__ uint8_t s_lut[CTX ? 256 : 1];
  const int rows = CTX ? n_ctx * 256 : 256;  // table entries per group
  const int s0 = blockIdx.x * blockDim.x;
  const int s = s0 + threadIdx.x;
  const int g_lo = s0 / sg;
  if constexpr (CTX) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) s_lut[i] = cls_lut[i];
  }
  if (use_smem) {
    // the groups this block's lanes span, contiguous in the table
    const int g_hi = (min(s0 + (int)blockDim.x, S) - 1) / sg;
    const int n = (g_hi - g_lo + 1) * rows;
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      s_tab[i] = tab[(size_t)g_lo * rows + i];
  }
  __syncthreads();
  if (s >= S) return;
  const uint32_t* t_grp =
      use_smem ? s_tab + (s / sg - g_lo) * rows : tab + (size_t)(s / sg) * rows;
  uint32_t x = RANS_L;
  // CTX: the symbol of step t, loaded at step t + 1 as its previous one
  uint32_t cur = (CTX && L > 0) ? syms[(size_t)(L - 1) * S + s] : 0u;
  for (int t = L - 1; t >= 0; --t) {
    const size_t at = (size_t)t * S + s;
    uint32_t e;
    if constexpr (CTX) {
      const uint32_t prev = t > 0 ? syms[at - S] : 128u;
      e = t_grp[s_lut[prev] * 256u + cur];
      cur = prev;
    } else {
      e = t_grp[syms[at]];
    }
    const uint32_t f = e & 0xFFFFu;
    const uint32_t cum = e >> 16;
    const uint32_t emit = (x >> SHIFT_EMIT) >= f ? 1u : 0u;
    const uint32_t low = x & 0xFFFFu;
    if (emit) x >>= 16;
    x = ((x / f) << K_PROB) + (x % f) + cum;
    raw[at] = (int32_t)(low | (emit << 16));
  }
  states[s] = x;
}

__global__ void __launch_bounds__(CMP_THREADS)
compact_count_kernel(const int32_t* __restrict__ raw, long long n,
                     int32_t* __restrict__ tile_counts) {
  __shared__ int scratch[33];
  const long long base = (long long)blockIdx.x * CMP_TILE;
  int c = 0;
  for (int r = 0; r < CMP_ROUNDS; ++r) {
    const long long i = base + (long long)r * CMP_THREADS + threadIdx.x;
    if (i < n) c += (raw[i] >> 16) != 0;
  }
  int total;
  block_exclusive_scan(c, &total, scratch);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = total;
}

__global__ void __launch_bounds__(SCAN_THREADS)
compact_scan_kernel(const int32_t* __restrict__ tile_counts, int n_tiles,
                    int32_t* __restrict__ tile_offsets,
                    int32_t* __restrict__ n_words) {
  __shared__ int scratch[33];
  const int per = (n_tiles + blockDim.x - 1) / blockDim.x;
  const int lo = min((int)threadIdx.x * per, n_tiles);
  const int hi = min(lo + per, n_tiles);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += tile_counts[i];
  int total;
  int run = block_exclusive_scan(sum, &total, scratch);
  for (int i = lo; i < hi; ++i) {
    tile_offsets[i] = run;
    run += tile_counts[i];
  }
  if (threadIdx.x == 0) *n_words = total;
}

__global__ void __launch_bounds__(CMP_THREADS)
compact_scatter_kernel(const int32_t* __restrict__ raw, long long n,
                       const int32_t* __restrict__ tile_offsets,
                       uint16_t* __restrict__ words) {
  __shared__ int scratch[33];
  const long long base = (long long)blockIdx.x * CMP_TILE;
  int run = tile_offsets[blockIdx.x];
  for (int r = 0; r < CMP_ROUNDS; ++r) {
    const long long i = base + (long long)r * CMP_THREADS + threadIdx.x;
    const int32_t v = i < n ? raw[i] : 0;
    const int flag = (v >> 16) != 0;
    int total;
    const int rank = block_exclusive_scan(flag, &total, scratch);
    if (flag) words[run + rank] = (uint16_t)(v & 0xFFFF);
    run += total;
  }
}

// One block per row t of the (L, S) raw grid.
__global__ void __launch_bounds__(ROW_THREADS)
compact_rows_kernel(const int32_t* __restrict__ raw, int S,
                    uint16_t* __restrict__ rows,
                    int32_t* __restrict__ counts) {
  __shared__ int scratch[33];
  const size_t base = (size_t)blockIdx.x * S;
  int run = 0;
  for (int s0 = 0; s0 < S; s0 += blockDim.x) {
    const int s = s0 + threadIdx.x;
    const int32_t v = s < S ? raw[base + s] : 0;
    const int flag = (v >> 16) != 0;
    int total;
    const int rank = block_exclusive_scan(flag, &total, scratch);
    if (flag) rows[base + run + rank] = (uint16_t)(v & 0xFFFF);
    run += total;
  }
  if (threadIdx.x == 0) counts[blockIdx.x] = run;
}

template <bool CTX>
int launch_encode(const void* syms, const void* tab, const void* cls_lut,
                  void* raw, void* states, int S, int L, int G, int n_ctx,
                  void* stream) {
  const int sg = S / G;
  const int blocks = (S + ENC_THREADS - 1) / ENC_THREADS;
  // most groups one block can span: its lanes cover ENC_THREADS
  // consecutive lanes, which touch at most this many groups of sg lanes
  const int span = std::min(G, (ENC_THREADS + sg - 1) / sg + 1);
  const size_t smem = (size_t)span * (CTX ? n_ctx : 1) * 256 * sizeof(uint32_t);
  const int use_smem = smem <= (size_t)STATIC_SMEM_LIMIT;
  rans_encode_kernel<CTX><<<blocks, ENC_THREADS, use_smem ? smem : 0,
                            (cudaStream_t)stream>>>(
      (const uint8_t*)syms, (const uint32_t*)tab, (const uint8_t*)cls_lut,
      (int32_t*)raw, (uint32_t*)states, S, L, sg, n_ctx, use_smem);
  return (int)cudaGetLastError();
}

}  // namespace vcf

extern "C" {

// syms (L, S) u8, tab (G, 256) packed f | cum << 16, raw (L, S) i32 out,
// states (S,) u32 out.  Returns cudaGetLastError() after the launch.
int vcf_rans_encode_grouped(const void* syms, const void* tab, void* raw,
                            void* states, int S, int L, int G,
                            void* stream) {
  return vcf::launch_encode<false>(syms, tab, nullptr, raw, states, S, L, G,
                                   1, stream);
}

// The context mode: tab (G, n_ctx, 256) packed f | cum << 16, cls_lut
// (256,) u8 classes in [0, n_ctx); the rest as vcf_rans_encode_grouped.
int vcf_rans_encode_ctx(const void* syms, const void* tab,
                        const void* cls_lut, void* raw, void* states, int S,
                        int L, int G, int n_ctx, void* stream) {
  return vcf::launch_encode<true>(syms, tab, cls_lut, raw, states, S, L, G,
                                  n_ctx, stream);
}

int vcf_rans_compact_tile(void) { return vcf::CMP_TILE; }

// K2's row mode: raw (L, S) i32 grid -> rows (L, S) u16 (each row's
// flagged words as a prefix, the tail unwritten) and counts (L,) i32.
int vcf_rans_compact_rows(const void* raw, int S, int L, void* rows,
                          void* counts, void* stream) {
  if (S < 1 || L < 1) return (int)cudaErrorInvalidValue;
  vcf::compact_rows_kernel<<<L, vcf::ROW_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)raw, S, (uint16_t*)rows, (int32_t*)counts);
  return (int)cudaGetLastError();
}

// raw (n,) i32 grid in decode order; tile_counts/tile_offsets scratch of
// ceil(n / tile) i32; words (n,) u16 out (valid prefix), n_words (1,) i32.
int vcf_rans_compact(const void* raw, long long n, void* tile_counts,
                     void* tile_offsets, void* words, void* n_words,
                     void* stream) {
  const int n_tiles = (int)((n + vcf::CMP_TILE - 1) / vcf::CMP_TILE);
  cudaStream_t st = (cudaStream_t)stream;
  vcf::compact_count_kernel<<<n_tiles, vcf::CMP_THREADS, 0, st>>>(
      (const int32_t*)raw, n, (int32_t*)tile_counts);
  int err = (int)cudaGetLastError();
  if (err) return err;
  vcf::compact_scan_kernel<<<1, vcf::SCAN_THREADS, 0, st>>>(
      (const int32_t*)tile_counts, n_tiles, (int32_t*)tile_offsets,
      (int32_t*)n_words);
  err = (int)cudaGetLastError();
  if (err) return err;
  vcf::compact_scatter_kernel<<<n_tiles, vcf::CMP_THREADS, 0, st>>>(
      (const int32_t*)raw, n, (const int32_t*)tile_offsets,
      (uint16_t*)words);
  return (int)cudaGetLastError();
}

}  // extern "C"
