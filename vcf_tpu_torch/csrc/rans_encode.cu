// K1 rans_encode_grouped and K2 rans_compact: the grouped interleaved
// rANS encoder as two passes, the same split as the TPU library path.
//
// K1 replaces vcf_tpu/ops/pallas/rans_encode.py:pallas_encode_grouped_raw
// and, given the transposed view of (L, S) lanes,
// pallas_encode_grouped_raw_u8 (it reads (L, S) symbols).
// One thread per lane walks its L symbols newest first and writes the raw
// grid word (emit << 16) | (x & 0xFFFF) of decode step t, plus the final
// state.  What bounds it: 5 bytes of memory traffic per symbol (1 in, 4
// out) at S = 65536, and at ~2 warps an SM (S = 8704, the DWT grid) the
// per-lane chain through the state: the emit test, the quotient by the
// symbol's frequency and a multiply-add per symbol.  The table entry of
// a step depends on the symbols only, never on the state, so everything
// but that chain can run ahead of it.  The design:
// - symbol tiles staged ahead of the chain: a block copies ENC_TILE steps
//   of its lanes' (L, S) symbols into shared memory with 16-byte
//   cp.async copies, two stages, so the next tile (lower t) is in flight
//   while the lanes walk the current one from high t to low t, and no
//   step waits on a global-memory round trip;
// - table entries ENC_UNROLL steps ahead: the lane reads the tile's bytes
//   and their table entries for 8 steps into registers, then runs the 8
//   chain steps, so the shared-memory loads and the division's
//   divisor-only part leave the chain; the state stays in a register,
//   and the quotient is taken once (r = x - q * f);
// - lanes per block picked at launch (128, 64 or 32): the most that still
//   gives every SM a block, so S = 8704 runs 136 blocks of 64 lanes
//   instead of 68 of 128;
// - the block's tables in shared memory (a template parameter), with the
//   tiles after them; over 48 KiB in all the launch opts in to more, and
//   a refused opt-in is an error.  Small sg, whose blocks span many
//   groups (tables over 48 KiB), reads the tables from global memory.
// Stores stay one coalesced 4-byte word a lane a step (a warp writes 128
// contiguous bytes).  The TPU kernel's bf16 byte-split table fetch and f32
// reciprocal with correction rounds are gone: Hopper has exact integer
// division and per-thread table loads.  An exact integer reciprocal with
// one correction, floor((2^32 - 1) / f) taken each step, was slower
// (encode_ab.py's rcp variant).
//
// K1 has two modes, a template parameter: order 0 (above) and the order-1
// context mode `rans_encode_ctx`, which replaces
// vcf_tpu/ops/pallas/rans_ctx.py:pallas_encode_ctx_raw and
// pallas_encode_ctx_raw_u8 (one output, two TPU input layouts).  In the
// context mode each group has n_ctx tables of 256 entries, and the table
// of symbol t is picked by the class of the lane's previous symbol,
// cls_lut[syms[t - 1]] (a 256-entry lookup table covers 4 and 15
// classes alike); symbol 0 takes the class of 128, which is class 0.  A
// context tile stages one row more, the step below its lowest (t0 - 1),
// so the previous symbol of every step comes from the same tile; below
// step 0 that row holds 128.  The TPU's byte-split bf16 (class x
// hi-nibble) matmul fetch and its 2-bit packed class plane are gone: the
// class is one shared-memory byte lookup.  A block's groups keep their
// n_ctx tables in shared memory (8 KiB at 4 classes, 30 KiB at 15, for
// the two groups a 128-lane block can touch).
//
// K2 replaces vcf_tpu/ops/pallas/rans_encode.py:finish_stream_pallas.
// It is a stream compaction of the (L, S) raw grid, row-major over the
// flagged entries (bit 16 set), into the wire words, plus the per-step
// counts and n_words.  What bounds it: memory traffic, the 4-byte grid
// read once and 2 bytes written per word.  The design is ONE pass
// (`compact_kernel`): a tile of 256 threads x 16 entries, each thread
// loading 4 x 16-byte vectors (round k of a tile is 1024 consecutive
// entries, 4 a thread, so every load of a warp is 512 contiguous bytes).
// The thread's 4 per-round flag counts are packed in 16-bit fields of one
// u64, so one warp shuffle scan plus a sum over the 8 warps ranks all 4
// rounds at once.  The tile stages its words in shared memory in stream
// order, takes its offset from a decoupled look-back over the tiles
// before it (rans_common.cuh; tiles ordered by an atomic ticket), and
// writes them as one contiguous run of u16.  The same pass adds the
// tile's words to counts[t] with one atomicAdd per row segment of the
// tile (a tile crosses rows when S is not a multiple of 4096, as at the
// tests' small shapes), and the last tile writes n_words.  The TPU's
// butterfly compaction per chunk and its stitch scan are gone, and so is
// XLA's row sum for the counts.  CUDA and not Triton: the look-back is a
// spin on another program's published state, which Triton's block model
// does not express.
//
// K2 has a row mode, `rans_compact_rows`: K1 followed by it is
// `rans_encode_rows`, which replaces the compacting encodes
// vcf_tpu/ops/pallas/rans_encode.py:pallas_encode_grouped and
// pallas_encode_grouped_u8 (one output, two TPU input layouts).  Row t
// of the output holds the words that decode step t reads, in lane order,
// as a prefix; the rest of the row is left unwritten (the TPU kernels
// leave it unspecified too), and counts[t] is the prefix length.  The
// TPU's per-step in-kernel compaction (matmul ranks, carry-hi packing) is
// not carried over: the per-step prefix across all S lanes is a grid-wide
// dependency that K1's one-thread-per-lane walk cannot carry, so it stays
// a second pass.  What bounds it: memory traffic, the 4-byte grid read
// once (at S = 65536 about 1% of the entries are words, so the stores are
// under 1% of the bytes).  The prefix is per row, so one CTA owns a row
// and carries its running offset through rounds, and one launch does it
// with no offset crossing CTAs.  The first design ran 1024-thread CTAs, a
// 4-byte load a thread a round, each round waiting on a block scan (three
// barriers) before the next load was issued, so no load latency was
// hidden.  The design (`compact_rows_kernel`): 128-thread CTAs, 8 an SM
// (765 rows are less than one wave on 132 SMs); a round is 2048 entries
// of the row, each thread loading ROW_VECS 16-byte vectors (every load of
// a warp 512 contiguous bytes) and ranking them as K2's one pass does: the
// per-vector flag counts packed in 16-bit fields of one u64, one warp
// shuffle scan and a sum over the 4 warps.  The loads of the CTAs an SM
// holds keep memory busy: loading the next round into registers before
// ranking this one moved it by 3% or less (rows_ab.py's prefetch variant),
// and 256-thread CTAs (4 an SM) were 4-8% slower.  The round's words are
// staged in shared memory in stream order and stored from the running
// offset as one contiguous run of u16.  Two barriers a round.  S % 4 != 0
// or a raw grid off 16-byte alignment takes plain 4-byte loads in the same
// kernel, chosen by shape; a row's ragged last round masks its tail.  A
// row mode of K2's one pass (a look-back confined to a row) would split a
// row over CTAs, which 765 rows do not need.

#include <algorithm>

#include "rans_common.cuh"

namespace vcf {

constexpr int ENC_LANES = 128;   // most lanes (threads) of a K1 block
constexpr int ENC_TILE = 64;     // steps of a staged symbol tile
constexpr int ENC_UNROLL = 8;    // steps whose table entries load ahead
static_assert(ENC_TILE % ENC_UNROLL == 0, "a full tile is whole unrolls");
constexpr int CMP_THREADS = 256;
constexpr int CMP_VEC = 4;                           // entries per load
constexpr int CMP_ROUNDS = 4;                        // loads per thread
constexpr int CMP_ROUND = CMP_THREADS * CMP_VEC;     // 1024 entries
constexpr int CMP_TILE = CMP_ROUND * CMP_ROUNDS;     // 4096 entries a tile
constexpr int ROW_THREADS = 128;
constexpr int ROW_VECS = 4;                          // loads a thread a round
constexpr int ROW_ROUND = ROW_THREADS * CMP_VEC * ROW_VECS;   // 2048 entries
constexpr int ROW_MIN_BLOCKS = 8;                    // resident CTAs an SM
constexpr int STATIC_SMEM_LIMIT = 48 * 1024;

// Stage the symbols of steps [t0 - CTX, t0 + rows) of the block's lanes
// [s0, s0 + blockDim.x) into buf: row k holds step t0 - CTX + k, one byte
// a lane.  vec: 16-byte cp.async copies, which needs S % 16 == 0 and
// 16-byte aligned symbols (a 16-lane chunk then lies wholly inside or
// outside [0, S); chunks past S are left unwritten, their lanes never
// read); else plain byte loads (ragged S).  The context mode's row of
// step -1 holds 128, whose class is 0.
template <bool CTX>
__device__ __forceinline__ void stage_tile(uint8_t* buf,
                                           const uint8_t* __restrict__ syms,
                                           int S, int s0, int t0, int rows,
                                           int vec) {
  const int lanes = blockDim.x;
  const int first = t0 - (CTX ? 1 : 0);
  const int n = rows + (CTX ? 1 : 0);
  if (vec) {
    // a row is lanes / 16 chunks, so one pass of the block covers 16 rows
    const int per_row = lanes / 16;
    const int q = threadIdx.x % per_row;
    const int s = s0 + 16 * q;
    for (int k = threadIdx.x / per_row; k < n; k += 16) {
      uint8_t* dst = buf + k * lanes + 16 * q;
      const int t = first + k;
      if (t < 0)
        *reinterpret_cast<uint4*>(dst) = make_uint4(
            0x80808080u, 0x80808080u, 0x80808080u, 0x80808080u);
      else if (s < S)
        cp_async16(dst, syms + (size_t)t * S + s);
    }
  } else {
    const int s = s0 + threadIdx.x;
    for (int k = 0; k < n; ++k) {
      const int t = first + k;
      buf[k * lanes + threadIdx.x] =
          t < 0 ? 128 : (s < S ? syms[(size_t)t * S + s] : 0);
    }
  }
}

// One step of the state chain (the law of encode_steps_ref); returns the
// raw word of the step.  The quotient is taken once: one division
// sequence a step, whose divisor-only part runs ahead of the chain.
__device__ __forceinline__ uint32_t encode_step(uint32_t& x, uint32_t e) {
  const uint32_t f = e & 0xFFFFu;
  const uint32_t emit = (x >> SHIFT_EMIT) >= f ? 1u : 0u;
  const uint32_t low = x & 0xFFFFu;
  if (emit) x >>= 16;
  const uint32_t q = x / f;
  x = (q << K_PROB) + (x - q * f) + (e >> 16);
  return low | (emit << 16);
}

// Steps t0 + rows - 1 down to t0 of one lane.  col: the lane's byte of
// staged row 0 (rows `lanes` bytes apart); out: raw[t0][s]; t_grp: the
// lane's group's table(s).  The table entries of ENC_UNROLL steps are
// read before their chain steps run.
template <bool CTX>
__device__ __forceinline__ void encode_tile(const uint8_t* col, int lanes,
                                            const uint32_t* t_grp,
                                            const uint8_t* s_lut,
                                            int32_t* out, int S, int rows,
                                            uint32_t& x) {
  constexpr int C = CTX ? 1 : 0;  // staged row of step t0
  int r = rows - 1;
  for (; r >= ENC_UNROLL - 1; r -= ENC_UNROLL) {
    uint32_t e[ENC_UNROLL];
    if constexpr (CTX) {
      // sym[u]: step r - u's symbol; sym[u + 1]: its previous one
      uint32_t sym[ENC_UNROLL + 1];
#pragma unroll
      for (int u = 0; u <= ENC_UNROLL; ++u) sym[u] = col[(r + C - u) * lanes];
#pragma unroll
      for (int u = 0; u < ENC_UNROLL; ++u)
        e[u] = t_grp[s_lut[sym[u + 1]] * 256u + sym[u]];
    } else {
#pragma unroll
      for (int u = 0; u < ENC_UNROLL; ++u) e[u] = t_grp[col[(r - u) * lanes]];
    }
#pragma unroll
    for (int u = 0; u < ENC_UNROLL; ++u)
      out[(size_t)(r - u) * S] = (int32_t)encode_step(x, e[u]);
  }
  for (; r >= 0; --r) {
    const uint32_t e =
        CTX ? t_grp[s_lut[col[r * lanes]] * 256u + col[(r + 1) * lanes]]
            : t_grp[col[r * lanes]];
    out[(size_t)r * S] = (int32_t)encode_step(x, e);
  }
}

// CTX = false: order 0, tab (G, 256).  CTX = true: the context mode, tab
// (G, n_ctx, 256) and cls_lut (256,) the class of each previous symbol.
// SMEM: the tables of the groups the block spans in shared memory, after
// the two tile stages; else read from global memory.
template <bool CTX, bool SMEM>
__global__ void __launch_bounds__(ENC_LANES)
rans_encode_kernel(const uint8_t* __restrict__ syms,     // (L, S)
                   const uint32_t* __restrict__ tab,     // (G, rows_g)
                   const uint8_t* __restrict__ cls_lut,  // (256,), CTX only
                   int32_t* __restrict__ raw,            // (L, S)
                   uint32_t* __restrict__ states,        // (S,)
                   int S, int L, int sg, int n_ctx, int vec) {
  constexpr int ROWS = ENC_TILE + (CTX ? 1 : 0);  // staged rows a stage
  extern __shared__ __align__(16) uint8_t s_dyn[];
  __shared__ uint8_t s_lut[CTX ? 256 : 1];
  const int lanes = blockDim.x;
  const int stage = ROWS * lanes;
  uint32_t* s_tab = reinterpret_cast<uint32_t*>(s_dyn + 2 * stage);
  const int rows_g = CTX ? n_ctx * 256 : 256;  // table entries per group
  const int s0 = blockIdx.x * lanes;
  const int s = s0 + threadIdx.x;
  const int g_lo = s0 / sg;
  if constexpr (CTX) {
    for (int i = threadIdx.x; i < 256; i += lanes) s_lut[i] = cls_lut[i];
  }
  if constexpr (SMEM) {
    // the groups this block's lanes span, contiguous in the table
    const int g_hi = (min(s0 + lanes, S) - 1) / sg;
    const int n = (g_hi - g_lo + 1) * rows_g;
    for (int i = threadIdx.x; i < n; i += lanes)
      s_tab[i] = tab[(size_t)g_lo * rows_g + i];
  }
  const int n_tiles = (L + ENC_TILE - 1) / ENC_TILE;  // tile j: steps j * T..
  if (n_tiles > 0) {
    const int t0 = (n_tiles - 1) * ENC_TILE;
    stage_tile<CTX>(s_dyn + ((n_tiles - 1) & 1) * stage, syms, S, s0, t0,
                    L - t0, vec);
    cp_async_commit();
  }
  const bool live = s < S;
  const int g = min(s, S - 1) / sg;
  const uint32_t* t_grp = SMEM ? s_tab + (g - g_lo) * rows_g
                               : tab + (size_t)g * rows_g;
  uint32_t x = RANS_L;
  for (int j = n_tiles - 1; j >= 0; --j) {
    // the next tile down goes in flight, then this one must have landed
    if (j > 0) {
      stage_tile<CTX>(s_dyn + ((j - 1) & 1) * stage, syms, S, s0,
                      (j - 1) * ENC_TILE, ENC_TILE, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // the tile (and, first time, tables and LUT) visible
    if (live) {
      const int t0 = j * ENC_TILE;
      encode_tile<CTX>(s_dyn + (j & 1) * stage + threadIdx.x, lanes, t_grp,
                       s_lut, raw + (size_t)t0 * S + s, S,
                       min(ENC_TILE, L - t0), x);
    }
    __syncthreads();  // every lane is done with the stage the next refills
  }
  if (live) states[s] = x;
}

// 8 blocks an SM (at most 32 registers a thread): more tiles in flight
__global__ void __launch_bounds__(CMP_THREADS, 8)
compact_kernel(const int32_t* __restrict__ raw, int n, int S,
               uint16_t* __restrict__ words, int32_t* __restrict__ n_words,
               unsigned long long* __restrict__ desc,  // (tiles,)
               int* __restrict__ ticket,
               int32_t* __restrict__ counts) {  // (L,), zeroed
  __shared__ uint16_t s_words[CMP_TILE];
  __shared__ int s_rows[CMP_TILE + 1];  // per-row counts of a tile
  __shared__ unsigned long long s_warp[CMP_THREADS / 32];
  __shared__ long long s_prefix;
  __shared__ int s_tile;
  const int tile = lb_ticket(ticket, &s_tile);
  const long long base = (long long)tile * CMP_TILE;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // entry base + k * CMP_ROUND + CMP_VEC * threadIdx.x + j is r[4k + j],
  // flagged at bit 4k + j of `flags`
  alignas(16) int32_t r[CMP_ROUNDS * CMP_VEC];
  uint32_t flags = 0;
  unsigned long long packed = 0;  // field k (16 bits): round k's flags
#pragma unroll
  for (int k = 0; k < CMP_ROUNDS; ++k) {
    const long long e = base + k * CMP_ROUND + CMP_VEC * threadIdx.x;
    if (e + CMP_VEC <= n) {
      reinterpret_cast<int4*>(r)[k] = __ldcs((const int4*)(raw + e));
    } else {
#pragma unroll
      for (int j = 0; j < CMP_VEC; ++j)
        r[CMP_VEC * k + j] = e + j < n ? raw[e + j] : 0;
    }
    uint32_t f = 0;
#pragma unroll
    for (int j = 0; j < CMP_VEC; ++j)
      f |= (((uint32_t)r[CMP_VEC * k + j] >> 16) != 0u) << j;
    flags |= f << (CMP_VEC * k);
    packed |= (unsigned long long)__popc(f) << (16 * k);
  }
  // rank: an inclusive warp scan of the packed counts (no field carries:
  // a round has 1024 entries), then the warps before this one
  unsigned long long incl = packed;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  unsigned long long before = incl - packed, sum = 0;
#pragma unroll
  for (int w = 0; w < CMP_THREADS / 32; ++w) {
    const unsigned long long c = s_warp[w];
    if (w < warp) before += c;
    sum += c;
  }
  int total = 0;
#pragma unroll
  for (int k = 0; k < CMP_ROUNDS; ++k) {
    // round k's words follow those of the rounds before it
    int at = total + (int)((before >> (16 * k)) & 0xFFFFu);
    total += (int)((sum >> (16 * k)) & 0xFFFFu);
#pragma unroll
    for (int j = 0; j < CMP_VEC; ++j)
      if ((flags >> (CMP_VEC * k + j)) & 1u)
        s_words[at++] = (uint16_t)(r[CMP_VEC * k + j] & 0xFFFF);
  }
  if (warp == 0) {
    const long long excl = lb_scan(desc, tile, (uint32_t)total, nullptr);
    if (lane == 0) s_prefix = excl;
  }
  __syncthreads();
  const long long prefix = s_prefix;
  for (int i = threadIdx.x; i < total; i += CMP_THREADS)
    words[prefix + i] = s_words[i];
  if (tile == (int)gridDim.x - 1 && threadIdx.x == 0)
    *n_words = (int32_t)(prefix + total);
  // the per-step counts: one atomicAdd per row the tile touches
  const int r0 = (int)(base / S);
  const int r1 = (int)((min(base + CMP_TILE, (long long)n) - 1) / S);
  if (r0 == r1) {
    if (threadIdx.x == 0 && total) atomicAdd(&counts[r0], total);
    return;
  }
  for (int i = threadIdx.x; i <= r1 - r0; i += CMP_THREADS) s_rows[i] = 0;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < CMP_ROUNDS; ++k) {
#pragma unroll
    for (int j = 0; j < CMP_VEC; ++j) {
      if ((flags >> (CMP_VEC * k + j)) & 1u) {
        const long long e = base + k * CMP_ROUND + CMP_VEC * threadIdx.x + j;
        atomicAdd(&s_rows[(int)(e / S) - r0], 1);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i <= r1 - r0; i += CMP_THREADS)
    if (s_rows[i]) atomicAdd(&counts[r0 + i], s_rows[i]);
}

// Round r0 of a row for one thread: entry r0 + k * ROW_THREADS * CMP_VEC +
// CMP_VEC * threadIdx.x + j is v[CMP_VEC * k + j], 0 past the row's end.
// vec: 16-byte loads (S % 4 == 0 and an aligned grid).
__device__ __forceinline__ void rows_load(int32_t (&v)[ROW_VECS * CMP_VEC],
                                          const int32_t* __restrict__ in,
                                          int r0, int S, int vec) {
#pragma unroll
  for (int k = 0; k < ROW_VECS; ++k) {
    const int e = r0 + k * ROW_THREADS * CMP_VEC + CMP_VEC * threadIdx.x;
    if (vec && e + CMP_VEC <= S) {
      reinterpret_cast<int4*>(v)[k] = __ldcs((const int4*)(in + e));
    } else {
#pragma unroll
      for (int j = 0; j < CMP_VEC; ++j)
        v[CMP_VEC * k + j] = e + j < S ? in[e + j] : 0;
    }
  }
}

// One CTA per row t of the (L, S) raw grid; rounds of ROW_ROUND entries.
__global__ void __launch_bounds__(ROW_THREADS, ROW_MIN_BLOCKS)
compact_rows_kernel(const int32_t* __restrict__ raw, int S,
                    uint16_t* __restrict__ rows,
                    int32_t* __restrict__ counts, int vec) {
  __shared__ uint16_t s_words[ROW_ROUND];
  __shared__ unsigned long long s_warp[ROW_THREADS / 32];
  const int32_t* in = raw + (size_t)blockIdx.x * S;
  uint16_t* out = rows + (size_t)blockIdx.x * S;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int run = 0;
  for (int r0 = 0; r0 < S; r0 += ROW_ROUND) {
    alignas(16) int32_t cur[ROW_VECS * CMP_VEC];
    rows_load(cur, in, r0, S, vec);
    uint32_t flags = 0;
    unsigned long long packed = 0;  // field k (16 bits): vector k's flags
#pragma unroll
    for (int k = 0; k < ROW_VECS; ++k) {
      uint32_t f = 0;
#pragma unroll
      for (int j = 0; j < CMP_VEC; ++j)
        f |= (((uint32_t)cur[CMP_VEC * k + j] >> 16) != 0u) << j;
      flags |= f << (CMP_VEC * k);
      packed |= (unsigned long long)__popc(f) << (16 * k);
    }
    // rank: an inclusive warp scan of the packed counts (a field holds at
    // most ROW_THREADS * CMP_VEC), then the warps before this one
    unsigned long long incl = packed;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned long long y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();  // the sums visible; the last round's words stored
    unsigned long long before = incl - packed, sum = 0;
#pragma unroll
    for (int w = 0; w < ROW_THREADS / 32; ++w) {
      const unsigned long long c = s_warp[w];
      if (w < warp) before += c;
      sum += c;
    }
    int total = 0;
#pragma unroll
    for (int k = 0; k < ROW_VECS; ++k) {
      // vector k's words follow those of the vectors before it
      int at = total + (int)((before >> (16 * k)) & 0xFFFFu);
      total += (int)((sum >> (16 * k)) & 0xFFFFu);
#pragma unroll
      for (int j = 0; j < CMP_VEC; ++j)
        if ((flags >> (CMP_VEC * k + j)) & 1u)
          s_words[at++] = (uint16_t)(cur[CMP_VEC * k + j] & 0xFFFF);
    }
    __syncthreads();  // the round's words staged
    for (int i = threadIdx.x; i < total; i += ROW_THREADS)
      out[run + i] = s_words[i];
    run += total;
  }
  if (threadIdx.x == 0) counts[blockIdx.x] = run;
}

template <bool CTX, bool SMEM>
int launch_encode_smem(const void* syms, const void* tab, const void* cls_lut,
                       void* raw, void* states, int S, int L, int sg,
                       int n_ctx, int lanes, size_t smem, void* stream) {
  const auto kernel = rans_encode_kernel<CTX, SMEM>;
  if (smem > (size_t)STATIC_SMEM_LIMIT) {
    const int err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err) return err;
  }
  const int vec = S % 16 == 0 && (uintptr_t)syms % 16 == 0;
  kernel<<<(S + lanes - 1) / lanes, lanes, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)syms, (const uint32_t*)tab, (const uint8_t*)cls_lut,
      (int32_t*)raw, (uint32_t*)states, S, L, sg, n_ctx, vec);
  return (int)cudaGetLastError();
}

// K1's launch shape for S lanes in G groups (n_ctx 0: order 0).
struct EncodePlan {
  int lanes;          // a block's lanes: the most of 128, 64, 32 that still
                      // gives every SM a block (S = 65536: 128; S = 8704,
                      // the DWT grid: 64; S = 8192: 32)
  bool smem_tables;   // the spanned groups' tables fit 48 KiB
  size_t smem;        // dynamic shared memory: tiles (+ tables)
};

int encode_plan(int S, int G, int n_ctx, EncodePlan* p) {
  if (S < 1 || G < 1 || S % G) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (err) return err;
  p->lanes = ENC_LANES;
  while (p->lanes > 32 && (S + p->lanes - 1) / p->lanes < sms) p->lanes >>= 1;
  const int sg = S / G;
  // most groups one block can span: its lanes cover `lanes` consecutive
  // lanes, which touch at most this many groups of sg lanes
  const int span = std::min(G, (p->lanes + sg - 1) / sg + 1);
  const size_t tables =
      (size_t)span * (n_ctx ? n_ctx : 1) * 256 * sizeof(uint32_t);
  p->smem_tables = tables <= (size_t)STATIC_SMEM_LIMIT;
  p->smem = 2 * (size_t)(ENC_TILE + (n_ctx ? 1 : 0)) * p->lanes +
            (p->smem_tables ? tables : 0);
  return 0;
}

template <bool CTX>
int launch_encode(const void* syms, const void* tab, const void* cls_lut,
                  void* raw, void* states, int S, int L, int G, int n_ctx,
                  void* stream) {
  EncodePlan p;
  if (L < 0 || (CTX && n_ctx < 1)) return (int)cudaErrorInvalidValue;
  const int err = encode_plan(S, G, CTX ? n_ctx : 0, &p);
  if (err) return err;
  const int sg = S / G;
  if (p.smem_tables)
    return launch_encode_smem<CTX, true>(syms, tab, cls_lut, raw, states, S,
                                         L, sg, n_ctx, p.lanes, p.smem,
                                         stream);
  return launch_encode_smem<CTX, false>(syms, tab, cls_lut, raw, states, S, L,
                                        sg, n_ctx, p.lanes, p.smem, stream);
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

int vcf_rans_encode_tile(void) { return vcf::ENC_TILE; }

// K1's plan for S lanes in G groups (n_ctx 0: order 0): the block's lanes
// times 2, plus 1 if its tables are in shared memory; minus a CUDA error.
int vcf_rans_encode_plan(int S, int G, int n_ctx) {
  vcf::EncodePlan p;
  const int err = vcf::encode_plan(S, G, n_ctx, &p);
  return err ? -err : 2 * p.lanes + (p.smem_tables ? 1 : 0);
}

int vcf_rans_compact_tile(void) { return vcf::CMP_TILE; }

// K2's row mode: raw (L, S) i32 grid -> rows (L, S) u16 (each row's
// flagged words as a prefix, the tail unwritten) and counts (L,) i32.
int vcf_rans_compact_rows(const void* raw, int S, int L, void* rows,
                          void* counts, void* stream) {
  if (S < 1 || L < 1) return (int)cudaErrorInvalidValue;
  const int vec = S % vcf::CMP_VEC == 0 && (uintptr_t)raw % 16 == 0;
  vcf::compact_rows_kernel<<<L, vcf::ROW_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)raw, S, (uint16_t*)rows, (int32_t*)counts, vec);
  return (int)cudaGetLastError();
}

// raw (L, S) i32 grid (n = L * S entries, n < 2^31) in decode order ->
// words (n,) u16 (the stream as a prefix), n_words (1,) i32 and counts
// (L,) i32.  scratch: ceil(n / tile) u64 descriptors, the ticket i32,
// then the counts (L,) i32, all zeroed here by one memset on the stream.
// Returns the first CUDA error of the memset or launch.
int vcf_rans_compact(const void* raw, long long n, int S, int L, void* words,
                     void* n_words, void* scratch, void* stream) {
  if (n < 1 || n >= (1LL << 31) || S < 1 || (long long)S * L != n)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (int)((n + vcf::CMP_TILE - 1) / vcf::CMP_TILE);
  cudaStream_t st = (cudaStream_t)stream;
  unsigned long long* desc = (unsigned long long*)scratch;
  int* ticket = (int*)(desc + n_tiles);
  int err = (int)cudaMemsetAsync(
      scratch, 0, n_tiles * sizeof(unsigned long long) + (1 + L) * sizeof(int),
      st);
  if (err) return err;
  vcf::compact_kernel<<<n_tiles, vcf::CMP_THREADS, 0, st>>>(
      (const int32_t*)raw, (int)n, S, (uint16_t*)words, (int32_t*)n_words,
      desc, ticket, ticket + 1);
  return (int)cudaGetLastError();
}

}  // extern "C"
