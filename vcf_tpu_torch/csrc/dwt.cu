// The periodized DWT bank (ops/dwt.py) one level a launch: analysis and
// synthesis, each one kernel.
//
// dwt_analyze_level_kernel and dwt_synthesize_level_kernel replace no TPU
// kernel: vcf_tpu's bank (vcf_tpu/ops/dwt.py _down_axis / _up_axis) is
// XLA ops, and the port's plain version (ops/dwt.py fma32) evaluates each
// of its sums as a float32 FMA chain emulated in float64 torch ops, about
// a dozen full-size kernels a tap of every filter of every pass.  Here
// each sum is the same chain in float32 intrinsics, so the two agree bit
// for bit:
//   analysis  a[k] = sum_j f[j] * x[(2k + j + shift) mod n]: the first
//             product __fmul_rn, fused with the other product of the first
//             pair as ops/dwt.py _fuses_first says (the wrapper passes the
//             flag for each filter and each pass, since it depends on the
//             pass's length n), then __fmaf_rn for j = 2, 3, ...;
//   synthesis y[m] = sum_j f[j] * up[(m - j - phase) mod n], up[2k] = a[k],
//             0 at odd places.  One product of the chain's first pair is
//             always such a 0, and fma(0, w, z) equals z but for the sign
//             of a zero z, so the kernel skips the zero terms: the first
//             nonzero term's product __fmul_rn, then __fmaf_rn for the
//             later ones.  Its floats equal the torch chain's under ==
//             (+0 and -0 may differ where the sum is 0);
//   the band sums up(LL) + up(LH), up(HL) + up(HH) and the final row sum
//             are __fadd_rn.
// nvcc contracts nothing here (every step an _rn intrinsic), and the build
// keeps IEEE subnormals (no -ftz, no --use_fast_math), as fma32 rounds.
//
// What bounds them: bytes.  A level reads its input once and writes its
// four bands (analysis) or its output (synthesis) once: 8 bytes an element
// over 1 + 1/4 + ... of a (B, H, W, T) float32 clip, ~534 MB a direction
// for 8 x 1088 x 1920 x 3 at five levels, 0.16 ms at 3.35 TB/s; the ~20
// FMAs an element of db5 take ~45 us at the card's float32 rate, but only
// if each costs about one instruction.  Design: a CTA of 256 threads owns
// a tile of output rows x output columns over a chunk of the trailing axis
// (all of it unless that does not fit), stages what the tile reads into
// shared memory once by asynchronous copies (all of a thread's copies in
// flight at once), runs both passes there and writes each output once, so
// device memory sees each input element about once (the halos of
// neighbouring tiles come from L2) and each output element once.
//   Analysis: the input rows 2k + j + shift and columns of the tile (mod H,
//   mod W) are staged (stage()): where no wrap falls in the tile a row's
//   part is one contiguous run, copied 16 bytes at a time from the aligned
//   address at or below its start, or 4 bytes at a time where the row's
//   pitch is not a multiple of 16 bytes; a modulo index per element where a
//   wrap falls in the tile or the trailing axis is cut into chunks.  The
//   row pass of both filters writes a (2, rows, staged columns) tile in
//   shared memory, its even and odd columns apart, so that the column
//   pass's stride-2 reads fall on consecutive words; the column pass of
//   both filters reads it and writes the four bands of the (2, 2, B, H/2,
//   W/2, T) output (column filter, row filter: the stacked tensor
//   ops/dwt.py _down_pair(_down_pair(x)) builds).  Where the two filters
//   have one length and one shift (db, sym, coif), each staged value a
//   thread reads feeds both filters' chains.
//   Synthesis: the band rows and columns the tile reads (mod h, mod w) of
//   LL, LH, HL and HH are staged the same way; the column pass writes the
//   two row bands up(LL) + up(LH) and up(HL) + up(HH) over the staged rows
//   and the tile's output columns into shared memory; the row pass reads
//   them and writes the output once.  A thread evaluates a pair of output
//   columns (column pass) or rows (row pass): one of the pair takes the
//   filter's even taps and the other its odd taps over one run of inputs,
//   so each input is read once for both.
// Instructions: the chains are unrolled with the taps in the kernel's
// parameters (held in registers across a thread's items), so each FMA
// takes its input by one shared-memory load from a pointer stepped by a
// fixed stride; threads walk their items by adding the block's size to a
// (row, column, element) position, with no division.  A bank whose two
// filters have one tap count of 2, 4, ..., 12 takes the instance for that
// count (no test a tap); other banks of up to DWT_UNROLL taps a filter the
// instance unrolled that far, which tests the count at each tap; longer
// ones the instance with plain loops and the taps in shared memory.
// Tile geometry is chosen from the shape and the bank (dwt_plan): the
// first tile (16 x 32 output rows x columns for analysis, 32 x 64 for
// synthesis: of the sizes tried on the cell's levels, the fastest; 8 x 32
// and 16 x 64 took 12% and 24% longer at level 1 and 6% and 19% at level
// 2, the coarser levels and the clip path end to end the same within
// their spread, H100 timed in turns) cut to the level's
// size, so coarse levels such as 34 x 60 or 2 x 4, whose staged rows wrap
// one or several times, take the modulo index; then halved, columns first,
// until it fits 100 KB of shared memory (63 and 71 KB at db5 with T = 3,
// three CTAs an SM).  A tile that does not fit at its least size takes up
// to 227 KB, and
// past that the first pass reads its input from device memory with the
// same modulo index instead of staging it, so no filter length or level
// size is refused.  Taps, lengths, shifts and phases are launch arguments.
// Two of these paths carry no configuration's traffic: the plain-loop
// instance (filters past 32 taps: get_bank's db and sym from order 17) and
// the unstaged read (past about 230 taps); every codec configuration and
// benchmark cell takes a bank of 12 taps or fewer.  The card tests run
// both on a random 300-tap bank.

#include <algorithm>
#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

namespace vcf {

constexpr int DWT_THREADS = 256;
constexpr int DWT_UNROLL = 32;                     // taps a filter, unrolled
constexpr long long DWT_SMEM_TARGET = 100 * 1024;  // 2 CTAs an SM or more
constexpr long long DWT_SMEM_MAX = 227 * 1024;     // one CTA, opted in
// the first tile of each kernel: output rows x output columns
constexpr int DWT_AN_ROWS = 16, DWT_AN_COLS = 32;
constexpr int DWT_SY_ROWS = 32, DWT_SY_COLS = 64;

// A bank as a launch takes it (ops/dwt.py `kernel_args`): tap counts of
// the lowpass and the highpass filter, their shifts (analysis) or phases
// (synthesis), and for analysis whether each filter's first pair fuses its
// first product, in the pass along H (rows) and along W (columns); the
// taps themselves when both filters have at most DWT_UNROLL (else the tap
// buffer on the device, lowpass first).
struct DwtBank {
  int len[2];
  int off[2];
  int fuse_rows[2];
  int fuse_cols[2];
  float taps[2][DWT_UNROLL];
};

// A launch's tile: output rows, output columns and trailing elements a
// tile, staged input rows and columns (analysis: of x; synthesis: of each
// band) and the floats a staged row takes (its elements, up to 3 floats
// of alignment before them, rounded up to 4), whether the first pass
// reads them from shared memory (staged) or from device memory, the shared
// memory a CTA takes and the tiles.
struct DwtPlan {
  int rows, cols, chans;
  int in_rows, in_cols, in_stride;
  int staged;
  long long smem;
  long long tiles;
};

__host__ __device__ inline int wrap(int v, int n) {
  const int r = v % n;
  return r < 0 ? r + n : r;
}

__host__ __device__ inline int floor_half(int v) {   // floor(v / 2)
  return v >= 0 ? v / 2 : -((1 - v) / 2);
}

__host__ __device__ inline int taps_padded(const DwtBank& bk) {
  return (bk.len[0] + bk.len[1] + 3) / 4 * 4;   // keeps what follows aligned
}

// Global -> shared copies in flight together: 4 bytes (any aligned float)
// or 16 (both addresses 16-byte aligned); cp_async_wait_all and a barrier
// make them visible.  The host branch (a g++ rehearsal) copies at once.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src)
               : "memory");
#else
  memcpy(dst, src, 4);
#endif
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
               "l"(src)
               : "memory");
#else
  memcpy(dst, src, 16);
#endif
}

__device__ __forceinline__ void cp_async_wait_all() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;" ::: "memory");
#endif
}

// A thread's walk over the items (row, l) of a pass, l < width, in steps
// of the block's size: l split into (n, t) by the trailing chunk chans,
// all by additions (the first position by one division).
struct Walk {
  int row, l, n, t;
  int width, chans, dl, dn, dt, drows;
  __device__ Walk(int width_, int chans_) : width(width_), chans(chans_) {
    const int e = threadIdx.x, step = blockDim.x;
    row = e / width;
    l = e - row * width;
    n = l / chans;
    t = l - n * chans;
    dl = step % width;
    dn = dl / chans;
    dt = dl - dn * chans;
    drows = step / width;      // rows a step adds besides the carry
  }
  __device__ void next() {
    row += drows;
    l += dl;
    n += dn;
    t += dt;
    if (t >= chans) {
      t -= chans;
      ++n;
    }
    if (l >= width) {
      l -= width;
      n -= width / chans;
      ++row;
    }
  }
};

// sum_j f(j) * v(j), j = 0 .. n - 1, as ops/dwt.py _fma_chain: one
// product, fused with the other product of the first pair (fuse: fma(v0,
// f0, v1 * f1), else fma(v1, f1, v0 * f0)), then one fused multiply-add a
// tap.  NT > 0: unrolled, n <= NT (EXACT: n == NT, no test a tap).
template <int NT, bool EXACT, typename F, typename V>
__device__ __forceinline__ float fma_chain(int n, int fuse, F f, V v) {
  if (EXACT) n = NT;
  if (n == 1) return __fmul_rn(v(0), f(0));
  float z = fuse ? __fmaf_rn(v(0), f(0), __fmul_rn(v(1), f(1)))
                 : __fmaf_rn(v(1), f(1), __fmul_rn(v(0), f(0)));
  if (NT) {
#pragma unroll
    for (int j = 2; j < (NT ? NT : 1); ++j) {
      if (!EXACT && j >= n) break;
      z = __fmaf_rn(v(j), f(j), z);
    }
  } else {
    for (int j = 2; j < n; ++j) z = __fmaf_rn(v(j), f(j), z);
  }
  return z;
}

// Two chains of one length over the same inputs (the lowpass and the
// highpass of a pass with one shift): each v(j) read once.
template <int NT, bool EXACT, typename F0, typename F1, typename V>
__device__ __forceinline__ void fma_chain2(int n, int fuse0, int fuse1,
                                           F0 f0, F1 f1, V v, float* z0,
                                           float* z1) {
  if (EXACT) n = NT;
  if (n == 1) {
    const float a = v(0);
    *z0 = __fmul_rn(a, f0(0));
    *z1 = __fmul_rn(a, f1(0));
    return;
  }
  const float a = v(0), b = v(1);
  float y0 = fuse0 ? __fmaf_rn(a, f0(0), __fmul_rn(b, f0(1)))
                   : __fmaf_rn(b, f0(1), __fmul_rn(a, f0(0)));
  float y1 = fuse1 ? __fmaf_rn(a, f1(0), __fmul_rn(b, f1(1)))
                   : __fmaf_rn(b, f1(1), __fmul_rn(a, f1(0)));
  if (NT) {
#pragma unroll
    for (int j = 2; j < (NT ? NT : 1); ++j) {
      if (!EXACT && j >= n) break;
      const float c = v(j);
      y0 = __fmaf_rn(c, f0(j), y0);
      y1 = __fmaf_rn(c, f1(j), y1);
    }
  } else {
    for (int j = 2; j < n; ++j) {
      const float c = v(j);
      y0 = __fmaf_rn(c, f0(j), y0);
      y1 = __fmaf_rn(c, f1(j), y1);
    }
  }
  *z0 = y0;
  *z1 = y1;
}

// The synthesis chain over the zero-upsampled input without its zero
// terms: taps J0, J0 + 2, ... (J0 the parity at which the input is a band
// sample), the first a product, the later ones fused multiply-adds; v(k)
// is the k-th of those terms' inputs.
template <int NT, bool EXACT, int J0, typename F, typename V>
__device__ __forceinline__ float up_chain(int n, F f, V v) {
  if (EXACT) n = NT;
  if (J0 >= n) return 0.0f;
  float z = __fmul_rn(v(0), f(J0));
  if (NT) {
#pragma unroll
    for (int k = 1; J0 + 2 * k < (NT ? NT : 1); ++k) {
      if (!EXACT && J0 + 2 * k >= n) break;
      z = __fmaf_rn(v(k), f(J0 + 2 * k), z);
    }
  } else {
    for (int k = 1; J0 + 2 * k < n; ++k) z = __fmaf_rn(v(k), f(J0 + 2 * k), z);
  }
  return z;
}

template <int NT, bool EXACT, typename F, typename V>
__device__ __forceinline__ float up_chain(int n, int j0, F f, V v) {
  return j0 ? up_chain<NT, EXACT, 1>(n, f, v) : up_chain<NT, EXACT, 0>(n, f, v);
}

// Rows [r0, r0 + n_rows) mod H x columns [c0, c0 + n_cols) mod W x the
// trailing elements [t0, t0 + tc) of the (H, W, T) frame xb -> dst, row i
// at dst + lead + i * stride, column j's element t at j * chans + t;
// returns lead (0 to 3), the same for every thread.  Where no wrap falls
// in the tile, a row's run of n_cols * T floats is contiguous: copied 16
// bytes at a time from the aligned address at or below its start (lead
// floats before it) when the row pitch, the frame and the run's aligned
// end allow, else 4 bytes at a time; otherwise a modulo index each.  The
// copies stay in flight (cp_async_wait_all and a barrier land them).
__device__ int stage(const float* __restrict__ xb, float* dst, int H, int W,
                     int T, int r0, int n_rows, int c0, int n_cols, int t0,
                     int tc, int chans, int stride) {
  const long long pitch = (long long)W * T;
  if (tc == T && c0 >= 0 && c0 + n_cols <= W) {
    const int g0 = c0 * T, run = n_cols * T;
    const int lead = g0 & 3, v = (lead + run + 3) / 4;
    if (pitch % 4 == 0 && (uintptr_t)xb % 16 == 0 && stride % 4 == 0 &&
        g0 - lead + 4LL * v <= pitch && 4 * v <= stride) {
      const float* base = xb + g0 - lead;
      for (Walk e(v, 1); e.row < n_rows; e.next())
        cp_async16(dst + e.row * stride + 4 * e.l,
                   base + wrap(r0 + e.row, H) * pitch + 4 * e.l);
      return lead;
    }
    const float* base = xb + g0;
    for (Walk e(run, 1); e.row < n_rows; e.next())
      cp_async4(dst + e.row * stride + e.l,
                base + wrap(r0 + e.row, H) * pitch + e.l);
    return 0;
  }
  // a wrap along W or a chunk of the trailing axis: a modulo index each
  for (Walk e(n_cols * tc, tc); e.row < n_rows; e.next())
    cp_async4(dst + e.row * stride + e.n * chans + e.t,
              xb + wrap(r0 + e.row, H) * pitch +
                  (long long)wrap(c0 + e.n, W) * T + t0 + e.t);
  return 0;
}

// x (B, H, W, T) f32 -> out (2, 2, B, H/2, W/2, T): out[cf][rf] the column
// pass of filter cf over the row pass of filter rf.  a_lo: the least
// shift; the tile's staged input rows begin at 2 k0 + a_lo, its columns at
// 2 q0 + a_lo.  NT: the taps a filter the chains unroll to (taps in bk;
// EXACT: both filters have NT) or 0 (plain loops, taps in `taps`).
template <int NT, bool EXACT>
__global__ void __launch_bounds__(DWT_THREADS)
dwt_analyze_level_kernel(const float* __restrict__ x, float* __restrict__ out,
                         const float* __restrict__ taps,
                         const __grid_constant__ DwtBank bk, int B, int H,
                         int W, int T, const __grid_constant__ DwtPlan p,
                         int a_lo) {
  extern __shared__ __align__(16) float smem[];
  const int h = H / 2, w = W / 2;
  const int tq = (w + p.cols - 1) / p.cols, tk = (h + p.rows - 1) / p.rows;
  const int tt = (T + p.chans - 1) / p.chans;
  long long id = blockIdx.x;
  const int qt = (int)(id % tq);
  id /= tq;
  const int kt = (int)(id % tk);
  id /= tk;
  const int ct = (int)(id % tt);
  const int b = (int)(id / tt);
  const int k0 = kt * p.rows, q0 = qt * p.cols, t0 = ct * p.chans;
  const int tc = min(p.chans, T - t0);
  const int kmax = min(p.rows, h - k0);         // the tile's output rows
  const int r0 = 2 * k0 + a_lo, c0 = 2 * q0 + a_lo;
  const int cw = p.in_cols * p.chans;           // a staged row's elements
  const int half = (p.in_cols + 1) / 2 * p.chans;   // even columns of a row
  const int mw = (2 * half + 3) / 4 * 4;        // a row-pass row, in floats
  const float* xb = x + (long long)b * H * W * T;

  float* s_taps = smem;
  float* s_in = smem + taps_padded(bk);
  float* s_mid = s_in + (p.staged ? p.in_rows * p.in_stride : 0);
  auto tap0 = [&](int j) { return NT ? bk.taps[0][j] : s_taps[j]; };
  auto tap1 = [&](int j) {
    return NT ? bk.taps[1][j] : s_taps[bk.len[0] + j];
  };
  if (!NT)
    for (int i = threadIdx.x; i < bk.len[0] + bk.len[1]; i += blockDim.x)
      s_taps[i] = taps[i];
  const int lead = p.staged ? stage(xb, s_in, H, W, T, r0, p.in_rows, c0,
                                   p.in_cols, t0, tc, p.chans, p.in_stride)
                           : 0;
  cp_async_wait_all();
  __syncthreads();

  // row pass: s_mid[f][kk][column c, element t], even columns c first
  const bool pair = bk.len[0] == bk.len[1] && bk.off[0] == bk.off[1];
  for (Walk it(cw, p.chans); it.row < kmax; it.next()) {
    if (it.t >= tc) continue;
    const int kk = it.row, c = it.n;
    float* dst = s_mid + kk * mw + (c & 1) * half + (c >> 1) * p.chans + it.t;
    float z[2];
    if (p.staged) {
      const int sw = p.in_stride;
      const float* col = s_in + (2 * kk + bk.off[0] - a_lo) * sw + lead + it.l;
      auto v0 = [&](int i) { return col[i * sw]; };
      if (pair) {
        fma_chain2<NT, EXACT>(bk.len[0], bk.fuse_rows[0], bk.fuse_rows[1],
                              tap0, tap1, v0, &z[0], &z[1]);
      } else {
        const float* col1 =
            s_in + (2 * kk + bk.off[1] - a_lo) * sw + lead + it.l;
        z[0] = fma_chain<NT, EXACT>(bk.len[0], bk.fuse_rows[0], tap0, v0);
        z[1] = fma_chain<NT, EXACT>(bk.len[1], bk.fuse_rows[1], tap1,
                                    [&](int i) { return col1[i * sw]; });
      }
    } else {
      const float* col = xb + (long long)wrap(c0 + c, W) * T + t0 + it.t;
      const long long pitch = (long long)W * T;
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        const int r = 2 * (k0 + kk) + bk.off[f];
        auto v = [&](int i) { return __ldg(col + wrap(r + i, H) * pitch); };
        z[f] = f ? fma_chain<NT, EXACT>(bk.len[1], bk.fuse_rows[1], tap1, v)
                 : fma_chain<NT, EXACT>(bk.len[0], bk.fuse_rows[0], tap0, v);
      }
    }
    dst[0] = z[0];
    dst[p.rows * mw] = z[1];
  }
  __syncthreads();

  // column pass: both column filters over both row-pass tiles; staged
  // column 2 qq + o + i lies at (o + i) % 2 * half + (qq + (o + i) / 2) *
  // chans, so the chain's even and odd taps step by chans from two bases
  const long long band = (long long)B * h * w * T;
  const int ncol = min(p.cols, w - q0);
  for (Walk it(p.cols * p.chans, p.chans); it.row < kmax; it.next()) {
    const int kk = it.row, qq = it.n, t = it.t;
    if (qq >= ncol || t >= tc) continue;
    float* o = out + ((long long)b * h + k0 + kk) * w * T +
               (long long)(q0 + qq) * T + t0 + t;
#pragma unroll
    for (int rf = 0; rf < 2; ++rf) {
      const float* row = s_mid + (rf * p.rows + kk) * mw + qq * p.chans + t;
      auto base = [&](int f, int par) {
        const int o = bk.off[f] - a_lo + par;
        return row + (o & 1) * half + (o >> 1) * p.chans;
      };
      const float* e0 = base(0, 0);
      const float* e1 = base(0, 1);
      auto v0 = [&](int i) { return (i & 1 ? e1 : e0)[(i >> 1) * p.chans]; };
      float z[2];
      if (pair) {
        fma_chain2<NT, EXACT>(bk.len[0], bk.fuse_cols[0], bk.fuse_cols[1],
                              tap0, tap1, v0, &z[0], &z[1]);
      } else {
        const float* g0 = base(1, 0);
        const float* g1 = base(1, 1);
        z[0] = fma_chain<NT, EXACT>(bk.len[0], bk.fuse_cols[0], tap0, v0);
        z[1] = fma_chain<NT, EXACT>(
            bk.len[1], bk.fuse_cols[1], tap1,
            [&](int i) { return (i & 1 ? g1 : g0)[(i >> 1) * p.chans]; });
      }
      o[rf * band] = z[0];
      o[(2 + rf) * band] = z[1];
    }
  }
}

// LL, LH, HL, HH (B, h, w, T) f32 -> out (B, 2h, 2w, T): along W, LL and
// HL through the lowpass and LH and HH through the highpass, the sums
// LL + LH and HL + HH; along H, the first through the lowpass and the
// second through the highpass, and their sum.  a_hi: the largest len - 1 +
// phase; the tile's staged band rows begin at floor((m0 - a_hi) / 2), its
// columns at floor((n0 - a_hi) / 2).  NT, EXACT: as the analysis kernel's.
template <int NT, bool EXACT>
__global__ void __launch_bounds__(DWT_THREADS)
dwt_synthesize_level_kernel(const float* __restrict__ ll,
                            const float* __restrict__ lh,
                            const float* __restrict__ hl,
                            const float* __restrict__ hh,
                            float* __restrict__ out,
                            const float* __restrict__ taps,
                            const __grid_constant__ DwtBank bk, int B, int h,
                            int w, int T, const __grid_constant__ DwtPlan p,
                            int a_hi) {
  extern __shared__ __align__(16) float smem[];
  const int H = 2 * h, W = 2 * w;
  const int tn = (W + p.cols - 1) / p.cols, tm = (H + p.rows - 1) / p.rows;
  const int tt = (T + p.chans - 1) / p.chans;
  long long id = blockIdx.x;
  const int nt = (int)(id % tn);
  id /= tn;
  const int mt = (int)(id % tm);
  id /= tm;
  const int ct = (int)(id % tt);
  const int b = (int)(id / tt);
  const int m0 = mt * p.rows, n0 = nt * p.cols, t0 = ct * p.chans;
  const int tc = min(p.chans, T - t0);
  const int rb0 = floor_half(m0 - a_hi), cb0 = floor_half(n0 - a_hi);
  const int sw = p.in_stride;              // a staged band row, in floats
  const int nw = p.cols * p.chans;         // a row-band row, in floats
  const int ncol = min(p.cols, W - n0), mmax = min(p.rows, H - m0);
  const long long frame = (long long)b * h * w * T;
  const float* bands[4] = {ll + frame, lh + frame, hl + frame, hh + frame};

  float* s_taps = smem;
  float* s_band = smem + taps_padded(bk);
  float* s_rows = s_band + (p.staged ? 4 * p.in_rows * sw : 0);
  auto tap0 = [&](int j) { return NT ? bk.taps[0][j] : s_taps[j]; };
  auto tap1 = [&](int j) {
    return NT ? bk.taps[1][j] : s_taps[bk.len[0] + j];
  };
  if (!NT)
    for (int i = threadIdx.x; i < bk.len[0] + bk.len[1]; i += blockDim.x)
      s_taps[i] = taps[i];
  int lead[4] = {0, 0, 0, 0};
  if (p.staged)
    for (int x = 0; x < 4; ++x)
      lead[x] = stage(bands[x], s_band + x * p.in_rows * sw, h, w, T, rb0,
                      p.in_rows, cb0, p.in_cols, t0, tc, p.chans, sw);
  cp_async_wait_all();
  __syncthreads();

  // Output y's nonzero terms with filter f of phase o: taps j of the parity
  // of y - o, input (y - j - o) / 2.  Of a pair y = m, m + 1 (m even), the
  // one with y - o even takes the even taps from input e = (m + (o & 1) -
  // o) / 2 down, the other the odd taps from e - (o & 1) down: both chains
  // read one run of inputs, and a thread evaluates the pair.
  // column pass: s_rows[s][i][n, t], s = 0: up(LL) + up(LH), 1: up(HL) +
  // up(HH), for each staged band row i and output column n0 + n
  for (Walk it((p.cols / 2) * p.chans, p.chans); it.row < p.in_rows;
       it.next()) {
    const int i = it.row, t = it.t, n = 2 * it.n, m = n0 + n;
    if (n >= ncol || t >= tc) continue;
    float y0[4], y1[4];                    // outputs m and m + 1, by band
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int f = x & 1;                 // LL, HL: lowpass; LH, HH: high
      const int odd = bk.off[f] & 1;
      const int e = ((m + odd - bk.off[f]) >> 1) - cb0;
      float ze, zo;
      if (p.staged) {
        const float* src =
            s_band + (x * p.in_rows + i) * sw + lead[x] + e * p.chans + t;
        auto ve = [&](int k) { return src[-k * p.chans]; };
        auto vo = [&](int k) { return src[-(k + odd) * p.chans]; };
        ze = f ? up_chain<NT, EXACT, 0>(bk.len[1], tap1, ve)
               : up_chain<NT, EXACT, 0>(bk.len[0], tap0, ve);
        zo = f ? up_chain<NT, EXACT, 1>(bk.len[1], tap1, vo)
               : up_chain<NT, EXACT, 1>(bk.len[0], tap0, vo);
      } else {
        const float* src = bands[x] +
                           (long long)wrap(rb0 + i, h) * w * T + t0 + t;
        auto ve = [&](int k) {
          return __ldg(src + (long long)wrap(cb0 + e - k, w) * T);
        };
        auto vo = [&](int k) {
          return __ldg(src + (long long)wrap(cb0 + e - k - odd, w) * T);
        };
        ze = f ? up_chain<NT, EXACT, 0>(bk.len[1], tap1, ve)
               : up_chain<NT, EXACT, 0>(bk.len[0], tap0, ve);
        zo = f ? up_chain<NT, EXACT, 1>(bk.len[1], tap1, vo)
               : up_chain<NT, EXACT, 1>(bk.len[0], tap0, vo);
      }
      y0[x] = odd ? zo : ze;
      y1[x] = odd ? ze : zo;
    }
    float* row = s_rows + i * nw + n * p.chans + t;
    row[0] = __fadd_rn(y0[0], y0[1]);
    row[p.chans] = __fadd_rn(y1[0], y1[1]);
    row[p.in_rows * nw] = __fadd_rn(y0[2], y0[3]);
    row[p.in_rows * nw + p.chans] = __fadd_rn(y1[2], y1[3]);
  }
  __syncthreads();

  // row pass: the lowpass over the first row band plus the highpass over
  // the second, a pair of output rows a thread, each output written once
  for (Walk it(nw, p.chans); 2 * it.row < mmax; it.next()) {
    const int m = m0 + 2 * it.row;
    if (it.n >= ncol || it.t >= tc) continue;
    float y0[2], y1[2];
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      const int odd = bk.off[f] & 1;
      const float* src =
          s_rows + (f * p.in_rows + ((m + odd - bk.off[f]) >> 1) - rb0) * nw +
          it.l;
      auto ve = [&](int k) { return src[-k * nw]; };
      auto vo = [&](int k) { return src[-(k + odd) * nw]; };
      const float ze = f ? up_chain<NT, EXACT, 0>(bk.len[1], tap1, ve)
                         : up_chain<NT, EXACT, 0>(bk.len[0], tap0, ve);
      const float zo = f ? up_chain<NT, EXACT, 1>(bk.len[1], tap1, vo)
                         : up_chain<NT, EXACT, 1>(bk.len[0], tap0, vo);
      y0[f] = odd ? zo : ze;
      y1[f] = odd ? ze : zo;
    }
    float* o = out + ((long long)b * H + m) * W * T +
               (long long)(n0 + it.n) * T + t0 + it.t;
    o[0] = __fadd_rn(y0[0], y0[1]);
    o[(long long)W * T] = __fadd_rn(y1[0], y1[1]);
  }
}

// Shared memory of a plan; in_rows / in_cols filled in from the tile.
// Analysis: the staged rows 2 rows + span - 1 (span = the largest len - 1
// + shift less the least shift), columns likewise, and the row pass's
// (2, rows, staged columns, even ones first, rounded up to 4 floats).
// Synthesis: the staged band rows floor((rows - 1 - least phase) / 2) -
// floor(-a_hi / 2) + 1 (the tile begins at an even row), columns
// likewise, four bands of them, and the column pass's (2, staged rows,
// cols).
void size_plan(DwtPlan& p, const DwtBank& bk, bool synthesis) {
  const int lo = std::min(bk.off[0], bk.off[1]);
  const int hi = std::max(bk.len[0] - 1 + bk.off[0], bk.len[1] - 1 + bk.off[1]);
  long long floats = taps_padded(bk);
  if (!synthesis) {
    p.in_rows = 2 * p.rows + hi - lo - 1;
    p.in_cols = 2 * p.cols + hi - lo - 1;
  } else {
    p.in_rows = floor_half(p.rows - 1 - lo) - floor_half(-hi) + 1;
    p.in_cols = floor_half(p.cols - 1 - lo) - floor_half(-hi) + 1;
  }
  p.in_stride = (p.in_cols * p.chans + 6) / 4 * 4;
  const long long staged = p.staged ? (long long)p.in_rows * p.in_stride : 0;
  if (!synthesis) {
    const long long mw = ((p.in_cols + 1) / 2 * 2LL * p.chans + 3) / 4 * 4;
    floats += staged + 2LL * p.rows * mw;
  } else {
    floats += 4 * staged + 2LL * p.in_rows * p.cols * p.chans;
  }
  p.smem = 4 * floats;
}

// The plan of one level: rows x cols the output's (analysis: H/2 x W/2,
// synthesis: 2h x 2w), T the trailing elements.  The first tile cut to
// the level, then halved (columns, rows, trailing chunk; synthesis keeps
// rows and columns even) until it fits DWT_SMEM_TARGET; at its least size
// it may take up to DWT_SMEM_MAX; past that, unstaged.  Returns false when
// nothing fits.
bool dwt_plan(const DwtBank& bk, bool synthesis, int B, int rows, int cols,
              int T, DwtPlan* out) {
  const int step = synthesis ? 2 : 1;
  auto shrink = [step](int v) {
    return step == 2 ? std::max(2, (v / 2 + 1) & ~1) : (v + 1) / 2;
  };
  for (int staged = 1; staged >= 0; --staged) {
    DwtPlan p;
    p.rows = std::min(synthesis ? DWT_SY_ROWS : DWT_AN_ROWS, rows);
    p.cols = std::min(synthesis ? DWT_SY_COLS : DWT_AN_COLS, cols);
    p.chans = T;
    p.staged = staged;
    for (;;) {
      size_plan(p, bk, synthesis);
      if (p.smem <= DWT_SMEM_TARGET) break;
      if (p.cols > step) p.cols = shrink(p.cols);
      else if (p.rows > step) p.rows = shrink(p.rows);
      else if (p.chans > 1) p.chans = (p.chans + 1) / 2;
      else break;
    }
    if (p.smem <= DWT_SMEM_MAX) {
      p.tiles = (long long)B * ((T + p.chans - 1) / p.chans) *
                ((rows + p.rows - 1) / p.rows) *
                ((cols + p.cols - 1) / p.cols);
      *out = p;
      return true;
    }
  }
  return false;
}

}  // namespace vcf

namespace {

// The ints of a bank (analysis: eight; synthesis: four, its chains fuse
// no first pair) and, when both filters have at most DWT_UNROLL taps, the
// taps (host) into the launch's bank; false for a bad bank.
bool read_bank(const int* a, const float* taps, bool synthesis,
               vcf::DwtBank* bk) {
  std::memset(bk, 0, sizeof(*bk));
  for (int f = 0; f < 2; ++f) {
    bk->len[f] = a[f];
    bk->off[f] = a[2 + f];
    if (!synthesis) {
      bk->fuse_rows[f] = a[4 + f];
      bk->fuse_cols[f] = a[6 + f];
    }
    if (a[f] < 1) return false;
  }
  if (taps && bk->len[0] <= vcf::DWT_UNROLL && bk->len[1] <= vcf::DWT_UNROLL)
    for (int f = 0; f < 2; ++f)
      std::copy(taps + (f ? bk->len[0] : 0),
                taps + (f ? bk->len[0] : 0) + bk->len[f], bk->taps[f]);
  return true;
}

template <typename K>
int set_smem(K kernel, long long smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// launch.run<NT, EXACT>() for the bank: the instance for its tap count
// where both filters have the same one of 2, 4, ..., 12 (haar, db, sym,
// coif up to 12 taps; db5, the cell's, has 10), else the one unrolled to
// DWT_UNROLL taps, else plain loops.
template <typename Launch>
int dispatch(const vcf::DwtBank& bk, const Launch& launch) {
  if (bk.len[0] == bk.len[1]) {
    switch (bk.len[0]) {
      case 2: return launch.template run<2, true>();
      case 4: return launch.template run<4, true>();
      case 6: return launch.template run<6, true>();
      case 8: return launch.template run<8, true>();
      case 10: return launch.template run<10, true>();
      case 12: return launch.template run<12, true>();
      default: break;
    }
  }
  if (bk.len[0] <= vcf::DWT_UNROLL && bk.len[1] <= vcf::DWT_UNROLL)
    return launch.template run<vcf::DWT_UNROLL, false>();
  return launch.template run<0, false>();
}

struct Analyze {
  const float *x, *taps;
  float* out;
  const vcf::DwtBank& bk;
  int B, H, W, T;
  const vcf::DwtPlan& p;
  cudaStream_t st;
  template <int NT, bool EXACT>
  int run() const {
    auto kernel = &vcf::dwt_analyze_level_kernel<NT, EXACT>;
    const int err = set_smem(kernel, p.smem);
    if (err) return err;
    kernel<<<(unsigned)p.tiles, vcf::DWT_THREADS, (size_t)p.smem, st>>>(
        x, out, taps, bk, B, H, W, T, p, std::min(bk.off[0], bk.off[1]));
    return (int)cudaGetLastError();
  }
};

struct Synthesize {
  const float *ll, *lh, *hl, *hh, *taps;
  float* out;
  const vcf::DwtBank& bk;
  int B, h, w, T;
  const vcf::DwtPlan& p;
  cudaStream_t st;
  template <int NT, bool EXACT>
  int run() const {
    auto kernel = &vcf::dwt_synthesize_level_kernel<NT, EXACT>;
    const int err = set_smem(kernel, p.smem);
    if (err) return err;
    kernel<<<(unsigned)p.tiles, vcf::DWT_THREADS, (size_t)p.smem, st>>>(
        ll, lh, hl, hh, out, taps, bk, B, h, w, T, p,
        std::max(bk.len[0] - 1 + bk.off[0], bk.len[1] - 1 + bk.off[1]));
    return (int)cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// The plan a level of `bank` (vcf_dwt_analyze's eight ints /
// vcf_dwt_synthesize's four) takes for B frames of the level's input rows x cols
// (analysis: x's H x W, even; synthesis: a band's h x w) and T trailing
// elements: plan[0..6] = output rows, output columns and trailing elements
// a tile, staged rows and columns, staged (1) or read from device memory
// (0), shared memory bytes; plan[7] the tiles.  Returns 0, or
// cudaErrorInvalidValue.
int vcf_dwt_plan(int synthesis, const int* bank, int B, int rows, int cols,
                 int T, long long* plan) {
  vcf::DwtBank bk;
  vcf::DwtPlan p;
  if (!read_bank(bank, nullptr, synthesis != 0, &bk) || B < 1 || T < 1 ||
      rows < 1 || cols < 1 || (!synthesis && (rows % 2 || cols % 2)))
    return (int)cudaErrorInvalidValue;
  const int orow = synthesis ? 2 * rows : rows / 2;
  const int ocol = synthesis ? 2 * cols : cols / 2;
  if (!vcf::dwt_plan(bk, synthesis, B, orow, ocol, T, &p) ||
      p.tiles >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const long long v[8] = {p.rows, p.cols,   p.chans, p.in_rows,
                          p.in_cols, p.staged, p.smem, p.tiles};
  std::copy(v, v + 8, plan);
  return 0;
}

// x (B, H, W, T) f32, out (2, 2, B, H/2, W/2, T) f32, taps_dev (len_lo +
// len_hi) f32, all on the device, contiguous; taps the same on the host;
// bank (host) len_lo, len_hi, shift_lo, shift_hi, and whether each
// filter's first pair fuses its first product along H (lo, hi) and along
// W (lo, hi).  H, W even.
int vcf_dwt_analyze(const void* x, void* out, const void* taps_dev,
                    const float* taps, const int* bank, int B, int H, int W,
                    int T, void* stream) {
  vcf::DwtBank bk;
  vcf::DwtPlan p;
  if (!read_bank(bank, taps, false, &bk) || B < 1 || T < 1 || H < 2 ||
      W < 2 || H % 2 || W % 2 ||
      !vcf::dwt_plan(bk, false, B, H / 2, W / 2, T, &p) ||
      p.tiles >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  return dispatch(bk, Analyze{(const float*)x, (const float*)taps_dev,
                              (float*)out, bk, B, H, W, T, p,
                              (cudaStream_t)stream});
}

// ll, lh, hl, hh (B, h, w, T) f32, out (B, 2h, 2w, T) f32, taps_dev
// (len_lo + len_hi) f32, all on the device, contiguous; taps the same on
// the host; bank (host) len_lo, len_hi, phase_lo, phase_hi.
int vcf_dwt_synthesize(const void* ll, const void* lh, const void* hl,
                       const void* hh, void* out, const void* taps_dev,
                       const float* taps, const int* bank, int B, int h,
                       int w, int T, void* stream) {
  vcf::DwtBank bk;
  vcf::DwtPlan p;
  if (!read_bank(bank, taps, true, &bk) || B < 1 || T < 1 || h < 1 ||
      w < 1 || !vcf::dwt_plan(bk, true, B, 2 * h, 2 * w, T, &p) ||
      p.tiles >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  return dispatch(bk, Synthesize{(const float*)ll, (const float*)lh,
                                 (const float*)hl, (const float*)hh,
                                 (const float*)taps_dev, (float*)out, bk, B,
                                 h, w, T, p, (cudaStream_t)stream});
}

}  // extern "C"
