// The IPP motion kernels: full-search block SAD with the argmin fused in,
// block motion compensation, and the luma the search runs on.
//
// sad_search_kernel replaces, in vcf_tpu/ops/pallas/sad_kernel.py,
// sad_search (:58) and its row-tiled variant sad_search_tiled (:141).  For
// frame g and the m x m block (by, bx) it computes, for every displacement
// d = (dy, dx) in [-s, s]^2 in row-major order,
//   SAD(d) = sum |cur[y][x] - ref[clampH(y + dy)][clampW(x + dx)]|
// (the coordinate clamp is the edge pad of ops/motion.py) and writes the
// (dy, dx) of the FIRST minimum and its SAD.  The TPU kernel wrote a
// (D, nby, nbx) SAD volume to HBM and reduced it in XLA; here the argmin
// stays in the CTA and nothing but the winner leaves it.
//
// What bounds it: arithmetic.  At 1088x1920, m=16, s=8 a frame is 8160
// blocks x 289 displacements x 256 terms (~0.6 G terms) against 8 MB of
// luma read, and a term is a subtract and an add of its absolute value.
// The first design (one thread a displacement, float64 sums out of shared
// memory) loaded 2 shared values a term: shared-memory bandwidth set its
// pace.
//
// Design (m = 4, 8, 16, 32: sad_search_kernel<M, R>).  A CTA takes
// bx_cta horizontally adjacent blocks of one block row (sad_plan picks the
// count that leaves the fewest lanes idle: 15 at m=16, s=8, 255 items in
// 256 threads) and stages their current blocks and the union of their
// clamped reference windows, (M + 2s) rows, once in shared memory, each
// warp a row with 8 loads in flight a thread.  A work item is (block, dy,
// a run of R consecutive dx; R = 17 or 9, whichever covers 2s + 1 with
// fewer slots); a thread takes items in turn and keeps the run's R sums in
// registers.  Per window row it loads chunks of 8 current and 8 + R - 1
// reference values into registers and adds R x 8 terms (32 shared loads
// for 136 terms at R = 17), so the adds, not the loads, set the pace.
// Lanes of a warp are consecutive dy of one run: rows an odd pitch apart,
// so the reference loads meet no bank conflict; the current values are a
// broadcast.
//
// Exactness: every nonzero luma is >= 0.114, so a multiple of 2^-27, and
// a block's SAD is < 2^18, so a float64 sum of |a - b| is exact in any
// order (at most 45 bits).  The argmin compares (sad, d) pairs
// lexicographically, first along a run, then across a block's items (one
// warp a block), so the first minimum wins whatever the order; kernel and
// plain version agree bit for bit on mvs and SADs.  The SAD is cast to
// float32 on output.
//
// The screen: the sums are taken in float32 (FADD, then FADD of the
// absolute value; no multiply, so nothing contracts), at twice the
// float64 add rate, from a float32 window.  For m^2 terms with unit
// roundoff u = 2^-24 the float32 sum F obeys |F - S| <= g S against the
// exact sum S, g = (m^2 + 1) u / (1 - (m^2 + 1) u).  Every d with F_d <=
// F_min (1 + g) / (1 - g) (the factor rounded up) is a candidate: every
// minimiser of S is one, and every other d has S_d > S_min.  F_d = 0 is
// exact (every fl(a - b) was then 0) and needs no second sum; the items
// with other candidates go on a list, whose candidates are summed again in
// float64 (converting the staged values), so the (S, d) minimum over the
// candidates is the answer.  On natural video few displacements are
// candidates (1383 of 16.5 M on the 7-frame test clip): a warp takes each
// listed item (a lane a row), which keeps the CTA's tail short.  Where
// many tie at a nonzero SAD (flat content under a change of light) the
// list is long, and a CTA whose list holds SAD_THREAD_LIST items or more
// gives each listed item to a thread instead (the screen's loop on
// doubles), which issues no shuffles.
//
// Other block sizes take sad_search_generic_kernel, the first design: one
// CTA per block, one thread per displacement, float64 sums out of shared
// memory.  Past the shared-memory gates (an instance's window and lists
// over 227 KiB, the first design's over 48 KiB: m = 16 from s = 77) every
// block size takes its global mode, which reads each term from global
// memory and so takes every range.
//
// mc_kernel replaces mc_apply_planar (vcf_tpu/ops/pallas/mc_kernel.py:115)
// and, as its CHANNEL_LAST mode, mc_apply (:103):
//   out[g][c][y][x] = ref[g][c][clampH(y + mv_y)][clampW(x + mv_x)]
// with (mv_y, mv_x) the vector of the block holding (y, x).  The TPU swept
// all (2s + 1)^2 displacements with a mask-accumulate because XLA gathers
// were slow there; on the card it is a gather.  A copy, so it is
// bit-exact.  What bounds it: memory traffic, each reference value read
// and each output written once (a block's window overlaps its
// neighbours', which L1 and L2 absorb).
//
// Design (mc_vec_kernel, both layouts).  A row is `row` floats: W in the
// planar layout, W * C in the channel-last one, where block bx's part of a
// row is the m * C floats from bx * m * C, in source and destination
// alike, so the channel-last layout is the planar one with C floats a
// pixel (cl) and one plane a frame.  For m % 4 == 0 a block row is a
// multiple of 4 floats, so a run of 4 consecutive outputs never crosses a
// block: a thread takes one run, reads its block's mv once, works out its
// columns once (the run's pixels, a division by cl each, never one per
// element, and whether the clamped window leaves the frame) and walks the
// block's m rows, 4 loads and one 16-byte store a row.  Inside the frame
// the 4 sources are contiguous from q0 + mv_x * cl: 4 scalar loads off one
// address, whose neighbours in a warp hit the same lines in L1 (two
// aligned 16-byte loads and a select by the offset mod 4 were 4-10%
// slower, and 4 clamped offsets in registers for every run 15%:
// mc_ab.py's funnel variant, PERF.md); at a frame edge, 4 loads from the
// clamped columns.  A CTA takes a few warps of runs along the row (spread
// evenly over the CTAs of a row) times MC_VEC_ROWS rows (whole blocks; m
// rows for m = 32): 5,712 CTAs of 128 threads at 7 x 3 x 1088 x 1920,
// 1,632 at the IPP loops' 2 frames, where the first design ran one CTA per
// 256 elements of a row (183 k CTAs at 7 frames), reloading the mv and
// dividing by C in every thread, with 4-byte stores.  What is left over
// the bound is the gather: the kernel as a plain copy (every mv 0) takes
// 1.22x the bound, and random vertical displacements, which spread a
// warp's loads over up to 8 rows, most of the rest (mc_ab.py's copy and
// novy variants).
// The vector mode needs m % 4 == 0 and 16-byte aligned ref and out
// (vcf_mc_mode); every other shape (m = 5, 6, a storage offset) takes
// mc_kernel, the first design, kept as the generic mode: one thread per
// output element.
//
// luma_kernel replaces no TPU kernel: vcf_tpu's planar IPP loop takes its
// lumas as an XLA dot (vcf_tpu/video/ipp.py:409-410).  It maps a 3-channel
// axis to a float32 luma plane by the chain ops/color.py fma_rows
// evaluates,
//   l = fma(x2, w2, fma(x1, w1, x0 * w0)),
// each step by an _rn intrinsic, so nvcc neither contracts nor reorders;
// ROUND applies rintf (half to even, as torch.round) to each channel
// first.  For pixel-sized integers fma_rows' float64 steps round as this
// chain does, so the two agree bit for bit.  The input is float32 or
// uint8, planar (G, 3, H, W) or a channels-last view (G, H, W, 3) with a
// pixel stride of 3, read where it lies, with no copy first.
// What bounds it: bytes.  At 8 x 3 x 1088 x 1920 float32 it reads 200.5 MB
// and writes 66.8 MB, three operations a pixel.  Design: a thread takes a
// group of 4 pixels along W as three aligned quad loads (4 elements: 16
// bytes of float32, 4 of uint8), one a channel in the planar mode, the
// group's whole 3-channel run (48 or 12 bytes) in the channels-last mode,
// and stores its 4 lumas as one 16-byte word, so a warp's stores are one
// contiguous 512-byte run and every byte moves once; a grid-stride loop
// over the groups, 8 CTAs of 256 threads an SM.  W % 4 != 0, a view off
// quad alignment or any other strides take the scalar mode of the same
// kernel, a thread a pixel (vcf_luma_mode, chosen by the input's pointer
// and strides).

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

namespace vcf {

// generic mode: its window in the 48 KB a launch gets without opt-in
constexpr int SAD_MAX_SMEM = 48 * 1024;
constexpr int SAD_MAX_THREADS = 1024;
// the block-size instances
constexpr int SAD_RUN_SHORT = 9;        // dx values a work item sums: 9 or
constexpr int SAD_RUN_LONG = 17;        // 17, whichever wastes fewer
constexpr int SAD_CHUNK = 8;            // current values a register chunk
constexpr int SAD_STAGE = 8;            // loads in flight a staging thread
constexpr int SAD_CTA_THREADS = 320;
constexpr int SAD_THREAD_LIST = 64;     // a list this long: a thread an item
constexpr int SAD_MAX_BLOCKS = 32;      // blocks a CTA may take
constexpr int SAD_SMEM_TARGET = 100 * 1024;   // two CTAs an SM
constexpr int SAD_OPTIN_SMEM = 227 * 1024;    // one block's CTA at most
constexpr int MC_THREADS = 256;         // the generic mode's CTA
constexpr int MC_VEC = 4;               // outputs a run (one float4)
constexpr int MC_VEC_WARPS = 4;         // most warps of runs a CTA
constexpr int MC_VEC_ROWS = 16;         // rows a CTA (at least one block)
constexpr int LUMA_THREADS = 256;
constexpr int LUMA_CTAS_SM = 8;         // CTAs an SM: 2048 threads
// luma_kernel's modes (vcf_luma_mode)
constexpr int LUMA_PLANAR = 0;          // vector, (G, 3, H, W)
constexpr int LUMA_CHANNEL_LAST = 1;    // vector, (G, H, W, 3)
constexpr int LUMA_SCALAR = 2;          // any strides, a thread a pixel

// The run length for n = 2s + 1 displacements a row: the one whose runs
// cover n with fewer slots (17 for s = 8, 9 for s = 4).
__host__ __device__ inline int sad_run_for(int n) {
  const int r_long = (n + SAD_RUN_LONG - 1) / SAD_RUN_LONG * SAD_RUN_LONG;
  const int r_short = (n + SAD_RUN_SHORT - 1) / SAD_RUN_SHORT * SAD_RUN_SHORT;
  return r_long <= r_short ? SAD_RUN_LONG : SAD_RUN_SHORT;
}

// Row pitch of the staged window, in elements: the columns bx blocks need
// (the last run may reach past dx = 2s), made odd.
__host__ __device__ inline int sad_pitch(int m, int s, int bx, int run) {
  const int runs = (2 * s + run) / run;
  return ((bx - 1) * m + runs * run - 1 + m) | 1;
}

// Dynamic shared memory of a CTA of bx blocks: each item's best sum and
// displacement, the window and the current blocks (each padded by one
// element) in float32, each item's float32 sums, a block's minimum and
// the list of items to refine.
inline long long sad_smem(int m, int s, int bx) {
  const int n = 2 * s + 1, run = sad_run_for(n);
  const long long items = (long long)bx * n * ((n + run - 1) / run);
  const long long stage = (long long)(m + 2 * s) * sad_pitch(m, s, bx, run) +
                          (long long)bx * (m * m + 1);
  return 4 * stage + (16 + 4LL * run) * items + 4 * bx;
}

template <typename D>
__device__ __forceinline__ bool sad_better(double a, D da, double b, D db) {
  return a < b || (a == b && da < db);
}

__device__ __forceinline__ double abs_diff(double a, double b) {
  return fabs(a - b);
}
__device__ __forceinline__ float abs_diff(float a, float b) {
  return fabsf(a - b);
}

// acc[k] += sum over xx < M of |cb[xx] - rb[xx + k]|, k < R, in type A
// (float: the screen; double: the exact sums, each value converted), in
// chunks of C current values and C + R - 1 reference values held in
// registers.
template <int M, int C, int R, typename A>
__device__ __forceinline__ void sad_row(const float* cb, const float* rb,
                                        A (&acc)[R]) {
#pragma unroll
  for (int x0 = 0; x0 < M; x0 += C) {
    A cv[C], rv[C + R - 1];
#pragma unroll
    for (int j = 0; j < C; ++j) cv[j] = A(cb[x0 + j]);
#pragma unroll
    for (int j = 0; j < C + R - 1; ++j) rv[j] = A(rb[x0 + j]);
#pragma unroll
    for (int k = 0; k < R; ++k)
#pragma unroll
      for (int j = 0; j < C; ++j) acc[k] += abs_diff(cv[j], rv[j + k]);
  }
}

// Stage n_rows rows of `cols` values: store(i, c, load(i, c)) for row i
// and column c, one warp a row, SAD_STAGE loads in flight a thread.
template <typename Load, typename Store>
__device__ __forceinline__ void sad_stage(int n_rows, int cols, Load load,
                                          Store store) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < n_rows; i += blockDim.x >> 5)
    for (int c0 = 0; c0 < cols; c0 += 32 * SAD_STAGE) {
      float v[SAD_STAGE];
#pragma unroll
      for (int u = 0; u < SAD_STAGE; ++u) {
        const int c = c0 + 32 * u + lane;
        v[u] = c < cols ? load(i, c) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < SAD_STAGE; ++u) {
        const int c = c0 + 32 * u + lane;
        if (c < cols) store(i, c, v[u]);
      }
    }
}

// The screen's candidates among an item's R float32 sums f[k] (+inf past
// dx = 2s): `zero` those whose sum is 0 (exact: every fl(a - b) was 0),
// `refine` the others within the rounding bound of the block's minimum
// fmin.  With g = (M^2 + 1) u / (1 - (M^2 + 1) u), u = 2^-24, bounding
// |F - S| / S, every minimiser d of S has F_d (1 - g) <= F_min (1 + g);
// the test F_d <= F_min K takes K = (1 + g) / (1 - g) rounded up past the
// float32 product's rounding, so it keeps every minimiser (and perhaps a
// few more candidates, each summed exactly).  A zero sum makes fmin 0, so
// an item with candidates to refine has no zero sums.
template <int M, int R>
__device__ __forceinline__ void sad_candidates(const float* f, float fmin,
                                               unsigned& zero,
                                               unsigned& refine) {
  constexpr double g = (M * M + 1) * 0x1p-24 / (1.0 - (M * M + 1) * 0x1p-24);
  constexpr float K = (float)((1.0 + g) / (1.0 - g) * (1.0 + 0x1p-20));
  const float lim = fmin * K;
  zero = refine = 0;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    if (f[k] == 0.0f)
      zero |= 1u << k;
    else if (f[k] <= lim)
      refine |= 1u << k;
  }
}

// Fold the float64 sum v of displacement d into (best, best_d); callers
// go in ascending d, so the strict < keeps the first minimum.
__device__ __forceinline__ void sad_fold(double v, int d, double& best,
                                         int& best_d) {
  if (v < best) {
    best = v;
    best_d = d;
  }
}

// An item's `refine` candidates in float64 by one warp, for short lists:
// a lane a row, 32 / M groups of M lanes each summing RR of the R
// displacements (M = 32: one group, passes of 9), each sum added over its
// group's lanes.  A group's last displacements may lie past R: their sums
// read columns past the run and are never used.
template <int M, int R>
__device__ __forceinline__ void sad_refine_warp(const float* cb,
                                                const float* rb, int pitch,
                                                unsigned refine, int d0,
                                                double& best, int& best_d) {
  constexpr int G = M < 32 ? 32 / M : 1;
  constexpr int RR = G > 1 ? (R + G - 1) / G : SAD_RUN_SHORT;
  constexpr int PASSES = (R + G * RR - 1) / (G * RR);
  const int lane = threadIdx.x & 31, row = lane % M, grp = lane / M;
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    if ((refine >> (p * G * RR)) == 0) break;
    double acc[RR];
#pragma unroll
    for (int k = 0; k < RR; ++k) acc[k] = 0.0;
    sad_row<M, 4>(cb + row * M, rb + row * pitch + (p * G + grp) * RR, acc);
#pragma unroll
    for (int k = 0; k < RR; ++k)
#pragma unroll
      for (int off = M / 2; off > 0; off >>= 1)
        acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
#pragma unroll
    for (int g2 = 0; g2 < G; ++g2)
#pragma unroll
      for (int kk = 0; kk < RR; ++kk) {
        const int k = (p * G + g2) * RR + kk;
        const double sum = __shfl_sync(0xffffffffu, acc[kk], g2 * M);
        if (k < R && (refine >> k & 1u)) sad_fold(sum, d0 + k, best, best_d);
      }
  }
}

// An item's `refine` candidates in float64 by one thread, for long lists
// (where a warp an item would issue its shuffles for every item): the
// screen's loop on doubles, in passes of RH displacements (half a run of
// 17: the registers of three CTAs an SM).  The second pass's last sum
// reads a column past the run and is never used.
template <int M, int R>
__device__ __forceinline__ void sad_refine_thread(const float* cb,
                                                  const float* rb, int pitch,
                                                  unsigned refine, int d0,
                                                  double& best,
                                                  int& best_d) {
  constexpr int RH = R > SAD_RUN_SHORT ? (R + 1) / 2 : R;
#pragma unroll
  for (int k0 = 0; k0 < R; k0 += RH) {
    if ((refine >> k0) == 0) break;
    double acc[RH];
#pragma unroll
    for (int k = 0; k < RH; ++k) acc[k] = 0.0;
    for (int yy = 0; yy < M; ++yy)
      sad_row<M, 4>(cb + yy * M, rb + yy * pitch + k0, acc);
#pragma unroll
    for (int k = 0; k < RH; ++k)
      if (k0 + k < R && (refine >> (k0 + k) & 1u))
        sad_fold(acc[k], d0 + k0 + k, best, best_d);
  }
}

// ref, cur (G, H, W) f32; mv (G, nby, nbx, 2) i32; sad (G, nby, nbx) f32;
// n_refined (nullable; 2 counts) gets the screen's candidates summed
// again in float64 and the CTAs that gave a listed item to a thread.  Grid (ceil(nbx / bx_cta), nby, G); blockDim a multiple of 32,
// at most SAD_CTA_THREADS; R = sad_run_for(2s + 1); dynamic shared memory
// sad_smem(M, s, bx_cta).
template <int M, int R>
__global__ void __launch_bounds__(SAD_CTA_THREADS, 3)
sad_search_kernel(const float* __restrict__ ref,
                  const float* __restrict__ cur, int* __restrict__ mv,
                  float* __restrict__ sad,
                  unsigned long long* __restrict__ n_refined, int H, int W,
                  int s, int bx_cta) {
  constexpr int BLK = M * M + 1;  // a staged block, padded off the banks
  constexpr int C = M < SAD_CHUNK ? M : SAD_CHUNK;
  extern __shared__ double s_mem[];
  __shared__ int s_n_list;
  const int n = 2 * s + 1, runs = (n + R - 1) / R, pb = n * runs;
  const int items = bx_cta * pb;
  const int rows = M + 2 * s, pitch = sad_pitch(M, s, bx_cta, R);
  const int nbx = W / M, bx0 = blockIdx.x * bx_cta;
  const int by = blockIdx.y, g = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  // each item's (sad, d) best, the window, the current blocks, each
  // item's float32 sums, each block's minimum (as the bits of a
  // non-negative float, which order as ints), the items to refine
  double* s_best = s_mem;
  float* s_ref = reinterpret_cast<float*>(s_best + items);
  float* s_cur = s_ref + rows * pitch;
  int* s_d = reinterpret_cast<int*>(s_cur + bx_cta * BLK);
  float* s_f = reinterpret_cast<float*>(s_d + items);
  int* s_fmin = reinterpret_cast<int*>(s_f + items * R);
  int* s_list = s_fmin + bx_cta;

  const size_t plane = (size_t)H * W;
  const float* r = ref + g * plane;
  const float* c = cur + g * plane;
  const int y0 = by * M - s, x0 = bx0 * M - s;
  sad_stage(
      rows, pitch,
      [&](int i, int x) {
        return r[(size_t)min(max(y0 + i, 0), H - 1) * W +
                 min(max(x0 + x, 0), W - 1)];
      },
      [&](int i, int x, float v) { s_ref[i * pitch + x] = v; });
  // row yy of the CTA's blocks is one run of bx_cta * M values; a block
  // past the row's end repeats the last column (its result is dropped)
  sad_stage(
      M, bx_cta * M,
      [&](int yy, int x) {
        return c[(size_t)(by * M + yy) * W + min(bx0 * M + x, W - 1)];
      },
      [&](int yy, int x, float v) {
        s_cur[(x / M) * BLK + yy * M + x % M] = v;
      });
  if (threadIdx.x == 0) s_n_list = 0;
  for (int b = threadIdx.x; b < bx_cta; b += blockDim.x)
    s_fmin[b] = 0x7f800000;  // +inf
  __syncthreads();

  // item it = (b, run, dy), dy fastest: its R float32 sums, row-major term
  // order, and the block's minimum
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int dy = it % n, q = it / n, run = q % runs, b = q / runs;
    const int dx0 = run * R;
    const float* cb = s_cur + b * BLK;
    const float* rb = s_ref + dy * pitch + b * M + dx0;
    float acc[R];
#pragma unroll
    for (int k = 0; k < R; ++k) acc[k] = 0.0f;
    for (int yy = 0; yy < M; ++yy, cb += M, rb += pitch)
      sad_row<M, C>(cb, rb, acc);
    float fmin = __int_as_float(0x7f800000);
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const float f = dx0 + k < n ? acc[k] : __int_as_float(0x7f800000);
      s_f[it * R + k] = f;
      fmin = fminf(fmin, f);
    }
    atomicMin(&s_fmin[b], __float_as_int(fmin));
  }
  __syncthreads();

  const double inf = __longlong_as_double(0x7ff0000000000000LL);
  // items whose candidates are all zero sums are done; the others go on
  // the list
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int dy = it % n, q = it / n, run = q % runs, b = q / runs;
    unsigned zero, refine;
    sad_candidates<M, R>(s_f + it * R, __int_as_float(s_fmin[b]), zero,
                         refine);
    if (refine != 0) {
      s_list[atomicAdd(&s_n_list, 1)] = it;
      if (n_refined != nullptr) atomicAdd(n_refined, __popc(refine));
    } else {
      // the first zero sum, if any (every minimiser is a candidate)
      s_best[it] = zero != 0 ? 0.0 : inf;
      s_d[it] = zero != 0 ? dy * n + run * R + __ffs(zero) - 1 : n * n;
    }
  }
  __syncthreads();

  // the listed items' candidates in float64: a thread an item once the
  // list is long (ties over flat content), else a warp an item
  const int n_list = s_n_list;
  const bool by_thread = n_list >= SAD_THREAD_LIST;
  if (by_thread && threadIdx.x == 0 && n_refined != nullptr)
    atomicAdd(n_refined + 1, 1ULL);
  const int step = by_thread ? blockDim.x : n_warps;
  for (int e = by_thread ? threadIdx.x : warp; e < n_list; e += step) {
    const int it = s_list[e];
    const int dy = it % n, q = it / n, run = q % runs, b = q / runs;
    unsigned zero, refine;
    sad_candidates<M, R>(s_f + it * R, __int_as_float(s_fmin[b]), zero,
                         refine);
    const float* cb = s_cur + b * BLK;
    const float* rb = s_ref + dy * pitch + b * M + run * R;
    double best = inf;
    int best_d = n * n;
    if (by_thread) {
      sad_refine_thread<M, R>(cb, rb, pitch, refine, dy * n + run * R, best,
                              best_d);
    } else {
      sad_refine_warp<M, R>(cb, rb, pitch, refine, dy * n + run * R, best,
                            best_d);
      if (lane != 0) continue;
    }
    s_best[it] = best;
    s_d[it] = best_d;
  }
  __syncthreads();

  // each block's (sad, d) minimum over its items, one warp a block
  for (int b = warp; b < bx_cta; b += n_warps) {
    double best = inf;
    int best_d = n * n;
    for (int i = lane; i < pb; i += 32)
      if (sad_better(s_best[b * pb + i], s_d[b * pb + i], best, best_d)) {
        best = s_best[b * pb + i];
        best_d = s_d[b * pb + i];
      }
    for (int off = 16; off > 0; off >>= 1) {
      const double o = __shfl_down_sync(0xffffffffu, best, off);
      const int od = __shfl_down_sync(0xffffffffu, best_d, off);
      if (sad_better(o, od, best, best_d)) {
        best = o;
        best_d = od;
      }
    }
    if (lane == 0 && bx0 + b < nbx) {
      const size_t blk = ((size_t)g * gridDim.y + by) * nbx + bx0 + b;
      mv[2 * blk] = best_d / n - s;
      mv[2 * blk + 1] = best_d % n - s;
      sad[blk] = (float)best;
    }
  }
}

// The first design, for block sizes without an instance, and for every
// (m, s) past the shared-memory gates.  Grid (nbx, nby, G); blockDim a
// multiple of 32.  STAGED: the clamped (m + 2s)^2 window and the m x m
// block in dynamic shared memory as doubles (vcf_sad_smem bytes).
// Otherwise (the global mode) each term is read from global memory: a
// warp's lanes take consecutive displacements, mostly consecutive dx, so
// their reference loads are coalesced and their current value is one
// address; the window's rows stay in L1/L2.  Displacements count in 64
// bits, so the global mode takes any s.  Its sums stay exact for m <= 512
// (m^2 terms below 2^8, multiples of 2^-27: under 2^53).
template <bool STAGED>
__global__ void sad_search_generic_kernel(const float* __restrict__ ref,
                                          const float* __restrict__ cur,
                                          int* __restrict__ mv,
                                          float* __restrict__ sad, int H,
                                          int W, int m, int s) {
  extern __shared__ double s_mem[];
  __shared__ double w_sad[SAD_MAX_THREADS / 32];
  __shared__ unsigned long long w_d[SAD_MAX_THREADS / 32];
  const int bx = blockIdx.x, by = blockIdx.y, g = blockIdx.z;
  const size_t plane = (size_t)H * W;
  const float* r = ref + g * plane;
  const float* c = cur + g * plane;
  const int win = STAGED ? m + 2 * s : 0;
  double* s_ref = s_mem;
  double* s_cur = s_mem + win * win;
  if (STAGED) {
    const int y0 = by * m - s, x0 = bx * m - s;
    for (int i = threadIdx.x; i < win * win; i += blockDim.x) {
      const int wy = i / win, wx = i - wy * win;
      const int y = min(max(y0 + wy, 0), H - 1);
      const int x = min(max(x0 + wx, 0), W - 1);
      s_ref[i] = (double)r[(size_t)y * W + x];
    }
    for (int i = threadIdx.x; i < m * m; i += blockDim.x) {
      const int yy = i / m, xx = i - yy * m;
      s_cur[i] = (double)c[(size_t)(by * m + yy) * W + bx * m + xx];
    }
    __syncthreads();
  }

  // n^2 < 2^64 for every int s >= 0
  const unsigned long long n = 2ULL * s + 1, n_disp = n * n;
  double best = __longlong_as_double(0x7ff0000000000000LL);  // +inf
  unsigned long long best_d = n_disp;                          // none
  // each thread visits its displacements in increasing order, so a strict
  // < keeps its first minimum
  for (unsigned long long d = threadIdx.x; d < n_disp; d += blockDim.x) {
    const long long dy = (long long)(d / n), dx = (long long)(d % n);
    double acc = 0.0;
    if (STAGED) {
      for (int yy = 0; yy < m; ++yy) {
        const double* rr = s_ref + (yy + (int)dy) * win + (int)dx;
        const double* cc = s_cur + yy * m;
        for (int xx = 0; xx < m; ++xx) acc += fabs(cc[xx] - rr[xx]);
      }
    } else {
      const long long y0 = (long long)by * m + dy - s;
      const long long x0 = (long long)bx * m + dx - s;
      for (int yy = 0; yy < m; ++yy) {
        const long long y = min(max(y0 + yy, 0LL), (long long)H - 1);
        const float* rr = r + (size_t)y * W;
        const float* cc = c + (size_t)(by * m + yy) * W + (size_t)bx * m;
        for (int xx = 0; xx < m; ++xx) {
          const long long x = min(max(x0 + xx, 0LL), (long long)W - 1);
          acc += fabs((double)__ldg(cc + xx) - (double)__ldg(rr + x));
        }
      }
    }
    if (acc < best) {
      best = acc;
      best_d = d;
    }
  }
  // CTA argmin over (sad, d) pairs: warp shuffles, then the first warp
  for (int off = 16; off > 0; off >>= 1) {
    const double o = __shfl_down_sync(0xffffffffu, best, off);
    const unsigned long long od = __shfl_down_sync(0xffffffffu, best_d, off);
    if (sad_better(o, od, best, best_d)) {
      best = o;
      best_d = od;
    }
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  if (lane == 0) {
    w_sad[warp] = best;
    w_d[warp] = best_d;
  }
  __syncthreads();
  if (warp == 0) {
    best = lane < n_warps ? w_sad[lane]
                          : __longlong_as_double(0x7ff0000000000000LL);
    best_d = lane < n_warps ? w_d[lane] : n_disp;
    for (int off = 16; off > 0; off >>= 1) {
      const double o = __shfl_down_sync(0xffffffffu, best, off);
      const unsigned long long od = __shfl_down_sync(0xffffffffu, best_d, off);
      if (sad_better(o, od, best, best_d)) {
        best = o;
        best_d = od;
      }
    }
    if (lane == 0) {
      const size_t blk = ((size_t)g * gridDim.y + by) * gridDim.x + bx;
      mv[2 * blk] = (int)((long long)(best_d / n) - s);
      mv[2 * blk + 1] = (int)((long long)(best_d % n) - s);
      sad[blk] = (float)best;
    }
  }
}

// ref and out (G, C, H, W) f32, or (G, H, W, C) with CHANNEL_LAST; mv
// (G, H / m, W / m, 2) i32.  Grid (ceil(row / MC_THREADS), H, G or G * C),
// row = W (planar) or W * C (channel-last): one thread per element.
template <bool CHANNEL_LAST>
__global__ void __launch_bounds__(MC_THREADS)
mc_kernel(const float* __restrict__ ref, const int* __restrict__ mv,
          float* __restrict__ out, int C, int H, int W, int m) {
  const int row = CHANNEL_LAST ? W * C : W;
  const int q = blockIdx.x * MC_THREADS + threadIdx.x;
  if (q >= row) return;
  const int y = blockIdx.y;
  const int x = CHANNEL_LAST ? q / C : q;
  const int g = CHANNEL_LAST ? blockIdx.z : blockIdx.z / C;
  const int nby = H / m, nbx = W / m;
  const int* v = mv + 2 * (((size_t)g * nby + y / m) * nbx + x / m);
  const int sy = min(max(y + v[0], 0), H - 1);
  const int sx = min(max(x + v[1], 0), W - 1);
  // blockIdx.z indexes (G) row planes of H rows in both modes
  const size_t plane = (size_t)blockIdx.z * H;
  if (CHANNEL_LAST)
    out[(plane + y) * row + q] =
        ref[(plane + sy) * row + (size_t)sx * C + (q - x * C)];
  else
    out[(plane + y) * row + q] = ref[(plane + sy) * row + sx];
}

// The vector mode.  ref and out: planes of H rows of cl * W floats (planar:
// G * C planes, cl = 1, ppg = C planes a frame; channel-last: G planes,
// cl = C, ppg = 1), 16-byte aligned, m % 4 == 0; mv (G, H / m, W / m, 2).
// Grid (CTAs along a row, H / rows_cta, planes), rows_cta a multiple of m.
__global__ void __launch_bounds__(MC_VEC_WARPS * 32)
mc_vec_kernel(const float* __restrict__ ref, const int* __restrict__ mv,
              float* __restrict__ out, int cl, int ppg, int H, int W, int m,
              int rows_cta) {
  const int row = cl * W;
  const int q0 = (blockIdx.x * blockDim.x + threadIdx.x) * MC_VEC;
  if (q0 >= row) return;
  const int plane = blockIdx.z;
  const int nby = H / m, nbx = W / m;
  // the run's first and last pixel; both lie in block bx
  const int x0 = q0 / cl, x3 = (q0 + MC_VEC - 1) / cl;
  const int* v_row = mv + 2 * ((size_t)(plane / ppg) * nby * nbx + x0 / m);
  const float* src = ref + (size_t)plane * H * row;
  float* dst = out + (size_t)plane * H * row + q0;
  const int y_end = min((blockIdx.y + 1) * rows_cta, H);
  for (int y0 = blockIdx.y * rows_cta; y0 < y_end; y0 += m) {
    const int* v = v_row + 2 * (size_t)(y0 / m) * nbx;
    const int vy = __ldg(v), vx = __ldg(v + 1);
    if (x0 + vx >= 0 && x3 + vx < W) {
      // inside the frame: the 4 sources are contiguous from q0 + vx * cl
      const int a = q0 + vx * cl;
#pragma unroll 4
      for (int y = y0; y < y0 + m; ++y) {
        const float* s = src + (size_t)min(max(y + vy, 0), H - 1) * row + a;
        *reinterpret_cast<float4*>(dst + (size_t)y * row) =
            make_float4(__ldg(s), __ldg(s + 1), __ldg(s + 2), __ldg(s + 3));
      }
    } else {
      // a frame edge: each output's clamped source column
      int off[MC_VEC];
#pragma unroll
      for (int j = 0; j < MC_VEC; ++j) {
        const int x = (q0 + j) / cl;
        off[j] = min(max(x + vx, 0), W - 1) * cl + (q0 + j - x * cl);
      }
      for (int y = y0; y < y0 + m; ++y) {
        const float* s = src + (size_t)min(max(y + vy, 0), H - 1) * row;
        *reinterpret_cast<float4*>(dst + (size_t)y * row) = make_float4(
            __ldg(s + off[0]), __ldg(s + off[1]), __ldg(s + off[2]),
            __ldg(s + off[3]));
      }
    }
  }
}

// The luma of one pixel: fma_rows' chain, rounded step by step.
template <bool ROUND>
__device__ __forceinline__ float luma_of(float x0, float x1, float x2,
                                         float w0, float w1, float w2) {
  if (ROUND) {
    x0 = rintf(x0);
    x1 = rintf(x1);
    x2 = rintf(x2);
  }
  return __fmaf_rn(x2, w2, __fmaf_rn(x1, w1, __fmul_rn(x0, w0)));
}

// A quad: 4 consecutive elements of T, one aligned load (16 bytes of
// float32, 4 of uint8); at(r, k) is element k of three quads (k a
// constant once the callers' loops unroll, so r stays in registers).
template <typename T>
struct LumaQuad;
template <>
struct LumaQuad<float> {
  using type = uint4;
  __device__ static float at(const uint4 (&r)[3], int k) {
    const uint4& v = r[k >> 2];
    return __uint_as_float((k & 3) == 0   ? v.x
                           : (k & 3) == 1 ? v.y
                           : (k & 3) == 2 ? v.z
                                          : v.w);
  }
};
template <>
struct LumaQuad<unsigned char> {
  using type = unsigned;
  __device__ static float at(const unsigned (&r)[3], int k) {
    return (float)((r[k >> 2] >> (8 * (k & 3))) & 0xffu);
  }
};

// x: G frames of H rows of W pixels, element (g, c, y, x) at
// g * sg + c * sc + y * sh + x * sw; out (G, H, W) f32, contiguous.  n:
// the groups of 4 pixels along W (vector modes: planar sw = 1, a quad a
// channel; channels-last sc = 1 and sw = 3, the group's 12 elements as
// three quads; W % 4 == 0 and quad-aligned frames, rows and channels), or
// the pixels (LUMA_SCALAR).
template <typename T, int MODE, bool ROUND>
__global__ void __launch_bounds__(LUMA_THREADS)
luma_kernel(const T* __restrict__ x, float* __restrict__ out, int H, int W,
            long long sg, long long sc, long long sh, long long sw,
            long long n, float w0, float w1, float w2) {
  if (MODE == LUMA_SCALAR) {
    for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         q < n; q += (long long)gridDim.x * blockDim.x) {
      const long long row = q / W, g = row / H;
      const T* p = x + g * sg + (row - g * H) * sh + (q - row * W) * sw;
      out[q] = luma_of<ROUND>((float)p[0], (float)p[sc], (float)p[2 * sc],
                              w0, w1, w2);
    }
    return;
  }
  using Quad = typename LumaQuad<T>::type;
  const unsigned nw = W / 4;      // n < 2^31: 32-bit index arithmetic
  for (unsigned q = blockIdx.x * blockDim.x + threadIdx.x; q < n;
       q += gridDim.x * blockDim.x) {
    const unsigned row = q / nw, g = row / H;
    const T* p = x + g * sg + (long long)(row - g * H) * sh +
                 (long long)(q - row * nw) * (MODE == LUMA_PLANAR ? 4 : 12);
    Quad r[3];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      r[j] = __ldg(MODE == LUMA_PLANAR
                       ? reinterpret_cast<const Quad*>(p + j * sc)
                       : reinterpret_cast<const Quad*>(p) + j);
    // pixel i's channel c: element 4 * c + i (planar), 3 * i + c
    constexpr int kc = MODE == LUMA_PLANAR ? 4 : 1;
    float l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = MODE == LUMA_PLANAR ? i : 3 * i;
      l[i] = luma_of<ROUND>(LumaQuad<T>::at(r, k), LumaQuad<T>::at(r, k + kc),
                            LumaQuad<T>::at(r, k + 2 * kc), w0, w1, w2);
    }
    reinterpret_cast<float4*>(out)[q] = make_float4(l[0], l[1], l[2], l[3]);
  }
}

}  // namespace vcf

namespace {

// The CTA's block count for a row of nbx blocks: the one that leaves the
// fewest lanes idle (items over launched thread slots, the row's ragged
// end included), among counts whose shared memory leaves room for two
// CTAs an SM (one block always qualifies).
int sad_plan(int m, int s, int nbx, int* threads) {
  const int n = 2 * s + 1, run = vcf::sad_run_for(n);
  const int pb = n * ((n + run - 1) / run);
  int best_bx = 1;
  double best_eff = -1.0;
  for (int bx = 1; bx <= nbx && bx <= vcf::SAD_MAX_BLOCKS; ++bx) {
    if (bx > 1 && vcf::sad_smem(m, s, bx) > vcf::SAD_SMEM_TARGET) break;
    const int items = bx * pb;
    int t = (items + 31) / 32 * 32;
    if (t > vcf::SAD_CTA_THREADS) t = vcf::SAD_CTA_THREADS;
    const int passes = (items + t - 1) / t, ctas = (nbx + bx - 1) / bx;
    const double eff = (double)nbx * pb / ((double)ctas * t * passes);
    if (eff > best_eff + 1e-9) {
      best_eff = eff;
      best_bx = bx;
      *threads = t;
    }
  }
  return best_bx;
}

template <int M, int R>
int launch_sad(const float* ref, const float* cur, int* mv, float* sad,
               unsigned long long* n_refined, int G, int H, int W, int s,
               cudaStream_t st) {
  auto kernel = vcf::sad_search_kernel<M, R>;
  int threads = 32;
  const int bx = sad_plan(M, s, W / M, &threads);
  const int smem = (int)vcf::sad_smem(M, s, bx);
  if (smem > 48 * 1024) {  // past the default: opt in (refused: an error)
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((W / M + bx - 1) / bx, H / M, G);
  kernel<<<grid, threads, smem, st>>>(ref, cur, mv, sad, n_refined, H, W, s,
                                      bx);
  return (int)cudaGetLastError();
}

template <int M>
int launch_sad(const float* ref, const float* cur, int* mv, float* sad,
               unsigned long long* n_refined, int G, int H, int W, int s,
               cudaStream_t st) {
  if (vcf::sad_run_for(2 * s + 1) == vcf::SAD_RUN_LONG)
    return launch_sad<M, vcf::SAD_RUN_LONG>(ref, cur, mv, sad, n_refined, G,
                                            H, W, s, st);
  return launch_sad<M, vcf::SAD_RUN_SHORT>(ref, cur, mv, sad, n_refined, G,
                                           H, W, s, st);
}

bool sad_instance(int m) { return m == 4 || m == 8 || m == 16 || m == 32; }

template <typename T, bool ROUND>
int launch_luma(const void* x, void* out, int mode, int H, int W,
                long long sg, long long sc, long long sh, long long sw,
                long long n, float w0, float w1, float w2, void* stream) {
  int dev = 0, sms = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (err) return err;
  const long long ctas = std::min<long long>(
      (n + vcf::LUMA_THREADS - 1) / vcf::LUMA_THREADS,
      (long long)sms * vcf::LUMA_CTAS_SM);
  auto kernel = mode == vcf::LUMA_PLANAR
                    ? &vcf::luma_kernel<T, vcf::LUMA_PLANAR, ROUND>
                : mode == vcf::LUMA_CHANNEL_LAST
                    ? &vcf::luma_kernel<T, vcf::LUMA_CHANNEL_LAST, ROUND>
                    : &vcf::luma_kernel<T, vcf::LUMA_SCALAR, ROUND>;
  kernel<<<(unsigned)ctas, vcf::LUMA_THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)x, (float*)out, H, W, sg, sc, sh, sw, n, w0, w1, w2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory a CTA of one block needs for block m and range s in the
// staged mode for m (the instance, or the generic kernel's STAGED mode),
// or -1 past that mode's limit.
int vcf_sad_smem(int m, int s) {
  if (m < 1 || s < 0 || m > 65535 || s > 65535) return -1;
  if (sad_instance(m)) {
    const long long b = vcf::sad_smem(m, s, 1);
    return b <= vcf::SAD_OPTIN_SMEM ? (int)b : -1;
  }
  const long long win = m + 2LL * s;
  const long long b = (win * win + (long long)m * m) * 8;
  return b <= vcf::SAD_MAX_SMEM ? (int)b : -1;
}

// The mode sad_search takes for block m and range s: 0 the instance, 1
// the generic kernel's staged mode, 2 its global mode (past the staged
// mode's shared memory); -1 for m < 1 or s < 0.
int vcf_sad_mode(int m, int s) {
  if (m < 1 || s < 0) return -1;
  if (vcf_sad_smem(m, s) < 0) return 2;
  return sad_instance(m) ? 0 : 1;
}

// ref, cur (G, H, W) f32 and outputs mv (G, H/m, W/m, 2) i32, sad
// (G, H/m, W/m) f32, all on the device; n_refined (nullable) two device
// u64s to which the screen adds its float64 second sums and the CTAs that
// summed them a thread an item.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// shape the kernel does not take.
int vcf_sad_search(const void* ref, const void* cur, void* mv, void* sad,
                   void* n_refined, int G, int H, int W, int m, int s,
                   void* stream) {
  const int mode = vcf_sad_mode(m, s);
  if (G < 1 || mode < 0 || H % m || W % m || H < m || W < m ||
      H / m > 65535 || G > 65535)
    return (int)cudaErrorInvalidValue;
  const float* r = (const float*)ref;
  const float* c = (const float*)cur;
  int* v = (int*)mv;
  float* d = (float*)sad;
  auto* nr = (unsigned long long*)n_refined;
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == 0) {
    switch (m) {
      case 4: return launch_sad<4>(r, c, v, d, nr, G, H, W, s, st);
      case 8: return launch_sad<8>(r, c, v, d, nr, G, H, W, s, st);
      case 16: return launch_sad<16>(r, c, v, d, nr, G, H, W, s, st);
      default: return launch_sad<32>(r, c, v, d, nr, G, H, W, s, st);
    }
  }
  const unsigned long long n_disp = (2ULL * s + 1) * (2ULL * s + 1);
  const int threads = n_disp >= (unsigned long long)vcf::SAD_MAX_THREADS
                          ? vcf::SAD_MAX_THREADS
                          : (int)((n_disp + 31) / 32 * 32);
  dim3 grid(W / m, H / m, G);
  if (mode == 1)
    vcf::sad_search_generic_kernel<true><<<grid, threads,
                                           vcf_sad_smem(m, s), st>>>(
        r, c, v, d, H, W, m, s);
  else
    vcf::sad_search_generic_kernel<false><<<grid, threads, 0, st>>>(
        r, c, v, d, H, W, m, s);
  return (int)cudaGetLastError();
}

// The mode vcf_mc_apply takes, in either layout: 0 the vector mode
// (m % 4 == 0, so that a row, W or W * C floats with W % m == 0, is a
// multiple of 4 floats; ref and out 16-byte aligned), 1 the generic mode;
// -1 for a shape it refuses.
int vcf_mc_mode(const void* ref, const void* out, int C, int W, int m) {
  if (C < 1 || m < 1 || W < m || W % m) return -1;
  return m % vcf::MC_VEC == 0 && (uintptr_t)ref % 16 == 0 &&
                 (uintptr_t)out % 16 == 0
             ? 0
             : 1;
}

// ref and out (G, C, H, W) f32 (channel_last = 0) or (G, H, W, C)
// (channel_last = 1); mv (G, H/m, W/m, 2) i32; all on the device.  The
// mode is vcf_mc_mode's.
int vcf_mc_apply(const void* ref, const void* mv, void* out, int G, int C,
                 int H, int W, int m, int channel_last, void* stream) {
  const int mode = vcf_mc_mode(ref, out, C, W, m);
  if (G < 1 || mode < 0 || H % m || H < m || H > 65535 ||
      (long long)G * C > 65535 || (long long)W * C >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int row = channel_last ? W * C : W;
  const int planes = channel_last ? G : G * C;
  cudaStream_t st = (cudaStream_t)stream;
  const float* r = (const float*)ref;
  const int* v = (const int*)mv;
  float* o = (float*)out;
  if (mode == 0) {
    // the row's warps of runs spread evenly over the fewest CTAs of at
    // most MC_VEC_WARPS warps
    const int warps = (row / vcf::MC_VEC + 31) / 32;
    const int ctas = (warps + vcf::MC_VEC_WARPS - 1) / vcf::MC_VEC_WARPS;
    const int threads = 32 * ((warps + ctas - 1) / ctas);
    const int rows_cta = m * std::max(1, vcf::MC_VEC_ROWS / m);
    dim3 grid(ctas, (H + rows_cta - 1) / rows_cta, planes);
    vcf::mc_vec_kernel<<<grid, threads, 0, st>>>(
        r, v, o, channel_last ? C : 1, channel_last ? 1 : C, H, W, m,
        rows_cta);
    return (int)cudaGetLastError();
  }
  dim3 grid((row + vcf::MC_THREADS - 1) / vcf::MC_THREADS, H, planes);
  if (channel_last)
    vcf::mc_kernel<true><<<grid, vcf::MC_THREADS, 0, st>>>(r, v, o, C, H, W,
                                                          m);
  else
    vcf::mc_kernel<false><<<grid, vcf::MC_THREADS, 0, st>>>(r, v, o, C, H,
                                                           W, m);
  return (int)cudaGetLastError();
}

// The mode vcf_luma takes: 0 planar vector, 1 channels-last vector (W %
// 4 == 0; x and its frame, row and, planar, channel offsets aligned to a
// quad, 16 bytes of float32 or 4 of uint8; fewer than 2^31 groups of 4
// pixels), 2 scalar (any other strides); -1 for a shape it refuses.
// Strides in elements, 0 for an axis of size 1.
int vcf_luma_mode(const void* x, int dtype, int G, int H, int W,
                  long long sg, long long sc, long long sh, long long sw) {
  if (G < 1 || H < 1 || W < 1 || (dtype != 0 && dtype != 1)) return -1;
  const int es = dtype ? 1 : 4, quad = 4 * es;
  const bool aligned = (uintptr_t)x % quad == 0 && (sg * es) % quad == 0 &&
                       (sh * es) % quad == 0;
  if (W % 4 || !aligned || (long long)G * H * (W / 4) >= (1LL << 31))
    return vcf::LUMA_SCALAR;
  if (sw == 1 && (sc * es) % quad == 0) return vcf::LUMA_PLANAR;
  if (sc == 1 && sw == 3) return vcf::LUMA_CHANNEL_LAST;
  return vcf::LUMA_SCALAR;
}

// x: G x H x W pixels of 3 channels on the device, float32 (dtype 0) or
// uint8 (1), element (g, c, y, x) at g * sg + c * sc + y * sh + x * sw
// (strides in elements, 0 for an axis of size 1); out (G, H, W) f32,
// contiguous, on the device; w0..w2 the float32 weights.  round != 0
// rounds each float32 channel (half to even) first.
int vcf_luma(const void* x, void* out, int dtype, int G, int H, int W,
             long long sg, long long sc, long long sh, long long sw,
             float w0, float w1, float w2, int round, void* stream) {
  const int mode = vcf_luma_mode(x, dtype, G, H, W, sg, sc, sh, sw);
  if (mode < 0 || (uintptr_t)out % 16) return (int)cudaErrorInvalidValue;
  const long long pixels = (long long)G * H * W;
  const long long n = mode == vcf::LUMA_SCALAR ? pixels : pixels / 4;
  auto launch = dtype   ? &launch_luma<unsigned char, false>
                : round ? &launch_luma<float, true>
                        : &launch_luma<float, false>;
  return launch(x, out, mode, H, W, sg, sc, sh, sw, n, w0, w1, w2, stream);
}

}  // extern "C"
