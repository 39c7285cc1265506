// The IPP motion kernels: full-search block SAD with the argmin fused in,
// and block motion compensation.
//
// sad_search_kernel replaces, in vcf_tpu/ops/pallas/sad_kernel.py,
// sad_search (:58) and its row-tiled variant sad_search_tiled (:141).  For
// frame g and the m x m block (by, bx) it computes, for every displacement
// d = (dy, dx) in [-s, s]^2 in row-major order,
//   SAD(d) = sum |cur[y][x] - ref[clampH(y + dy)][clampW(x + dx)]|
// (the coordinate clamp is the edge pad of ops/motion.py) and writes the
// (dy, dx) of the FIRST minimum and its SAD.  The TPU kernel wrote a
// (D, nby, nbx) SAD volume to HBM and reduced it in XLA; here the argmin
// stays in the CTA and nothing but the winner leaves it.  The tiling and
// VMEM gates of the TPU variants have no counterpart.
//
// What bounds it: arithmetic, not memory.  At 1088x1920, m=16, s=8 a
// frame is 8160 blocks x 289 displacements x 256 terms (~0.6 G terms),
// against 8 MB of luma read.  Design: one CTA per block; the current block
// and the clamped (m + 2s)^2 reference window (32 x 32 at m=16, s=8) are
// staged once in shared memory; one thread per displacement (looping when
// there are more displacements than threads) sums its m x m terms out of
// shared memory, the current block's value a broadcast.  The CTA argmin
// compares (sad, d) pairs lexicographically, so the first minimum wins
// whatever the order of the reduction.
//
// Precision: the terms are summed in float64, where a block's sum of
// |a - b| over float32 lumas in [0, 255] is exact in any order (every
// nonzero luma is a multiple of 2^-27, a block's SAD < 2^18), so kernel and
// plain version agree bit for bit.  The SAD is cast to float32 on output.
//
// mc_kernel replaces mc_apply_planar (vcf_tpu/ops/pallas/mc_kernel.py:115)
// and, as its CHANNEL_LAST mode, mc_apply (:103):
//   out[g][c][y][x] = ref[g][c][clampH(y + mv_y)][clampW(x + mv_x)]
// with (mv_y, mv_x) the vector of the block holding (y, x).  The TPU swept
// all (2s + 1)^2 displacements with a mask-accumulate because XLA gathers
// were slow there; on the card it is a gather: one thread per output
// element, loads and stores coalesced along the row (x, or x * C + c in the
// channel-last mode).  A copy, so it is bit-exact; memory-bound.

#include <cstdint>

#include <cuda_runtime.h>

namespace vcf {

constexpr int SAD_MAX_SMEM = 48 * 1024;
constexpr int SAD_MAX_THREADS = 1024;
constexpr int MC_THREADS = 256;

__device__ __forceinline__ bool sad_better(double a, int da, double b,
                                           int db) {
  return a < b || (a == b && da < db);
}

// ref, cur (G, H, W) f32; mv (G, nby, nbx, 2) i32; sad (G, nby, nbx) f32.
// Grid (nbx, nby, G); blockDim a multiple of 32; dynamic shared memory
// ((m + 2s)^2 + m^2) doubles.
__global__ void sad_search_kernel(const float* __restrict__ ref,
                                  const float* __restrict__ cur,
                                  int* __restrict__ mv,
                                  float* __restrict__ sad, int H, int W,
                                  int m, int s) {
  extern __shared__ double s_mem[];
  __shared__ double w_sad[SAD_MAX_THREADS / 32];
  __shared__ int w_d[SAD_MAX_THREADS / 32];
  const int win = m + 2 * s;
  double* s_ref = s_mem;
  double* s_cur = s_mem + win * win;
  const int bx = blockIdx.x, by = blockIdx.y, g = blockIdx.z;
  const size_t plane = (size_t)H * W;
  const float* r = ref + g * plane;
  const float* c = cur + g * plane;
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

  const int n = 2 * s + 1, n_disp = n * n;
  double best = __longlong_as_double(0x7ff0000000000000LL);  // +inf
  int best_d = n_disp;                                         // no candidate
  // each thread visits its displacements in increasing order, so a strict
  // < keeps its first minimum
  for (int d = threadIdx.x; d < n_disp; d += blockDim.x) {
    const int dy = d / n, dx = d - dy * n;
    double acc = 0.0;
    for (int yy = 0; yy < m; ++yy) {
      const double* rr = s_ref + (yy + dy) * win + dx;
      const double* cc = s_cur + yy * m;
      for (int xx = 0; xx < m; ++xx) acc += fabs(cc[xx] - rr[xx]);
    }
    if (acc < best) {
      best = acc;
      best_d = d;
    }
  }
  // CTA argmin over (sad, d) pairs: warp shuffles, then the first warp
  for (int off = 16; off > 0; off >>= 1) {
    const double o = __shfl_down_sync(0xffffffffu, best, off);
    const int od = __shfl_down_sync(0xffffffffu, best_d, off);
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
      const int od = __shfl_down_sync(0xffffffffu, best_d, off);
      if (sad_better(o, od, best, best_d)) {
        best = o;
        best_d = od;
      }
    }
    if (lane == 0) {
      const size_t blk = ((size_t)g * gridDim.y + by) * gridDim.x + bx;
      mv[2 * blk] = best_d / n - s;
      mv[2 * blk + 1] = best_d % n - s;
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

}  // namespace vcf

extern "C" {

// ref, cur (G, H, W) f32 and outputs mv (G, H/m, W/m, 2) i32, sad
// (G, H/m, W/m) f32, all on the device.  Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for a shape the kernel does not take.
int vcf_sad_search(const void* ref, const void* cur, void* mv, void* sad,
                   int G, int H, int W, int m, int s, void* stream) {
  const int win = m + 2 * s;
  const int smem = (win * win + m * m) * (int)sizeof(double);
  const int n_disp = (2 * s + 1) * (2 * s + 1);
  if (G < 1 || m < 1 || s < 0 || H % m || W % m || H < m || W < m ||
      smem > vcf::SAD_MAX_SMEM || H / m > 65535 || G > 65535)
    return (int)cudaErrorInvalidValue;
  int threads = (n_disp + 31) / 32 * 32;
  if (threads > vcf::SAD_MAX_THREADS) threads = vcf::SAD_MAX_THREADS;
  dim3 grid(W / m, H / m, G);
  vcf::sad_search_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const float*)ref, (const float*)cur, (int*)mv, (float*)sad, H, W, m,
      s);
  return (int)cudaGetLastError();
}

// ref and out (G, C, H, W) f32 (channel_last = 0) or (G, H, W, C)
// (channel_last = 1); mv (G, H/m, W/m, 2) i32; all on the device.
int vcf_mc_apply(const void* ref, const void* mv, void* out, int G, int C,
                 int H, int W, int m, int channel_last, void* stream) {
  if (G < 1 || C < 1 || m < 1 || H % m || W % m || H < m || W < m ||
      H > 65535 || (long long)G * C > 65535)
    return (int)cudaErrorInvalidValue;
  const int row = channel_last ? W * C : W;
  dim3 grid((row + vcf::MC_THREADS - 1) / vcf::MC_THREADS, H,
            channel_last ? G : G * C);
  cudaStream_t st = (cudaStream_t)stream;
  if (channel_last)
    vcf::mc_kernel<true><<<grid, vcf::MC_THREADS, 0, st>>>(
        (const float*)ref, (const int*)mv, (float*)out, C, H, W, m);
  else
    vcf::mc_kernel<false><<<grid, vcf::MC_THREADS, 0, st>>>(
        (const float*)ref, (const int*)mv, (float*)out, C, H, W, m);
  return (int)cudaGetLastError();
}

}  // extern "C"
