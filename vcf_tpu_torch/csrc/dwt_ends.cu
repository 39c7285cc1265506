// The two ends of the DWT clip path (ops/dwt.py DWT.clip_to_lanes /
// lanes_to_clip) around the bank's level kernels (dwt.cu): four pointwise
// kernels, one for each end in each direction.
//
//   dwt_color_in_kernel   u8 frames (N, H, W, C) at any element strides ->
//                         the bank's float32 (N, Hp, Wp, C) input:
//                         the float32 cast, pad_centered's zeros, minus the
//                         spatial offset, then the forward colour matrix as
//                         fma(x2, m2, fma(x1, m1, x0 * m0)) (__fmul_rn,
//                         __fmaf_rn), or the cast alone (color "none");
//   dwt_quantize_grid_kernel  the bank's bands -> the (G * sg * N, L) u8
//                         lane grid of entropy/dwt_device.py bands_to_grid:
//                         k = trunc(IEEE x / qss) (__fdiv_rn, ROADMAP C9),
//                         LL's (k + 128) & 0xFFFF as a high and a low byte
//                         plane, each detail band's (k + 128) & 0xFF, 128
//                         in every slot past a band's symbols;
//   dwt_dequantize_grid_kernel  the lane grid where K3 leaves it (the
//                         transposed (S, L) view of its (L, S) buffer) or
//                         any other strides -> the bands synthesis takes:
//                         LL's (hi << 8 | lo) unwrapped from 16 bits,
//                         details' byte, both - 128, times qss;
//   dwt_color_out_kernel  the bank's float32 (N, Hp, Wp, C) output -> u8
//                         frames (N, H, W, C): the inverse colour matrix in
//                         ops/color.py fma_rows' float64 steps (__dmul_rn,
//                         __dadd_rn, __double2float_rn: these inputs are
//                         not integers, and one float32 FMA could round
//                         otherwise), plus the offset in float32,
//                         unpad_centered's crop, rintf (torch.round, half
//                         to even), the clamp to [0, 255] and the u8 cast.
//
// They replace no TPU kernel: vcf_tpu's colour, quantizer and byte planes
// are XLA ops, and the port's plain versions (the torch chains of
// ops/dwt.py _bands, _byte_planes, _grid_flat and _pixels, with
// bands_to_grid's and grid_to_bands' copies) launch ~100 torch kernels a
// call, the colour alone ~12 float64 kernels a plane.  Each step here is
// the plain version's own rounding, so kernels and plain versions agree
// bit for bit (on pixel-sized integers the float64 steps of fma_rows
// round as the float32 FMA chain does).
//
// What bounds them: bytes.  Each reads its input once and writes its
// output once: at 8 x 1088 x 1920 x 3, 50 MB of u8 and 200 MB of float32
// at the colour ends, 200 MB of bands and the 213 MB grid at the
// quantizer, and on decode only the grid's real symbols (23.6% of its
// slots at the cell's shape).  Design, to read and write each byte once:
//   colour in / out: a thread takes 4 pixels of one row, loads their
//   channels, computes every output channel of each and stores the
//   float32 row segment as 16-byte stores (the u8 one as 4-byte stores)
//   where the row allows, a warp's stores one contiguous run; a CTA takes
//   a run of one row, so the frame, row and column come from one division
//   a block;
//   quantizer: a CTA takes a run of one (group, frame) block of the grid,
//   a thread 4 consecutive slots: a 16-byte load of the band where it is
//   aligned, one 4-byte store;
//   dequantizer: K3 leaves the grid transposed, so a band's symbols run
//   along the lanes while the buffer runs along the steps.  A CTA stages a
//   tile of 32 lane rows x 128 lanes of a band's one or two byte planes in
//   shared memory, read along whichever axis is contiguous in the buffer
//   (vcf_dwt_dequantize_mode), and writes the tile's float32 values along
//   the lanes, so both the reads and the writes are contiguous runs.
//   Only the tiles that hold a band's symbols are launched.

#include <cstdint>

#include <cuda_runtime.h>

namespace vcf {

constexpr int ENDS_THREADS = 256;
constexpr int ENDS_MAX_BANDS = 63;      // G = bands + 1 groups, LL twice
constexpr int DQ_ROWS = 32, DQ_LANES = 128;   // the dequantizer's tile

// A colour transform as the ends take it: `linear` with a row-major 3 x 3
// matrix (three channels), else the cast alone.
struct Colour {
  int linear;
  float m[9];
};

// The bands a grid is made of or read into: band b's symbols a frame and
// where its values lie (quantizer: a pointer each; dequantizer: an offset
// into one buffer, and the first tile of the band).
struct GridBands {
  int n[ENDS_MAX_BANDS];
  const float* src[ENDS_MAX_BANDS];
  long long off[ENDS_MAX_BANDS];
  int row_tiles[ENDS_MAX_BANDS];
  long long first[ENDS_MAX_BANDS + 1];
};

// u8 frames -> float32 (N, Hp, Wp, C), frames centred at (top, left); a
// CTA takes `chunks` runs of one output row, a thread 4 pixels.  CC: the
// channels when 3 (vector stores where vec), else 0 (C at run time).
template <int CC>
__global__ void __launch_bounds__(ENDS_THREADS)
dwt_color_in_kernel(const uint8_t* __restrict__ x, float* __restrict__ out,
                    int H, int W, int C_, long long sn, long long sh,
                    long long sw, long long sc, int Hp, int Wp, int top,
                    int left, int chunks, float offset,
                    const __grid_constant__ Colour col, int vec) {
  const int C = CC ? CC : C_;
  const int row = blockIdx.x / chunks;
  const int x0 = ((blockIdx.x - row * chunks) * ENDS_THREADS + threadIdx.x)
                 * 4;
  if (x0 >= Wp) return;
  const int n = row / Hp, ys = row - n * Hp - top;
  float* o = out + (long long)row * Wp * C + (long long)x0 * C;
  const bool row_in = ys >= 0 && ys < H;
  const uint8_t* xr = x + n * sn + (long long)ys * sh;
  float v[4 * 3];
  const int px = min(4, Wp - x0);
  for (int i = 0; i < px; ++i) {
    const int xs = x0 + i - left;
    const bool in = row_in && xs >= 0 && xs < W;
    const uint8_t* p = xr + (long long)xs * sw;
    auto chan = [&](int k) {
      return __fsub_rn(in ? (float)p[k * sc] : 0.0f, offset);
    };
    if (CC == 3 && col.linear) {
      const float a = chan(0), b = chan(1), c = chan(2);
#pragma unroll
      for (int r = 0; r < 3; ++r)
        v[3 * i + r] = __fmaf_rn(c, col.m[3 * r + 2],
                                 __fmaf_rn(b, col.m[3 * r + 1],
                                           __fmul_rn(a, col.m[3 * r])));
    } else if (CC == 3) {
#pragma unroll
      for (int r = 0; r < 3; ++r) v[3 * i + r] = chan(r);
    } else {
      for (int r = 0; r < C; ++r) o[i * C + r] = chan(r);
    }
  }
  if (CC != 3) return;
  if (vec && px == 4) {
    float4* o4 = reinterpret_cast<float4*>(o);
    o4[0] = make_float4(v[0], v[1], v[2], v[3]);
    o4[1] = make_float4(v[4], v[5], v[6], v[7]);
    o4[2] = make_float4(v[8], v[9], v[10], v[11]);
  } else {
    for (int i = 0; i < 3 * px; ++i) o[i] = v[i];
  }
}

// float32 (N, Hp, Wp, C) -> u8 (N, H, W, C), the crop at (top, left); a
// CTA takes `chunks` runs of one output row, a thread 4 pixels.
template <int CC>
__global__ void __launch_bounds__(ENDS_THREADS)
dwt_color_out_kernel(const float* __restrict__ x, uint8_t* __restrict__ out,
                     int H, int W, int C_, int Hp, int Wp, int top, int left,
                     int chunks, float offset,
                     const __grid_constant__ Colour col, int vec) {
  const int C = CC ? CC : C_;
  const int row = blockIdx.x / chunks;
  const int x0 = ((blockIdx.x - row * chunks) * ENDS_THREADS + threadIdx.x)
                 * 4;
  if (x0 >= W) return;
  const int n = row / H, y = row - n * H;
  const float* xr = x + ((long long)n * Hp + y + top) * Wp * C +
                    (long long)(x0 + left) * C;
  uint8_t* o = out + (long long)row * W * C + (long long)x0 * C;
  auto pixel = [&](float f) {
    const float r = rintf(__fadd_rn(f, offset));
    return (uint8_t)fminf(fmaxf(r, 0.0f), 255.0f);
  };
  uint8_t v[4 * 3];
  const int px = min(4, W - x0);
  for (int i = 0; i < px; ++i) {
    const float* p = xr + i * C;
    if (CC == 3 && col.linear) {
      const double a = p[0], b = p[1], c = p[2];
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        float z = __double2float_rn(__dmul_rn(a, (double)col.m[3 * r]));
        z = __double2float_rn(
            __dadd_rn(__dmul_rn(b, (double)col.m[3 * r + 1]), (double)z));
        z = __double2float_rn(
            __dadd_rn(__dmul_rn(c, (double)col.m[3 * r + 2]), (double)z));
        v[3 * i + r] = pixel(z);
      }
    } else if (CC == 3) {
#pragma unroll
      for (int r = 0; r < 3; ++r) v[3 * i + r] = pixel(p[r]);
    } else {
      for (int r = 0; r < C; ++r) o[i * C + r] = pixel(p[r]);
    }
  }
  if (CC != 3) return;
  if (vec && px == 4) {
    uint32_t w[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      w[k] = (uint32_t)v[4 * k] | (uint32_t)v[4 * k + 1] << 8 |
             (uint32_t)v[4 * k + 2] << 16 | (uint32_t)v[4 * k + 3] << 24;
    uint32_t* o4 = reinterpret_cast<uint32_t*>(o);
    o4[0] = w[0];
    o4[1] = w[1];
    o4[2] = w[2];
  } else {
    for (int i = 0; i < 3 * px; ++i) o[i] = v[i];
  }
}

// The symbol of grid group g (0: LL's high byte, 1: its low byte, g > 1:
// detail band g - 1) for the band value x.
__device__ __forceinline__ uint32_t symbol(float x, float qss, int g) {
  const int k = (int)truncf(__fdiv_rn(x, qss)) + 128;
  if (g == 0) return ((uint32_t)k & 0xFFFF) >> 8;
  return (uint32_t)k & 0xFF;
}

// bands -> grid (G, N, blk) u8, blk = sg * L (a multiple of 4); a CTA a
// run of ENDS_THREADS * 4 slots of one (group, frame) block.
__global__ void __launch_bounds__(ENDS_THREADS)
dwt_quantize_grid_kernel(uint8_t* __restrict__ grid,
                         const __grid_constant__ GridBands gb, int N,
                         int blk, int chunks, float qss) {
  const int t = blockIdx.x / chunks;           // g * N + f
  const int j0 = ((blockIdx.x - t * chunks) * ENDS_THREADS + threadIdx.x)
                 * 4;
  if (j0 >= blk) return;
  const int g = t / N, f = t - g * N;
  const int b = g ? g - 1 : 0;
  const int n = gb.n[b];
  uint32_t word = 0x80808080u;                 // 128 in each slot
  if (j0 < n) {
    const float* src = gb.src[b] + (long long)f * n + j0;
    float v[4];
    if (j0 + 4 <= n && ((uintptr_t)src & 15) == 0) {
      const float4 q = *reinterpret_cast<const float4*>(src);
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[3] = q.w;
    } else {
      for (int i = 0; i < 4; ++i) v[i] = j0 + i < n ? src[i] : 0.0f;
    }
    word = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      word |= (j0 + i < n ? symbol(v[i], qss, g) : 128u) << (8 * i);
  }
  *reinterpret_cast<uint32_t*>(grid + (long long)t * blk + j0) = word;
}

// grid (S, L) u8 at element strides (ss, sl) -> the bands' float32 values
// in one buffer; a CTA a tile of DQ_ROWS lane rows x DQ_LANES lanes of one
// band and frame, staged along the steps (ALONG_S: ss == 1, K3's
// transposed view) or along the lanes.
template <bool ALONG_S>
__global__ void __launch_bounds__(ENDS_THREADS)
dwt_dequantize_grid_kernel(const uint8_t* __restrict__ lanes, long long ss,
                           long long sl, float* __restrict__ out,
                           const __grid_constant__ GridBands gb, int N,
                           int sg, int L, int lane_tiles, float qss) {
  __shared__ uint8_t tile[2][DQ_ROWS][DQ_LANES + 4];
  const long long bid = blockIdx.x;
  int b = 0;
  while (bid >= gb.first[b + 1]) ++b;
  int local = (int)(bid - gb.first[b]);
  const int lt = local % lane_tiles;
  local /= lane_tiles;
  const int rt = local % gb.row_tiles[b];
  const int f = local / gb.row_tiles[b];
  const int n = gb.n[b];
  const int r0 = rt * DQ_ROWS, l0 = lt * DQ_LANES;
  const int planes = b ? 1 : 2;
  const int g0 = b ? b + 1 : 0;
  for (int p = 0; p < planes; ++p) {
    const long long s0 = ((long long)(g0 + p) * N + f) * sg + r0;
    for (int i = threadIdx.x; i < DQ_ROWS * DQ_LANES; i += ENDS_THREADS) {
      const int r = ALONG_S ? i % DQ_ROWS : i / DQ_LANES;
      const int l = ALONG_S ? i / DQ_ROWS : i % DQ_LANES;
      if (l0 + l < L && (long long)(r0 + r) * L + l0 + l < n)
        tile[p][r][l] = lanes[(s0 + r) * ss + (long long)(l0 + l) * sl];
    }
  }
  __syncthreads();
  float* o = out + gb.off[b] + (long long)f * n;
  for (int i = threadIdx.x; i < DQ_ROWS * DQ_LANES; i += ENDS_THREADS) {
    const int r = i / DQ_LANES, l = i % DQ_LANES;
    const long long j = (long long)(r0 + r) * L + l0 + l;
    if (l0 + l >= L || j >= n) continue;
    int k;
    if (b == 0) {
      const int v = (int)tile[0][r][l] << 8 | (int)tile[1][r][l];
      k = (v >= 32768 ? v - 65536 : v) - 128;
    } else {
      k = (int)tile[0][r][l] - 128;
    }
    o[j] = __fmul_rn((float)k, qss);
  }
}

}  // namespace vcf

namespace {

void read_colour(const float* mat, vcf::Colour* col) {
  col->linear = mat != nullptr;
  for (int i = 0; i < 9; ++i) col->m[i] = mat ? mat[i] : 0.0f;
}

// The lengths of a grid's bands, checked, into gb; false for a bad grid.
bool read_bands(int bands, const int* n, int sg, int L, vcf::GridBands* gb) {
  if (bands < 1 || bands > vcf::ENDS_MAX_BANDS || sg < 1 || L < 1)
    return false;
  for (int b = 0; b < bands; ++b) {
    if (n[b] < 0 || (long long)n[b] > (long long)sg * L) return false;
    gb->n[b] = n[b];
    gb->src[b] = nullptr;
    gb->off[b] = 0;
    gb->row_tiles[b] = 0;
  }
  return true;
}

}  // namespace

extern "C" {

// frames u8 (N, H, W, C) at element strides (sn, sh, sw, sc) -> out f32
// (N, Hp, Wp, C) contiguous, on the device; mat (host) the row-major 3 x 3
// forward matrix (C == 3) or null for the cast alone.  Hp >= H, Wp >= W.
int vcf_dwt_color_in(const void* x, void* out, int N, int H, int W, int C,
                     long long sn, long long sh, long long sw, long long sc,
                     int Hp, int Wp, const float* mat, float offset,
                     void* stream) {
  vcf::Colour col;
  read_colour(mat, &col);
  if (N < 1 || H < 1 || W < 1 || C < 1 || Hp < H || Wp < W ||
      (col.linear && C != 3))
    return (int)cudaErrorInvalidValue;
  const int chunks = (Wp + 4 * vcf::ENDS_THREADS - 1) / (4 * vcf::ENDS_THREADS);
  const long long blocks = (long long)N * Hp * chunks;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int top = (Hp - H) / 2, left = (Wp - W) / 2;
  const int vec = (Wp % 4 == 0) && ((uintptr_t)out % 16 == 0);
  cudaStream_t st = (cudaStream_t)stream;
  if (C == 3)
    vcf::dwt_color_in_kernel<3><<<(unsigned)blocks, vcf::ENDS_THREADS, 0,
                                  st>>>(
        (const uint8_t*)x, (float*)out, H, W, C, sn, sh, sw, sc, Hp, Wp, top,
        left, chunks, offset, col, vec);
  else
    vcf::dwt_color_in_kernel<0><<<(unsigned)blocks, vcf::ENDS_THREADS, 0,
                                  st>>>(
        (const uint8_t*)x, (float*)out, H, W, C, sn, sh, sw, sc, Hp, Wp, top,
        left, chunks, offset, col, vec);
  return (int)cudaGetLastError();
}

// x f32 (N, Hp, Wp, C) contiguous -> out u8 (N, H, W, C) contiguous, on the
// device; mat (host) the row-major 3 x 3 inverse matrix (C == 3) or null.
int vcf_dwt_color_out(const void* x, void* out, int N, int Hp, int Wp, int C,
                      int H, int W, const float* mat, float offset,
                      void* stream) {
  vcf::Colour col;
  read_colour(mat, &col);
  if (N < 1 || H < 1 || W < 1 || C < 1 || Hp < H || Wp < W ||
      (col.linear && C != 3))
    return (int)cudaErrorInvalidValue;
  const int chunks = (W + 4 * vcf::ENDS_THREADS - 1) / (4 * vcf::ENDS_THREADS);
  const long long blocks = (long long)N * H * chunks;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int top = (Hp - H) / 2, left = (Wp - W) / 2;
  const int vec = (W % 4 == 0) && ((uintptr_t)out % 4 == 0);
  cudaStream_t st = (cudaStream_t)stream;
  if (C == 3)
    vcf::dwt_color_out_kernel<3><<<(unsigned)blocks, vcf::ENDS_THREADS, 0,
                                   st>>>(
        (const float*)x, (uint8_t*)out, H, W, C, Hp, Wp, top, left, chunks,
        offset, col, vec);
  else
    vcf::dwt_color_out_kernel<0><<<(unsigned)blocks, vcf::ENDS_THREADS, 0,
                                   st>>>(
        (const float*)x, (uint8_t*)out, H, W, C, Hp, Wp, top, left, chunks,
        offset, col, vec);
  return (int)cudaGetLastError();
}

// bands[b] (host array of device pointers): band b's N frames of n[b]
// float32 values each, contiguous -> grid u8 (bands + 1, N, sg * L) on the
// device (L a multiple of 4): group 0 / 1 LL's high / low byte plane,
// group b + 1 detail band b.
int vcf_dwt_quantize_grid(const void* const* bands, const int* n, int nb,
                          int N, int sg, int L, float qss, void* grid,
                          void* stream) {
  vcf::GridBands gb;
  if (!read_bands(nb, n, sg, L, &gb) || N < 1 || L % 4 || qss == 0.0f)
    return (int)cudaErrorInvalidValue;
  for (int b = 0; b < nb; ++b) gb.src[b] = (const float*)bands[b];
  const long long blk = (long long)sg * L;
  const long long chunks = (blk + 4 * vcf::ENDS_THREADS - 1) /
                           (4 * vcf::ENDS_THREADS);
  const long long blocks = (long long)(nb + 1) * N * chunks;
  if (blk >= (1LL << 31) || blocks >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  vcf::dwt_quantize_grid_kernel<<<(unsigned)blocks, vcf::ENDS_THREADS, 0,
                                  (cudaStream_t)stream>>>(
      (uint8_t*)grid, gb, N, (int)blk, (int)chunks, qss);
  return (int)cudaGetLastError();
}

// The axis the dequantizer stages a tile along for a grid at element
// strides (ss, sl): 1 along the steps (ss == 1 and sl != 1: K3's
// transposed view), else 0 along the lanes.
int vcf_dwt_dequantize_mode(long long ss, long long sl) {
  return ss == 1 && sl != 1 ? 1 : 0;
}

// grid u8 (S, L) = ((bands + 1) * N * sg, L) at element strides (ss, sl)
// -> out f32: band b's N frames of n[b] values from N * (n[0] + ... +
// n[b - 1]) on, on the device.
int vcf_dwt_dequantize_grid(const void* lanes, long long ss, long long sl,
                            const int* n, int nb, int N, int sg, int L,
                            float qss, void* out, void* stream) {
  vcf::GridBands gb;
  if (!read_bands(nb, n, sg, L, &gb) || N < 1)
    return (int)cudaErrorInvalidValue;
  const int lane_tiles = (L + vcf::DQ_LANES - 1) / vcf::DQ_LANES;
  long long off = 0;
  gb.first[0] = 0;
  for (int b = 0; b < nb; ++b) {
    const long long rows = ((long long)n[b] + L - 1) / L;
    gb.row_tiles[b] = (int)((rows + vcf::DQ_ROWS - 1) / vcf::DQ_ROWS);
    gb.off[b] = off;
    off += (long long)N * n[b];
    gb.first[b + 1] =
        gb.first[b] + (long long)N * gb.row_tiles[b] * lane_tiles;
  }
  const long long blocks = gb.first[nb];
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (vcf_dwt_dequantize_mode(ss, sl))
    vcf::dwt_dequantize_grid_kernel<true><<<(unsigned)blocks,
                                            vcf::ENDS_THREADS, 0, st>>>(
        (const uint8_t*)lanes, ss, sl, (float*)out, gb, N, sg, L, lane_tiles,
        qss);
  else
    vcf::dwt_dequantize_grid_kernel<false><<<(unsigned)blocks,
                                             vcf::ENDS_THREADS, 0, st>>>(
        (const uint8_t*)lanes, ss, sl, (float*)out, gb, N, sg, L, lane_tiles,
        qss);
  return (int)cudaGetLastError();
}

}  // extern "C"
