// B1-B4: the fused block DCT + deadzone quantizer, forward and inverse, as
// two kernels with two modes each.
//
// dct_forward_kernel replaces, in vcf_tpu/ops/pallas/dct_kernel.py:
//   mode PLANES (COLOR=false): fused_dct_quantize and fused_dct_quantize_any
//     (bodies _encode_kernel and, with a perceptual table, _encode_kernel_p):
//     f32 planes -> block DCT -> [* table] -> trunc(c * (1/qss)) + offset
//     -> clip -> u8;
//   mode COLOR (COLOR=true): fused_cdct_quantize (_encode_kernel_cdct):
//     u8 pixels - offset -> 3x3 color rows -> the same, u8 in and out.
// dct_inverse_kernel replaces:
//   mode PLANES: fused_dequantize_idct and fused_dequantize_idct_any
//     (_decode_kernel, _decode_kernel_p): (k - offset) * qss [/ table]
//     -> inverse DCT -> f32 planes;
//   mode COLOR: fused_dequantize_cdct (_decode_kernel_cdct): the same, then
//     the 3x3 inverse rows + offset -> round half to even -> clip -> u8.
//
// What bounds them: memory traffic.  COLOR moves 2 bytes per coefficient
// (u8 in, u8 out; ~100 MB for an 8x1088x1920 clip) against ~16 FMAs per
// coefficient for the two 1-D passes, far below the card's fp32 rate, so
// the design aims to touch device memory once each way and nothing more.
// Forward design: one CTA per strip of b rows x (1024 / b) columns of one
// frame (all three channels in COLOR mode, one plane in PLANES mode).
// Loads are coalesced (neighbouring threads, neighbouring columns) into an
// f32 tile
// in shared memory, with the color rows applied on the way in.  Then one
// vertical and one horizontal 1-D DCT pass, one thread per output
// coefficient, each an b-term dot product out of shared memory; the
// quantized byte goes straight from the second pass to a coalesced store.
// The DCT matrix sits in shared memory with a row stride of b + 1, so the
// b different rows a warp reads in the horizontal pass fall in different
// banks.  The TPU kernels wrote the DCT as kron matmuls (32x32 and
// 512x512 constants) because Mosaic rejects lane-splitting reshapes; that
// is not carried over.  Plain fp32 on the CUDA cores: the tensor cores
// would offer only TF32 here, which the port forbids.
//
// Inverse design, dct_inverse_kernel<COLOR, B, GRID>: the block size and
// the layout are template parameters (vcf_dct_inverse dispatches b in
// {1, 2, 4, 8, 16, 32} and cw != 0), so every / B, % B and tile width is
// a shift or a constant.  One CTA of 128 threads per strip of B rows x
// TW = 1024 / B columns; in the grid layout a strip lies inside one
// cw-wide lane chunk, so its row and column permutation is fixed once per
// CTA.  Three phases, two barriers (three in the grid layout):
//   1. loads: one thread per run of up to 16 index bytes, one uint4 where
//      the run is whole and 16-byte aligned, else single bytes in the same
//      thread (rows with W % 16 != 0, the ragged last strip, runs of a
//      narrow chunk).  Block layout: runs along a row.  Grid layout:
//      threads in (channel, u, v, block) order, so a run is the strip's
//      blocks of one coefficient (u, v), contiguous in the grid (16 bytes
//      at b = 8 for cw = 128 or 512).  Dequantized on the way into one f32
//      tile, each run in its own order: four float4 stores a run in both
//      layouts (stride-B scalar stores made the grid layout ~20% slower
//      than the block layout on an H100);
//   2. vertical pass: one thread per (channel, column), the column's B
//      coefficients in registers, its B outputs written in block order:
//      in place (block layout), or, in the grid layout, after a barrier,
//      from the column's load-order place to its block-order place;
//   3. horizontal pass: one thread per (row, block), all three channels in
//      COLOR mode: B values a channel from the tile, B outputs in
//      registers, then the colour rows, round and clip, and one B-byte
//      store a channel (COLOR) or float4 stores (PLANES); B bytes at a
//      multiple of B are always aligned.
// Each tile row holds a float4 of padding after every 32 columns and the
// row stride is 8 (mod 16) words, so at B = 8 the float4 stores of phase
// 1, the column reads and writes of phase 2 (the grid layout's reads at
// stride 16) and the float4 reads of phase 3 meet no bank conflict.  The DCT
// matrix is a kernel parameter, in the constant bank, since every lane
// reads the same entry; the perceptual table entry differs from lane to
// lane (v), so it comes through the read-only cache into registers.  The
// float operations and their order are those of one output computed on
// its own (an fmaf chain from 0.f over u ascending, then one over v; the
// dequantize, colour and rounding below), so the result depends neither
// on the layout nor on which thread computes it.
//
// Both kernels take a layout flag, `cw`: 0 for the block layout, else the
// lane chunk of vcf_tpu's subband-grid tile layout (grid_layout=True,
// dct_kernel.py _grid_perm / _kron_dct_grid): inside each (32, cw) tile,
// rows go in (coeff_y, block_y) and columns in (coeff_x, block_x) order.
// The TPU kernels folded that permutation into their kron matrices; here
// it is only another store index (forward) or load index (inverse), the
// arithmetic untouched, so a grid-layout output is the block-layout
// output permuted, bit for bit.  cw is vcf_tpu's `_chunk_w(W, b)` (128
// at W = 1920): it fixes the lane order and so the wire bytes.
//
// Rounding: the color rows, the perceptual multiply and divide, the
// quantizer's multiply by float32(1/qss) and the final + offset use
// __fmul_rn / __fadd_rn / __fdiv_rn, so they round as the plain torch
// version's elementwise ops do (no FMA contraction).  The DCT dot
// products use fmaf; their summation order differs from torch's matmul in
// any case, which is what the +-1 index rule allows for.  Truncation is
// __float2int_rz, rounding __float2int_rn (half to even, as torch.round).

#include <cstdint>

#include <cuda_runtime.h>

namespace vcf {

constexpr int DCT_THREADS = 256;
constexpr int DCT_STRIP = 1024;  // tile elements per channel: b x (1024 / b)
constexpr int DCT_MAXB = 32;
constexpr int DCT_DSTRIDE = DCT_MAXB + 1;
constexpr int DCT_GRID_ROWS = 32;  // tile rows of the subband-grid layout

struct Mat3 {
  float m[9];  // row-major 3x3
};

__device__ __forceinline__ float color_row(const Mat3& m, int d, float x0,
                                           float x1, float x2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(m.m[3 * d], x0),
                             __fmul_rn(m.m[3 * d + 1], x1)),
                   __fmul_rn(m.m[3 * d + 2], x2));
}

// Offset in a plane of block-layout element (y, x) in the subband-grid
// layout: tile row ty = blk * b + g moves to g * (32 / b) + blk, and the
// same with cw / b blocks along the tile's columns.
__device__ __forceinline__ size_t grid_at(int y, int x, int W, int b,
                                          int cw) {
  const int ty = y % DCT_GRID_ROWS, tx = x % cw;
  const int gy = (y - ty) + (ty % b) * (DCT_GRID_ROWS / b) + ty / b;
  const int gx = (x - tx) + (tx % b) * (cw / b) + tx / b;
  return (size_t)gy * W + gx;
}

// The b x b DCT matrix into s_d (row stride b + 1), and the b x b
// perceptual table of this CTA's channel into s_sc when there is one.
__device__ __forceinline__ void load_consts(const float* __restrict__ dmat,
                                            const float* __restrict__ table,
                                            int b, float* s_d, float* s_sc) {
  for (int i = threadIdx.x; i < b * b; i += blockDim.x) {
    s_d[(i / b) * (b + 1) + i % b] = dmat[i];
    if (table) s_sc[i] = table[i];
  }
}

// in (N, C, H, W): f32 planes (PLANES) or u8 pixels with C == 3 (COLOR);
// out (N, C, H, W) u8.  scale (2, b, b) luma and chroma tables or null
// (PLANES only).  Grid (ceil(W / tw), H / b, COLOR ? N : N * C).
template <bool COLOR>
__global__ void __launch_bounds__(DCT_THREADS)
dct_forward_kernel(const void* __restrict__ in, uint8_t* __restrict__ out,
                   const float* __restrict__ dmat,
                   const float* __restrict__ scale, Mat3 m, int C, int H,
                   int W, int b, float recip, int offset, int cw) {
  constexpr int CH = COLOR ? 3 : 1;
  __shared__ float s_x[CH][DCT_STRIP];
  __shared__ float s_y[CH][DCT_STRIP];
  __shared__ float s_d[DCT_MAXB * DCT_DSTRIDE];
  __shared__ float s_sc[DCT_MAXB * DCT_MAXB];
  const int tw = DCT_STRIP / b;
  const int x0 = blockIdx.x * tw;
  const int width = min(tw, W - x0);
  const size_t plane = (size_t)H * W;
  const size_t fbase = (size_t)blockIdx.z * CH * plane;
  const size_t base = fbase + (size_t)blockIdx.y * b * W + x0;
  const float* table =
      scale ? scale + ((blockIdx.z % C) == 0 ? 0 : b * b) : nullptr;
  load_consts(dmat, table, b, s_d, s_sc);

  for (int e = threadIdx.x; e < DCT_STRIP; e += DCT_THREADS) {
    const int r = e / tw, j = e - r * tw;
    const size_t at = base + (size_t)r * W + j;
    if constexpr (COLOR) {
      const uint8_t* px = (const uint8_t*)in;
      float v0 = 0.f, v1 = 0.f, v2 = 0.f;
      if (j < width) {
        v0 = (float)px[at] - (float)offset;
        v1 = (float)px[at + plane] - (float)offset;
        v2 = (float)px[at + 2 * plane] - (float)offset;
      }
      for (int d = 0; d < CH; ++d) s_x[d][e] = color_row(m, d, v0, v1, v2);
    } else {
      s_x[0][e] = j < width ? ((const float*)in)[at] : 0.f;
    }
  }
  __syncthreads();

  // vertical pass: y[c][u][j] = sum_r D[u][r] x[c][r][j]
  for (int e = threadIdx.x; e < CH * DCT_STRIP; e += DCT_THREADS) {
    const int c = e / DCT_STRIP, rem = e - c * DCT_STRIP;
    const int u = rem / tw, j = rem - u * tw;
    const float* du = s_d + u * (b + 1);
    const float* xc = s_x[c] + j;
    float acc = 0.f;
    for (int r = 0; r < b; ++r) acc = fmaf(du[r], xc[r * tw], acc);
    s_y[c][rem] = acc;
  }
  __syncthreads();

  // horizontal pass: coeff[c][u][j] = sum_s y[c][u][j - v + s] D[v][s],
  // v = j mod b; then quantize and store
  for (int e = threadIdx.x; e < CH * DCT_STRIP; e += DCT_THREADS) {
    const int c = e / DCT_STRIP, rem = e - c * DCT_STRIP;
    const int u = rem / tw, j = rem - u * tw;
    if (j >= width) continue;
    const int v = j & (b - 1);
    const float* yr = s_y[c] + u * tw + (j - v);
    const float* dv = s_d + v * (b + 1);
    float acc = 0.f;
    for (int s = 0; s < b; ++s) acc = fmaf(yr[s], dv[s], acc);
    if (table) acc = __fmul_rn(acc, s_sc[u * b + v]);
    int k = __float2int_rz(__fmul_rn(acc, recip)) + offset;
    k = min(max(k, 0), 255);
    const size_t at =
        cw ? fbase + grid_at(blockIdx.y * b + u, x0 + j, W, b, cw)
           : base + (size_t)u * W + j;
    out[at + c * plane] = (uint8_t)k;
  }
}

constexpr int IDCT_THREADS = 128;

// The b x b DCT matrix by value: D[u][x] at d[u * B + x].
template <int B>
struct DctMat {
  float d[B * B];
};

// The inverse kernel's strip of B rows x TW columns and its f32 tile.
template <int B>
struct InvStrip {
  static constexpr int TW = DCT_STRIP / B;  // columns
  static constexpr int NK = TW / B;         // blocks in a row
  static constexpr int ROW = TW + TW / 8;   // + a float4 after every 32
  static constexpr int S = ROW + (24 - ROW % 16) % 16;  // stride, 8 mod 16
  static constexpr int RUNS_BLOCK = TW / 16;            // runs of a row
  static constexpr int RUNS_GRID = (NK + 15) / 16;      // runs of a (u, v)
};

// Tile word of column j: a float4 of padding after every 32 columns.
__device__ __forceinline__ int tile_col(int j) { return j + ((j >> 5) << 2); }

// The B values at p (16-byte aligned for B >= 4) into v.
template <int B>
__device__ __forceinline__ void load_run(const float* p, float* v) {
  if constexpr (B >= 4) {
#pragma unroll
    for (int f = 0; f < B / 4; ++f) {
      const float4 x = ((const float4*)p)[f];
      v[4 * f] = x.x; v[4 * f + 1] = x.y; v[4 * f + 2] = x.z;
      v[4 * f + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < B; ++i) v[i] = p[i];
  }
}

// B floats to out + at (at a multiple of B, so aligned to 4B bytes).
template <int B>
__device__ __forceinline__ void store_floats(float* p, const float* v) {
  if constexpr (B >= 4) {
#pragma unroll
    for (int f = 0; f < B / 4; ++f)
      ((float4*)p)[f] = make_float4(v[4 * f], v[4 * f + 1], v[4 * f + 2],
                                    v[4 * f + 3]);
  } else if constexpr (B == 2) {
    *(float2*)p = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// B bytes, packed four a word, to p (at a multiple of B: aligned).
template <int B>
__device__ __forceinline__ void store_bytes(uint8_t* p, const uint32_t* w) {
  if constexpr (B >= 16) {
#pragma unroll
    for (int f = 0; f < B / 16; ++f)
      ((uint4*)p)[f] =
          make_uint4(w[4 * f], w[4 * f + 1], w[4 * f + 2], w[4 * f + 3]);
  } else if constexpr (B == 8) {
    *(uint2*)p = make_uint2(w[0], w[1]);
  } else if constexpr (B == 4) {
    *(uint32_t*)p = w[0];
  } else if constexpr (B == 2) {
    *(uint16_t*)p = (uint16_t)w[0];
  } else {
    *p = (uint8_t)w[0];
  }
}

// in (N, C, H, W) u8 indexes (C == 3 in COLOR mode), in the subband-grid
// layout when GRID; out (N, C, H, W) f32 planes (PLANES) or u8 pixels
// (COLOR), block layout.  scale (2, B, B) or null (PLANES only).  Grid
// (strips across a row, H / B, COLOR ? N : N * C); GRID strips are
// (W / cw) chunks x ceil(cw / TW) strips a chunk.
template <bool COLOR, int B, bool GRID>
__global__ void __launch_bounds__(IDCT_THREADS)
dct_inverse_kernel(const uint8_t* __restrict__ in, void* __restrict__ out,
                   const DctMat<B> dm, const float* __restrict__ scale,
                   Mat3 m, int C, int H, int W, float qss, int offset,
                   int cw) {
  using T = InvStrip<B>;
  constexpr int CH = COLOR ? 3 : 1;
  __shared__ __align__(16) float tile[CH * B * T::S];
  const size_t plane = (size_t)H * W;
  const size_t fbase = (size_t)blockIdx.z * CH * plane;
  const int y0 = blockIdx.y * B;
  const float* table =
      scale ? scale + ((blockIdx.z % C) == 0 ? 0 : B * B) : nullptr;

  // the strip's columns [x0, x0 + width); in the grid layout also its
  // chunk's first column, its first block in the chunk, the chunk's
  // blocks a row (cb) and the grid row of coefficient row 0
  int x0, width, chunk0 = 0, k0 = 0, cb = 0, grow0 = 0;
  if constexpr (GRID) {
    const int per = (cw + T::TW - 1) / T::TW;
    const int ch = blockIdx.x / per, t = blockIdx.x - ch * per;
    chunk0 = ch * cw;
    x0 = chunk0 + t * T::TW;
    width = min(T::TW, cw - t * T::TW);
    k0 = t * T::NK;
    cb = cw / B;
    grow0 = (y0 & ~(DCT_GRID_ROWS - 1)) + (y0 & (DCT_GRID_ROWS - 1)) / B;
  } else {
    x0 = blockIdx.x * T::TW;
    width = min(T::TW, W - x0);
  }

  // 1. index runs -> dequantized coefficients: (k - offset) * qss
  //    [/ table[u][v]]; coefficient (c, u, v) of block k goes to row
  //    c * B + u of the tile, column k * B + v (block layout) or, in the
  //    grid layout, v * NK + k: the run's own order, so each run is four
  //    float4 stores in both layouts
  constexpr int RUNS = GRID ? T::RUNS_GRID : T::RUNS_BLOCK;
  constexpr int SEGS = GRID ? CH * B * B : CH * B;
  const int len = GRID ? width / B : width;  // bytes of a segment
  for (int p = threadIdx.x; p < SEGS * RUNS; p += IDCT_THREADS) {
    const int seg = p / RUNS, q = p - seg * RUNS;
    const int n = min(16, len - 16 * q);
    if (n <= 0) continue;
    const int c = GRID ? seg / (B * B) : seg / B;
    const int u = GRID ? (seg / B) % B : seg % B;
    const int v = GRID ? seg % B : 0;
    const uint8_t* src =
        GRID ? in + fbase + c * plane +
                   (size_t)(grow0 + u * (DCT_GRID_ROWS / B)) * W + chunk0 +
                   v * cb + k0 + 16 * q
             : in + fbase + c * plane + (size_t)(y0 + u) * W + x0 + 16 * q;
    uint32_t w[4];
    if (n == 16 && ((uintptr_t)src & 15) == 0) {
      const uint4 x = *(const uint4*)src;
      w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
    } else {
#pragma unroll
      for (int f = 0; f < 4; ++f) w[f] = 0;
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (i < n) w[i >> 2] |= (uint32_t)src[i] << (8 * (i & 3));
    }
    float coeff[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int vi = GRID ? v : (16 * q + i) & (B - 1);
      const int k = (int)((w[i >> 2] >> (8 * (i & 3))) & 0xFF) - offset;
      coeff[i] = __fmul_rn((float)k, qss);
      if (table) coeff[i] = __fdiv_rn(coeff[i], __ldg(table + u * B + vi));
    }
    float* row = tile + (c * B + u) * T::S;
    const int j0 = (GRID ? v * T::NK : 0) + 16 * q;
    if (n == 16) {  // j0 is then a multiple of 16
      float4* dst = (float4*)(row + tile_col(j0));
#pragma unroll
      for (int f = 0; f < 4; ++f)
        dst[f] = make_float4(coeff[4 * f], coeff[4 * f + 1],
                             coeff[4 * f + 2], coeff[4 * f + 3]);
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (i < n) row[tile_col(j0 + i)] = coeff[i];
    }
  }
  __syncthreads();

  // 2. vertical pass: y[c][r][j] = sum_u D[u][r] coeff[c][u][j], one
  //    thread a column; every column goes back to column j (block
  //    layout), so in the grid layout, whose columns moved, each thread
  //    reads its columns before any thread writes
  constexpr int COLS = (CH * T::TW + IDCT_THREADS - 1) / IDCT_THREADS;
  float x[COLS][B];
#pragma unroll
  for (int i = 0; i < COLS; ++i) {
    const int e = threadIdx.x + i * IDCT_THREADS;
    const int c = e / T::TW, j = e % T::TW;
    if (e >= CH * T::TW || j >= width) continue;
    const float* col =
        tile + c * B * T::S + tile_col(GRID ? (j % B) * T::NK + j / B : j);
#pragma unroll
    for (int u = 0; u < B; ++u) x[i][u] = col[u * T::S];
  }
  if constexpr (GRID) __syncthreads();
#pragma unroll
  for (int i = 0; i < COLS; ++i) {
    const int e = threadIdx.x + i * IDCT_THREADS;
    const int c = e / T::TW, j = e % T::TW;
    if (e >= CH * T::TW || j >= width) continue;
    float* col = tile + c * B * T::S + tile_col(j);
#pragma unroll
    for (int r = 0; r < B; ++r) {
      float acc = 0.f;
#pragma unroll
      for (int u = 0; u < B; ++u) acc = fmaf(dm.d[u * B + r], x[i][u], acc);
      col[r * T::S] = acc;
    }
  }
  __syncthreads();

  // 3. horizontal pass: x[c][r][kB + s] = sum_v y[c][r][kB + v] D[v][s];
  //    then (COLOR) the inverse colour rows + offset, round half to even,
  //    clip, store
  for (int e = threadIdx.x; e < B * T::NK; e += IDCT_THREADS) {
    const int r = e / T::NK, k = e % T::NK;
    if (k * B >= width) continue;
    const size_t at = fbase + (size_t)(y0 + r) * W + x0 + k * B;
    float y[CH][B];
#pragma unroll
    for (int c = 0; c < CH; ++c)
      load_run<B>(tile + (c * B + r) * T::S + tile_col(k * B), y[c]);
    if constexpr (COLOR) {
      uint32_t pk[3][(B + 3) / 4];
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int f = 0; f < (B + 3) / 4; ++f) pk[c][f] = 0;
#pragma unroll
      for (int s = 0; s < B; ++s) {
        float t[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          float acc = 0.f;
#pragma unroll
          for (int v = 0; v < B; ++v)
            acc = fmaf(y[c][v], dm.d[v * B + s], acc);
          t[c] = acc;
        }
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float pix =
              __fadd_rn(color_row(m, c, t[0], t[1], t[2]), (float)offset);
          const int k8 = min(max(__float2int_rn(pix), 0), 255);
          pk[c][s >> 2] |= (uint32_t)k8 << (8 * (s & 3));
        }
      }
      uint8_t* px = (uint8_t*)out + at;
#pragma unroll
      for (int c = 0; c < 3; ++c) store_bytes<B>(px + c * plane, pk[c]);
    } else {
      float o[B];
#pragma unroll
      for (int s = 0; s < B; ++s) {
        float acc = 0.f;
#pragma unroll
        for (int v = 0; v < B; ++v)
          acc = fmaf(y[0][v], dm.d[v * B + s], acc);
        o[s] = acc;
      }
      store_floats<B>((float*)out + at, o);
    }
  }
}

// The shape checks of both directions, the forward kernel's launch
// geometry and the colour matrix; returns false for a shape the kernels
// do not take.
static bool dct_grid(const float* m, int N, int C, int H, int W, int b,
                     int cw, dim3* grid, Mat3* mat) {
  if (b < 1 || b > DCT_MAXB || (b & (b - 1)) || H % b || W % b || N < 1 ||
      C < 1 || (m && C != 3))
    return false;
  if (cw && (cw < 0 || H % DCT_GRID_ROWS || cw % b || W % cw)) return false;
  const int tw = DCT_STRIP / b;
  *grid = dim3((W + tw - 1) / tw, H / b, m ? N : N * C);
  for (int i = 0; i < 9; ++i) mat->m[i] = m ? m[i] : 0.f;
  return true;
}

// The inverse kernel's arguments but the DCT matrix.
struct InvArgs {
  const uint8_t* in;
  void* out;
  const float* scale;
  Mat3 mat;
  bool color;
  int N, C, H, W;
  float qss;
  int offset, cw;
  cudaStream_t st;
};

// Launch dct_inverse_kernel<COLOR, B, GRID> on a shape dct_grid accepted.
template <int B>
static int launch_inverse(const InvArgs& a, const float* dmat) {
  constexpr int TW = InvStrip<B>::TW;
  DctMat<B> dm;
  for (int i = 0; i < B * B; ++i) dm.d[i] = dmat[i];
  const int strips =
      a.cw ? (a.W / a.cw) * ((a.cw + TW - 1) / TW) : (a.W + TW - 1) / TW;
  const dim3 grid(strips, a.H / B, a.color ? a.N : a.N * a.C);
  if (a.color && a.cw)
    dct_inverse_kernel<true, B, true><<<grid, IDCT_THREADS, 0, a.st>>>(
        a.in, a.out, dm, nullptr, a.mat, a.C, a.H, a.W, a.qss, a.offset,
        a.cw);
  else if (a.color)
    dct_inverse_kernel<true, B, false><<<grid, IDCT_THREADS, 0, a.st>>>(
        a.in, a.out, dm, nullptr, a.mat, a.C, a.H, a.W, a.qss, a.offset, 0);
  else if (a.cw)
    dct_inverse_kernel<false, B, true><<<grid, IDCT_THREADS, 0, a.st>>>(
        a.in, a.out, dm, a.scale, a.mat, a.C, a.H, a.W, a.qss, a.offset,
        a.cw);
  else
    dct_inverse_kernel<false, B, false><<<grid, IDCT_THREADS, 0, a.st>>>(
        a.in, a.out, dm, a.scale, a.mat, a.C, a.H, a.W, a.qss, a.offset, 0);
  return (int)cudaGetLastError();
}

}  // namespace vcf

extern "C" {

// in (N, C, H, W) f32 (m null) or u8 (m = 3x3 forward matrix on the host,
// C == 3); out (N, C, H, W) u8; dmat (b, b) f32 and scale (2, b, b) f32 or
// null on the device.  Returns cudaGetLastError() after the launch.
int vcf_dct_forward(const void* in, void* out, const void* dmat,
                    const void* scale, const float* m, int N, int C, int H,
                    int W, int b, float recip, int offset, int cw,
                    void* stream) {
  dim3 grid;
  vcf::Mat3 mat;
  if (!vcf::dct_grid(m, N, C, H, W, b, cw, &grid, &mat))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (m)
    vcf::dct_forward_kernel<true><<<grid, vcf::DCT_THREADS, 0, st>>>(
        in, (uint8_t*)out, (const float*)dmat, nullptr, mat, C, H, W, b,
        recip, offset, cw);
  else
    vcf::dct_forward_kernel<false><<<grid, vcf::DCT_THREADS, 0, st>>>(
        in, (uint8_t*)out, (const float*)dmat, (const float*)scale, mat, C,
        H, W, b, recip, offset, cw);
  return (int)cudaGetLastError();
}

// in (N, C, H, W) u8 indexes; out (N, C, H, W) f32 (m null) or u8 pixels
// (m = 3x3 inverse matrix on the host, C == 3); dmat (b, b) f32 on the
// HOST (passed by value to the kernel); scale (2, b, b) f32 or null on the
// device.
int vcf_dct_inverse(const void* in, void* out, const float* dmat,
                    const void* scale, const float* m, int N, int C, int H,
                    int W, int b, float qss, int offset, int cw,
                    void* stream) {
  dim3 grid;
  vcf::Mat3 mat;
  if (!vcf::dct_grid(m, N, C, H, W, b, cw, &grid, &mat))
    return (int)cudaErrorInvalidValue;
  const vcf::InvArgs a{(const uint8_t*)in, out, (const float*)scale, mat,
                       m != nullptr, N, C, H, W, qss, offset, cw,
                       (cudaStream_t)stream};
  switch (b) {
    case 1: return vcf::launch_inverse<1>(a, dmat);
    case 2: return vcf::launch_inverse<2>(a, dmat);
    case 4: return vcf::launch_inverse<4>(a, dmat);
    case 8: return vcf::launch_inverse<8>(a, dmat);
    case 16: return vcf::launch_inverse<16>(a, dmat);
    default: return vcf::launch_inverse<32>(a, dmat);
  }
}

}  // extern "C"
