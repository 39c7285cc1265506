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
// the design aims to touch device memory once each way, in 16-byte
// vectors, and to keep the passes' operands in registers.  The TPU
// kernels wrote the DCT as kron matmuls (32x32 and 512x512 constants)
// because Mosaic rejects lane-splitting reshapes; that is not carried
// over.  Plain fp32 on the CUDA cores: the tensor cores would offer only
// TF32 here, which the port forbids.
//
// Both kernels, dct_forward_kernel<COLOR, B, GRID> and
// dct_inverse_kernel<COLOR, B, GRID>, take the block size and the layout
// as template parameters (vcf_dct_forward / vcf_dct_inverse dispatch b in
// {1, 2, 4, 8, 16, 32} and cw != 0 through launch_dct<FWD, B>), so every
// / B, % B and tile width is a shift or a constant.  One CTA per strip of
// B rows x TW = 1024 / B columns (Strip<B>), of 64 threads (forward: 128
// made B1 1.19x and B3 1.07x slower on an H100 at 8 x 1088 x 1920, 256
// slower still) or 128 (inverse).  In the grid layout a strip lies inside
// one cw-wide lane chunk, so its row and column permutation is fixed once
// per CTA (StripAt).  The DCT matrix is a kernel parameter, in the
// constant bank, since every lane reads the same entry; the perceptual
// table entry differs from lane to lane, so it comes through the
// read-only cache.
//
// Forward, three phases and two barriers (three in the grid layout):
//   1. loads: one thread per run of up to 16 pixels of one row, one uint4
//      a channel (COLOR) or four float4 (PLANES) where the run is whole
//      and 16-byte aligned, else single elements in the same thread (rows
//      with W % 16 != 0, the ragged last strip, a narrow chunk, a
//      misaligned storage offset).  COLOR applies the colour rows in
//      registers, all three channels a thread; each run goes into the f32
//      tile as four float4 stores a channel;
//   2. vertical pass: one thread per (channel, column), the column's B
//      values in registers, its B outputs written back in place;
//   3. horizontal pass: one thread per (channel, row u, block k): B values
//      from the tile, B coefficients, the table, the quantizer, the clamp,
//      all in registers.  Block layout: one B-byte store (a uint2 at
//      B = 8).  Grid layout: the bytes go into a u8 staging tile in grid
//      order; after a barrier one thread per (channel, u, v) run stores
//      the strip's blocks of that coefficient, contiguous in the grid (16
//      bytes at B = 8 for cw = 128 or 512: one uint4 where aligned).
//
// Inverse, three phases and two barriers (three in the grid layout):
//   1. loads: one thread per run of up to 16 index bytes, one uint4 where
//      the run is whole and 16-byte aligned, else single bytes in the same
//      thread.  Block layout: runs along a row.  Grid layout: threads in
//      (channel, u, v, block) order, so a run is the strip's blocks of one
//      coefficient (u, v), contiguous in the grid.  Dequantized on the way
//      into one f32 tile, each run in its own order: four float4 stores a
//      run in both layouts (stride-B scalar stores made the grid layout
//      ~20% slower than the block layout on an H100);
//   2. vertical pass: one thread per (channel, column), the column's B
//      coefficients in registers, its B outputs written in block order:
//      in place (block layout), or, in the grid layout, after a barrier,
//      from the column's load-order place to its block-order place;
//   3. horizontal pass: one thread per (row, block), all three channels in
//      COLOR mode: B values a channel from the tile, B outputs in
//      registers, then the colour rows, round and clip, and one B-byte
//      store a channel (COLOR) or float4 stores (PLANES); B bytes at a
//      multiple of B are always aligned.
//
// Each tile row holds a float4 of padding after every 32 columns and the
// row stride is 8 (mod 16) words, so at B = 8 the float4 stores of the
// runs, the column reads and writes of the vertical passes (the inverse
// grid layout's reads at stride 16) and the float4 reads of the
// horizontal passes meet no bank conflict.  The float operations and
// their order are those of one output computed on its own, so the result
// depends neither on the layout nor on which thread computes it: forward,
// the colour rows (color_row), an fmaf chain from 0.f over r ascending
// (vertical), one over s ascending (horizontal), then __fmul_rn by the
// table and by float32(1/qss), __float2int_rz, + offset, clamp; inverse,
// an fmaf chain over u, then one over v, the dequantize, colour and
// rounding below.
//
// Both kernels take a layout flag, `cw`: 0 for the block layout, else the
// lane chunk of vcf_tpu's subband-grid tile layout (grid_layout=True,
// dct_kernel.py _grid_perm / _kron_dct_grid): inside each (32, cw) tile,
// rows go in (coeff_y, block_y) and columns in (coeff_x, block_x) order.
// The TPU kernels folded that permutation into their kron matrices; here
// it is only where the bytes are stored (forward) or loaded (inverse), the
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

constexpr int DCT_THREADS = 64;    // forward kernel
constexpr int IDCT_THREADS = 128;  // inverse kernel
constexpr int DCT_STRIP = 1024;  // tile elements per channel: b x (1024 / b)
constexpr int DCT_MAXB = 32;
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

// The b x b DCT matrix by value: D[u][x] at d[u * B + x].
template <int B>
struct DctMat {
  float d[B * B];
};

// A CTA's strip of B rows x TW columns and its f32 tile.
template <int B>
struct Strip {
  static constexpr int TW = DCT_STRIP / B;  // columns
  static constexpr int NK = TW / B;         // blocks in a row
  static constexpr int ROW = TW + TW / 8;   // + a float4 after every 32
  static constexpr int S = ROW + (24 - ROW % 16) % 16;  // stride, 8 mod 16
  static constexpr int RUNS_BLOCK = TW / 16;            // runs of a row
  static constexpr int RUNS_GRID = (NK + 15) / 16;      // runs of a (u, v)
};

// Where this CTA's strip lies: rows [y0, y0 + B), columns [x0, x0 +
// width); in the grid layout also its chunk's first column, its first
// block in the chunk, the chunk's blocks a row (cb) and the grid row of
// coefficient row 0.  Grid (strips across a row, H / B, frames or
// planes); GRID strips are (W / cw) chunks x ceil(cw / TW) strips a chunk.
template <int B, bool GRID>
struct StripAt {
  int y0, x0, width, chunk0 = 0, k0 = 0, cb = 0, grow0 = 0;

  __device__ __forceinline__ StripAt(int W, int cw) {
    using T = Strip<B>;
    y0 = blockIdx.y * B;
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
  }
};

// Tile word of column j: a float4 of padding after every 32 columns.
__device__ __forceinline__ int tile_col(int j) { return j + ((j >> 5) << 2); }

// The n <= 16 bytes at src, packed four a word into w: one uint4 where the
// run is whole and 16-byte aligned, else byte by byte (zeros past n).
__device__ __forceinline__ void load_run16(const uint8_t* src, int n,
                                           uint32_t* w) {
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
}

// The n <= 16 floats at src into v: four float4 where the run is whole
// and 16-byte aligned, else one by one (zeros past n).
__device__ __forceinline__ void load_run16(const float* src, int n,
                                           float* v) {
  if (n == 16 && ((uintptr_t)src & 15) == 0) {
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const float4 x = ((const float4*)src)[f];
      v[4 * f] = x.x; v[4 * f + 1] = x.y; v[4 * f + 2] = x.z;
      v[4 * f + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) v[i] = i < n ? src[i] : 0.f;
  }
}

// n <= 16 values to tile row `row` from column j0: four float4 stores
// when n == 16 (j0 is then a multiple of 16), else one by one.
__device__ __forceinline__ void store_run16(float* row, int j0, int n,
                                            const float* v) {
  if (n == 16) {
    float4* dst = (float4*)(row + tile_col(j0));
#pragma unroll
    for (int f = 0; f < 4; ++f)
      dst[f] = make_float4(v[4 * f], v[4 * f + 1], v[4 * f + 2], v[4 * f + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (i < n) row[tile_col(j0 + i)] = v[i];
  }
}

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

// in (N, C, H, W): f32 planes (PLANES) or u8 pixels with C == 3 (COLOR);
// out (N, C, H, W) u8 indexes, in the subband-grid layout when GRID.
// scale (2, B, B) luma and chroma tables or null (PLANES only).  Grid as
// StripAt's, z = COLOR ? N : N * C.
template <bool COLOR, int B, bool GRID>
__global__ void __launch_bounds__(DCT_THREADS)
dct_forward_kernel(const void* __restrict__ in, uint8_t* __restrict__ out,
                   const DctMat<B> dm, const float* __restrict__ scale,
                   Mat3 m, int C, int H, int W, float recip, int offset,
                   int cw) {
  using T = Strip<B>;
  constexpr int CH = COLOR ? 3 : 1;
  __shared__ __align__(16) float tile[CH * B * T::S];
  __shared__ __align__(16) uint8_t stage[GRID ? CH * DCT_STRIP : 16];
  const size_t plane = (size_t)H * W;
  const size_t fbase = (size_t)blockIdx.z * CH * plane;
  const StripAt<B, GRID> strip(W, cw);
  const float* table =
      scale ? scale + ((blockIdx.z % C) == 0 ? 0 : B * B) : nullptr;

  // 1. runs of 16 pixels of row r -> tile row c * B + r, columns 16q..;
  //    COLOR: (float)px - offset, then the colour rows in registers
  for (int p = threadIdx.x; p < B * T::RUNS_BLOCK; p += DCT_THREADS) {
    const int r = p / T::RUNS_BLOCK, q = p % T::RUNS_BLOCK;
    const int n = min(16, strip.width - 16 * q);
    if (n <= 0) continue;
    const size_t src = fbase + (size_t)(strip.y0 + r) * W + strip.x0 + 16 * q;
    float v[CH][16];
    if constexpr (COLOR) {
      uint32_t w[3][4];
#pragma unroll
      for (int c = 0; c < 3; ++c)
        load_run16((const uint8_t*)in + src + c * plane, n, w[c]);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        float x[3];
#pragma unroll
        for (int c = 0; c < 3; ++c)
          x[c] = (float)((w[c][i >> 2] >> (8 * (i & 3))) & 0xFF) -
                 (float)offset;
#pragma unroll
        for (int d = 0; d < 3; ++d) v[d][i] = color_row(m, d, x[0], x[1], x[2]);
      }
    } else {
      load_run16((const float*)in + src, n, v[0]);
    }
#pragma unroll
    for (int c = 0; c < CH; ++c)
      store_run16(tile + (c * B + r) * T::S, 16 * q, n, v[c]);
  }
  __syncthreads();

  // 2. vertical pass: y[c][u][j] = sum_r D[u][r] x[c][r][j], in place
  for (int e = threadIdx.x; e < CH * T::TW; e += DCT_THREADS) {
    const int c = e / T::TW, j = e % T::TW;
    if (j >= strip.width) continue;
    float* col = tile + c * B * T::S + tile_col(j);
    float x[B];
#pragma unroll
    for (int r = 0; r < B; ++r) x[r] = col[r * T::S];
#pragma unroll
    for (int u = 0; u < B; ++u) {
      float acc = 0.f;
#pragma unroll
      for (int r = 0; r < B; ++r) acc = fmaf(dm.d[u * B + r], x[r], acc);
      col[u * T::S] = acc;
    }
  }
  __syncthreads();

  // 3. horizontal pass: coeff[c][u][kB + v] = sum_s y[c][u][kB + s]
  //    D[v][s]; then [* table[u][v]], quantize, clamp; one B-byte store
  //    (block layout) or B bytes into the staging tile in grid order
  //    ((c, u, v) rows of NK blocks)
  for (int e = threadIdx.x; e < CH * B * T::NK; e += DCT_THREADS) {
    const int c = e / (B * T::NK), u = (e / T::NK) % B, k = e % T::NK;
    if (k * B >= strip.width) continue;
    float y[B];
    load_run<B>(tile + (c * B + u) * T::S + tile_col(k * B), y);
    uint32_t pk[(B + 3) / 4];
#pragma unroll
    for (int f = 0; f < (B + 3) / 4; ++f) pk[f] = 0;
#pragma unroll
    for (int v = 0; v < B; ++v) {
      float acc = 0.f;
#pragma unroll
      for (int s = 0; s < B; ++s) acc = fmaf(y[s], dm.d[v * B + s], acc);
      if (table) acc = __fmul_rn(acc, __ldg(table + u * B + v));
      const int q8 =
          min(max(__float2int_rz(__fmul_rn(acc, recip)) + offset, 0), 255);
      if constexpr (GRID)
        stage[((c * B + u) * B + v) * T::NK + k] = (uint8_t)q8;
      else
        pk[v >> 2] |= (uint32_t)q8 << (8 * (v & 3));
    }
    if constexpr (!GRID)
      store_bytes<B>(out + fbase + c * plane + (size_t)(strip.y0 + u) * W +
                         strip.x0 + k * B,
                     pk);
  }
  if constexpr (GRID) {
    __syncthreads();
    // the strip's blocks of coefficient (c, u, v): grid row grow0 +
    // u * (32 / B), columns chunk0 + v * cb + k0 .. in runs of 16 bytes
    const int nk = strip.width / B;
    for (int p = threadIdx.x; p < CH * B * B * T::RUNS_GRID;
         p += DCT_THREADS) {
      const int seg = p / T::RUNS_GRID, q = p % T::RUNS_GRID;
      const int n = min(16, nk - 16 * q);
      if (n <= 0) continue;
      const int c = seg / (B * B), u = (seg / B) % B, v = seg % B;
      uint8_t* dst = out + fbase + c * plane +
                     (size_t)(strip.grow0 + u * (DCT_GRID_ROWS / B)) * W +
                     strip.chunk0 + v * strip.cb + strip.k0 + 16 * q;
      const uint8_t* src = stage + seg * T::NK + 16 * q;
      if (n == 16 && ((uintptr_t)dst & 15) == 0) {
        *(uint4*)dst = *(const uint4*)src;  // NK % 16 == 0: src aligned
      } else {
        for (int i = 0; i < n; ++i) dst[i] = src[i];
      }
    }
  }
}

// in (N, C, H, W) u8 indexes (C == 3 in COLOR mode), in the subband-grid
// layout when GRID; out (N, C, H, W) f32 planes (PLANES) or u8 pixels
// (COLOR), block layout.  scale (2, B, B) or null (PLANES only).  Grid as
// StripAt's, z = COLOR ? N : N * C.
template <bool COLOR, int B, bool GRID>
__global__ void __launch_bounds__(IDCT_THREADS)
dct_inverse_kernel(const uint8_t* __restrict__ in, void* __restrict__ out,
                   const DctMat<B> dm, const float* __restrict__ scale,
                   Mat3 m, int C, int H, int W, float qss, int offset,
                   int cw) {
  using T = Strip<B>;
  constexpr int CH = COLOR ? 3 : 1;
  __shared__ __align__(16) float tile[CH * B * T::S];
  const size_t plane = (size_t)H * W;
  const size_t fbase = (size_t)blockIdx.z * CH * plane;
  const StripAt<B, GRID> strip(W, cw);
  const float* table =
      scale ? scale + ((blockIdx.z % C) == 0 ? 0 : B * B) : nullptr;

  // 1. index runs -> dequantized coefficients: (k - offset) * qss
  //    [/ table[u][v]]; coefficient (c, u, v) of block k goes to row
  //    c * B + u of the tile, column k * B + v (block layout) or, in the
  //    grid layout, v * NK + k: the run's own order, so each run is four
  //    float4 stores in both layouts
  constexpr int RUNS = GRID ? T::RUNS_GRID : T::RUNS_BLOCK;
  constexpr int SEGS = GRID ? CH * B * B : CH * B;
  const int len = GRID ? strip.width / B : strip.width;  // bytes of a segment
  for (int p = threadIdx.x; p < SEGS * RUNS; p += IDCT_THREADS) {
    const int seg = p / RUNS, q = p - seg * RUNS;
    const int n = min(16, len - 16 * q);
    if (n <= 0) continue;
    const int c = GRID ? seg / (B * B) : seg / B;
    const int u = GRID ? (seg / B) % B : seg % B;
    const int v = GRID ? seg % B : 0;
    const uint8_t* src =
        GRID ? in + fbase + c * plane +
                   (size_t)(strip.grow0 + u * (DCT_GRID_ROWS / B)) * W +
                   strip.chunk0 + v * strip.cb + strip.k0 + 16 * q
             : in + fbase + c * plane + (size_t)(strip.y0 + u) * W + strip.x0 +
                   16 * q;
    uint32_t w[4];
    load_run16(src, n, w);
    float coeff[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int vi = GRID ? v : (16 * q + i) & (B - 1);
      const int k = (int)((w[i >> 2] >> (8 * (i & 3))) & 0xFF) - offset;
      coeff[i] = __fmul_rn((float)k, qss);
      if (table) coeff[i] = __fdiv_rn(coeff[i], __ldg(table + u * B + vi));
    }
    store_run16(tile + (c * B + u) * T::S, (GRID ? v * T::NK : 0) + 16 * q,
                n, coeff);
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
    if (e >= CH * T::TW || j >= strip.width) continue;
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
    if (e >= CH * T::TW || j >= strip.width) continue;
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
    if (k * B >= strip.width) continue;
    const size_t at = fbase + (size_t)(strip.y0 + r) * W + strip.x0 + k * B;
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

// Either kernel's arguments but the DCT matrix; `step` is float32(1/qss)
// (forward) or qss (inverse).
struct DctArgs {
  const void* in;
  void* out;
  const float* scale;
  Mat3 mat;
  bool color;
  int N, C, H, W;
  float step;
  int offset, cw;
  cudaStream_t st;
};

template <bool FWD, bool COLOR, int B, bool GRID>
static void launch_one(const DctArgs& a, const DctMat<B>& dm, dim3 grid) {
  const float* scale = COLOR ? nullptr : a.scale;
  if constexpr (FWD)
    dct_forward_kernel<COLOR, B, GRID><<<grid, DCT_THREADS, 0, a.st>>>(
        a.in, (uint8_t*)a.out, dm, scale, a.mat, a.C, a.H, a.W, a.step,
        a.offset, a.cw);
  else
    dct_inverse_kernel<COLOR, B, GRID><<<grid, IDCT_THREADS, 0, a.st>>>(
        (const uint8_t*)a.in, a.out, dm, scale, a.mat, a.C, a.H, a.W,
        a.step, a.offset, a.cw);
}

// Launch the forward (FWD) or inverse kernel <COLOR, B, GRID> on a shape
// dct_args accepted.
template <bool FWD, int B>
static int launch_dct(const DctArgs& a, const float* dmat) {
  constexpr int TW = Strip<B>::TW;
  DctMat<B> dm;
  for (int i = 0; i < B * B; ++i) dm.d[i] = dmat[i];
  const int strips =
      a.cw ? (a.W / a.cw) * ((a.cw + TW - 1) / TW) : (a.W + TW - 1) / TW;
  const dim3 grid(strips, a.H / B, a.color ? a.N : a.N * a.C);
  if (a.color && a.cw)
    launch_one<FWD, true, B, true>(a, dm, grid);
  else if (a.color)
    launch_one<FWD, true, B, false>(a, dm, grid);
  else if (a.cw)
    launch_one<FWD, false, B, true>(a, dm, grid);
  else
    launch_one<FWD, false, B, false>(a, dm, grid);
  return (int)cudaGetLastError();
}

// The shape checks of both directions, then the launch.
template <bool FWD>
static int dct_entry(const void* in, void* out, const float* dmat,
                     const void* scale, const float* m, int N, int C, int H,
                     int W, int b, float step, int offset, int cw,
                     void* stream) {
  if (b < 1 || b > DCT_MAXB || (b & (b - 1)) || H % b || W % b || N < 1 ||
      C < 1 || (m && C != 3))
    return (int)cudaErrorInvalidValue;
  if (cw && (cw < 0 || H % DCT_GRID_ROWS || cw % b || W % cw))
    return (int)cudaErrorInvalidValue;
  DctArgs a{in, out, (const float*)scale, {}, m != nullptr, N, C, H, W,
            step, offset, cw, (cudaStream_t)stream};
  for (int i = 0; i < 9; ++i) a.mat.m[i] = m ? m[i] : 0.f;
  switch (b) {
    case 1: return launch_dct<FWD, 1>(a, dmat);
    case 2: return launch_dct<FWD, 2>(a, dmat);
    case 4: return launch_dct<FWD, 4>(a, dmat);
    case 8: return launch_dct<FWD, 8>(a, dmat);
    case 16: return launch_dct<FWD, 16>(a, dmat);
    default: return launch_dct<FWD, 32>(a, dmat);
  }
}

}  // namespace vcf

extern "C" {

// in (N, C, H, W) f32 (m null) or u8 (m = 3x3 forward matrix on the host,
// C == 3); out (N, C, H, W) u8; dmat (b, b) f32 on the HOST (passed by
// value to the kernel); scale (2, b, b) f32 or null on the device; cw 0
// (block layout) or the grid layout's chunk.  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for a shape it does not take.
int vcf_dct_forward(const void* in, void* out, const float* dmat,
                    const void* scale, const float* m, int N, int C, int H,
                    int W, int b, float recip, int offset, int cw,
                    void* stream) {
  return vcf::dct_entry<true>(in, out, dmat, scale, m, N, C, H, W, b, recip,
                              offset, cw, stream);
}

// in (N, C, H, W) u8 indexes; out (N, C, H, W) f32 (m null) or u8 pixels
// (m = 3x3 inverse matrix on the host, C == 3); the rest as
// vcf_dct_forward's.
int vcf_dct_inverse(const void* in, void* out, const float* dmat,
                    const void* scale, const float* m, int N, int C, int H,
                    int W, int b, float qss, int offset, int cw,
                    void* stream) {
  return vcf::dct_entry<false>(in, out, dmat, scale, m, N, C, H, W, b, qss,
                               offset, cw, stream);
}

}  // extern "C"
