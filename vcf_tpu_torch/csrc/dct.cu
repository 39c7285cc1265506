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
// Design: one CTA per strip of b rows x (1024 / b) columns of one frame
// (all three channels in COLOR mode, one plane in PLANES mode).  Loads are
// coalesced (neighbouring threads, neighbouring columns) into an f32 tile
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

// in (N, C, H, W) u8 indexes (C == 3 in COLOR mode); out (N, C, H, W) f32
// planes (PLANES) or u8 pixels (COLOR).  Grid as for the forward kernel.
template <bool COLOR>
__global__ void __launch_bounds__(DCT_THREADS)
dct_inverse_kernel(const uint8_t* __restrict__ in, void* __restrict__ out,
                   const float* __restrict__ dmat,
                   const float* __restrict__ scale, Mat3 m, int C, int H,
                   int W, int b, float qss, int offset, int cw) {
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
  __syncthreads();  // the dequantize loop reads s_sc

  // dequantize: coeff = (k - offset) * qss [/ table[u][v]]
  for (int e = threadIdx.x; e < CH * DCT_STRIP; e += DCT_THREADS) {
    const int c = e / DCT_STRIP, rem = e - c * DCT_STRIP;
    const int u = rem / tw, j = rem - u * tw;
    float coeff = 0.f;
    if (j < width) {
      const size_t at =
          cw ? fbase + grid_at(blockIdx.y * b + u, x0 + j, W, b, cw)
             : base + (size_t)u * W + j;
      const int k = (int)in[at + c * plane] - offset;
      coeff = __fmul_rn((float)k, qss);
      if (table) coeff = __fdiv_rn(coeff, s_sc[u * b + (j & (b - 1))]);
    }
    s_x[c][rem] = coeff;
  }
  __syncthreads();

  // vertical pass: y[c][r][j] = sum_u D[u][r] coeff[c][u][j]
  for (int e = threadIdx.x; e < CH * DCT_STRIP; e += DCT_THREADS) {
    const int c = e / DCT_STRIP, rem = e - c * DCT_STRIP;
    const int r = rem / tw, j = rem - r * tw;
    const float* xc = s_x[c] + j;
    float acc = 0.f;
    for (int u = 0; u < b; ++u)
      acc = fmaf(s_d[u * (b + 1) + r], xc[u * tw], acc);
    s_y[c][rem] = acc;
  }
  __syncthreads();

  // horizontal pass: x[c][r][j] = sum_v y[c][r][j - s + v] D[v][s],
  // s = j mod b
  for (int e = threadIdx.x; e < CH * DCT_STRIP; e += DCT_THREADS) {
    const int c = e / DCT_STRIP, rem = e - c * DCT_STRIP;
    const int r = rem / tw, j = rem - r * tw;
    if (j >= width) continue;
    const int s = j & (b - 1);
    const float* yr = s_y[c] + r * tw + (j - s);
    float acc = 0.f;
    for (int v = 0; v < b; ++v) acc = fmaf(yr[v], s_d[v * (b + 1) + s], acc);
    if constexpr (COLOR)
      s_x[c][rem] = acc;
    else
      ((float*)out)[base + (size_t)r * W + j] = acc;
  }
  if constexpr (COLOR) {
    __syncthreads();
    // color inverse rows + offset, round half to even, clip, store
    uint8_t* px = (uint8_t*)out;
    for (int e = threadIdx.x; e < DCT_STRIP; e += DCT_THREADS) {
      const int r = e / tw, j = e - r * tw;
      if (j >= width) continue;
      const float t0 = s_x[0][e], t1 = s_x[1][e], t2 = s_x[2][e];
      const size_t at = base + (size_t)r * W + j;
      for (int c = 0; c < 3; ++c) {
        const float pix =
            __fadd_rn(color_row(m, c, t0, t1, t2), (float)offset);
        const int k = min(max(__float2int_rn(pix), 0), 255);
        px[at + c * plane] = (uint8_t)k;
      }
    }
  }
}

// Launch geometry shared by both directions; returns false for a shape
// the kernels do not take.
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
// (m = 3x3 inverse matrix on the host, C == 3); dmat and scale as above.
int vcf_dct_inverse(const void* in, void* out, const void* dmat,
                    const void* scale, const float* m, int N, int C, int H,
                    int W, int b, float qss, int offset, int cw,
                    void* stream) {
  dim3 grid;
  vcf::Mat3 mat;
  if (!vcf::dct_grid(m, N, C, H, W, b, cw, &grid, &mat))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (m)
    vcf::dct_inverse_kernel<true><<<grid, vcf::DCT_THREADS, 0, st>>>(
        (const uint8_t*)in, out, (const float*)dmat, nullptr, mat, C, H, W,
        b, qss, offset, cw);
  else
    vcf::dct_inverse_kernel<false><<<grid, vcf::DCT_THREADS, 0, st>>>(
        (const uint8_t*)in, out, (const float*)dmat, (const float*)scale, mat,
        C, H, W, b, qss, offset, cw);
  return (int)cudaGetLastError();
}

}  // extern "C"
