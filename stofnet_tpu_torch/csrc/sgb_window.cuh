// The SGB contract+pool mma.sync mainloop of the tile kernel
// (sgb_contract_pool.cu), which it serves alone: the streamed kernel and
// kernel A run on wgmma (sgb_contract_pool_dma.cu).
//
// A CTA holds a 128-channel slice of the contract conv's weights in shared
// memory as rows of W_STRIDE bf16 ([n][t * 64 + c], 8 bf16 of padding), and
// stages pool windows of ROWS = 84 input rows (80 plus a 2-row halo on each
// side) as rows of IN_STRIDE bf16. Warp (wm, wn) owns window wm of a
// WINDOWS-window tile and channels [32 wn, 32 wn + 32). Both strides keep the
// fragment loads free of bank conflicts.
#pragma once

#include "common.cuh"

namespace sgb {

constexpr int C = 64;                  // input channels
constexpr int K = 5;                   // taps
constexpr int PAD = K / 2;             // SAME padding of a k5 conv
constexpr int POOL = 80;               // pool window = semi_global_scale
constexpr int KC = K * C;              // GEMM depth, 320
constexpr int N_TILE = 128;            // output channels per CTA
constexpr int WINDOWS = 2;             // pool windows per tile, one per warp row
constexpr int ROWS = POOL + 2 * PAD;   // input rows per window, 84
constexpr int IN_STRIDE = C + 8;       // bf16 per shared input row
constexpr int W_STRIDE = KC + 8;       // bf16 per shared weight row
constexpr int THREADS = 256;           // 8 warps: 2 windows x 4 channel slices
constexpr int M_TILES = POOL / 16;     // m16 tiles per window, 5
constexpr int N_SUB = 4;               // n8 tiles per warp, 32 channels

constexpr int SMEM_W = N_TILE * W_STRIDE * 2;              // 83,968 B
constexpr int SMEM_TILE = WINDOWS * ROWS * IN_STRIDE * 2;  // 24,192 B

// acc[i][j] += conv of the window's output rows 16 i .. 16 i + 15 with the
// warp's channels 8 j .. 8 j + 7. xw: the window's 84 staged rows (row 0 is
// position -2); wb: the warp's first weight row. Output row m reads input row
// m + t for tap t, so no im2col copy is made.
__device__ __forceinline__ void window_mma(float (&acc)[M_TILES][N_SUB][4],
                                           const __nv_bfloat16* xw,
                                           const __nv_bfloat16* wb, int g, int tq) {
#pragma unroll
  for (int t = 0; t < K; ++t) {
#pragma unroll
    for (int c0 = 0; c0 < C; c0 += 16) {
      const int k0 = t * C + c0;
      uint32_t b[N_SUB][2];
#pragma unroll
      for (int j = 0; j < N_SUB; ++j) {
        const __nv_bfloat16* bp = wb + (j * 8 + g) * W_STRIDE + k0 + 2 * tq;
        b[j][0] = ld32(bp);
        b[j][1] = ld32(bp + 8);
      }
#pragma unroll
      for (int i = 0; i < M_TILES; ++i) {
        const __nv_bfloat16* ap = xw + (i * 16 + g + t) * IN_STRIDE + c0 + 2 * tq;
        const uint32_t a[4] = {ld32(ap), ld32(ap + 8 * IN_STRIDE), ld32(ap + 8),
                               ld32(ap + 8 * IN_STRIDE + 8)};
#pragma unroll
        for (int j = 0; j < N_SUB; ++j) mma_bf16(acc[i][j], a, b[j][0], b[j][1]);
      }
    }
  }
}

// Window max of each of the lane's columns (2 tq, 2 tq + 1 of each n8 tile):
// registers over rows g and g + 8 of each m tile, then the eight row groups
// (lane bits 2..4) by shuffle. Every lane ends with the window's max.
__device__ __forceinline__ void window_max(const float (&acc)[M_TILES][N_SUB][4],
                                           float (&mx)[N_SUB][2]) {
#pragma unroll
  for (int j = 0; j < N_SUB; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float m = fmaxf(acc[0][j][e], acc[0][j][e + 2]);
#pragma unroll
      for (int i = 1; i < M_TILES; ++i) m = fmaxf(m, fmaxf(acc[i][j][e], acc[i][j][e + 2]));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 4));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 8));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 16));
      mx[j][e] = m;
    }
}

// leaky(max + bias) of the lane's columns, rounded once to bf16, into the
// pooled row `row` (F channels) by the lanes of row group 0 (leaky after the
// pool is exact: leaky is monotone).
__device__ __forceinline__ void store_pooled(__nv_bfloat16* row, const float* bias,
                                             const float (&mx)[N_SUB][2], int n_warp,
                                             int g, int tq, float slope) {
  if (g != 0) return;
#pragma unroll
  for (int j = 0; j < N_SUB; ++j) {
    const int n = n_warp + j * 8 + 2 * tq;
    float v0 = mx[j][0] + bias[n];
    float v1 = mx[j][1] + bias[n + 1];
    v0 = v0 >= 0.f ? v0 : slope * v0;
    v1 = v1 >= 0.f ? v1 : slope * v1;
    *reinterpret_cast<__nv_bfloat162*>(row + n) = __floats2bfloat162_rn(v0, v1);
  }
}

}  // namespace sgb
