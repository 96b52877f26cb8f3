// SemiGlobalBlock contract path, fused: leaky(maxpool80(conv1d_same_k5(h, w) + b)).
//
// Replaces the TPU kernel stofnet_tpu/ops/pallas/sgb_kernel.py:sgb_contract_pool
// (_run/_kernel). h (B, L, 64) bf16 with L % 80 == 0, weights (5, 64, F) bf16,
// bias (F,) f32 -> out (B, L/80, F) bf16. The (B, L, F) pre-pool tensor never
// leaves the chip: each warp pools its 80 rows in registers and only the pooled
// row is written.
//
// Bound on the H100: operations. At B=128, L=8000, F=512 the conv is a
// 1,024,000 x 512 x 320 GEMM (3.36e11 FLOP, 0.34 ms at 989 TFLOP/s bf16),
// against 131 MB read and 13 MB written (0.04 ms at 3.35 TB/s).
//
// Design: an implicit GEMM on the tensor cores with mma.sync m16n8k16 (bf16 in,
// f32 accumulate). M = positions, N = output channels, K = 5 taps x 64 channels.
// A CTA keeps a 128-channel slice of the weights in shared memory for its whole
// life (persistent: it walks over tiles of two pool windows). A tile loads each
// window's 80 rows plus a 2-row halo on each side (zeros beyond the sequence
// ends); tap t of output row m reads shared row m + t, so no im2col copy is
// made. Warp (wm, wn) owns window wm and channels [32 wn, 32 wn + 32): the
// window max is a register max over its 5 m16 tiles and a shuffle over the 8
// row groups of the accumulator fragment. leaky is applied to the pooled value
// (exact: leaky is monotone). Rows of 72 bf16 (input) and 328 bf16 (weights)
// keep the fragment loads free of bank conflicts. No cp.async, TMA or wgmma
// yet: this is the simple first version.

#include "common.cuh"

namespace {

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
constexpr int SMEM_IN = WINDOWS * ROWS * IN_STRIDE * 2;    // 24,192 B
constexpr int SMEM = SMEM_W + SMEM_IN;                     // 108,160 B

__global__ void __launch_bounds__(THREADS, 2)
sgb_contract_pool_kernel(const __nv_bfloat16* __restrict__ h,   // (B, L, 64)
                         const __nv_bfloat16* __restrict__ wt,  // (F, 320): [n][t*64 + c]
                         const float* __restrict__ bias,        // (F,)
                         __nv_bfloat16* __restrict__ out,       // (B, L/80, F)
                         int L, int F, long long total_windows, float slope) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + SMEM_W);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;  // fragment row group, column pair
  const int wm = warp >> 2;                // window slot of this warp
  const int wn = warp & 3;                 // 32-channel slice of this warp
  const int n0 = blockIdx.x * N_TILE;
  const int W = L / POOL;
  const long long n_tiles = (total_windows + WINDOWS - 1) / WINDOWS;

  // this CTA's weight slice, once: 128 rows of 320 bf16 (40 x 16 B each)
  for (int i = tid; i < N_TILE * (KC / 8); i += THREADS) {
    const int r = i / (KC / 8), v = i % (KC / 8);
    const uint4 val = reinterpret_cast<const uint4*>(wt + (size_t)(n0 + r) * KC)[v];
    *reinterpret_cast<uint4*>(ws + r * W_STRIDE + v * 8) = val;
  }

  const __nv_bfloat16* xw = xs + wm * ROWS * IN_STRIDE;
  const __nv_bfloat16* wb = ws + (wn * 32) * W_STRIDE;

  for (long long tile = blockIdx.y; tile < n_tiles; tile += gridDim.y) {
    // two windows of 84 rows x 64 channels (8 x 16 B per row); rows outside
    // [0, L) are the SAME conv's zero padding
    for (int i = tid; i < WINDOWS * ROWS * (C / 8); i += THREADS) {
      const int slot = i / (ROWS * (C / 8));
      const int rem = i % (ROWS * (C / 8));
      const int r = rem / (C / 8), v = rem % (C / 8);
      const long long gw = tile * WINDOWS + slot;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (gw < total_windows) {
        const long long b = gw / W;
        const int p = (int)(gw % W) * POOL - PAD + r;
        if (p >= 0 && p < L)
          val = reinterpret_cast<const uint4*>(h + ((size_t)b * L + p) * C)[v];
      }
      *reinterpret_cast<uint4*>(xs + (slot * ROWS + r) * IN_STRIDE + v * 8) = val;
    }
    __syncthreads();

    float acc[M_TILES][N_SUB][4];
#pragma unroll
    for (int i = 0; i < M_TILES; ++i)
#pragma unroll
      for (int j = 0; j < N_SUB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

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
          // output row m reads input row m + t (row 0 is position -2)
          const __nv_bfloat16* ap = xw + (i * 16 + g + t) * IN_STRIDE + c0 + 2 * tq;
          const uint32_t a[4] = {ld32(ap), ld32(ap + 8 * IN_STRIDE), ld32(ap + 8),
                                 ld32(ap + 8 * IN_STRIDE + 8)};
#pragma unroll
          for (int j = 0; j < N_SUB; ++j) mma_bf16(acc[i][j], a, b[j][0], b[j][1]);
        }
      }
    }

    // window max: registers over rows g and g+8 of each m tile, then the
    // eight row groups (lane bits 2..4) by shuffle
    float mx[N_SUB][2];
#pragma unroll
    for (int j = 0; j < N_SUB; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float m = fmaxf(acc[0][j][e], acc[0][j][e + 2]);
#pragma unroll
        for (int i = 1; i < M_TILES; ++i)
          m = fmaxf(m, fmaxf(acc[i][j][e], acc[i][j][e + 2]));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 4));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 8));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 16));
        mx[j][e] = m;
      }

    const long long gw = tile * WINDOWS + wm;
    if (g == 0 && gw < total_windows) {
#pragma unroll
      for (int j = 0; j < N_SUB; ++j) {
        const int n = n0 + wn * 32 + j * 8 + 2 * tq;
        float v0 = mx[j][0] + bias[n];
        float v1 = mx[j][1] + bias[n + 1];
        v0 = v0 >= 0.f ? v0 : slope * v0;  // leaky after the pool (exact)
        v1 = v1 >= 0.f ? v1 : slope * v1;
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)gw * F + n) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
    __syncthreads();  // the next tile overwrites xs
  }
}

}  // namespace

extern "C" int sgb_contract_pool_launch(const void* h, const void* wt, const void* bias,
                                        void* out, int B, int L, int F, float slope,
                                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(sgb_contract_pool_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;

  const long long total_windows = (long long)B * (L / POOL);
  const long long n_tiles = (total_windows + WINDOWS - 1) / WINDOWS;
  const int n_slices = F / N_TILE;
  long long per_slice = (2LL * sms + n_slices - 1) / n_slices;  // two CTAs per SM
  if (per_slice > n_tiles) per_slice = n_tiles;
  if (per_slice < 1) per_slice = 1;
  dim3 grid(n_slices, (unsigned)per_slice);
  sgb_contract_pool_kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)h, (const __nv_bfloat16*)wt, (const float*)bias,
      (__nv_bfloat16*)out, L, F, total_windows, slope);
  return cudaGetLastError();
}
