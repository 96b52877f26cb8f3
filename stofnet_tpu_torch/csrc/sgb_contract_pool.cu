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
// yet: this is the simple first version. The mainloop and the pooled epilogue
// live in sgb_window.cuh, which serves this kernel alone (the streamed kernel
// and kernel A, the trainable op's forward with argmax, run on wgmma in
// sgb_contract_pool_dma.cu).

#include "sgb_window.cuh"

namespace {

using namespace sgb;

constexpr int SMEM_IN = SMEM_TILE;                         // 24,192 B
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

    window_mma(acc, xw, wb, g, tq);

    float mx[N_SUB][2];
    window_max(acc, mx);
    const long long gw = tile * WINDOWS + wm;
    if (gw < total_windows)
      store_pooled(out + (size_t)gw * F, bias, mx, n0 + wn * 32, g, tq, slope);
    __syncthreads();  // the next tile overwrites xs
  }
}

}  // namespace

extern "C" int sgb_contract_pool_launch(const void* h, const void* wt, const void* bias,
                                        void* out, int B, int L, int F, float slope,
                                        int device, void* stream) {
  cudaError_t err = use_device(device);
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
