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
// live in sgb_window.cuh; they serve this kernel and kernel A only (the
// streamed kernel, sgb_contract_pool_dma.cu, runs on wgmma).
//
// Kernel A, the forward of the trainable op (replaces _run(with_argmax=True)
// of sgb_kernel.py, reached from sgb_contract_pool_trainable's _trainable_fwd):
// the same mainloop (template flag ARGMAX), plus the int32 offset (0..79) of
// each window's first maximal element. As in the JAX kernel, the maximum and
// its offset are taken on y = bias + sum of taps in f32: the accumulator
// starts at the bias. Rows are reduced as (value, row) pairs, on equal values
// keeping the lower row: in registers over rows g, g+8, 16+g, ... in that
// order, then across the three shuffles. Only the 80 real rows of a window
// are candidates, never the halo rows. Its bound is the serving kernel's
// (operations), plus 26 MB of offsets written at B=128, L=8000, F=512.

#include "sgb_window.cuh"

namespace {

using namespace sgb;

constexpr int SMEM_IN = SMEM_TILE;                         // 24,192 B
constexpr int SMEM = SMEM_W + SMEM_IN;                     // 108,160 B

template <bool ARGMAX>
__global__ void __launch_bounds__(THREADS, 2)
sgb_contract_pool_kernel(const __nv_bfloat16* __restrict__ h,   // (B, L, 64)
                         const __nv_bfloat16* __restrict__ wt,  // (F, 320): [n][t*64 + c]
                         const float* __restrict__ bias,        // (F,)
                         __nv_bfloat16* __restrict__ out,       // (B, L/80, F)
                         int* __restrict__ offs,                // (B, L/80, F), ARGMAX only
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
    for (int j = 0; j < N_SUB; ++j) {
      // ARGMAX: y = bias + taps, the value the JAX kernel takes the argmax of
      const int n = n0 + wn * 32 + j * 8 + 2 * tq;
      const float b0 = ARGMAX ? bias[n] : 0.f, b1 = ARGMAX ? bias[n + 1] : 0.f;
#pragma unroll
      for (int i = 0; i < M_TILES; ++i) {
        acc[i][j][0] = acc[i][j][2] = b0;
        acc[i][j][1] = acc[i][j][3] = b1;
      }
    }

    window_mma(acc, xw, wb, g, tq);

    if constexpr (!ARGMAX) {
      float mx[N_SUB][2];
      window_max(acc, mx);
      const long long gw = tile * WINDOWS + wm;
      if (gw < total_windows)
        store_pooled(out + (size_t)gw * F, bias, mx, n0 + wn * 32, g, tq, slope);
    } else {
      // (value, row) pairs: first maximal row of the window, ties to the
      // lower; each column pair is written as soon as it is reduced
      const long long gw = tile * WINDOWS + wm;
#pragma unroll
      for (int j = 0; j < N_SUB; ++j) {
        float mx[2];
        int ix[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float m = acc[0][j][e];
          int r = g;
#pragma unroll
          for (int i = 0; i < M_TILES; ++i) {  // rows 16i+g, then 16i+g+8
            if (i > 0 && acc[i][j][e] > m) { m = acc[i][j][e]; r = i * 16 + g; }
            if (acc[i][j][e + 2] > m) { m = acc[i][j][e + 2]; r = i * 16 + g + 8; }
          }
#pragma unroll
          for (int s = 4; s <= 16; s <<= 1) {
            const float om = __shfl_xor_sync(0xffffffffu, m, s);
            const int orow = __shfl_xor_sync(0xffffffffu, r, s);
            if (om > m || (om == m && orow < r)) { m = om; r = orow; }
          }
          mx[e] = m >= 0.f ? m : slope * m;  // the bias is in already
          ix[e] = r;
        }
        if (g == 0 && gw < total_windows) {
          const int n = n0 + wn * 32 + j * 8 + 2 * tq;
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)gw * F + n) =
              __floats2bfloat162_rn(mx[0], mx[1]);
          *reinterpret_cast<int2*>(offs + (size_t)gw * F + n) = make_int2(ix[0], ix[1]);
        }
      }
    }
    __syncthreads();  // the next tile overwrites xs
  }
}

template <bool ARGMAX>
int launch(const void* h, const void* wt, const void* bias, void* out, void* offs,
           int B, int L, int F, float slope, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(sgb_contract_pool_kernel<ARGMAX>,
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
  sgb_contract_pool_kernel<ARGMAX><<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)h, (const __nv_bfloat16*)wt, (const float*)bias,
      (__nv_bfloat16*)out, (int*)offs, L, F, total_windows, slope);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sgb_contract_pool_launch(const void* h, const void* wt, const void* bias,
                                        void* out, int B, int L, int F, float slope,
                                        int device, void* stream) {
  return launch<false>(h, wt, bias, out, nullptr, B, L, F, slope, device, stream);
}

// kernel A: pooled output and the int32 offsets (B, L/80, F) of the first
// maximal element of each window
extern "C" int sgb_contract_pool_argmax_launch(const void* h, const void* wt,
                                               const void* bias, void* out, void* offs,
                                               int B, int L, int F, float slope,
                                               int device, void* stream) {
  return launch<true>(h, wt, bias, out, offs, B, L, F, slope, device, stream);
}
