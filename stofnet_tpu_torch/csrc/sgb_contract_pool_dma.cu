// SemiGlobalBlock contract path with the input streamed through a copy ring:
// leaky(maxpool80(conv1d_same_k5(h, w) + b)).
//
// Replaces the TPU kernel stofnet_tpu/ops/pallas/sgb_dma_kernel.py:
// sgb_contract_pool_dma (_kernel), whose point is an explicit double-buffered
// copy of the input from device memory (pltpu.make_async_copy with
// semaphores). h (B, L, 64) bf16 with L % 800 == 0, weights (F, 320) bf16 as
// [n][t*64 + c], bias (F,) f32 -> out (B, L/80, F) bf16. The function is the
// tile kernel's (sgb_contract_pool.cu); only the way the input arrives
// differs.
//
// Bound on the H100: operations, as the tile kernel's. At B=128, L=8000,
// F=512 the direct conv is 3.36e11 FLOP (0.339 ms at 989 TFLOP/s bf16),
// against 131 MB read and 13 MB written (0.04 ms at 3.35 TB/s).
//
// Design: one CTA per (waveform, 128-channel slice), as the TPU grid gives
// one program per waveform. The CTA keeps its weight slice in shared memory
// for its life and walks the waveform's L/80 pool windows, two at a time,
// through a ring of STAGES input stages. Each stage is filled with
// cp.async.cg 16-byte copies (one commit group per stage); rows outside
// [0, L) are zero-filled by the copy itself (source size 0), which is the
// SAME conv's zero padding. At step s the CTA waits for stage s's group,
// synchronises (every thread's copies are visible, and every warp is done
// with stage s-1), issues the copies of stage s + STAGES - 1 into the slot
// that stage s-1 held, then runs the tile kernel's mma.sync mainloop and
// pooled epilogue (sgb_window.cuh) on stage s. The weight slice is copied
// with the first stage's group.
//
// Not carried over from the TPU kernel: the pair-packed 128-lane rows, the
// 16-row output blocks and the 800-sample chunk (the TPU's lane and sublane
// rules). A chunk of 804 rows x 64 bf16 is 103 KB, and two of them plus the
// weight slice would not fit in a block's 227 KB of shared memory.
//
// Shared memory: the weight slice 128 x 328 bf16 = 83,968 B; a stage is two
// windows of 84 rows x 72 bf16 = 24,192 B; three stages 72,576 B; in all
// 156,544 B, so one CTA (8 warps) per SM. At B=128, F=512: 512 CTAs, 3.9
// waves over 132 SMs.

#include "sgb_window.cuh"

namespace {

using namespace sgb;

constexpr int STAGES = 3;
constexpr int SMEM = SMEM_W + STAGES * SMEM_TILE;  // 156,544 B

__global__ void __launch_bounds__(THREADS, 1)
sgb_contract_pool_dma_kernel(const __nv_bfloat16* __restrict__ h,   // (B, L, 64)
                             const __nv_bfloat16* __restrict__ wt,  // (F, 320)
                             const float* __restrict__ bias,        // (F,)
                             __nv_bfloat16* __restrict__ out,       // (B, L/80, F)
                             int L, int F, float slope) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + SMEM_W);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;  // fragment row group, column pair
  const int wm = warp >> 2;                // window slot of this warp
  const int wn = warp & 3;                 // 32-channel slice of this warp
  const int n0 = blockIdx.x * N_TILE;
  const int b = blockIdx.y;
  const int W = L / POOL;                  // windows of this waveform, even
  const int n_tiles = W / WINDOWS;
  const __nv_bfloat16* hb = h + (size_t)b * L * C;

  // stage `tile` into ring slot `slot`: two windows of 84 rows x 8 x 16 B
  auto issue = [&](int tile, int slot) {
    __nv_bfloat16* dst = xs + slot * (WINDOWS * ROWS * IN_STRIDE);
    for (int i = tid; i < WINDOWS * ROWS * (C / 8); i += THREADS) {
      const int w = i / (ROWS * (C / 8));
      const int rem = i % (ROWS * (C / 8));
      const int r = rem / (C / 8), v = rem % (C / 8);
      const int p = (tile * WINDOWS + w) * POOL - PAD + r;
      const bool in = p >= 0 && p < L;
      cp_async16(dst + (w * ROWS + r) * IN_STRIDE + v * 8,
                 hb + (size_t)(in ? p : 0) * C + v * 8, in ? 16 : 0);
    }
  };

  // the weight slice (128 rows of 40 x 16 B) joins stage 0's group
  for (int i = tid; i < N_TILE * (KC / 8); i += THREADS) {
    const int r = i / (KC / 8), v = i % (KC / 8);
    cp_async16(ws + r * W_STRIDE + v * 8, wt + (size_t)(n0 + r) * KC + v * 8);
  }
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) issue(s, s);
    cp_async_commit();  // one group per stage, empty ones included
  }

  const __nv_bfloat16* wb = ws + (wn * 32) * W_STRIDE;
  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of stage `tile` landed
    __syncthreads();              // everyone's did; slot (tile - 1) % STAGES is free
    const int next = tile + STAGES - 1;
    if (next < n_tiles) issue(next, next % STAGES);
    cp_async_commit();

    const __nv_bfloat16* xw =
        xs + (tile % STAGES) * (WINDOWS * ROWS * IN_STRIDE) + wm * ROWS * IN_STRIDE;
    float acc[M_TILES][N_SUB][4] = {};
    window_mma(acc, xw, wb, g, tq);
    float mx[N_SUB][2];
    window_max(acc, mx);
    const size_t row = (size_t)b * W + tile * WINDOWS + wm;
    store_pooled(out + row * F, bias, mx, n0 + wn * 32, g, tq, slope);
  }
  cp_async_wait<0>();  // no copy outlives the block (the tail groups are empty)
}

}  // namespace

extern "C" int sgb_contract_pool_dma_launch(const void* h, const void* wt, const void* bias,
                                            void* out, int B, int L, int F, float slope,
                                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(sgb_contract_pool_dma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  if (B > 65535) return cudaErrorInvalidValue;  // one grid row per waveform
  dim3 grid(F / N_TILE, B);
  sgb_contract_pool_dma_kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)h, (const __nv_bfloat16*)wt, (const float*)bias,
      (__nv_bfloat16*)out, L, F, slope);
  return cudaGetLastError();
}
