// Backward of the fused SemiGlobalBlock contract path (kernel B).
//
// Replaces the backward of stofnet_tpu/ops/pallas/sgb_kernel.py:
// sgb_contract_pool_trainable (_trainable_bwd), which JAX runs as XLA: a scan
// over chunks of 8 output channels, each through a dense (B, L, 8) plane.
// Given the cotangent g of the pooled output (B, R, F) bf16 (R = L/80), the
// pooled output, kernel A's int32 window offsets and the f32 master weight w,
// with pos = offset + 80 r the selected position of each (b, r, f):
//
//   g_pre[b,r,f]   = pooled >= 0 ? g : slope * g                  (f32)
//   dbias[f]       = sum_{b,r} g_pre[b,r,f]                       (f32)
//   dkernel[t,c,f] = sum_{b,r} bf16(g_pre[b,r,f]) * h[b, pos+t-2, c]   (f32 sums)
//   dh[b,q,c]      = sum_{r,f,t: pos+t-2 = q} g_pre[b,r,f] * w[t,c,f]  (f32, then bf16)
//
// the rounding points of the JAX backward. Exactly one position per
// (b, window, channel) is selected, so the work is sparse: at B=128, L=8000,
// F=512 about 6.5 M positions, each touching 5 x 64 weights for dh and as
// many inputs for dkernel, 8.4 GFLOP in all. Bound on the H100: operations,
// 8.4 GFLOP at 67 TFLOP/s f32 on the CUDA cores (0.125 ms), against about
// 315 MB moved (0.094 ms at 3.35 TB/s). The (B, L, F) plane never exists.
//
// Design: gather/scatter on the CUDA cores in f32, three passes on one
// stream, no atomics, so two runs on the same inputs give the same bits.
//  1. dh: one CTA per window owns that window's 80 dh rows (8 warps x 10
//     rows, two channels a lane, f32 in registers). A warp scans the window's
//     512 offsets (a ballot per 32 channels) for positions within 2 rows of
//     its own and adds g_pre * w[f][t][c] for each tap that lands on one of
//     its rows. Rows 0-1 and 78-79 also take the positions 78-79 of the
//     window to the left and 0-1 of the window to the right, which only the
//     first and last warp scan. A row's terms are added in a fixed order (left
//     window, own, right; channels ascending), so no two CTAs write one row.
//     w is read as [f][t][c] f32 (655 KB, from L2) so a tap's 64 channels are
//     one coalesced row.
//  2. dkernel: CTA (channel tile of 64, window group) walks its group's
//     windows in order, stages each window's 84 input rows (2-row zero halos
//     outside [0, L)) in shared memory, and adds bf16(g_pre) * h into 80 f32
//     registers a thread (two channels x 5 taps x 8 input channels); warp 0
//     also sums g_pre for dbias. Each CTA writes its partial sums.
//  3. reduce: the partials of the window groups are summed in group order.

#include "common.cuh"

namespace {

constexpr int C = 64;          // input channels
constexpr int K = 5;           // taps
constexpr int PAD = K / 2;     // SAME padding of a k5 conv
constexpr int POOL = 80;       // pool window
constexpr int DH_WARPS = 8;
constexpr int RPW = POOL / DH_WARPS;        // dh rows per warp, 10
constexpr int FT = 64;                      // dkernel pass: channels per CTA
constexpr int ROWS = POOL + 2 * PAD;        // input rows per window, 84
constexpr int IN_STRIDE = C + 8;            // bf16 per staged row (bank spread)
constexpr int DW_THREADS = 256;             // 8 warps x 8 input channels
constexpr int RED_THREADS = 256;

__device__ __forceinline__ float g_pre(__nv_bfloat16 g, __nv_bfloat16 pooled,
                                       float slope) {
  const float gv = __bfloat162float(g);
  return __bfloat162float(pooled) >= 0.f ? gv : slope * gv;
}

// the terms of the position p (window-relative, -2..81) of channel f on this
// warp's rows j0..j0+9: tap t = j - p + 2 lands on row j
__device__ __forceinline__ void add_position(float2 (&acc)[RPW],
                                             const float* __restrict__ w_ftc,
                                             int f, float gs, int p, int j0, int lane) {
  const float* wf = w_ftc + (size_t)f * (K * C) + 2 * lane;
#pragma unroll
  for (int k = 0; k < RPW; ++k) {
    const int t = j0 + k - p + PAD;
    if (t >= 0 && t < K) {
      const float2 wv = *reinterpret_cast<const float2*>(wf + t * C);
      acc[k].x = fmaf(gs, wv.x, acc[k].x);
      acc[k].y = fmaf(gs, wv.y, acc[k].y);
    }
  }
}

// the neighbour window's positions that reach this warp's rows: its offsets
// >= 78 (left, p = offset - 80) or <= 1 (right, p = offset + 80)
__device__ __forceinline__ void add_neighbour(float2 (&acc)[RPW],
                                              const float* __restrict__ w_ftc,
                                              const __nv_bfloat16* __restrict__ g,
                                              const __nv_bfloat16* __restrict__ pooled,
                                              const int* __restrict__ off,
                                              size_t nb, int F, bool left, float slope,
                                              int j0, int lane) {
  for (int f0 = 0; f0 < F; f0 += 32) {
    const int o = off[nb + f0 + lane];
    unsigned mask = __ballot_sync(0xffffffffu, left ? o >= POOL - PAD : o < PAD);
    while (mask) {
      const int src = __ffs(mask) - 1;
      mask &= mask - 1;
      const int f = f0 + src;
      const int os = __shfl_sync(0xffffffffu, o, src);
      const float gs = g_pre(g[nb + f], pooled[nb + f], slope);
      add_position(acc, w_ftc, f, gs, left ? os - POOL : os + POOL, j0, lane);
    }
  }
}

__global__ void __launch_bounds__(DH_WARPS * 32)
sgb_bwd_dh_kernel(const float* __restrict__ w_ftc,          // (F, 5, 64) f32
                  const __nv_bfloat16* __restrict__ g,       // (B, R, F)
                  const __nv_bfloat16* __restrict__ pooled,  // (B, R, F)
                  const int* __restrict__ off,               // (B, R, F)
                  __nv_bfloat16* __restrict__ dh,            // (B, L, 64)
                  int R, int F, float slope) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_off = reinterpret_cast<int*>(smem);
  float* s_g = reinterpret_cast<float*>(smem + F * sizeof(int));

  const long long win = blockIdx.x;  // b * R + r
  const int r = (int)(win % R);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = warp * RPW;
  const size_t base = (size_t)win * F;
  for (int f = tid; f < F; f += DH_WARPS * 32) {
    s_off[f] = off[base + f];
    s_g[f] = g_pre(g[base + f], pooled[base + f], slope);
  }
  __syncthreads();

  float2 acc[RPW];
#pragma unroll
  for (int k = 0; k < RPW; ++k) acc[k] = make_float2(0.f, 0.f);

  if (warp == 0 && r > 0)
    add_neighbour(acc, w_ftc, g, pooled, off, base - F, F, true, slope, j0, lane);
  for (int f0 = 0; f0 < F; f0 += 32) {
    const int o = s_off[f0 + lane];
    unsigned mask = __ballot_sync(0xffffffffu, o >= j0 - PAD && o < j0 + RPW + PAD);
    while (mask) {
      const int src = __ffs(mask) - 1;
      mask &= mask - 1;
      const int f = f0 + src;
      add_position(acc, w_ftc, f, s_g[f], s_off[f], j0, lane);
    }
  }
  if (warp == DH_WARPS - 1 && r < R - 1)
    add_neighbour(acc, w_ftc, g, pooled, off, base + F, F, false, slope, j0, lane);

#pragma unroll
  for (int k = 0; k < RPW; ++k)
    *reinterpret_cast<__nv_bfloat162*>(dh + ((size_t)win * POOL + j0 + k) * C + 2 * lane) =
        __floats2bfloat162_rn(acc[k].x, acc[k].y);
}

__global__ void __launch_bounds__(DW_THREADS)
sgb_bwd_dw_kernel(const __nv_bfloat16* __restrict__ h,       // (B, L, 64)
                  const __nv_bfloat16* __restrict__ g,       // (B, R, F)
                  const __nv_bfloat16* __restrict__ pooled,  // (B, R, F)
                  const int* __restrict__ off,               // (B, R, F)
                  float* __restrict__ part_w,                // (G, 5, 64, F)
                  float* __restrict__ part_b,                // (G, F)
                  int L, int R, int F, long long total_windows, long long per_group,
                  float slope) {
  __shared__ __align__(16) __nv_bfloat16 xs[ROWS * IN_STRIDE];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = warp * 8;                        // this thread's 8 input channels
  const int fa = blockIdx.x * FT + lane;          // and its two output channels
  const int grp = blockIdx.y;
  const long long w_begin = grp * per_group;
  long long w_end = w_begin + per_group;
  if (w_end > total_windows) w_end = total_windows;

  float acc[2][K][8];
  float bsum[2] = {0.f, 0.f};
#pragma unroll
  for (int ff = 0; ff < 2; ++ff)
#pragma unroll
    for (int t = 0; t < K; ++t)
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[ff][t][k] = 0.f;

  for (long long win = w_begin; win < w_end; ++win) {
    const long long b = win / R;
    const int p0 = (int)(win % R) * POOL - PAD;  // position of staged row 0
    __syncthreads();  // the previous window's rows are no longer read
    for (int i = tid; i < ROWS * (C / 8); i += DW_THREADS) {
      const int row = i / (C / 8), v = i % (C / 8);
      const int p = p0 + row;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (p >= 0 && p < L)
        val = reinterpret_cast<const uint4*>(h + ((size_t)b * L + p) * C)[v];
      *reinterpret_cast<uint4*>(xs + row * IN_STRIDE + v * 8) = val;
    }
    __syncthreads();

    const size_t base = (size_t)win * F;
#pragma unroll
    for (int ff = 0; ff < 2; ++ff) {
      const int f = fa + 32 * ff;
      const int o = off[base + f];  // staged row o + t is position pos + t - 2
      const float gp = g_pre(g[base + f], pooled[base + f], slope);
      const float gb = __bfloat162float(__float2bfloat16_rn(gp));
      bsum[ff] += gp;
#pragma unroll
      for (int t = 0; t < K; ++t) {
        const uint4 raw = *reinterpret_cast<const uint4*>(xs + (o + t) * IN_STRIDE + c0);
        const __nv_bfloat162* hv = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 x = __bfloat1622float2(hv[k]);
          acc[ff][t][2 * k] = fmaf(gb, x.x, acc[ff][t][2 * k]);
          acc[ff][t][2 * k + 1] = fmaf(gb, x.y, acc[ff][t][2 * k + 1]);
        }
      }
    }
  }

  float* pw = part_w + (size_t)grp * K * C * F;
#pragma unroll
  for (int ff = 0; ff < 2; ++ff) {
    const int f = fa + 32 * ff;
#pragma unroll
    for (int t = 0; t < K; ++t)
#pragma unroll
      for (int k = 0; k < 8; ++k) pw[((size_t)t * C + c0 + k) * F + f] = acc[ff][t][k];
    if (warp == 0) part_b[(size_t)grp * F + f] = bsum[ff];
  }
}

// dkernel and dbias: the window groups' partial sums added in group order
__global__ void __launch_bounds__(RED_THREADS)
sgb_bwd_reduce_kernel(const float* __restrict__ part_w, const float* __restrict__ part_b,
                      float* __restrict__ dkernel, float* __restrict__ dbias,
                      int n_w, int F, int groups) {
  const int i = blockIdx.x * RED_THREADS + threadIdx.x;
  if (i < n_w) {
    float s = 0.f;
    for (int grp = 0; grp < groups; ++grp) s += part_w[(size_t)grp * n_w + i];
    dkernel[i] = s;
  } else if (i < n_w + F) {
    const int f = i - n_w;
    float s = 0.f;
    for (int grp = 0; grp < groups; ++grp) s += part_b[(size_t)grp * F + f];
    dbias[f] = s;
  }
}

}  // namespace

// all three passes on ``stream``; part_w (groups, 5, 64, F) and part_b
// (groups, F) are f32 scratch. Needs L % 80 == 0 and F % 64 == 0.
extern "C" int sgb_contract_pool_bwd_launch(const void* h, const void* w_ftc, const void* g,
                                            const void* pooled, const void* off, void* dh,
                                            void* dkernel, void* dbias, void* part_w,
                                            void* part_b, int B, int L, int F, int groups,
                                            float slope, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = (cudaStream_t)stream;
  const int R = L / POOL;
  const long long total_windows = (long long)B * R;
  const long long per_group = (total_windows + groups - 1) / groups;

  const size_t dh_smem = (size_t)F * (sizeof(int) + sizeof(float));
  sgb_bwd_dh_kernel<<<(unsigned)total_windows, DH_WARPS * 32, dh_smem, st>>>(
      (const float*)w_ftc, (const __nv_bfloat16*)g, (const __nv_bfloat16*)pooled,
      (const int*)off, (__nv_bfloat16*)dh, R, F, slope);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  dim3 grid(F / FT, groups);
  sgb_bwd_dw_kernel<<<grid, DW_THREADS, 0, st>>>(
      (const __nv_bfloat16*)h, (const __nv_bfloat16*)g, (const __nv_bfloat16*)pooled,
      (const int*)off, (float*)part_w, (float*)part_b, L, R, F, total_windows,
      per_group, slope);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int n_w = K * C * F;
  sgb_bwd_reduce_kernel<<<(n_w + F + RED_THREADS - 1) / RED_THREADS, RED_THREADS, 0, st>>>(
      (const float*)part_w, (const float*)part_b, (float*)dkernel, (float*)dbias, n_w, F,
      groups);
  return cudaGetLastError();
}
