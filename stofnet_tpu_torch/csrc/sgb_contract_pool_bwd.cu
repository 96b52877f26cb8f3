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
// many inputs for dkernel, 8.4 GFLOP in all, against about 314 MB that must
// move. Bound on the H100: bytes, 314 MB at 3.35 TB/s (0.094 ms), with
// dkernel's bf16 x bf16 products counted at the tensor cores' rate. This
// design runs every product in f32 on the CUDA cores: its floor is 8.4 GFLOP
// at 67 TFLOP/s (0.125 ms). The (B, L, F) plane never exists.
//
// Design: gather/scatter on the CUDA cores, three kernels on one stream, no
// float atomics and a fixed order of every sum, so two runs on the same
// inputs give the same bits. The wrapper plans the split of the windows
// (ops/kernels/sgb.py:bwd_plan) and hands it over as window bounds.
//  1. dh: a CTA of 32 warps owns a run of up to 8 consecutive windows (b, r
//     flattened) and every row of them: warp (k, h) owns rows 5k..5k+4 of
//     the run's windows 4h..4h+3, two channels a lane, 40 f32 accumulators a
//     thread. The f32 weight [f][t][c] (655 KB) streams through a 4-slot
//     ring of 32-channel chunks (40 KB, one cp.async.bulk on an mbarrier a
//     slot; thread 0 refills a slot once every warp has released it), so a
//     run reads the weight once from L2: 1.05 GB in all at B=128, L=8000,
//     where a CTA per window read 8.4 GB. Before the chunks, the CTA lays
//     the run's offsets (u8) and g_pre (f32), and its two neighbours', in
//     shared memory for a block of 512 channels, and one warp per (window,
//     chunk) ballots which of the chunk's 32 channels reach each row group
//     (positions within 2 rows of it) and which of the neighbours' reach
//     rows 0-1 (offsets 78-79 of the window to the left) and 78-79 (0-1 of
//     the window to the right). A warp then walks its masks' set bits and,
//     for each tap that lands on one of its rows, adds g_pre * w[f][t][c]
//     from the ring. A row's terms are added in a fixed order (chunks
//     ascending; in each, the own window, the left, the right), and no two
//     warps or CTAs write one row.
//  2. dkernel: a CTA owns 128 output channels (a thread: one channel, 16 of
//     the 64 input channels, 5 taps, 80 f32 accumulators) and a group of
//     consecutive windows, one CTA an SM. It walks its windows through an
//     8-slot ring, each slot one window: its 84 input rows (2-row halos)
//     by one 3-D TMA copy in the 128-byte swizzle (rows outside [0, L)
//     arrive as zeros), and the window's offsets, g and pooled for the
//     CTA's channels by three bulk copies, all on one full mbarrier; each
//     warp releases a slot on an empty mbarrier, and thread 0 refills the
//     slot of the window before once every warp has released it. So a
//     window costs no __syncthreads and is staged once for 128 channels (4
//     times for 512, where the first design staged it 8 times and
//     synchronised twice a window); a thread adds bf16(g_pre) * h into its
//     80 sums and sums g_pre for dbias. Each CTA writes its partial sums
//     (33 groups at F=512 on 132 SMs).
//  3. reduce: the partials of the groups are summed in group order.
//
// What holds it at B=128, L=8000, F=512 (PERF.md): both passes read their
// operands from shared memory once a product (dh 8.4 GB of weight rows,
// dkernel 4.2 GB of input rows), some 0.3 ms and 0.15 ms of the SM's
// shared-memory rate, and each selected position costs a warp a chain of
// dependent loads; measured variants with the weight in padded rows, two
// positions in flight or 20 warps of 4 rows ran slower.

#include <cuda.h>

#include "hopper.cuh"

namespace {

constexpr int C = 64;          // input channels
constexpr int K = 5;           // taps
constexpr int PAD = K / 2;     // SAME padding of a k5 conv
constexpr int POOL = 80;       // pool window
constexpr int ROW = C * 2;     // bytes of an input row, 128

// dh pass
constexpr int DH_RUN = 8;                          // windows of a CTA's run
constexpr int DH_GROUP_ROWS = 5;                   // rows of a row group
constexpr int DH_GROUPS = POOL / DH_GROUP_ROWS;    // 16 row groups a window
constexpr int DH_HALVES = 2;                       // window halves of a run
constexpr int DH_WPW = DH_RUN / DH_HALVES;         // windows a warp, 4
constexpr int DH_WARPS = DH_GROUPS * DH_HALVES;    // 32
constexpr int DH_THREADS = DH_WARPS * 32;
constexpr int FC = 32;                             // output channels of a chunk
constexpr int CHUNK = FC * K * C;                  // f32 of a chunk
constexpr int DH_STAGES = 4;
constexpr int FB = 512;                            // channels of a table block
constexpr int TW = DH_RUN + 2;                     // windows of the tables
constexpr int MASKS = DH_GROUPS + 2;               // masks of a (window, chunk)
constexpr int RING_BYTES = DH_STAGES * CHUNK * 4;  // 163,840
constexpr int DH_SMEM = RING_BYTES + 2 * DH_STAGES * 8 + TW * FB * 5 +
                        DH_RUN * (FB / FC) * MASKS * 4;  // 198,720

// dkernel pass
constexpr int FT = 128;                            // output channels of a CTA
constexpr int DW_THREADS = 512;                    // 128 channels x 4 quarters
constexpr int DW_WARPS = DW_THREADS / 32;
constexpr int CQ = C / 4;                          // input channels a thread, 16
constexpr int ROWS = POOL + 2 * PAD;               // input rows of a window, 84
constexpr int H_BYTES = ROWS * ROW;                // 10,752
constexpr int OFF_AT = 11 * 1024;                  // the slot's offsets
constexpr int G_AT = OFF_AT + FT * 4;              // its g
constexpr int P_AT = G_AT + FT * 2;                // its pooled
constexpr int SLOT = P_AT + FT * 2;                // 12,288, 1,024-byte steps
constexpr int DW_STAGES = 8;
constexpr int DW_SMEM = 1024 + DW_STAGES * SLOT + 2 * DW_STAGES * 8;  // 99,456
constexpr int RED_THREADS = 256;

__device__ __forceinline__ float g_pre(__nv_bfloat16 g, __nv_bfloat16 pooled,
                                       float slope) {
  const float gv = __bfloat162float(g);
  return __bfloat162float(pooled) >= 0.f ? gv : slope * gv;
}

__global__ void __launch_bounds__(DH_THREADS, 1)
sgb_bwd_dh_kernel(const float* __restrict__ w_ftc,          // (F, 5, 64) f32
                  const __nv_bfloat16* __restrict__ g,       // (B, R, F)
                  const __nv_bfloat16* __restrict__ pooled,  // (B, R, F)
                  const int* __restrict__ off,               // (B, R, F)
                  const int* __restrict__ runs,              // (n_runs + 1,) window bounds
                  __nv_bfloat16* __restrict__ dh,            // (B, L, 64)
                  int R, int F, float slope) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + RING_BYTES);
  uint64_t* empty = full + DH_STAGES;
  // the tables of a block of FB channels: windows w0 - 1 .. w0 + 8 (the run
  // and its two neighbours) as rows 0..9
  float* s_gp = reinterpret_cast<float*>(empty + DH_STAGES);              // [TW][FB] g_pre
  unsigned char* s_p = reinterpret_cast<unsigned char*>(s_gp + TW * FB);  // [TW][FB] offsets
  unsigned* s_m = reinterpret_cast<unsigned*>(s_p + TW * FB);  // [DH_RUN][FB / FC][MASKS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int w0 = runs[blockIdx.x], w1 = runs[blockIdx.x + 1], total = runs[gridDim.x];
  // this warp: rows j0..j0+4 of the run's windows ww0..ww0+3, channels
  // 2 lane, 2 lane + 1
  const int grp = warp % DH_GROUPS, j0 = grp * DH_GROUP_ROWS;
  const int ww0 = (warp / DH_GROUPS) * DH_WPW;
  const int n_chunks = F / FC;

  if (tid == 0) {
    for (int s = 0; s < DH_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], DH_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int ci = 0; ci < DH_STAGES && ci < n_chunks; ++ci)
      bulk_load(ring + ci * CHUNK, w_ftc + (size_t)ci * CHUNK, CHUNK * 4, &full[ci]);

  float2 acc[DH_WPW][DH_GROUP_ROWS];
#pragma unroll
  for (int i = 0; i < DH_WPW; ++i)
#pragma unroll
    for (int k = 0; k < DH_GROUP_ROWS; ++k) acc[i][k] = make_float2(0.f, 0.f);

  for (int fb0 = 0; fb0 < F; fb0 += FB) {
    const int nfb = F - fb0 < FB ? F - fb0 : FB, nch = nfb / FC;
    if (fb0) __syncthreads();  // every warp is done with the last block's tables
    // offsets and g_pre of the run's windows and their neighbours, once
    for (int idx = tid; idx < TW * nfb; idx += DH_THREADS) {
      const int j = idx / nfb, f = idx - j * nfb, win = w0 - 1 + j;
      unsigned char p = 0xff;
      float gp = 0.f;
      if (win >= 0 && win < total && win <= w1) {
        const size_t a = (size_t)win * F + fb0 + f;
        p = (unsigned char)off[a];
        gp = g_pre(g[a], pooled[a], slope);
      }
      s_p[j * FB + f] = p;
      s_gp[j * FB + f] = gp;
    }
    __syncthreads();
    // for each (window, chunk): which of its 32 channels reach each row
    // group (positions within 2 rows of it), and which of the neighbours'
    // channels reach rows 0-1 (left, offsets 78-79) and 78-79 (right, 0-1)
    for (int task = warp; task < DH_RUN * nch; task += DH_WARPS) {
      const int i = task / nch, c = task - i * nch, win = w0 + i;
      if (win >= w1) continue;
      const int r = win % R;
      const int p = s_p[(i + 1) * FB + c * FC + lane];
      unsigned* m = s_m + (i * (FB / FC) + c) * MASKS;
#pragma unroll
      for (int k = 0; k < DH_GROUPS; ++k) {
        const int lo = k * DH_GROUP_ROWS - PAD;
        const unsigned b = __ballot_sync(0xffffffffu, p >= lo && p < lo + DH_GROUP_ROWS + 2 * PAD);
        if (lane == 0) m[k] = b;
      }
      const int pl = s_p[i * FB + c * FC + lane], pr = s_p[(i + 2) * FB + c * FC + lane];
      const unsigned bl = __ballot_sync(0xffffffffu, r > 0 && pl >= POOL - PAD && pl < POOL);
      const unsigned br = __ballot_sync(0xffffffffu, r < R - 1 && pr < PAD);
      if (lane == 0) {
        m[DH_GROUPS] = bl;
        m[DH_GROUPS + 1] = br;
      }
    }
    __syncthreads();

    for (int c = 0; c < nch; ++c) {
      const int ci = fb0 / FC + c, s = ci % DH_STAGES;
      mbar_wait(&full[s], (ci / DH_STAGES) & 1);
      const float* wc = ring + s * CHUNK + 2 * lane;
#pragma unroll
      for (int i = 0; i < DH_WPW; ++i) {
        const int wi = ww0 + i;
        if (w0 + wi >= w1) continue;
        const unsigned* m = s_m + (wi * (FB / FC) + c) * MASKS;
        // a fixed order: the own window's positions, the left's, the right's
#pragma unroll
        for (int side = 0; side < 3; ++side) {
          unsigned mask = side == 0 ? m[grp]
                          : side == 1 ? (grp == 0 ? m[DH_GROUPS] : 0u)
                                      : (grp == DH_GROUPS - 1 ? m[DH_GROUPS + 1] : 0u);
          const int j = wi + (side == 0 ? 1 : side == 1 ? 0 : 2);
          const int shift = side == 0 ? 0 : side == 1 ? -POOL : POOL;
          const unsigned char* sp = s_p + j * FB + c * FC;
          const float* sg = s_gp + j * FB + c * FC;
          while (mask) {
            const int src = __ffs(mask) - 1;
            mask &= mask - 1;
            const int p = sp[src] + shift;
            const float gs = sg[src];
            const float* wf = wc + src * (K * C);
            // tap t = j - p + 2 lands on row j of this warp's
#pragma unroll
            for (int k = 0; k < DH_GROUP_ROWS; ++k) {
              const int t = j0 + k - p + PAD;
              if (t >= 0 && t < K) {
                const float2 wv = *reinterpret_cast<const float2*>(wf + t * C);
                acc[i][k].x = fmaf(gs, wv.x, acc[i][k].x);
                acc[i][k].y = fmaf(gs, wv.y, acc[i][k].y);
              }
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      // refill the slot of the chunk before, once every warp has released it
      if (tid == 0 && ci >= 1 && ci - 1 + DH_STAGES < n_chunks) {
        const int j = ci - 1, sj = j % DH_STAGES;
        mbar_wait(&empty[sj], (j / DH_STAGES) & 1);
        bulk_load(ring + sj * CHUNK, w_ftc + (size_t)(j + DH_STAGES) * CHUNK, CHUNK * 4,
                  &full[sj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < DH_WPW; ++i) {
    const int win = w0 + ww0 + i;
    if (win < w1)
#pragma unroll
      for (int k = 0; k < DH_GROUP_ROWS; ++k)
        *reinterpret_cast<__nv_bfloat162*>(dh + ((size_t)win * POOL + j0 + k) * C + 2 * lane) =
            __floats2bfloat162_rn(acc[i][k].x, acc[i][k].y);
  }
}

__global__ void __launch_bounds__(DW_THREADS, 1)
sgb_bwd_dw_kernel(const __grid_constant__ CUtensorMap hmap,  // h as (64, L, B)
                  const __nv_bfloat16* __restrict__ g,       // (B, R, F)
                  const __nv_bfloat16* __restrict__ pooled,  // (B, R, F)
                  const int* __restrict__ off,               // (B, R, F)
                  const int* __restrict__ groups,            // (G + 1,) window bounds
                  float* __restrict__ part_w,                // (G, 5, 64, F)
                  float* __restrict__ part_b,                // (G, F)
                  int R, int F, float slope) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzled input rows on 1,024-byte boundaries: the 128-byte swizzle
  // is laid on absolute shared addresses
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + DW_STAGES * SLOT);
  uint64_t* empty = full + DW_STAGES;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int fl = warp * 8 + (lane >> 2), cq = lane & 3;  // channel, input quarter
  const int f0 = blockIdx.x * FT;
  const int nf = F - f0 < FT ? F - f0 : FT;
  const bool active = fl < nf;
  const int grp = blockIdx.y;
  const int wb = groups[grp], n = groups[grp + 1] - wb;

  if (tid == 0) {
    for (int s = 0; s < DW_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], DW_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // window wb + i into slot s (thread 0)
  auto issue = [&](int i, int s) {
    const int win = wb + i, b = win / R, r = win - b * R;
    unsigned char* slot = ring + s * SLOT;
    const size_t base = (size_t)win * F + f0;
    mbar_expect_tx(&full[s], H_BYTES + nf * 8);
    tma_load_3d(slot, &hmap, 0, r * POOL - PAD, b, &full[s]);
    bulk_copy(slot + OFF_AT, off + base, nf * 4, &full[s]);
    bulk_copy(slot + G_AT, g + base, nf * 2, &full[s]);
    bulk_copy(slot + P_AT, pooled + base, nf * 2, &full[s]);
  };
  if (tid == 0)
    for (int i = 0; i < DW_STAGES && i < n; ++i) issue(i, i);

  float acc[K][CQ];
#pragma unroll
  for (int t = 0; t < K; ++t)
#pragma unroll
    for (int k = 0; k < CQ; ++k) acc[t][k] = 0.f;
  float bsum = 0.f;

  for (int i = 0; i < n; ++i) {
    const int s = i % DW_STAGES;
    mbar_wait(&full[s], (i / DW_STAGES) & 1);
    const unsigned char* slot = ring + s * SLOT;
    if (active) {
      const int o = reinterpret_cast<const int*>(slot + OFF_AT)[fl];
      const float gp = g_pre(reinterpret_cast<const __nv_bfloat16*>(slot + G_AT)[fl],
                             reinterpret_cast<const __nv_bfloat16*>(slot + P_AT)[fl], slope);
      bsum += gp;
      const float gb = __bfloat162float(__float2bfloat16_rn(gp));
#pragma unroll
      for (int t = 0; t < K; ++t) {
        const int row = o + t;  // staged row o + t is position pos + t - 2
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int chunk = (2 * cq + j) ^ (row & 7);
          const uint4 raw = *reinterpret_cast<const uint4*>(slot + row * ROW + chunk * 16);
          const __nv_bfloat162* hv = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 x = __bfloat1622float2(hv[e]);
            acc[t][8 * j + 2 * e] = fmaf(gb, x.x, acc[t][8 * j + 2 * e]);
            acc[t][8 * j + 2 * e + 1] = fmaf(gb, x.y, acc[t][8 * j + 2 * e + 1]);
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    // refill the slot of the window before, once every warp has released it
    if (tid == 0 && i >= 1 && i - 1 + DW_STAGES < n) {
      const int j = i - 1, sj = j % DW_STAGES;
      mbar_wait(&empty[sj], (j / DW_STAGES) & 1);
      issue(j + DW_STAGES, sj);
    }
  }

  if (active) {
    const int f = f0 + fl;
    float* pw = part_w + (size_t)grp * K * C * F;
#pragma unroll
    for (int t = 0; t < K; ++t)
#pragma unroll
      for (int k = 0; k < CQ; ++k) pw[((size_t)t * C + cq * CQ + k) * F + f] = acc[t][k];
    if (cq == 0) part_b[(size_t)grp * F + f] = bsum;
  }
}

// dkernel and dbias: the groups' partial sums added in group order
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

// all three passes on ``stream``. plan holds the dh pass's run bounds
// (n_runs + 1 window indices) and then the dkernel pass's group bounds
// (groups + 1); part_w (groups, 5, 64, F) and part_b (groups, F) are f32
// scratch. Needs L % 80 == 0, F % 64 == 0 and B * L / 80 < 2^31.
extern "C" int sgb_contract_pool_bwd_launch(const void* h, const void* w_ftc, const void* g,
                                            const void* pooled, const void* off, void* dh,
                                            void* dkernel, void* dbias, void* part_w,
                                            void* part_b, const void* plan, int n_runs,
                                            int groups, int B, int L, int F, float slope,
                                            int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  if (L % POOL || F % (2 * FC) || n_runs < 1 || groups < 1) return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int R = L / POOL;
  const int* runs = (const int*)plan;

  err = cudaFuncSetAttribute(sgb_bwd_dh_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DH_SMEM);
  if (err != cudaSuccess) return err;
  sgb_bwd_dh_kernel<<<n_runs, DH_THREADS, DH_SMEM, st>>>(
      (const float*)w_ftc, (const __nv_bfloat16*)g, (const __nv_bfloat16*)pooled,
      (const int*)off, runs, (__nv_bfloat16*)dh, R, F, slope);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  EncodeTiled encode;
  err = encode_tiled(&encode);
  if (err != cudaSuccess) return err;
  // h as a (64, L, B) tensor of bf16; a box of 64 x 84 x 1 is one window
  CUtensorMap map;
  const cuuint64_t dims[3] = {C, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[2] = {ROW, (cuuint64_t)L * ROW};  // bytes, dims 1 and 2
  const cuuint32_t box[3] = {C, ROWS, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(h), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(sgb_bwd_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DW_SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((F + FT - 1) / FT, groups);
  sgb_bwd_dw_kernel<<<grid, DW_THREADS, DW_SMEM, st>>>(
      map, (const __nv_bfloat16*)g, (const __nv_bfloat16*)pooled, (const int*)off,
      runs + n_runs + 1, (float*)part_w, (float*)part_b, R, F, slope);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int n_w = K * C * F;
  sgb_bwd_reduce_kernel<<<(n_w + F + RED_THREADS - 1) / RED_THREADS, RED_THREADS, 0, st>>>(
      (const float*)part_w, (const float*)part_b, (float*)dkernel, (float*)dbias, n_w, F,
      groups);
  return cudaGetLastError();
}
