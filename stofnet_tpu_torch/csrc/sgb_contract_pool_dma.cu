// SemiGlobalBlock contract path with the input streamed through a copy ring:
// leaky(maxpool80(conv1d_same_k5(h, w) + b)), and kernel A, the same
// contraction with the argmax of each window (template flag ARGMAX).
//
// Serving (ARGMAX false) replaces both TPU kernels of this function, at
// every L % 80 == 0: stofnet_tpu/ops/pallas/sgb_kernel.py: sgb_contract_pool
// (_kernel, pallas_call at :163) and stofnet_tpu/ops/pallas/sgb_dma_kernel.py:
// sgb_contract_pool_dma (_kernel, pallas_call at :189), whose point is an
// explicit double-buffered copy of the input from device memory
// (pltpu.make_async_copy with semaphores); the JAX package takes the second
// only where L % 800 == 0, a TPU tiling. h (B, L, 64) bf16, weights bf16 in
// the image of ops/kernels/sgb.py:sgb_dma_weights, bias (F,) f32 -> out
// (B, L/80, F) bf16: f32 sums, the bias added after the window max (exact:
// rounding is monotone), leaky after the pool, one rounding to bf16.
//
// Kernel A (ARGMAX true), the forward of the trainable op, replaces
// _run(with_argmax=True) of stofnet_tpu/ops/pallas/sgb_kernel.py (_kernel,
// pallas_call at :163, reached from sgb_contract_pool_trainable's
// _trainable_fwd). Same inputs with every L % 80 == 0, plus int32 offsets
// (B, L/80, F): the window-relative position (0..79) of the first maximal
// element of y = bias + sum of taps in f32, the bias in before the max as
// the JAX kernel's y (the accumulator starts at it); pooled = bf16(leaky(max
// of y)).
//
// Bound on the H100, both: operations. At B=128, L=8000, F=512 the direct
// conv is 3.36e11 FLOP (0.339 ms at 989 TFLOP/s bf16), against 131 MB read
// and 13 MB written (0.04 ms at 3.35 TB/s); kernel A writes 26 MB of
// offsets besides (0.05 ms of bytes in all).
//
// Design: the conv stack's wgmma recipe (conv_stack.cu) with its roles.
// - One CTA per (waveform, 128-channel slice), as the TPU grid gives one
//   program per waveform, numbered along x (no 65,535 limit on B): 512
//   CTAs at B=128, F=512, one an SM (shared memory), 3.9 waves over 132
//   SMs. Two consumer warpgroups own 64 output channels each; a ninth warp
//   issues the copies.
// - The product of a tile of two pool windows (160 positions): D (64
//   channels x 160 positions, 80 f32 accumulators a thread) = A (a tap
//   block's 64 channels x 16 input channels) x B (16 input channels x 160
//   positions), wgmma.m64n160k16, 5 taps x 4 k-steps in one commit group.
//   B is read through a descriptor on the staged input, 128-byte rows (64
//   bf16, one position each) in the 128-byte swizzle, starting at row t for
//   tap t and stepped along K by 32 bytes (rows_desc): output position p
//   reads input p + t - 2, and no im2col copy is made.
// - The weights: the CTA's slice lives in shared memory for its life as
//   2 halves x 5 taps of 64 x 64 swizzled blocks (80 KB), laid out once on
//   the host (sgb_dma_weights) and brought in by ten 1-D bulk copies on one
//   mbarrier. A comes through a descriptor on its tap block too (both
//   operands from shared memory): no thread loads a weight, and the 20
//   products of a tile go out as one commit group with no wait between
//   taps. The whole 64 x 320 slice of a warpgroup as register fragments
//   (80 registers a thread) took ptxas to 168 registers with spills and
//   serialized wgmma (C7512), and ran slower (PERF.md).
// - The input ring: STAGES slots of 164 rows (160 positions and the 2-row
//   halo on each side, not duplicated between the two windows), each filled
//   by one 3-D TMA copy over the (64, L, B) tensor in the 128-byte swizzle;
//   rows at -2, -1 and >= L are outside the tensor and arrive as zeros, the
//   SAME conv's padding. A waveform takes ceil(W / 2) tiles of W = L / 80
//   windows: where W is odd, the last tile's second window lies past L, its
//   rows arrive as zeros (the first window's right halo), and it is
//   computed but not stored (the masked last tile). A full barrier a slot
//   (the copy's bytes) and an empty barrier a slot (one arrival a
//   warpgroup once its wgmma are done) let the two warpgroups run a tile
//   apart, so one's epilogue overlaps the other's products. The copy warp
//   needs no registers to speak of: nine warps leave each thread up to 224
//   (the conv stack's 17th warp capped its 512 threads at 96).
// - The pooled epilogue in registers: for window w a thread holds the n8
//   groups 10w..10w+9, two columns each, on rows g and g+8 of its warp's
//   16; it takes the max of its 20 values per row, then across the quad
//   (shuffles xor 1, 2); the lane whose column pair is 2w + m adds the bias
//   to row g + 8m, applies leaky and stores one bf16. No pre-pool value
//   leaves the registers.
// - Kernel A's (value, position) epilogue: the same walk keeps the
//   position too, j over 10w..10w+9 then e, so a strict > keeps the lower
//   of equal values; across the quad (shuffles xor 1, 2 of the pair) equal
//   values go to the lower position. The lane with tq == 2w + m stores
//   bf16(leaky(max)) and the offset. Halo rows are input rows only, never
//   candidates, as in the JAX kernel.
// Shared memory: 80 KB of weights + 4 x 21 KB stages + barriers, 169,032 B
// with the 1,024 B that align the swizzled buffers.
//
// This replaces the first design of both (an mma.sync m16n8k16 mainloop
// fed with 32-bit shared loads: 23 FLOP a byte of shared memory, no copy
// pipeline, 84 rows staged a window): a k16 step of
// a warpgroup here reads 2 KB of A and 5 KB of B for 327 kFLOP, 47 FLOP a
// byte, within the SM's shared-memory rate at the tensor cores' peak. What
// is left above the bound is the tail of the last of the 3.9 waves and each
// tile's epilogue, which the other warpgroup's products cover: kernel A's
// (value, position) epilogue and offset stores cost it 0.024 ms over the
// serving instantiation at B=128, L=8000 (PERF.md).

#include "hopper.cuh"

namespace {

constexpr int C = 64;                 // input channels
constexpr int K = 5;                  // taps
constexpr int PAD = K / 2;            // SAME padding of a k5 conv
constexpr int POOL = 80;              // pool window
constexpr int WINDOWS = 2;            // pool windows of a tile
constexpr int NP = WINDOWS * POOL;    // positions of a tile, wgmma N = 160
constexpr int N_SUB = NP / 8;         // n8 groups of an accumulator, 20
constexpr int ROWS = NP + K - 1;      // staged input rows of a tile, 164
constexpr int ROW = C * 2;            // bytes of an input row, 128
constexpr int N_TILE = 128;           // output channels of a CTA
constexpr int GROUP = 64;             // output channels of a warpgroup
constexpr int HALVES = N_TILE / GROUP;
constexpr int THREADS = 32 * (4 * HALVES + 1);  // two warpgroups, the copy warp
constexpr int COPY_WARP = 4 * HALVES;
constexpr int STAGES = 4;             // input ring slots
constexpr int TAP_BYTES = GROUP * C * 2;                  // 8,192
constexpr int SMEM_W = HALVES * K * TAP_BYTES;            // 81,920
constexpr int STAGE_BYTES = ROWS * ROW;                   // 20,992
constexpr int STAGE_STRIDE = (STAGE_BYTES + 1023) / 1024 * 1024;  // 21,504
constexpr int SMEM_BAR = (2 * STAGES + 1) * 8;
constexpr int SMEM = 1024 + SMEM_W + STAGES * STAGE_STRIDE + SMEM_BAR;  // 169,032

// rows [p, p + ROWS) of waveform b, all 64 channels, into `dst` (1,024-byte
// aligned) in the 128-byte swizzle by one TMA copy counted on `bar`; rows
// outside [0, L) arrive as zeros
__device__ __forceinline__ void tma_rows(void* dst, const CUtensorMap* map, int p,
                                         int b, uint64_t* bar) {
  mbar_expect_tx(bar, STAGE_BYTES);
  tma_load_3d(dst, map, 0, p, b, bar);
}

// d (64 output channels x 160 positions, f32) += a (64 x 16 bf16 of a tap
// block, through its descriptor) * b (16 channels x 160 positions, the
// descriptor's rows)
__device__ __forceinline__ void wgmma_ss(float (&d)[80], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, %80, %81, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79])
      : "l"(a), "l"(b), "r"(1));
}

template <bool ARGMAX>
__global__ void __launch_bounds__(THREADS, 1)
sgb_contract_pool_dma_kernel(const __grid_constant__ CUtensorMap hmap,  // h as (64, L, B)
                             const __nv_bfloat16* __restrict__ wimg,  // (F/64, 5, 64 x 64)
                             const float* __restrict__ bias,          // (F,)
                             __nv_bfloat16* __restrict__ out,         // (B, L/80, F)
                             int* __restrict__ offs,  // (B, L/80, F), ARGMAX only
                             int L, int F, float slope) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzled buffers on 1,024-byte boundaries: the 128-byte swizzle is
  // laid on absolute shared addresses
  unsigned char* ws = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* xs = ws + SMEM_W;
  uint64_t* full = reinterpret_cast<uint64_t*>(xs + STAGES * STAGE_STRIDE);
  uint64_t* empty = full + STAGES;
  uint64_t* wbar = empty + STAGES;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_slices = F / N_TILE;
  const int slice = blockIdx.x % n_slices, b = blockIdx.x / n_slices;
  const int W = L / POOL;
  const int n_tiles = (W + WINDOWS - 1) / WINDOWS;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], HALVES);
    }
    mbar_init(wbar, HALVES * K);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == COPY_WARP) {
    // the weight slice, then the input tiles, slot s refilled once both
    // warpgroups have released it
    if (lane == 0) {
      const __nv_bfloat16* wsrc = wimg + (size_t)slice * (SMEM_W / 2);
      for (int i = 0; i < HALVES * K; ++i)
        bulk_load(ws + i * TAP_BYTES, wsrc + i * (TAP_BYTES / 2), TAP_BYTES, wbar);
      for (int tile = 0; tile < n_tiles; ++tile) {
        const int s = tile % STAGES;
        if (tile >= STAGES) mbar_wait(&empty[s], (tile / STAGES - 1) & 1);
        tma_rows(xs + s * STAGE_STRIDE, &hmap, tile * NP - PAD, b, &full[s]);
      }
    }
    return;
  }

  // warpgroup wg computes output channels [64 wg, 64 wg + 64) of the
  // slice; its warp wq the rows [16 wq, 16 wq + 16), the accumulator's
  // layout: d[4j + 2m + e] is channel g + 8m, position 8j + 2tq + e
  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, tq = lane & 3;
  const int ch = slice * N_TILE + wg * GROUP + wq * 16 + g;
  const float bias0 = bias[ch], bias1 = bias[ch + 8];
  const uint32_t w0 = smem_u32(ws + wg * K * TAP_BYTES), x0 = smem_u32(xs);

  mbar_wait(wbar, 0);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int s = tile % STAGES;
    mbar_wait(&full[s], (tile / STAGES) & 1);
    float acc[4 * N_SUB];
    // ARGMAX: y = bias + taps, the value the JAX kernel takes the argmax of
#pragma unroll
    for (int i = 0; i < 4 * N_SUB; ++i) acc[i] = ARGMAX ? ((i & 2) ? bias1 : bias0) : 0.f;
    acc_fence(acc);
    wg_fence();
    const uint32_t xb = x0 + s * STAGE_STRIDE;
#pragma unroll
    for (int t = 0; t < K; ++t) {
      const uint64_t bd = rows_desc(xb, t);
      const uint64_t ad = rows_desc(w0 + t * TAP_BYTES, 0);
#pragma unroll
      for (int k = 0; k < C / 16; ++k) wgmma_ss(acc, ad + 2 * k, bd + 2 * k);
    }
    wg_commit();
    wg_wait_all();
    acc_fence(acc);
    if ((tid & 127) == 0) mbar_arrive(&empty[s]);

    const size_t row0 = (size_t)b * W + tile * WINDOWS;
#pragma unroll
    for (int w = 0; w < WINDOWS; ++w)
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        constexpr int J = N_SUB / WINDOWS;
        // the masked last tile: a second window past L is not stored
        const bool store = tq == 2 * w + m && tile * WINDOWS + w < W;
        const size_t o = (row0 + w) * F + ch + 8 * m;
        if constexpr (ARGMAX) {
          // (value, position) in increasing position order: the thread's
          // candidates are 8 (j - J w) + 2 tq + e, kept as k = that - 2 tq
          float mx = acc[4 * J * w + 2 * m];
          int k = 0;
#pragma unroll
          for (int j = J * w; j < J * (w + 1); ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if ((j > J * w || e > 0) && acc[4 * j + 2 * m + e] > mx) {
                mx = acc[4 * j + 2 * m + e];
                k = 8 * (j - J * w) + e;
              }
          int pos = k + 2 * tq;
#pragma unroll
          for (int x = 1; x <= 2; x <<= 1) {
            const float om = __shfl_xor_sync(0xffffffffu, mx, x);
            const int op = __shfl_xor_sync(0xffffffffu, pos, x);
            if (om > mx || (om == mx && op < pos)) {
              mx = om;
              pos = op;
            }
          }
          if (store) {
            out[o] = __float2bfloat16_rn(mx >= 0.f ? mx : slope * mx);  // bias in already
            offs[o] = pos;
          }
        } else {
          float mx = fmaxf(acc[4 * J * w + 2 * m], acc[4 * J * w + 2 * m + 1]);
#pragma unroll
          for (int j = J * w + 1; j < J * (w + 1); ++j)
            mx = fmaxf(mx, fmaxf(acc[4 * j + 2 * m], acc[4 * j + 2 * m + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          if (store) {
            float v = mx + (m ? bias1 : bias0);
            v = v >= 0.f ? v : slope * v;
            out[o] = __float2bfloat16_rn(v);
          }
        }
      }
  }
}

template <bool ARGMAX>
int launch(const void* h, const void* wimg, const void* bias, void* out, void* offs,
           int B, int L, int F, float slope, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(sgb_contract_pool_dma_kernel<ARGMAX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  const long long ctas = (long long)B * (F / N_TILE);  // one a (waveform, slice)
  if (ctas < 1 || ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  EncodeTiled encode;
  err = encode_tiled(&encode);
  if (err != cudaSuccess) return err;
  // h as a (64, L, B) tensor of bf16; a box of 64 x ROWS x 1 is one stage
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
  sgb_contract_pool_dma_kernel<ARGMAX><<<(unsigned)ctas, THREADS, SMEM, (cudaStream_t)stream>>>(
      map, (const __nv_bfloat16*)wimg, (const float*)bias, (__nv_bfloat16*)out, (int*)offs, L,
      F, slope);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sgb_contract_pool_dma_launch(const void* h, const void* wimg, const void* bias,
                                            void* out, int B, int L, int F, float slope,
                                            int device, void* stream) {
  return launch<false>(h, wimg, bias, out, nullptr, B, L, F, slope, device, stream);
}

// kernel A: pooled output and the int32 offsets (B, L/80, F) of the first
// maximal element of each window of bias + conv
extern "C" int sgb_contract_pool_argmax_launch(const void* h, const void* wimg,
                                               const void* bias, void* out, void* offs,
                                               int B, int L, int F, float slope,
                                               int device, void* stream) {
  return launch<true>(h, wimg, bias, out, offs, B, L, F, slope, device, stream);
}
