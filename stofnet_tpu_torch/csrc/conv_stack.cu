// StofNet conv stack, fused: conv2..conv11 (k7, 64->64, a residual add at odd
// layers and leaky 0.01 otherwise), conv12 plus the global skip, then
// conv_last (k3, 64->r), all in one kernel.
//
// Replaces the TPU kernel stofnet_tpu/ops/pallas/conv_stack_kernel.py:
// conv_stack_fused (_run_window/_kernel). h0 (B, L, 64) bf16, weights bf16,
// biases f32 -> out (B, L, r) f32. Rounding as in the TPU kernel: f32
// accumulation; after a residual layer (res + y) rounds to bf16, after any
// other layer leaky(y) rounds to bf16.
//
// Bound on the H100: operations. At B=128, L=8000, r=4: 6.47e11 FLOP, 0.65 ms
// at 989 TFLOP/s bf16, against about 148 MB of traffic (0.04 ms at 3.35 TB/s).
// Layer by layer through device memory the stack would move 2 x 11 x 131 MB.
//
// Design: a persistent CTA of 16 warps walks over tiles of 444 positions plus a
// halo of 34 on each side (512 rows; the receptive half-width of the stack is
// 11 x 3 + 1 = 34). Every layer is an implicit GEMM over all 512 rows with
// mma.sync m16n8k16 (bf16 in, f32 accumulate): warp w owns rows [32w, 32w + 32)
// and all 64 output channels. The activation x and the residual carry res stay
// in shared memory as bf16; the global skip res1 is h0 itself, read again from
// device memory for conv12. The 11 layers of weights (616 KiB) do not fit, so
// each layer's 56 KiB are loaded in turn. Rows whose position lies outside
// [0, L) are re-zeroed after every layer (SAME padding at the sequence ends);
// the garbage that enters from the buffer edges moves in 3 rows a layer and
// never reaches the 444 rows that are written out. No cp.async, TMA or wgmma
// yet: this is the simple first version.

#include "common.cuh"

namespace {

constexpr int C = 64;                // channels of the stack
constexpr int KM = 7;                // conv2..conv12 kernel size
constexpr int KL = 3;                // conv_last kernel size
constexpr int NMID = 11;             // conv2..conv12
constexpr int HALO = 34;             // receptive half-width of the stack
constexpr int R = 512;               // rows of a tile, halos included
constexpr int T = R - 2 * HALO;      // positions written per tile, 444
constexpr int EDGE = KM / 2;         // zero rows kept at both buffer ends
constexpr int XS = C + 8;            // bf16 per shared activation row
constexpr int KMC = KM * C;          // GEMM depth of a k7 layer, 448
constexpr int WS = KMC + 8;          // bf16 per shared weight row
constexpr int KLC = KL * C;          // GEMM depth of conv_last, 192
constexpr int WLS = KLC + 8;         // bf16 per shared conv_last weight row
constexpr int NL = 8;                // conv_last outputs, padded to one n8 tile
constexpr int THREADS = 512;         // 16 warps x 32 rows
constexpr int M_SUB = 2;             // m16 tiles per warp
constexpr int N_SUB = C / 8;         // n8 tiles per warp, 8

constexpr int SMEM_X = (R + 2 * EDGE) * XS * 2;   // 74,592 B
constexpr int SMEM_RES = R * XS * 2;              // 73,728 B
constexpr int SMEM_W = C * WS * 2;                // 58,368 B
constexpr int SMEM = SMEM_X + SMEM_RES + SMEM_W;  // 206,688 B

// rows x cols bf16 from device memory (row-major, cols % 8 == 0) into shared
// memory with row stride `stride`
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, int stride,
                                          const __nv_bfloat16* src, int rows,
                                          int cols) {
  const int per_row = cols / 8;
  for (int i = threadIdx.x; i < rows * per_row; i += THREADS) {
    const int r = i / per_row, v = i % per_row;
    *reinterpret_cast<uint4*>(dst + r * stride + v * 8) =
        reinterpret_cast<const uint4*>(src + (size_t)r * cols)[v];
  }
}

__global__ void __launch_bounds__(THREADS, 1)
conv_stack_kernel(const __nv_bfloat16* __restrict__ h0,     // (B, L, 64)
                  const __nv_bfloat16* __restrict__ wmid,   // (11, 64, 448): [l][n][t*64 + c]
                  const float* __restrict__ bmid,           // (11, 64)
                  const __nv_bfloat16* __restrict__ wlast,  // (8, 192): [n][t*64 + c]
                  const float* __restrict__ blast,          // (8,)
                  float* __restrict__ out,                  // (B, L, r)
                  int B, int L, int r_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);  // rows -3 .. R+2
  __nv_bfloat16* rs = reinterpret_cast<__nv_bfloat16*>(smem + SMEM_X);
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem + SMEM_X + SMEM_RES);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int row0 = warp * 32;  // first tile row of this warp
  const int tiles_per_seq = (L + T - 1) / T;
  const long long n_tiles = (long long)B * tiles_per_seq;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  // the EDGE rows at both buffer ends stay zero for the kernel's life
  for (int i = tid; i < 2 * EDGE * XS; i += THREADS) {
    const int r = i / XS, c = i % XS;
    xs[(r < EDGE ? r : R + r) * XS + c] = zero;
  }

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long b = tile / tiles_per_seq;
    const int p0 = (int)(tile % tiles_per_seq) * T - HALO;  // position of row 0
    const __nv_bfloat16* hb = h0 + (size_t)b * L * C;

    // x = res = h0 over the tile's rows, zero outside [0, L)
    for (int i = tid; i < R * (C / 8); i += THREADS) {
      const int r = i / (C / 8), v = i % (C / 8);
      const int p = p0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (p >= 0 && p < L) val = reinterpret_cast<const uint4*>(hb + (size_t)p * C)[v];
      *reinterpret_cast<uint4*>(xs + (r + EDGE) * XS + v * 8) = val;
      *reinterpret_cast<uint4*>(rs + r * XS + v * 8) = val;
    }
    load_rows(ws, WS, wmid, C, KMC);

    for (int l = 0; l < NMID; ++l) {
      __syncthreads();  // x and this layer's weights are in place

      float acc[M_SUB][N_SUB][4];
#pragma unroll
      for (int j = 0; j < N_SUB; ++j) {
        const float b0 = bmid[l * C + j * 8 + 2 * tq];
        const float b1 = bmid[l * C + j * 8 + 2 * tq + 1];
#pragma unroll
        for (int i = 0; i < M_SUB; ++i) {
          acc[i][j][0] = b0; acc[i][j][1] = b1;
          acc[i][j][2] = b0; acc[i][j][3] = b1;
        }
      }

#pragma unroll 1
      for (int t = 0; t < KM; ++t) {
#pragma unroll
        for (int c0 = 0; c0 < C; c0 += 16) {
          const int k0 = t * C + c0;
          uint32_t a[M_SUB][4];
#pragma unroll
          for (int i = 0; i < M_SUB; ++i) {
            // output row m reads input row m + t - 3, stored at m + t
            const __nv_bfloat16* ap = xs + (row0 + i * 16 + g + t) * XS + c0 + 2 * tq;
            a[i][0] = ld32(ap);
            a[i][1] = ld32(ap + 8 * XS);
            a[i][2] = ld32(ap + 8);
            a[i][3] = ld32(ap + 8 * XS + 8);
          }
#pragma unroll
          for (int j = 0; j < N_SUB; ++j) {
            const __nv_bfloat16* bp = ws + (j * 8 + g) * WS + k0 + 2 * tq;
            const uint32_t b0 = ld32(bp), b1 = ld32(bp + 8);
#pragma unroll
            for (int i = 0; i < M_SUB; ++i) mma_bf16(acc[i][j], a[i], b0, b1);
          }
        }
      }
      __syncthreads();  // every warp is done reading x and the weights

      // the next layer's weights load while this layer's output is written
      if (l + 1 < NMID) load_rows(ws, WS, wmid + (size_t)(l + 1) * C * KMC, C, KMC);
      else load_rows(ws, WLS, wlast, NL, KLC);

      const int layer = l + 2;                  // conv{layer}
      const bool residual = (layer & 1) && layer < 2 + NMID - 1;
      const bool skip = layer == 2 + NMID - 1;  // conv12 + res1
#pragma unroll
      for (int i = 0; i < M_SUB; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = row0 + i * 16 + g + half * 8;
          const int p = p0 + row;
          const bool inside = p >= 0 && p < L;
#pragma unroll
          for (int j = 0; j < N_SUB; ++j) {
            const int n = j * 8 + 2 * tq;
            float v0 = acc[i][j][2 * half], v1 = acc[i][j][2 * half + 1];
            if (residual) {
              const float2 rv = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(rs + row * XS + n));
              v0 += rv.x; v1 += rv.y;
            } else if (skip) {
              if (inside) {
                const float2 rv = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(hb + (size_t)p * C + n));
                v0 += rv.x; v1 += rv.y;
              }
            } else {
              v0 = v0 >= 0.f ? v0 : 0.01f * v0;
              v1 = v1 >= 0.f ? v1 : 0.01f * v1;
            }
            __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
            if (!inside) v = __floats2bfloat162_rn(0.f, 0.f);  // SAME padding
            *reinterpret_cast<__nv_bfloat162*>(xs + (row + EDGE) * XS + n) = v;
            if (residual) *reinterpret_cast<__nv_bfloat162*>(rs + row * XS + n) = v;
          }
        }
    }
    __syncthreads();  // x after conv12 and conv_last's weights are in place

    // conv_last: k3, 64 -> r (padded to 8 outputs: one n8 tile)
    float acc[M_SUB][4];
    {
      const float b0 = blast[2 * tq], b1 = blast[2 * tq + 1];
#pragma unroll
      for (int i = 0; i < M_SUB; ++i) {
        acc[i][0] = b0; acc[i][1] = b1; acc[i][2] = b0; acc[i][3] = b1;
      }
    }
#pragma unroll
    for (int t = 0; t < KL; ++t)
#pragma unroll
      for (int c0 = 0; c0 < C; c0 += 16) {
        const __nv_bfloat16* bp = ws + g * WLS + t * C + c0 + 2 * tq;
        const uint32_t b0 = ld32(bp), b1 = ld32(bp + 8);
#pragma unroll
        for (int i = 0; i < M_SUB; ++i) {
          // output row m reads input row m + t - 1, stored at m + t + 2
          const __nv_bfloat16* ap = xs + (row0 + i * 16 + g + t + 2) * XS + c0 + 2 * tq;
          const uint32_t a[4] = {ld32(ap), ld32(ap + 8 * XS), ld32(ap + 8),
                                 ld32(ap + 8 * XS + 8)};
          mma_bf16(acc[i], a, b0, b1);
        }
      }
#pragma unroll
    for (int i = 0; i < M_SUB; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + i * 16 + g + half * 8;
        const int p = p0 + row;
        if (row < HALO || row >= HALO + T || p >= L) continue;
        float* o = out + ((size_t)b * L + p) * r_out;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = 2 * tq + e;
          if (n < r_out) o[n] = acc[i][2 * half + e];
        }
      }
    __syncthreads();  // the next tile overwrites x, res and the weights
  }
}

}  // namespace

extern "C" int conv_stack_launch(const void* h0, const void* wmid, const void* bmid,
                                 const void* wlast, const void* blast, void* out,
                                 int B, int L, int r_out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(conv_stack_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;

  const long long n_tiles = (long long)B * ((L + T - 1) / T);
  int grid = (int)(n_tiles < sms ? n_tiles : sms);  // one CTA per SM
  if (grid < 1) grid = 1;
  conv_stack_kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)h0, (const __nv_bfloat16*)wmid, (const float*)bmid,
      (const __nv_bfloat16*)wlast, (const float*)blast, (float*)out, B, L, r_out);
  return cudaGetLastError();
}
