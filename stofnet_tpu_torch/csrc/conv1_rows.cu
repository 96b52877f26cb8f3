// StofNet's conv1 (k9, 1 -> 64, SAME padding) with its bias and ReLU, written
// as the channels-last (B, L, 64) bf16 rows that the SGB and conv-stack
// kernels read.
//
// Replaces no TPU kernel: conv1 was XLA's in the JAX package
// (stofnet_tpu/models/fused.py). On the card it was cuDNN's conv, which
// writes (B, 64, L) channel-major, then a bias add and a ReLU as passes of
// their own, and a transposing copy in each kernel wrapper that wants the
// rows: five kernels and two copies of the 131 MB activation at B=128, L=8000.
//
// x (B, L) f32 frames, w (64, 1, 9) bf16 (torch's [o][t]), bias (64,) bf16 ->
// h (B, L, 64) bf16. Rounding as conv1d_same(..., dtype=bf16) followed by
// relu: x rounds to bf16; the 9 products (exact in f32) are summed in f32 and
// the sum rounds to bf16 (the conv's output); the bias is added in f32 and
// the sum rounds to bf16; then max(., 0). The result differs from cuDNN's
// only by the order of the 9-term f32 sum.
//
// Bound on the H100: bytes. A position reads 4 B of frame and writes 128 B of
// h: 135 MB at B=128, L=8000, 0.040 ms at 3.35 TB/s. Its 1,152 FLOP a
// position (1.18 GFLOP) take 0.018 ms at 67 TFLOP/s f32 on the CUDA cores.
//
// Design: every byte of h is written once, by 16-byte stores of whole
// 128-byte lines; the frame is read once; nothing else goes to device
// memory, and no thread waits on another.
// - Thread t owns channels 8 (t % 8) .. 8 (t % 8) + 7: their 72 weights and
//   8 biases are read once into registers, before a persistent loop (two
//   CTAs of 256 threads an SM) over tiles of 256 positions of one waveform.
// - In a tile, thread t computes RUN = 8 consecutive positions, starting at
//   8 (t / 8): it loads their 16 frame values (4 halo positions each side,
//   zero outside [0, L): the SAME padding) into registers through the
//   read-only path, rounded to bf16, and reuses each for up to 9 taps. No
//   shared memory and no barrier: the 8 threads of a run load the same
//   addresses, which the cache serves once.
// - The epilogue rounds the 8 sums in pairs (one bf16x2 conversion), adds
//   the biases in f32, rounds again and applies max(., 0) on the pair, then
//   writes the 8 channels of a position as one 16-byte store: the 8 threads
//   of a run fill a 128-byte line, a warp 4 lines a store.
// - A thread's 576 FMAs a tile (8 positions x 72) keep the CUDA cores
//   about as busy as the stores keep HBM (0.02-0.03 ms of instructions
//   against 0.040 ms of bytes), so the tile loop interleaves the two
//   across the SM's 16 warps.

#include "common.cuh"

namespace {

constexpr int C = 64;                // output channels
constexpr int K = 9;                 // taps
constexpr int HALF = K / 2;          // SAME padding: 4 on each side
constexpr int THREADS = 256;
constexpr int CTAS_PER_SM = 2;
constexpr int GROUP = 8;             // channels a thread: one 16-byte store
constexpr int GROUPS = C / GROUP;    // threads a position
constexpr int RUN = 8;               // consecutive positions a thread
constexpr int TILE = THREADS / GROUPS * RUN;  // positions a CTA pass, 256

__global__ void __launch_bounds__(THREADS, CTAS_PER_SM)
conv1_rows_kernel(const float* __restrict__ x,            // (B, L)
                  const __nv_bfloat16* __restrict__ w,    // (64, 9) [o][t]
                  const __nv_bfloat16* __restrict__ bias, // (64,)
                  __nv_bfloat16* __restrict__ out,        // (B, L, 64)
                  int L, int tiles, int n_tiles) {
  const int g = threadIdx.x % GROUPS;  // channels GROUP g .. GROUP g + 7
  const int run = threadIdx.x / GROUPS * RUN;
  float wr[K][GROUP], br[GROUP];
#pragma unroll
  for (int j = 0; j < GROUP; ++j) {
#pragma unroll
    for (int t = 0; t < K; ++t)
      wr[t][j] = __bfloat162float(w[(GROUP * g + j) * K + t]);
    br[j] = __bfloat162float(bias[GROUP * g + j]);
  }
  const __nv_bfloat162 zero = __float2bfloat162_rn(0.f);

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / tiles;
    const int p = (tile % tiles) * TILE + run;  // this thread's first position
    if (p >= L) continue;
    const float* xb = x + (size_t)b * L;
    float xr[RUN + K - 1];  // frame p - 4 .. p + RUN + 3, rounded to bf16
#pragma unroll
    for (int i = 0; i < RUN + K - 1; ++i) {
      const int s = p - HALF + i;
      xr[i] = (s >= 0 && s < L)
                  ? __bfloat162float(__float2bfloat16_rn(__ldg(xb + s)))
                  : 0.f;
    }
    __nv_bfloat16* ob = out + ((size_t)b * L + p) * C + GROUP * g;
#pragma unroll
    for (int r = 0; r < RUN; ++r) {
      if (p + r >= L) break;
      float acc[GROUP];
#pragma unroll
      for (int j = 0; j < GROUP; ++j) acc[j] = 0.f;
#pragma unroll
      for (int t = 0; t < K; ++t)  // output p + r reads frame p + r + t - 4
#pragma unroll
        for (int j = 0; j < GROUP; ++j) acc[j] = fmaf(xr[r + t], wr[t][j], acc[j]);
      uint32_t packed[GROUP / 2];
#pragma unroll
      for (int j = 0; j < GROUP / 2; ++j) {
        // the conv's output rounded, the bias added in f32, rounded, relu
        // (max with NaN passing, as torch's relu passes it)
        const __nv_bfloat162 y = __floats2bfloat162_rn(acc[2 * j], acc[2 * j + 1]);
        const __nv_bfloat162 v = __hmax2_nan(
            __floats2bfloat162_rn(__low2float(y) + br[2 * j],
                                  __high2float(y) + br[2 * j + 1]),
            zero);
        packed[j] = *reinterpret_cast<const uint32_t*>(&v);
      }
      *reinterpret_cast<uint4*>(ob + (size_t)r * C) =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
    }
  }
}

}  // namespace

extern "C" int conv1_rows_launch(const void* x, const void* w, const void* bias,
                                 void* out, int B, int L, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  const int tiles = (L + TILE - 1) / TILE;
  const long long n_tiles = (long long)B * tiles;
  if (n_tiles == 0) return cudaSuccess;
  if (n_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long slots = (long long)CTAS_PER_SM * sms;
  const int grid = (int)(n_tiles < slots ? n_tiles : slots);
  conv1_rows_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const __nv_bfloat16*)w, (const __nv_bfloat16*)bias,
      (__nv_bfloat16*)out, L, tiles, (int)n_tiles);
  return cudaGetLastError();
}
