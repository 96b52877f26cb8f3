// The streaming-read probe and its canary.
//
// Probe: replaces the TPU kernel of scripts/dma_probe.py:make_manual_probe
// (its `probe`), which walks a (n_rows, 128) bf16 array through n_buffers
// chunk buffers filled by explicit async copies and sums it to
// out[r, c] = sum_i x[8 i + r, c] in f32. Its time measures the rate at which
// a kernel can stream its input from device memory through such a ring.
//
// Bound on the H100: bytes. The (1,024,000, 128) bf16 input is 262 MB, 0.078
// ms at 3.35 TB/s; the 2.6e8 f32 adds are 0.004 ms at 67 TFLOP/s.
//
// Design: one block cannot approach the card's memory rate, so a grid of
// persistent CTAs (one or two per SM, as many as shared memory lets) each
// streams a contiguous share of the chunks. A chunk is `chunk_rows` rows
// (chunk_rows * 256 B) and fills one stage of an NBUF-stage ring in shared
// memory with cp.async.cg 16-byte copies, one commit group per stage; the CTA
// waits for stage s, synchronises, issues stage s + NBUF - 1 into the slot
// stage s - 1 held, and adds stage s into registers. Thread t owns the 8
// columns 8 (t % 16) .. + 7 of rows t / 16, t / 16 + 16, ... of each chunk,
// all of which have row index t / 16 mod 8. The CTA then sums its two
// threads per (row, column) into a (8, 128) f32 partial, and a second kernel
// sums the partials in CTA order: no float atomics, so two runs on the same
// card give the same bits. `chunk_rows` and NBUF are the sweep's parameters
// (stage size and depth of the ring), in place of the TPU's VMEM buffers,
// which do not fit in shared memory.
//
// Canary: replaces scripts/dma_probe.py:triv, o = 2 x on (8, 128) f32. It is
// run first after the build: a failure there names the toolchain or the
// CUDA runtime, not a kernel. Bound: 8 KB moved; its time is the launch latency.

#include "common.cuh"

namespace {

constexpr int COLS = 128;         // bf16 per row, 256 B
constexpr int THREADS = 256;      // 16 threads per row, 16 rows per pass
constexpr int VEC_PER_ROW = COLS / 8;
constexpr int ROWS_PER_PASS = THREADS / VEC_PER_ROW;
constexpr int RED_BYTES = ROWS_PER_PASS * COLS * 4;  // the CTA's (16, 128) f32 sums

// dynamic shared memory of a launch: the ring, and at least the sums that
// reuse it at the end
__host__ __device__ constexpr long long probe_smem(int chunk_rows, int n_buffers) {
  return (long long)n_buffers * chunk_rows * COLS * 2 > RED_BYTES
             ? (long long)n_buffers * chunk_rows * COLS * 2
             : RED_BYTES;
}

template <int NBUF>
__global__ void __launch_bounds__(THREADS)
probe_kernel(const __nv_bfloat16* __restrict__ x,  // (n_chunks * chunk_rows, 128)
             float* __restrict__ partial,          // (gridDim.x, 8, 128)
             long long n_chunks, int chunk_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const long long c0 = n_chunks * blockIdx.x / gridDim.x;
  const long long c1 = n_chunks * (blockIdx.x + 1) / gridDim.x;
  const int stage_bytes = chunk_rows * COLS * 2;
  const int vecs = chunk_rows * VEC_PER_ROW;

  auto issue = [&](long long c, int slot) {
    const char* src = reinterpret_cast<const char*>(x) + c * stage_bytes;
    unsigned char* dst = smem + slot * stage_bytes;
    for (int i = tid; i < vecs; i += THREADS) cp_async16(dst + i * 16, src + i * 16);
  };

#pragma unroll
  for (int s = 0; s < NBUF - 1; ++s) {
    if (c0 + s < c1) issue(c0 + s, s);
    cp_async_commit();  // one group per stage, empty ones included
  }

  float acc[8] = {};
  const int col = (tid % VEC_PER_ROW) * 8;
  const int row0 = tid / VEC_PER_ROW;  // 0..15; its rows are all row0 % 8 mod 8
  for (long long c = c0; c < c1; ++c) {
    cp_async_wait<NBUF - 2>();
    __syncthreads();
    const long long next = c + NBUF - 1;
    if (next < c1) issue(next, (int)((next - c0) % NBUF));
    cp_async_commit();

    const __nv_bfloat16* s =
        reinterpret_cast<const __nv_bfloat16*>(smem + ((c - c0) % NBUF) * stage_bytes);
    for (int r = row0; r < chunk_rows; r += ROWS_PER_PASS) {
      const uint4 v = *reinterpret_cast<const uint4*>(s + r * COLS + col);
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(p[k]);
        acc[2 * k] += f.x;
        acc[2 * k + 1] += f.y;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every stage consumed: the ring's memory is free

  // rows row0 and row0 + 8 of each pass share a residue: add them in order
  float* red = reinterpret_cast<float*>(smem);  // (16, 128), RED_BYTES
#pragma unroll
  for (int k = 0; k < 8; ++k) red[row0 * COLS + col + k] = acc[k];
  __syncthreads();
  float* mine = partial + (size_t)blockIdx.x * 8 * COLS;
  for (int i = tid; i < 8 * COLS; i += THREADS) mine[i] = red[i] + red[i + 8 * COLS];
}

__global__ void probe_reduce(const float* __restrict__ partial, float* __restrict__ out,
                             int n_parts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 8 * COLS) return;
  float s = 0.f;
  for (int p = 0; p < n_parts; ++p) s += partial[(size_t)p * 8 * COLS + i];
  out[i] = s;
}

__global__ void canary_kernel(const float* __restrict__ x, float* __restrict__ o, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = 2.f * x[i];
}

template <int NBUF>
cudaError_t launch_probe(const void* x, void* partial, void* out, long long n_chunks,
                         int chunk_rows, int n_parts, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(probe_kernel<NBUF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  probe_kernel<NBUF><<<n_parts, THREADS, smem, stream>>>(
      (const __nv_bfloat16*)x, (float*)partial, n_chunks, chunk_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  probe_reduce<<<(8 * COLS + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      (const float*)partial, (float*)out, n_parts);
  return cudaGetLastError();
}

}  // namespace

// CTAs the probe launches for this stage size and depth: as many per SM as
// shared memory lets, at most two, never more than there are chunks. The
// wrapper sizes the partials with it.
extern "C" int dma_probe_ctas(long long n_chunks, int chunk_rows, int n_buffers, int device,
                              int* ctas) {
  int sms = 0, per_block = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&per_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  if (err != cudaSuccess) return err;
  const long long smem = probe_smem(chunk_rows, n_buffers);
  if (smem > per_block) return cudaErrorInvalidValue;
  const long long fit = per_sm / (smem + 1024);  // 1 KB reserved per block
  const long long per = fit >= 2 ? 2 : 1;
  long long n = per * sms;
  if (n > n_chunks) n = n_chunks;
  *ctas = (int)n;
  return cudaSuccess;
}

extern "C" int dma_probe_launch(const void* x, void* partial, void* out, long long n_rows,
                                int chunk_rows, int n_buffers, int n_parts, int device,
                                void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  if (chunk_rows <= 0 || chunk_rows % 8 || n_rows % chunk_rows || n_parts < 1)
    return cudaErrorInvalidValue;
  const long long n_chunks = n_rows / chunk_rows;
  const int smem = (int)probe_smem(chunk_rows, n_buffers);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (n_buffers) {
    case 2: return launch_probe<2>(x, partial, out, n_chunks, chunk_rows, n_parts, smem, s);
    case 3: return launch_probe<3>(x, partial, out, n_chunks, chunk_rows, n_parts, smem, s);
    case 4: return launch_probe<4>(x, partial, out, n_chunks, chunk_rows, n_parts, smem, s);
    case 6: return launch_probe<6>(x, partial, out, n_chunks, chunk_rows, n_parts, smem, s);
    case 8: return launch_probe<8>(x, partial, out, n_chunks, chunk_rows, n_parts, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int dma_canary_launch(const void* x, void* o, int n, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  canary_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>((const float*)x,
                                                                   (float*)o, n);
  return cudaGetLastError();
}
