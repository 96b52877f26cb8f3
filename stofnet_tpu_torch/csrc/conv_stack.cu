// StofNet conv stack, fused: conv2..conv11 (k7, 64->64, a residual add at odd
// layers and leaky 0.01 otherwise), conv12 plus the global skip, then
// conv_last (k3, 64->r), all in one kernel.
//
// Replaces the TPU kernel stofnet_tpu/ops/pallas/conv_stack_kernel.py:
// conv_stack_fused (_run_window/_kernel). h0 (B, L, 64) bf16, weights bf16,
// biases f32 -> out (B, L, r) f32. Rounding as in the TPU kernel: f32
// accumulation; after a residual layer (res + y) rounds to bf16, after any
// other layer leaky(y) rounds to bf16; conv12 + h0 rounds to bf16; conv_last
// stays f32.
//
// Bound on the H100: operations. At B=128, L=8000, r=4: 6.47e11 FLOP, 0.65 ms
// at 989 TFLOP/s bf16, against about 148 MB of traffic (0.04 ms at 3.35 TB/s).
// Layer by layer through device memory the stack would move 2 x 11 x 131 MB.
//
// Design. A persistent CTA of 512 threads (one an SM) walks over tiles of
// R = 512 rows; the receptive half-width of the stack is HALO = 11 x 3 + 1.
// - Edge-anchored tiles (the TPU kernel's window rule): the first tile of a
//   waveform starts at 0 and keeps [0, 478), the last ends at L and keeps its
//   last 478 positions, the others keep 444 with a halo of 34 on each side;
//   L <= 512 is one tile. At a sequence end the buffer's zero rows are the
//   stack's own SAME padding, so no outer halo is computed there: 18 tiles a
//   waveform at L = 8000 (87 % of the rows kept) where tiles of 444 centred
//   on their halo took 19 (82 %). The plan has one source, the Python
//   function ops/kernels/conv_stack.py:tile_plan, tested on the CPU: the
//   wrapper passes the kernel one int32 row (start, lo, hi) for each tile
//   of a waveform, and the launch sizes the grid from the number of rows.
// - Weights through a ring of 10 slots in shared memory. A k7 layer is 7 tap
//   blocks of 64 (n) x 64 (c) bf16, 8 KB each, laid out once on the host
//   (stack_weights) as their shared-memory image in the 128-byte swizzle:
//   chunk j of row n at chunk j ^ (n % 8). Each block arrives by one 1-D
//   cp.async.bulk that completes on its slot's mbarrier. The walk runs
//   through 11 x 7 tap blocks and conv_last's 3 KB, tile after tile. Thread 0
//   refills after the barrier that ends each layer, which every thread
//   reaches only when it is done with that layer's slots: no empty barriers
//   and no producer warp, whose 17th warp would cap every thread at 96
//   registers (one SM sub-partition holding 5 warps) and serialize the
//   wgmma. Taps 0-2 of the next layer arrive one layer ahead; no thread
//   copies weights through registers.
// - The k7 layers on wgmma.m64n128k16 (bf16 in, f32 accumulate) with the
//   roles of a plain implicit GEMM swapped: D (64 output channels x 128
//   positions) = A (the tap block's 64 x 16 channels, registers) x B (16
//   channels x 128 positions, the activation). Each of four warpgroups owns
//   128 positions of the tile (64 f32 accumulators a thread); its warps load
//   their 16 rows of the tap block by ldmatrix.x4 (XOR addressing on the
//   swizzled image), 8 KB a warpgroup a tap. B comes through a descriptor
//   on the activation buffer, itself in the 128-byte swizzle, starting at
//   row p + t for tap t (output position p reads input p + t - 3), stepped
//   along K by 32 bytes. A descriptor may start at any 128-byte row: the
//   card applies the swizzle to absolute shared addresses. This departs
//   from the first design (activation as A by ldmatrix at any row, the tap
//   block as B, m64n64): that reads 917 KB of shared memory a layer and
//   tile against 687 KB here, and on an H100 at B=128, L=8000 it ran at
//   1.42-1.48 ms where this runs at 1.23-1.25 (PERF.md).
// - Two activation buffers, no residual copy: xa holds h0 and, after every
//   residual layer, res = x; conv2, 4, .., 12 read xa and write xb, the
//   residual layers conv3, 5, .., 11 read xb and add their result into xa
//   in place. No layer writes the buffer its taps read, so one barrier a
//   layer (after the writes) suffices; each thread fences its writes to the
//   async proxy, through which wgmma reads B, before it. The epilogue
//   stores the accumulator (channels x positions) transposed into the
//   buffer (positions x channels) with stmatrix.trans, and reads res back
//   with ldmatrix.trans, each thread only the elements it then writes. For
//   conv12's global skip, h0 is copied into xb while conv12's taps read xa
//   and added the same way. Rows outside [0, L) (only in the one tile of a
//   waveform shorter than 512) are written as zeros after every layer.
//   conv_last (k3, 64 -> 8 padded, under 0.5 % of the FLOP) runs on
//   mma.sync from its slot.
// Shared memory: ring 81,920 B + 2 x 66,560 B + barriers, 216,144 B with
// the 1,024 B that align the ring.

#include "hopper.cuh"

namespace {

constexpr int C = 64;                // channels of the stack
constexpr int KM = 7;                // conv2..conv12 kernel size
constexpr int KL = 3;                // conv_last kernel size
constexpr int NMID = 11;             // conv2..conv12
constexpr int R = 512;               // rows of a tile (ROWS in conv_stack.py)
constexpr int EDGE = KM / 2;         // zero rows kept at both buffer ends
constexpr int ROW = C * 2;           // bytes of an activation row, 128
constexpr int KLC = KL * C;          // GEMM depth of conv_last, 192
constexpr int THREADS = 512;         // 4 warpgroups x 128 positions
constexpr int NP = 128;              // positions of a warpgroup (wgmma N)
constexpr int N_SUB = NP / 8;        // n8 position groups of an accumulator, 16
constexpr int TAP_BYTES = C * C * 2;     // one swizzled tap block, 8 KB
constexpr int LAST_BYTES = 8 * KLC * 2;  // conv_last's weights, 3 KB
constexpr int NSLOT = 10;            // ring slots
constexpr int BLOCKS = NMID * KM + 1;  // ring blocks of a tile: 77 taps, conv_last

constexpr int SMEM_RING = NSLOT * TAP_BYTES;                  // 81,920 B
constexpr int SMEM_X = ((R + 2 * EDGE) * ROW + 1023) / 1024 * 1024;  // 66,560 B, each of two
constexpr int SMEM_BAR = NSLOT * 8;                           // a full barrier a slot
constexpr int SMEM = 1024 + SMEM_RING + 2 * SMEM_X + SMEM_BAR;  // 216,144 B

// byte offset of 16-byte chunk j of row i in a 1,024-byte aligned buffer of
// 128-byte rows in the 128-byte swizzle (the layout wgmma reads)
__device__ __forceinline__ int swz(int i, int j) { return i * ROW + ((j ^ (i & 7)) << 4); }

__device__ __forceinline__ void block_sync() {
  asm volatile("bar.sync 0;\n" ::: "memory");
}

// order this thread's shared-memory accesses before later ones of the async
// proxy: wgmma's reads of its B operand, the bulk copies into the ring
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// four 8 x 8 b16 matrices from shared memory, lane l giving the address of
// row l % 8 of matrix l / 8; .trans delivers each transposed
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void stmatrix_x4_trans(const uint32_t (&r)[4], void* p) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1,%2,%3,%4};\n"
               ::"r"(smem_u32(p)), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// d (64 output channels x 128 positions, f32) += a (64 x 16 bf16 of a tap
// block, registers) * b (16 channels x 128 positions, the descriptor's rows)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
      "%61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),
        "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// One k7 layer over this warpgroup's 128 positions: per tap, the warp's 16
// output channels of the tap block by ldmatrix (XOR addressing on the
// swizzled image) as A, the input rows p + t - 3 of `xin` through a
// descriptor as B; a tap is one commit group. The next tap's A fragments
// load after wait_group 0: one set of A registers (a second set, to keep a
// group in flight meanwhile, spilled and was no faster; the other three
// warpgroups keep the tensor cores busy). The taps are unrolled: over a
// loop whose groups it cannot count, ptxas serializes the wgmma.
__device__ __forceinline__ void layer_wgmma(float (&acc)[64], uint32_t xin,
                                            const unsigned char* ring, uint64_t* full,
                                            uint32_t& q, int pos0, int ch0, int lane) {
  uint32_t a[4][4];
  const int n = ch0 + (lane & 15);
  acc_fence(acc);
#pragma unroll
  for (int t = 0; t < KM; ++t) {
    const int slot = (q + t) % NSLOT;
    mbar_wait(&full[slot], ((q + t) / NSLOT) & 1);
    const unsigned char* wb = ring + slot * TAP_BYTES;
    wg_wait_all();  // tap t - 1 is done with a
#pragma unroll
    for (int k = 0; k < C / 16; ++k)
      ldmatrix_x4(a[k], wb + n * ROW + (((2 * k + (lane >> 4)) ^ (n & 7)) << 4));
    const uint64_t desc = rows_desc(xin, pos0 + t);
    wg_fence();
#pragma unroll
    for (int k = 0; k < C / 16; ++k) wgmma_rs(acc, a[k], desc + 2 * k);
    wg_commit();
  }
  q += KM;
  wg_wait_all();
  acc_fence(acc);
}

enum Epilogue { LEAKY, RESIDUAL, SKIP };

// A layer's output over this warp's 16 channels x 128 positions, rounded
// to bf16 into `xout` by stmatrix.trans (the accumulator holds channels x
// positions, the buffer positions x channels): leaky(y); or y + the
// bf16 values already at those places of `xout` (res for a residual layer,
// h0 for conv12), each thread reading only what it then writes. Positions
// outside [0, L) are written as zeros, the SAME padding of the next layer.
template <Epilogue MODE>
__device__ __forceinline__ void epilogue(const float (&acc)[64], unsigned char* xout,
                                         int pos0, int ch0, int p0, int L, int lane,
                                         int tq) {
  // lane l addresses row l % 8 of matrix l / 8: n8 position group 2jj + l / 16,
  // channels ch0 + 8 ((l / 8) % 2) .. + 8
  const int chunk = ch0 / 8 + ((lane >> 3) & 1);
#pragma unroll
  for (int jj = 0; jj < N_SUB / 2; ++jj) {
    const int i = EDGE + pos0 + (2 * jj + (lane >> 4)) * 8 + (lane & 7);
    unsigned char* addr = xout + swz(i, chunk);
    uint32_t old[4];
    if (MODE != LEAKY) ldmatrix_x4_trans(old, addr);
    uint32_t v[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 2 * jj + h;
      const int p = p0 + pos0 + 8 * j + 2 * tq;  // this thread's positions p, p + 1
#pragma unroll
      for (int m = 0; m < 2; ++m) {  // channels g (m = 0) and g + 8
        float y0 = acc[4 * j + 2 * m], y1 = acc[4 * j + 2 * m + 1];
        if (MODE == LEAKY) {
          y0 = y0 >= 0.f ? y0 : 0.01f * y0;
          y1 = y1 >= 0.f ? y1 : 0.01f * y1;
        } else {
          const float2 r = unpack_bf16(old[2 * h + m]);
          y0 += r.x; y1 += r.y;
        }
        v[2 * h + m] = pack_bf16(p < L ? y0 : 0.f, p + 1 < L ? y1 : 0.f);
      }
    }
    stmatrix_x4_trans(v, addr);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
conv_stack_kernel(const __nv_bfloat16* __restrict__ h0,     // (B, L, 64)
                  const __nv_bfloat16* __restrict__ wmid,   // (11, 7, 64 x 64) swizzled
                  const float* __restrict__ bmid,           // (11, 64)
                  const __nv_bfloat16* __restrict__ wlast,  // (8, 192): [n][t*64 + c]
                  const float* __restrict__ blast,          // (8,)
                  float* __restrict__ out,                  // (B, L, r)
                  const int* __restrict__ plan,             // (n_seq, 3): start, lo, hi
                  int n_seq, int B, int L, int r_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // everything on 1,024-byte boundaries: the 128-byte swizzle is laid on
  // absolute shared addresses
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // two activation buffers of 128-byte rows, position p of the tile at row
  // p + EDGE: xa holds h0 and, after each residual layer, res = x; xb the
  // output of every other layer
  unsigned char* xa = ring + SMEM_RING;
  unsigned char* xb = xa + SMEM_X;
  uint64_t* full = reinterpret_cast<uint64_t*>(xb + SMEM_X);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long n_tiles = (long long)B * n_seq;
  const long long mine = blockIdx.x < n_tiles ? (n_tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const uint32_t total = (uint32_t)(mine * BLOCKS);  // ring blocks of this CTA's walk

  if (tid == 0) {
    for (int i = 0; i < NSLOT; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the EDGE rows at both ends of both buffers stay zero for the kernel's life
  for (int i = tid; i < 2 * EDGE * ROW / 16; i += THREADS) {
    const int r = i / (ROW / 16), v = i % (ROW / 16);
    const int row = r < EDGE ? r : R + r;
    *reinterpret_cast<uint4*>(xa + row * ROW + v * 16) = make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(xb + row * ROW + v * 16) = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  // Thread 0 keeps the ring full: the walk of ring blocks is the tile's 77
  // tap blocks and conv_last's, tile after tile, block u in slot u % NSLOT.
  // Called after a barrier that every thread reaches only once it is done
  // with the first `consumed` blocks, it fills their slots with the next.
  uint32_t issued = 0;
  auto refill = [&](uint32_t consumed) {
    if (tid != 0) return;
    fence_async_shared();  // conv_last's reads of its slot, before the copies
    for (; issued < total && issued < consumed + NSLOT; ++issued) {
      const int blk = issued % BLOCKS;
      const bool last = blk == BLOCKS - 1;
      bulk_load(ring + (issued % NSLOT) * TAP_BYTES,
                last ? (const void*)wlast : (const void*)(wmid + (size_t)blk * C * C),
                last ? LAST_BYTES : TAP_BYTES, &full[issued % NSLOT]);
    }
  };
  refill(0);

  const int g = lane >> 2, tq = lane & 3;
  // warpgroup wg computes positions [128 wg, 128 wg + 128) of the tile; its
  // warp w4 the output channels [16 w4, 16 w4 + 16), the wgmma
  // accumulator's layout
  const int pos0 = (warp >> 2) * NP, ch0 = (warp & 3) * 16;
  const uint32_t xa_s = smem_u32(xa), xb_s = smem_u32(xb);
  uint32_t q = 0;  // ring blocks consumed so far

  // h0's rows of one tile into a buffer, in the swizzle, zero outside [0, L)
  auto load_h0 = [&](unsigned char* dst, const __nv_bfloat16* hb, int p0) {
    for (int i = tid; i < R * (ROW / 16); i += THREADS) {
      const int r = i / (ROW / 16), v = i % (ROW / 16);
      const int p = p0 + r;
      const bool in = p < L;
      cp_async16(dst + swz(r + EDGE, v), in ? hb + (size_t)p * C + v * 8 : hb,
                 in ? 16 : 0);
    }
    cp_async_commit();
  };

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long b = tile / n_seq;
    // the tile's first position and the range [lo, hi) of positions it writes
    const int* pt = plan + 3 * (tile % n_seq);
    const int p0 = pt[0], lo = pt[1], hi = pt[2];
    const __nv_bfloat16* hb = h0 + (size_t)b * L * C;

    // xa = h0. The previous tile last read xa in conv12, before the
    // barrier that ended that layer.
    load_h0(xa, hb, p0);
    cp_async_wait<0>();
    fence_async_shared();
    block_sync();  // and every thread is done with the previous conv_last
    refill(q);

    for (int l = 0; l < NMID; ++l) {
      // conv{l + 2}: conv2, 4, .., 12 read xa and write xb; the residual
      // layers conv3, 5, .., 11 read xb and write res + y over xa. No
      // layer writes the buffer its taps read, so the only barrier is the
      // one after the writes, before the next layer reads them.
      float acc[64];
      {
        const float b0 = bmid[l * C + ch0 + g], b1 = bmid[l * C + ch0 + g + 8];
#pragma unroll
        for (int j = 0; j < N_SUB; ++j) {
          acc[4 * j] = b0; acc[4 * j + 1] = b0;
          acc[4 * j + 2] = b1; acc[4 * j + 3] = b1;
        }
      }
      if (l == NMID - 1) load_h0(xb, hb, p0);  // conv12's skip, into xb
      layer_wgmma(acc, l % 2 ? xb_s : xa_s, ring, full, q, pos0, ch0, lane);
      if (l % 2) {
        epilogue<RESIDUAL>(acc, xa, pos0, ch0, p0, L, lane, tq);
      } else if (l < NMID - 1) {
        epilogue<LEAKY>(acc, xb, pos0, ch0, p0, L, lane, tq);
      } else {
        cp_async_wait<0>();
        block_sync();  // h0 is in xb
        epilogue<SKIP>(acc, xb, pos0, ch0, p0, L, lane, tq);
      }
      fence_async_shared();
      block_sync();  // this layer's output and its taps are done with
      refill(q);
    }

    // conv_last: k3, 64 -> r (padded to 8 outputs: one n8 tile), its
    // weights [n][t * 64 + c] in the ring's next slot; warp w computes
    // positions [32 w, 32 w + 32) with mma.sync, A by ldmatrix from xb
    const int slot = q % NSLOT;
    mbar_wait(&full[slot], (q / NSLOT) & 1);
    const __nv_bfloat16* wl = reinterpret_cast<const __nv_bfloat16*>(ring + slot * TAP_BYTES);
    float acc[2][4];
    {
      const float b0 = blast[2 * tq], b1 = blast[2 * tq + 1];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        acc[s][0] = b0; acc[s][1] = b1; acc[s][2] = b0; acc[s][3] = b1;
      }
    }
#pragma unroll
    for (int t = 0; t < KL; ++t)
#pragma unroll
      for (int c0 = 0; c0 < C; c0 += 16) {
        const __nv_bfloat16* bp = wl + g * KLC + t * C + c0 + 2 * tq;
        const uint32_t b0 = ld32(bp), b1 = ld32(bp + 8);
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          // output position m reads input m + t - 1, at row m + t + 2
          const int i = warp * 32 + s * 16 + (lane & 15) + t + 2;
          uint32_t a[4];
          ldmatrix_x4(a, xb + swz(i, c0 / 8 + (lane >> 4)));
          mma_bf16(acc[s], a, b0, b1);
        }
      }
    ++q;
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = p0 + warp * 32 + s * 16 + g + half * 8;
        if (p < lo || p >= hi) continue;
        float* o = out + ((size_t)b * L + p) * r_out;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = 2 * tq + e;
          if (n < r_out) o[n] = acc[s][2 * half + e];
        }
      }
  }
}

}  // namespace

extern "C" int conv_stack_launch(const void* h0, const void* wmid, const void* bmid,
                                 const void* wlast, const void* blast, void* out,
                                 const void* plan, int n_seq, int B, int L, int r_out,
                                 int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(conv_stack_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;

  const long long n_tiles = (long long)B * n_seq;
  int grid = (int)(n_tiles < sms ? n_tiles : sms);  // one CTA per SM
  if (grid < 1) grid = 1;
  conv_stack_kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)h0, (const __nv_bfloat16*)wmid, (const float*)bmid,
      (const __nv_bfloat16*)wlast, (const float*)blast, (float*)out, (const int*)plan,
      n_seq, B, L, r_out);
  return cudaGetLastError();
}
