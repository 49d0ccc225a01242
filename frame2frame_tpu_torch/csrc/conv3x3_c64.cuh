// The 3x3 SAME convolution body over NHWC activations with 64 channels in and
// out (128 bytes a pixel in bf16) of the forward kernels of the DnCNN 64->64
// mid layers (fused_stack.cu), for Hopper (sm_90a), and the helpers that the
// port's other tensor-core kernels share: the swizzled 128-byte-row layout,
// ldmatrix, mma.sync, cp.async, the rounded affine, finish_sums and the
// persistent grid (fused_stack_bwd.cu, conv3x3.cu).
//
// One template, conv3x3_c64<T, PRO, EPI>, with a prologue applied to the
// operand while it is staged and an epilogue applied to the f32 accumulators:
//
//   PRO_NONE    operand = in
//   PRO_AFFINE  operand = relu(s * in + b)
//   EPI_NONE    out = acc
//   EPI_AFFINE  out = relu(s * acc + b)
//   EPI_STATS   out = acc, and per channel sum(acc), sum(acc^2) over the
//               image pixels, from the accumulator before out is rounded
//
// Zero padding applies to the operand AFTER the prologue: pixels outside the
// image are written as zeros into the halo tile. Frames of a batch are
// isolated by the same per-image padding.
//
// Every affine whose sign decides a ReLU or a ReLU mask is computed as a
// rounded product plus a rounded sum (affine() below, no fused multiply-add),
// in the forward prologue, the backward kernel's masks and the plain PyTorch
// versions alike, so all of them agree on every pixel.
//
// Per-channel sums are reduced without atomics: a thread keeps its sums over
// all tiles of its persistent block, the block reduces them by warp shuffles
// and shared memory and writes one row of partials, and finish_sums adds the
// rows in block order. The same inputs give the same bits on every run.
//
// Design (first version: right and simple; wgmma and TMA come later):
//   * a persistent block of 4 warps walks output tiles of 8 x 16 pixels x 64
//     channels of one image; each warp owns 2 tile rows (two m16 MMA tiles);
//   * the (8+2) x (16+2) x 64 halo tile is staged in shared memory as bf16
//     after the prologue, zeros outside the image;
//   * each thread starts all global loads of a batch of halo chunks before
//     it converts and stores any, so it waits on device memory once a batch;
//   * nine taps (unrolled) x four k16 steps of mma.sync.m16n8k16 (bf16 in,
//     f32 accumulate), fragments loaded with ldmatrix.x4 from the halo tile
//     and the weights held in shared memory;
//   * both shared tiles use 128-byte rows with the 16-byte chunk index XORed
//     by (row & 7), so every ldmatrix phase and every staging store is free
//     of bank conflicts;
//   * the epilogue stores bf16 or f32 straight from the accumulators.
// MMA operands are rounded to bf16 also for the f32 chain, as the TPU's
// matrix unit rounds them at default precision.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace f2f {

constexpr int C = 64;                 // channels in and out
constexpr int TH = 8;                 // output tile rows
constexpr int TW = 16;                // output tile columns: one m16 MMA tile
constexpr int HH = TH + 2;            // halo tile rows
constexpr int HW = TW + 2;            // halo tile columns
constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr int RPW = TH / NWARPS;      // tile rows per warp
constexpr int W_BYTES = 9 * C * C * 2;
constexpr int HALO_BYTES = HH * HW * C * 2;
constexpr int SMEM_BYTES = W_BYTES + HALO_BYTES;
constexpr int CHUNKS_PER_THREAD = (HH * HW * 8 + NTHREADS - 1) / NTHREADS;

static_assert(NTHREADS % 8 == 0, "a thread keeps one channel chunk");
static_assert(TH % NWARPS == 0, "warps split the tile rows evenly");
static_assert(NTHREADS == 2 * C, "one thread writes one per-channel sum");

enum Prologue { PRO_NONE = 0, PRO_AFFINE = 1 };
enum Epilogue { EPI_NONE = 0, EPI_AFFINE = 1, EPI_STATS = 2 };

// Byte offset of channel ch of row `row` in a swizzled 128-byte-row tile.
__device__ __forceinline__ int swz(int row, int ch) {
  return row * 128 + (((ch >> 3) ^ (row & 7)) << 4) + ((ch & 7) << 1);
}

// s * z + b with the product and the sum rounded separately.
__device__ __forceinline__ float affine(float s, float z, float b) {
  return __fadd_rn(__fmul_rn(s, z), b);
}

// One 8-channel chunk (16 bytes of bf16, 32 of f32) as it lies in memory.
template <typename T>
struct Chunk;
template <>
struct Chunk<__nv_bfloat16> {
  uint4 u;
};
template <>
struct Chunk<float> {
  float4 a, b;
};

__device__ __forceinline__ void ldg(Chunk<__nv_bfloat16>& c,
                                    const __nv_bfloat16* p) {
  c.u = *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void ldg(Chunk<float>& c, const float* p) {
  c.a = reinterpret_cast<const float4*>(p)[0];
  c.b = reinterpret_cast<const float4*>(p)[1];
}

__device__ __forceinline__ void unpack(const Chunk<__nv_bfloat16>& c,
                                       float v[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&c.u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void unpack(const Chunk<float>& c, float v[8]) {
  v[0] = c.a.x; v[1] = c.a.y; v[2] = c.a.z; v[3] = c.a.w;
  v[4] = c.b.x; v[5] = c.b.y; v[6] = c.b.z; v[7] = c.b.w;
}

__device__ __forceinline__ uint4 pack8(const float v[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  return u;
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// Four 8x8 b16 matrices from shared memory; lane l gives the address of
// row (l & 7) of matrix (l >> 3). The .trans form hands each lane a column
// pair instead of a row pair: the MMA B fragment of a row-major K x N tile,
// or the MMA A fragment of a row-major K x M tile.
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0,
                                              uint32_t& r1, uint32_t& r2,
                                              uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t addr, uint32_t& r0,
                                              uint32_t& r1) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float c[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 16 bytes from global to shared memory without passing through registers;
// valid = false writes 16 zero bytes and reads nothing (src must still be a
// mapped address). Completion is waited for by group: cp_async_commit()
// closes the group of the copies issued so far, cp_async_wait<N>() waits
// until at most N groups are in flight.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Whether image row y is a row of the image: the one test of row validity
// of the backward kernels, which a row window of a split frame can replace.
__device__ __forceinline__ bool row_in_image(int y, int H) {
  return y >= 0 && y < H;
}

// in, out: (B, H, W, 64) contiguous, T = bf16 or float.
// w: (3, 3, 64, 64) HWIO bf16 = (9 * 64, 64) rows tap*64 + i (tap = 3*dy+dx)
//    of the 64 output channels.
// s, b: 64 floats each (PRO_AFFINE or EPI_AFFINE);
// partial: (blocks, 2, 64) f32 (EPI_STATS).
template <typename T>
struct ConvArgs {
  const T* in;
  const __nv_bfloat16* w;
  const float* s;
  const float* b;
  T* out;
  float* partial;
  int B, H, W, tiles_y, tiles_x;
};

template <typename T, int PRO, int EPI>
__global__ void __launch_bounds__(NTHREADS, 2)
conv3x3_c64(const ConvArgs<T> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[NWARPS][2][C];   // per-warp sums of the block
  unsigned char* ws = smem;
  unsigned char* hs = smem + W_BYTES;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;  // MMA group: fragment row / column
  const int t = tid & 3;          // thread in group: fragment k pair
  const int H = a.H, W = a.W;
  constexpr bool SUMS = EPI == EPI_STATS;

  for (int idx = tid; idx < 9 * C * 8; idx += NTHREADS) {
    uint4 u = reinterpret_cast<const uint4*>(a.w)[idx];
    *reinterpret_cast<uint4*>(ws + swz(idx >> 3, (idx & 7) * 8)) = u;
  }

  // NTHREADS % 8 == 0: a thread stages the same channel chunk of every pixel
  const int chunk = tid & 7;
  float ps[8], pb[8];    // PRO_AFFINE: s, b
  if constexpr (PRO == PRO_AFFINE) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      ps[i] = a.s[chunk * 8 + i];
      pb[i] = a.b[chunk * 8 + i];
    }
  }
  float es[8][2], eb[8][2];
  if constexpr (EPI == EPI_AFFINE) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        es[j][q] = a.s[8 * j + 2 * t + q];
        eb[j][q] = a.b[8 * j + 2 * t + q];
      }
    }
  }
  // this thread's sums over all tiles of the block: channels 8j + 2t + q
  float st0[8][2], st1[8][2];
  if constexpr (SUMS) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int q = 0; q < 2; ++q) st0[j][q] = st1[j][q] = 0.f;
    }
  }

  const long ntiles = (long)a.B * a.tiles_y * a.tiles_x;
  for (long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int tx = (int)(tile % a.tiles_x);
    const long r = tile / a.tiles_x;
    const int ty = (int)(r % a.tiles_y);
    const int bi = (int)(r / a.tiles_y);
    const int y0 = ty * TH, x0 = tx * TW;

    __syncthreads();  // the previous tile's MMAs are done with the halo
    // All of a batch's global loads are started before any is used, so a
    // thread waits for device memory once a batch, not once a chunk.
    constexpr int NB = sizeof(T) == 2 ? 12 : 6;  // 48 registers of loads
    static_assert(CHUNKS_PER_THREAD % NB == 0, "whole batches");
#pragma unroll
    for (int i0 = 0; i0 < CHUNKS_PER_THREAD; i0 += NB) {
      Chunk<T> raw[NB];
      bool inside[NB];
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const int p = (tid + (i0 + i) * NTHREADS) >> 3;
        const int hy = p / HW, hx = p - hy * HW;
        const int y = y0 + hy - 1, x = x0 + hx - 1;
        inside[i] = p < HH * HW && y >= 0 && y < H && x >= 0 && x < W;
        if (inside[i])
          ldg(raw[i], a.in + (((size_t)bi * H + y) * W + x) * C + chunk * 8);
      }
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const int p = (tid + (i0 + i) * NTHREADS) >> 3;
        if (p >= HH * HW) continue;
        uint4 u = make_uint4(0u, 0u, 0u, 0u);
        if (inside[i]) {
          if constexpr (PRO == PRO_NONE &&
                        std::is_same<T, __nv_bfloat16>::value) {
            u = raw[i].u;
          } else {
            float v[8];
            unpack(raw[i], v);
            if constexpr (PRO == PRO_AFFINE) {
#pragma unroll
              for (int k = 0; k < 8; ++k)
                v[k] = fmaxf(affine(ps[k], v[k], pb[k]), 0.f);
            }
            u = pack8(v);
          }
        }
        *reinterpret_cast<uint4*>(hs + swz(p, chunk * 8)) = u;
      }
    }
    __syncthreads();

    float acc[RPW][8][4];
#pragma unroll
    for (int m = 0; m < RPW; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][j][q] = 0.f;

    // ldmatrix lane roles: A rows (pixels) and k halves. B from HWIO
    // weights, rows = input channels: k runs down the rows (.trans: b_row
    // is k, b_nt the n-tile of a pair)
    const int lane = tid & 31;
    const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int a_kh = lane >> 4;
    const int b_row = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int b_nt = lane >> 4;
    const uint32_t ws_s = (uint32_t)__cvta_generic_to_shared(ws);
    const uint32_t hs_s = (uint32_t)__cvta_generic_to_shared(hs);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap - 3 * (tap / 3);
#pragma unroll
      for (int k0 = 0; k0 < C; k0 += 16) {
        uint32_t bf[8][2];
#pragma unroll
        for (int j = 0; j < 8; j += 2)
          ldsm_x4_trans(ws_s + swz(tap * C + k0 + b_row, 8 * (j + b_nt)),
                        bf[j][0], bf[j][1], bf[j + 1][0], bf[j + 1][1]);
#pragma unroll
        for (int m = 0; m < RPW; ++m) {
          const int p = (warp * RPW + m + dy) * HW + dx + a_row;
          uint32_t a0, a1, a2, a3;
          ldsm_x4(hs_s + swz(p, k0 + 8 * a_kh), a0, a1, a2, a3);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            mma_bf16(acc[m][j], a0, a1, a2, a3, bf[j][0], bf[j][1]);
        }
      }
    }

#pragma unroll
    for (int m = 0; m < RPW; ++m) {
      const int y = y0 + warp * RPW + m;
      if (y >= H) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int x = x0 + g + 8 * half;
        if (x >= W) continue;
        const size_t off = (((size_t)bi * H + y) * W + x) * C + 2 * t;
        T* dst = a.out + off;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float v0 = acc[m][j][2 * half], v1 = acc[m][j][2 * half + 1];
          if constexpr (EPI == EPI_AFFINE) {
            v0 = fmaxf(fmaf(es[j][0], v0, eb[j][0]), 0.f);
            v1 = fmaxf(fmaf(es[j][1], v1, eb[j][1]), 0.f);
          }
          store2(dst + 8 * j, v0, v1);
          if constexpr (EPI == EPI_STATS) {
            st0[j][0] += v0;
            st0[j][1] += v1;
            st1[j][0] = fmaf(v0, v0, st1[j][0]);
            st1[j][1] = fmaf(v1, v1, st1[j][1]);
          }
        }
      }
    }
  }

  if constexpr (SUMS) {
    // over the 8 row groups of a warp (lanes of equal t), then the warps
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float v0 = st0[j][q], v1 = st1[j][q];
#pragma unroll
        for (int sh = 4; sh < 32; sh <<= 1) {
          v0 += __shfl_xor_sync(0xffffffffu, v0, sh);
          v1 += __shfl_xor_sync(0xffffffffu, v1, sh);
        }
        if (g == 0) {
          red[warp][0][8 * j + 2 * t + q] = v0;
          red[warp][1][8 * j + 2 * t + q] = v1;
        }
      }
    }
    __syncthreads();
    const int k = tid >> 6, ch = tid & (C - 1);
    float sum = 0.f;
#pragma unroll
    for (int wi = 0; wi < NWARPS; ++wi) sum += red[wi][k][ch];
    a.partial[((size_t)blockIdx.x * 2 + k) * C + ch] = sum;
  }
}

// out[i] = sum over rows r of partial[r * n + i], in row order, in double.
__global__ void finish_sums(const float* __restrict__ partial, int rows, int n,
                            float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  double s = 0.0;
  for (int r = 0; r < rows; ++r) s += (double)partial[(size_t)r * n + i];
  out[i] = (float)s;
}

inline int finish(const float* partial, int rows, int n, float* out,
                  void* stream) {
  finish_sums<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(partial, rows,
                                                                n, out);
  return (int)cudaGetLastError();
}

// How many blocks of one kernel the current device holds at once, asked of
// the runtime once per kernel and device: the occupancy query and the
// shared-memory attribute cost the host more than the launch itself.
struct Resident {
  std::atomic<int> dev{-1};
  std::atomic<int> blocks{0};
};

// *grid = the persistent grid of `kern` over ntiles tiles: the resident
// blocks, at most max_blocks if that is positive (the rows of the caller's
// partials) and at most ntiles.
template <typename K>
int persistent_grid(K kern, int threads, int smem_bytes, long ntiles,
                    int max_blocks, Resident* cache, int* grid) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (cache->dev.load() != dev) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
    if (e != cudaSuccess) return (int)e;
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                      smem_bytes);
    if (e != cudaSuccess) return (int)e;
    cache->blocks.store(sms * (per_sm > 0 ? per_sm : 1));
    cache->dev.store(dev);
  }
  long n = cache->blocks.load();
  if (ntiles < n) n = ntiles;
  if (max_blocks > 0 && max_blocks < n) n = max_blocks;
  *grid = (int)n;
  return 0;
}

// Launches the conv body over (B, H, W); *grid gets the number of blocks,
// which is the number of rows written to a.partial.
template <typename T, int PRO, int EPI>
int launch_conv(ConvArgs<T> a, int max_blocks, int* grid, void* stream) {
  static Resident resident;  // one for each instantiation of the kernel
  auto kern = conv3x3_c64<T, PRO, EPI>;
  a.tiles_y = (a.H + TH - 1) / TH;
  a.tiles_x = (a.W + TW - 1) / TW;
  const long ntiles = (long)a.B * a.tiles_y * a.tiles_x;
  int rc = persistent_grid(kern, NTHREADS, SMEM_BYTES, ntiles, max_blocks,
                           &resident, grid);
  if (rc != 0 || *grid == 0) return rc;
  kern<<<*grid, NTHREADS, SMEM_BYTES, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace f2f
