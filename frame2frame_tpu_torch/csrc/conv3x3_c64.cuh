// The helpers that the port's tensor-core kernels share, for Hopper
// (sm_90a): the swizzled 128-byte-row layout of 64-channel pixels, ldmatrix,
// mma.sync, cp.async, the rounded affine, finish_sums and the persistent
// grid, and the 8 x 16 pixel tile with its (8+2) x (16+2) halo of the
// backward and weight-gradient kernels (fused_stack_bwd.cu, conv3x3.cu,
// fused_ends.cu). The forward convolution of the mid layers has its own
// tile and its own body, in fused_stack.cu.
//
// Every affine whose sign decides a ReLU or a ReLU mask is computed as a
// rounded product plus a rounded sum (affine() below, no fused multiply-add),
// in the forward prologue, the backward kernel's masks and the plain PyTorch
// versions alike, so all of them agree on every pixel.
//
// Per-channel sums are reduced without atomics: each persistent block writes
// one row of partials, and finish_sums adds the rows in block order. The
// same inputs give the same bits on every run.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace f2f {

constexpr int C = 64;                 // channels in and out
constexpr int TH = 8;                 // tile rows
constexpr int TW = 16;                // tile columns: one m16 MMA tile
constexpr int HH = TH + 2;            // halo tile rows
constexpr int HW = TW + 2;            // halo tile columns
constexpr int W_BYTES = 9 * C * C * 2;
constexpr int HALO_BYTES = HH * HW * C * 2;

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

// Four 8x8 b16 matrices to shared memory, transposed: register k holds row
// lane / 4, columns 2 (lane % 4) + {0, 1} of matrix k (mma.sync's C layout),
// stored as column lane / 4 of rows 2 (lane % 4) + {0, 1}; lane l gives the
// address of stored row l % 8 of matrix l / 8.
__device__ __forceinline__ void stsm_x4_trans(uint32_t addr, uint32_t r0,
                                              uint32_t r1, uint32_t r2,
                                              uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1,%2,%3,%4};\n"
      ::"r"(addr), "r"(r0), "r"(r1), "r"(r2), "r"(r3)
      : "memory");
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

// The same for 4 bytes (through L1).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Whether row y lies in the row window [lo, hi): the one test of row
// validity of the kernels. A whole image is the window [0, H); a slab of a
// frame split by rows (its body and one halo row above and below) has the
// window of its rows that are rows of the frame, and the window of its body
// rows among them, where a sum counts each row of the frame once.
__device__ __forceinline__ bool row_in(int y, int lo, int hi) {
  return y >= lo && y < hi;
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
// shared-memory attribute cost the host more than the launch itself. One
// slot a device, 0 until asked (the slabs of a frame split over several
// cards alternate devices launch by launch); every Resident is static, so
// its slots start at zero.
constexpr int kMaxDevices = 64;
struct Resident {
  std::atomic<int> blocks[kMaxDevices];
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
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  long n = cache->blocks[dev].load();
  if (n == 0) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
    if (e != cudaSuccess) return (int)e;
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                      smem_bytes);
    if (e != cudaSuccess) return (int)e;
    n = sms * (per_sm > 0 ? per_sm : 1);
    cache->blocks[dev].store((int)n);
  }
  if (ntiles < n) n = ntiles;
  if (max_blocks > 0 && max_blocks < n) n = max_blocks;
  *grid = (int)n;
  return 0;
}

}  // namespace f2f
