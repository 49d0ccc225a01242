// The helpers that the port's tensor-core kernels share, for Hopper
// (sm_90a): the swizzled 128-byte-row layout of 64-channel pixels, ldmatrix,
// mma.sync, cp.async, the rounded affine, finish_sums and the persistent
// grid, and the 8 x 16 pixel tile with its (8+2) x (16+2) halo (the mid
// layers' forward and backward, fused_stack.cu and fused_stack_bwd.cu; the
// weight-gradient kernels of conv3x3.cu and fused_ends.cu). Last, what the
// mid layers' two wgmma bodies share: mbarriers, named barriers, TMA loads
// of 4-D tensor maps and the maps' encoder, wgmma and its shared-memory
// matrix descriptors.
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

#include <cuda.h>  // CUtensorMap; the encoder comes through the runtime
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

// --- Hopper: mbarriers, named barriers, TMA, wgmma --------------------------
// (the mid layers' forward, fused_stack.cu, and backward, fused_stack_bwd.cu)

// mbarriers and named barriers

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// The box of `map` at coordinates (c0, c1, c2, c3) into shared memory at
// dst; its bytes complete a transaction of bar. Out-of-range elements are
// zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Orders this thread's generic-proxy accesses of shared memory before the
// async proxy's (TMA, wgmma's descriptors) that follow.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --- wgmma -----------------------------------------------------------------

// Descriptors of operand tiles in the 128-byte swizzle: rows of 128 bytes,
// the swizzle following the absolute shared address, so that any 128-byte
// row may start a tile. K-major (desc_sw128): a row holds 64 k of one m or
// n, 8-row groups along m or n 1024 bytes apart. MN-major (desc_sw128_mn,
// the transposed B of wgmma): a row holds 64 m or n of one k, 8-row groups
// along k 1024 bytes apart, and the next 64 m or n `lbo` bytes on.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint64_t desc_sw128_mn(uint32_t saddr,
                                                  uint32_t lbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x 64 f32) += A (64 x 16 bf16, registers) * B (16 x 64 bf16, K-major
// in shared memory, descriptor). Each warp of the warpgroup gives A's rows
// 16 w .. 16 w + 15 in the fragment layout of mma.sync.m16n8k16's A, and
// holds the same rows of d in the layout of its C, n8 tile after n8 tile.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
}

// d (64 x 192 f32) += A (64 x 16 bf16, registers, as wgmma_rs) * B (16 x 192
// bf16, MN-major in shared memory: a row of the descriptor's tile is one k).
__device__ __forceinline__ void wgmma_rs_n192_mn(float (&d)[96],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),
        "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]),
        "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
}

// d (64 x 96 f32) += A (64 x 16 bf16, registers, as wgmma_rs) * B (16 x 96
// bf16, MN-major in shared memory: a row of the descriptor's tile is one k).
__device__ __forceinline__ void wgmma_rs_n96_mn(float (&d)[48],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
}

// Four 8 x 8 b16 matrices to shared memory from the fragment layout of
// mma.sync's C (register k: row lane / 4, columns 2 (lane % 4) + 0, 1 of
// matrix k); lane l gives the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void stsm_x4(uint32_t addr, uint32_t r0, uint32_t r1,
                                        uint32_t r2, uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
          addr),
      "r"(r0), "r"(r1), "r"(r2), "r"(r3)
      : "memory");
}

__device__ __forceinline__ uint32_t bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// --- tensor maps -----------------------------------------------------------

// cuTensorMapEncodeTiled, from the driver through the runtime (the library
// links no -lcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled lookup_encoder() {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  const cudaError_t e = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
  const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                cudaEnableDefault, &q);
#endif
  return e == cudaSuccess && q == cudaDriverEntryPointSuccess
             ? reinterpret_cast<EncodeTiled>(p)
             : nullptr;
}

inline EncodeTiled encoder() {
  static const EncodeTiled fn = lookup_encoder();  // once, thread-safe
  return fn;
}

// The map of rows [lo, hi) of a (B, H, W, 64) tensor, bf16 or f32, with a
// bh x bw pixel box: its row 0 is the tensor's row lo, and TMA fills the
// rows outside the window with zeros. Encoded at every launch: two
// encodings cost the host less than the measurement's spread around a
// wrapper call (36.4 against 37.8 us with maps reused; chip_smoke.py,
// NVIDIA H100 80GB HBM3, 700 W).
inline int tensor_map(const void* ptr, bool f32, int B, int H, int W, int lo,
                      int hi, int bw, int bh, CUtensorMap* map) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t px = f32 ? C * 4 : C * 2;  // bytes a pixel
  const cuuint64_t dims[4] = {C, (cuuint64_t)W, (cuuint64_t)(hi - lo),
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {px, (cuuint64_t)W * px,
                                 (cuuint64_t)H * W * px};
  const cuuint32_t box[4] = {C, (cuuint32_t)bw, (cuuint32_t)bh, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  // bf16 in the 128-byte swizzle; f32 (256 bytes a pixel) unswizzled
  const CUresult r = enc(
      map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4,
      const_cast<char*>(static_cast<const char*>(ptr)) + (size_t)lo * W * px,
      dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      f32 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace f2f
