// Hopper (sm_90a) kernels for the DnCNN 64->64 mid layers of the serving path.
//
// Two entry points share one 3x3 SAME convolution body over NHWC activations
// with 64 channels in and out (128 bytes a pixel in bf16):
//
//   f2f_fwd_layer       z = conv3x3(relu(s * z_prev + b))      prologue affine
//     replaces frame2frame_tpu/ops/fused_stack.py: fwd_layer (_fwd_kernel),
//     eval route emit_stats=False, with or without stack=.
//   f2f_fwd_layer_eval  a = relu(s * conv3x3(a_prev, w) + b)    epilogue affine
//     replaces frame2frame_tpu/ops/fused_stack.py: fwd_layer_eval
//     (_fwd_eval_kernel). The TPU kernel folds the BN scale s into its
//     weights. Rounding w * s to bf16 moved served DnCNN-17 pixels by up to
//     0.045 against the f32 forward (540p, H100, chip_smoke.py), so here s
//     scales the f32 accumulator in the epilogue instead, at one FMA an
//     output.
//
// Zero padding applies to the operand AFTER the prologue: pixels outside the
// image are written as zeros into the halo tile, exactly as the TPU kernel
// masks the activation at pad positions. Frames of a batch are isolated by
// the same per-image padding, so no separator rows exist.
//
// Bound at 540p (1 x 540 x 960 x 64, bf16 storage), per layer and frame:
//   operations 2 * 540*960 * 64*64*9 = 38.2 GFLOP -> 39 us at 989 TFLOP/s;
//   bytes      2 * 540*960*64 * 2    = 132.7 MB  -> 40 us at 3.35 TB/s.
// The layer sits near balance, so the design keeps both sides simple and
// whole: every input byte is read once per tile plus a one-pixel halo, every
// output byte written once, and the 73.7 KB of bf16 weights are loaded into
// shared memory once per persistent block rather than once per tile.
//
// Design (first version: right and simple; wgmma and TMA come later):
//   * a persistent block of 4 warps walks output tiles of 8 x 16 pixels x 64
//     channels of one image; each warp owns 2 tile rows (two m16 MMA tiles);
//   * the (8+2) x (16+2) x 64 halo tile is staged in shared memory as bf16
//     after the prologue, zeros outside the image;
//   * each thread issues all global loads of a batch of halo chunks before
//     it converts and stores any, so it waits on device memory once a batch;
//   * nine taps (unrolled) x four k16 steps of mma.sync.m16n8k16 (bf16 in,
//     f32 accumulate), fragments loaded with ldmatrix.x4 from the halo tile
//     and the weights held in shared memory;
//   * both shared tiles use 128-byte rows with the 16-byte chunk index XORed
//     by (row & 7), so every ldmatrix phase and every staging store is free
//     of bank conflicts;
//   * the epilogue stores bf16 or f32 straight from the accumulators.
// This form stages every MMA operand from shared memory through registers;
// wgmma, which reads its operands from shared memory itself, and TMA are the
// next steps.
// MMA operands are rounded to bf16 also for the f32 chain, as the TPU's
// matrix unit rounds them at default precision.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

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

// Byte offset of channel ch of row `row` in a swizzled 128-byte-row tile.
__device__ __forceinline__ int swz(int row, int ch) {
  return row * 128 + (((ch >> 3) ^ (row & 7)) << 4) + ((ch & 7) << 1);
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

// Four 8x8 b16 matrices from shared memory; lane l gives the address of
// row (l & 7) of matrix (l >> 3). The .trans form hands each lane a column
// pair instead of a row pair: the MMA B fragment of a row-major K x N tile.
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

__device__ __forceinline__ void mma_bf16(float c[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// in/out: (B, H, W, 64) contiguous, T = bf16 or float.
// w: (3, 3, 64, 64) HWIO bf16 = (9 * 64, 64) rows tap*64 + i (tap = 3*dy+dx)
//    of the 64 output channels.
// s, b: 64 floats each, applied by exactly one of the two flags.
// AFFINE: operand = relu(s * in + b), else operand = in.
// EPILOGUE: out = relu(s * acc + b), else out = acc.
template <typename T, bool AFFINE, bool EPILOGUE>
__global__ void __launch_bounds__(NTHREADS, 2)
conv3x3_c64(const T* __restrict__ in, const __nv_bfloat16* __restrict__ w,
            const float* __restrict__ s, const float* __restrict__ b,
            T* __restrict__ out, int B, int H, int W, int tiles_y,
            int tiles_x) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ws = smem;
  unsigned char* hs = smem + W_BYTES;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;  // MMA group: fragment row / column
  const int t = tid & 3;          // thread in group: fragment k pair

  for (int idx = tid; idx < 9 * C * 8; idx += NTHREADS) {
    uint4 u = reinterpret_cast<const uint4*>(w)[idx];
    *reinterpret_cast<uint4*>(ws + swz(idx >> 3, (idx & 7) * 8)) = u;
  }

  // NTHREADS % 8 == 0: a thread stages the same channel chunk of every pixel
  const int chunk = tid & 7;
  float ps[8], pb[8];
  if constexpr (AFFINE) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      ps[i] = s[chunk * 8 + i];
      pb[i] = b[chunk * 8 + i];
    }
  }
  float es[8][2], eb[8][2];
  if constexpr (EPILOGUE) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        es[j][q] = s[8 * j + 2 * t + q];
        eb[j][q] = b[8 * j + 2 * t + q];
      }
    }
  }

  const long ntiles = (long)B * tiles_y * tiles_x;
  for (long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int tx = (int)(tile % tiles_x);
    const long r = tile / tiles_x;
    const int ty = (int)(r % tiles_y);
    const int bi = (int)(r / tiles_y);
    const int y0 = ty * TH, x0 = tx * TW;

    __syncthreads();  // the previous tile's MMAs are done with the halo
    // All of a batch's global loads are issued before any is used, so a
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
          ldg(raw[i], in + (((size_t)bi * H + y) * W + x) * C + chunk * 8);
      }
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const int p = (tid + (i0 + i) * NTHREADS) >> 3;
        if (p >= HH * HW) continue;
        uint4 u = make_uint4(0u, 0u, 0u, 0u);
        if (inside[i]) {
          if constexpr (!AFFINE && std::is_same<T, __nv_bfloat16>::value) {
            u = raw[i].u;
          } else {
            float v[8];
            unpack(raw[i], v);
            if constexpr (AFFINE) {
#pragma unroll
              for (int k = 0; k < 8; ++k)
                v[k] = fmaxf(fmaf(ps[k], v[k], pb[k]), 0.f);
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

    // ldmatrix lane roles: A rows (pixels) and k halves; B rows (input
    // channels, k) and which n-tile of a pair
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
        T* dst = out + (((size_t)bi * H + y) * W + x) * C + 2 * t;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float v0 = acc[m][j][2 * half], v1 = acc[m][j][2 * half + 1];
          if constexpr (EPILOGUE) {
            v0 = fmaxf(fmaf(es[j][0], v0, eb[j][0]), 0.f);
            v1 = fmaxf(fmaf(es[j][1], v1, eb[j][1]), 0.f);
          }
          store2(dst + 8 * j, v0, v1);
        }
      }
    }
  }
}

template <typename T, bool AFFINE, bool EPILOGUE>
int launch(const void* in, const void* w, const float* s, const float* b,
           void* out, int B, int H, int W, void* stream) {
  auto kern = conv3x3_c64<T, AFFINE, EPILOGUE>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NTHREADS,
                                                    SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const int tiles_y = (H + TH - 1) / TH, tiles_x = (W + TW - 1) / TW;
  const long ntiles = (long)B * tiles_y * tiles_x;
  const long resident = (long)sms * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(ntiles < resident ? ntiles : resident);
  if (grid == 0) return 0;
  kern<<<grid, NTHREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      static_cast<const T*>(in), static_cast<const __nv_bfloat16*>(w), s, b,
      static_cast<T*>(out), B, H, W, tiles_y, tiles_x);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t code: 0 on a launch that was accepted.
int f2f_fwd_layer(const void* z_prev, int is_f32, const void* w,
                  const float* s, const float* b, void* z, int B, int H, int W,
                  void* stream) {
  return is_f32
             ? launch<float, true, false>(z_prev, w, s, b, z, B, H, W, stream)
             : launch<__nv_bfloat16, true, false>(z_prev, w, s, b, z, B, H, W,
                                                  stream);
}

int f2f_fwd_layer_eval(const void* a_prev, int is_f32, const void* w,
                       const float* s, const float* b, void* a, int B, int H,
                       int W, void* stream) {
  return is_f32
             ? launch<float, false, true>(a_prev, w, s, b, a, B, H, W, stream)
             : launch<__nv_bfloat16, false, true>(a_prev, w, s, b, a, B, H, W,
                                                  stream);
}

const char* f2f_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
