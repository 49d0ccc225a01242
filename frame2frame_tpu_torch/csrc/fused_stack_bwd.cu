// Hopper (sm_90a) backward kernels of the DnCNN 64->64 mid layers.
//
// f2f_bwd_layer replaces frame2frame_tpu/ops/fused_stack.py: bwd_layer
// (_bwd_kernel): one layer's backward through ReLU, training-mode BatchNorm
// and the 3x3 convolution, in image space (NHWC, 64 channels). From the
// cotangent g of the layer's activation, its stored conv output z_i, the
// previous layer's stored output z_prev and eight per-channel vectors
// (BwdVec in conv3x3_c64.cuh) it gives
//   da_prev    = conv3x3(dz, flip(w)^T),  dz = A * (g * [s_i z_i + b_i > 0])
//                                              + B * z_i + C
//   dW         = sum_p a_prev[p + tap - 1] (x) dz[p],  f32,
//                a_prev = relu(s_p * z_prev + b_p)
//   stats_prev = sum(gp), sum(gp * zhat_prev),  gp = da_prev * [a_prev > 0],
//                from the f32 da_prev before it is rounded (not first_layer)
//
// It runs as two kernels and two finishing sums on one stream:
//   1. conv3x3_c64<PRO_DZ, EPI_BNBWD or EPI_NONE, WT> (conv3x3_c64.cuh): the
//      forward's convolution body with dz built in the prologue, zero outside
//      the image after the prologue, the flipped and transposed weights read
//      from the same HWIO array, and the previous layer's BN-backward sums
//      in the epilogue. It also writes dz once, as bf16, at the image pixels.
//   2. dw3x3_c64 below: the weight gradient, with pixels as the MMA's k.
// dz makes one round trip through device memory as bf16 (written by 1, read
// by 2) instead of being rebuilt from g and z_i in 2: the bytes are the same
// on a bf16 chain and fewer on an f32 chain, and 2 keeps one prologue. The
// TPU kernel's stored-operand option (emit_act) is not taken: 2 rebuilds
// a_prev from z_prev, which it must read anyway in place of a stored copy.
//
// Bound at 540p (1 x 540 x 960 x 64, bf16 chain): g, z_i and z_prev read and
// da_prev written once, 4 x 66.4 MB -> 79 us at 3.35 TB/s; dX and dW are
// 2 x 38.2 GFLOP -> 77 us at 989 TFLOP/s. With dz's round trip and z_prev's
// second read the two kernels move 7 x 66.4 MB -> 139 us.
//
// dw3x3_c64: a persistent block of 12 warps walks the same 8 x 16 pixel
// tiles. It stages a_prev's (8+2) x (16+2) halo tile (prologue affine + ReLU,
// zeros outside the image) and the tile's dz (zeros outside the image), both
// bf16 in swizzled 128-byte rows. dW is 9 taps x 4 blocks of 16 input
// channels x 64 output channels; a warp owns three of these 36 blocks in f32
// accumulators (96 registers a thread), summed over every tile of its
// thread block. Twelve warps, three on each of the multiprocessor's four
// schedulers, leave a thread 168 registers; nine warps of one tap each
// needed 128 accumulators a thread and spilled. One tile row of 16 pixels is
// one k16 step: the B fragment is dz, read with ldmatrix.trans as the forward
// reads its weights and shared by the warp's three blocks; the A fragment is
// a_prev^T, read with ldmatrix.trans from the halo row shifted by the
// block's tap. Each thread block writes its (9, 64, 64) partial once and
// finish_sums adds the partials in block order: no atomics, the same bits
// on every run.

#include "conv3x3_c64.cuh"

namespace {

using namespace f2f;

constexpr int DW_WARPS = 12;
constexpr int DW_THREADS = DW_WARPS * 32;
constexpr int DW_UNITS = 9 * 4 / DW_WARPS;  // (tap, 16 input channels) a warp
constexpr int DZ_BYTES = TH * TW * C * 2;
constexpr int DW_SMEM_BYTES = HALO_BYTES + DZ_BYTES;
constexpr int DW_HALO_CHUNKS = (HH * HW * 8 + DW_THREADS - 1) / DW_THREADS;
constexpr int DW_DZ_CHUNKS = (TH * TW * 8 + DW_THREADS - 1) / DW_THREADS;
constexpr int DW_N = 9 * C * C;

static_assert(DW_THREADS % 8 == 0, "a thread keeps one channel chunk");
static_assert(DW_UNITS * DW_WARPS == 36, "warps split the 36 blocks evenly");

// zprev: (B, H, W, 64) T; dz: (B, H, W, 64) bf16; vec: (8, 64), rows V_SP and
// V_BP used; partial: (blocks, 9, 64, 64) f32.
template <typename T>
__global__ void __launch_bounds__(DW_THREADS, 1)
dw3x3_c64(const T* __restrict__ zprev, const __nv_bfloat16* __restrict__ dz,
          const float* __restrict__ vec, float* __restrict__ partial, int B,
          int H, int W, int tiles_y, int tiles_x) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(16) float sp[C];  // a_prev's affine: scale,
  __shared__ __align__(16) float sb[C];  // shift
  unsigned char* hs = smem;
  unsigned char* ds = smem + HALO_BYTES;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int chunk = tid & 7;
  if (tid < C) {
    sp[tid] = vec[V_SP * C + tid];
    sb[tid] = vec[V_BP * C + tid];
  }

  // this warp's blocks: unit u = DW_UNITS * warp + i is tap u / 4, input
  // channels 16 * (u % 4) ..; acc[i][j] covers output channels 8 j .. 8 j + 7
  float acc[DW_UNITS][8][4];
#pragma unroll
  for (int i = 0; i < DW_UNITS; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  // ldmatrix.trans lane roles. A = a_prev^T from rows of pixels (k): matrix
  // (lane >> 3) holds k half (lane >> 4) and m half ((lane >> 3) & 1).
  // B = dz from rows of pixels (k): as the forward's weights.
  const int a_k = (lane & 7) + (lane >> 4) * 8;
  const int a_mh = (lane >> 3) & 1;
  const int b_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int b_nt = lane >> 4;
  const uint32_t hs_s = (uint32_t)__cvta_generic_to_shared(hs);
  const uint32_t ds_s = (uint32_t)__cvta_generic_to_shared(ds);
  // halo pixel of tile pixel (0, 0) under each unit's tap, and its channels
  int a_pix[DW_UNITS], a_ch[DW_UNITS];
#pragma unroll
  for (int i = 0; i < DW_UNITS; ++i) {
    const int u = DW_UNITS * warp + i;
    const int tap = u >> 2;
    a_pix[i] = (tap / 3) * HW + (tap - 3 * (tap / 3)) + a_k;
    a_ch[i] = 16 * (u & 3) + 8 * a_mh;
  }

  const long ntiles = (long)B * tiles_y * tiles_x;
  for (long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int tx = (int)(tile % tiles_x);
    const long r = tile / tiles_x;
    const int ty = (int)(r % tiles_y);
    const int bi = (int)(r / tiles_y);
    const int y0 = ty * TH, x0 = tx * TW;

    __syncthreads();  // the previous tile's MMAs are done with both tiles
    {
      Chunk<T> raw[DW_HALO_CHUNKS];
      uint4 dzraw[DW_DZ_CHUNKS];
      bool inside[DW_HALO_CHUNKS];
#pragma unroll
      for (int i = 0; i < DW_HALO_CHUNKS; ++i) {
        const int p = (tid + i * DW_THREADS) >> 3;
        const int hy = p / HW, hx = p - hy * HW;
        const int y = y0 + hy - 1, x = x0 + hx - 1;
        inside[i] = p < HH * HW && y >= 0 && y < H && x >= 0 && x < W;
        if (inside[i])
          ldg(raw[i], zprev + (((size_t)bi * H + y) * W + x) * C + chunk * 8);
      }
#pragma unroll
      for (int i = 0; i < DW_DZ_CHUNKS; ++i) {
        const int p = (tid + i * DW_THREADS) >> 3;
        const int py = p / TW, px = p - py * TW;
        const int y = y0 + py, x = x0 + px;
        dzraw[i] = make_uint4(0u, 0u, 0u, 0u);
        if (p < TH * TW && y < H && x < W)
          dzraw[i] = *reinterpret_cast<const uint4*>(
              dz + (((size_t)bi * H + y) * W + x) * C + chunk * 8);
      }
      float ps[8], pb[8];
      *reinterpret_cast<float4*>(ps) = reinterpret_cast<float4*>(sp)[2 * chunk];
      *reinterpret_cast<float4*>(ps + 4) =
          reinterpret_cast<float4*>(sp)[2 * chunk + 1];
      *reinterpret_cast<float4*>(pb) = reinterpret_cast<float4*>(sb)[2 * chunk];
      *reinterpret_cast<float4*>(pb + 4) =
          reinterpret_cast<float4*>(sb)[2 * chunk + 1];
#pragma unroll
      for (int i = 0; i < DW_HALO_CHUNKS; ++i) {
        const int p = (tid + i * DW_THREADS) >> 3;
        if (p >= HH * HW) continue;
        uint4 u = make_uint4(0u, 0u, 0u, 0u);
        if (inside[i]) {
          float v[8];
          unpack(raw[i], v);
#pragma unroll
          for (int k = 0; k < 8; ++k)
            v[k] = fmaxf(affine(ps[k], v[k], pb[k]), 0.f);
          u = pack8(v);
        }
        *reinterpret_cast<uint4*>(hs + swz(p, chunk * 8)) = u;
      }
#pragma unroll
      for (int i = 0; i < DW_DZ_CHUNKS; ++i) {
        const int p = (tid + i * DW_THREADS) >> 3;
        if (p < TH * TW)
          *reinterpret_cast<uint4*>(ds + swz(p, chunk * 8)) = dzraw[i];
      }
    }
    __syncthreads();

#pragma unroll
    for (int row = 0; row < TH; ++row) {
      uint32_t bf[8][2];
#pragma unroll
      for (int j = 0; j < 8; j += 2)
        ldsm_x4_trans(ds_s + swz(row * TW + b_row, 8 * (j + b_nt)), bf[j][0],
                      bf[j][1], bf[j + 1][0], bf[j + 1][1]);
#pragma unroll
      for (int i = 0; i < DW_UNITS; ++i) {
        uint32_t a0, a1, a2, a3;
        ldsm_x4_trans(hs_s + swz(row * HW + a_pix[i], a_ch[i]), a0, a1, a2,
                      a3);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mma_bf16(acc[i][j], a0, a1, a2, a3, bf[j][0], bf[j][1]);
      }
    }
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < DW_UNITS; ++i) {
    const int u = DW_UNITS * warp + i;
    float* dst = partial + ((size_t)blockIdx.x * 9 + (u >> 2)) * C * C +
                 16 * (u & 3) * C;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        store2(dst + (g + 8 * half) * C + 8 * j + 2 * t, acc[i][j][2 * half],
               acc[i][j][2 * half + 1]);
  }
}

template <typename T>
int backward(const void* g, const void* z_i, const void* z_prev, const void* w,
             const float* vec, int first_layer, void* da, void* dz, float* dw,
             float* stats_prev, float* partial_stats, float* partial_dw,
             int max_blocks, int B, int H, int W, void* stream) {
  ConvArgs<T> a = {};
  a.in = static_cast<const T*>(g);
  a.in2 = static_cast<const T*>(z_i);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.vec = vec;
  a.out = static_cast<T*>(da);
  a.dz = static_cast<__nv_bfloat16*>(dz);
  a.zprev = static_cast<const T*>(z_prev);
  a.partial = partial_stats;
  a.B = B;
  a.H = H;
  a.W = W;
  int grid = 0, rc;
  if (first_layer) {
    rc = launch_conv<T, PRO_DZ, EPI_NONE, true>(a, 0, &grid, stream);
  } else {
    rc = launch_conv<T, PRO_DZ, EPI_BNBWD, true>(a, max_blocks, &grid, stream);
    if (rc == 0) rc = finish(partial_stats, grid, 2 * C, stats_prev, stream);
  }
  if (rc != 0) return rc;

  static Resident resident;
  auto kern = dw3x3_c64<T>;
  const int tiles_y = (H + TH - 1) / TH, tiles_x = (W + TW - 1) / TW;
  rc = persistent_grid(kern, DW_THREADS, DW_SMEM_BYTES,
                       (long)B * tiles_y * tiles_x, max_blocks, &resident,
                       &grid);
  if (rc != 0) return rc;
  if (grid > 0) {
    kern<<<grid, DW_THREADS, DW_SMEM_BYTES, (cudaStream_t)stream>>>(
        static_cast<const T*>(z_prev), static_cast<const __nv_bfloat16*>(dz),
        vec, partial_dw, B, H, W, tiles_y, tiles_x);
    if ((rc = (int)cudaGetLastError()) != 0) return rc;
  }
  return finish(partial_dw, grid, DW_N, dw, stream);
}

}  // namespace

extern "C" {

// g, z_i, z_prev, da: (B, H, W, 64) bf16 or f32; w: (3, 3, 64, 64) HWIO bf16;
// vec: (8, 64) f32; dz: (B, H, W, 64) bf16 scratch; dw: (3, 3, 64, 64) f32
// out; stats_prev: (2, 64) f32 out, untouched when first_layer;
// partial_stats: (max_blocks, 2, 64) and partial_dw: (max_blocks, 9, 64, 64)
// f32 scratch. Returns a cudaError_t code: 0 on launches that were accepted.
int f2f_bwd_layer(const void* g, const void* z_i, const void* z_prev,
                  int is_f32, const void* w, const float* vec, int first_layer,
                  void* da, void* dz, float* dw, float* stats_prev,
                  float* partial_stats, float* partial_dw, int max_blocks,
                  int B, int H, int W, void* stream) {
  if (max_blocks <= 0) return (int)cudaErrorInvalidValue;
  return is_f32 ? backward<float>(g, z_i, z_prev, w, vec, first_layer, da, dz,
                                  dw, stats_prev, partial_stats, partial_dw,
                                  max_blocks, B, H, W, stream)
                : backward<__nv_bfloat16>(g, z_i, z_prev, w, vec, first_layer,
                                          da, dz, dw, stats_prev,
                                          partial_stats, partial_dw,
                                          max_blocks, B, H, W, stream);
}

const char* f2f_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
