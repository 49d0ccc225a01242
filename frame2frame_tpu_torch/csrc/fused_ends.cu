// Hopper (sm_90a) kernels for the two ends of the DnCNN and its loss in the
// online fine-tune: the 1 -> 64 input convolution, the 64 -> 1 output
// convolution with the last BatchNorm affine + ReLU before it and the masked
// summed L1 loss behind it, and their backward passes.
//
//   f2f_first_conv     z1 = conv3x3(x, w_in), raw (the ReLU is the first mid
//     layer's prologue). Replaces frame2frame_tpu/ops/fused_ends.py:
//     first_conv (_first_conv_kernel).
//   f2f_last_loss_fwd  a = relu(s * z_L + b); noise = conv3x3(a, w_out) in
//     f32; loss = sum |aux_c - aux_m * noise|. Replaces last_loss_fwd
//     (_last_fwd_kernel). The stored activation of the TPU kernel is not
//     emitted: the backward rebuilds a from z_L. Its own tile and body, on
//     the tensor cores: see last_fwd_k.
//   f2f_last_loss_bwd  e = aux_m * sign(aux_c - aux_m * noise), sign(0) = 0,
//     dL/dnoise = -e; g_L = conv3x3^T(-e, w_out), the cotangent of a;
//     dW_out[t][c] = sum_p a[p + t][c] * -e[p]; and the last BatchNorm's
//     backward sums sum(gp), sum(gp * zhat_L), gp = g_L * [s * z_L + b > 0],
//     from the f32 g_L before it is rounded. Replaces last_loss_bwd
//     (_last_bwd_kernel); g_L and dW_out leave with their final signs.
//   f2f_first_dw       dW_in[t][c] = sum_p x[p + t] * da0[p][c] * [z1 > 0].
//     Replaces first_dw (_first_dw_kernel).
//
// Images are (H, W) row-major without padding, activations (1, H, W, 64)
// NHWC, T = bf16 or float (the chain's type); aux_c, aux_m and noise are
// f32. The lane embedding, the odd slab and the column masks of the TPU
// kernels exist to feed a 128 x 128 matrix unit and have no counterpart.
// Zero SAME padding applies to x, to a (after the affine and the ReLU) and to
// e. Dot operands are rounded to bf16 (x, a, e, da0 * [z1 > 0], the weights),
// as the TPU's matrix unit takes them, and accumulated in f32.
//
// Bound at 540 x 960: K or N of these convolutions is 1, 0.6 GFLOP a
// convolution, nothing against the bytes: one 64-channel activation is
// 66.4 MB in bf16 (20 us at 3.35 TB/s). first_conv writes one, last_loss_fwd
// reads one, last_loss_bwd reads one and writes one, first_dw reads two.
// So all four are bound by bytes: every activation byte read once with
// 16-byte loads, several loads in flight a thread. first_conv and first_dw
// multiply on FMAs, with operands in registers and shared memory (a thread
// keeps one 8-channel chunk of a pixel); last_loss_fwd's and last_loss_bwd's
// products go to the tensor cores, where their FMAs left them bound by their
// own instructions (below).
//
// first_conv, first_dw: a persistent block of 256 threads walks tiles of
// 8 x 32 pixels: thread = (pixel column, 8-channel chunk), looping over the
// tile's rows. The single-channel operand of a tile (x) lies in shared
// memory with a one-pixel halo, zeros outside the image; its rows are not
// 16-byte aligned for odd W, so it is loaded by scalars.
//
// last_loss_fwd turns the convolution inside out: each pixel of the halo
// tile gives its nine tap products q[p][t] = sum_c a[p][c] * w[t][c], and an
// output pixel gathers one product from each of its nine neighbours. On FMAs
// (8 x 32 tiles, eight threads a pixel, 72 FMAs, 27 shuffles, 9 selects a
// pixel and chunk, the weights in registers so one block a multiprocessor)
// it waited on its own instructions: 0.131 ms at 540 x 960 on an H100, 6x
// its byte bound. The 64 -> 9 product of a pixel is a tensor core's shape:
// q = A (16 halo pixels x 64) . W (64 x 16: taps 0-8, seven zero columns),
// mma.sync m16n8k16 bf16 with f32 sums, two n8 fragments, four k steps.
// Each lane feeds the A fragment from its own 32 (bf16) or 64 (f32)
// contiguous bytes of a pixel: lane (g, t) of a group of 16 halo pixels
// reads channels 16t .. 16t + 15 of pixels g and g + 8 with 16-byte loads
// straight into registers, and the k index of the product is that
// permutation of the channels (k = 16 kk + 2t + {0, 1, 8, 9} is channel
// 16t + 4kk + {0, 1, 2, 3}); the weights' B fragments, built once a block,
// take the same permutation. The affine, the ReLU and the bf16 rounding are
// applied in registers, and a pixel outside the image gives a = 0 by its
// position, not relu(b). Tiles of 16 x 64 outputs (an 18 x 66 halo, 1.16x
// the activation where 8 x 32 read 1.33x); the products go to shared memory
// tap-major, a tap's row 1220 floats apart (4 banks a tap apart: the
// fragment stores are free of conflicts), and each output adds its nine in
// tap order. Two blocks a multiprocessor; a warp keeps two groups' loads in
// flight on the bf16 chain, one on the f32 chain (the same bytes). 0.044 ms
// at 540 x 960 bf16 on an H100, 2.0x its byte bound; three groups in flight,
// three blocks a multiprocessor and 16 x 32 tiles were no faster.
//
// last_loss_bwd puts both of its products on the tensor cores (see
// last_bwd_k): g^T = W^T . E^T and dW^T = a^T . E, with E the nine -e taps
// of 16 pixels. On FMAs (8 x 32 tiles, 144 FMAs a pixel and chunk, 234
// registers, one block a multiprocessor, the -e halo staged between two
// barriers before a tile's z loads) it took 0.136 ms at 540 x 960 bf16 on
// an H100, 3.3x its byte bound. Now a block of 16 warps a multiprocessor
// streams units of 16 pixels, each warp through its own two-unit cp.async
// ring with no block barrier; z is read once, g written once through
// stmatrix and 16-byte stores. What moved the time, on the card: the grid
// walking the image as one front (each warp every n-th unit, not a
// contiguous share), a unit body that ptxas inlines (a lambda instantiated
// twice became a call, about an eighth slower) and a finishing sum with its
// loads in flight (finish_rows). Deeper rings, wider units, bulk copies and
// L2 prefetch hints were no faster.
//
// Sums over the pixels (loss, dW, BatchNorm sums) are reduced without
// atomics: a thread keeps its sums over all tiles of its block, the block
// adds them by shuffles and shared memory in a fixed order into one row of
// partials, and finish_sums (finish_rows for last_loss_bwd) adds the rows in
// a fixed order in double: the same inputs give the same bits on every run.

#include "conv3x3_c64.cuh"

namespace {

using namespace f2f;

constexpr int ETH = 8;             // tile rows (not last_loss_fwd's)
constexpr int ETW = 32;            // tile columns
constexpr int EHH = ETH + 2;       // halo tile rows
constexpr int EHW = ETW + 2;       // halo tile columns
constexpr int ETHREADS = ETW * 8;  // one thread a pixel column and chunk
constexpr int EWARPS = ETHREADS / 32;
constexpr int BWD_SUMS = 11;       // last_loss_bwd: 9 dW taps, 2 BN sums
constexpr unsigned FULL = 0xffffffffu;


__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float ldf(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ float ldf(const float* p) { return *p; }

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[8]) {
  *reinterpret_cast<uint4*>(p) = pack8(v);
}

__device__ __forceinline__ void store8(float* p, const float v[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// tile[hy * EHW + hx] = value(y * W + x) at image pixel (y0 + hy - 1,
// x0 + hx - 1), 0 outside the image.
template <typename F>
__device__ __forceinline__ void stage_halo(float* tile, int y0, int x0, int H,
                                           int W, F value) {
  for (int i = threadIdx.x; i < EHH * EHW; i += ETHREADS) {
    const int hy = i / EHW, hx = i - hy * EHW;
    const int y = y0 + hy - 1, x = x0 + hx - 1;
    const bool inside = y >= 0 && y < H && x >= 0 && x < W;
    tile[i] = inside ? value((size_t)y * W + x) : 0.f;
  }
}

// v[i][k]: this thread's sum of item i for channel 8 * (tid & 7) + k.
// row[i * C + ch] = the sum over the block's threads, added in a fixed
// order: lanes of a warp by shuffles, warps in order. red: EWARPS * NV * C.
template <int NV>
__device__ __forceinline__ void block_sums(float (&v)[NV][8], float* red,
                                           float* row) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = tid & 7;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float s = v[i][k];
      s += __shfl_xor_sync(FULL, s, 8);
      s += __shfl_xor_sync(FULL, s, 16);
      if (lane < 8) red[(warp * NV + i) * C + chunk * 8 + k] = s;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < NV * C; idx += ETHREADS) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < EWARPS; ++w) s += red[w * NV * C + idx];
    row[idx] = s;
  }
}

// x: (H, W) T; w: (9, 64) f32; z: (H, W, 64) T.
template <typename T>
__global__ void __launch_bounds__(ETHREADS)
first_conv_k(const T* __restrict__ x, const float* __restrict__ w,
             T* __restrict__ z, int H, int W, int tiles_x, int ntiles) {
  __shared__ float xs[EHH * EHW];
  const int tid = threadIdx.x, chunk = tid & 7, px = tid >> 3;
  float wr[9][8];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int k = 0; k < 8; ++k) wr[t][k] = round_bf16(w[t * C + chunk * 8 + k]);

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int y0 = (tile / tiles_x) * ETH, x0 = (tile % tiles_x) * ETW;
    __syncthreads();  // the previous tile's rows are done with xs
    stage_halo(xs, y0, x0, H, W,
               [&](size_t i) { return round_bf16(ldf(x + i)); });
    __syncthreads();
    const int xx = x0 + px;
    if (xx >= W) continue;
#pragma unroll
    for (int py = 0; py < ETH; ++py) {
      const int y = y0 + py;
      if (y >= H) break;
      float acc[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[k] = 0.f;
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const float v = xs[(py + t / 3) * EHW + px + t % 3];
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[k] = fmaf(v, wr[t][k], acc[k]);
      }
      store8(z + ((size_t)y * W + xx) * C + chunk * 8, acc);
    }
  }
}

// last_loss_fwd's tile: 16 x 64 outputs, an 18 x 66 halo in 75 groups of 16
// pixels (the last one part padding), eight warps
constexpr int LTH = 16, LTW = 64;
constexpr int LHW = LTW + 2;
constexpr int LHALO = (LTH + 2) * LHW;
constexpr int LGROUPS = (LHALO + 15) / 16;
constexpr int LQS = 1220;  // a tap's row of products: >= 16 * LGROUPS, 4 mod 32
constexpr int LWARPS = ETHREADS / 32;

static_assert(LQS >= 16 * LGROUPS && LQS % 32 == 4, "qs rows");
static_assert(LTH * LTW % ETHREADS == 0, "whole outputs a thread");

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// z: (H, W, 64) T; s, b: 64 f32; w: (9, 64) f32; aux_c, aux_m, noise: (H, W)
// f32; partial: one f32 a block. Tiles of LTH x LTW outputs.
template <typename T>
__global__ void __launch_bounds__(ETHREADS, 2)
last_fwd_k(const T* __restrict__ z, const float* __restrict__ s,
           const float* __restrict__ b, const float* __restrict__ w,
           const float* __restrict__ aux_c, const float* __restrict__ aux_m,
           float* __restrict__ noise, float* __restrict__ partial, int H,
           int W, int tiles_x, int ntiles) {
  // qs[t * LQS + p]: halo pixel p's product with tap t
  __shared__ float qs[9 * LQS];
  __shared__ float red[LWARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;  // the fragments' row and column
  const int ch0 = 16 * t4;                 // this lane's channels
  float ps[16], pb[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    ps[k] = s[ch0 + k];
    pb[k] = b[ch0 + k];
  }
  // B fragments of W (k permuted as the A fragments): n fragment nf holds
  // taps 8 nf .. 8 nf + 7; column g of it is tap 8 nf + g, zero past tap 8
  uint32_t bw[4][2][2];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int nf = 0; nf < 2; ++nf) {
      const int tap = 8 * nf + g;
      const float* wt = w + tap * C + ch0 + 4 * kk;
      bw[kk][nf][0] = tap < 9 ? pack_bf16x2(wt[0], wt[1]) : 0u;
      bw[kk][nf][1] = tap < 9 ? pack_bf16x2(wt[2], wt[3]) : 0u;
    }
  float loss = 0.f;

  constexpr int NB = sizeof(T) == 2 ? 2 : 1;  // groups in flight a warp
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int y0 = (tile / tiles_x) * LTH, x0 = (tile % tiles_x) * LTW;
    __syncthreads();  // the previous tile's gather is done with qs
    for (int g0 = warp; g0 < LGROUPS; g0 += LWARPS * NB) {
      Chunk<T> raw[NB][2][2];  // group, pixel g / g + 8, channel half
      bool inside[NB][2];
#pragma unroll
      for (int i = 0; i < NB; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = (g0 + i * LWARPS) * 16 + g + 8 * h;
          const int hy = p / LHW, hx = p - hy * LHW;
          const int y = y0 + hy - 1, x = x0 + hx - 1;
          inside[i][h] = g0 + i * LWARPS < LGROUPS && p < LHALO && y >= 0 &&
                         y < H && x >= 0 && x < W;
          if (inside[i][h]) {
            const T* src = z + ((size_t)y * W + x) * C + ch0;
            ldg(raw[i][h][0], src);
            ldg(raw[i][h][1], src + 8);
          }
        }
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const int grp = g0 + i * LWARPS;
        if (grp >= LGROUPS) break;
        // a = bf16(relu(s z + b)) of pixels g and g + 8 as A fragments; zero
        // SAME padding of a: a pixel outside the image gives 0, not relu(b)
        uint32_t af[2][8];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v[16];
          unpack(raw[i][h][0], v);
          unpack(raw[i][h][1], v + 8);
#pragma unroll
          for (int k = 0; k < 16; ++k)
            v[k] = inside[i][h] ? fmaxf(affine(ps[k], v[k], pb[k]), 0.f) : 0.f;
#pragma unroll
          for (int k = 0; k < 8; ++k)
            af[h][k] = pack_bf16x2(v[2 * k], v[2 * k + 1]);
        }
        float q0[4] = {0.f, 0.f, 0.f, 0.f}, q1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          // rows g, g + 8; k = 2 t4 + {0, 1} and 2 t4 + {8, 9} of step kk
          const uint32_t a0 = af[0][2 * kk], a1 = af[1][2 * kk];
          const uint32_t a2 = af[0][2 * kk + 1], a3 = af[1][2 * kk + 1];
          mma_bf16(q0, a0, a1, a2, a3, bw[kk][0][0], bw[kk][0][1]);
          mma_bf16(q1, a0, a1, a2, a3, bw[kk][1][0], bw[kk][1][1]);
        }
        const int p = grp * 16 + g;
        qs[(2 * t4) * LQS + p] = q0[0];
        qs[(2 * t4 + 1) * LQS + p] = q0[1];
        qs[(2 * t4) * LQS + p + 8] = q0[2];
        qs[(2 * t4 + 1) * LQS + p + 8] = q0[3];
        if (t4 == 0) {
          qs[8 * LQS + p] = q1[0];
          qs[8 * LQS + p + 8] = q1[2];
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int o = tid; o < LTH * LTW; o += ETHREADS) {
      const int py = o / LTW, px = o - py * LTW;
      const int y = y0 + py, x = x0 + px;
      if (y < H && x < W) {
        float n = 0.f;
#pragma unroll
        for (int t = 0; t < 9; ++t)
          n += qs[t * LQS + (py + t / 3) * LHW + px + t % 3];
        const size_t i = (size_t)y * W + x;
        noise[i] = n;
        loss += fabsf(__fsub_rn(aux_c[i], __fmul_rn(aux_m[i], n)));
      }
    }
  }

#pragma unroll
  for (int sh = 16; sh > 0; sh >>= 1) loss += __shfl_xor_sync(FULL, loss, sh);
  if (lane == 0) red[warp] = loss;
  __syncthreads();
  if (tid == 0) {
    float sum = 0.f;
#pragma unroll
    for (int wi = 0; wi < LWARPS; ++wi) sum += red[wi];
    partial[blockIdx.x] = sum;
  }
}

// last_loss_bwd's stream. A unit is 16 pixels of one image row (2 KB of z
// bf16, 4 KB f32); warp i of the grid's n takes units i, i + n, i + 2n, ...
// in row-major order, so the grid walks the image as one front. Each warp
// keeps a ring of BSTAGES units in shared memory, filled by cp.async: z
// (16-byte copies) and the unit's noise, aux_c and aux_m with a one-pixel
// halo (3 rows of 18, 4-byte copies, zeros outside the image), on which -e
// is computed once a halo pixel. In the registers of a lane (gq = lane / 4,
// t4 = lane % 4) a unit covers channels c = 16 mf + gq + 8 h (mf < 4,
// h < 2) at pixels 2 t4 + e + 8 jj (e, jj < 2):
//   g^T (64 x 8 pixels) = W^T (64 x 16 taps) . E^T (16 taps x 8 pixels)
//   dW^T (64 x 16 taps) = a^T (64 x 16 pixels) . E (16 pixels x 16 taps)
// with E[p][t] = -e at p - off_t, taps 9-15 zero. The C fragment of the
// first and the A fragment of the second hold the same (channel, pixel)
// places, so one read of z gives a, the ReLU mask and zhat where g is.
constexpr int BWARPS = 16;              // one block of 16 warps a multiprocessor
constexpr int BTHREADS = 32 * BWARPS;
constexpr int BSTAGES = 2;              // units in a warp's ring
constexpr int UW = 16;                  // pixels a unit
constexpr int HWU = UW + 2;             // halo columns
constexpr int BW_FRAG = 4 * 32 * 16;    // bytes of W^T's A fragments
constexpr int BVEC = C * 16;            // bytes of (s, b, rstd, -mean rstd)

template <typename T>
struct BwdUnit {
  static constexpr bool BF16 = sizeof(T) == 2;
  static constexpr int CHUNKS = C * (int)sizeof(T) / 16;  // a pixel's
  static constexpr int ROW = BF16 ? 128 : 272;         // bytes a staged pixel
  static constexpr int ZBYTES = UW * ROW;
  static constexpr int STAGE = (ZBYTES + 9 * HWU * 4 + 127) / 128 * 128;
  static constexpr int SMEM = BW_FRAG + BVEC + BWARPS * BSTAGES * STAGE;
  // Byte offset of 16-byte chunk cc of staged pixel px. bf16: 128-byte rows,
  // chunks swizzled by px % 8, so the eight rows of an ldmatrix or stmatrix
  // lie on distinct banks; f32: 272-byte rows, so the 32 lanes' scalar
  // reads of a fragment lie on distinct banks.
  __device__ static int at(int px, int cc) {
    return BF16 ? px * ROW + ((cc ^ (px & 7)) << 4) : px * ROW + cc * 16;
  }
};

static_assert(BWD_SUMS * C * 4 <= BSTAGES * BwdUnit<__nv_bfloat16>::STAGE,
              "a warp's sums fit its ring");

// noise, aux_c, aux_m: (H, W) f32; z, g: (H, W, 64) T; w: (9, 64) f32;
// vec: (4, 64) f32 = s_L, b_L, rstd_L, -mean_L * rstd_L;
// partial: (blocks, 11, 64) f32 = nine taps of dW_out, sum gp, sum gp zhat.
template <typename T>
__global__ void __launch_bounds__(BTHREADS, 1)
last_bwd_k(const float* __restrict__ noise, const float* __restrict__ aux_c,
           const float* __restrict__ aux_m, const T* __restrict__ z,
           const float* __restrict__ w, const float* __restrict__ vec,
           T* __restrict__ g, float* __restrict__ partial, int H, int W) {
  using U = BwdUnit<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t4 = lane & 3;
  uint4* wfrag = reinterpret_cast<uint4*>(smem);
  float4* vecs = reinterpret_cast<float4*>(smem + BW_FRAG);
  unsigned char* ring = smem + BW_FRAG + BVEC + warp * BSTAGES * U::STAGE;
  const uint32_t ring_s = (uint32_t)__cvta_generic_to_shared(ring);
  if (tid < 128) {
    // A fragments of W^T, rows c and c + 8 (c = 16 mf + gq), k = tap
    const int c = 16 * warp + gq;
    auto wt = [&](int t, int ch) { return t < 9 ? w[t * C + ch] : 0.f; };
    wfrag[tid] = make_uint4(pack_bf16x2(wt(2 * t4, c), wt(2 * t4 + 1, c)),
                            pack_bf16x2(wt(2 * t4, c + 8), wt(2 * t4 + 1, c + 8)),
                            pack_bf16x2(wt(2 * t4 + 8, c), wt(2 * t4 + 9, c)),
                            pack_bf16x2(wt(2 * t4 + 8, c + 8),
                                        wt(2 * t4 + 9, c + 8)));
  } else if (tid < 128 + C) {
    const int c = tid - 128;
    vecs[c] = make_float4(vec[c], vec[C + c], vec[2 * C + c], vec[3 * C + c]);
  }
  // -e at pixel p of a unit minus off_t: neh[toff(t) + p], neh the unit's
  // 3 x HWU halo (row 0 image row y - 1, column 0 image column x0 - 1)
  auto toff = [](int t) { return (2 - t / 3) * HWU + 2 - t % 3; };
  const int oa = toff(2 * t4), ob = toff(2 * t4 + 1), og = toff(gq);
  const int o8 = toff(8);
  // sums of the lane: gp and gp zhat of channel 16 mf + gq + 8 h; dW^T's C
  // fragments, taps 2 t4 + {0, 1} (dw0) and tap 8 (dw1, lanes t4 = 0)
  float s1[4][2] = {}, s2[4][2] = {}, dw0[4][4] = {}, dw1[4][2] = {};
  __syncthreads();

  const int units_x = (W + UW - 1) / UW;
  const long nunits = (long)units_x * H, nw = (long)gridDim.x * BWARPS;
  const long gw = (long)blockIdx.x * BWARPS + warp;
  const int n = gw < nunits ? (int)((nunits - gw + nw - 1) / nw) : 0;
  auto unit_of = [&](int k, int& y, int& x0) {
    const long u = gw + k * nw;
    y = (int)(u / units_x);
    x0 = (int)(u - (long)y * units_x) * UW;
  };
  auto issue = [&](int k) {
    int y, x0;
    unit_of(k, y, x0);
    const uint32_t st = ring_s + (k % BSTAGES) * U::STAGE;
    const T* zrow = z + ((size_t)y * W + x0) * C;
#pragma unroll
    for (int i = 0; i < UW * U::CHUNKS / 32; ++i) {
      const int q = lane + 32 * i, px = q / U::CHUNKS, cc = q % U::CHUNKS;
      const bool ok = x0 + px < W;
      cp_async16(st + U::at(px, cc),
                 ok ? zrow + px * C + cc * (16 / (int)sizeof(T)) : z, ok);
    }
    // neh[r][j]: noise, aux_c, aux_m (r / 3) of image row y + r % 3 - 1
#pragma unroll
    for (int i = 0; i < (9 * HWU + 31) / 32; ++i) {
      const int j = lane + 32 * i, r = j / HWU, cx = j - r * HWU;
      const int yy = y + r % 3 - 1, x = x0 + cx - 1;
      const float* src = r < 3 ? noise : r < 6 ? aux_c : aux_m;
      const bool ok = yy >= 0 && yy < H && x >= 0 && x < W;
      if (j < 9 * HWU)
        cp_async4(st + U::ZBYTES + 4 * j, ok ? src + (size_t)yy * W + x : src,
                  ok);
    }
  };

#pragma unroll 1
  for (int k = 0; k < BSTAGES - 1; ++k) {
    if (k < n) issue(k);
    cp_async_commit();
  }
#pragma unroll 1
  for (int k = 0; k < n; ++k) {
    if (k + BSTAGES - 1 < n) issue(k + BSTAGES - 1);
    cp_async_commit();
    cp_async_wait<BSTAGES - 1>();
    __syncwarp();
    int y, x0;
    unit_of(k, y, x0);
    unsigned char* st = ring + (k % BSTAGES) * U::STAGE;
    const uint32_t st_s = ring_s + (k % BSTAGES) * U::STAGE;
    float* neh = reinterpret_cast<float*>(st + U::ZBYTES);
    // -e = bf16(-m sign(c - m noise)), once a halo pixel, over noise's rows
    for (int i = lane; i < 3 * HWU; i += 32) {
      const float m = neh[6 * HWU + i];
      const float u = __fsub_rn(neh[3 * HWU + i], __fmul_rn(m, neh[i]));
      neh[i] = round_bf16(-m * (float)((u > 0.f) - (u < 0.f)));
    }
    __syncwarp();
    // the unit's pixels in the image: the others give a = 0 and add to no sum
    const int lim = W - x0;
    {
      uint32_t bg[2][2], bd[2][2];  // E^T's B fragments; E's (taps 0-7, 8)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int p = 8 * j + gq;
        bg[j][0] = pack_bf16x2(neh[oa + p], neh[ob + p]);
        bg[j][1] = t4 == 0 ? pack_bf16x2(neh[o8 + p], 0.f) : 0u;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int p = 2 * t4 + 8 * j;
        bd[0][j] = pack_bf16x2(neh[og + p], neh[og + p + 1]);
        bd[1][j] = gq == 0 ? pack_bf16x2(neh[o8 + p], neh[o8 + p + 1]) : 0u;
      }
      // z at the lane's places: zv[mf][h + 2 jj][e]
      float zv[4][4][2];
      if constexpr (U::BF16) {
        const int px = (lane & 7) + 8 * (lane >> 4);
#pragma unroll
        for (int mf = 0; mf < 4; ++mf) {
          uint32_t r[4];
          ldsm_x4_trans(st_s + U::at(px, 2 * mf + ((lane >> 3) & 1)), r[0],
                        r[1], r[2], r[3]);
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) {
            const float2 f = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&r[mi]));
            zv[mf][mi][0] = f.x;
            zv[mf][mi][1] = f.y;
          }
        }
        __syncwarp();  // every lane's z is read before g overwrites it
      } else {
        const float* zs = reinterpret_cast<const float*>(st);
#pragma unroll
        for (int mf = 0; mf < 4; ++mf)
#pragma unroll
          for (int mi = 0; mi < 4; ++mi)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              zv[mf][mi][e] = zs[(2 * t4 + e + 8 * (mi >> 1)) * (U::ROW / 4)
                                 + 16 * mf + gq + 8 * (mi & 1)];
      }
#pragma unroll
      for (int mf = 0; mf < 4; ++mf) {
        const uint4 wa = wfrag[mf * 32 + lane];
        float gc[2][4] = {};  // g^T: pixels 8 jj + 2 t4 + {0, 1}
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
          mma_bf16(gc[jj], wa.x, wa.y, wa.z, wa.w, bg[jj][0], bg[jj][1]);
        const float4 v[2] = {vecs[16 * mf + gq], vecs[16 * mf + gq + 8]};
        uint32_t af[4];  // a^T's A fragment: register h + 2 jj
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          const int h = mi & 1, jj = mi >> 1;
          float a[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float zz = zv[mf][mi][e];
            float yv = affine(v[h].x, zz, v[h].y);
            if (2 * t4 + e + 8 * jj >= lim) yv = -1.f;
            a[e] = fmaxf(yv, 0.f);
            const float gp = yv > 0.f ? gc[jj][2 * h + e] : 0.f;
            s1[mf][h] += gp;
            s2[mf][h] = fmaf(gp, fmaf(v[h].z, zz, v[h].w), s2[mf][h]);
          }
          af[mi] = pack_bf16x2(a[0], a[1]);
        }
        // one k step a chain, added to the f32 sums rounded to nearest
        float d0[4] = {}, d1[4] = {};
        mma_bf16(d0, af[0], af[1], af[2], af[3], bd[0][0], bd[0][1]);
        mma_bf16(d1, af[0], af[1], af[2], af[3], bd[1][0], bd[1][1]);
#pragma unroll
        for (int i = 0; i < 4; ++i) dw0[mf][i] += d0[i];
        dw1[mf][0] += d1[0];
        dw1[mf][1] += d1[2];
        // g over the staged z, in the chain's type
        if constexpr (U::BF16) {
          const int px = (lane & 7) + 8 * (lane >> 4);
          stsm_x4_trans(st_s + U::at(px, 2 * mf + ((lane >> 3) & 1)),
                        pack_bf16x2(gc[0][0], gc[0][1]),
                        pack_bf16x2(gc[0][2], gc[0][3]),
                        pack_bf16x2(gc[1][0], gc[1][1]),
                        pack_bf16x2(gc[1][2], gc[1][3]));
        } else {
          float* zs = reinterpret_cast<float*>(st);
#pragma unroll
          for (int mi = 0; mi < 4; ++mi)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              zs[(2 * t4 + e + 8 * (mi >> 1)) * (U::ROW / 4) + 16 * mf +
                 gq + 8 * (mi & 1)] = gc[mi >> 1][2 * (mi & 1) + e];
        }
      }
    }
    __syncwarp();
    // g out with 16-byte stores, whole pixels a store
    T* grow = g + ((size_t)y * W + x0) * C;
#pragma unroll
    for (int i = 0; i < UW * U::CHUNKS / 32; ++i) {
      const int q = lane + 32 * i, px = q / U::CHUNKS, cc = q % U::CHUNKS;
      if (px < lim)
        *reinterpret_cast<uint4*>(grow + px * C + cc * (16 / (int)sizeof(T))) =
            *reinterpret_cast<const uint4*>(st + U::at(px, cc));
    }
    __syncwarp();  // the ring slot is read before it is filled again
  }
  cp_async_wait<0>();

  // the block's sums in a fixed order: lanes of a channel by shuffles, then
  // warps in order through shared memory (the rings are free)
#pragma unroll
  for (int mf = 0; mf < 4; ++mf)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int sh = 1; sh < 4; sh <<= 1) {
        s1[mf][h] += __shfl_xor_sync(FULL, s1[mf][h], sh);
        s2[mf][h] += __shfl_xor_sync(FULL, s2[mf][h], sh);
      }
  __syncthreads();
  float* mine = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int mf = 0; mf < 4; ++mf)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 16 * mf + gq + 8 * h;
      mine[2 * t4 * C + c] = dw0[mf][2 * h];
      mine[(2 * t4 + 1) * C + c] = dw0[mf][2 * h + 1];
      if (t4 == 0) {
        mine[8 * C + c] = dw1[mf][h];
        mine[9 * C + c] = s1[mf][h];
        mine[10 * C + c] = s2[mf][h];
      }
    }
  __syncthreads();
  for (int i = tid; i < BWD_SUMS * C; i += BTHREADS) {
    float sum = 0.f;
#pragma unroll
    for (int wi = 0; wi < BWARPS; ++wi)
      sum += reinterpret_cast<const float*>(smem + BW_FRAG + BVEC +
                                            wi * BSTAGES * U::STAGE)[i];
    partial[(size_t)blockIdx.x * BWD_SUMS * C + i] = sum;
  }
}

// da, z1: (H, W, 64) T; x: (H, W) T; partial: (blocks, 9, 64) f32.
template <typename T>
__global__ void __launch_bounds__(ETHREADS)
first_dw_k(const T* __restrict__ da, const T* __restrict__ z1,
           const T* __restrict__ x, float* __restrict__ partial, int H, int W,
           int tiles_x, int ntiles) {
  __shared__ float xs[EHH * EHW];
  __shared__ float red[EWARPS * 9 * C];
  const int tid = threadIdx.x, chunk = tid & 7, px = tid >> 3;
  float acc[9][8];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[t][k] = 0.f;

  constexpr int NB = sizeof(T) == 2 ? 4 : 2;  // rows in flight, two loads each
  static_assert(ETH % NB == 0, "whole batches of tile rows");
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int y0 = (tile / tiles_x) * ETH, x0 = (tile % tiles_x) * ETW;
    __syncthreads();  // the previous tile's rows are done with xs
    stage_halo(xs, y0, x0, H, W,
               [&](size_t i) { return round_bf16(ldf(x + i)); });
    __syncthreads();
    const int xx = x0 + px;
#pragma unroll
    for (int r0 = 0; r0 < ETH; r0 += NB) {
      Chunk<T> rd[NB], rz[NB];
      bool inside[NB];
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const int y = y0 + r0 + i;
        inside[i] = y < H && xx < W;
        if (inside[i]) {
          const size_t off = ((size_t)y * W + xx) * C + chunk * 8;
          ldg(rd[i], da + off);
          ldg(rz[i], z1 + off);
        }
      }
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        if (!inside[i]) continue;
        const int py = r0 + i;
        float gp[8], zv[8];
        unpack(rd[i], gp);
        unpack(rz[i], zv);
#pragma unroll
        for (int k = 0; k < 8; ++k) gp[k] = zv[k] > 0.f ? round_bf16(gp[k]) : 0.f;
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          const float v = xs[(py + t / 3) * EHW + px + t % 3];
#pragma unroll
          for (int k = 0; k < 8; ++k) acc[t][k] = fmaf(v, gp[k], acc[t][k]);
        }
      }
    }
  }
  block_sums<9>(acc, red, partial + (size_t)blockIdx.x * 9 * C);
}

struct Tiles {
  int tiles_x, ntiles;
};

inline Tiles tiles_of(int H, int W) {
  const int tiles_x = (W + ETW - 1) / ETW;
  return {tiles_x, tiles_x * ((H + ETH - 1) / ETH)};
}

// The persistent grid of `kern` over the image's tiles; see persistent_grid.
template <typename K>
int ends_grid(K kern, const Tiles& t, int max_blocks, Resident* cache,
              int* grid) {
  return persistent_grid(kern, ETHREADS, 0, t.ntiles, max_blocks, cache, grid);
}

template <typename T>
int first_conv(const void* x, const float* w, void* z, int H, int W,
               void* stream) {
  static Resident resident;
  auto kern = first_conv_k<T>;
  const Tiles t = tiles_of(H, W);
  int grid = 0;
  int rc = ends_grid(kern, t, 0, &resident, &grid);
  if (rc != 0) return rc;
  kern<<<grid, ETHREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), w, static_cast<T*>(z), H, W, t.tiles_x,
      t.ntiles);
  return (int)cudaGetLastError();
}

template <typename T>
int last_loss_fwd(const void* z, const float* s, const float* b,
                  const float* w, const float* aux_c, const float* aux_m,
                  float* noise, float* loss, float* partial, int max_blocks,
                  int H, int W, void* stream) {
  static Resident resident;
  auto kern = last_fwd_k<T>;
  const int tiles_x = (W + LTW - 1) / LTW;
  const Tiles t = {tiles_x, tiles_x * ((H + LTH - 1) / LTH)};
  int grid = 0;
  int rc = ends_grid(kern, t, max_blocks, &resident, &grid);
  if (rc != 0) return rc;
  kern<<<grid, ETHREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(z), s, b, w, aux_c, aux_m, noise, partial, H, W,
      t.tiles_x, t.ntiles);
  if ((rc = (int)cudaGetLastError()) != 0) return rc;
  return finish(partial, grid, 1, loss, stream);
}

// out[i] = the sum over rows r of partial[r * n + i], in double, in a fixed
// order: thread (i, j) of a 32 x 16 block adds rows j, j + 16, ... in order,
// then thread (i, 0) adds the 16 sums in order of j. The same inputs give
// the same bits on every run. A thread has its nine loads of 132 rows in
// flight where finish_sums' thread waits on its 132 loads in turn.
__global__ void finish_rows(const float* __restrict__ partial, int rows, int n,
                            float* __restrict__ out) {
  __shared__ double part[16][33];
  const int i = blockIdx.x * 32 + threadIdx.x, j = threadIdx.y;
  double s = 0.0;
  if (i < n)
    for (int r = j; r < rows; r += 16) s += (double)partial[(size_t)r * n + i];
  part[j][threadIdx.x] = s;
  __syncthreads();
  if (j == 0 && i < n) {
    double t = 0.0;
#pragma unroll
    for (int k = 0; k < 16; ++k) t += part[k][threadIdx.x];
    out[i] = (float)t;
  }
}

template <typename T>
int last_loss_bwd(const float* noise, const float* aux_c, const float* aux_m,
                  const void* z, const float* w, const float* vec, void* g,
                  float* sums, float* partial, int max_blocks, int H, int W,
                  void* stream) {
  static Resident resident;
  using U = BwdUnit<T>;
  auto kern = last_bwd_k<T>;
  const long nunits = (long)((W + UW - 1) / UW) * H;
  int grid = 0;
  int rc = persistent_grid(kern, BTHREADS, U::SMEM,
                           (nunits + BWARPS - 1) / BWARPS, max_blocks,
                           &resident, &grid);
  if (rc != 0) return rc;
  kern<<<grid, BTHREADS, U::SMEM, (cudaStream_t)stream>>>(
      noise, aux_c, aux_m, static_cast<const T*>(z), w, vec,
      static_cast<T*>(g), partial, H, W);
  if ((rc = (int)cudaGetLastError()) != 0) return rc;
  finish_rows<<<(BWD_SUMS * C + 31) / 32, dim3(32, 16), 0,
                (cudaStream_t)stream>>>(partial, grid, BWD_SUMS * C, sums);
  return (int)cudaGetLastError();
}

template <typename T>
int first_dw(const void* da, const void* z1, const void* x, float* dw,
             float* partial, int max_blocks, int H, int W, void* stream) {
  static Resident resident;
  auto kern = first_dw_k<T>;
  const Tiles t = tiles_of(H, W);
  int grid = 0;
  int rc = ends_grid(kern, t, max_blocks, &resident, &grid);
  if (rc != 0) return rc;
  kern<<<grid, ETHREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(da), static_cast<const T*>(z1),
      static_cast<const T*>(x), partial, H, W, t.tiles_x, t.ntiles);
  if ((rc = (int)cudaGetLastError()) != 0) return rc;
  return finish(partial, grid, 9 * C, dw, stream);
}

}  // namespace

extern "C" {

// Each returns a cudaError_t code: 0 on launches that were accepted. H and W
// are positive; is_f32 names T; every array is contiguous.

// x: (H, W) T; w: (3, 3, 1, 64) f32; z: (1, H, W, 64) T out.
int f2f_first_conv(const void* x, int is_f32, const float* w, void* z, int H,
                   int W, void* stream) {
  if (H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  return is_f32 ? first_conv<float>(x, w, z, H, W, stream)
                : first_conv<__nv_bfloat16>(x, w, z, H, W, stream);
}

// z: (1, H, W, 64) T; s, b: (64,) f32; w: (3, 3, 64, 1) f32; aux_c, aux_m:
// (H, W) f32; noise: (H, W) f32 out; loss: one f32 out; partial: (max_blocks,)
// f32 scratch.
int f2f_last_loss_fwd(const void* z, int is_f32, const float* s,
                      const float* b, const float* w, const float* aux_c,
                      const float* aux_m, float* noise, float* loss,
                      float* partial, int max_blocks, int H, int W,
                      void* stream) {
  if (H <= 0 || W <= 0 || max_blocks <= 0) return (int)cudaErrorInvalidValue;
  return is_f32 ? last_loss_fwd<float>(z, s, b, w, aux_c, aux_m, noise, loss,
                                       partial, max_blocks, H, W, stream)
                : last_loss_fwd<__nv_bfloat16>(z, s, b, w, aux_c, aux_m, noise,
                                               loss, partial, max_blocks, H, W,
                                               stream);
}

// noise, aux_c, aux_m: (H, W) f32; z: (1, H, W, 64) T; w: (3, 3, 64, 1) f32;
// vec: (4, 64) f32; g: (1, H, W, 64) T out; sums: (11, 64) f32 out = dW_out
// (3, 3, 64, 1) then the two BatchNorm sums; partial: (max_blocks, 11, 64)
// f32 scratch.
int f2f_last_loss_bwd(const float* noise, const float* aux_c,
                      const float* aux_m, const void* z, int is_f32,
                      const float* w, const float* vec, void* g, float* sums,
                      float* partial, int max_blocks, int H, int W,
                      void* stream) {
  if (H <= 0 || W <= 0 || max_blocks <= 0) return (int)cudaErrorInvalidValue;
  return is_f32 ? last_loss_bwd<float>(noise, aux_c, aux_m, z, w, vec, g, sums,
                                       partial, max_blocks, H, W, stream)
                : last_loss_bwd<__nv_bfloat16>(noise, aux_c, aux_m, z, w, vec,
                                               g, sums, partial, max_blocks, H,
                                               W, stream);
}

// da, z1: (1, H, W, 64) T; x: (H, W) T; dw: (3, 3, 1, 64) f32 out; partial:
// (max_blocks, 9, 64) f32 scratch.
int f2f_first_dw(const void* da, const void* z1, const void* x, int is_f32,
                 float* dw, float* partial, int max_blocks, int H, int W,
                 void* stream) {
  if (H <= 0 || W <= 0 || max_blocks <= 0) return (int)cudaErrorInvalidValue;
  return is_f32 ? first_dw<float>(da, z1, x, dw, partial, max_blocks, H, W,
                                  stream)
                : first_dw<__nv_bfloat16>(da, z1, x, dw, partial, max_blocks,
                                          H, W, stream);
}

const char* f2f_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
