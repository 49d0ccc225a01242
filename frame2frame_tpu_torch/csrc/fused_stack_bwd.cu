// Hopper (sm_90a) backward kernel of the DnCNN 64->64 mid layers.
//
// f2f_bwd_layer replaces frame2frame_tpu/ops/fused_stack.py: bwd_layer
// (_bwd_kernel): one layer's backward through ReLU, training-mode BatchNorm
// and the 3x3 convolution, in image space (NHWC, 64 channels). From the
// cotangent g of the layer's activation, its stored conv output z_i, the
// previous layer's stored output z_prev and eight per-channel vectors
// (BwdVec below) it gives
//   da_prev    = conv3x3(dz, flip(w)^T),  dz = A * (g * [s_i z_i + b_i > 0])
//                                              + B * z_i + C
//   dW         = sum_p a_prev[p + tap - 1] (x) dz[p],  f32,
//                a_prev = relu(s_p * z_prev + b_p)
//   stats_prev = sum(gp), sum(gp * zhat_prev),  gp = da_prev * [a_prev > 0],
//                from the f32 da_prev before it is rounded (not first_layer)
//
// f2f_bwd_layer_window takes the row windows of a slab of a frame split by
// rows (ops/fused_spatial.py), the valid_bounds input of the TPU kernel: dz
// is zero at rows outside [lo, hi), as at the image's border, and a_prev
// outside [slo, shi), the slab's body rows that are rows of the frame; the
// BN-backward sums count rows [slo, shi). So dW pairs each body row's
// a_prev with dz at every row, halo rows included, and a sum over the slabs
// counts each row of the frame once. da_prev is written at every row.
// f2f_bwd_layer runs the same body with both windows [0, H).
//
// One persistent kernel computes all three in one pass over the frame, as
// the TPU kernel does in one pallas_call, and one finish_sums adds the
// blocks' partial rows (stats_prev and dW side by side) in block order, in
// double: no atomics, the same bits on every run.
//
// Bound at 540p (1 x 540 x 960 x 64, bf16 chain): g, z_i and z_prev read and
// da_prev written once, 4 x 66.4 MB -> 79 us at 3.35 TB/s; dX and dW are
// 2 x 38.2 GFLOP -> 77 us at 989 TFLOP/s. As run, the (8+2) x (16+2) halo
// tiles read the three inputs 1.41 times: (3 x 1.41 + 1) x 66.4 MB -> 104 us.
//
// Design. A persistent block of 12 warps walks 8 x 16 pixel tiles of one
// image. The weights (73.7 KB) stay in shared memory; two stages hold the
// (8+2) x (16+2) halo tiles of g, z_i and z_prev (bf16 in swizzled 128-byte
// rows), one for this tile and one being filled for the next:
//   * dX: warps 0..7 own one tile row each, 16 pixels x 64 channels in 32
//     f32 accumulators: 9 taps x 4 k16 steps of mma.sync.m16n8k16, each
//     step's fragments loaded before its MMAs, A from the dz halo
//     (ldmatrix) and B the flipped, transposed weights read from the same
//     HWIO array (ldmatrix, not .trans). The epilogue writes da_prev and
//     adds the tile's BN-backward sums, reduced over the warp by shuffles,
//     to the warp's own row of sums in shared memory;
//   * dW: every warp owns three (tap, 16 input channels) units x 64 output
//     channels of dW in 96 f32 accumulators, summed over all tiles of the
//     block; one tile row of 16 pixels is one k16 step with A = a_prev^T
//     (ldmatrix.trans from the a_prev halo row shifted by the unit's tap,
//     the three units' fragments loaded first) and B = dz at the row's
//     pixels (ldmatrix.trans from the dz halo);
//   * warps 8..11, which have no dX row, fill the other stage for the next
//     tile while the others compute: its copies go out (cp.async, 16 bytes,
//     zeros outside the image) before this tile's MMAs, and after their own
//     dW each thread runs the prologue on the chunks it copied itself, in
//     place: g's halo becomes dz, z_i's a_prev (both zeros outside the
//     image); z_prev's stays for the epilogue's masks. The f32 chain (not
//     timed) loads and converts through registers at the same point. One
//     barrier a tile.
// So dz never leaves the multiprocessor and z_prev is read once (two
// kernels would write dz, read it back and read z_prev twice: 7 x 66.4 MB).
// dW's 36,864 accumulators a block take 56 % of the register file: one
// block a multiprocessor, and 12 warps leave a thread 168 registers, for 96
// dW and 32 dX accumulators and one k step's fragments at once in warps
// 0..7.

#include "conv3x3_c64.cuh"

namespace {

using namespace f2f;

// Rows of the (8, 64) f32 vectors of one backward layer.
enum BwdVec {
  V_A = 0,       // gamma_i * rstd_i: the ReLU-mask scale and dz's factor of g
  V_BI = 1,      // the shift of the same affine
  V_B = 2,       // -A * rstd_i * dgamma_i / M
  V_C = 3,       // A * (mean_i * rstd_i * dgamma_i / M - dbeta_i / M)
  V_SP = 4,      // scale of the previous layer's affine
  V_BP = 5,      // its shift
  V_RSTDP = 6,   // rstd_prev
  V_NMRP = 7,    // -mean_prev * rstd_prev
};

constexpr int BW_WARPS = 12;
constexpr int BW_THREADS = BW_WARPS * 32;
constexpr int BW_UNITS = 9 * 4 / BW_WARPS;  // (tap, 16 input channels) a warp
constexpr int BW_HALO_CHUNKS = HH * HW * 8;  // 16-byte chunks of a halo tile
constexpr int BW_N = 2 * C + 9 * C * C;      // a partial row: stats | dW
constexpr int BW_RED = BW_WARPS * 2 * C;     // the warps' BN-backward sums
// dynamic shared memory: weights | vectors | sums | stages of 3 halo tiles
constexpr int BW_FIXED_BYTES = W_BYTES + 8 * C * 4 + BW_RED * 4;
constexpr int BW_STAGE_BYTES = 3 * HALO_BYTES;
constexpr int BW_SMEM_BF16 = BW_FIXED_BYTES + 2 * BW_STAGE_BYTES;
constexpr int BW_SMEM_F32 = BW_FIXED_BYTES + 4 * HALO_BYTES;
// warps TH.. have no dX row: they fill the other stage for the next tile
constexpr int BW_STAGER0 = TH * 32;  // their first thread
constexpr int BW_STAGERS = BW_THREADS - BW_STAGER0;

static_assert(BW_THREADS % 8 == 0, "a thread keeps one channel chunk");
static_assert(BW_UNITS * BW_WARPS == 36, "warps split the 36 units evenly");
static_assert(TH < BW_WARPS, "one dX tile row a warp, and stagers");
static_assert(BW_STAGERS % 8 == 0, "a stager keeps one channel chunk");
static_assert(BW_SMEM_BF16 <= 232448, "two stages fit the multiprocessor");

struct Tile {
  int bi, y0, x0;
};

__device__ __forceinline__ Tile tile_at(long tile, int tiles_y, int tiles_x) {
  const int tx = (int)(tile % tiles_x);
  const long r = tile / tiles_x;
  return {(int)(r / tiles_y), (int)(r % tiles_y) * TH, tx * TW};
}

// The halo pixel p of a tile: its image coordinates and whether it lies in
// the image.
__device__ __forceinline__ bool halo_pixel(const Tile& tl, int p, int H,
                                           int W, int& y, int& x) {
  const int hy = p / HW, hx = p - hy * HW;
  y = tl.y0 + hy - 1;
  x = tl.x0 + hx - 1;
  return row_in(y, 0, H) && x >= 0 && x < W;
}

// The rows of the windows: dz at [lo, hi), a_prev and the sums at
// [slo, shi).
struct Rows {
  int lo, hi, slo, shi;
};

// bf16 chain, by warps 8..11: the halo tiles of g, z_i and z_prev into one
// stage, 16 bytes a copy, zeros outside the image.
__device__ __forceinline__ void stage_copies(
    unsigned char* st, const __nv_bfloat16* __restrict__ g,
    const __nv_bfloat16* __restrict__ zi, const __nv_bfloat16* __restrict__ zp,
    const Tile& tl, int H, int W) {
  const uint32_t st_s = (uint32_t)__cvta_generic_to_shared(st);
  const int chunk = threadIdx.x & 7;
  for (int e = threadIdx.x - BW_STAGER0; e < BW_HALO_CHUNKS;
       e += BW_STAGERS) {
    const int p = e >> 3;
    int y, x;
    const bool in = halo_pixel(tl, p, H, W, y, x);
    const size_t off =
        in ? (((size_t)tl.bi * H + y) * W + x) * C + chunk * 8 : 0;
    const uint32_t dst = st_s + swz(p, chunk * 8);
    cp_async16(dst, g + off, in);
    cp_async16(dst + HALO_BYTES, zi + off, in);
    cp_async16(dst + 2 * HALO_BYTES, zp + off, in);
  }
}

// dz and a_prev of 8 channels from g (v), z_i (z) and z_prev (p), in
// place; vs: the layer's vectors, read four channels at a time.
__device__ __forceinline__ void prologue8(const float* vs, int chunk,
                                          float v[8], const float z[8],
                                          float p[8]) {
  const float4* v4 = reinterpret_cast<const float4*>(vs);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c4 = 2 * chunk + h;  // float4 index of channels 4 c4 ..
    const float4 a4 = v4[V_A * C / 4 + c4], bi4 = v4[V_BI * C / 4 + c4];
    const float4 b4 = v4[V_B * C / 4 + c4], cc4 = v4[V_C * C / 4 + c4];
    const float4 sp4 = v4[V_SP * C / 4 + c4], bp4 = v4[V_BP * C / 4 + c4];
    const float a[4] = {a4.x, a4.y, a4.z, a4.w};
    const float bi[4] = {bi4.x, bi4.y, bi4.z, bi4.w};
    const float b[4] = {b4.x, b4.y, b4.z, b4.w};
    const float cc[4] = {cc4.x, cc4.y, cc4.z, cc4.w};
    const float sp[4] = {sp4.x, sp4.y, sp4.z, sp4.w};
    const float bp[4] = {bp4.x, bp4.y, bp4.z, bp4.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = 4 * h + k;
      const float gt = affine(a[k], z[e], bi[k]) > 0.f ? v[e] : 0.f;
      v[e] = fmaf(a[k], gt, fmaf(b[k], z[e], cc[k]));
      p[e] = fmaxf(affine(sp[k], p[e], bp[k]), 0.f);
    }
  }
}

// bf16 chain, by warps 8..11, in place: the stage's g halo becomes dz, its
// z_i halo a_prev, both zeros outside the image and their windows. A thread
// converts the chunks it copied itself, so its own cp_async_wait suffices.
__device__ __forceinline__ void prologue_in_place(unsigned char* st,
                                                  const float* vs,
                                                  const Tile& tl, int H,
                                                  int W, const Rows& r) {
  const int chunk = threadIdx.x & 7;
  for (int e = threadIdx.x - BW_STAGER0; e < BW_HALO_CHUNKS;
       e += BW_STAGERS) {
    const int p = e >> 3;
    int y, x;
    const bool in = halo_pixel(tl, p, H, W, y, x);
    const bool in_dz = in && row_in(y, r.lo, r.hi);
    const bool in_ap = in && row_in(y, r.slo, r.shi);
    uint4* dz = reinterpret_cast<uint4*>(st + swz(p, chunk * 8));
    uint4* ap = reinterpret_cast<uint4*>(st + HALO_BYTES + swz(p, chunk * 8));
    uint4 ud = make_uint4(0u, 0u, 0u, 0u), ua = ud;
    if (in_dz || in_ap) {
      Chunk<__nv_bfloat16> cg, cz, cp;
      cg.u = *dz;
      cz.u = *ap;
      cp.u = *reinterpret_cast<const uint4*>(st + 2 * HALO_BYTES +
                                             swz(p, chunk * 8));
      float v[8], z[8], pv[8];
      unpack(cg, v);
      unpack(cz, z);
      unpack(cp, pv);
      prologue8(vs, chunk, v, z, pv);
      if (in_dz) ud = pack8(v);
      if (in_ap) ua = pack8(pv);
    }
    *dz = ud;
    *ap = ua;
  }
}

// f32 chain, by warps 8..11: dz and a_prev from device memory into the
// stage's two halo tiles, through registers, zeros outside the image and
// their windows.
__device__ __forceinline__ void prologue_loads(
    unsigned char* st, const float* vs, const float* __restrict__ g,
    const float* __restrict__ zi, const float* __restrict__ zp,
    const Tile& tl, int H, int W, const Rows& r) {
  const int chunk = threadIdx.x & 7;
  for (int e = threadIdx.x - BW_STAGER0; e < BW_HALO_CHUNKS;
       e += BW_STAGERS) {
    const int p = e >> 3;
    int y, x;
    uint4 ud = make_uint4(0u, 0u, 0u, 0u), ua = ud;
    const bool in = halo_pixel(tl, p, H, W, y, x);
    const bool in_dz = in && row_in(y, r.lo, r.hi);
    const bool in_ap = in && row_in(y, r.slo, r.shi);
    if (in_dz || in_ap) {
      const size_t off = (((size_t)tl.bi * H + y) * W + x) * C + chunk * 8;
      Chunk<float> cg, cz, cp;
      ldg(cg, g + off);
      ldg(cz, zi + off);
      ldg(cp, zp + off);
      float v[8], z[8], pv[8];
      unpack(cg, v);
      unpack(cz, z);
      unpack(cp, pv);
      prologue8(vs, chunk, v, z, pv);
      if (in_dz) ud = pack8(v);
      if (in_ap) ua = pack8(pv);
    }
    *reinterpret_cast<uint4*>(st + swz(p, chunk * 8)) = ud;
    *reinterpret_cast<uint4*>(st + HALO_BYTES + swz(p, chunk * 8)) = ua;
  }
}

// z_prev at two channels of a tile pixel: from the stage (bf16 chain) or
// from device memory (f32 chain).
__device__ __forceinline__ float2 zprev2(const unsigned char* st, int p,
                                         int ch, const __nv_bfloat16*,
                                         size_t) {
  return load2(reinterpret_cast<const __nv_bfloat16*>(st + 2 * HALO_BYTES +
                                                      swz(p, ch)));
}
__device__ __forceinline__ float2 zprev2(const unsigned char*, int, int,
                                         const float* zp, size_t off) {
  return load2(zp + off);
}

// g, z_i, z_prev, da: (B, H, W, 64) T; w: (3, 3, 64, 64) HWIO bf16; vec:
// (8, 64) f32; partial: (gridDim.x, BW_N) f32, a row a block: stats_prev
// (2, 64) then dW (9, 64, 64). STATS: the BN-backward sums (not first_layer).
template <typename T, bool STATS>
__global__ void __launch_bounds__(BW_THREADS, 1)
bwd_layer_k(const T* __restrict__ g, const T* __restrict__ zi,
            const T* __restrict__ zp, const __nv_bfloat16* __restrict__ w,
            const float* __restrict__ vec, T* __restrict__ da,
            float* __restrict__ partial, int B, int H, int W, int tiles_y,
            int tiles_x, const Rows r) {
  constexpr bool PIPE = sizeof(T) == 2;  // cp.async copies of the raw tiles
  constexpr int STAGE = PIPE ? BW_STAGE_BYTES : 2 * HALO_BYTES;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ws = smem;
  float* vs = reinterpret_cast<float*>(smem + W_BYTES);
  float* red = vs + 8 * C;  // [BW_WARPS][2][C]
  unsigned char* stages = smem + BW_FIXED_BYTES;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;  // MMA group: fragment row / column
  const int t = lane & 3;    // thread in group: fragment k pair

  for (int idx = tid; idx < 9 * C * 8; idx += BW_THREADS) {
    const uint4 u = reinterpret_cast<const uint4*>(w)[idx];
    *reinterpret_cast<uint4*>(ws + swz(idx >> 3, (idx & 7) * 8)) = u;
  }
  for (int idx = tid; idx < 8 * C; idx += BW_THREADS) vs[idx] = vec[idx];
  for (int idx = tid; idx < BW_RED; idx += BW_THREADS) red[idx] = 0.f;

  // dW units u = BW_UNITS * warp + i: tap u / 4, input channels 16 (u % 4)
  // ..; acc[i][j] covers output channels 8 j .. 8 j + 7
  float acc[BW_UNITS][8][4];
#pragma unroll
  for (int i = 0; i < BW_UNITS; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  // ldmatrix lane roles. dW: A = a_prev^T from rows of pixels (.trans,
  // matrix (lane >> 3) holds k half (lane >> 4) and m half ((lane >> 3) &
  // 1)); B = dz from rows of pixels (.trans, as the forward's weights).
  // dX: A rows (pixels) and k halves; B from the HWIO weights with k along
  // a row (plain: the row is n, the chunk a k half).
  const int a_k = (lane & 7) + (lane >> 4) * 8;
  const int a_mh = (lane >> 3) & 1;
  const int b_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int b_nt = lane >> 4;
  const int x_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int x_kh = lane >> 4;
  const int w_row = (lane & 7) + (lane >> 4) * 8;
  const int w_kh = (lane >> 3) & 1;
  const uint32_t ws_s = (uint32_t)__cvta_generic_to_shared(ws);
  int a_pix[BW_UNITS], a_ch[BW_UNITS];
#pragma unroll
  for (int i = 0; i < BW_UNITS; ++i) {
    const int u = BW_UNITS * warp + i;
    const int tap = u >> 2;
    a_pix[i] = (tap / 3) * HW + (tap - 3 * (tap / 3)) + a_k;
    a_ch[i] = 16 * (u & 3) + 8 * a_mh;
  }

  const bool stager = tid >= BW_STAGER0;
  const long ntiles = (long)B * tiles_y * tiles_x;
  long tile = blockIdx.x;
  __syncthreads();  // weights, vectors and sums in place
  if (stager && tile < ntiles) {  // the first tile's stage
    const Tile tl = tile_at(tile, tiles_y, tiles_x);
    if constexpr (PIPE) {
      stage_copies(stages, g, zi, zp, tl, H, W);
      cp_async_commit();
      cp_async_wait<0>();
      prologue_in_place(stages, vs, tl, H, W, r);
    } else {
      prologue_loads(stages, vs, g, zi, zp, tl, H, W, r);
    }
  }
  __syncthreads();

  for (int s = 0; tile < ntiles; tile += gridDim.x, s ^= 1) {
    const Tile tl = tile_at(tile, tiles_y, tiles_x);
    const unsigned char* st = stages + s * STAGE;
    unsigned char* sn = stages + (s ^ 1) * STAGE;
    const long next = tile + gridDim.x;
    if constexpr (PIPE) {
      // the next tile's copies go out before this tile's MMAs
      if (stager && next < ntiles)
        stage_copies(sn, g, zi, zp, tile_at(next, tiles_y, tiles_x), H, W);
      cp_async_commit();
    }
    const uint32_t dz_s = (uint32_t)__cvta_generic_to_shared(st);
    const uint32_t ap_s = dz_s + HALO_BYTES;

    if (warp < TH) {  // dX of tile row `warp`
      const int row = warp;
      float ax[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) ax[j][q] = 0.f;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap - 3 * (tap / 3);
        const int wtap = 8 - tap;
#pragma unroll
        for (int k0 = 0; k0 < C; k0 += 16) {
          uint32_t fb[8][2], a0, a1, a2, a3;
#pragma unroll
          for (int j = 0; j < 8; j += 2)
            ldsm_x4(ws_s + swz(wtap * C + 8 * j + w_row, k0 + 8 * w_kh),
                    fb[j][0], fb[j][1], fb[j + 1][0], fb[j + 1][1]);
          ldsm_x4(dz_s + swz((row + dy) * HW + dx + x_row, k0 + 8 * x_kh), a0,
                  a1, a2, a3);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            mma_bf16(ax[j], a0, a1, a2, a3, fb[j][0], fb[j][1]);
        }
      }

      const int y = tl.y0 + row;
      const bool summed = row_in(y, r.slo, r.shi);
      float* wred = red + warp * 2 * C;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int ch = 8 * j + 2 * t;
        float s0[2] = {0.f, 0.f}, s1[2] = {0.f, 0.f};
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int x = tl.x0 + gq + 8 * half;
          if (!row_in(y, 0, H) || x >= W) continue;
          const size_t off = (((size_t)tl.bi * H + y) * W + x) * C + ch;
          const float v0 = ax[j][2 * half], v1 = ax[j][2 * half + 1];
          store2(da + off, v0, v1);
          if constexpr (STATS) {
            if (!summed) continue;
            const float2 z = zprev2(st, (row + 1) * HW + 1 + gq + 8 * half,
                                    ch, zp, off);
            const float g0 =
                affine(vs[V_SP * C + ch], z.x, vs[V_BP * C + ch]) > 0.f ? v0
                                                                       : 0.f;
            const float g1 = affine(vs[V_SP * C + ch + 1], z.y,
                                    vs[V_BP * C + ch + 1]) > 0.f
                                 ? v1
                                 : 0.f;
            s0[0] += g0;
            s0[1] += g1;
            s1[0] = fmaf(g0, fmaf(vs[V_RSTDP * C + ch], z.x, vs[V_NMRP * C + ch]),
                         s1[0]);
            s1[1] = fmaf(g1,
                         fmaf(vs[V_RSTDP * C + ch + 1], z.y,
                              vs[V_NMRP * C + ch + 1]),
                         s1[1]);
          }
        }
        if constexpr (STATS) {
          // over the 8 row groups of the warp (lanes of equal t)
#pragma unroll
          for (int sh = 4; sh < 32; sh <<= 1) {
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              s0[q] += __shfl_xor_sync(0xffffffffu, s0[q], sh);
              s1[q] += __shfl_xor_sync(0xffffffffu, s1[q], sh);
            }
          }
          if (gq == 0) {
            wred[ch] += s0[0];
            wred[ch + 1] += s0[1];
            wred[C + ch] += s1[0];
            wred[C + ch + 1] += s1[1];
          }
        }
      }
    }

    // dW over the tile's rows
#pragma unroll 1
    for (int row = 0; row < TH; ++row) {
      uint32_t bf[8][2];
#pragma unroll
      for (int j = 0; j < 8; j += 2)
        ldsm_x4_trans(dz_s + swz((row + 1) * HW + 1 + b_row, 8 * (j + b_nt)),
                      bf[j][0], bf[j][1], bf[j + 1][0], bf[j + 1][1]);
      uint32_t af[BW_UNITS][4];
#pragma unroll
      for (int i = 0; i < BW_UNITS; ++i)
        ldsm_x4_trans(ap_s + swz(row * HW + a_pix[i], a_ch[i]), af[i][0],
                      af[i][1], af[i][2], af[i][3]);
#pragma unroll
      for (int i = 0; i < BW_UNITS; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mma_bf16(acc[i][j], af[i][0], af[i][1], af[i][2], af[i][3],
                   bf[j][0], bf[j][1]);
    }
    if (stager && next < ntiles) {  // the next tile's prologue
      const Tile tn = tile_at(next, tiles_y, tiles_x);
      if constexpr (PIPE) {
        cp_async_wait<0>();
        prologue_in_place(sn, vs, tn, H, W, r);
      } else {
        prologue_loads(sn, vs, g, zi, zp, tn, H, W, r);
      }
    }
    __syncthreads();  // the next stage is ready, this one is free
  }

  float* row_out = partial + (size_t)blockIdx.x * BW_N;
  for (int idx = tid; idx < 2 * C; idx += BW_THREADS) {
    float sum = 0.f;
    for (int wi = 0; wi < BW_WARPS; ++wi) sum += red[wi * 2 * C + idx];
    row_out[idx] = sum;
  }
#pragma unroll
  for (int i = 0; i < BW_UNITS; ++i) {
    const int u = BW_UNITS * warp + i;
    float* dst = row_out + 2 * C + ((u >> 2) * C + 16 * (u & 3)) * C;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        store2(dst + (gq + 8 * half) * C + 8 * j + 2 * t, acc[i][j][2 * half],
               acc[i][j][2 * half + 1]);
  }
}

template <typename T, bool STATS>
int launch(const void* g, const void* z_i, const void* z_prev, const void* w,
           const float* vec, void* da, float* out, float* partial,
           int max_blocks, int B, int H, int W, const Rows& r, void* stream) {
  static Resident resident;  // one for each instantiation of the kernel
  auto kern = bwd_layer_k<T, STATS>;
  constexpr int smem = sizeof(T) == 2 ? BW_SMEM_BF16 : BW_SMEM_F32;
  const int tiles_y = (H + TH - 1) / TH, tiles_x = (W + TW - 1) / TW;
  int grid = 0;
  int rc = persistent_grid(kern, BW_THREADS, smem, (long)B * tiles_y * tiles_x,
                           max_blocks, &resident, &grid);
  if (rc != 0) return rc;
  kern<<<grid, BW_THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(z_i),
      static_cast<const T*>(z_prev), static_cast<const __nv_bfloat16*>(w), vec,
      static_cast<T*>(da), partial, B, H, W, tiles_y, tiles_x, r);
  if ((rc = (int)cudaGetLastError()) != 0) return rc;
  return finish(partial, grid, BW_N, out, stream);
}

template <typename T>
int backward(const void* g, const void* z_i, const void* z_prev,
             const void* w, const float* vec, int first_layer, void* da,
             float* out, float* partial, int max_blocks, int B, int H, int W,
             const Rows& r, void* stream) {
  return first_layer
             ? launch<T, false>(g, z_i, z_prev, w, vec, da, out, partial,
                                max_blocks, B, H, W, r, stream)
             : launch<T, true>(g, z_i, z_prev, w, vec, da, out, partial,
                               max_blocks, B, H, W, r, stream);
}

}  // namespace

extern "C" {

// g, z_i, z_prev, da: (B, H, W, 64) bf16 or f32; w: (3, 3, 64, 64) HWIO bf16;
// vec: (8, 64) f32; out: (2 * 64 + 9 * 64 * 64) f32, stats_prev (2, 64) (zeros
// when first_layer) then dW (3, 3, 64, 64); partial: (max_blocks, 2 * 64 + 9
// * 64 * 64) f32 scratch; the windows: dz's rows [lo, hi) (0 <= lo < hi <=
// H), a_prev's and the sums' rows [slo, shi). Returns a cudaError_t code: 0
// on launches that were accepted.
int f2f_bwd_layer_window(const void* g, const void* z_i, const void* z_prev,
                         int is_f32, const void* w, const float* vec,
                         int first_layer, void* da, float* out, float* partial,
                         int max_blocks, int B, int H, int W, int lo, int hi,
                         int slo, int shi, void* stream) {
  if (max_blocks <= 0 || B <= 0 || H <= 0 || W <= 0 || lo < 0 || hi > H ||
      lo >= hi || slo < 0 || shi > H)
    return (int)cudaErrorInvalidValue;
  const Rows r = {lo, hi, slo, shi};
  return is_f32 ? backward<float>(g, z_i, z_prev, w, vec, first_layer, da,
                                  out, partial, max_blocks, B, H, W, r, stream)
                : backward<__nv_bfloat16>(g, z_i, z_prev, w, vec, first_layer,
                                          da, out, partial, max_blocks, B, H,
                                          W, r, stream);
}

// The same with both windows [0, H): the entry point that
// scripts/torch_kernel_ab.py calls on this tree and on a parent tree
// that has no window.
int f2f_bwd_layer(const void* g, const void* z_i, const void* z_prev,
                  int is_f32, const void* w, const float* vec, int first_layer,
                  void* da, float* out, float* partial, int max_blocks, int B,
                  int H, int W, void* stream) {
  return f2f_bwd_layer_window(g, z_i, z_prev, is_f32, w, vec, first_layer, da,
                              out, partial, max_blocks, B, H, W, 0, H, 0, H,
                              stream);
}

const char* f2f_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
