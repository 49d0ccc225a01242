// Hopper (sm_90a) backward kernel of the DnCNN 64->64 mid layers.
//
// f2f_bwd_layer replaces frame2frame_tpu/ops/fused_stack.py: bwd_layer
// (_bwd_kernel, ops/fused_stack.py:1161): one layer's backward through
// ReLU, training-mode BatchNorm and the 3x3 convolution, in image space
// (NHWC, 64 channels). From the cotangent g of the layer's activation, its
// stored conv output z_i, the previous layer's stored output z_prev and
// eight per-channel vectors (BwdVec below) it gives
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
// f2f_bwd_layer runs the same body with both windows [0, H). The prologue
// tests both windows pixel by pixel (dz is C, not zero, where g and z_i
// are zero), so the tensor maps span the whole tensor.
//
// One persistent kernel computes all three in one pass over the frame, as
// the TPU kernel does in one pallas_call, and one finish_sums adds the
// blocks' partial rows (stats_prev and dW side by side) in block order, in
// double: no atomics, the same bits on every run. dz never leaves the
// multiprocessor and z_prev is read once (two kernels would write dz, read
// it back and read z_prev twice: 7 x 66.4 MB).
//
// Bound at 540p (1 x 540 x 960 x 64, bf16 chain): g, z_i and z_prev read and
// da_prev written once, 4 x 66.4 MB -> 79.3 us at 3.35 TB/s; dX and dW are
// 2 x 38.2 GFLOP -> 77.3 us at 989 TFLOP/s. As run, each 8 x 16 tile reads
// its three (8+2) x (16+2) TMA boxes, 1.41 times the inputs:
// (3 x 1.41 + 1) x 66.4 MB -> 103.4 us, where neighbouring boxes miss L2.
//
// Design: the forward's shape (fused_stack.cu), one block a multiprocessor
// of three warpgroups that walks the image's 8 x 16 tiles.
//   * Producer warpgroup (24 registers a thread after setmaxnreg): one
//     thread keeps a ring of two stages filled by TMA, each stage the three
//     boxes (64, 18, 10, 1) of g, z_i and z_prev over (C, W, H, B) in the
//     128-byte swizzle, signalled by an mbarrier (full) and handed back by
//     the eight consumer warps (empty). The zero fill pads the image.
//   * Two consumer warpgroups (240 registers) share each tile. Both run the
//     prologue in place on the landed stage, each thread one 8-channel group
//     of its 16-byte chunks, four channels a pass so that 24 constants stay
//     in registers: g's box becomes dz, z_i's a_prev (zeros outside the
//     image and the windows); z_prev's stays. Then each issues 52 wgmma a
//     tile in 26 commit groups, three fragment sets in flight:
//       dX, 36 x m64n64k16 a warpgroup: warpgroup w owns tile rows 4w ..
//       4w + 3, warp q row 4w + q (32 accumulators). A is dz at the tap's
//       shift, by ldmatrix from the box, as the forward takes its A; B the
//       flipped weights, the HWIO array as it is (row tap * 64 + ci holds
//       the 64 co: K-major with n = ci), written once a block, 8 KB a tap.
//       dW, 16 products a warpgroup, one m64n192k16 and one m64n96k16 a
//       tile row: M = the 64 output channels, K = the row's 16 pixels, N =
//       (dx, input channel). A is dz^T of the row by ldmatrix.trans, one
//       fragment a warp for both products; B is a_prev of halo row
//       row + dy read by wgmma as an MN-major operand whose next 64 n lie
//       one pixel row (128 bytes) on, so that N spans the three taps dx of
//       one dy. Warpgroup w holds dy = 2w (N = 192, 96 accumulators) and
//       half of dy = 1 (N = 96 from (dx, ci) = (0, 0) or (1, 32), 48), its
//       share of the 9 x 64 x 64 f32 dW summed over all the block's tiles.
//     The swizzle follows the absolute shared address, so descriptors may
//     start at any 128-byte row and any 16-byte chunk of it.
//   * Epilogue, in five pieces issued between the dW groups, once the dX
//     groups are done: four pieces of BN-backward sums from the f32
//     accumulator and z_prev in the stage (branch-free; 8 values a piece
//     reduced over the warp's 8 row groups by 7 shuffles, each lane
//     keeping one running sum over the block's tiles), then da_prev rounded
//     to bf16 into the stage's z_prev row by stmatrix (only this warp reads
//     that row after the prologue) and stored as 16-byte pixels, 2 KB a row.
//     After the last group each warp hands the stage back.
// dW the other way round (M = a tap's input channels, A = a_prev^T shifted
// by ldmatrix.trans, the warpgroups halving N to m64n32k16) gave the same
// bits at 0.258 ms a 540p launch, against 0.252 for this form at the same
// epilogue: 30 fragment loads and 72 products a warpgroup and tile, here 8
// and 16.
// Why dW's A comes from registers: the products read B (6 and 3 KB) from
// shared memory; A there too would add 2 KB a product, and the forward's
// variant with both operands in shared memory was bound by those reads. In
// registers a warp loads dz^T of a row once (512 bytes) for both products.
// Budget. Registers: a consumer thread holds 144 dW and 32 dX accumulators
// and three fragment sets of 8; ptxas spills 0.6-0.7 KB a thread around the
// epilogue's pieces. 2 x 128 x 240 + 128 x 24 = 64,512, what 384 threads
// hold at launch (168 each). Shared memory: weights 73,728 | two stages of
// 3 x 23,552 | vectors 2,048 | the warps' sums 4,096 | barriers:
// 222,240 bytes with the 1024-byte alignment slack.
// What the card said (NVIDIA H100 80GB HBM3, 700 W; CUDA events over
// back-to-back launches, ms a 540p launch): the MMAs alone 0.131, the loads,
// prologue and epilogue alone 0.122 (bytes), the whole 0.252 with the sums
// reduced by 96 shuffles a tile into shared memory, 0.226 with them
// reduced as here after the MMAs; the epilogue beside the dW products
// 0.230 at 540p and 0.774-0.798 against 0.81 at 1080p. The prologue in the
// producer warpgroup (four warps, a pixel row a step) took 0.297: with two
// stages it runs after the landing of its own tile, and both exceed a tile.
// Two fragment sets, or the prologue's loads in two batches, were slower.
//
// The f32 chain (strict mode; not timed) has no TMA: the consumers' prologue
// loads g, z_i and z_prev from device memory through registers into the
// same stage, rounded to bf16 (MMA operands are bf16 on either chain, as in
// the forward), and the same wgmma body runs; the epilogue reads z_prev
// from device memory and stores f32 pairs from the accumulators.

#include "conv3x3_c64.cuh"

#include <type_traits>

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

constexpr int BW_CONSUMERS = 2;                 // warpgroups
constexpr int BW_CWARPS = 4 * BW_CONSUMERS;     // one dX tile row each
constexpr int BW_CTHREADS = 32 * BW_CWARPS;
constexpr int BW_THREADS = BW_CTHREADS + 128;   // and a producer warpgroup
constexpr int BW_NST = 2;                       // ring of stages
constexpr int BW_HALO = (HALO_BYTES + 1023) / 1024 * 1024;  // the swizzle
constexpr int BW_STAGE = 3 * BW_HALO;           // g -> dz | z_i -> a_prev | z_prev
constexpr int BW_CHUNKS = HH * HW * 8;          // 16-byte chunks of a box
constexpr int BW_PER_THREAD = (BW_CHUNKS + BW_CTHREADS - 1) / BW_CTHREADS;
constexpr int BW_N = 2 * C + 9 * C * C;         // a partial row: stats | dW
// registers a thread: 168 at launch (65,536 / 384, in steps of 8); the
// producer's setmaxnreg.dec frees what the consumers' .inc takes
constexpr int BW_LAUNCH_REGS = 65536 / BW_THREADS / 8 * 8;
constexpr int BW_PRODUCER_REGS = 24;
constexpr int BW_CONSUMER_REGS = 240;
// dynamic shared memory, from a 1024-byte aligned base: weights | stages |
// vectors | the warps' sums | barriers: full and empty a stage
constexpr int BW_STAGE_OFF = W_BYTES;
constexpr int BW_VEC_OFF = BW_STAGE_OFF + BW_NST * BW_STAGE;
constexpr int BW_RED_OFF = BW_VEC_OFF + 8 * C * 4;
constexpr int BW_BAR_OFF = BW_RED_OFF + BW_CWARPS * 2 * C * 4;
constexpr int BW_SMEM = BW_BAR_OFF + 2 * BW_NST * 8 + 1024;
// the MMAs of a tile: 18 dX groups (a tap, two k16 steps), 8 dW groups (a
// tile row)
constexpr int DX_GROUPS = 18;
constexpr int DW_GROUPS = TH;
constexpr int GROUPS = DX_GROUPS + DW_GROUPS;
// dW of warpgroup w: the products of dy = 2w (N = 192: dx and the input
// channel) and half of dy = 1's (N = 96, from (dx, ci) = (0, 0) for w = 0
// and (1, 32) for w = 1)
constexpr int DW_BIG = 3 * C / 2;    // accumulators a thread: 64 x 192
constexpr int DW_SMALL = 3 * C / 4;  // 64 x 96

static_assert(TH == BW_CWARPS, "one dX tile row a consumer warp");
static_assert(BW_CTHREADS % 8 == 0, "a thread keeps one channel group");
static_assert(W_BYTES % 1024 == 0, "the swizzle atoms are 1024-aligned");
static_assert(BW_SMEM <= 232448, "one block fits the multiprocessor");
static_assert(128 * BW_PRODUCER_REGS + BW_CTHREADS * BW_CONSUMER_REGS <=
                  BW_THREADS * BW_LAUNCH_REGS,
              "the consumers take no more registers than the producer frees");

template <typename T>
struct BwdArgs {
  const T* g;  // (B, H, W, 64); the bf16 chain reads them through the maps
  const T* zi;
  const T* zp;
  const __nv_bfloat16* w;  // (3, 3, 64, 64) HWIO
  const float* vec;        // (8, 64)
  T* da;                   // (B, H, W, 64)
  float* partial;          // (blocks, BW_N)
  int B, H, W, tiles_y, tiles_x;
  int lo, hi;              // dz's rows
  int slo, shi;            // a_prev's and the sums' rows
};

struct Tile {
  int bi, y0, x0;
};

__device__ __forceinline__ Tile tile_at(unsigned tile, unsigned tiles_y,
                                        unsigned tiles_x) {
  const unsigned r = tile / tiles_x;
  return {(int)(r / tiles_y), (int)(r % tiles_y) * TH,
          (int)(tile - r * tiles_x) * TW};
}

// Halo pixel p of a tile: whether it lies in the image, and whether in dz's
// and a_prev's row windows.
struct HaloPixel {
  int y, x;
  bool dz, ap;
};

template <typename T>
__device__ __forceinline__ HaloPixel halo_pixel(const Tile& tl, int p,
                                                const BwdArgs<T>& a) {
  const int hy = p / HW, hx = p - hy * HW;
  HaloPixel h;
  h.y = tl.y0 + hy - 1;
  h.x = tl.x0 + hx - 1;
  const bool in = row_in(h.y, 0, a.H) && h.x >= 0 && h.x < a.W;
  h.dz = in && row_in(h.y, a.lo, a.hi);
  h.ap = in && row_in(h.y, a.slo, a.shi);
  return h;
}

__device__ __forceinline__ void unpack4(uint2 u, float v[4]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 f0 = __bfloat1622float2(h[0]), f1 = __bfloat1622float2(h[1]);
  v[0] = f0.x;
  v[1] = f0.y;
  v[2] = f1.x;
  v[3] = f1.y;
}

__device__ __forceinline__ uint2 pack4(const float v[4]) {
  uint2 u;
  u.x = bf16x2(v[0], v[1]);
  u.y = bf16x2(v[2], v[3]);
  return u;
}

// dz from g and z_i, a_prev from z_prev, one channel (k: its constants).
__device__ __forceinline__ void prologue1(const float (&cs)[6], float& v,
                                          float z, float& p) {
  const float gt = affine(cs[0], z, cs[1]) > 0.f ? v : 0.f;
  v = fmaf(cs[0], gt, fmaf(cs[2], z, cs[3]));
  p = fmaxf(affine(cs[4], p, cs[5]), 0.f);
}

// The constants (A, BI, B, C, SP, BP) of channel c from the vectors.
__device__ __forceinline__ void consts_of(const float* vs, int c,
                                          float (&cs)[6]) {
  cs[0] = vs[V_A * C + c];
  cs[1] = vs[V_BI * C + c];
  cs[2] = vs[V_B * C + c];
  cs[3] = vs[V_C * C + c];
  cs[4] = vs[V_SP * C + c];
  cs[5] = vs[V_BP * C + c];
}

// bf16 chain, consumer thread ct: the landed stage's g box becomes dz and
// its z_i box a_prev, in place, on the thread's chunks (one channel group
// of eight, four channels a pass so that 24 constants stay in registers).
__device__ __forceinline__ void prologue_in_place(
    unsigned char* st, const float* vs, const Tile& tl,
    const BwdArgs<__nv_bfloat16>& a, int ct) {
  const int chunk = ct & 7;
  // bit 2 i: the thread's chunk i lies in dz's window, bit 2 i + 1: in
  // a_prev's
  unsigned in = 0;
#pragma unroll
  for (int i = 0; i < BW_PER_THREAD; ++i) {
    const int e = ct + i * BW_CTHREADS;
    if (e >= BW_CHUNKS) break;
    const HaloPixel h = halo_pixel(tl, e >> 3, a);
    in |= (h.dz ? 1u : 0u) << (2 * i) | (h.ap ? 2u : 0u) << (2 * i);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float cs[4][6];
#pragma unroll
    for (int k = 0; k < 4; ++k) consts_of(vs, chunk * 8 + hh * 4 + k, cs[k]);
    uint2 ug[BW_PER_THREAD], uz[BW_PER_THREAD], up[BW_PER_THREAD];
#pragma unroll
    for (int i = 0; i < BW_PER_THREAD; ++i) {
      const int e = ct + i * BW_CTHREADS;
      if (e >= BW_CHUNKS) break;
      const int off = swz(e >> 3, chunk * 8) + hh * 8;
      ug[i] = *reinterpret_cast<const uint2*>(st + off);
      uz[i] = *reinterpret_cast<const uint2*>(st + BW_HALO + off);
      up[i] = *reinterpret_cast<const uint2*>(st + 2 * BW_HALO + off);
    }
#pragma unroll
    for (int i = 0; i < BW_PER_THREAD; ++i) {
      const int e = ct + i * BW_CTHREADS;
      if (e >= BW_CHUNKS) break;
      float v[4], z[4], p[4];
      unpack4(ug[i], v);
      unpack4(uz[i], z);
      unpack4(up[i], p);
#pragma unroll
      for (int k = 0; k < 4; ++k) prologue1(cs[k], v[k], z[k], p[k]);
      const int off = swz(e >> 3, chunk * 8) + hh * 8;
      *reinterpret_cast<uint2*>(st + off) =
          (in >> (2 * i)) & 1u ? pack4(v) : make_uint2(0u, 0u);
      *reinterpret_cast<uint2*>(st + BW_HALO + off) =
          (in >> (2 * i)) & 2u ? pack4(p) : make_uint2(0u, 0u);
    }
  }
}

// f32 chain, consumer thread ct: dz and a_prev from device memory into the
// stage's first two boxes, rounded to bf16, zeros outside the image and the
// windows.
__device__ __forceinline__ void prologue_loads(unsigned char* st,
                                               const float* vs, const Tile& tl,
                                               const BwdArgs<float>& a,
                                               int ct) {
  const int chunk = ct & 7;
  for (int e = ct; e < BW_CHUNKS; e += BW_CTHREADS) {
    const HaloPixel h = halo_pixel(tl, e >> 3, a);
    uint4 ud = make_uint4(0u, 0u, 0u, 0u), ua = ud;
    if (h.dz || h.ap) {
      const size_t off =
          (((size_t)tl.bi * a.H + h.y) * a.W + h.x) * C + chunk * 8;
      Chunk<float> cg, cz, cp;
      ldg(cg, a.g + off);
      ldg(cz, a.zi + off);
      ldg(cp, a.zp + off);
      float v[8], z[8], p[8];
      unpack(cg, v);
      unpack(cz, z);
      unpack(cp, p);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        float cs[6];
        consts_of(vs, chunk * 8 + k, cs);
        prologue1(cs, v[k], z[k], p[k]);
      }
      if (h.dz) ud = pack8(v);
      if (h.ap) ua = pack8(p);
    }
    *reinterpret_cast<uint4*>(st + swz(e >> 3, chunk * 8)) = ud;
    *reinterpret_cast<uint4*>(st + BW_HALO + swz(e >> 3, chunk * 8)) = ua;
  }
}

// z_prev at two channels of a tile pixel: from the stage (bf16 chain) or
// from device memory (f32 chain).
__device__ __forceinline__ float2 zprev2(const unsigned char* st, int p,
                                         int ch, const __nv_bfloat16*,
                                         size_t) {
  return load2(reinterpret_cast<const __nv_bfloat16*>(st + 2 * BW_HALO +
                                                      swz(p, ch)));
}
__device__ __forceinline__ float2 zprev2(const unsigned char*, int, int,
                                         const float* zp, size_t off) {
  return load2(zp + off);
}

// One step of a sum over lanes: the lane keeps N of its 2N values, the upper
// half where `upper`, each plus its partner's (lane ^ LANE) at the same slot.
template <int N, int LANE, int M>
__device__ __forceinline__ void reduce_scatter(float (&v)[M], int upper) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float keep = upper ? v[i + N] : v[i];
    const float send = upper ? v[i] : v[i + N];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, LANE);
  }
}

// Keeps the compiler from moving accesses of the accumulators across a
// wgmma fence or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

struct Acc {
  float dx[32];        // dX of the warp's tile row
  float big[DW_BIG];   // dW, dy = 2w
  float small[DW_SMALL];  // dW, half of dy = 1
};

__device__ __forceinline__ void fence_acc(Acc& c) {
  fence_regs(c.dx);
  fence_regs(c.big);
  fence_regs(c.small);
}

// ldmatrix lane roles. dX: A rows (pixels) and k halves, as the forward's.
// dW: A = dz^T from rows of pixels (.trans: matrix lane >> 3 holds k half
// lane >> 4 and m half (lane >> 3) & 1).
struct Lanes {
  int x_row, x_kh, a_k, a_mh;
};

// The fragments of group q: dX, tap q / 2 at k16 steps 2 (q % 2) ..; dW,
// dz^T of tile row q - DX_GROUPS (the warp's 16 output channels 16 wq ..).
__device__ __forceinline__ void load_group(uint32_t (&f)[2][4], int q,
                                           uint32_t dz_s, int row, int wq,
                                           const Lanes& l) {
  if (q < DX_GROUPS) {
    const int tap = q >> 1, dy = tap / 3, dx = tap % 3;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int k16 = 2 * (q & 1) + kk;
      ldsm_x4(dz_s + swz((row + dy) * HW + dx + l.x_row, 16 * k16 + 8 * l.x_kh),
              f[kk][0], f[kk][1], f[kk][2], f[kk][3]);
    }
  } else {
    const int r = q - DX_GROUPS;
    ldsm_x4_trans(dz_s + swz((r + 1) * HW + 1 + l.a_k, 16 * wq + 8 * l.a_mh),
                  f[0][0], f[0][1], f[0][2], f[0][3]);
  }
}

// B of dW: a_prev of halo row h from pixel dx as an MN-major operand, n =
// 64 dx' + ci at pixel dx + dx' (the next 64 n one pixel row, 128 bytes,
// on), k the pixel of the tile row.
__device__ __forceinline__ void issue_group(Acc& c, const uint32_t (&f)[2][4],
                                            int q, uint32_t ap_s, uint32_t w_s,
                                            int wg) {
  if (q < DX_GROUPS) {
    const int tap = q >> 1;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int k16 = 2 * (q & 1) + kk;
      wgmma_rs(c.dx, f[kk],
               desc_sw128(w_s + (8 - tap) * (C * 128) + k16 * 32));
    }
  } else {
    const int r = q - DX_GROUPS;
    wgmma_rs_n192_mn(c.big, f[0],
                     desc_sw128_mn(ap_s + (r + 2 * wg) * HW * 128, 128));
    wgmma_rs_n96_mn(c.small, f[0],
                    desc_sw128_mn(ap_s + (r + 1) * HW * 128 + wg * 192, 128));
  }
}

// All the MMAs of one tile; dX is zeroed here, dW accumulates. Three
// fragment sets: the loads of group q + 1 go out while groups q - 1 and q
// run. dX's groups come first: from the wait after group DX_GROUPS on,
// dX is final, and epilogue(0 .. EPI_PIECES - 1) runs after the issue of
// each following group, beside the tensor cores' dW products.
constexpr int EPI_PIECES = 5;
static_assert(DX_GROUPS + 1 + EPI_PIECES <= GROUPS, "dW groups to hide in");

template <typename Epilogue>
__device__ __forceinline__ void tile_mmas(Acc& c, uint32_t dz_s,
                                          uint32_t ap_s, uint32_t w_s,
                                          int row, int wg, int wq,
                                          const Lanes& l, Epilogue epilogue) {
#pragma unroll
  for (int i = 0; i < 32; ++i) c.dx[i] = 0.f;
  uint32_t f[3][2][4];
  load_group(f[0], 0, dz_s, row, wq, l);
#pragma unroll
  for (int q = 0; q < GROUPS; ++q) {
    fence_acc(c);
    wg_fence();
    issue_group(c, f[q % 3], q, ap_s, w_s, wg);
    wg_commit();
    if (q + 1 < GROUPS) load_group(f[(q + 1) % 3], q + 1, dz_s, row, wq, l);
    const int piece = q - DX_GROUPS - 1;
    if (piece >= 0 && piece < EPI_PIECES) {
      fence_regs(c.dx);
      epilogue(piece);
    }
    wg_wait<1>();
  }
  wg_wait<0>();
  fence_acc(c);
}

// g, z_i, z_prev through maps over (C, W, H, B) with (64, 18, 10, 1) boxes
// in the 128-byte swizzle (the bf16 chain; unused on the f32 chain).
// STATS: the BN-backward sums (not first_layer).
template <typename T, bool STATS>
__global__ void __launch_bounds__(BW_THREADS, 1)
bwd_layer_k(const BwdArgs<T> a, const __grid_constant__ CUtensorMap mg,
            const __grid_constant__ CUtensorMap mz,
            const __grid_constant__ CUtensorMap mp) {
  extern __shared__ unsigned char smem_raw[];
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  const uint32_t raw_s = (uint32_t)__cvta_generic_to_shared(smem_raw);
  unsigned char* smem = smem_raw + (((raw_s + 1023) & ~1023u) - raw_s);
  const uint32_t smem_s = (uint32_t)__cvta_generic_to_shared(smem);
  float* vs = reinterpret_cast<float*>(smem + BW_VEC_OFF);
  float* red = reinterpret_cast<float*>(smem + BW_RED_OFF);  // [warp][2][C]
  const uint32_t full0 = smem_s + BW_BAR_OFF, empty0 = full0 + BW_NST * 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int H = a.H, W = a.W;

  // the weights as they are: row tap * 64 + ci holds the 64 co
  for (int idx = tid; idx < 9 * C * 8; idx += BW_THREADS) {
    const uint4 u = reinterpret_cast<const uint4*>(a.w)[idx];
    *reinterpret_cast<uint4*>(smem + swz(idx >> 3, (idx & 7) * 8)) = u;
  }
  for (int idx = tid; idx < 8 * C; idx += BW_THREADS) vs[idx] = a.vec[idx];
  if (tid == 0) {
    for (int s = 0; s < BW_NST; ++s) {
      mbar_init(full0 + 8 * s, 1);           // the TMA loads' bytes
      mbar_init(empty0 + 8 * s, BW_CWARPS);  // the consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the weights are read by the tensor cores through the async proxy
  fence_async_shared();
  __syncthreads();

  // the block's tiles: blockIdx.x + i * gridDim.x, i = 0 .. n - 1 (the
  // host keeps the tile count below 2^31)
  const unsigned ntiles = (unsigned)a.B * a.tiles_y * a.tiles_x;
  const int n = (int)((ntiles - blockIdx.x + gridDim.x - 1) / gridDim.x);
  auto tile_of = [&](int i) {
    return tile_at(blockIdx.x + (unsigned)i * gridDim.x, a.tiles_y,
                   a.tiles_x);
  };

  if (warp >= BW_CWARPS) {
    // the producer warpgroup: every tile's three boxes into the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        BW_PRODUCER_REGS));
    if (BF16 && tid == BW_CTHREADS) {
      for (int i = 0; i < n; ++i) {
        const int s = i % BW_NST;
        if (i >= BW_NST) mbar_wait(empty0 + 8 * s, (i / BW_NST - 1) & 1);
        const Tile tl = tile_of(i);
        const uint32_t bar = full0 + 8 * s;
        const uint32_t dst = smem_s + BW_STAGE_OFF + s * BW_STAGE;
        mbar_expect_tx(bar, 3 * HALO_BYTES);
        tma_load_4d(dst, &mg, bar, 0, tl.x0 - 1, tl.y0 - 1, tl.bi);
        tma_load_4d(dst + BW_HALO, &mz, bar, 0, tl.x0 - 1, tl.y0 - 1, tl.bi);
        tma_load_4d(dst + 2 * BW_HALO, &mp, bar, 0, tl.x0 - 1, tl.y0 - 1,
                    tl.bi);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      BW_CONSUMER_REGS));
  const int wg = warp >> 2, wq = warp & 3, ct = tid;
  const int row = warp;  // the warp's dX tile row: 4 wg + wq
  const int gq = lane >> 2, t = lane & 3;
  const Lanes l = {(lane & 7) + ((lane >> 3) & 1) * 8, lane >> 4,
                   (lane & 7) + (lane >> 4) * 8, (lane >> 3) & 1};
  Acc c;
#pragma unroll
  for (int i = 0; i < DW_BIG; ++i) c.big[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DW_SMALL; ++i) c.small[i] = 0.f;
  float (&dx)[32] = c.dx;
  // the BN-backward sums over the block's tiles, one of each epilogue
  // piece k: stat gq / 4 of channel 8 (2 k + gq / 2 % 2) + 2 t + gq % 2
  float sums[4] = {0.f, 0.f, 0.f, 0.f};

  for (int i = 0; i < n; ++i) {
    const int s = i % BW_NST;
    const Tile tl = tile_of(i);
    unsigned char* st = smem + BW_STAGE_OFF + s * BW_STAGE;
    const uint32_t dz_s = smem_s + BW_STAGE_OFF + s * BW_STAGE;
    if constexpr (BF16) {
      mbar_wait(full0 + 8 * s, (i / BW_NST) & 1);
      prologue_in_place(st, vs, tl, a, ct);
    } else {
      prologue_loads(st, vs, tl, a, ct);
    }
    // dz is read by wgmma through the async proxy
    fence_async_shared();
    named_sync(1, BW_CTHREADS);

    // the epilogue, in pieces run while the tile's dW products do (dx is
    // final once the dX groups are): dx[4 n8 + 2 half + q] is pixel
    // gq + 8 half of tile row `row`, channel 8 n8 + 2 t + q
    const int y = tl.y0 + row;
    auto epilogue = [&](int piece) {
      if (piece < 4) {
        if constexpr (STATS) {
          // the tile's sums of channels 8 n8 + 2 t + q, n8 = 2 piece ..
          // 2 piece + 1, over the thread's two pixels, branch-free:
          // v[4 k + 2 (n8 % 2) + q] = stat k
          const bool summed = row_in(y, a.slo, a.shi);
          float v[8];
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const int n8 = 2 * piece + m, ch = 8 * n8 + 2 * t;
            const float2 sp =
                *reinterpret_cast<const float2*>(vs + V_SP * C + ch);
            const float2 bp =
                *reinterpret_cast<const float2*>(vs + V_BP * C + ch);
            const float2 rs =
                *reinterpret_cast<const float2*>(vs + V_RSTDP * C + ch);
            const float2 nm =
                *reinterpret_cast<const float2*>(vs + V_NMRP * C + ch);
            float s0[2] = {0.f, 0.f}, s1[2] = {0.f, 0.f};
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int x = tl.x0 + gq + 8 * half;
              const bool in = summed && x < W;
              const float2 z =
                  in ? zprev2(st, (row + 1) * HW + 1 + gq + 8 * half, ch,
                              a.zp, (((size_t)tl.bi * H + y) * W + x) * C + ch)
                     : make_float2(0.f, 0.f);
              const float v0 = dx[4 * n8 + 2 * half];
              const float v1 = dx[4 * n8 + 2 * half + 1];
              const float g0 = in && affine(sp.x, z.x, bp.x) > 0.f ? v0 : 0.f;
              const float g1 = in && affine(sp.y, z.y, bp.y) > 0.f ? v1 : 0.f;
              s0[0] += g0;
              s0[1] += g1;
              s1[0] = fmaf(g0, fmaf(rs.x, z.x, nm.x), s1[0]);
              s1[1] = fmaf(g1, fmaf(rs.y, z.y, nm.y), s1[1]);
            }
            v[2 * m] = s0[0];
            v[2 * m + 1] = s0[1];
            v[4 + 2 * m] = s1[0];
            v[4 + 2 * m + 1] = s1[1];
          }
          // over the 8 row groups of the warp (lanes of equal t), halving
          // the slots a lane keeps at each step: lane gq ends with slot gq
          reduce_scatter<4, 16>(v, gq & 4);
          reduce_scatter<2, 8>(v, gq & 2);
          reduce_scatter<1, 4>(v, gq & 1);
          sums[piece] += v[0];
        }
      } else if constexpr (BF16) {
        // da_prev through the stage's z_prev row, which only this warp reads
        // after the prologue: stmatrix, then 16-byte stores of whole pixels
        __syncwarp();
        const uint32_t zp_s = dz_s + 2 * BW_HALO;
        const int p_l = (row + 1) * HW + 1 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int n8 = 0; n8 < 8; n8 += 2)
          stsm_x4(zp_s + swz(p_l, 8 * (n8 + (lane >> 4))),
                  bf16x2(dx[4 * n8], dx[4 * n8 + 1]),
                  bf16x2(dx[4 * n8 + 2], dx[4 * n8 + 3]),
                  bf16x2(dx[4 * n8 + 4], dx[4 * n8 + 5]),
                  bf16x2(dx[4 * n8 + 6], dx[4 * n8 + 7]));
        __syncwarp();
#pragma unroll
        for (int k = 0; k < TW / 4; ++k) {
          const int px = (lane >> 3) + 4 * k, c8 = lane & 7;
          const int x = tl.x0 + px;
          const uint4 u = *reinterpret_cast<const uint4*>(
              st + 2 * BW_HALO + swz((row + 1) * HW + 1 + px, 8 * c8));
          if (y < H && x < W)
            *reinterpret_cast<uint4*>(
                a.da + (((size_t)tl.bi * H + y) * W + x) * C + 8 * c8) = u;
        }
      } else {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int x = tl.x0 + gq + 8 * half;
          if (y >= H || x >= W) continue;
          T* dst = a.da + (((size_t)tl.bi * H + y) * W + x) * C + 2 * t;
#pragma unroll
          for (int n8 = 0; n8 < 8; ++n8)
            store2(dst + 8 * n8, dx[4 * n8 + 2 * half],
                   dx[4 * n8 + 2 * half + 1]);
        }
      }
    };
    tile_mmas(c, dz_s, dz_s + BW_HALO, smem_s, row, wg, wq, l, epilogue);
    // the warp is done with the stage; its next writer on the bf16 chain is
    // the TMA engine (the async proxy)
    fence_async_shared();
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  }

  // the block's partial row: the warps' sums in order, then dW
#pragma unroll
  for (int k = 0; k < 4; ++k)
    red[warp * 2 * C + (gq >> 2) * C + 8 * (2 * k + ((gq >> 1) & 1)) + 2 * t +
        (gq & 1)] = sums[k];
  named_sync(1, BW_CTHREADS);
  float* row_out = a.partial + (size_t)blockIdx.x * BW_N;
  if (ct < 2 * C) {
    float sum = 0.f;
#pragma unroll
    for (int wi = 0; wi < BW_CWARPS; ++wi) sum += red[wi * 2 * C + ct];
    row_out[ct] = sum;
  }
  // accumulator 4 j + 2 half + e: output channel 16 wq + gq + 8 half, n =
  // 8 j + 2 t + e, that is (dx, input channel) = (n / 64, n % 64) of dy = 2w
  // (big) and n + 96 w of dy = 1 (small)
  float* dw = row_out + 2 * C;
#pragma unroll
  for (int i = 0; i < DW_BIG; ++i) {
    const int n = 8 * (i >> 2) + 2 * t + (i & 1);
    const int co = 16 * wq + gq + 8 * ((i >> 1) & 1);
    dw[((3 * (2 * wg) + (n >> 6)) * C + (n & 63)) * C + co] = c.big[i];
  }
#pragma unroll
  for (int i = 0; i < DW_SMALL; ++i) {
    const int n = 8 * (i >> 2) + 2 * t + (i & 1) + 96 * wg;
    const int co = 16 * wq + gq + 8 * ((i >> 1) & 1);
    dw[((3 + (n >> 6)) * C + (n & 63)) * C + co] = c.small[i];
  }
}

// Rows: dz's window [lo, hi), a_prev's and the sums' [slo, shi).
struct Rows {
  int lo, hi, slo, shi;
};

template <typename T, bool STATS>
int launch(const void* g, const void* z_i, const void* z_prev, const void* w,
           const float* vec, void* da, float* out, float* partial,
           int max_blocks, int B, int H, int W, const Rows& r, void* stream) {
  static Resident resident;  // one for each instantiation of the kernel
  auto kern = bwd_layer_k<T, STATS>;
  constexpr bool F32 = std::is_same<T, float>::value;
  BwdArgs<T> a = {};
  a.g = static_cast<const T*>(g);
  a.zi = static_cast<const T*>(z_i);
  a.zp = static_cast<const T*>(z_prev);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.vec = vec;
  a.da = static_cast<T*>(da);
  a.partial = partial;
  a.B = B;
  a.H = H;
  a.W = W;
  a.tiles_y = (H + TH - 1) / TH;
  a.tiles_x = (W + TW - 1) / TW;
  a.lo = r.lo;
  a.hi = r.hi;
  a.slo = r.slo;
  a.shi = r.shi;
  const long ntiles = (long)B * a.tiles_y * a.tiles_x;
  if (ntiles >= (1l << 31)) return (int)cudaErrorInvalidValue;
  int grid = 0;
  int rc = persistent_grid(kern, BW_THREADS, BW_SMEM, ntiles, max_blocks,
                           &resident, &grid);
  if (rc != 0) return rc;
  CUtensorMap mg = {}, mz = {}, mp = {};
  if (!F32) {
    rc = tensor_map(g, false, B, H, W, 0, H, HW, HH, &mg);
    if (rc == 0) rc = tensor_map(z_i, false, B, H, W, 0, H, HW, HH, &mz);
    if (rc == 0) rc = tensor_map(z_prev, false, B, H, W, 0, H, HW, HH, &mp);
    if (rc != 0) return rc;
  }
  kern<<<grid, BW_THREADS, BW_SMEM, (cudaStream_t)stream>>>(a, mg, mz, mp);
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
