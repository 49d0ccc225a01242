// Hopper (sm_90a) forward kernels of the DnCNN 64->64 mid layers: one
// 3x3 SAME convolution body on wgmma, conv3x3_fwd<T, PRO, EPI>, behind three
// entry points:
//
//   f2f_fwd_layer        z = conv3x3(relu(s * z_prev + b))      PRO_AFFINE
//     replaces frame2frame_tpu/ops/fused_stack.py: fwd_layer (_fwd_kernel),
//     eval route emit_stats=False, with or without stack=.
//   f2f_fwd_layer_train  the same z, and per channel sum(z), sum(z^2)
//     replaces fwd_layer (_fwd_kernel) with emit_stats=True, the training
//     forward (PRO_AFFINE, EPI_STATS). The TPU kernel adds each tile's sums
//     into one block that a sequential grid revisits; here every persistent
//     block writes one row of partial sums and finish_sums adds the rows in
//     block order, so the batch statistics are the same bits on every run.
//     The sums are taken from the f32 accumulator, before z is rounded.
//   f2f_fwd_layer_eval   a = relu(s * conv3x3(a_prev, w) + b)    EPI_AFFINE
//     replaces frame2frame_tpu/ops/fused_stack.py: fwd_layer_eval
//     (_fwd_eval_kernel). The TPU kernel folds the BN scale s into its
//     weights; rounding w * s to bf16 moved served DnCNN-17 pixels by up to
//     0.045 against the f32 forward (540p), so s scales the f32 accumulator
//     here, one FMA an output.
//
// Zero padding applies to the operand AFTER the prologue: pixels outside the
// image are zeros in the halo tile, never relu(b). Frames of a batch are
// isolated by the same per-image padding. The prologue is affine(), a
// rounded product plus a rounded sum, so the backward kernel's ReLU masks
// and the plain versions agree with it on every pixel. MMA operands are
// rounded to bf16 on either chain, as the TPU's matrix unit rounds them at
// default precision.
//
// The *_window entry points take a row window for a slab of a frame split
// by rows (ops/fused_spatial.py): the operand is zero at rows outside
// [lo, hi), as at the image's border, and the training sums count rows
// [slo, shi) only, the slab's body rows that are rows of the frame. This is
// the valid_bounds input of the same TPU kernels. The input's tensor map
// spans rows [lo, hi) only, so TMA's zero fill pads the window as it pads
// the image; the prologue and the f32 chain's conversion test the same
// window. The entry points without a window run the same body with the
// window [0, H).
//
// Bound at 540p (1 x 540 x 960 x 64, bf16 storage), per layer and frame:
//   bytes      2 * 540*960*64 * 2    = 132.7 MB  -> 39.6 us at 3.35 TB/s;
//   operations 2 * 540*960 * 64*64*9 = 38.2 GFLOP -> 38.6 us at 989 TFLOP/s.
// The layer sits at balance: the tensor cores must run near their peak and
// device memory must stream without pause for the bound to be reached.
//
// What held the mma.sync body before this one back, and what this one does:
//   * every warp loaded all 73.7 KB of weight fragments through ldmatrix on
//     every 8 x 16 tile (295 KB of shared-memory reads a tile, more than the
//     whole byte bound over a frame). Here the weights are the B operand of
//     wgmma.m64n64k16, read by the tensor cores straight from shared memory
//     through a matrix descriptor: they are written there once a persistent
//     block, transposed to K-major rows of 128 bytes in the 128-byte swizzle
//     (the 64 input channels of one output channel a row, 8 KB a tap);
//   * loads and MMAs never overlapped inside a block. Here one thread of a
//     producer warpgroup keeps a ring of four halo stages filled by TMA (a
//     4-D map (C, W, H, B), box (64, 18, 10, 1) at (0, x0 - 1, y0 - 1, b):
//     the hardware's zero fill is the per-image padding, its 128-byte
//     swizzle the layout ldmatrix reads), each stage signalled by an
//     mbarrier; three consumer warpgroups take the tiles in turn, so one
//     runs its MMAs while the others run prologues and epilogues;
//   * 4 warps, 2 blocks an SM hid latency with 8 warps. Here one block an
//     SM holds 16 warps, and wgmma is asynchronous: a warpgroup loads the A
//     fragments of its next group while two groups of MMAs run. setmaxnreg
//     gives the consumers 160 registers a thread and the producer 24 (128
//     each at launch).
// The A operand (pixels x input channels) is taken from registers: each
// warp of a warpgroup owns two output rows of 16 pixels of the warpgroup's
// 8 x 16 tile (acc[j], rows 2w + j, one m64 each over the warpgroup) and
// loads its fragments with ldmatrix from the swizzled halo tile, as
// mma.sync's A. A fragment of halo row 2w + h, shifted by dx, serves every
// (j, dy) with j + dy = h: 48 ldmatrix a warp and tile in place of 72, 72
// wgmma a tile.
//
// The prologue (PRO_AFFINE: relu(s * z + b), rounded to bf16) is applied
// once a halo tile, in place in shared memory, by the consuming warpgroup
// after the TMA load lands: halo pixels outside the image stay zeros. The
// epilogue goes through shared memory: the warpgroup writes its bf16 tile
// with stmatrix from the accumulator layout and one thread stores it with
// TMA (a box (64, 16, 8, 1); rows and columns past the image are not
// written).
//
// What the card said about the alternatives (my chip runs, NVIDIA H100 80GB
// HBM3, 700 W; ms at 540p B=1 bf16): with the A operand also read by wgmma
// from shared memory (tiles of 2 x 64 pixels, descriptors at any 128-byte
// row: the swizzle follows the absolute address, base offset 0), eval took
// 0.101 and the affine form 0.155, bound by the operands' shared-memory
// reads; wgmma of N = 128 or 192 over the taps that share a fragment made
// ptxas serialise every wgmma ("insufficient register resources for the
// wgmma pipeline"); the prologue applied to the A fragments in registers
// lengthened each group's path (fwd 0.121); the halo copied by cp.async
// from a producer warp and the prologue applied by it stalled behind the
// consumers' shared-memory traffic (0.15); stores straight from the
// accumulators (4 bytes a lane) took 25-40 % of a warpgroup's time; the
// training sums reduced each tile (shuffles into shared memory) doubled the
// training form's time against sums kept in registers to the end. The
// number of fragment sets and k16 steps a commit group follows ptxas's
// spills: 3 sets of 4 steps where the epilogue holds nothing, 3 sets of 2
// steps where it holds the affine's constants or the sums.
//
// The f32 chain (strict mode): the producer's TMA lands each raw f32 halo
// tile (256 bytes a pixel, unswizzled) in the space of the bf16 chain's
// output tiles, one tile at a time, and the tile's warpgroup converts it
// into a stage of its own, the prologue applied, rounded to bf16. Staging
// through registers, by the producer or by each warpgroup, was bound by the
// loads in flight (0.18-0.22 ms at 540p, slower than the mma.sync body).
// Its epilogue stores f32 pairs straight from the accumulators.
//
// Per-channel sums (EPI_STATS): each thread keeps its sums over all its
// tiles in registers, from the f32 accumulator before z is rounded and over
// the image's pixels only; at the end the warps add their lanes by shuffles
// and the block adds the twelve warps' rows in order and writes one row of
// partials. Fixed order throughout: the same bits on every run.

#include "conv3x3_c64.cuh"

#include <type_traits>

namespace {

using namespace f2f;

enum Prologue { PRO_NONE = 0, PRO_AFFINE = 1 };
enum Epilogue { EPI_NONE = 0, EPI_AFFINE = 1, EPI_STATS = 2 };

// TH x TW (8 x 16) output tiles with their HH x HW halo (conv3x3_c64.cuh)
constexpr int RPW = TH / 4;              // output rows a warp
constexpr int F_CHUNKS = HH * HW * 8;    // 16-byte chunks of a halo tile
constexpr int F_STAGE = (HALO_BYTES + 1023) / 1024 * 1024;  // TMA's swizzle
constexpr int F_OUT = TH * TW * C * 2;   // a bf16 output tile
constexpr int F_NST = 4;                 // ring of halo stages
constexpr int F_CONSUMERS = 3;           // warpgroups
constexpr int F_CWARPS = 4 * F_CONSUMERS;
constexpr int F_THREADS = F_CWARPS * 32 + 128;  // and a producer warpgroup
// registers a thread after setmaxnreg (65536 / 512 = 128 each at launch):
// one producer thread issues TMA loads, the consumers do the rest
constexpr int F_PRODUCER_REGS = 24;
constexpr int F_CONSUMER_REGS = 160;
// dynamic shared memory, from a 1024-byte aligned base: transposed weights |
// halo stages | output tiles, one a consumer warpgroup | s, b | the warps'
// sums | barriers: full and empty a stage, the f32 landing zone's
constexpr int F_STAGE_OFF = W_BYTES;
constexpr int F_OUT_OFF = F_STAGE_OFF + F_NST * F_STAGE;
constexpr int F_VEC_OFF = F_OUT_OFF + F_CONSUMERS * F_OUT;
constexpr int F_RED_OFF = F_VEC_OFF + 2 * C * 4;
constexpr int F_BAR_OFF = F_RED_OFF + F_CWARPS * 2 * C * 4;
constexpr int F_SMEM = F_BAR_OFF + (2 * F_NST + F_CONSUMERS + 1) * 8 + 1024;
// f32 chain: the raw f32 halo tile lands where the bf16 chain keeps its
// output tiles (the f32 epilogue stores straight from the accumulators)
constexpr int F_LAND = HH * HW * C * 4;

static_assert(TH % 4 == 0, "the warps of a warpgroup split the tile rows");
static_assert(W_BYTES % 1024 == 0 && F_OUT % 1024 == 0,
              "the swizzle atoms are 1024-aligned");
static_assert(F_SMEM <= 232448, "one block fits the multiprocessor");
static_assert(F_NST >= F_CONSUMERS, "a stage a warpgroup on the f32 chain");
static_assert(F_LAND <= F_CONSUMERS * F_OUT, "the f32 halo fits");
static_assert(128 * F_PRODUCER_REGS + F_CWARPS * 32 * F_CONSUMER_REGS <=
                  65536, "the block's registers hold both roles");

// (the input comes through its TMA map)
template <typename T>
struct FwdArgs {
  const __nv_bfloat16* w;       // (3, 3, 64, 64) HWIO
  const float* s;               // (64,) PRO_AFFINE or EPI_AFFINE
  const float* b;
  T* out;                       // (B, H, W, 64)
  float* partial;               // (blocks, 2, 64) EPI_STATS
  int B, H, W, tiles_y, tiles_x;
  int lo, hi;                   // rows of the operand: its row window
  int slo, shi;                 // rows that EPI_STATS sums
};

// --- wgmma -----------------------------------------------------------------

// Keeps the compiler from moving accesses of the accumulators across a
// wgmma fence or wait.
__device__ __forceinline__ void fence_acc(float (&d)[RPW][32]) {
#pragma unroll
  for (int j = 0; j < RPW; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[j][i])::"memory");
}

// The box of `map` at (c0, c1, c2, c3) from shared memory at src to global
// memory; elements outside the tensor are not written. Completion by bulk
// group of the issuing thread.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until the bulk stores of this thread have read their shared memory
__device__ __forceinline__ void tma_store_read_wait() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// --- the tile --------------------------------------------------------------

struct FTile {
  int bi, y0, x0;
};

__device__ __forceinline__ FTile ftile_at(unsigned tile, unsigned tiles_y,
                                          unsigned tiles_x) {
  const unsigned r = tile / tiles_x;
  return {(int)(r / tiles_y), (int)(r % tiles_y) * TH,
          (int)(tile - r * tiles_x) * TW};
}

// Halo pixel p of a tile: its image coordinates and whether it lies in the
// operand: in the row window [lo, hi) and the image's columns.
__device__ __forceinline__ bool fhalo_pixel(const FTile& tl, int p, int lo,
                                            int hi, int W, int& y, int& x) {
  const int hy = p / HW, hx = p - hy * HW;
  y = tl.y0 + hy - 1;
  x = tl.x0 + hx - 1;
  return row_in(y, lo, hi) && x >= 0 && x < W;
}

constexpr int PER_THREAD = (F_CHUNKS + 127) / 128;  // chunks of 128 threads

// bf16 chain, PRO_AFFINE, thread ct of a consumer warpgroup: relu(s * z + b)
// in place on its chunks of the landed halo tile, in the operand's rows
// [lo, hi); the zeros outside stay zeros.
__device__ __forceinline__ void prologue_in_place(unsigned char* st,
                                                  const float* vs,
                                                  const FTile& tl, int lo,
                                                  int hi, int W, int ct) {
  const int chunk = ct & 7;
  float ps[8], pb[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    ps[k] = vs[chunk * 8 + k];
    pb[k] = vs[C + chunk * 8 + k];
  }
  constexpr int NB = 4;  // chunks loaded before any is rewritten
  static_assert(PER_THREAD % NB == 0, "whole batches");
#pragma unroll 1
  for (int i0 = 0; i0 < PER_THREAD; i0 += NB) {
    Chunk<__nv_bfloat16> c[NB];
    bool inside[NB];
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int e = ct + (i0 + i) * 128;
      int y, x;
      inside[i] = e < F_CHUNKS && fhalo_pixel(tl, e >> 3, lo, hi, W, y, x);
      if (inside[i])
        c[i].u = *reinterpret_cast<const uint4*>(st + swz(e >> 3, chunk * 8));
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      if (!inside[i]) continue;
      float v[8];
      unpack(c[i], v);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        v[k] = fmaxf(affine(ps[k], v[k], pb[k]), 0.f);
      const int e = ct + (i0 + i) * 128;
      *reinterpret_cast<uint4*>(st + swz(e >> 3, chunk * 8)) = pack8(v);
    }
  }
}

// f32 chain, thread ct of a consumer warpgroup: its chunks of the landed f32
// halo tile (256 bytes a pixel) into the warpgroup's stage, after the
// prologue, rounded to bf16, zeros outside the operand's rows [lo, hi) and
// the image's columns.
template <int PRO>
__device__ __forceinline__ void convert_f32(unsigned char* st,
                                            const unsigned char* land,
                                            const float* vs, const FTile& tl,
                                            int lo, int hi, int W, int ct) {
  const int chunk = ct & 7;
  float ps[8], pb[8];
  if constexpr (PRO == PRO_AFFINE) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      ps[k] = vs[chunk * 8 + k];
      pb[k] = vs[C + chunk * 8 + k];
    }
  }
  constexpr int NB = 4;  // chunks loaded before any is converted
  static_assert(PER_THREAD % NB == 0, "whole batches");
#pragma unroll 1
  for (int i0 = 0; i0 < PER_THREAD; i0 += NB) {
    Chunk<float> raw[NB];
    bool inside[NB];
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int e = ct + (i0 + i) * 128;
      int y, x;
      inside[i] = e < F_CHUNKS && fhalo_pixel(tl, e >> 3, lo, hi, W, y, x);
      if (inside[i]) {
        const float4* q = reinterpret_cast<const float4*>(
            land + (e >> 3) * (C * 4) + chunk * 32);
        raw[i].a = q[0];
        raw[i].b = q[1];
      }
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int e = ct + (i0 + i) * 128;
      if (e >= F_CHUNKS) continue;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (inside[i]) {
        float v[8];
        unpack(raw[i], v);
        if constexpr (PRO == PRO_AFFINE) {
#pragma unroll
          for (int k = 0; k < 8; ++k)
            v[k] = fmaxf(affine(ps[k], v[k], pb[k]), 0.f);
        }
        u = pack8(v);
      }
      *reinterpret_cast<uint4*>(st + swz(e >> 3, chunk * 8)) = u;
    }
  }
}

// The MMAs of one tile into acc (zeroed here): for each halo row h of the
// warp, shift dx and KG of the four k16 steps, one load of A fragments and
// a wgmma a k16 step for each tap dy that uses them (output row j = h - dy):
// 72 wgmma in 12 * 4 / KG commit groups. With NSETS = 3 register sets the
// fragments of group q + 1 are loaded while groups q - 1 and q run; with 2,
// once group q - 1 is done. release() is called once the wgmma of the last
// group are issued: their A fragments, the last reads of the stage, have
// arrived in registers.
template <int KG>
__device__ __forceinline__ void load_group(uint32_t (&a)[KG][4], uint32_t hs_s,
                                           int q, int wq, int a_row,
                                           int a_kh) {
  constexpr int KS = 4 / KG;  // groups a (h, dx)
  const int h = q / (3 * KS), dx = q / KS % 3, k0 = q % KS * KG;
  const int p = (RPW * wq + h) * HW + dx + a_row;
#pragma unroll
  for (int kk = 0; kk < KG; ++kk)
    ldsm_x4(hs_s + swz(p, (k0 + kk) * 16 + 8 * a_kh), a[kk][0], a[kk][1],
            a[kk][2], a[kk][3]);
}

template <int NSETS, int KG, typename Release>
__device__ __forceinline__ void tile_mmas(float (&acc)[RPW][32],
                                          uint32_t hs_s, uint32_t ws_s,
                                          int wq, int lane, Release release) {
  constexpr int KS = 4 / KG;
  constexpr int GROUPS = 3 * (RPW + 2) * KS;
#pragma unroll
  for (int j = 0; j < RPW; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
  // ldmatrix lanes: A rows (pixels of the warp's output row) and k halves
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_kh = lane >> 4;
  uint32_t a[NSETS][KG][4];
  load_group<KG>(a[0], hs_s, 0, wq, a_row, a_kh);
#pragma unroll
  for (int q = 0; q < GROUPS; ++q) {
    const int h = q / (3 * KS), dx = q / KS % 3, k0 = q % KS * KG;
    fence_acc(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KG; ++kk) {
#pragma unroll
      for (int j = 0; j < RPW; ++j) {
        const int dy = h - j;
        if (dy < 0 || dy > 2) continue;
        wgmma_rs(acc[j], a[q % NSETS][kk],
                 desc_sw128(ws_s + (3 * dy + dx) * (C * 128) + (k0 + kk) * 32));
      }
    }
    wg_commit();
    if (q + 1 == GROUPS) release();
    if (NSETS > 2 && q + 1 < GROUPS)
      load_group<KG>(a[(q + 1) % NSETS], hs_s, q + 1, wq, a_row, a_kh);
    wg_wait<1>();
    if (NSETS == 2 && q + 1 < GROUPS)
      load_group<KG>(a[(q + 1) % NSETS], hs_s, q + 1, wq, a_row, a_kh);
  }
  wg_wait<0>();
  fence_acc(acc);
}

// map: the input as a 4-D tensor (C, W, H, B) with an HH x HW pixel box, in
// the 128-byte swizzle for bf16; omap: the bf16 output with a TH x TW box in
// the same swizzle (unused on the f32 chain).
template <typename T, int PRO, int EPI>
__global__ void __launch_bounds__(F_THREADS, 1)
conv3x3_fwd(const FwdArgs<T> a, const __grid_constant__ CUtensorMap map,
            const __grid_constant__ CUtensorMap omap) {
  extern __shared__ unsigned char smem_raw[];
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr bool SUMS = EPI == EPI_STATS;
  const uint32_t raw_s = (uint32_t)__cvta_generic_to_shared(smem_raw);
  unsigned char* smem = smem_raw + (((raw_s + 1023) & ~1023u) - raw_s);
  const uint32_t smem_s = (uint32_t)__cvta_generic_to_shared(smem);
  float* vs = reinterpret_cast<float*>(smem + F_VEC_OFF);
  float* red = reinterpret_cast<float*>(smem + F_RED_OFF);
  const uint32_t full0 = smem_s + F_BAR_OFF, empty0 = full0 + F_NST * 8;
  // f32 chain: the landing zone's barriers, loaded for warpgroup c's tile
  // and converted by it
  const uint32_t landed0 = empty0 + F_NST * 8;
  const uint32_t converted = landed0 + F_CONSUMERS * 8;
  unsigned char* land = smem + F_OUT_OFF;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int H = a.H, W = a.W;

  // weights, transposed to K-major rows: row tap * 64 + n holds the 64 input
  // channels of output channel n of tap (dy, dx) = (tap / 3, tap % 3)
  for (int idx = tid; idx < 9 * C * 8; idx += F_THREADS) {
    const uint4 u = reinterpret_cast<const uint4*>(a.w)[idx];
    const int r = idx >> 3, tap = r >> 6, k = r & (C - 1);
    const int n0 = (idx & 7) * 8;
    const unsigned short* h = reinterpret_cast<const unsigned short*>(&u);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      *reinterpret_cast<unsigned short*>(smem + swz(tap * C + n0 + e, k)) =
          h[e];
  }
  if (tid < 2 * C) {
    vs[tid] = (PRO == PRO_AFFINE || EPI == EPI_AFFINE)
                  ? (tid < C ? a.s[tid] : a.b[tid - C])
                  : 0.f;
  }
  if (tid == 0) {
    for (int st = 0; st < F_NST; ++st) {
      mbar_init(full0 + 8 * st, 1);   // the TMA load's bytes
      mbar_init(empty0 + 8 * st, 4);  // the consuming warpgroup's warps
    }
    for (int c = 0; c < F_CONSUMERS; ++c) mbar_init(landed0 + 8 * c, 1);
    mbar_init(converted, 1);
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
    return ftile_at(blockIdx.x + (unsigned)i * gridDim.x, a.tiles_y,
                    a.tiles_x);
  };
  auto stage = [&](int i) { return smem + F_STAGE_OFF + (i % F_NST) * F_STAGE; };

  if (warp >= F_CWARPS) {
    // the producer warpgroup: every tile's halo into the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        F_PRODUCER_REGS));
    const int pt = tid - F_CWARPS * 32;
    auto wait_empty = [&](int i) {
      if (i >= F_NST) mbar_wait(empty0 + 8 * (i % F_NST), (i / F_NST - 1) & 1);
    };
    if (BF16 && pt == 0) {  // one TMA load a tile, as soon as its stage is free
      for (int i = 0; i < n; ++i) {
        wait_empty(i);
        const uint32_t bar = full0 + 8 * (i % F_NST);
        const FTile tl = tile_of(i);
        mbar_expect_tx(bar, HALO_BYTES);
        tma_load_4d((uint32_t)__cvta_generic_to_shared(stage(i)), &map, bar,
                    0, tl.x0 - 1, tl.y0 - 1 - a.lo, tl.bi);
      }
    }
    if (!BF16 && pt == 0) {  // the f32 tiles through the one landing zone
      for (int i = 0; i < n; ++i) {
        if (i > 0) mbar_wait(converted, (i - 1) & 1);
        const uint32_t bar = landed0 + 8 * (i % F_CONSUMERS);
        const FTile tl = tile_of(i);
        mbar_expect_tx(bar, F_LAND);
        tma_load_4d((uint32_t)__cvta_generic_to_shared(land), &map, bar, 0,
                    tl.x0 - 1, tl.y0 - 1 - a.lo, tl.bi);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      F_CONSUMER_REGS));
  const int wg = warp >> 2, wq = warp & 3, ct = tid & 127;
  const int g = lane >> 2, t = lane & 3;
  unsigned char* out_s = smem + F_OUT_OFF + wg * F_OUT;
  // EPI_STATS: the thread's sums over all its tiles of its channels
  // 8 n + 2 t + q
  float s0[8][2], s1[8][2];
  if constexpr (SUMS) {
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
      for (int q = 0; q < 2; ++q) s0[n8][q] = s1[n8][q] = 0.f;
  }
  for (int i = wg; i < n; i += F_CONSUMERS) {
    const FTile tl = tile_of(i);
    // the f32 chain: the warpgroup's own stage, staged by itself
    const int st = BF16 ? i % F_NST : wg;
    unsigned char* hs = smem + F_STAGE_OFF + st * F_STAGE;
    if constexpr (BF16) {
      mbar_wait(full0 + 8 * st, (i / F_NST) & 1);
      if constexpr (PRO == PRO_AFFINE) {
        prologue_in_place(hs, vs, tl, a.lo, a.hi, W, ct);
        named_sync(1 + wg, 128);
      }
    } else {
      named_sync(1 + wg, 128);  // its last tile's fragments are read
      mbar_wait(landed0 + 8 * wg, (i / F_CONSUMERS) & 1);
      convert_f32<PRO>(hs, land, vs, tl, a.lo, a.hi, W, ct);
      named_sync(1 + wg, 128);
      // the landing zone's next writer is the TMA engine (the async proxy)
      fence_async_shared();
      if (ct == 0) mbar_arrive(converted);
    }

    float acc[RPW][32];
    // three fragment sets; half-size groups where the epilogue's constants
    // or sums hold registers, and on the f32 chain (fastest of the forms
    // measured on the card)
    constexpr int KG = BF16 && EPI == EPI_NONE ? 4 : 2;
    tile_mmas<3, KG>(
        acc, (uint32_t)__cvta_generic_to_shared(hs), smem_s, wq, lane, [&] {
          if constexpr (BF16) {
            // the stage's next writer is the TMA engine (the async proxy)
            fence_async_shared();
            __syncwarp();
            if (lane == 0) mbar_arrive(empty0 + 8 * st);
          }
        });

    // epilogue: acc[j][4 n + 2 half + q] is output row RPW wq + j, pixel
    // g + 8 half, channel 8 n + 2 t + q
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {
        float2 es, eb;
        if constexpr (EPI == EPI_AFFINE) {
          es = *reinterpret_cast<const float2*>(vs + 8 * n8 + 2 * t);
          eb = *reinterpret_cast<const float2*>(vs + C + 8 * n8 + 2 * t);
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float& v0 = acc[j][4 * n8 + 2 * half];
          float& v1 = acc[j][4 * n8 + 2 * half + 1];
          if constexpr (EPI == EPI_AFFINE) {
            v0 = fmaxf(fmaf(es.x, v0, eb.x), 0.f);
            v1 = fmaxf(fmaf(es.y, v1, eb.y), 0.f);
          }
          if constexpr (SUMS) {
            const int y = tl.y0 + RPW * wq + j, x = tl.x0 + g + 8 * half;
            if (!row_in(y, a.slo, a.shi) || x >= W) continue;  // not summed
            s0[n8][0] += v0;
            s0[n8][1] += v1;
            s1[n8][0] = fmaf(v0, v0, s1[n8][0]);
            s1[n8][1] = fmaf(v1, v1, s1[n8][1]);
          }
        }
      }
    }
    if constexpr (BF16) {
      // the tile through shared memory (stmatrix) and one TMA store; the
      // store of this warpgroup's tile before must have read its buffer
      if (ct == 0) tma_store_read_wait();
      named_sync(1 + wg, 128);
      const uint32_t o_s = (uint32_t)__cvta_generic_to_shared(out_s);
#pragma unroll
      for (int j = 0; j < RPW; ++j) {
        // matrix m of an x4: pixels 8 (m & 1) .., channels 8 (n8 + m / 2) ..
        const int p = (RPW * wq + j) * TW + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int n8 = 0; n8 < 8; n8 += 2)
          stsm_x4(o_s + swz(p, 8 * (n8 + (lane >> 4))),
                  bf16x2(acc[j][4 * n8], acc[j][4 * n8 + 1]),
                  bf16x2(acc[j][4 * n8 + 2], acc[j][4 * n8 + 3]),
                  bf16x2(acc[j][4 * n8 + 4], acc[j][4 * n8 + 5]),
                  bf16x2(acc[j][4 * n8 + 6], acc[j][4 * n8 + 7]));
      }
      fence_async_shared();
      named_sync(1 + wg, 128);
      if (ct == 0) tma_store_4d(&omap, o_s, 0, tl.x0, tl.y0, tl.bi);
    } else {
#pragma unroll
      for (int j = 0; j < RPW; ++j) {
        const int y = tl.y0 + RPW * wq + j;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int x = tl.x0 + g + 8 * half;
          if (y >= H || x >= W) continue;
          T* dst = a.out + (((size_t)tl.bi * H + y) * W + x) * C + 2 * t;
#pragma unroll
          for (int n8 = 0; n8 < 8; ++n8)
            store2(dst + 8 * n8, acc[j][4 * n8 + 2 * half],
                   acc[j][4 * n8 + 2 * half + 1]);
        }
      }
    }
  }
  if constexpr (BF16) {
    if (ct == 0) tma_store_wait();
  }

  if constexpr (SUMS) {
    // over the 8 lane groups of equal t, then the warps, in order
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float v0 = s0[n8][q], v1 = s1[n8][q];
#pragma unroll
        for (int sh = 4; sh < 32; sh <<= 1) {
          v0 += __shfl_xor_sync(0xffffffffu, v0, sh);
          v1 += __shfl_xor_sync(0xffffffffu, v1, sh);
        }
        if (g == 0) {
          red[(warp * 2 + 0) * C + 8 * n8 + 2 * t + q] = v0;
          red[(warp * 2 + 1) * C + 8 * n8 + 2 * t + q] = v1;
        }
      }
    }
    named_sync(1 + F_CONSUMERS, F_CWARPS * 32);  // the consumers only
    if (tid < 2 * C) {
      const int k = tid >> 6, ch = tid & (C - 1);
      float sum = 0.f;
#pragma unroll
      for (int wi = 0; wi < F_CWARPS; ++wi) sum += red[(wi * 2 + k) * C + ch];
      a.partial[((size_t)blockIdx.x * 2 + k) * C + ch] = sum;
    }
  }
}

// Rows: the operand's window [lo, hi), the summed rows [slo, shi).
struct Rows {
  int lo, hi, slo, shi;
};

template <typename T, int PRO, int EPI>
int forward(const void* in, const void* w, const float* s, const float* b,
            void* out, float* partial, float* stats, int max_blocks, int B,
            int H, int W, Rows r, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || r.lo < 0 || r.hi > H || r.lo >= r.hi ||
      r.slo < 0 || r.shi > H)
    return (int)cudaErrorInvalidValue;
  static Resident resident;  // one for each instantiation of the kernel
  auto kern = conv3x3_fwd<T, PRO, EPI>;
  FwdArgs<T> a = {};
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.s = s;
  a.b = b;
  a.out = static_cast<T*>(out);
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
  int rc = persistent_grid(kern, F_THREADS, F_SMEM, ntiles, max_blocks,
                           &resident, &grid);
  if (rc != 0 || grid == 0) return rc;
  constexpr bool F32 = std::is_same<T, float>::value;
  CUtensorMap map = {}, omap = {};
  rc = tensor_map(in, F32, B, H, W, r.lo, r.hi, HW, HH, &map);
  if (rc == 0 && !F32)
    rc = tensor_map(out, false, B, H, W, 0, H, TW, TH, &omap);
  if (rc != 0) return rc;
  kern<<<grid, F_THREADS, F_SMEM, (cudaStream_t)stream>>>(a, map, omap);
  rc = (int)cudaGetLastError();
  if (rc != 0 || EPI != EPI_STATS) return rc;
  return finish(partial, grid, 2 * C, stats, stream);
}

}  // namespace

extern "C" {

// Each returns a cudaError_t code: 0 on launches that were accepted. The
// *_window forms take the operand's row window [lo, hi) (0 <= lo < hi <= H)
// and the training form the rows it sums, [slo, shi); the wrappers call
// these only. The others run the same bodies with the window [0, H): they
// keep the entry points that scripts/torch_kernel_ab.py calls on this tree
// and on a parent tree that has no window.
int f2f_fwd_layer_window(const void* z_prev, int is_f32, const void* w,
                         const float* s, const float* b, void* z, int B, int H,
                         int W, int lo, int hi, void* stream) {
  const Rows r = {lo, hi, 0, 0};
  return is_f32 ? forward<float, PRO_AFFINE, EPI_NONE>(
                      z_prev, w, s, b, z, nullptr, nullptr, 0, B, H, W, r,
                      stream)
                : forward<__nv_bfloat16, PRO_AFFINE, EPI_NONE>(
                      z_prev, w, s, b, z, nullptr, nullptr, 0, B, H, W, r,
                      stream);
}

int f2f_fwd_layer(const void* z_prev, int is_f32, const void* w,
                  const float* s, const float* b, void* z, int B, int H, int W,
                  void* stream) {
  return f2f_fwd_layer_window(z_prev, is_f32, w, s, b, z, B, H, W, 0, H,
                              stream);
}

// stats: (2, 64) f32 out; partial: (max_blocks, 2, 64) f32 scratch.
int f2f_fwd_layer_train_window(const void* z_prev, int is_f32, const void* w,
                               const float* s, const float* b, void* z,
                               float* stats, float* partial, int max_blocks,
                               int B, int H, int W, int lo, int hi, int slo,
                               int shi, void* stream) {
  if (max_blocks <= 0) return (int)cudaErrorInvalidValue;
  const Rows r = {lo, hi, slo, shi};
  return is_f32
             ? forward<float, PRO_AFFINE, EPI_STATS>(z_prev, w, s, b, z,
                                                     partial, stats, max_blocks,
                                                     B, H, W, r, stream)
             : forward<__nv_bfloat16, PRO_AFFINE, EPI_STATS>(
                   z_prev, w, s, b, z, partial, stats, max_blocks, B, H, W, r,
                   stream);
}

int f2f_fwd_layer_train(const void* z_prev, int is_f32, const void* w,
                        const float* s, const float* b, void* z, float* stats,
                        float* partial, int max_blocks, int B, int H, int W,
                        void* stream) {
  return f2f_fwd_layer_train_window(z_prev, is_f32, w, s, b, z, stats,
                                    partial, max_blocks, B, H, W, 0, H, 0, H,
                                    stream);
}

int f2f_fwd_layer_eval_window(const void* a_prev, int is_f32, const void* w,
                              const float* s, const float* b, void* a, int B,
                              int H, int W, int lo, int hi, void* stream) {
  const Rows r = {lo, hi, 0, 0};
  return is_f32 ? forward<float, PRO_NONE, EPI_AFFINE>(
                      a_prev, w, s, b, a, nullptr, nullptr, 0, B, H, W, r,
                      stream)
                : forward<__nv_bfloat16, PRO_NONE, EPI_AFFINE>(
                      a_prev, w, s, b, a, nullptr, nullptr, 0, B, H, W, r,
                      stream);
}

int f2f_fwd_layer_eval(const void* a_prev, int is_f32, const void* w,
                       const float* s, const float* b, void* a, int B, int H,
                       int W, void* stream) {
  return f2f_fwd_layer_eval_window(a_prev, is_f32, w, s, b, a, B, H, W, 0, H,
                                   stream);
}

const char* f2f_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
