// Hopper (sm_90a) kernels of the 3x3 SAME convolution in f32, any channel
// counts, and of its weight gradient.
//
// f2f_conv3x3 (kernel A) replaces frame2frame_tpu/ops/pallas_conv.py:
// conv3x3_nopad (_fwd_kernel_tiled) and conv3x3_nopad_p2 (_fwd_kernel_p2),
// which compute the same function and differ only in how they stage the
// taps for the TPU's matrix unit:
//   y[b, h, w, o] = sum_{dy, dx, c} x[b, h + dy - 1, w + dx - 1, c] W[dy, dx, c, o]
// NHWC f32 x and y, HWIO f32 W, zero outside the image (the padding is done
// here, no padded copy is made). dX of the convolution is the same kernel
// on the cotangent with the spatially flipped, io-transposed weights, as in
// the JAX package. The function is f32 and the reference multiplies in f32;
// the TPU kernel took its matrix unit (jnp.dot at default precision).
//
// f2f_dw_conv3x3 (kernel B) replaces frame2frame_tpu/ops/conv_dw.py:
// dw_conv3x3 / dw_conv3x3_batched (_dw_kernel, pair-packed) and
// pallas_conv.py: _dw_nopad (_dw_kernel) and _dw_nopad_p2 (_dw_kernel_p2),
// again one function under three stagings:
//   dW[dy, dx, c, o] = sum_{b, h, w} x[b, h + dy - 1, w + dx - 1, c] g[b, h, w, o]
// x and g f32 or bf16 (both the same), products and sums in f32, dW f32
// (3, 3, Cin, Cout). The TPU kernels add each row tile into one output block
// that a sequential grid revisits; here every block writes its own partial
// dW and finish_sums (conv3x3_c64.cuh) adds the partials in block order, in
// double: no atomics, the same bits on every run.
//
// Split f32 on the TF32 tensor cores (kernel A, and kernel B on f32
// operands, where Cin and Cout are multiples of 8). One TF32 pass keeps 10
// mantissa bits of each operand: 3e-4 of the largest output off float64 at
// 64 -> 64 (tests/test_torch_conv_split.py), 30x the 1e-5 that the plain
// versions are held to. Each operand x is split in registers into hi =
// x rounded to TF32 (to nearest) and lo = x - hi, exact in f32, |lo| <=
// 2^-12 |x|; a product is hi*lo + lo*hi + hi*hi (three TF32 MMAs, small
// terms first), lo*lo (< 2^-22 of it) dropped, and the tensor core reads lo
// truncated to TF32 (an error below 2^-22 again). That is 7e-8 to 1e-7 of
// the largest output in emulation; on the card 1e-6 (A, wgmma) and 1.3e-7
// (B, mma.sync) off float64: f32, not TF32. The tensor core adds into its
// accumulator truncated, which over a weight gradient's thousands of k
// steps biased dW by 3e-5 of its largest value at 540p; so each chain of
// products starts from zero and is added to running f32 sums rounded to
// nearest (add4(), and A's sums over its 16-channel units).
//
// Bounds at 540p, 64 -> 64, f32 (one launch of either kernel): 2 * 540 *
// 960 * 64 * 64 * 9 = 38.2 GFLOP -> 0.5705 ms as f32 FMAs at 67 TFLOP/s;
// as run, three TF32 products, 115 GFLOP -> 0.2316 ms at 495 TFLOP/s;
// against 265 MB of inputs and output -> 0.079 ms at 3.35 TB/s: bound by
// operations. On an H100, mma.sync of TF32 issues at about half that peak
// (a pass of kernel B costs 0.15 ms, PERF.md section 6), which puts the
// floor of B's route near 0.46 ms. On bf16 operands the
// product of two values is exact in f32, so kernel B takes them to the
// tensor cores (bf16 x bf16 -> f32 MMA) and computes the same function up
// to the order of its f32 sums: 38.2 GFLOP -> 0.039 ms at 989 TFLOP/s
// against 133 MB -> 0.040 ms, bound by bytes.
//
// Kernel A on the tensor cores (conv3x3_wg): wgmma m64n64k8 tf32 with the
// weights as A, split in registers and loaded from L2 a tap ahead (147 KB
// of f32 weights resident in shared memory would leave no room for the
// pixels' lo), and the pixels as B from shared memory, hi and lo in two
// halves of a stage; 16 x 8 output tiles, 16 input channels a stage, a
// ring of three (kernel comment). Measured against the first body, which
// held the weights resident and took every product on mma.sync.m16n8k8
// (0.62 ms at 540p 64 -> 64): 0.52-0.54 ms. With one pass in place of
// three it takes 0.42 ms, so it is bound by its own latencies (one
// warpgroup a block, two blocks a multiprocessor, by registers and the
// running sums' 32 KB) more than by the tensor cores.
//
// The thin class (f32 operands, min(Cin, Cout) <= THIN_N = 4: DnCNN's first
// and last layers, 1 -> 64 and 64 -> 1 in grayscale, 3 -> 64 and 64 -> 3 in
// colour, and their dX and dW) is bound by the one operand with the wide
// channel count, read or written once: 133 MB at 540p, 0.040 ms. Three
// bodies, the narrow count n a template parameter, each a stream over that
// operand in which 16 lanes hold a pixel's 64 wide channels, 4 a lane (16
// bytes, so a warp moves two pixels' 256 contiguous bytes an instruction):
// - a_thin_in (A, n -> wide): a lane's 4 output channels with their 9 n
//   weights in registers, x's 3 x 3 x n window sliding in registers along a
//   run of a row; y written once, by 16-byte streaming stores.
// - a_thin_out (A, wide -> n): "inside out", as last_loss_fwd in
//   fused_ends.cu. Each pixel of x is read once and gives its 9 n tap dots
//   q[p, t, o] = sum_c x[p, c] W[t, c, o] (a lane's 4 channels, then the 16
//   lanes reduced by shuffles); y[p] = sum_t q[p + off_t, t] is gathered in
//   tap order from a ring of q rows in shared memory while a block walks a
//   strip of columns down a segment of rows, one barrier a row. Only q of
//   the strip's two edge columns and the segment's two edge rows is
//   computed twice: no x halo. The segments are as many as make one wave of
//   the card's resident blocks (a first build launched 288 blocks on 264
//   slots: 0.110 ms; one wave at three blocks a multiprocessor 0.069), and
//   the step keeps its cursor in counters, not divisions (0.057 ms; 540p on
//   an H100).
// - b_thin (B, either side narrow): a lane's 9 x n x 4 sums of dW in
//   registers over a slot's runs of 16 pixels; the narrow operand's 3 x 3 x
//   n window slides along a run in registers, the wide one comes in the
//   thread's own 16-byte cp.async chunks, a few pixels ahead, through a ring
//   in shared memory (no barrier: a thread reads back only what it copied).
//   Its step was bound by issuing instructions (a ring 4 to 16 deep, or a
//   walk down columns that reads a block's row contiguously, changed
//   nothing or lost), so a run's 16 steps are unrolled and address the ring,
//   the window and both operands at fixed offsets (0.087 -> 0.060 ms at
//   540p on an H100). The block adds its slots' sums in a fixed order and
//   writes one partial row; 512 threads a block for n = 1 halve the rows
//   finish_sums adds.
// The wide operand is read in 16-byte chunks where its channel count is a
// multiple of 4 (ops/conv_dw.py cp_async_reads), else 4 bytes at a time.
//
// Kernel A on f32 FMAs (conv3x3_f32), for channel counts that are neither
// multiples of 8 nor thin (12 -> 20), bound by their bytes: a block of 256
// threads computes a tile of 8*NPG/2 x 16 pixels by COT output channels
// (COT = 64, or 8 where Cout <= 8, so a layer to a few channels does not
// compute 63 empty ones), one thread 8 pixels of a row by 8 channels in
// 64 f32 accumulators. Input channels go in chunks
// of CI: the chunk's halo tile (zeros outside the image) and its 9 x CI x
// COT weights are staged in shared memory, then each thread reads ten input
// values of a halo row and eight weights a tap and does 8 x 8 FMAs with
// them. Weights are stored with the first and second four channels of each
// thread's eight in separate halves, so that the eight threads of a quarter
// warp read 128 contiguous bytes.
//
// Kernel B on f32 operands on the tensor cores (dw_tc_k): the weight
// gradient as a product with the pixels as k, in the frame of the bf16 body
// below. A persistent block of 12 warps owns 64 input by 64 output
// channels and walks 8 x 16 pixel tiles, the tile's f32 x halo (46 KB) and
// g (32 KB) two in flight (cp.async, swizzled 256-byte pixel rows). dW of
// the block is 18 (tap, 32 input channels) units by two halves of 32
// output channels; a warp takes three units of one half, 96 accumulators.
// A k8 step is 8 pixels of a tile row: one 16-byte load of a pixel gives a
// lane four channels, which are rows g and g + 8 of two m16 tiles of x^T or
// column g of four n8 tiles of g. Channels past Cin or Cout are copied as
// zeros and never written out.
//
// Kernel B on f32 FMAs (dw_conv3x3_k), for odd channel counts that are not
// thin: a block is 9 taps x CG x OG threads, one thread the 8 x 8 block
// of dW of one tap, 8 input and 8 output channels, in 64 f32 accumulators.
// Blocks walk 4 x 16 pixel tiles in a grid-stride loop; a tile's x halo
// and g values are staged in shared memory, then each thread runs over the
// tile's 64 pixels: two float4 loads of x at the pixel shifted by its tap,
// two of g, 64 FMAs.
//
// Kernel B on bf16 operands (dw_mma_k): the weight gradient as a matrix
// product with the pixels as the MMA's k, as the mid layers' dW in
// fused_stack_bwd.cu. A persistent block of 12 warps owns 64 input by 64
// output channels of dW (blockIdx.y, blockIdx.z) and walks 8 x 16 pixel
// tiles. A tile's x halo ((8+2) x (16+2) pixels) and its g (8 x 16 pixels)
// are staged as bf16 in swizzled 128-byte rows, two tiles in flight: the
// next tile's copies (cp.async, 16 bytes each, zeros outside the image) are
// issued before the current tile's MMAs. dW of the block is 9 taps x 4
// blocks of 16 input channels (the MMA's m) x 64 output channels (n); a
// warp owns three of these 36 (tap, 16-channel) units in f32 accumulators
// summed over all tiles of its block. One tile row of 16 pixels is one k16
// step of mma.sync.m16n8k16: the B fragment is g of the row, read with
// ldmatrix.trans; the A fragment x^T, read with ldmatrix.trans from the halo
// row shifted by the unit's tap. Any channel counts: a block's channels past
// Cin or Cout are never read into an MMA whose output is kept (a channel is
// one row of A or one column of B, hence one row or column of dW), so they
// are neither copied nor zeroed; only pixels outside the image must be zero.
// Where Cin or Cout is not a multiple of 8 (the 1 -> 64 and 64 -> 1 layers)
// that operand is copied value by value, the next tile's values carried in
// registers across this tile's MMAs (loaded one tile ahead, a device-memory
// wait a tile otherwise). Three shape classes (dw_mma_k<UPW, NT, GUARD>):
// 64-channel blocks as above; Cin <= 16 (1 -> 64): nine warps of one unit,
// the input channel stays the m dimension (one of 16 rows used: the taps as
// m would take one MMA a row instead of nine, but the layer is bound by
// reading g); Cout <= 8 (64 -> 1): one n8 tile (one of 8 columns used). The
// thin classes hold few accumulators and run two blocks a multiprocessor;
// both are bound by reading their 64-channel operand, 66 MB at 540p.
//
// Both forms of kernel B write a partial dW a block and finish_sums
// (conv3x3_c64.cuh) adds the partials in block order, in double: no atomics,
// the same bits on every run.

#include "conv3x3_c64.cuh"  // finish(): per-block partials in block order

namespace {

constexpr int A_THREADS = 256;
constexpr int A_TW = 16;           // output tile columns: two groups of 8
constexpr int A_HW = A_TW + 2;     // halo columns
constexpr int A_RS = A_TW + 4;     // halo row stride in floats, 16-byte rows

template <int COT, int CI>
struct ATile {
  static constexpr int NCOG = COT / 8;           // channel groups
  static constexpr int NPG = A_THREADS / NCOG;   // pixel groups of 8
  static constexpr int TH = NPG / 2;             // output tile rows
  static constexpr int HH = TH + 2;              // halo rows
  static constexpr int PLANE = HH * A_RS;        // floats of one channel
  static constexpr int HALO = CI * HH * A_HW;    // values staged a chunk
};

// position of channel o of a COT-channel weight row: thread group g's
// channels 8g..8g+3 at 4g, 8g+4..8g+7 at COT/2 + 4g
template <int COT>
__device__ __forceinline__ int wpos(int o) {
  return ((o >> 2) & 1) * (COT / 2) + (o >> 3) * 4 + (o & 3);
}

template <int COT, int CI>
__global__ void __launch_bounds__(A_THREADS, 2)
conv3x3_f32(const float* __restrict__ x, const float* __restrict__ w,
            float* __restrict__ y, int H, int W, int Cin, int Cout,
            int tiles_x) {
  using T = ATile<COT, CI>;
  __shared__ __align__(16) float hs[CI * T::PLANE];
  __shared__ __align__(16) float ws[9 * CI * COT];
  const int tid = threadIdx.x;
  const int cog = tid % T::NCOG;
  const int pg = tid / T::NCOG;
  const int row = pg >> 1, half = pg & 1;
  const int y0 = (blockIdx.x / tiles_x) * T::TH;
  const int x0 = (blockIdx.x % tiles_x) * A_TW;
  const int o0 = blockIdx.y * COT;
  const int b = blockIdx.z;
  const float* xb = x + (size_t)b * H * W * Cin;

  float acc[8][8];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[p][j] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += CI) {
    const int nci = min(CI, Cin - c0);
    __syncthreads();  // the previous chunk's FMAs are done with both tiles
    for (int e = tid; e < T::HALO; e += A_THREADS) {
      const int ci = e % CI, p = e / CI;
      const int hy = p / A_HW, hx = p - hy * A_HW;
      const int yy = y0 + hy - 1, xx = x0 + hx - 1;
      float v = 0.f;
      if (ci < nci && yy >= 0 && yy < H && xx >= 0 && xx < W)
        v = xb[((size_t)yy * W + xx) * Cin + c0 + ci];
      hs[ci * T::PLANE + hy * A_RS + hx] = v;
    }
    for (int e = tid; e < 9 * CI * COT; e += A_THREADS) {
      const int o = e % COT, r = e / COT;
      const int ci = r % CI, tap = r / CI;
      float v = 0.f;
      if (ci < nci && o0 + o < Cout)
        v = w[((size_t)tap * Cin + c0 + ci) * Cout + o0 + o];
      ws[(tap * CI + ci) * COT + wpos<COT>(o)] = v;
    }
    __syncthreads();

    for (int ci = 0; ci < nci; ++ci) {
      const float* hrow = hs + ci * T::PLANE + row * A_RS + half * 8;
      const float* wrow = ws + ci * COT + cog * 4;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float v[10];
        const float4 a = *reinterpret_cast<const float4*>(hrow + dy * A_RS);
        const float4 q = *reinterpret_cast<const float4*>(hrow + dy * A_RS + 4);
        const float2 r = *reinterpret_cast<const float2*>(hrow + dy * A_RS + 8);
        v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
        v[4] = q.x; v[5] = q.y; v[6] = q.z; v[7] = q.w;
        v[8] = r.x; v[9] = r.y;
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float* wt = wrow + (dy * 3 + dx) * CI * COT;
          const float4 w0 = *reinterpret_cast<const float4*>(wt);
          const float4 w1 = *reinterpret_cast<const float4*>(wt + COT / 2);
          const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int p = 0; p < 8; ++p)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[p][j] = fmaf(v[p + dx], wv[j], acc[p][j]);
        }
      }
    }
  }

  const int yy = y0 + row;
  if (yy >= H) return;
  float* yrow = y + (((size_t)b * H + yy) * W) * Cout;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int xx = x0 + half * 8 + p;
    if (xx >= W) break;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int o = o0 + cog * 8 + j;
      if (o < Cout) yrow[(size_t)xx * Cout + o] = acc[p][j];
    }
  }
}

template <int COT, int CI>
int launch_conv3x3(const float* x, const float* w, float* y, int B, int H,
                   int W, int Cin, int Cout, void* stream) {
  using T = ATile<COT, CI>;
  const int tiles_y = (H + T::TH - 1) / T::TH;
  const int tiles_x = (W + A_TW - 1) / A_TW;
  const dim3 grid(tiles_y * tiles_x, (Cout + COT - 1) / COT, B);
  conv3x3_f32<COT, CI><<<grid, A_THREADS, 0, (cudaStream_t)stream>>>(
      x, w, y, H, W, Cin, Cout, tiles_x);
  return (int)cudaGetLastError();
}

// ---- split-f32 products on the TF32 tensor cores (kernel A, kernel B f32)

// x rounded to TF32 (11 significant bits, to nearest, ties away from zero:
// cvt.rna.tf32.f32 on finite values, done as an integer add and mask, which
// issue at four times the rate of the conversion) and the rest, x - hi,
// exact in f32; the tensor core reads lo truncated.
struct Split {
  uint32_t hi, lo;
};

__device__ __forceinline__ Split split(float x) {
  const uint32_t h = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  return {h, __float_as_uint(x - __uint_as_float(h))};
}

__device__ __forceinline__ void mma_tf32(float c[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// c += a b in split f32: hi lo, lo hi, hi hi, the small terms first; lo lo
// (below 2^-22 of the product) is dropped.
__device__ __forceinline__ void mma_split(float c[4], const Split (&a)[4],
                                          const Split (&b)[2]) {
  mma_tf32(c, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].lo, b[1].lo);
  mma_tf32(c, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[0].hi, b[1].hi);
  mma_tf32(c, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].hi, b[1].hi);
}

// The running f32 sums, added to rounded to nearest: the tensor core's own
// accumulation truncates (source note).
__device__ __forceinline__ void add4(float acc[4], const float d[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) acc[q] += d[q];
}

__device__ __forceinline__ float4 lds128(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0,%1,%2,%3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

constexpr int G_THREADS = 128;               // one warpgroup
constexpr int G_TR = 16, G_TC = 8;           // output tile: 16 rows x 8 columns
constexpr int G_HR = G_TR + 2, G_HC = G_TC + 2;
constexpr int G_CHUNKS = G_HR * G_HC * 4;    // 16-byte chunks of a stage
constexpr int G_HALF = (G_HR * G_HC * 64 + 511) / 512 * 512;  // 16 channels
constexpr int G_STAGE = 2 * G_HALF;          // hi | lo
constexpr int G_NST = 3;
constexpr int G_SMEM = G_NST * G_STAGE + 64 * G_THREADS * 4 + 512;

struct WgArgs {
  const float* x;
  const float* w;
  float* y;
  int B, H, W, Cin, Cout, ncc, tiles_y, tiles_x;
};

// byte offset of chunk q (4 channels) of pixel row p in a stage: 64-byte
// rows in wgmma's 64-byte swizzle (address bits 4-5 ^= bits 7-8)
__device__ __forceinline__ int g_off(int p, int q) {
  return p * 64 + ((q ^ ((p >> 1) & 3)) << 4);
}

__device__ __forceinline__ uint64_t desc_sw64(uint32_t saddr, uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (2ull << 62);
}

__device__ __forceinline__ void g_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void g_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void g_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void g_fence_acc(float (&d)[2][32]) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[j][i])::"memory");
}

// d (64 x 64 f32) (+)= A (64 x 8 tf32, registers) * B (8 x 64 tf32,
// K-major in shared memory); scale_d = 0 starts d from zero
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wg_tile(const WgArgs& a, long tile,
                                        size_t& row0, int& y0, int& x0) {
  const long r = tile / a.tiles_x;
  x0 = (int)(tile - r * a.tiles_x) * G_TC;
  y0 = (int)(r % a.tiles_y) * G_TR;
  row0 = (size_t)(r / a.tiles_y) * a.H;
}

// input channels 16 cc .. + 16 of the tile's halo into the stage's hi half
__device__ __forceinline__ void wg_copy(const WgArgs& a, long tile, int cc,
                                        uint32_t dst) {
  size_t row0;
  int y0, x0;
  wg_tile(a, tile, row0, y0, x0);
  for (int e = threadIdx.x; e < G_CHUNKS; e += G_THREADS) {
    const int p = e >> 2, q = e & 3;
    const int hy = p / G_HC, hx = p - hy * G_HC;
    const int yy = y0 + hy - 1, xx = x0 + hx - 1, c = 16 * cc + 4 * q;
    const bool in = yy >= 0 && yy < a.H && xx >= 0 && xx < a.W && c < a.Cin;
    f2f::cp_async16(dst + g_off(p, q),
                    in ? a.x + ((row0 + yy) * a.W + xx) * a.Cin + c : a.x, in);
  }
}

// Kernel A on wgmma for Cin and Cout multiples of 8: output channels 64
// blockIdx.y .. as wgmma's M (A: the weights, from registers, split there),
// the pixels of a 16 x 8 output tile as N (B: the halo in shared memory,
// K-major as NHWC lies, two n64 halves of 8 tile rows whose 8-pixel groups
// sit G_HC pixels apart), k the input channels of one tap. A persistent
// block (one warpgroup, two a multiprocessor) walks its tiles in units of
// 16 input channels; a unit's halo comes by cp.async into a ring of three
// stages and is split in place (hi; lo into the stage's second half)
// while the unit before it runs its products. A unit's products (9 taps x
// 2 k8 steps x 3 a sum) start from zero; the tile's running sums over its
// units are f32 adds in shared memory.
__global__ void __launch_bounds__(G_THREADS, 2) conv3x3_wg(const WgArgs a) {
  extern __shared__ unsigned char g_raw[];
  const uint32_t raw_s = (uint32_t)__cvta_generic_to_shared(g_raw);
  const uint32_t pad = ((raw_s + 511) & ~511u) - raw_s;
  unsigned char* base = g_raw + pad;
  const uint32_t base_s = raw_s + pad;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int oa = blockIdx.y * 64 + 16 * warp + g, ob = oa + 8;
  const long ntiles = (long)a.B * a.tiles_y * a.tiles_x;
  const int mine =
      blockIdx.x < ntiles
          ? (int)((ntiles - blockIdx.x + gridDim.x - 1) / gridDim.x)
          : 0;
  const int nunits = mine * a.ncc;
  auto tile_of = [&](int u) {
    return blockIdx.x + (long)(u / a.ncc) * gridDim.x;
  };
  auto issue = [&](int u) {
    if (u < nunits)
      wg_copy(a, tile_of(u), u % a.ncc, base_s + (u % G_NST) * G_STAGE);
    f2f::cp_async_commit();
  };
  // this lane's weights of one (tap, 16 channels): A rows oa, ob, columns
  // (k) t and t + 4 of two k8 steps
  auto wload = [&](int cc, int tap, float (&r)[8]) {
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = 16 * cc + 8 * ks + t + 4 * (i >> 1);
        const int o = (i & 1) ? ob : oa;
        const size_t at = ((size_t)tap * a.Cin + c) * a.Cout + o;
        r[4 * ks + i] = c < a.Cin && o < a.Cout ? __ldg(a.w + at) : 0.f;
      }
  };

  // a landed stage's values split in place: hi stays, lo goes to the
  // stage's second half; both are read by wgmma through the async proxy
  auto split_stage = [&](int u) {
    unsigned char* st = base + (u % G_NST) * G_STAGE;
    for (int e = tid; e < G_CHUNKS; e += G_THREADS) {
      const int off = g_off(e >> 2, e & 3);
      float4* hp = reinterpret_cast<float4*>(st + off);
      const float4 v = *hp;
      const Split sx = split(v.x), sy = split(v.y), sz = split(v.z),
                  sw = split(v.w);
      *hp = make_float4(__uint_as_float(sx.hi), __uint_as_float(sy.hi),
                        __uint_as_float(sz.hi), __uint_as_float(sw.hi));
      *reinterpret_cast<float4*>(st + G_HALF + off) =
          make_float4(__uint_as_float(sx.lo), __uint_as_float(sy.lo),
                      __uint_as_float(sz.lo), __uint_as_float(sw.lo));
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };

  issue(0);
  issue(1);
  f2f::cp_async_wait<1>();  // unit 0 has landed
  __syncthreads();
  split_stage(0);
  // per thread 64 running sums, [sum][thread]
  float* accs = reinterpret_cast<float*>(base + G_NST * G_STAGE);
  float tmp[2][32];
  float wr[8];  // the weights of the next (tap, chunk) step, loaded ahead
  wload(0, 0, wr);
  for (int u = 0; u < nunits; ++u) {
    const int cc = u % a.ncc;
    issue(u + 2);
    __syncthreads();  // unit u's stage is split
    const uint32_t hs = base_s + (u % G_NST) * G_STAGE, ls = hs + G_HALF;
    uint32_t ah[2][2][4], al[2][2][4];  // [tap & 1][k8 step][register]
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int buf = tap & 1, dy = tap / 3, dx = tap % 3;
      if (tap >= 2) g_wait<1>();  // tap - 2's products are done with buf
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const Split s = split(wr[4 * ks + i]);
          ah[buf][ks][i] = s.hi;
          al[buf][ks][i] = s.lo;
        }
      if (tap < 8) wload(cc, tap + 1, wr);
      else if (u + 1 < nunits) wload((u + 1) % a.ncc, 0, wr);
      g_fence_acc(tmp);
      g_fence();
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // N: tile rows 8h .. 8h + 7 of 8 pixels, G_HC pixels apart
          const int p = (8 * h + dy) * G_HC + dx;
          const uint64_t dh = desc_sw64(hs + p * 64 + 32 * ks, G_HC * 64);
          const uint64_t dl = desc_sw64(ls + p * 64 + 32 * ks, G_HC * 64);
          wgmma_tf32(tmp[h], ah[buf][ks], dl, tap + ks > 0);
          wgmma_tf32(tmp[h], al[buf][ks], dh, 1);
          wgmma_tf32(tmp[h], ah[buf][ks], dh, 1);
        }
      g_commit();
      if (tap == 4 && u + 1 < nunits) {  // the next unit's split, meanwhile
        f2f::cp_async_wait<1>();
        __syncthreads();
        split_stage(u + 1);
      }
    }
    g_wait<0>();
    g_fence_acc(tmp);

    // the tile's running sums over its channel chunks, in shared memory
    if (cc < a.ncc - 1) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          float* r = accs + (32 * h + i) * G_THREADS + tid;
          *r = cc ? *r + tmp[h][i] : tmp[h][i];
        }
    } else {
      size_t row0;
      int y0, x0;
      wg_tile(a, tile_of(u), row0, y0, x0);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int yy = y0 + 8 * h + j;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int xx = x0 + 2 * t + (i & 1);
            const int o = (i >> 1) ? ob : oa;
            const int k = 4 * j + i;
            const float v =
                cc ? accs[(32 * h + k) * G_THREADS + tid] + tmp[h][k]
                   : tmp[h][k];
            if (yy < a.H && xx < a.W && o < a.Cout)
              a.y[((row0 + yy) * a.W + xx) * a.Cout + o] = v;
          }
        }
    }
    __syncthreads();  // unit u's stage is read before issue(u + 3) refills it
  }
}

int launch_conv3x3_wg(const float* x, const float* w, float* y, int B, int H,
                      int W, int Cin, int Cout, void* stream) {
  static f2f::Resident resident;
  const WgArgs a = {x, w, y, B, H, W, Cin, Cout, (Cin + 15) / 16,
                    (H + G_TR - 1) / G_TR, (W + G_TC - 1) / G_TC};
  int grid = 0;
  int rc = f2f::persistent_grid(conv3x3_wg, G_THREADS, G_SMEM,
                                (long)B * a.tiles_y * a.tiles_x, 0, &resident,
                                &grid);
  if (rc != 0) return rc;
  conv3x3_wg<<<dim3(grid, (Cout + 63) / 64), G_THREADS, G_SMEM,
               (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

constexpr int B_TH = 4;                       // pixel tile rows
constexpr int B_TW = 16;                      // pixel tile columns
constexpr int B_HW = B_TW + 2;                // halo columns
constexpr int B_HPIX = (B_TH + 2) * B_HW;     // halo pixels
constexpr int B_CT = 64;                      // channels of a block, in and out
constexpr int B_MAX_THREADS = 9 * (B_CT / 8) * (B_CT / 8);

// x: (B, H, W, Cin), g: (B, H, W, Cout); partial: (gridDim.x, 9, Cin, Cout).
// A block owns input channels 64 blockIdx.y .. and output channels
// 64 blockIdx.z ..; cg_n and og_n are the groups of 8 of a full tile.
__global__ void __launch_bounds__(B_MAX_THREADS, 1)
dw_conv3x3_k(const float* __restrict__ x, const float* __restrict__ g,
             float* __restrict__ partial, int B, int H, int W, int Cin,
             int Cout, int tiles_y, int tiles_x, int cg_n, int og_n) {
  __shared__ __align__(16) float xs[B_HPIX * B_CT];
  __shared__ __align__(16) float gs[B_TH * B_TW * B_CT];
  const int tid = threadIdx.x;
  const int og = tid % og_n;
  const int cg = (tid / og_n) % cg_n;
  const int tap = tid / (og_n * cg_n);
  const int dy = tap / 3, dx = tap - 3 * (tap / 3);
  const int c0 = blockIdx.y * B_CT, o0 = blockIdx.z * B_CT;
  const int nc = min(B_CT, Cin - c0), no = min(B_CT, Cout - o0);

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const long ntiles = (long)B * tiles_y * tiles_x;
  for (long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int tx = (int)(tile % tiles_x);
    const long r = tile / tiles_x;
    const int ty = (int)(r % tiles_y);
    const int bi = (int)(r / tiles_y);
    const int y0 = ty * B_TH, x0 = tx * B_TW;

    __syncthreads();  // the previous tile's FMAs are done with both tiles
    for (int e = tid; e < B_HPIX * B_CT; e += blockDim.x) {
      const int c = e % B_CT, p = e / B_CT;
      const int hy = p / B_HW, hx = p - hy * B_HW;
      const int yy = y0 + hy - 1, xx = x0 + hx - 1;
      float v = 0.f;
      if (c < nc && yy >= 0 && yy < H && xx >= 0 && xx < W)
        v = x[(((size_t)bi * H + yy) * W + xx) * Cin + c0 + c];
      xs[p * B_CT + wpos<B_CT>(c)] = v;
    }
    for (int e = tid; e < B_TH * B_TW * B_CT; e += blockDim.x) {
      const int c = e % B_CT, p = e / B_CT;
      const int yy = y0 + p / B_TW, xx = x0 + p % B_TW;
      float v = 0.f;
      if (c < no && yy < H && xx < W)
        v = g[(((size_t)bi * H + yy) * W + xx) * Cout + o0 + c];
      gs[p * B_CT + wpos<B_CT>(c)] = v;
    }
    __syncthreads();

#pragma unroll 2
    for (int py = 0; py < B_TH; ++py) {
#pragma unroll 4
      for (int px = 0; px < B_TW; ++px) {
        const float* xr = xs + ((py + dy) * B_HW + px + dx) * B_CT + cg * 4;
        const float* gr = gs + (py * B_TW + px) * B_CT + og * 4;
        const float4 xa = *reinterpret_cast<const float4*>(xr);
        const float4 xb = *reinterpret_cast<const float4*>(xr + B_CT / 2);
        const float4 ga = *reinterpret_cast<const float4*>(gr);
        const float4 gb = *reinterpret_cast<const float4*>(gr + B_CT / 2);
        const float xv[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
        const float gv[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xv[i], gv[j], acc[i][j]);
      }
    }
  }

  float* dst = partial + ((size_t)blockIdx.x * 9 + tap) * Cin * Cout;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = c0 + cg * 8 + i;
    if (c >= Cin) break;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int o = o0 + og * 8 + j;
      if (o < Cout) dst[(size_t)c * Cout + o] = acc[i][j];
    }
  }
}

int launch_dw_fma(const void* x, const void* g, float* dw, float* partial,
                  int max_blocks, int B, int H, int W, int Cin, int Cout,
                  void* stream) {
  const int tiles_y = (H + B_TH - 1) / B_TH;
  const int tiles_x = (W + B_TW - 1) / B_TW;
  const long ntiles = (long)B * tiles_y * tiles_x;
  const int blocks = (int)(ntiles < max_blocks ? ntiles : max_blocks);
  const int cg_n = (min(Cin, B_CT) + 7) / 8, og_n = (min(Cout, B_CT) + 7) / 8;
  const dim3 grid(blocks, (Cin + B_CT - 1) / B_CT, (Cout + B_CT - 1) / B_CT);
  dw_conv3x3_k<<<grid, 9 * cg_n * og_n, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(g), partial, B, H, W,
      Cin, Cout, tiles_y, tiles_x, cg_n, og_n);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return f2f::finish(partial, blocks, 9 * Cin * Cout, dw, stream);
}

constexpr int D_WARPS = 12;
constexpr int D_THREADS = D_WARPS * 32;
constexpr int D_TH = 8, D_TW = 16;           // pixel tile: 8 x 16
constexpr int D_HW = D_TW + 2;               // halo columns
constexpr int D_XH_BYTES = (D_TH + 2) * D_HW * 64 * 4;   // 46,080
constexpr int D_G_BYTES = D_TH * D_TW * 64 * 4;          // 32,768
constexpr int D_STAGE_BYTES = D_XH_BYTES + D_G_BYTES;
constexpr int D_SMEM_BYTES = 2 * D_STAGE_BYTES;          // 157,696

struct DwF32Args {
  const float* x;
  const float* g;
  float* partial;
  int B, H, W, Cin, Cout, tiles_y, tiles_x;
};

// A pixel's 64 f32 channels are 16 chunks of 16 bytes; chunk q lies at
// q ^ dsw(p): four consecutive pixels by two chunks on distinct banks.
__device__ __forceinline__ int dsw(int p) { return (p & 3) << 1; }

// Tile `tile`'s x halo ((8+2) x (16+2) pixels, channels c0 ..) and g (8 x 16
// pixels, channels o0 ..) into the stage at dst: cp.async, zeros outside
// the image and past the block's channels.
__device__ __forceinline__ void dw_f32_copy(const DwF32Args& a, long tile,
                                            int c0, int nc, int o0, int no,
                                            uint32_t dst) {
  const long r = tile / a.tiles_x;
  const int tx = (int)(tile - r * a.tiles_x);
  const int ty = (int)(r % a.tiles_y);
  const size_t row0 = (size_t)(r / a.tiles_y) * a.H;
  constexpr int NX = (D_TH + 2) * D_HW * 16, NG = D_TH * D_TW * 16;
  for (int e = threadIdx.x; e < NX + NG; e += D_THREADS) {
    const bool isx = e < NX;
    const int f = isx ? e : e - NX;
    const int p = f >> 4, q = f & 15;
    const int cols = isx ? D_HW : D_TW, halo = isx ? 1 : 0;
    const int hy = p / cols, hx = p - hy * cols;
    const int yy = ty * D_TH + hy - halo, xx = tx * D_TW + hx - halo;
    const bool in = yy >= 0 && yy < a.H && xx >= 0 && xx < a.W &&
                    4 * q < (isx ? nc : no);
    const float* src = isx ? a.x + ((row0 + yy) * a.W + xx) * a.Cin + c0
                           : a.g + ((row0 + yy) * a.W + xx) * a.Cout + o0;
    f2f::cp_async16(dst + (isx ? 0 : D_XH_BYTES) + p * 256 +
                        ((q ^ dsw(p)) << 4),
                    in ? src + 4 * q : a.x, in);
  }
}

// Kernel B on f32 operands, Cin and Cout multiples of 8, on the tensor cores
// in split f32: dW of the block's 64 input (blockIdx.y) by 64 output
// channels (blockIdx.z) as a product with the pixels as k. A persistent
// block walks 8 x 16 pixel tiles, two in flight (cp.async). dW of the block
// is 18 units of (tap, 32 input channels: two m16 tiles) by two halves of
// 32 output channels (four n8 tiles); warp w takes output half w / 6 and
// units 3 (w % 6) .. + 3. One k8 step is 8 pixels of a tile row: a lane's
// k = t and t + 4 are pixels t and t + 4, and one 16-byte load of a pixel
// gives the lane four channels: input channels 4g .. 4g + 3 are rows g and
// g + 8 of the two m tiles, output channels 4g + j column g of n tile j.
__global__ void __launch_bounds__(D_THREADS, 1)
dw_tc_k(const DwF32Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int c0 = blockIdx.y * 64, o0 = blockIdx.z * 64;
  const int nc = min(64, a.Cin - c0), no = min(64, a.Cout - o0);
  const int oh = warp / 6, u0 = 3 * (warp % 6);

  float acc[3][2][4][4];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][mi][j][q] = 0.f;
  int a_pix[3], a_ch[3];  // unit i: halo pixel of the tap, input chunk
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int tap = (u0 + i) >> 1;
    a_pix[i] = (tap / 3) * D_HW + tap % 3 + t;
    a_ch[i] = 8 * ((u0 + i) & 1) + g;
  }

  const long ntiles = (long)a.B * a.tiles_y * a.tiles_x;
  const uint32_t s0 = (uint32_t)__cvta_generic_to_shared(smem);
  long tile = blockIdx.x;
  if (tile < ntiles) dw_f32_copy(a, tile, c0, nc, o0, no, s0);
  f2f::cp_async_commit();
  for (int s = 0; tile < ntiles; tile += gridDim.x, s ^= 1) {
    const long next = tile + gridDim.x;
    if (next < ntiles)
      dw_f32_copy(a, next, c0, nc, o0, no, s0 + (s ^ 1) * D_STAGE_BYTES);
    f2f::cp_async_commit();
    f2f::cp_async_wait<1>();  // this tile's copies have landed
    __syncthreads();

    const uint32_t xs = s0 + s * D_STAGE_BYTES, gs = xs + D_XH_BYTES;
#pragma unroll 1
    for (int ks = 0; ks < 2 * D_TH; ++ks) {
      const int row = ks >> 1, px = 8 * (ks & 1);
      Split bf[4][2];  // [n tile][fragment register]
      {
        const int p = row * D_TW + px + t;
        const int off = ((8 * oh + g) ^ dsw(p)) << 4;
        const float4 u = lds128(gs + p * 256 + off);
        const float4 v = lds128(gs + (p + 4) * 256 + off);
        bf[0][0] = split(u.x); bf[0][1] = split(v.x);
        bf[1][0] = split(u.y); bf[1][1] = split(v.y);
        bf[2][0] = split(u.z); bf[2][1] = split(v.z);
        bf[3][0] = split(u.w); bf[3][1] = split(v.w);
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const int p = row * D_HW + px + a_pix[i];
        const int off = (a_ch[i] ^ dsw(p)) << 4;
        const float4 u = lds128(xs + p * 256 + off);
        const float4 v = lds128(xs + (p + 4) * 256 + off);
        const Split af0[4] = {split(u.x), split(u.y), split(v.x), split(v.y)};
        const Split af1[4] = {split(u.z), split(u.w), split(v.z), split(v.w)};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float d0[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f};
          mma_split(d0, af0, bf[j]);
          mma_split(d1, af1, bf[j]);
          add4(acc[i][0][j], d0);
          add4(acc[i][1][j], d1);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }

#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int tap = (u0 + i) >> 1, cu = 32 * ((u0 + i) & 1);
    float* dst = a.partial + ((size_t)blockIdx.x * 9 + tap) * a.Cin * a.Cout;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = cu + 4 * g + 2 * mi + (q >> 1);
          const int o = 32 * oh + 4 * (2 * t + (q & 1)) + j;
          if (c < nc && o < no)
            dst[(size_t)(c0 + c) * a.Cout + o0 + o] = acc[i][mi][j][q];
        }
  }
}

int launch_dw_tc(const float* x, const float* g, float* dw, float* partial,
                 int max_blocks, int B, int H, int W, int Cin, int Cout,
                 void* stream) {
  static f2f::Resident resident;
  const DwF32Args a = {x, g, partial, B, H, W, Cin, Cout,
                       (H + D_TH - 1) / D_TH, (W + D_TW - 1) / D_TW};
  int grid = 0;
  int rc = f2f::persistent_grid(dw_tc_k, D_THREADS, D_SMEM_BYTES,
                                (long)B * a.tiles_y * a.tiles_x, max_blocks,
                                &resident, &grid);
  if (rc != 0) return rc;
  dw_tc_k<<<dim3(grid, (Cin + 63) / 64, (Cout + 63) / 64), D_THREADS,
            D_SMEM_BYTES, (cudaStream_t)stream>>>(a);
  if ((rc = (int)cudaGetLastError()) != 0) return rc;
  return f2f::finish(partial, grid, 9 * Cin * Cout, dw, stream);
}

constexpr int M_WARPS = 12;
constexpr int M_THREADS = M_WARPS * 32;
constexpr int M_XH_BYTES = f2f::HALO_BYTES;                // x halo tile
constexpr int M_G_BYTES = f2f::TH * f2f::TW * f2f::C * 2;  // g tile
constexpr int M_STAGE_BYTES = M_XH_BYTES + M_G_BYTES;
constexpr int M_SMEM_BYTES = 2 * M_STAGE_BYTES;
// values of an operand copied one at a time (a channel count that is not a
// multiple of 8) that a thread carries in registers to the next tile
constexpr int M_CARRY = 2;

struct DwArgs {
  const __nv_bfloat16* x;
  const __nv_bfloat16* g;
  float* partial;
  int B, H, W, Cin, Cout, tiles_y, tiles_x;
};

struct DwTile {
  size_t row0;  // image index * H
  int y0, x0;
};

__device__ __forceinline__ DwTile dw_tile(const DwArgs& a, long tile) {
  const long r = tile / a.tiles_x;
  return {(size_t)(r / a.tiles_y) * a.H, (int)(r % a.tiles_y) * f2f::TH,
          (int)(tile - r * a.tiles_x) * f2f::TW};
}

// Pixel p of a tile of x (HALO = 1: the (8+2) x (16+2) halo) or of g
// (HALO = 0: the 8 x 16 pixels): its index in the batch and whether it lies
// in the image.
template <int HALO>
__device__ __forceinline__ bool dw_pixel(const DwArgs& a, const DwTile& t,
                                         int p, size_t& pix) {
  constexpr int COLS = f2f::TW + 2 * HALO;
  const int hy = p / COLS, hx = p - hy * COLS;
  const int y = t.y0 + hy - HALO, x = t.x0 + hx - HALO;
  pix = (t.row0 + y) * a.W + x;
  return f2f::row_in(y, 0, a.H) && x >= 0 && x < a.W;
}

// The tile's nch chunks of 8 channels a pixel, from channel c0 of rows of
// cs channels, into shared memory at dst: cp.async, zeros outside the image.
template <int HALO>
__device__ __forceinline__ void dw_copy(const DwArgs& a, const DwTile& t,
                                        uint32_t dst,
                                        const __nv_bfloat16* src, int cs,
                                        int c0, int nch) {
  constexpr int NPIX = (f2f::TH + 2 * HALO) * (f2f::TW + 2 * HALO);
  for (int e = threadIdx.x; e < NPIX * nch; e += M_THREADS) {
    const int p = nch == 8 ? e >> 3 : e / nch, ch = e - p * nch;
    size_t pix;
    const bool in = dw_pixel<HALO>(a, t, p, pix);
    f2f::cp_async16(dst + f2f::swz(p, 8 * ch),
                    in ? src + pix * cs + c0 + 8 * ch : src, in);
  }
}

// The same for n channels one value at a time: the first M_CARRY values of
// a thread into registers (load), then into shared memory (store), so that
// the loads of the next tile overlap this tile's MMAs; the rest of a wide
// operand (an edge shape) loaded and stored in the store step.
template <int HALO>
__device__ __forceinline__ void dw_load(const DwArgs& a, const DwTile& t,
                                        __nv_bfloat16 (&v)[M_CARRY],
                                        const __nv_bfloat16* src, int cs,
                                        int c0, int n) {
  constexpr int NPIX = (f2f::TH + 2 * HALO) * (f2f::TW + 2 * HALO);
#pragma unroll
  for (int k = 0; k < M_CARRY; ++k) {
    const int e = threadIdx.x + k * M_THREADS;
    v[k] = __float2bfloat16(0.f);
    if (e < NPIX * n) {
      const int p = e / n, c = e - p * n;
      size_t pix;
      if (dw_pixel<HALO>(a, t, p, pix)) v[k] = src[pix * cs + c0 + c];
    }
  }
}

template <int HALO>
__device__ __forceinline__ void dw_store(const DwArgs& a, const DwTile& t,
                                         const __nv_bfloat16 (&v)[M_CARRY],
                                         unsigned char* dst,
                                         const __nv_bfloat16* src, int cs,
                                         int c0, int n) {
  constexpr int NPIX = (f2f::TH + 2 * HALO) * (f2f::TW + 2 * HALO);
#pragma unroll
  for (int k = 0; k < M_CARRY; ++k) {
    const int e = threadIdx.x + k * M_THREADS;
    if (e < NPIX * n) {
      const int p = e / n, c = e - p * n;
      *reinterpret_cast<__nv_bfloat16*>(dst + f2f::swz(p, c)) = v[k];
    }
  }
  for (int e = threadIdx.x + M_CARRY * M_THREADS; e < NPIX * n;
       e += M_THREADS) {
    const int p = e / n, c = e - p * n;
    size_t pix;
    __nv_bfloat16 u = __float2bfloat16(0.f);
    if (dw_pixel<HALO>(a, t, p, pix)) u = src[pix * cs + c0 + c];
    *reinterpret_cast<__nv_bfloat16*>(dst + f2f::swz(p, c)) = u;
  }
}

// x: (B, H, W, Cin), g: (B, H, W, Cout) bf16; partial: (gridDim.x, 9, Cin,
// Cout) f32. The block owns input channels 64 blockIdx.y .. and output
// channels 64 blockIdx.z ... Shape classes: UPW (tap, 16 input channels)
// units a warp, 3 (12 warps x 3 = 36 units of 64 input channels) or 1 (nine
// warps, one tap each, 16 input channels at most); NT n8 tiles of output
// channels, 8 or 1 (8 output channels at most); GUARD: the block's channels
// may be fewer than its units and n tiles cover (without it, UPW = 3 and NT
// = 8 take blocks of exactly 64 x 64 channels).
template <int UPW, int NT, bool GUARD>
__global__ void __launch_bounds__(M_THREADS, UPW * NT > 8 ? 1 : 2)
dw_mma_k(const DwArgs a) {
  using namespace f2f;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int c0 = blockIdx.y * C, o0 = blockIdx.z * C;
  const int nc = min(C, a.Cin - c0), no = min(C, a.Cout - o0);
  const int mt = (nc + 15) >> 4;  // m16 tiles of input channels in use
  const int nt = (no + 7) >> 3;   // n8 tiles of output channels in use
  const bool xvec = a.Cin % 8 == 0, gvec = a.Cout % 8 == 0;

  float acc[UPW][NT][4];
#pragma unroll
  for (int i = 0; i < UPW; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  // ldmatrix.trans lane roles, as in the mid layers' dW (fused_stack_bwd.cu):
  // A = x^T from rows of pixels (k), B = g from rows of pixels (k)
  const int a_k = (lane & 7) + (lane >> 4) * 8;
  const int a_mh = (lane >> 3) & 1;
  const int b_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int b_nt = lane >> 4;
  // unit i of this warp: tap and first input channel
  auto unit_tap = [&](int i) { return UPW == 3 ? (UPW * warp + i) >> 2 : warp; };
  auto unit_c = [&](int i) { return UPW == 3 ? 16 * ((UPW * warp + i) & 3) : 0; };
  constexpr bool EXACT = UPW == 3 && NT == 8 && !GUARD;
  int a_pix[UPW];
  bool used[UPW];
#pragma unroll
  for (int i = 0; i < UPW; ++i) {
    const int tap = unit_tap(i);
    a_pix[i] = (tap / 3) * HW + (tap % 3) + a_k;
    used[i] = EXACT || (tap < 9 && unit_c(i) < 16 * mt);
  }

  const long ntiles = (long)a.B * a.tiles_y * a.tiles_x;
  long tile = blockIdx.x;
  __nv_bfloat16 xv[M_CARRY], gv[M_CARRY];
  if (tile < ntiles) {
    const DwTile t = dw_tile(a, tile);
    const uint32_t s0 = (uint32_t)__cvta_generic_to_shared(smem);
    if (xvec) dw_copy<1>(a, t, s0, a.x, a.Cin, c0, nc >> 3);
    else {
      dw_load<1>(a, t, xv, a.x, a.Cin, c0, nc);
      dw_store<1>(a, t, xv, smem, a.x, a.Cin, c0, nc);
    }
    if (gvec) dw_copy<0>(a, t, s0 + M_XH_BYTES, a.g, a.Cout, o0, no >> 3);
    else {
      dw_load<0>(a, t, gv, a.g, a.Cout, o0, no);
      dw_store<0>(a, t, gv, smem + M_XH_BYTES, a.g, a.Cout, o0, no);
    }
  }
  cp_async_commit();
  for (int s = 0; tile < ntiles; tile += gridDim.x, s ^= 1) {
    unsigned char* xs = smem + s * M_STAGE_BYTES;
    unsigned char* xn = smem + (s ^ 1) * M_STAGE_BYTES;
    // the next tile's copies and loads go out before this tile's MMAs
    const long next = tile + gridDim.x;
    const DwTile tn = dw_tile(a, next < ntiles ? next : tile);
    if (next < ntiles) {
      const uint32_t sn = (uint32_t)__cvta_generic_to_shared(xn);
      if (xvec) dw_copy<1>(a, tn, sn, a.x, a.Cin, c0, nc >> 3);
      else dw_load<1>(a, tn, xv, a.x, a.Cin, c0, nc);
      if (gvec) dw_copy<0>(a, tn, sn + M_XH_BYTES, a.g, a.Cout, o0, no >> 3);
      else dw_load<0>(a, tn, gv, a.g, a.Cout, o0, no);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies have landed
    __syncthreads();

    const uint32_t xs_s = (uint32_t)__cvta_generic_to_shared(xs);
    const uint32_t gs_s = xs_s + M_XH_BYTES;
#pragma unroll
    for (int row = 0; row < TH; ++row) {
      uint32_t bf[NT < 2 ? 2 : NT][2];
      if constexpr (NT == 1) {
        ldsm_x2_trans(gs_s + swz(row * TW + b_row, 0), bf[0][0], bf[0][1]);
      } else {
#pragma unroll
        for (int j = 0; j < NT; j += 2)
          if (!GUARD || j < nt)
            ldsm_x4_trans(gs_s + swz(row * TW + b_row, 8 * (j + b_nt)),
                          bf[j][0], bf[j][1], bf[j + 1][0], bf[j + 1][1]);
      }
      // every unit's A fragment before the row's MMAs: one wait a row
      uint32_t af[UPW][4];
#pragma unroll
      for (int i = 0; i < UPW; ++i)
        if (EXACT || used[i])
          ldsm_x4_trans(xs_s + swz(row * HW + a_pix[i], unit_c(i) + 8 * a_mh),
                        af[i][0], af[i][1], af[i][2], af[i][3]);
#pragma unroll
      for (int i = 0; i < UPW; ++i) {
        if (!EXACT && !used[i]) continue;
#pragma unroll
        for (int j = 0; j < NT; ++j)
          if (!GUARD || j < nt)
            mma_bf16(acc[i][j], af[i][0], af[i][1], af[i][2], af[i][3],
                     bf[j][0], bf[j][1]);
      }
    }
    if (next < ntiles) {
      if (!xvec) dw_store<1>(a, tn, xv, xn, a.x, a.Cin, c0, nc);
      if (!gvec) dw_store<0>(a, tn, gv, xn + M_XH_BYTES, a.g, a.Cout, o0, no);
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }

  const int gi = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < UPW; ++i) {
    if (!used[i]) continue;
    float* dst =
        a.partial + ((size_t)blockIdx.x * 9 + unit_tap(i)) * a.Cin * a.Cout;
    const int cm = unit_c(i);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = cm + gi + 8 * (q >> 1);
        const int o = 8 * j + 2 * t + (q & 1);
        if (c < nc && o < no)
          dst[(size_t)(c0 + c) * a.Cout + o0 + o] = acc[i][j][q];
      }
  }
}

template <int UPW, int NT, bool GUARD>
int launch_mma(DwArgs a, float* dw, int max_blocks, void* stream) {
  using namespace f2f;
  static Resident resident;  // one for each instantiation of the kernel
  auto kern = dw_mma_k<UPW, NT, GUARD>;
  int grid = 0;
  int rc = persistent_grid(kern, M_THREADS, M_SMEM_BYTES,
                           (long)a.B * a.tiles_y * a.tiles_x, max_blocks,
                           &resident, &grid);
  if (rc != 0) return rc;
  const dim3 blocks(grid, (a.Cin + C - 1) / C, (a.Cout + C - 1) / C);
  kern<<<blocks, M_THREADS, M_SMEM_BYTES, (cudaStream_t)stream>>>(a);
  if ((rc = (int)cudaGetLastError()) != 0) return rc;
  return finish(a.partial, grid, 9 * a.Cin * a.Cout, dw, stream);
}

int launch_dw_mma(const void* x, const void* g, float* dw, float* partial,
                  int max_blocks, int B, int H, int W, int Cin, int Cout,
                  void* stream) {
  using namespace f2f;
  const DwArgs a = {static_cast<const __nv_bfloat16*>(x),
                    static_cast<const __nv_bfloat16*>(g),
                    partial,
                    B,
                    H,
                    W,
                    Cin,
                    Cout,
                    (H + TH - 1) / TH,
                    (W + TW - 1) / TW};
  if (Cout <= 8) return launch_mma<3, 1, false>(a, dw, max_blocks, stream);
  if (Cin <= 16)
    return Cout % C == 0 ? launch_mma<1, 8, false>(a, dw, max_blocks, stream)
                         : launch_mma<1, 8, true>(a, dw, max_blocks, stream);
  return Cin % C == 0 && Cout % C == 0
             ? launch_mma<3, 8, false>(a, dw, max_blocks, stream)
             : launch_mma<3, 8, true>(a, dw, max_blocks, stream);
}

// ---- the thin class: f32 operands, min(Cin, Cout) <= THIN_N (source note)

constexpr int THIN_N = 4;                // the narrow side's largest count
constexpr int T_THREADS = 256;
constexpr int T_SLOTS = T_THREADS / 16;  // 16 lanes a pixel, 4 channels each
constexpr int T_RUN = 16;                // pixels of a row a slot walks
constexpr int T_STAGES = 4;              // b_thin: a thread's ring of chunks
constexpr int Q_STAGES = 4;              // a_thin_out: steps of x in flight

enum Body { BODY_FMA = 0, BODY_TC = 1, BODY_THIN = 2, BODY_BF16 = 3 };

// Which body computes kernel A (b = 0) or B (b = 1) on these operands: the
// one rule of f2f_conv3x3, f2f_dw_conv3x3 and f2f_conv3x3_body, which the
// wrappers' cp_async_reads (ops/conv_dw.py) mirrors.
int body_of(int b, int is_f32, int cin, int cout) {
  if (b && !is_f32) return BODY_BF16;
  if (cin % 8 == 0 && cout % 8 == 0) return BODY_TC;
  return min(cin, cout) <= THIN_N ? BODY_THIN : BODY_FMA;
}

// Channels c .. c + 3 of pixel pix of an f32 tensor of C channels into
// shared memory at dst, zeros past C and where !in: one 16-byte cp.async
// where C is a multiple of 4 (vec), else four of 4 bytes.
__device__ __forceinline__ void copy4(uint32_t dst, const float* base,
                                      size_t pix, int c, int C, bool in,
                                      bool vec) {
  if (vec) {
    const bool ok = in && c < C;
    f2f::cp_async16(dst, ok ? base + pix * C + c : base, ok);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool ok = in && c + k < C;
      f2f::cp_async4(dst + 4 * k, ok ? base + pix * C + c + k : base, ok);
    }
  }
}

// Run `run` of an image batch: T_RUN pixels of one image row, runs_x runs a
// row. pix: its first pixel's index in the batch; n: its pixels in the
// image; up, down: rows row - 1 and row + 1 in the image.
struct ThinRun {
  size_t pix;
  int x0, n;
  bool up, down;
};

__device__ __forceinline__ ThinRun thin_run(long run, int runs_x, int H,
                                            int W) {
  const long r = run / runs_x;  // image * H + row
  const int x0 = (int)(run - r * runs_x) * T_RUN, row = (int)(r % H);
  return {(size_t)r * W + x0, x0, min(T_RUN, W - x0), row > 0, row + 1 < H};
}

// Column x0 + dc of rows row - 1 .. row + 1 of the run's narrow operand
// (t: row `row`, column x0 + dc; stride: a row), zeros outside the image.
template <int N>
__device__ __forceinline__ void thin_col(float (&d)[3][N], const float* t,
                                         size_t stride, bool up, bool down,
                                         bool in) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    d[0][j] = in && up ? __ldg(t - stride + j) : 0.f;
    d[1][j] = in ? __ldg(t + j) : 0.f;
    d[2][j] = in && down ? __ldg(t + stride + j) : 0.f;
  }
}

// Kernel A, Cin = N <= THIN_N: y[p, o] = sum_t sum_c x[p + off_t, c] W[t, c,
// o], in tap order, f32 FMAs. Bound by writing y. Slot s of block b walks
// run 16 b + s (T_RUN pixels of one image row, unrolled); lane q owns
// output channels 64 blockIdx.y + 4 q .. + 3 and their 9 N weights in
// registers.
template <int N>
__global__ void __launch_bounds__(T_THREADS, N == 1 ? 3 : 1)
a_thin_in(const float* __restrict__ x, const float* __restrict__ w,
          float* __restrict__ y, int B, int H, int W, int Cout, int runs_x) {
  const int q = threadIdx.x & 15;
  const long run = (long)blockIdx.x * T_SLOTS + (threadIdx.x >> 4);
  const int o = blockIdx.y * 64 + 4 * q;
  if (run >= (long)B * H * runs_x) return;
  float wr[9][N][4];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int c = 0; c < N; ++c)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        wr[t][c][k] = o + k < Cout
                          ? __ldg(w + ((size_t)t * N + c) * Cout + o + k)
                          : 0.f;
  const ThinRun ru = thin_run(run, runs_x, H, W);
  const float* xr = x + ru.pix * N;  // the run's first pixel
  float* yr = y + ru.pix * Cout + o;
  const size_t stride = (size_t)W * N;
  const bool vec = Cout % 4 == 0 && o < Cout;
  float win[3][3][N];  // [column x - 1, x, x + 1][row][channel]
  thin_col<N>(win[0], xr - N, stride, ru.up, ru.down, ru.x0 > 0);
  thin_col<N>(win[1], xr, stride, ru.up, ru.down, true);
#pragma unroll
  for (int i = 0; i < T_RUN; ++i) {
    if (i >= ru.n) break;
    thin_col<N>(win[2], xr + (i + 1) * N, stride, ru.up, ru.down,
                ru.x0 + i + 1 < W);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int t = 0; t < 9; ++t)
#pragma unroll
      for (int c = 0; c < N; ++c)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          acc[k] = fmaf(win[t % 3][t / 3][c], wr[t][c][k], acc[k]);
    float* dst = yr + (size_t)i * Cout;
    if (vec) {
      __stcs(reinterpret_cast<float4*>(dst),
             make_float4(acc[0], acc[1], acc[2], acc[3]));
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (o + k < Cout) dst[k] = acc[k];
    }
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int c = 0; c < N; ++c) win[s][r][c] = win[s + 1][r][c];
  }
}

template <int N>
int launch_a_thin_in(const float* x, const float* w, float* y, int B, int H,
                     int W, int Cout, void* stream) {
  const int runs_x = (W + T_RUN - 1) / T_RUN;
  const long blocks = ((long)B * H * runs_x + T_SLOTS - 1) / T_SLOTS;
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  a_thin_in<N><<<dim3((unsigned)blocks, (Cout + 63) / 64), T_THREADS, 0,
                 (cudaStream_t)stream>>>(x, w, y, B, H, W, Cout, runs_x);
  return (int)cudaGetLastError();
}

// A pixel's V tap dots are cut into groups of 16, 8, 4, 2 and 1 (largest
// first); lane q of the pixel's 16 keeps the dots of a group of M in the
// order i ^ (q M / 16), so that each level of the reduction over the lanes
// adds the upper half of its registers, shuffled, into the lower half, the
// same registers in every lane: no select. Register i holds dot perm(V, i, q).
__device__ __forceinline__ int perm(int V, int i, int q) {
  int v0 = 0;
  while (true) {
    const int r = V - v0;
    const int m = r >= 16 ? 16 : r >= 8 ? 8 : r >= 4 ? 4 : r >= 2 ? 2 : 1;
    if (i < v0 + m) return v0 + ((i - v0) ^ ((q * m) >> 4));
    v0 += m;
  }
}

// All V dots of a pixel, lane q's partial sums in p, into out[0 .. V). A
// group of M dots at p[V0 ..] is summed over the 16 lanes of the pixel in
// halves over lane masks 8, 4, .. (a lane keeps the dots its lane bits
// select), then the rest of the masks add whole sums: p[V0] of lane q is
// dot q M / 16 of the group, summed in the same order in every lane.
template <int V0, int H, int MASK, int V>
__device__ __forceinline__ void reduce_level(float (&p)[V]) {
  if constexpr (MASK >= 1) {
#pragma unroll
    for (int i = 0; i < (H > 0 ? H : 1); ++i)
      p[V0 + i] += __shfl_xor_sync(0xffffffffu, p[V0 + i + H], MASK);
    reduce_level<V0, H / 2, MASK / 2>(p);
  }
}

template <int V, int V0 = 0>
__device__ __forceinline__ void reduce_dots(float (&p)[V], float* out, int q) {
  if constexpr (V0 < V) {
    constexpr int R = V - V0;
    constexpr int M = R >= 16 ? 16 : R >= 8 ? 8 : R >= 4 ? 4 : R >= 2 ? 2 : 1;
    reduce_level<V0, M / 2, 8>(p);
    if ((q & (16 / M - 1)) == 0) out[V0 + ((q * M) >> 4)] = p[V0];
    reduce_dots<V, V0 + M>(p, out, q);
  }
}

template <int N>
struct AOut {
  static constexpr int V = 9 * N;             // tap dots a pixel
  static constexpr int PPS = N <= 3 ? 2 : 1;  // pixels a slot takes of a row
  static constexpr int QW = T_SLOTS * PPS;    // pixels of a row of q
  static constexpr int SW = QW - 2;           // output columns of a strip
  static constexpr int STAGE = T_THREADS * PPS * 16;  // bytes of x a row
  static constexpr int QROW = QW * V;                 // floats of a q row
  static constexpr int SMEM = Q_STAGES * STAGE + 4 * QROW * 4;
};

struct AOutArgs {
  const float* x;
  const float* w;
  float* y;
  int H, W, Cin, ncg, strips, seg_rows;
};

// Kernel A, Cout = N <= THIN_N, inside out (source note). Block (blockIdx.x,
// image blockIdx.y) takes output columns c0 .. c0 + SW - 1 of the strip and
// rows r0 .. r1 - 1 of the segment, and walks q rows r0 - 1 .. r1: a step is
// one row of QW pixels (columns c0 - 1 ..) by 64 input channels (ncg steps a
// row), lane q of slot s copying channels 4 q .. + 3 of pixels s + 16 i
// (Q_STAGES - 1 steps ahead) and forming their dots with its 4 x V weights.
// A row's q goes into a ring of four rows; after one barrier, output row
// rr - 1 is gathered from q rows rr - 2 .. rr in tap order.
template <int N>
__global__ void __launch_bounds__(T_THREADS, N == 1 ? 3 : 1)
a_thin_out(const AOutArgs a) {
  using T = AOut<N>;
  constexpr int V = T::V, PPS = T::PPS;
  extern __shared__ __align__(16) unsigned char q_smem[];
  const uint32_t ring = (uint32_t)__cvta_generic_to_shared(q_smem);
  float* qring = reinterpret_cast<float*>(q_smem + Q_STAGES * T::STAGE);
  const int tid = threadIdx.x, q = tid & 15, slot = tid >> 4;
  const int c0 = (blockIdx.x % a.strips) * T::SW;
  const int r0 = (blockIdx.x / a.strips) * a.seg_rows;
  const int r1 = min(r0 + a.seg_rows, a.H);
  const size_t img = (size_t)blockIdx.y * a.H;
  const bool vec = a.Cin % 4 == 0;
  const int nsteps = (r1 - r0 + 2) * a.ncg;

  float wr[V][4];
  auto load_w = [&](int cg) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int v = perm(V, i, q), t = v / N, o = v - t * N;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = 64 * cg + 4 * q + k;
        wr[i][k] = c < a.Cin ? __ldg(a.w + ((size_t)t * a.Cin + c) * N + o)
                             : 0.f;
      }
    }
  };
  auto stage = [&](int k, int i) {
    return ring + (uint32_t)((k % Q_STAGES) * T::STAGE +
                             (i * T_THREADS + tid) * 16);
  };
  int prow = r0 - 1, pcg = 0;  // the step that issue() copies next
  auto issue = [&](int k) {
    if (k < nsteps) {
#pragma unroll
      for (int i = 0; i < PPS; ++i) {
        const int xc = c0 - 1 + slot + T_SLOTS * i;
        const bool in = prow >= 0 && prow < a.H && xc >= 0 && xc < a.W;
        copy4(stage(k, i), a.x, in ? (img + prow) * a.W + xc : 0,
              64 * pcg + 4 * q, a.Cin, in, vec);
      }
      if (++pcg == a.ncg) pcg = 0, ++prow;
    }
    f2f::cp_async_commit();
  };

  load_w(0);
  for (int k = 0; k < Q_STAGES - 1; ++k) issue(k);
  float part[PPS][V];
  for (int k = 0, rr = r0 - 1; rr <= r1; ++rr) {  // q row rr
    for (int cg = 0; cg < a.ncg; ++cg, ++k) {
      issue(k + Q_STAGES - 1);
      f2f::cp_async_wait<Q_STAGES - 1>();  // step k's chunks have landed
      if (a.ncg > 1) load_w(cg);
#pragma unroll
      for (int i = 0; i < PPS; ++i) {
        const float4 xv = lds128(stage(k, i));
#pragma unroll
        for (int j = 0; j < V; ++j) {
          float s = cg ? part[i][j] : 0.f;
          s = fmaf(xv.x, wr[j][0], s);
          s = fmaf(xv.y, wr[j][1], s);
          s = fmaf(xv.z, wr[j][2], s);
          part[i][j] = fmaf(xv.w, wr[j][3], s);
        }
      }
    }
    float* qrow = qring + ((rr + 4) & 3) * T::QROW;
#pragma unroll
    for (int i = 0; i < PPS; ++i)
      reduce_dots<V>(part[i], qrow + (slot + T_SLOTS * i) * V, q);
    // q row rr is written; gathers of output row rr - 2 and before are done
    // with the slot it overwrote (one barrier a row: a ring of four rows)
    __syncthreads();
    if (rr - 1 < r0) continue;
    for (int e = tid; e < T::SW * N; e += T_THREADS) {
      const int j = e / N, o = e - j * N;
      if (c0 + j >= a.W) break;
      float s = 0.f;
#pragma unroll
      for (int t = 0; t < 9; ++t)
        s += qring[((rr - 2 + t / 3 + 4) & 3) * T::QROW + (j + t % 3) * V +
                   t * N + o];
      a.y[((img + rr - 1) * a.W + c0 + j) * N + o] = s;
    }
  }
  f2f::cp_async_wait<0>();
}

template <int N>
int launch_a_thin_out(const float* x, const float* w, float* y, int B, int H,
                      int W, int Cin, void* stream) {
  using T = AOut<N>;
  static f2f::Resident resident;
  int blocks = 0;  // resident blocks of the card, all segments at once
  int rc = f2f::persistent_grid(a_thin_out<N>, T_THREADS, T::SMEM, 1L << 40,
                                0, &resident, &blocks);
  if (rc != 0) return rc;
  const long strips = (W + T::SW - 1) / T::SW;
  long segs = blocks / (strips * B);  // one wave: no block waits for a slot
  segs = segs < 1 ? 1 : segs > H ? H : segs;
  const int seg_rows = (int)((H + segs - 1) / segs);
  segs = (H + seg_rows - 1) / seg_rows;
  if (strips * segs > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const AOutArgs a = {x, w, y, H, W, Cin, (Cin + 63) / 64, (int)strips,
                      seg_rows};
  a_thin_out<N><<<dim3((unsigned)(strips * segs), B), T_THREADS, T::SMEM,
                  (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

struct BThinArgs {
  const float* x;
  const float* g;
  float* partial;
  int B, H, W, Cin, Cout, runs_x;
};

template <int N>
struct BThin {
  static constexpr int THREADS = N == 1 ? 512 : 256;  // by registers
  static constexpr int SLOTS = THREADS / 16;
  static constexpr int SMEM = T_STAGES * THREADS * 16 + 9 * N * 64 * 4;
};

// Kernel B, the narrow side N <= THIN_N: Cin (WIDE_IN false, 1 -> 64: g is
// the wide operand) or Cout (WIDE_IN true, 64 -> 1: x is). Lane q of a slot
// owns wide channels 64 blockIdx.y + 4 q .. + 3 and the 9 x N x 4 sums of
// dW they take. A persistent block's slot s walks runs first = SLOTS
// blockIdx.x + s, first + SLOTS gridDim.x, ..: a run's T_RUN steps are
// unrolled, so that ring slots, window columns and addresses are fixed
// offsets from pointers set once a run (the step is bound by issuing its
// instructions, not by memory: a deeper ring gains nothing). The wide
// operand's chunk of a pixel comes by the thread's own cp.async T_STAGES -
// 1 steps ahead (the next run's pixels in a run's last steps); the narrow
// one's 3 x 3 x N window slides in registers, its next column loaded a step
// ahead. With the taps of the narrow operand at p + off_t (WIDE_IN false:
// dW[t, j, c] += x[p + off_t, j] g[p, c]) or at p - off_t (WIDE_IN true:
// dW[t, c, j] += x[p, c] g[p - off_t, j]), one window serves both, its taps
// mirrored.
template <int N, bool WIDE_IN>
__global__ void __launch_bounds__(BThin<N>::THREADS, 1)
b_thin(const BThinArgs a) {
  using T = BThin<N>;
  static_assert(T_RUN % T_STAGES == 0, "a run's steps fill whole rings");
  extern __shared__ __align__(16) unsigned char b_smem[];
  const int tid = threadIdx.x, q = tid & 15, lane = tid & 31, warp = tid >> 5;
  const int cw = WIDE_IN ? a.Cin : a.Cout;
  const float* wide = WIDE_IN ? a.x : a.g;
  const float* thin = WIDE_IN ? a.g : a.x;
  const int c = blockIdx.y * 64 + 4 * q;
  const bool vec = cw % 4 == 0;
  const long nruns = (long)a.B * a.H * a.runs_x;
  const long slots = (long)gridDim.x * T::SLOTS;
  const long first = (long)blockIdx.x * T::SLOTS + (tid >> 4);
  const int nr =
      first < nruns ? (int)((nruns - first + slots - 1) / slots) : 0;
  const uint32_t ring = (uint32_t)__cvta_generic_to_shared(b_smem) + tid * 16;
  const size_t stride = (size_t)a.W * N;
  auto run_of = [&](int i) {
    return thin_run(first + i * slots, a.runs_x, a.H, a.W);
  };
  // pixel j of run ru into ring slot j % T_STAGES, or nothing; one group
  auto issue = [&](const ThinRun& ru, int j, bool any) {
    if (any)
      copy4(ring + (j % T_STAGES) * T::THREADS * 16, wide, ru.pix + j, c, cw,
            j < ru.n, vec);
    f2f::cp_async_commit();
  };

  float acc[9][N][4];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[t][j][k] = 0.f;
  ThinRun nx = run_of(0);
#pragma unroll
  for (int j = 0; j < T_STAGES - 1; ++j) issue(nx, j, nr > 0);
  for (int ri = 0; ri < nr; ++ri) {
    const ThinRun ru = nx;
    if (ri + 1 < nr) nx = run_of(ri + 1);
    const float* tr = thin + ru.pix * N;  // the run's first pixel
    float win[3][3][N];  // [column x - 1, x, x + 1][row][channel]
    float nxt[3][N];     // column x + 2, loaded while x's products run
    thin_col<N>(win[0], tr - N, stride, ru.up, ru.down, ru.x0 > 0);
    thin_col<N>(win[1], tr, stride, ru.up, ru.down, true);
    thin_col<N>(win[2], tr + N, stride, ru.up, ru.down, ru.x0 + 1 < a.W);
#pragma unroll
    for (int i = 0; i < T_RUN; ++i) {
      const int ip = i + T_STAGES - 1;  // the pixel this step copies
      if (ip < T_RUN) issue(ru, ip, true);
      else issue(nx, ip - T_RUN, ri + 1 < nr);
      f2f::cp_async_wait<T_STAGES - 1>();  // pixel i's chunk has landed
      if (i >= ru.n) continue;  // past the image's right edge
      const float4 v = lds128(ring + (i % T_STAGES) * T::THREADS * 16);
      if (i > 0) {
#pragma unroll
        for (int r = 0; r < 3; ++r)
#pragma unroll
          for (int j = 0; j < N; ++j) win[2][r][j] = nxt[r][j];
      }
      if (i + 1 < T_RUN)
        thin_col<N>(nxt, tr + (i + 2) * N, stride, ru.up, ru.down,
                    ru.x0 + i + 2 < a.W);
      const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const int dy = WIDE_IN ? 2 - t / 3 : t / 3;
        const int dx = WIDE_IN ? 2 - t % 3 : t % 3;
#pragma unroll
        for (int j = 0; j < N; ++j)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            acc[t][j][kk] = fmaf(win[dx][dy][j], vv[kk], acc[t][j][kk]);
      }
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int r = 0; r < 3; ++r)
#pragma unroll
          for (int j = 0; j < N; ++j) win[s][r][j] = win[s + 1][r][j];
    }
  }
  f2f::cp_async_wait<0>();

  // the block's sums in a fixed order: the warp's two slots, then the
  // warps one after another into red; one partial row a block
  float* red = reinterpret_cast<float*>(b_smem + T_STAGES * T::THREADS * 16);
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        acc[t][j][k] += __shfl_xor_sync(0xffffffffu, acc[t][j][k], 16);
  for (int w8 = 0; w8 < T::THREADS / 32; ++w8) {
    if (warp == w8 && lane < 16) {
#pragma unroll
      for (int t = 0; t < 9; ++t)
#pragma unroll
        for (int j = 0; j < N; ++j) {
          float4* r =
              reinterpret_cast<float4*>(red + (t * N + j) * 64 + 4 * q);
          float4 s = make_float4(acc[t][j][0], acc[t][j][1], acc[t][j][2],
                                 acc[t][j][3]);
          if (w8) {
            const float4 o = *r;
            s = make_float4(o.x + s.x, o.y + s.y, o.z + s.z, o.w + s.w);
          }
          *r = s;
        }
    }
    __syncthreads();
  }
  float* dst = a.partial + (size_t)blockIdx.x * 9 * a.Cin * a.Cout;
  for (int e = tid; e < 9 * N * 64; e += T::THREADS) {
    const int tj = e / 64, t = tj / N, j = tj - t * N;
    const int ch = blockIdx.y * 64 + e % 64;
    if (ch < cw)
      dst[WIDE_IN ? ((size_t)t * a.Cin + ch) * N + j
                  : ((size_t)t * N + j) * a.Cout + ch] = red[e];
  }
}

template <int N, bool WIDE_IN>
int launch_b_thin(const BThinArgs& a, float* dw, int max_blocks,
                  void* stream) {
  using T = BThin<N>;
  static f2f::Resident resident;
  const long ntiles = ((long)a.B * a.H * a.runs_x + T::SLOTS - 1) / T::SLOTS;
  int grid = 0;
  int rc = f2f::persistent_grid(b_thin<N, WIDE_IN>, T::THREADS, T::SMEM,
                                ntiles, max_blocks, &resident, &grid);
  if (rc != 0) return rc;
  const int cw = WIDE_IN ? a.Cin : a.Cout;
  b_thin<N, WIDE_IN><<<dim3(grid, (cw + 63) / 64), T::THREADS, T::SMEM,
                       (cudaStream_t)stream>>>(a);
  if ((rc = (int)cudaGetLastError()) != 0) return rc;
  return f2f::finish(a.partial, grid, 9 * a.Cin * a.Cout, dw, stream);
}

int launch_a_thin(const float* x, const float* w, float* y, int B, int H,
                  int W, int Cin, int Cout, void* stream) {
  if (Cin <= THIN_N) {
    switch (Cin) {
      case 1: return launch_a_thin_in<1>(x, w, y, B, H, W, Cout, stream);
      case 2: return launch_a_thin_in<2>(x, w, y, B, H, W, Cout, stream);
      case 3: return launch_a_thin_in<3>(x, w, y, B, H, W, Cout, stream);
      default: return launch_a_thin_in<4>(x, w, y, B, H, W, Cout, stream);
    }
  }
  switch (Cout) {
    case 1: return launch_a_thin_out<1>(x, w, y, B, H, W, Cin, stream);
    case 2: return launch_a_thin_out<2>(x, w, y, B, H, W, Cin, stream);
    case 3: return launch_a_thin_out<3>(x, w, y, B, H, W, Cin, stream);
    default: return launch_a_thin_out<4>(x, w, y, B, H, W, Cin, stream);
  }
}

int launch_dw_thin(const float* x, const float* g, float* dw, float* partial,
                   int max_blocks, int B, int H, int W, int Cin, int Cout,
                   void* stream) {
  const BThinArgs a = {x, g, partial, B, H, W, Cin, Cout,
                       (W + T_RUN - 1) / T_RUN};
  if (Cin <= THIN_N) {
    switch (Cin) {
      case 1: return launch_b_thin<1, false>(a, dw, max_blocks, stream);
      case 2: return launch_b_thin<2, false>(a, dw, max_blocks, stream);
      case 3: return launch_b_thin<3, false>(a, dw, max_blocks, stream);
      default: return launch_b_thin<4, false>(a, dw, max_blocks, stream);
    }
  }
  switch (Cout) {
    case 1: return launch_b_thin<1, true>(a, dw, max_blocks, stream);
    case 2: return launch_b_thin<2, true>(a, dw, max_blocks, stream);
    case 3: return launch_b_thin<3, true>(a, dw, max_blocks, stream);
    default: return launch_b_thin<4, true>(a, dw, max_blocks, stream);
  }
}

}  // namespace

extern "C" {

// x: (B, H, W, Cin) f32; w: (3, 3, Cin, Cout) f32 HWIO; y: (B, H, W, Cout)
// f32 out. Returns a cudaError_t code: 0 on a launch that was accepted.
int f2f_conv3x3(const float* x, const float* w, float* y, int B, int H, int W,
                int Cin, int Cout, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  // shape classes (body_of): the tensor cores where both channel counts are
  // multiples of 8, the thin bodies where one is at most THIN_N, f32 FMAs
  // for the other counts
  switch (body_of(0, 1, Cin, Cout)) {
    case BODY_TC:
      return launch_conv3x3_wg(x, w, y, B, H, W, Cin, Cout, stream);
    case BODY_THIN: return launch_a_thin(x, w, y, B, H, W, Cin, Cout, stream);
    default:
      return Cout <= 8
                 ? launch_conv3x3<8, 2>(x, w, y, B, H, W, Cin, Cout, stream)
                 : launch_conv3x3<64, 8>(x, w, y, B, H, W, Cin, Cout, stream);
  }
}

// x: (B, H, W, Cin), g: (B, H, W, Cout), both f32 (is_f32) or both bf16;
// dw: (3, 3, Cin, Cout) f32 out; partial: (max_blocks, 9, Cin, Cout) f32
// scratch. Returns a cudaError_t code: 0 on launches that were accepted.
int f2f_dw_conv3x3(const void* x, const void* g, int is_f32, float* dw,
                   float* partial, int max_blocks, int B, int H, int W,
                   int Cin, int Cout, void* stream) {
  if (max_blocks <= 0 || B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0
      || (Cin + B_CT - 1) / B_CT > 65535 || (Cout + B_CT - 1) / B_CT > 65535)
    return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* gf = static_cast<const float*>(g);
  switch (body_of(1, is_f32, Cin, Cout)) {  // as f2f_conv3x3's
    case BODY_BF16:
      return launch_dw_mma(x, g, dw, partial, max_blocks, B, H, W, Cin, Cout,
                           stream);
    case BODY_TC:
      return launch_dw_tc(xf, gf, dw, partial, max_blocks, B, H, W, Cin, Cout,
                          stream);
    case BODY_THIN:
      return launch_dw_thin(xf, gf, dw, partial, max_blocks, B, H, W, Cin,
                            Cout, stream);
    default:
      return launch_dw_fma(x, g, dw, partial, max_blocks, B, H, W, Cin, Cout,
                           stream);
  }
}

// The body that f2f_conv3x3 (kernel_b = 0) or f2f_dw_conv3x3 (kernel_b = 1)
// runs on these operands: 0 f32 FMAs, 1 split f32 on the TF32 tensor cores,
// 2 the thin class, 3 bf16 on the tensor cores.
int f2f_conv3x3_body(int kernel_b, int is_f32, int cin, int cout) {
  return body_of(kernel_b, is_f32, cin, cout);
}

const char* f2f_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
