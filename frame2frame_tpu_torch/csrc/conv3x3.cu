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
// the JAX package. Every product is an f32 FMA: the function is f32, and the
// reference multiplies in f32, so no tensor core (TF32 would keep 10 bits).
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
// Bound at 540p, 64 -> 64, f32 (one launch of either kernel): 2 * 540 * 960
// * 64 * 64 * 9 = 38.2 GFLOP -> 0.57 ms at 67 TFLOP/s (f32 outside the tensor
// cores), against 265 MB of inputs and output -> 0.079 ms at 3.35 TB/s: both
// are bound by operations. Kernel B on bf16 operands moves half the bytes
// and does the same f32 FMAs.
//
// Design, simple first (a later change may move kernel A to the tensor cores
// in three bf16 passes, or kernel B to TF32 with a correction term):
//
// Kernel A: a block of 256 threads computes a tile of 8*NPG/2 x 16 pixels by
// COT output channels (COT = 64, or 8 where Cout <= 8, so the 64 -> 1 layer
// does not compute 63 empty channels), one thread 8 pixels of a row by 8
// channels in 64 f32 accumulators. Input channels go in chunks of CI: the
// chunk's halo tile (zeros outside the image) and its 9 x CI x COT weights
// are staged in shared memory, then each thread reads ten input values of a
// halo row and eight weights a tap and does 8 x 8 FMAs with them (about 20
// FMAs a shared-memory load). Weights are stored with the first and second
// four channels of each thread's eight in separate halves, so that the
// eight threads of a quarter warp read 128 contiguous bytes.
//
// Kernel B: a block is 9 taps x CG x OG threads (576 for 64 -> 64), one
// thread the 8 x 8 block of dW of one tap, 8 input and 8 output channels, in
// 64 f32 accumulators. Blocks walk 4 x 16 pixel tiles in a grid-stride loop;
// a tile's x halo and g values are staged in shared memory as f32 (bf16
// operands are widened, exactly), then each thread runs over the tile's 64
// pixels: two float4 loads of x at the pixel shifted by its tap, two of g,
// 64 FMAs. Thin layers (Cin or Cout of 1) leave 7 of a thread's 8 rows or
// columns empty: their dW is small beside a 64 -> 64 layer's.

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

constexpr int B_TH = 4;                       // pixel tile rows
constexpr int B_TW = 16;                      // pixel tile columns
constexpr int B_HW = B_TW + 2;                // halo columns
constexpr int B_HPIX = (B_TH + 2) * B_HW;     // halo pixels
constexpr int B_CT = 64;                      // channels of a block, in and out
constexpr int B_MAX_THREADS = 9 * (B_CT / 8) * (B_CT / 8);

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// x: (B, H, W, Cin), g: (B, H, W, Cout); partial: (gridDim.x, 9, Cin, Cout).
// A block owns input channels 64 blockIdx.y .. and output channels
// 64 blockIdx.z ..; cg_n and og_n are the groups of 8 of a full tile.
template <typename T>
__global__ void __launch_bounds__(B_MAX_THREADS, 1)
dw_conv3x3_k(const T* __restrict__ x, const T* __restrict__ g,
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
        v = widen(x[(((size_t)bi * H + yy) * W + xx) * Cin + c0 + c]);
      xs[p * B_CT + wpos<B_CT>(c)] = v;
    }
    for (int e = tid; e < B_TH * B_TW * B_CT; e += blockDim.x) {
      const int c = e % B_CT, p = e / B_CT;
      const int yy = y0 + p / B_TW, xx = x0 + p % B_TW;
      float v = 0.f;
      if (c < no && yy < H && xx < W)
        v = widen(g[(((size_t)bi * H + yy) * W + xx) * Cout + o0 + c]);
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

template <typename T>
int launch_dw(const void* x, const void* g, float* dw, float* partial,
              int max_blocks, int B, int H, int W, int Cin, int Cout,
              void* stream) {
  const int tiles_y = (H + B_TH - 1) / B_TH;
  const int tiles_x = (W + B_TW - 1) / B_TW;
  const long ntiles = (long)B * tiles_y * tiles_x;
  const int blocks = (int)(ntiles < max_blocks ? ntiles : max_blocks);
  const int cg_n = (min(Cin, B_CT) + 7) / 8, og_n = (min(Cout, B_CT) + 7) / 8;
  const dim3 grid(blocks, (Cin + B_CT - 1) / B_CT, (Cout + B_CT - 1) / B_CT);
  dw_conv3x3_k<T><<<grid, 9 * cg_n * og_n, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), partial, B, H, W,
      Cin, Cout, tiles_y, tiles_x, cg_n, og_n);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return f2f::finish(partial, blocks, 9 * Cin * Cout, dw, stream);
}

}  // namespace

extern "C" {

// x: (B, H, W, Cin) f32; w: (3, 3, Cin, Cout) f32 HWIO; y: (B, H, W, Cout)
// f32 out. Returns a cudaError_t code: 0 on a launch that was accepted.
int f2f_conv3x3(const float* x, const float* w, float* y, int B, int H, int W,
                int Cin, int Cout, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  return Cout <= 8 ? launch_conv3x3<8, 2>(x, w, y, B, H, W, Cin, Cout, stream)
                   : launch_conv3x3<64, 8>(x, w, y, B, H, W, Cin, Cout,
                                           stream);
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
  return is_f32 ? launch_dw<float>(x, g, dw, partial, max_blocks, B, H, W,
                                   Cin, Cout, stream)
                : launch_dw<__nv_bfloat16>(x, g, dw, partial, max_blocks, B,
                                           H, W, Cin, Cout, stream);
}

const char* f2f_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
