// The TV-L1 primal-dual inner loop of one warp of one scale, run to
// convergence in ONE launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel `tvl1_inner_loop` (`_inner_kernel`) of
// frame2frame_tpu/flow/tvl1_pallas.py. That kernel is one program that keeps
// all state in VMEM and shifts whole arrays; none of that is carried over.
//
// What it computes, for each pair of a batch, with rho_c, I1wx, I1wy and grad
// fixed, while err > eps^2 and n < max_iters:
//   rho = rho_c + I1wx u1 + I1wy u2; v = u + d(rho) (three-way threshold
//   against +-l_t grad, with the grad < 1e-10 guard);
//   u' = v + theta div(p)   (backward differences, the solver's border rules);
//   err = (sum (u1' - u1)^2 + sum (u2' - u2)^2) / size;
//   p' = (p + taut grad(u')) / (1 + taut |grad(u')|)   (forward differences,
//   zero last column and row).
//
// What bounds it on this card: neither bytes nor operations but latency. The
// stop test needs a sum over the image every iteration and the stencils reach
// across tiles, so an iteration cannot be shorter than one barrier across all
// blocks plus one round of loads from L2.
//
// Design (first version: simple, state in global memory, which at every
// solved scale of a 540p frame stays in the 50 MB L2):
// - a cooperative launch whose grid fits the card at once; persistent blocks
//   walk over (pair, tile) items, a tile is 8 x 32 pixels;
// - ONE grid barrier an iteration. A block computes u' for its tile and for
//   the one-pixel halo to the right and below (in shared memory, recomputed
//   and not exchanged), then p' for the tile from it;
// - u and p are double-buffered (read one set, write the other), per pair:
//   iteration 0 reads the inputs and writes the outputs, later ones alternate
//   between a scratch set and the outputs; a last pass copies a pair whose
//   final state lies elsewhere into the outputs. The inputs are never written;
// - the error sum is deterministic and does not depend on the batch or on the
//   grid: one partial per tile (fixed shuffle tree, in double), and every
//   block adds a pair's partials in the same fixed order, so all blocks take
//   the same stop decision without a second barrier. No atomics;
// - per-pair convergence: every block keeps each pair's n and err in shared
//   memory; an inactive pair's tiles are skipped, so its state no longer
//   changes; the loop ends when no pair is active;
// - every product and sum is a rounded one (__fmul_rn, __fadd_rn, ...), in
//   the order of the reference, never contracted into an FMA: the plain
//   PyTorch version rounds after every op, and one stop decision that differs
//   moves a flow by about epsilon.
// The partials of the error are added in double where the reference adds in
// f32: the order of the additions then no longer shows in the f32 result.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TH = 8, TW = 32;        // tile: one pixel a thread of 8 warps
constexpr int TILE_WARPS = 8;
constexpr int HALO = TH + TW;         // right column, bottom row
constexpr int THREADS = (TILE_WARPS + 2) * 32;  // two more warps: the halo
constexpr int MAXP = 512;             // pairs a launch
constexpr float GRAD_IS_ZERO = 1e-10f;

struct Args {
  const float* fixed[4];  // I1wx, I1wy, rho_c, grad
  const float* in[6];     // u1, u2, p11, p12, p21, p22
  float* out[6];
  float* tmp[6];
  double* partial;        // (2, P, tiles)
  float* stats;           // (P, 2): iterations run, last error
  int P, ny, nx, tiles_x, tiles, max_iters;
  float l_t, taut, theta, eps2, size;
};

__device__ __forceinline__ float sub(float a, float b) {
  return __fadd_rn(a, -b);
}

// The six state arrays (u1, u2, p11, p12, p21, p22) a step reads or writes.
struct State {
  float* p[6];
};

// A state value that another block may have written in the step before:
// read from L2, past this multiprocessor's L1.
__device__ __forceinline__ float ld(const float* p, size_t k) {
  return __ldcg(p + k);
}

// u' at pixel (i, j) of the plane at offset `base`, from the state `st`.
__device__ __forceinline__ void primal(const Args& a, const State& st,
                                       size_t base, int i, int j, float& u1,
                                       float& u2, float& u1n, float& u2n) {
  const int nx = a.nx, ny = a.ny;
  const size_t k = base + (size_t)i * nx + j;
  const float ix = a.fixed[0][k], iy = a.fixed[1][k];
  const float rho_c = a.fixed[2][k], g = a.fixed[3][k];
  float* const* s = st.p;
  u1 = ld(s[0], k);
  u2 = ld(s[1], k);
  const float rho = __fadd_rn(__fadd_rn(rho_c, __fmul_rn(ix, u1)),
                              __fmul_rn(iy, u2));
  float d1, d2;
  if (rho < __fmul_rn(-a.l_t, g)) {
    d1 = __fmul_rn(a.l_t, ix);
    d2 = __fmul_rn(a.l_t, iy);
  } else if (rho > __fmul_rn(a.l_t, g)) {
    d1 = __fmul_rn(-a.l_t, ix);
    d2 = __fmul_rn(-a.l_t, iy);
  } else {
    const float fi = g < GRAD_IS_ZERO ? 0.0f : __fdiv_rn(-rho, g);
    d1 = __fmul_rn(fi, ix);
    d2 = __fmul_rn(fi, iy);
  }
  const float v1 = __fadd_rn(u1, d1), v2 = __fadd_rn(u2, d2);
  float dx, dy;
  // div(p11, p12): column 0 and row 0 keep p, the last ones take -p before
  dx = j == 0 ? ld(s[2], k) : (j == nx - 1 ? -ld(s[2], k - 1)
                  : sub(ld(s[2], k), ld(s[2], k - 1)));
  dy = i == 0 ? ld(s[3], k) : (i == ny - 1 ? -ld(s[3], k - nx)
                  : sub(ld(s[3], k), ld(s[3], k - nx)));
  u1n = __fadd_rn(v1, __fmul_rn(a.theta, __fadd_rn(dx, dy)));
  dx = j == 0 ? ld(s[4], k) : (j == nx - 1 ? -ld(s[4], k - 1)
                  : sub(ld(s[4], k), ld(s[4], k - 1)));
  dy = i == 0 ? ld(s[5], k) : (i == ny - 1 ? -ld(s[5], k - nx)
                  : sub(ld(s[5], k), ld(s[5], k - nx)));
  u2n = __fadd_rn(v2, __fmul_rn(a.theta, __fadd_rn(dx, dy)));
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(THREADS) tvl1_inner_k(const Args a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float su1[TH + 1][TW + 1], su2[TH + 1][TW + 1];
  __shared__ double red[TILE_WARPS];
  __shared__ int n_s[MAXP];
  __shared__ float err_s[MAXP];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t plane = (size_t)a.ny * a.nx;
  const int items = a.P * a.tiles;

  for (int q = tid; q < a.P; q += THREADS) {
    n_s[q] = 0;
    err_s[q] = __int_as_float(0x7f800000);  // +inf
  }
  __syncthreads();

  // where this thread works inside a tile: a pixel of the tile, or of its
  // halo (r == TH or c == TW), or nowhere (the spare lanes of the last warps)
  int r, c;
  if (tid < TH * TW) {
    r = tid >> 5;
    c = lane;
  } else if (tid < TH * TW + TH) {
    r = tid - TH * TW;
    c = TW;
  } else if (tid < TH * TW + HALO) {
    r = TH;
    c = tid - TH * TW - TH;
  } else {
    r = c = -1;
  }
  const bool inner = tid < TH * TW;

  for (int it = 0;; ++it) {
    int live = 0;
    for (int q = tid; q < a.P; q += THREADS)
      live |= err_s[q] > a.eps2 && n_s[q] < a.max_iters;
    if (!__syncthreads_or(live)) break;  // the same in every block

    double* part = a.partial + (size_t)(it & 1) * items;
    for (int w = blockIdx.x; w < items; w += gridDim.x) {
      const int q = w / a.tiles, t = w - q * a.tiles;
      const int n = n_s[q];
      if (!(err_s[q] > a.eps2 && n < a.max_iters)) continue;
      State src, dst;
#pragma unroll
      for (int x = 0; x < 6; ++x) {
        src.p[x] = n == 0 ? const_cast<float*>(a.in[x])
                          : (n & 1 ? a.out[x] : a.tmp[x]);
        dst.p[x] = n & 1 ? a.tmp[x] : a.out[x];
      }
      const size_t base = (size_t)q * plane;
      const int i = (t / a.tiles_x) * TH + r, j = (t % a.tiles_x) * TW + c;
      const bool here = r >= 0 && i < a.ny && j < a.nx;
      size_t k = 0;
      float p11 = 0, p12 = 0, p21 = 0, p22 = 0;
      double sq = 0.0;
      if (here) {
        k = base + (size_t)i * a.nx + j;
        float u1, u2, u1n, u2n;
        primal(a, src, base, i, j, u1, u2, u1n, u2n);
        su1[r][c] = u1n;
        su2[r][c] = u2n;
        if (inner) {
          dst.p[0][k] = u1n;
          dst.p[1][k] = u2n;
          const float e1 = sub(u1n, u1), e2 = sub(u2n, u2);
          sq = (double)__fmul_rn(e1, e1) + (double)__fmul_rn(e2, e2);
          p11 = ld(src.p[2], k);
          p12 = ld(src.p[3], k);
          p21 = ld(src.p[4], k);
          p22 = ld(src.p[5], k);
        }
      }
      if (inner) {
        sq = warp_sum(sq);
        if (lane == 0) red[warp] = sq;
      }
      __syncthreads();
      if (inner && here) {
        const bool right = j < a.nx - 1, below = i < a.ny - 1;
        const float c1 = su1[r][c], c2 = su2[r][c];
        const float u1x = right ? sub(su1[r][c + 1], c1) : 0.0f;
        const float u1y = below ? sub(su1[r + 1][c], c1) : 0.0f;
        const float u2x = right ? sub(su2[r][c + 1], c2) : 0.0f;
        const float u2y = below ? sub(su2[r + 1][c], c2) : 0.0f;
        const float g1 = __fsqrt_rn(__fadd_rn(__fmul_rn(u1x, u1x),
                                              __fmul_rn(u1y, u1y)));
        const float g2 = __fsqrt_rn(__fadd_rn(__fmul_rn(u2x, u2x),
                                              __fmul_rn(u2y, u2y)));
        const float ng1 = __fadd_rn(1.0f, __fmul_rn(a.taut, g1));
        const float ng2 = __fadd_rn(1.0f, __fmul_rn(a.taut, g2));
        dst.p[2][k] = __fdiv_rn(__fadd_rn(p11, __fmul_rn(a.taut, u1x)), ng1);
        dst.p[3][k] = __fdiv_rn(__fadd_rn(p12, __fmul_rn(a.taut, u1y)), ng1);
        dst.p[4][k] = __fdiv_rn(__fadd_rn(p21, __fmul_rn(a.taut, u2x)), ng2);
        dst.p[5][k] = __fdiv_rn(__fadd_rn(p22, __fmul_rn(a.taut, u2y)), ng2);
      }
      if (tid == 0) {
        double s = red[0];
#pragma unroll
        for (int x = 1; x < TILE_WARPS; ++x) s += red[x];
        part[w] = s;
      }
      __syncthreads();
    }

    grid.sync();

    // every block adds each active pair's partials, a warp a pair, in one
    // fixed order, and takes the pair's step count and error from them
    for (int q = warp; q < a.P; q += THREADS / 32) {
      if (!(err_s[q] > a.eps2 && n_s[q] < a.max_iters)) continue;
      const double* pq = part + (size_t)q * a.tiles;
      double s = 0.0;
      for (int t = lane; t < a.tiles; t += 32) s += __ldcg(pq + t);
      s = warp_sum(s);
      if (lane == 0) {
        err_s[q] = __fdiv_rn((float)s, a.size);
        n_s[q] += 1;
      }
    }
    __syncthreads();
  }

  // a pair that never ran still has its state in the inputs; one that ran an
  // even number of steps has it in the scratch set
  for (int q = 0; q < a.P; ++q) {
    const int n = n_s[q];
    if (n & 1) continue;
    const size_t base = (size_t)q * plane;
    for (size_t e = (size_t)blockIdx.x * THREADS + tid; e < plane;
         e += (size_t)gridDim.x * THREADS) {
#pragma unroll
      for (int x = 0; x < 6; ++x)
        a.out[x][base + e] = __ldcg((n == 0 ? a.in[x] : a.tmp[x]) + base + e);
    }
  }
  if (blockIdx.x == 0) {
    for (int q = tid; q < a.P; q += THREADS) {
      a.stats[2 * q] = (float)n_s[q];
      a.stats[2 * q + 1] = err_s[q];
    }
  }
}

// `syncs` grid barriers and nothing else: what a launch of this design pays
// an iteration whatever the image.
__global__ void __launch_bounds__(THREADS) barrier_probe_k(int syncs) {
  cg::grid_group grid = cg::this_grid();
  for (int s = 0; s < syncs; ++s) grid.sync();
}

// Blocks of `kernel` that the current device holds at once; asked once a
// device.
template <typename K>
int resident_blocks(K kernel, int* cache) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cache[dev] == 0) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                      0) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
    cache[dev] = per_sm * sms;
  }
  return cache[dev];
}

int g_inner_blocks[64], g_probe_blocks[64];

}  // namespace

extern "C" {

// Each returns a cudaError_t code: 0 on a launch that was accepted.

// fixed: I1wx, I1wy, rho_c, grad; in / out / tmp: u1, u2, p11, p12, p21, p22;
// every array (P, ny, nx) f32, contiguous; partial: (2, P, tiles) f64 with
// tiles = ceil(ny / 8) * ceil(nx / 32); stats: (P, 2) f32 out. 1 <= P <= 512.
// The grid never exceeds what the device holds at once; a device that holds
// no block gives cudaErrorCooperativeLaunchTooLarge.
int f2f_tvl1_inner(const float* const* fixed, const float* const* in,
                   float* const* out, float* const* tmp, double* partial,
                   float* stats, int P, int ny, int nx, float l_t, float taut,
                   float theta, float eps2, int max_iters, void* stream) {
  if (P < 1 || P > MAXP || ny < 1 || nx < 1) return (int)cudaErrorInvalidValue;
  Args a;
  for (int x = 0; x < 4; ++x) a.fixed[x] = fixed[x];
  for (int x = 0; x < 6; ++x) {
    a.in[x] = in[x];
    a.out[x] = out[x];
    a.tmp[x] = tmp[x];
  }
  a.partial = partial;
  a.stats = stats;
  a.P = P;
  a.ny = ny;
  a.nx = nx;
  a.tiles_x = (nx + TW - 1) / TW;
  a.tiles = a.tiles_x * ((ny + TH - 1) / TH);
  a.max_iters = max_iters;
  a.l_t = l_t;
  a.taut = taut;
  a.theta = theta;
  a.eps2 = eps2;
  a.size = (float)((double)ny * (double)nx);
  const int fit = resident_blocks(tvl1_inner_k, g_inner_blocks);
  if (fit < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const long long items = (long long)P * a.tiles;
  const int blocks = items < fit ? (int)items : fit;
  void* params[] = {&a};
  cudaError_t rc = cudaLaunchCooperativeKernel(
      (const void*)tvl1_inner_k, dim3(blocks), dim3(THREADS), params, 0,
      (cudaStream_t)stream);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}

// The grid a launch of f2f_tvl1_inner takes for P pairs of (ny, nx).
int f2f_tvl1_inner_blocks(int P, int ny, int nx) {
  const int fit = resident_blocks(tvl1_inner_k, g_inner_blocks);
  const long long items =
      (long long)P * ((nx + TW - 1) / TW) * ((ny + TH - 1) / TH);
  return items < fit ? (int)items : fit;
}

// `syncs` grid barriers on `blocks` blocks of the inner kernel's size.
int f2f_tvl1_barrier_probe(int blocks, int syncs, void* stream) {
  const int fit = resident_blocks(barrier_probe_k, g_probe_blocks);
  if (blocks < 1 || blocks > fit)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  void* params[] = {&syncs};
  cudaError_t rc = cudaLaunchCooperativeKernel(
      (const void*)barrier_probe_k, dim3(blocks), dim3(THREADS), params, 0,
      (cudaStream_t)stream);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}

const char* f2f_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
