// The TV-L1 primal-dual inner loop of one warp of one scale, run to
// convergence in ONE launch, for Hopper (sm_90a). Two bodies; the caller
// picks one by the level's shape alone (flow/tvl1_inner.py cluster_plan).
//
// Replaces the TPU kernel `tvl1_inner_loop` (`_inner_kernel`) of
// frame2frame_tpu/flow/tvl1_pallas.py. That kernel is one program that keeps
// all state in VMEM for the whole loop; the cluster body carries that idea
// over to a thread-block cluster's shared memory. Nothing else is carried
// over (it shifts whole arrays).
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
// across tiles, so an iteration cannot be shorter than the exchanges that
// publish the new state and the error, plus the chain of dependent
// operations of a pixel. With the state in global memory (the cooperative
// body) each iteration pays a grid barrier (1.2 us on an H100) and round
// trips to L2: 5.2 us an iteration at 135 x 240. A cluster-scope release (a
// barrier.cluster.arrive.release, or a fence.acq_rel.cluster) costs 0.4-0.8
// us by itself, an empty cluster barrier with release and acquire.
//
// The cluster body (tvl1_inner_cluster_k), for levels of up to 144 tiles
// (every solved level of a 540p flow with the denoising parameters; all
// but 270 x 480 of a 1080p flow):
// - one pair is one thread-block cluster, a batch of P pairs P clusters;
//   clusters never wait on each other, so a pair stops when it converges;
// - the level is cut into 8 x 32 tiles; block b of the cluster owns the
//   tiles [b * per, (b + 1) * per) in raster order, per <= 9, one to three
//   pixels a thread (whole tiles, not bands of whole tile rows: 135 x 240
//   has 17 tile rows, which 16 blocks take no finer than two rows, 16 tiles,
//   a block, where a raster split gives each at most 9);
// - u1, u2, p11, p12, p21, p22 live in the owning block's shared memory for
//   the whole launch, with a row and a column of halo a tile for what its
//   neighbours in other blocks hold; the four fixed fields of a thread's
//   pixel stay in its registers; global memory is read to load the state
//   and written to store it;
// - an iteration is two phases: (A) u' at each pixel from its own u and p
//   and the p of its left and upper neighbours, written over u; (B) p' at
//   each pixel from its own p and the u' of itself and its right and lower
//   neighbours, written over p. Each phase reads only what the other phase
//   wrote, so updating in place is safe, and no halo is recomputed;
// - what another block needs (u' of a tile's first row and column after
//   (A), p' of its last row and column after (B), and the error partials)
//   is pushed into that block's halo with st.async, whose bytes complete a
//   transaction on that block's mbarrier; one thread of each block waits on
//   its own mbarriers (acquire at cluster scope) and __syncthreads hands
//   the data to the block. No thread makes a cluster-scope release in the
//   loop. A block reads only its own shared memory;
// - the error: one double partial per 8 x 32 tile, its row sums by the
//   warp's shuffle tree and its eight rows added in order, as the
//   cooperative body does; every block adds all partials of its pair,
//   lane-strided over the tiles in order and then the warp's tree, in a
//   warp that overlaps it with (B): all blocks take the same stop decision,
//   and both bodies give the same bits;
// - only the pixels inside the level compute (the others push zeros where
//   their slot of a halo expects bytes), and a zero reaching a rounded
//   division or square root is handed over as 1 and given back (div0,
//   sqrt0): those operations take a slow path for a zero, which a tile's
//   lanes outside a small level would hit in every iteration;
// - a block exits once every push into it has arrived, and nobody reads
//   another block's memory, so the launch ends without a cluster barrier.
//
// The cooperative body (tvl1_inner_k), for larger levels (270 x 480 of a
// 1080p flow; the flow CLI's default fscale=0 at 540 x 960): a
// cooperative launch whose grid fits the card at once; persistent blocks
// walk over (pair, tile) items; one grid barrier an iteration, a block
// recomputing u' for the one-pixel halo to the right and below its tile; u
// and p double-buffered in global memory (read one set, write the other);
// per-pair convergence by each block keeping each pair's n and err in shared
// memory; the same per-tile partials, added by every block in the same
// fixed order.
//
// In both, every product and sum is a rounded one (__fmul_rn, __fadd_rn,
// ...), in the order of the reference, never contracted into an FMA: the
// plain PyTorch version rounds after every op, and one stop decision that
// differs moves a flow by about epsilon. The partials of the error are added
// in double where the reference adds in f32: the order of the additions then
// no longer shows in the f32 result.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TH = 8, TW = 32;        // tile: one pixel a thread of 8 warps
constexpr int TILE = TH * TW;
constexpr int TILE_WARPS = 8;
constexpr int HALO = TH + TW;         // right column, bottom row
constexpr int THREADS = (TILE_WARPS + 2) * 32;  // two more warps: the halo
constexpr int MAXP = 512;             // pairs a launch
constexpr float GRAD_IS_ZERO = 1e-10f;
// the cluster body: at most 16 blocks a cluster (a non-portable size)
constexpr int MAX_CLUSTER = 16;

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

// x / y and sqrt(x), rounded, with a zero x handed to the operation as 1 and
// given back as itself (x / y = x for y > 0, sqrt(x) = x): the same bits,
// without the slow path that the rounded operations take for a zero.
__device__ __forceinline__ float div0(float x, float y) {
  const float q = __fdiv_rn(x == 0.0f ? 1.0f : x, y);
  return x == 0.0f ? x : q;
}

__device__ __forceinline__ float sqrt0(float x) {
  const float q = __fsqrt_rn(x == 0.0f ? 1.0f : x);
  return x == 0.0f ? x : q;
}

// v = u + d(rho) at one pixel: the thresholding step.
__device__ __forceinline__ void threshold(float l_t, float ix, float iy,
                                          float rho_c, float g, float u1,
                                          float u2, float& v1, float& v2) {
  // every case computed and one selected: no branch, so the pixels of a
  // thread overlap (the rounded operations of each case are the same). The
  // division sees -rho / grad only where its case is taken, 1 / 1 elsewhere:
  // a quotient out of range would take the division's slow path
  const float rho = __fadd_rn(__fadd_rn(rho_c, __fmul_rn(ix, u1)),
                              __fmul_rn(iy, u2));
  const bool lo = rho < __fmul_rn(-l_t, g), hi = rho > __fmul_rn(l_t, g);
  const bool mid = !lo && !hi && !(g < GRAD_IS_ZERO);
  const float fi = mid ? div0(-rho, mid ? g : 1.0f) : 0.0f;
  const float d1 = lo ? __fmul_rn(l_t, ix)
                      : (hi ? __fmul_rn(-l_t, ix) : __fmul_rn(fi, ix));
  const float d2 = lo ? __fmul_rn(l_t, iy)
                      : (hi ? __fmul_rn(-l_t, iy) : __fmul_rn(fi, iy));
  v1 = __fadd_rn(u1, d1);
  v2 = __fadd_rn(u2, d2);
}

// One backward difference of div(p): the first column (row) keeps p, the
// last takes -p before. `before` is read only where it is used.
#define DIV_TERM(first, last, own, before) \
  ((first) ? (own) : ((last) ? -(before) : sub((own), (before))))

// The same from values both read: a select, not a branch.
__device__ __forceinline__ float div_term(bool first, bool last, float own,
                                          float before) {
  return DIV_TERM(first, last, own, before);
}

// p' at one pixel from u' differences: the dual step.
__device__ __forceinline__ void dual(float taut, float u1x, float u1y,
                                     float u2x, float u2y, float& p11,
                                     float& p12, float& p21, float& p22) {
  const float g1 = sqrt0(__fadd_rn(__fmul_rn(u1x, u1x), __fmul_rn(u1y, u1y)));
  const float g2 = sqrt0(__fadd_rn(__fmul_rn(u2x, u2x), __fmul_rn(u2y, u2y)));
  const float ng1 = __fadd_rn(1.0f, __fmul_rn(taut, g1));
  const float ng2 = __fadd_rn(1.0f, __fmul_rn(taut, g2));
  p11 = div0(__fadd_rn(p11, __fmul_rn(taut, u1x)), ng1);
  p12 = div0(__fadd_rn(p12, __fmul_rn(taut, u1y)), ng1);
  p21 = div0(__fadd_rn(p21, __fmul_rn(taut, u2x)), ng2);
  p22 = div0(__fadd_rn(p22, __fmul_rn(taut, u2y)), ng2);
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// The cooperative body: state in global memory, one grid barrier an
// iteration.

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
  float* const* s = st.p;
  u1 = ld(s[0], k);
  u2 = ld(s[1], k);
  float v1, v2;
  threshold(a.l_t, a.fixed[0][k], a.fixed[1][k], a.fixed[2][k], a.fixed[3][k],
            u1, u2, v1, v2);
  const bool j0 = j == 0, jl = j == nx - 1, i0 = i == 0, il = i == ny - 1;
  float dx = DIV_TERM(j0, jl, ld(s[2], k), ld(s[2], k - 1));
  float dy = DIV_TERM(i0, il, ld(s[3], k), ld(s[3], k - nx));
  u1n = __fadd_rn(v1, __fmul_rn(a.theta, __fadd_rn(dx, dy)));
  dx = DIV_TERM(j0, jl, ld(s[4], k), ld(s[4], k - 1));
  dy = DIV_TERM(i0, il, ld(s[5], k), ld(s[5], k - nx));
  u2n = __fadd_rn(v2, __fmul_rn(a.theta, __fadd_rn(dx, dy)));
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
        dual(a.taut, right ? sub(su1[r][c + 1], c1) : 0.0f,
             below ? sub(su1[r + 1][c], c1) : 0.0f,
             right ? sub(su2[r][c + 1], c2) : 0.0f,
             below ? sub(su2[r + 1][c], c2) : 0.0f, p11, p12, p21, p22);
        dst.p[2][k] = p11;
        dst.p[3][k] = p12;
        dst.p[4][k] = p21;
        dst.p[5][k] = p22;
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

// ---------------------------------------------------------------------------
// The cluster body: a pair's state in its cluster's shared memory; what a
// block needs of another block's tiles is pushed to it (st.async) and waited
// for on its own mbarriers.

// A block takes up to 9 tiles: a pixel a thread for up to four (1024
// threads), two for five to eight (1024), three for nine (768, so that the
// registers of three pixels fit). A level of more than 144 tiles (16 blocks
// of 9) takes the cooperative body.
constexpr int MAX_PER = 9;
// a tile's halo in each state plane: a row (32) and a column (8); a plane
// holds MAX_PER tiles and their halos whatever the plan, so that every
// offset into the state is a constant of the code
constexpr int HALO_PX = TW + TH;
constexpr int PLANE = MAX_PER * (TILE + HALO_PX);
constexpr int STATE_BYTES = 6 * PLANE * 4;
constexpr int HEAD_SMEM = 64;  // four mbarriers and the error
// border flags of a pixel, found once a launch
constexpr unsigned J0 = 1, JL = 2, I0 = 4, IL = 8, RIGHT = 16, BELOW = 32;

struct ClusterArgs {
  const float* fixed[4];  // I1wx, I1wy, rho_c, grad
  const float* in[6];     // u1, u2, p11, p12, p21, p22
  float* out[6];
  float* stats;           // (P, 2): iterations run, last error
  int ny, nx, tiles_x, tiles, per, max_iters;
  float l_t, taut, theta, eps2, size;
};

// Shared memory of a block (see carve): the six state planes of PLANE
// floats each, plane f, tile slot s, pixel (r, c) at f * PLANE + s * TILE +
// r * TW + c, and the halo of slot s at f * PLANE + per * TILE + s *
// HALO_PX + h: h = c for the row above (planes p12, p22) or below (u1, u2)
// the tile, h = TW + r for the column left (p11, p21) or right (u1, u2) of
// it, where that neighbour tile belongs to another block; then the four
// mbarriers and the pair's error in HEAD_SMEM bytes, the partials of every
// tile of the cluster by iteration parity (2 * blocks * per doubles) and
// the block's row sums (per * TH doubles).

struct Smem {
  uint64_t* mbar;  // [0] u' halos, [1] p halos, [2 + parity] partials
  float* err;
  double* part;    // [parity * blocks * per + tile]
  double* rows;
  float* st;
};

__device__ __forceinline__ Smem carve(unsigned char* base, int per, int nb) {
  Smem m;
  m.st = reinterpret_cast<float*>(base);
  m.mbar = reinterpret_cast<uint64_t*>(base + STATE_BYTES);
  m.err = reinterpret_cast<float*>(base + STATE_BYTES + 32);
  m.part = reinterpret_cast<double*>(base + STATE_BYTES + HEAD_SMEM);
  m.rows = m.part + 2 * nb * per;
  return m;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The address in block `rank`'s shared memory of what lies at `addr` in
// this block's.
__device__ __forceinline__ uint32_t remote(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// Asynchronous stores into another block's shared memory; each signals its
// bytes to the mbarrier `mbar` of that block.
__device__ __forceinline__ void push(uint32_t addr, float v, uint32_t mbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(addr), "r"(__float_as_uint(v)), "r"(mbar)
      : "memory");
}

__device__ __forceinline__ void push(uint32_t addr, double v, uint32_t mbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, "
      "[%2];\n" ::"r"(addr), "l"(__double_as_longlong(v)), "r"(mbar)
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* mbar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(mbar)) : "memory");
}

// This block's one arrival on the phase under way, which then waits for
// `bytes` more bytes of pushed stores.
__device__ __forceinline__ void mbar_expect(uint64_t* mbar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(mbar)), "r"(bytes) : "memory");
}

// Until the phase of parity `parity` is complete; what the pushes wrote is
// visible after it. A phase still open after about nine seconds of the SM's
// clock means a push that never came: the launch fails, it does not hang.
__device__ __forceinline__ void mbar_wait(uint64_t* mbar, int parity) {
  const uint32_t addr = smem_addr(mbar);
  const long long start = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - start > (1LL << 34)) __trap();
  }
}

// The whole cluster's barrier, with release and acquire: once a launch,
// after the mbarriers are set up and before anyone pushes.
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// PX pixels a thread: slots group + x * groups of the block, x < PX, with
// groups = blockDim.x / TILE. The fixed fields of a thread's pixels stay in
// its registers for the whole launch, and so do where their neighbours lie
// and where their edge values go.
template <int PX>
__global__ void __launch_bounds__(PX < 3 ? 1024 : 768, 1)
tvl1_inner_cluster_k(const ClusterArgs a) {
  cg::cluster_group cl = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int PS = PLANE;
  const int per = a.per;
  const int nb = (int)cl.num_blocks(), me = (int)cl.block_rank();
  const bool multi = nb > 1;  // one block has no other to wait for
  const Smem m = carve(smem, per, nb);
  float* const st = m.st;
  const size_t base = (size_t)(blockIdx.x / nb) * a.ny * a.nx;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r = warp & (TH - 1), c = lane;
  const int groups = blockDim.x / TILE, t0 = me * per;
  const int tx_last = a.tiles_x - 1;
  const uint32_t mbar_a = smem_addr(m.mbar);
  // Where the halo entry h of the pair's tile tt lies in its owner's shared
  // memory (plane 0), and the owner.
  auto halo_in = [&](int tt, int h, int* rank) {
    *rank = tt / per;
    return remote(smem_addr(st + per * TILE + (tt - *rank * per) * HALO_PX +
                            h), *rank);
  };
  bool live[PX];
  unsigned fl[PX];
  int k[PX], hn[PX], vn[PX], hr[PX], vr[PX];
  uint32_t hs[PX], vs[PX];
  float fx[PX][4];
#pragma unroll
  for (int x = 0; x < PX; ++x) {
    const int slot = tid / TILE + x * groups, t = t0 + slot;
    const int ty = t / a.tiles_x, tx = t - ty * a.tiles_x;
    const int i = ty * TH + r, j = tx * TW + c;
    const bool here = slot < per && t < a.tiles;
    live[x] = here && i < a.ny && j < a.nx;
    fl[x] = (j == 0 ? J0 : 0) | (j == a.nx - 1 ? JL : 0) |
            (i == 0 ? I0 : 0) | (i == a.ny - 1 ? IL : 0) |
            (j < a.nx - 1 ? RIGHT : 0) | (i < a.ny - 1 ? BELOW : 0);
    // a slot past the level's last tile computes nothing and stores and
    // pushes nothing
    k[x] = here ? slot * TILE + r * TW + c : 0;
    const size_t g = base + (size_t)(live[x] ? i * a.nx + j : 0);
    // neighbours in another tile: to the left / right (lanes 0 / 31), above
    // / below (rows 0 / 7): in this block's st, or in the halo of this tile;
    // edge values another block needs: u' of row 0 / column 0 in phase (A),
    // p' of row 7 / column 31 in phase (B); 0 where none
    const int halo = per * TILE + slot * HALO_PX;
    hn[x] = vn[x] = k[x];
    hs[x] = vs[x] = 0;
    hr[x] = vr[x] = 0;
    if (here) {
      if (c == 0 && tx > 0) {
        hn[x] = slot > 0 ? k[x] - TILE + TW - 1 : halo + TW + r;
        if (slot == 0) hs[x] = halo_in(t - 1, TW + r, &hr[x]);
      }
      if (c == TW - 1 && tx < tx_last) {
        hn[x] = slot + 1 < per ? k[x] + TILE - (TW - 1) : halo + TW + r;
        if (slot + 1 >= per) hs[x] = halo_in(t + 1, TW + r, &hr[x]);
      }
      if (r == 0 && ty > 0) {
        vn[x] = slot >= a.tiles_x ? k[x] - a.tiles_x * TILE + (TH - 1) * TW
                                  : halo + c;
        if (slot < a.tiles_x) vs[x] = halo_in(t - a.tiles_x, c, &vr[x]);
      }
      if (r == TH - 1 && t + a.tiles_x < a.tiles) {
        vn[x] = slot + a.tiles_x < per
                    ? k[x] + a.tiles_x * TILE - (TH - 1) * TW
                    : halo + c;
        if (slot + a.tiles_x >= per) vs[x] = halo_in(t + a.tiles_x, c, &vr[x]);
      }
    }
#pragma unroll
    for (int f = 0; f < 4; ++f) fx[x][f] = live[x] ? __ldg(a.fixed[f] + g) : 0.f;
    if (here) {
#pragma unroll
      for (int f = 0; f < 6; ++f)
        st[f * PS + k[x]] = live[x] ? a.in[f][g] : 0.0f;
      // the p of a neighbour above / to the left in another block, as the
      // first iteration reads it
      if (live[x] && r == 0 && vn[x] == halo + c) {
        st[3 * PS + vn[x]] = a.in[3][g - a.nx];
        st[5 * PS + vn[x]] = a.in[5][g - a.nx];
      }
      if (live[x] && c == 0 && hn[x] == halo + TW + r) {
        st[2 * PS + hn[x]] = a.in[2][g - 1];
        st[4 * PS + hn[x]] = a.in[4][g - 1];
      }
    }
  }
  // bytes pushed to this block a phase: the u' halos (A), the p halos (B)
  // and the other blocks' partials
  int bytes_a = 0, bytes_b = 0, own = 0;
  for (int s2 = 0; s2 < per && t0 + s2 < a.tiles; ++s2) {
    const int t2 = t0 + s2, tx2 = t2 % a.tiles_x;
    ++own;
    if (t2 + a.tiles_x < a.tiles && s2 + a.tiles_x >= per) bytes_a += 8 * TW;
    if (tx2 < tx_last && s2 + 1 >= per) bytes_a += 8 * TH;
    if (t2 >= a.tiles_x && s2 < a.tiles_x) bytes_b += 8 * TW;
    if (tx2 > 0 && s2 == 0) bytes_b += 8 * TH;
  }
  const int bytes_p = 8 * (a.tiles - own);
  if (multi) {
    if (tid == 0) {
      for (int x = 0; x < 4; ++x) mbar_init(m.mbar + x);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    cluster_barrier();  // every block's state and mbarriers are in place
  } else {
    __syncthreads();
  }

  float err = __int_as_float(0x7f800000);  // +inf
  int n = 0;
  while (err > a.eps2 && n < a.max_iters) {
    const int par = n & 1;
    double* const part = m.part + par * nb * per;
    if (multi && tid == 0) {
      mbar_expect(m.mbar, bytes_a);
      mbar_expect(m.mbar + 1, bytes_b);
      mbar_expect(m.mbar + 2 + par, bytes_p);
    }
    // (A) u' over u, and the squared steps; every value read
    // unconditionally (the indices are valid), the border rules selected;
    // a lane outside the level pushes zeros
    double sq[PX];
#pragma unroll
    for (int x = 0; x < PX; ++x) {
      sq[x] = 0.0;
      float u1n = 0.0f, u2n = 0.0f;
      if (live[x]) {
        const int kk = k[x];
        const int lft = c ? kk - 1 : hn[x], up = r ? kk - TW : vn[x];
        const float u1 = st[kk], u2 = st[PS + kk];
        const float p11 = st[2 * PS + kk], p11l = st[2 * PS + lft];
        const float p12 = st[3 * PS + kk], p12u = st[3 * PS + up];
        const float p21 = st[4 * PS + kk], p21l = st[4 * PS + lft];
        const float p22 = st[5 * PS + kk], p22u = st[5 * PS + up];
        float v1, v2;
        threshold(a.l_t, fx[x][0], fx[x][1], fx[x][2], fx[x][3], u1, u2, v1,
                  v2);
        const bool j0 = fl[x] & J0, jl = fl[x] & JL;
        const bool i0 = fl[x] & I0, il = fl[x] & IL;
        u1n = __fadd_rn(
            v1, __fmul_rn(a.theta, __fadd_rn(div_term(j0, jl, p11, p11l),
                                             div_term(i0, il, p12, p12u))));
        u2n = __fadd_rn(
            v2, __fmul_rn(a.theta, __fadd_rn(div_term(j0, jl, p21, p21l),
                                             div_term(i0, il, p22, p22u))));
        const float e1 = sub(u1n, u1), e2 = sub(u2n, u2);
        sq[x] = (double)__fmul_rn(e1, e1) + (double)__fmul_rn(e2, e2);
        st[kk] = u1n;
        st[PS + kk] = u2n;
      }
      if (hs[x] && c == 0) {
        const uint32_t mb = remote(mbar_a, hr[x]);
        push(hs[x], u1n, mb);
        push(hs[x] + 4u * PS, u2n, mb);
      }
      if (vs[x] && r == 0) {
        const uint32_t mb = remote(mbar_a, vr[x]);
        push(vs[x], u1n, mb);
        push(vs[x] + 4u * PS, u2n, mb);
      }
    }
    // a tile's rows by the warp's shuffle tree
#pragma unroll
    for (int x = 0; x < PX; ++x) {
      const int slot = tid / TILE + x * groups;
      if (slot >= per) break;  // the same for the whole warp
      const double v = warp_sum(sq[x]);
      if (lane == 0) m.rows[slot * TH + r] = v;
    }
    __syncthreads();  // (A) done in this block: u' and the row sums
    // one waiter for the block: the barrier after it hands what it acquired
    // to every thread
    if (multi && tid == 0) mbar_wait(m.mbar, par);  // the u' halos
    __syncthreads();  // u' of this block and the u' halos; the row sums

    // a tile's partial, its eight rows in order, pushed to every other
    // block; the pair's error from every tile's partial in one fixed order:
    // a warp that overlaps them with (B)
    if (warp == 1) {
      if (lane < per && t0 + lane < a.tiles) {
        double s = m.rows[lane * TH];
#pragma unroll
        for (int x = 1; x < TH; ++x) s += m.rows[lane * TH + x];
        part[t0 + lane] = s;
        if (multi) {
          const uint32_t to = smem_addr(part + t0 + lane);
          const uint32_t mb = smem_addr(m.mbar + 2 + par);
          for (int b = 0; b < nb; ++b)
            if (b != me) push(remote(to, b), s, remote(mb, b));
        }
      }
      if (multi && lane == 0) mbar_wait(m.mbar + 2 + par, (n >> 1) & 1);
      __syncwarp();
      double s = 0.0;
      for (int t2 = lane; t2 < a.tiles; t2 += 32) s += part[t2];
      s = warp_sum(s);
      if (lane == 0) *m.err = __fdiv_rn((float)s, a.size);
    }
    // (B) p' over p
#pragma unroll
    for (int x = 0; x < PX; ++x) {
      float p11 = 0.0f, p12 = 0.0f, p21 = 0.0f, p22 = 0.0f;
      if (live[x]) {
        const int kk = k[x];
        const int rgt = c < TW - 1 ? kk + 1 : hn[x];
        const int dwn = r < TH - 1 ? kk + TW : vn[x];
        const bool right = fl[x] & RIGHT, below = fl[x] & BELOW;
        const float c1 = st[kk], c2 = st[PS + kk];
        const float u1x = sub(st[rgt], c1), u1y = sub(st[dwn], c1);
        const float u2x = sub(st[PS + rgt], c2), u2y = sub(st[PS + dwn], c2);
        p11 = st[2 * PS + kk];
        p12 = st[3 * PS + kk];
        p21 = st[4 * PS + kk];
        p22 = st[5 * PS + kk];
        dual(a.taut, right ? u1x : 0.0f, below ? u1y : 0.0f,
             right ? u2x : 0.0f, below ? u2y : 0.0f, p11, p12, p21, p22);
        st[2 * PS + kk] = p11;
        st[3 * PS + kk] = p12;
        st[4 * PS + kk] = p21;
        st[5 * PS + kk] = p22;
      }
      if (hs[x] && c == TW - 1) {
        const uint32_t mb = remote(mbar_a + 8u, hr[x]);
        push(hs[x] + 8u * PS, p11, mb);
        push(hs[x] + 16u * PS, p21, mb);
      }
      if (vs[x] && r == TH - 1) {
        const uint32_t mb = remote(mbar_a + 8u, vr[x]);
        push(vs[x] + 12u * PS, p12, mb);
        push(vs[x] + 20u * PS, p22, mb);
      }
    }
    if (multi && tid == 0) mbar_wait(m.mbar + 1, par);  // the p halos
    __syncthreads();  // p' of this block and the p halos; the error
    err = *m.err;
    ++n;
  }

  // every push into this block has been waited for, and no block reads
  // another's shared memory: a block may exit without a cluster barrier
#pragma unroll
  for (int x = 0; x < PX; ++x) {
    if (!live[x]) continue;
    const int t = t0 + tid / TILE + x * groups, ty = t / a.tiles_x;
    const size_t g = base + (size_t)(ty * TH + r) * a.nx +
                     (t - ty * a.tiles_x) * TW + c;
#pragma unroll
    for (int f = 0; f < 6; ++f) a.out[f][g] = st[f * PS + k[x]];
  }
  if (me == 0 && tid == 0) {
    const size_t q = blockIdx.x / nb;
    a.stats[2 * q] = (float)n;
    a.stats[2 * q + 1] = err;
  }
}

// `syncs` cluster barriers (release / acquire) and nothing else.
__global__ void __launch_bounds__(1024, 1) cluster_probe_k(int syncs) {
  for (int s = 0; s < syncs; ++s) cluster_barrier();
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

// The launch configuration of one cluster of `blocks` blocks of `threads`
// threads with `smem` bytes of dynamic shared memory each, `clusters` of
// them. attr must outlive the config.
cudaLaunchConfig_t cluster_config(int blocks, int threads, int smem,
                                  int clusters, void* stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(blocks * clusters));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)blocks;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Whether the current device takes a cluster of `kernel` of this shape: the
// function is allowed clusters of up to 16 blocks and 227 KB of dynamic
// shared memory, then cudaOccupancyMaxActiveClusters. 0 when it does, a
// cudaError_t when not.
template <typename K>
int ask_clusters(K kernel, int blocks, int threads, int smem) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess)  // all a block may take, whatever smem asks
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(blocks, threads, smem, 1, nullptr,
                                          &attr);
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (e != cudaSuccess) return (int)e;
  return clusters < 1 ? (int)cudaErrorInvalidClusterSize : 0;
}

// The kernel, threads and bytes of dynamic shared memory a block of the
// cluster body takes for a plan (blocks, per).
struct ClusterShape {
  void (*kern)(ClusterArgs);
  int threads, smem;
};

ClusterShape cluster_shape(int blocks, int per) {
  const int px = (per + 3) / 4;  // pixels a thread
  // the state planes, the mbarriers, the partials, the row sums
  return {px == 1   ? &tvl1_inner_cluster_k<1>
          : px == 2 ? &tvl1_inner_cluster_k<2>
                    : &tvl1_inner_cluster_k<3>,
          TILE * ((per + px - 1) / px),
          STATE_BYTES + HEAD_SMEM + 16 * blocks * per + 8 * TH * per};
}

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

// The cluster body: arrays as for f2f_tvl1_inner (no tmp, no partial), one
// cluster of `blocks` blocks a pair, block b owning the tiles [b * per,
// (b + 1) * per); blocks * per covers the tiles, (blocks - 1) * per does
// not; 1 <= blocks <= 16, per <= 9. f2f_tvl1_cluster_check must have
// passed for (blocks, per) on the current device; nothing falls back.
int f2f_tvl1_cluster(const float* const* fixed, const float* const* in,
                     float* const* out, float* stats, int P, int ny, int nx,
                     int blocks, int per, float l_t, float taut, float theta,
                     float eps2, int max_iters, void* stream) {
  const int tiles_x = (nx + TW - 1) / TW;
  const long long tiles = (long long)tiles_x * ((ny + TH - 1) / TH);
  if (P < 1 || ny < 1 || nx < 1 || blocks < 1 || blocks > MAX_CLUSTER ||
      per < 1 || per > MAX_PER ||
      (long long)blocks * per < tiles ||
      (long long)(blocks - 1) * per >= tiles ||
      (long long)P * blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const ClusterShape sh = cluster_shape(blocks, per);
  ClusterArgs a;
  for (int x = 0; x < 4; ++x) a.fixed[x] = fixed[x];
  for (int x = 0; x < 6; ++x) {
    a.in[x] = in[x];
    a.out[x] = out[x];
  }
  a.stats = stats;
  a.ny = ny;
  a.nx = nx;
  a.tiles_x = tiles_x;
  a.tiles = (int)tiles;
  a.per = per;
  a.max_iters = max_iters;
  a.l_t = l_t;
  a.taut = taut;
  a.theta = theta;
  a.eps2 = eps2;
  a.size = (float)((double)ny * (double)nx);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(blocks, sh.threads, sh.smem, P, stream, &attr);
  cudaError_t e = cudaLaunchKernelEx(&cfg, sh.kern, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Whether the current device takes a cluster of the cluster body for a plan
// (blocks, per): 0 when it does, else the error that refuses it. Allows the
// function its cluster size and shared memory, so it is asked before the
// first launch of a plan on a device (flow/tvl1_inner.py caches the answer).
int f2f_tvl1_cluster_check(int blocks, int per) {
  if (blocks < 1 || blocks > MAX_CLUSTER || per < 1 || per > MAX_PER)
    return (int)cudaErrorInvalidValue;
  const ClusterShape sh = cluster_shape(blocks, per);
  return ask_clusters(sh.kern, blocks, sh.threads, sh.smem);
}

// As f2f_tvl1_cluster_check, for f2f_tvl1_cluster_probe's cluster.
int f2f_tvl1_cluster_probe_check(int blocks, int threads) {
  if (blocks < 1 || blocks > MAX_CLUSTER || threads < 32 || threads > 1024)
    return (int)cudaErrorInvalidValue;
  return ask_clusters(cluster_probe_k, blocks, threads, 0);
}

// `syncs` cluster barriers on one cluster of `blocks` blocks of `threads`
// threads.
int f2f_tvl1_cluster_probe(int blocks, int threads, int syncs, void* stream) {
  if (blocks < 1 || blocks > MAX_CLUSTER || threads < 32 ||
      threads > 1024)
    return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(blocks, threads, 0, 1, stream, &attr);
  cudaError_t e = cudaLaunchKernelEx(&cfg, cluster_probe_k, syncs);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* f2f_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
