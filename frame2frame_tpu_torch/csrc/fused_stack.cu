// Hopper (sm_90a) forward kernels of the DnCNN 64->64 mid layers.
//
// Three entry points share the 3x3 SAME convolution body of conv3x3_c64.cuh
// (design, shared-memory layout and MMA path are described there):
//
//   f2f_fwd_layer        z = conv3x3(relu(s * z_prev + b))      prologue affine
//     replaces frame2frame_tpu/ops/fused_stack.py: fwd_layer (_fwd_kernel),
//     eval route emit_stats=False, with or without stack=.
//   f2f_fwd_layer_train  the same z, and per channel sum(z), sum(z^2)
//     replaces fwd_layer (_fwd_kernel) with emit_stats=True, the training
//     forward. The TPU kernel adds each tile's sums into one block that a
//     sequential grid revisits; here every persistent block writes one row of
//     partial sums and a finishing kernel adds the rows in order, so the
//     batch statistics are the same bits on every run. The sums are taken
//     from the f32 accumulator, before z is rounded to the chain's type.
//   f2f_fwd_layer_eval   a = relu(s * conv3x3(a_prev, w) + b)    epilogue affine
//     replaces frame2frame_tpu/ops/fused_stack.py: fwd_layer_eval
//     (_fwd_eval_kernel). The TPU kernel folds the BN scale s into its
//     weights. Rounding w * s to bf16 moved served DnCNN-17 pixels by up to
//     0.045 against the f32 forward (540p, H100, chip_smoke.py), so here s
//     scales the f32 accumulator in the epilogue instead, at one FMA an
//     output.
//
// Bound at 540p (1 x 540 x 960 x 64, bf16 storage), per layer and frame:
//   operations 2 * 540*960 * 64*64*9 = 38.2 GFLOP -> 39 us at 989 TFLOP/s;
//   bytes      2 * 540*960*64 * 2    = 132.7 MB  -> 40 us at 3.35 TB/s.
// The layer sits near balance, so the design keeps both sides simple and
// whole: every input byte is read once per tile plus a one-pixel halo, every
// output byte written once, and the 73.7 KB of bf16 weights are loaded into
// shared memory once per persistent block rather than once per tile. The
// training form adds 32 f32 additions a thread and tile and one row of 128
// partial sums a block, which change neither side of the bound.

#include "conv3x3_c64.cuh"

namespace {

using namespace f2f;

template <typename T, int PRO, int EPI>
int forward(const void* in, const void* w, const float* s, const float* b,
            void* out, float* partial, float* stats, int max_blocks, int B,
            int H, int W, void* stream) {
  ConvArgs<T> a = {};
  a.in = static_cast<const T*>(in);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.s = s;
  a.b = b;
  a.out = static_cast<T*>(out);
  a.partial = partial;
  a.B = B;
  a.H = H;
  a.W = W;
  int grid = 0;
  int rc = launch_conv<T, PRO, EPI>(a, max_blocks, &grid, stream);
  if (rc != 0 || EPI != EPI_STATS) return rc;
  return finish(partial, grid, 2 * C, stats, stream);
}

}  // namespace

extern "C" {

// Each returns a cudaError_t code: 0 on launches that were accepted.
int f2f_fwd_layer(const void* z_prev, int is_f32, const void* w,
                  const float* s, const float* b, void* z, int B, int H, int W,
                  void* stream) {
  return is_f32 ? forward<float, PRO_AFFINE, EPI_NONE>(
                      z_prev, w, s, b, z, nullptr, nullptr, 0, B, H, W, stream)
                : forward<__nv_bfloat16, PRO_AFFINE, EPI_NONE>(
                      z_prev, w, s, b, z, nullptr, nullptr, 0, B, H, W, stream);
}

// stats: (2, 64) f32 out; partial: (max_blocks, 2, 64) f32 scratch.
int f2f_fwd_layer_train(const void* z_prev, int is_f32, const void* w,
                        const float* s, const float* b, void* z, float* stats,
                        float* partial, int max_blocks, int B, int H, int W,
                        void* stream) {
  if (max_blocks <= 0) return (int)cudaErrorInvalidValue;
  return is_f32
             ? forward<float, PRO_AFFINE, EPI_STATS>(z_prev, w, s, b, z,
                                                     partial, stats, max_blocks,
                                                     B, H, W, stream)
             : forward<__nv_bfloat16, PRO_AFFINE, EPI_STATS>(
                   z_prev, w, s, b, z, partial, stats, max_blocks, B, H, W,
                   stream);
}

int f2f_fwd_layer_eval(const void* a_prev, int is_f32, const void* w,
                       const float* s, const float* b, void* a, int B, int H,
                       int W, void* stream) {
  return is_f32 ? forward<float, PRO_NONE, EPI_AFFINE>(
                      a_prev, w, s, b, a, nullptr, nullptr, 0, B, H, W, stream)
                : forward<__nv_bfloat16, PRO_NONE, EPI_AFFINE>(
                      a_prev, w, s, b, a, nullptr, nullptr, 0, B, H, W, stream);
}

const char* f2f_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
