"""The DnCNN 64->64 mid layers: four CUDA kernels for Hopper
(``csrc/fused_stack.cu``, ``csrc/fused_stack_bwd.cu``), their plain PyTorch
versions, and the differentiable training-mode mid stack built on them.

Counterparts of ``frame2frame_tpu/ops/fused_stack.py``:

- ``fwd_layer`` <- ``fwd_layer`` with ``emit_stats=False`` (the eval "affine"
  route): ``z = conv3x3_SAME(relu(s * z_prev + b))``, chained on raw conv
  outputs.
- ``fwd_layer_train`` <- ``fwd_layer`` with ``emit_stats=True`` (the training
  forward): the same ``z`` and the BN batch sums ``(sum z, sum z^2)`` per
  channel, taken from the f32 accumulator before ``z`` is rounded.
- ``fwd_layer_eval`` <- ``fwd_layer_eval`` (the eval "act" route):
  ``a = relu(s * conv3x3_SAME(a_prev, w) + b)``, chained post-activation.
  The TPU kernel folds the BN scale into its weights; the port applies it
  to the f32 accumulator, since rounding ``w * s`` to bf16 loses accuracy
  (``csrc/fused_stack.cu``).
- ``bwd_layer`` <- ``bwd_layer``: one layer's backward through ReLU,
  training-mode BN and the conv: ``da_prev`` (dX), ``dW`` in f32, and the
  previous layer's BN-backward sums.
- ``fused_mid_stack`` <- ``fused_mid_stack`` (``_fused_fwd`` / ``_fused_bwd``):
  (conv3x3 + BatchNorm(train) + ReLU)^L as a ``torch.autograd.Function``.
  Its layer loops, ``mid_forward`` and ``mid_backward``, are also what the
  whole-iteration step (``train/flat_step.py``) runs between the end kernels
  of ``ops/fused_ends.py``.

``KERNELS`` is the launch registry of all of the port's kernels, the end
kernels, the flow's inner loop (``flow/tvl1_inner.py``) and the ``conv_impl``
routes' convolution and weight gradient (``ops/conv3x3.py``,
``ops/conv_dw.py``) included (``launch_counts``, ``reset_launch_counts``).

Activations are NHWC ``(B, H, W, 64)``, contiguous, bf16 or f32. The TPU
pair-packed flat layout is not carried over: a batch is the batch
dimension, and SAME padding per image isolates its frames. Zero padding
applies to the activation after the affine and ReLU, as the TPU kernel masks
the activation at pad positions; padding ``z_prev`` first would leak
``relu(b)`` into the border.

The TPU forward can also store each layer's operand for the backward
(``emit_act``). The port does not: ``bwd_layer`` rebuilds
``a_prev = relu(s_prev * z_prev + b_prev)`` from ``z_prev``, which it reads
anyway for the BN-backward sums, so a stored operand would add one tensor
written and one read per layer (1 GB a step at 540p) and save only an FMA and
a max per element in a kernel that waits on memory.

Every affine whose sign decides a ReLU mask is a rounded product plus a
rounded sum (``z * s + b`` in PyTorch, ``affine()`` in the kernels), so the
forward and the backward agree on every pixel, on either device.

The four layer functions take ``valid_bounds``, the row-validity window of
the TPU kernels, for a slab of a frame split by rows
(``ops/fused_spatial.py``): ``(lo, hi, slo, shi)``. The operand
(``relu(s * z_prev + b)``, the act route's input, the backward's dz) is zero
at rows outside ``[lo, hi)``, as at the image's border; a_prev of dW and
every sum over the pixels count rows ``[slo, shi)`` only, the slab's body
rows among them, so that adding the slabs' sums counts each row of the frame
once (``(lo, hi)`` alone sums the same rows as it reads). Outputs are
written at every row. Without a window a layer computes what it computed
before, with the same bits, as it does with the window ``(0, H)``.

A wrapper given a CPU tensor computes the plain version; given a CUDA tensor
it launches the kernel or raises. Each wrapper counts its launches in
``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import load
from ._common import (
    C,
    _bind_error_string,
    _conv_f32,
    _on_current_cuda,
    _partial_rows,
    _raise_on,
    _round_operand,
    conv2d_weight,
)
from ..flow.tvl1_inner import tvl1_inner_loop
from ..utils.profiling import count
from .fused_ends import first_conv, first_dw, last_loss_bwd, last_loss_fwd
from .conv3x3 import conv3x3_fwd
from .conv_dw import dw_conv3x3

EPS = 1e-5


def _affine_from_stats(mean, var, gamma, beta):
    """Eval BatchNorm as a per-channel affine: (scale, shift, rstd)."""
    rstd = torch.rsqrt(var + EPS)
    s = gamma * rstd
    return s, beta - mean * s, rstd


def rows_of(x, valid_bounds):
    """``valid_bounds`` on ``x`` (B, H, W, 64) clipped to its rows: (lo, hi,
    slo, shi), the operand's rows and the summed rows; None without a
    window."""
    if valid_bounds is None:
        return None
    H = x.shape[1]
    vb = tuple(int(v) for v in valid_bounds)
    lo, hi, slo, shi = vb if len(vb) == 4 else vb + vb
    lo, hi = max(lo, 0), min(hi, H)
    if lo >= hi:
        raise ValueError(f"valid_bounds {tuple(valid_bounds)}: no row of "
                         f"the {H} rows")
    return lo, hi, max(slo, 0), min(shi, H)


def _zero_outside(x, lo, hi):
    """x with its rows outside [lo, hi) set to zero."""
    rows = torch.arange(x.shape[1], device=x.device).view(1, -1, 1, 1)
    return torch.where((rows >= lo) & (rows < hi), x, torch.zeros_like(x))


def _operand(x, rows):
    return x if rows is None else _zero_outside(x, rows[0], rows[1])


def _summed(x, rows):
    """The rows of x that a sum over the pixels counts."""
    return x if rows is None else x[:, rows[2]:rows[3]]


def fwd_layer_plain(z_prev, w, s, b, valid_bounds=None):
    """Plain version of ``fwd_layer``: f32 arithmetic, storage dtype out."""
    a = torch.relu(z_prev.float() * s.float() + b.float())
    a = _operand(a, rows_of(z_prev, valid_bounds))
    return _conv_f32(a, w).to(z_prev.dtype).contiguous()


def fwd_layer_eval_plain(a_prev, w, s, b, valid_bounds=None):
    """Plain version of ``fwd_layer_eval``: f32 arithmetic, input dtype out."""
    a = _operand(a_prev.float(), rows_of(a_prev, valid_bounds))
    out = torch.relu(_conv_f32(a, w) * s.float() + b.float())
    return out.to(a_prev.dtype).contiguous()


def kernel_weights(w):
    """HWIO weights in the form the kernels take on ``w``'s device:
    contiguous bf16 on CUDA (the MMA operand type), unchanged on the CPU,
    where the plain versions compute in f32. Idempotent, so a caller may
    convert a stack of layers once and pass slices."""
    if w.device.type == "cpu":
        return w
    return w.to(torch.bfloat16).contiguous()


def _checked(name, x, w, s, b):
    """Validate one layer's inputs; returns contiguous (s, b)."""
    if x.dim() != 4 or x.shape[-1] != C:
        raise ValueError(f"{name}: expected (B, H, W, {C}), got {tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: bf16 or f32 storage, got {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name}: needs a contiguous 16-byte aligned tensor")
    if w.shape != (3, 3, C, C) or w.device != x.device:
        raise ValueError(f"{name}: w must be (3, 3, {C}, {C}) HWIO on {x.device}")
    for v in (s, b):
        if v.shape != (C,) or v.dtype != torch.float32 or v.device != x.device:
            raise ValueError(f"{name}: s and b must be ({C},) f32 on {x.device}")
    return s.contiguous(), b.contiguous()


@functools.cache
def _lib():
    lib = load("fused_stack")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name in ("f2f_fwd_layer_window", "f2f_fwd_layer_eval_window"):
        fn = getattr(lib, name)
        fn.restype = ci
        fn.argtypes = [vp, ci, vp, vp, vp, vp] + [ci] * 5 + [vp]
    lib.f2f_fwd_layer_train_window.restype = ci
    lib.f2f_fwd_layer_train_window.argtypes = ([vp, ci] + [vp] * 6 + [ci] * 8
                                               + [vp])
    _bind_error_string(lib)
    return lib


def _full_rows(x, rows):
    """``rows_of``'s window, or the whole image's: (0, H, 0, H)."""
    return rows or (0, x.shape[1], 0, x.shape[1])


def _launch(name, x, w, s, b, rows):
    """Run kernel ``f2f_<name>_window`` with ``rows`` (``_full_rows``) on
    CUDA tensors on the current device and return its output, in x's dtype.
    Raises if the launch is refused."""
    _on_current_cuda(name, x)
    lib = _lib()
    wk = kernel_weights(w)
    out = torch.empty_like(x)
    B, H, W, _ = x.shape
    args = (x.data_ptr(), int(x.dtype == torch.float32), wk.data_ptr(),
            s.data_ptr(), b.data_ptr(), out.data_ptr(), B, H, W)
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(lib, f"f2f_{name}_window")(*args, *rows[:2], stream)
    _raise_on(lib, name, rc)
    return out


def fwd_layer(z_prev, w, s, b, valid_bounds=None):
    """One eval mid layer on the affine route.

    z_prev: (B, H, W, 64) bf16 or f32, the previous layer's raw conv output
    (or the first activation with s = 1, b = 0); w: (3, 3, 64, 64) HWIO;
    s, b: (64,) f32, the previous layer's eval BN affine; valid_bounds: a
    slab's row window (module docstring). Returns the raw conv output z in
    z_prev's dtype (f32 accumulation)."""
    s, b = _checked("fwd_layer", z_prev, w, s, b)
    if z_prev.device.type == "cpu":
        return fwd_layer_plain(z_prev, w, s, b, valid_bounds)
    out = _launch("fwd_layer", z_prev, w, s, b,
                  _full_rows(z_prev, rows_of(z_prev, valid_bounds)))
    fwd_layer.launches += 1
    return out


def fwd_layer_eval(a_prev, w, s, b, valid_bounds=None):
    """One eval mid layer on the act route.

    a_prev: (B, H, W, 64) bf16 or f32, post-activation; w: (3, 3, 64, 64)
    HWIO; s, b: (64,) f32, this layer's eval BN affine; valid_bounds: a
    slab's row window. Returns relu(s * conv + b) in a_prev's dtype (f32
    accumulation)."""
    s, b = _checked("fwd_layer_eval", a_prev, w, s, b)
    if a_prev.device.type == "cpu":
        return fwd_layer_eval_plain(a_prev, w, s, b, valid_bounds)
    out = _launch("fwd_layer_eval", a_prev, w, s, b,
                  _full_rows(a_prev, rows_of(a_prev, valid_bounds)))
    fwd_layer_eval.launches += 1
    return out


def fwd_layer_train_plain(z_prev, w, s, b, mma_bf16=False, valid_bounds=None):
    """Plain version of ``fwd_layer_train``: (z, stats (2, 64) f32).

    f32 arithmetic with the rounding points of the TPU kernel run in
    interpret mode: the weights in the chain's dtype, z stored in the
    chain's dtype, the sums from the unrounded accumulator. ``mma_bf16``
    also rounds both dot operands to bf16, as the CUDA kernel's matrix unit
    takes them on either chain."""
    dt = z_prev.dtype
    rows = rows_of(z_prev, valid_bounds)
    a = _operand(torch.relu(z_prev.float() * s.float() + b.float()), rows)
    acc = _conv_f32(_round_operand(a, mma_bf16),
                    _round_operand(w.to(dt), mma_bf16))
    summed = _summed(acc, rows)
    stats = torch.stack([summed.sum((0, 1, 2)),
                         (summed * summed).sum((0, 1, 2))])
    return acc.to(dt).contiguous(), stats


# rows of ``vecs`` (8, 64) f32, as frame2frame_tpu's ``_bwd_kernel`` takes
# them: the affine whose sign is layer i's ReLU mask (A = gamma_i * rstd_i,
# b_i), dz's other two coefficients, the previous layer's affine, and its
# normalisation (rstd_prev, -mean_prev * rstd_prev)
V_A, V_BI, V_B, V_C, V_SP, V_BP, V_RSTDP, V_NMRP = range(8)


def bwd_layer_plain(g, z_i, z_prev, w, vecs, first_layer=False,
                    mma_bf16=False, valid_bounds=None):
    """Plain version of ``bwd_layer``: (da_prev, dW f32 HWIO, stats_prev).
    Rounding points and ``mma_bf16`` as in ``fwd_layer_train_plain``; with
    ``mma_bf16`` the operands dz, a_prev and w are rounded to bf16."""
    dt = g.dtype
    rows = rows_of(g, valid_bounds)
    v = vecs.float()
    zi, zp = z_i.float(), z_prev.float()
    gt = g.float() * (zi * v[V_A] + v[V_BI] > 0)
    dz = _round_operand(_operand(v[V_A] * gt + v[V_B] * zi + v[V_C], rows),
                        mma_bf16)
    wr = _round_operand(w.to(dt), mma_bf16)
    da = _conv_f32(dz, wr.flip(0, 1).transpose(2, 3))
    yp = zp * v[V_SP] + v[V_BP]
    a_prev = _round_operand(torch.relu(yp), mma_bf16)
    if rows is not None:
        a_prev = _zero_outside(a_prev, rows[2], rows[3])
    dw = conv2d_weight(
        a_prev.permute(0, 3, 1, 2), (C, C, 3, 3),
        dz.permute(0, 3, 1, 2)).permute(2, 3, 1, 0).contiguous()
    if first_layer:
        stats = torch.zeros(2, C, dtype=torch.float32, device=g.device)
    else:
        gp = _summed(da * (yp > 0), rows)
        zhat = _summed(zp * v[V_RSTDP] + v[V_NMRP], rows)
        stats = torch.stack([gp.sum((0, 1, 2)), (gp * zhat).sum((0, 1, 2))])
    return da.to(dt).contiguous(), dw, stats


# the program recorder's counter of ``bwd_layer``'s launches, named after
# the body they run: both chains run the wgmma body of
# ``csrc/fused_stack_bwd.cu`` (the f32 chain rounds its MMA operands to bf16
# in the prologue)
BWD_BODY_COUNTER = "kernel.bwd_layer.wgmma"


@functools.cache
def _lib_bwd():
    lib = load("fused_stack_bwd")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.f2f_bwd_layer_window.restype = ci
    lib.f2f_bwd_layer_window.argtypes = ([vp, vp, vp, ci, vp, vp, ci]
                                         + [vp] * 3 + [ci] * 8 + [vp])
    _bind_error_string(lib)
    return lib


def fwd_layer_train(z_prev, w, s, b, valid_bounds=None):
    """One training mid layer: ``fwd_layer`` and the BN batch sums.

    Returns (z in z_prev's dtype, stats (2, 64) f32 = per-channel sum z and
    sum z^2 over all B*H*W pixels, over rows [slo, shi) with
    ``valid_bounds``, from the f32 accumulator). The sums are reduced in a
    fixed order: the same inputs give the same bits."""
    s, b = _checked("fwd_layer_train", z_prev, w, s, b)
    rows = _full_rows(z_prev, rows_of(z_prev, valid_bounds))
    if z_prev.device.type == "cpu":
        return fwd_layer_train_plain(z_prev, w, s, b,
                                     valid_bounds=valid_bounds)
    _on_current_cuda("fwd_layer_train", z_prev)
    lib = _lib()
    wk = kernel_weights(w)
    n_partial = _partial_rows(z_prev.device.index)
    z = torch.empty_like(z_prev)
    stats = torch.empty(2, C, dtype=torch.float32, device=z_prev.device)
    partial = torch.empty(n_partial, 2, C, dtype=torch.float32,
                          device=z_prev.device)
    args = (z_prev.data_ptr(), int(z_prev.dtype == torch.float32),
            wk.data_ptr(), s.data_ptr(), b.data_ptr(), z.data_ptr(),
            stats.data_ptr(), partial.data_ptr(), n_partial, *z_prev.shape[:3])
    stream = torch.cuda.current_stream().cuda_stream
    rc = lib.f2f_fwd_layer_train_window(*args, *rows, stream)
    _raise_on(lib, "fwd_layer_train", rc)
    fwd_layer_train.launches += 1
    return z, stats


def bwd_layer(g, z_i, z_prev, w, vecs, first_layer=False, valid_bounds=None):
    """One training mid layer's backward.

    g: cotangent of the layer's activation a_i, (B, H, W, 64) bf16 or f32;
    z_i, z_prev: stored conv outputs of this layer and the one before (the
    stack input when ``first_layer``), same shape and dtype; w: (3, 3, 64,
    64) HWIO; vecs: (8, 64) f32, rows ``V_A`` .. ``V_NMRP``; valid_bounds:
    a slab's row window (module docstring).

    Returns (da_prev in g's dtype, dW (3, 3, 64, 64) f32, stats_prev (2, 64)
    f32 = sum gp and sum gp * zhat_prev with gp = da_prev * [a_prev > 0],
    zeros when ``first_layer``). One call counts as one launch: one kernel
    computes all three, and one finishing sum adds its blocks' partial sums
    of stats_prev and dW. A launch also adds one to ``BWD_BODY_COUNTER`` in
    the program's recorder, which records while a profiler runs."""
    name = "bwd_layer"
    _checked(name, g, w, vecs[0], vecs[1])
    for x in (z_i, z_prev):
        if (x.shape != g.shape or x.dtype != g.dtype or x.device != g.device
                or not x.is_contiguous() or x.data_ptr() % 16):
            raise ValueError(f"{name}: z_i and z_prev must match g's shape, "
                             "dtype, device and layout")
    if (vecs.shape != (8, C) or vecs.dtype != torch.float32
            or vecs.device != g.device):
        raise ValueError(f"{name}: vecs must be (8, {C}) f32 on {g.device}")
    vecs = vecs.contiguous()
    rows = _full_rows(g, rows_of(g, valid_bounds))
    if g.device.type == "cpu":
        return bwd_layer_plain(g, z_i, z_prev, w, vecs, first_layer,
                               valid_bounds=valid_bounds)
    _on_current_cuda(name, g)
    lib = _lib_bwd()
    wk = kernel_weights(w)
    dev = g.device
    n_partial = _partial_rows(dev.index)
    da = torch.empty_like(g)
    # stats_prev (2, 64) and dW (3, 3, 64, 64) side by side, as the kernel's
    # partial rows hold them
    out = torch.empty(2 * C + 9 * C * C, dtype=torch.float32, device=dev)
    partial = torch.empty(n_partial, out.numel(), dtype=torch.float32,
                          device=dev)
    args = (g.data_ptr(), z_i.data_ptr(), z_prev.data_ptr(),
            int(g.dtype == torch.float32), wk.data_ptr(), vecs.data_ptr(),
            int(bool(first_layer)), da.data_ptr(), out.data_ptr(),
            partial.data_ptr(), n_partial, *g.shape[:3])
    stream = torch.cuda.current_stream().cuda_stream
    rc = lib.f2f_bwd_layer_window(*args, *rows, stream)
    _raise_on(lib, name, rc)
    bwd_layer.launches += 1
    count(BWD_BODY_COUNTER)
    return da, out[2 * C:].view(3, 3, C, C), out[:2 * C].view(2, C)


KERNELS = (fwd_layer, fwd_layer_train, fwd_layer_eval, bwd_layer,
           first_conv, last_loss_fwd, last_loss_bwd, first_dw,
           tvl1_inner_loop, conv3x3_fwd, dw_conv3x3)


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0


reset_launch_counts()


def launch_counts():
    return {k.__name__: k.launches for k in KERNELS}


# ---------------------------------------------------------------------------
# the differentiable mid stack
#
# Between two layer calls stand only a few (64,)-sized ops, each a launch
# that costs the host more than the device: whatever does not depend on the
# neighbouring layer's result is computed for all layers at once.


def mid_forward(fwd, wk, gammas, betas, z_in, count):
    """The forward of (conv3x3 + BatchNorm(train) + ReLU)^L up to the last
    conv: ``fwd`` (``fwd_layer_train`` or its plain version) layer by layer.

    wk: ``kernel_weights`` of (L, 3, 3, 64, 64); z_in: (B, H, W, 64) in the
    chain's dtype, the stack input before its ReLU (or after: the first
    prologue is the identity affine and a ReLU), or whatever ``fwd`` takes
    (``ops/fused_spatial.py`` hands it a frame's slabs); count: B * H * W.
    Returns (zs, the L raw conv outputs; ss, bs (L + 1, 64), the prologue
    affines, row i + 1 layer i's BatchNorm; means, vars (L, 64)), all but
    zs on wk's device."""
    s = torch.ones(C, dtype=torch.float32, device=wk.device)
    b = torch.zeros_like(s)
    cur = z_in
    zs, ss, bs, moments = [], [s], [b], []
    for i in range(wk.shape[0]):
        cur, stats = fwd(cur, wk[i], s, b)
        mom = stats / count  # (E[z], E[z^2])
        var = torch.addcmul(mom[1], mom[0], mom[0], value=-1.0)
        s = gammas[i] * torch.rsqrt(var + EPS)
        b = torch.addcmul(betas[i], mom[0], s, value=-1.0)
        zs.append(cur)
        ss.append(s)
        bs.append(b)
        moments.append(mom)
    moments = torch.stack(moments)
    means = moments[:, 0].contiguous()
    vars_ = torch.addcmul(moments[:, 1], means, means, value=-1.0)
    return zs, torch.stack(ss), torch.stack(bs), means, vars_


def bn_norm(means, vars_):
    """(rstd, -mean * rstd) of the batch statistics."""
    rstd = torch.rsqrt(vars_ + EPS)
    return rstd, -means * rstd


def mid_backward(bwd, wk, zs, z_in, ss, bs, means, rstd, nmr, count, g,
                 dbeta, dgamma):
    """The backward of ``mid_forward``: ``bwd`` (``bwd_layer`` or its plain
    version) from the last layer down.

    g: cotangent of the last activation relu(ss[L] * zs[-1] + bs[L]), in the
    chain's dtype; dbeta, dgamma: (64,) the last BatchNorm's backward sums
    sum gt and sum gt * zhat_L with gt = g * [activation > 0]; rstd, nmr:
    ``bn_norm`` of the batch statistics. Returns (dW (L, 3, 3, 64, 64),
    dgammas, dbetas (L, 64), the cotangent of relu(z_in))."""
    L = len(zs)
    # dz_i = A_i gt + B_i z_i + C_i with A_i = gamma_i rstd_i = ss[i + 1],
    # B_i = k1_i dgamma_i, C_i = k2_i dgamma_i + k3_i dbeta_i: all but
    # the two sums, which the layer above delivers, is known beforehand
    k3 = ss[1:] / -count
    k1 = k3 * rstd
    k2 = -k1 * means
    zero = torch.zeros_like(ss[1:])
    vecs = torch.stack([
        ss[1:], bs[1:], zero, zero, ss[:-1], bs[:-1],
        torch.cat([ss[:1], rstd[:-1]]), torch.cat([bs[:1], nmr[:-1]])], 1)
    dws, dgammas, dbetas = [None] * L, [None] * L, [None] * L
    for i in range(L - 1, -1, -1):
        torch.mul(k1[i], dgamma, out=vecs[i, V_B])
        torch.mul(k2[i], dgamma, out=vecs[i, V_C])
        vecs[i, V_C].addcmul_(k3[i], dbeta)
        g, dws[i], stats = bwd(g, zs[i], zs[i - 1] if i > 0 else z_in,
                               wk[i], vecs[i], i == 0)
        dgammas[i], dbetas[i] = dgamma, dbeta
        dbeta, dgamma = stats[0], stats[1]
    return torch.stack(dws), torch.stack(dgammas), torch.stack(dbetas), g


class _FusedMidStack(torch.autograd.Function):
    """(conv3x3 + BatchNorm(train) + ReLU)^L over ``fwd`` and ``bwd``, the
    layer functions (the kernel wrappers, or their plain versions)."""

    @staticmethod
    def forward(ctx, ws, gammas, betas, a1, store_dtype, fwd, bwd):
        B, H, W, _ = a1.shape
        count = B * H * W
        wk = kernel_weights(ws)
        a_in = a1.to(store_dtype).contiguous()
        zs, ss, bs, means, vars_ = mid_forward(fwd, wk, gammas, betas, a_in,
                                               count)
        # the last BN affine + ReLU in f32, outside the kernels
        a_out = torch.relu(zs[-1].float() * ss[-1] + bs[-1])
        ctx.save_for_backward(wk, a_in, means, vars_, ss, bs, *zs)
        ctx.store_dtype, ctx.bwd, ctx.count = store_dtype, bwd, count
        ctx.a1_dtype = a1.dtype
        ctx.mark_non_differentiable(means, vars_)
        return a_out, means, vars_

    @staticmethod
    def backward(ctx, da_out, _dm, _dv):
        wk, a_in, means, vars_, ss, bs, *zs = ctx.saved_tensors
        rstd, nmr = bn_norm(means, vars_)
        # cotangent of z_L through the last BN affine + ReLU, in plain ops;
        # the mask is the forward's expression on the stored z_L
        g = da_out.to(ctx.store_dtype).contiguous()
        zl = zs[-1].float()
        gt = g.float() * (zl * ss[-1] + bs[-1] > 0)
        dbeta = gt.sum((0, 1, 2))
        dgamma = (gt * (zl * rstd[-1] + nmr[-1])).sum((0, 1, 2))
        del zl, gt
        dws, dgammas, dbetas, g = mid_backward(
            ctx.bwd, wk, zs, a_in, ss, bs, means, rstd, nmr, ctx.count, g,
            dbeta, dgamma)
        return (dws, dgammas, dbetas, g.to(ctx.a1_dtype), None, None, None)


def fused_mid_stack(ws, gammas, betas, a1, store_dtype=torch.bfloat16):
    """(conv3x3 + BatchNorm(train) + ReLU)^L on the mid-layer kernels.

    ws: (L, 3, 3, 64, 64) HWIO f32; gammas, betas: (L, 64) f32; a1: (B, H,
    W, 64) post-ReLU stack input. Returns (a_out (B, H, W, 64) f32, means
    (L, 64), vars (L, 64)): biased batch variance ``E[z^2] - mean^2``,
    eps 1e-5. Activations and cotangents are stored in ``store_dtype``
    between layers; BN sums, dW, dgamma and dbeta are f32. Differentiable in
    ws, gammas, betas and a1; means and vars carry no gradient."""
    return _FusedMidStack.apply(ws, gammas, betas, a1, store_dtype,
                                fwd_layer_train, bwd_layer)


def fused_mid_stack_plain(ws, gammas, betas, a1, store_dtype=torch.bfloat16,
                          mma_bf16=False, kernel_forward=False):
    """``fused_mid_stack`` over the layers' plain versions on any device:
    what ``chip_smoke.py`` holds the kernel route against on the card.

    ``kernel_forward`` keeps ``fwd_layer_train`` for the forward and takes
    the plain version of the backward only. Both backwards then start from
    the same stored activations, hence the same ReLU decisions, and differ
    by arithmetic alone; two forwards that differ by one rounded operand
    drift apart layer by layer."""
    fwd = (fwd_layer_train if kernel_forward
           else functools.partial(fwd_layer_train_plain, mma_bf16=mma_bf16))
    return _FusedMidStack.apply(
        ws, gammas, betas, a1, store_dtype, fwd,
        functools.partial(bwd_layer_plain, mma_bf16=mma_bf16))
