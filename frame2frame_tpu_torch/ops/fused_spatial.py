"""The DnCNN mid stack on one frame split by rows (H) into slabs over a list
of devices: the mid-layer kernels with their row window, halo rows
exchanged between neighbouring slabs, and BatchNorm statistics and
gradients summed over the slabs (sync-BN), so that the result is the one
frame's.

Counterpart of ``frame2frame_tpu/ops/fused_spatial.py``. ``jax.shard_map``
runs one program for every shard from one controller; so does this module,
in one process and without ``torch.distributed``:

- a mesh is an ordered tuple of ``torch.device``s along the ``space`` axis
  (``parallel/spatial.make_space_mesh``); a device may repeat, and then its
  slabs run one after another on its stream (one card runs D slabs so);
- slab k lives on device k: its body rows [k R, (k + 1) R) of the padded
  frame and one halo row above and one below, the 3x3 convolution's reach
  (the TPU layout's head and tail tiles);
- a halo exchange copies each neighbour's boundary body row into the halo
  rows (``copy_``, across devices where they differ); at the frame's top
  and bottom no neighbour exists, and the kernels' row window
  (``valid_bounds``) makes those rows read as zeros, as do pad rows;
- a psum adds the slabs' tensors in slab order on the first device, so the
  same inputs give the same bits, and the sum is handed to each slab's
  device where a kernel takes it;
- each slab's launches run with its device the current CUDA device, on
  that device's current stream (``_per_slab``); the copies between devices
  (``.to``, ``copy_``) are ordered by PyTorch against both devices'
  current streams.

The layer loops are ``ops/fused_stack.py``'s ``mid_forward`` and
``mid_backward``, given layer functions that run every slab and sum where
the TPU package has its psums: the BN sums after each forward layer; dW
and the BN-backward sums after each backward layer; the last layer's
dbeta and dgamma, taken per slab on the cotangent before any halo is
read, over the slab's body rows in the frame.
Rows of a slab outside its windows hold whatever the kernels wrote there
(conv outputs of halo rows); no kernel reads them.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from ._common import C
from .fused_stack import (
    bn_norm,
    bwd_layer,
    fwd_layer,
    fwd_layer_eval,
    fwd_layer_train,
    kernel_weights,
    mid_backward,
    mid_forward,
)

HALO = 1  # rows a slab holds above and below its body


def as_device(d):
    """``d`` as a ``torch.device`` with its index: ``"cuda"`` is the current
    CUDA device, as a tensor placed there records it."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def pad_h(H, n_shards):
    """Smallest padded height that splits into ``n_shards`` slabs of equal
    height. The TPU package also rounds to whole tiles of its flat layout;
    the port has none. Raises where a slab would hold no row of the
    frame."""
    Hp = -(-H // n_shards) * n_shards
    if (n_shards - 1) * (Hp // n_shards) >= H:
        raise ValueError(f"{H} rows do not split into {n_shards} slabs that "
                         "each hold a row of the frame")
    return Hp


def _local_geom(Hp, n_shards):
    """Body rows of a slab."""
    if Hp % n_shards:
        raise ValueError(f"padded H {Hp} must split into {n_shards} equal "
                         "slabs: pad to pad_h(H, n_shards)")
    return Hp // n_shards


def _valid_bounds(k, R, H_true):
    """Slab k's ``valid_bounds``: its rows that are rows of the frame (local
    row r is frame row k R + r - 1), and the body rows among them, which
    its sums count."""
    lo, hi = HALO - k * R, H_true + HALO - k * R
    return lo, hi, max(lo, HALO), min(hi, R + HALO)


def split_frame(x, mesh, halo=HALO):
    """(B, H, W, ...) -> the slabs of ``mesh``: slab k (B, H / D + 2 halo,
    W, ...) on ``mesh[k]``, its body rows [k H / D, (k + 1) H / D) and
    ``halo`` rows of its neighbours above and below (zeros beyond the
    frame). Each slab is a tensor of its own."""
    D = len(mesh)
    R = _local_geom(x.shape[1], D)
    pad = (0, 0) * (x.dim() - 2) + (halo, halo)
    xp = F.pad(x, pad) if halo else x
    return [xp[:, k * R:(k + 1) * R + 2 * halo].to(dev, copy=True)
            .contiguous() for k, dev in enumerate(mesh)]


def gather_frame(slabs, device=None, halo=HALO):
    """The inverse of ``split_frame``: the slabs' body rows, in order, as
    one tensor on ``device`` (the first slab's by default)."""
    device = slabs[0].device if device is None else device
    return torch.cat([s[:, halo:s.shape[1] - halo].to(device)
                      for s in slabs], 1)


def _exchange(slabs):
    """Halo rows from the neighbours' boundary body rows, in place."""
    R = slabs[0].shape[1] - 2 * HALO
    for k in range(1, len(slabs)):
        slabs[k][:, 0].copy_(slabs[k - 1][:, R])
        slabs[k - 1][:, R + 1].copy_(slabs[k][:, 1])
    return slabs


def _psum(parts):
    """The slabs' tensors added in slab order, on the first one's device."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(total.device)
    return total


def _on(t, x):
    return t.to(x.device)


def _current(device):
    """``device`` as the current CUDA device, so that a kernel wrapper
    launches there, on its current stream; nothing on the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _per_slab(launch, slabs, *per_slab):
    """[launch(slab, *its entries of per_slab)] over the slabs, each with
    its slab's device current."""
    outs = []
    for x, *args in zip(slabs, *per_slab):
        with _current(x.device):
            outs.append(launch(x, *args))
    return outs


def _sharded_fwd(fwd, bounds):
    """``mid_forward``'s layer function over slabs: each slab's layer with
    its window, halos exchanged, the BN sums added."""
    def layer(slabs, w, s, b):
        outs = _per_slab(
            lambda x, vb: fwd(x, _on(w, x), _on(s, x), _on(b, x),
                              valid_bounds=vb), slabs, bounds)
        return _exchange([z for z, _ in outs]), _psum([st for _, st in outs])
    return layer


def _sharded_bwd(bwd, bounds):
    """``mid_backward``'s layer function over slabs: dW and the BN-backward
    sums added, da_prev's halos exchanged (the first layer's cotangent is
    read at body rows only)."""
    def layer(g, z_i, z_prev, w, vecs, first_layer):
        outs = _per_slab(
            lambda gk, zk, zpk, vb: bwd(gk, zk, zpk, _on(w, gk),
                                        _on(vecs, gk), first_layer,
                                        valid_bounds=vb),
            g, z_i, z_prev, bounds)
        da = [o[0] for o in outs]
        if not first_layer:
            _exchange(da)
        return da, _psum([o[1] for o in outs]), _psum([o[2] for o in outs])
    return layer


def _last_bn_sums(g, z_last, s, b, rstd, nmr, bounds):
    """The last BatchNorm's backward sums (dbeta, dgamma) = (sum gt, sum gt
    * zhat) with gt = g * [s z + b > 0], each slab's over its body rows in
    the frame (``bounds``' summed rows), added: each row of the frame
    counted once. g, z_last: the slabs of the cotangent and of the last
    conv output."""
    def sums(gk, zk, vb):
        zl = zk[:, vb[2]:vb[3]].float()
        gt = gk[:, vb[2]:vb[3]].float() * (zl * _on(s, zk) + _on(b, zk) > 0)
        zhat = zl * _on(rstd, zk) + _on(nmr, zk)
        return torch.stack([gt.sum((0, 1, 2)), (gt * zhat).sum((0, 1, 2))])
    total = _psum(_per_slab(sums, g, z_last, bounds))
    return total[0], total[1]


def _geometry(a1, H_true, mesh):
    if a1.device != as_device(mesh[0]):
        raise ValueError(f"the frame must lie on the mesh's first device "
                         f"{mesh[0]}, not {a1.device}")
    R = _local_geom(a1.shape[1], len(mesh))
    if not 0 < H_true <= a1.shape[1]:
        raise ValueError(f"H_true {H_true} outside the frame's "
                         f"{a1.shape[1]} rows")
    return [_valid_bounds(k, R, H_true) for k in range(len(mesh))]


class _SpatialMidStack(torch.autograd.Function):
    """(conv3x3 + BatchNorm(train) + ReLU)^L over slabs, with ``fwd`` and
    ``bwd`` the layer functions (``fwd_layer_train``, ``bwd_layer``)."""

    @staticmethod
    def forward(ctx, ws, gammas, betas, a1, H_true, store_dtype, mesh, fwd,
                bwd):
        bounds = _geometry(a1, H_true, mesh)
        count = a1.shape[0] * H_true * a1.shape[2]
        wk = kernel_weights(ws)
        a_in = split_frame(a1.to(store_dtype), mesh)
        zs, ss, bs, means, vars_ = mid_forward(_sharded_fwd(fwd, bounds), wk,
                                               gammas, betas, a_in, count)
        a_out = torch.relu(gather_frame(zs[-1], a1.device).float() * ss[-1]
                           + bs[-1])
        ctx.save_for_backward(wk, means, vars_, ss, bs)
        # the slabs are intermediates of this function, on several devices
        ctx.slabs = (a_in, zs)
        ctx.store_dtype, ctx.mesh, ctx.count = store_dtype, mesh, count
        ctx.a1_dtype = a1.dtype
        ctx.bounds, ctx.layer_bwd = bounds, _sharded_bwd(bwd, bounds)
        ctx.mark_non_differentiable(means, vars_)
        return a_out, means, vars_

    @staticmethod
    def backward(ctx, da_out, _dm, _dv):
        wk, means, vars_, ss, bs = ctx.saved_tensors
        a_in, zs = ctx.slabs
        rstd, nmr = bn_norm(means, vars_)
        g = split_frame(da_out.to(ctx.store_dtype), ctx.mesh)
        dbeta, dgamma = _last_bn_sums(g, zs[-1], ss[-1], bs[-1], rstd[-1],
                                      nmr[-1], ctx.bounds)
        dws, dgammas, dbetas, g = mid_backward(
            ctx.layer_bwd, wk, zs, a_in, ss, bs, means, rstd, nmr, ctx.count,
            g, dbeta, dgamma)
        da1 = gather_frame(g, da_out.device).to(ctx.a1_dtype)
        return (dws, dgammas, dbetas, da1) + (None,) * 5


def fused_mid_stack_spatial(ws, gammas, betas, a1, H_true, store_dtype, mesh):
    """(conv3x3 + BatchNorm(train) + ReLU)^L of one frame split into the
    slabs of ``mesh``, with the one frame's semantics (BN statistics over
    its H_true * W pixels, sync-BN).

    ws: (L, 3, 3, 64, 64) HWIO f32; gammas, betas: (L, 64) f32; a1: (B, Hp,
    W, 64) post-ReLU stack input on ``mesh[0]``, Hp = pad_h(H_true, D)
    (rows >= H_true are ignored: outside every window, and whatever the
    stack writes there is the caller's to crop); store_dtype: the chain's
    dtype between layers. Returns (a_out (B, Hp, W, 64) f32 on ``mesh[0]``,
    means, vars (L, 64)), differentiable in ws, gammas, betas and a1 as
    ``fused_stack.fused_mid_stack``."""
    return _SpatialMidStack.apply(ws, gammas, betas, a1, H_true, store_dtype,
                                  mesh, fwd_layer_train, bwd_layer)


def eval_mid_stack_spatial(w, s, b, a1, H_true, mesh, dtype, route):
    """Eval-mode mid stack of one frame split into the slabs of ``mesh``.

    w: ``kernel_weights`` of (L, 3, 3, 64, 64); s, b: (L, 64) the layers'
    eval BN affines; a1: (B, Hp, W, 64) on ``mesh[0]``, Hp = pad_h(H_true,
    D); dtype: the chain's; route: "affine" (``fwd_layer`` on raw conv
    outputs, each applying the previous layer's affine and ReLU) or "act"
    (``fwd_layer_eval`` on post-activation slabs). Returns the last
    activation (B, Hp, W, 64) on ``mesh[0]``: f32 on "affine", in ``dtype``
    on "act"."""
    bounds = _geometry(a1, H_true, mesh)
    cur = split_frame(a1.to(dtype), mesh)
    L = w.shape[0]
    one = torch.ones(C, dtype=torch.float32, device=a1.device)
    for i in range(L):
        if route == "act":
            si, bi, layer = s[i], b[i], fwd_layer_eval
        elif i == 0:
            si, bi, layer = one, torch.zeros_like(one), fwd_layer
        else:
            si, bi, layer = s[i - 1], b[i - 1], fwd_layer
        cur = _per_slab(lambda x, vb: layer(x, _on(w[i], x), _on(si, x),
                                            _on(bi, x), valid_bounds=vb),
                        cur, bounds)
        if i + 1 < L:
            _exchange(cur)
    out = gather_frame(cur, a1.device)
    if route == "act":
        return out
    return torch.addcmul(b[-1], out, s[-1]).relu_()
