"""Sharded training steps over a (data, time) mesh.

Counterpart of ``frame2frame_tpu/parallel/shard.py``: the video batch split
over the ``data`` axis (data parallelism), long sequences over the ``time``
axis (the context-parallel analogue for video), one frame halo a time shard
for the frame-to-frame loss and +/-2 wt frames for the window losses, the
gradients summed over every shard, one optimizer update.

``shard_map`` runs every shard's program from one controller; so does the
port (``parallel/mesh.py``): the parameters live once, on the mesh's first
device, where ``model`` is; each shard computes with its parameters moved
to its own device by ``.to``, whose backward brings the gradient back; a
halo is a copy from the neighbour's block. Every loss here is a sum of
per-shard terms over a denominator that is not differentiated, so each
shard runs its forward and backward before the next shard's, in shard
order: the gradients add up in shard order on the first device, and a mesh
of four shards on one card holds no more than one shard's activations.

A step takes and returns the JAX package's layout: ``params`` and
``batch_stats`` trees (``models/dncnn.to_jax_variables``), the raveled
optimizer state of ``tx`` (``train/online.torch_adam``: ``init(vec)``,
``update(grads, state, params) -> (updates, state)``) and the loss.

Where the JAX package's sup step differs: its ``loss_fn`` ``psum``s the
local sum, and the transpose of that ``psum`` under ``shard_map`` sums the
cotangents over the shards before the gradients are ``psum``ed again, so
its gradient is D times the gradient of the loss it returns (D the mesh
size). Here the gradient is the gradient of the returned loss.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import functional_call

from ..config import Config
from ..models.dncnn import JaxRavel, load_jax_variables, to_jax_variables
from ..ops.fused_spatial import _current, _psum
from ..ops.warp import warped_dist_loss
from .mesh import shard_video


class _ShardedModel:
    """``model`` on the mesh's first device, run shard by shard: loads the
    JAX-layout variables, runs a shard's forward with the parameters moved
    to its device, and folds the gradients into one optimizer update."""

    def __init__(self, model, mesh, tx):
        self.model, self.mesh, self.tx = model, mesh, tx
        self.ravel = JaxRavel(model)
        self.params = dict(model.named_parameters())
        self.buffers = dict(model.named_buffers())

    def load(self, params, batch_stats):
        load_jax_variables(self.model, {"params": params,
                                        "batch_stats": batch_stats})
        for p in self.params.values():
            p.grad = None

    def forward(self, x, dev, train_bn):
        """The model on ``x`` (N, H, W, C) on ``dev``; with ``train_bn``
        the shard's own BatchNorm statistics, on copies of the running
        statistics that the forward moves (returned), else the running
        statistics."""
        state = {n: p.to(dev) for n, p in self.params.items()}
        state.update({n: b.detach().to(dev, copy=train_bn)
                      for n, b in self.buffers.items()})
        self.model.train(train_bn)
        try:
            out = functional_call(self.model, state, (x,))
        finally:
            self.model.eval()
        return out, {n: state[n] for n in self.buffers}

    def update(self, opt_state, shard_stats=None, grad_scale=None):
        """One ``tx`` update from the summed gradients (times
        ``grad_scale``); with ``shard_stats``, the running statistics
        become their mean over the shards, in shard order (the JAX
        package's ``pmean``). Returns (params, batch_stats, opt_state)."""
        grads = self.ravel.ravel(grads=True)
        if grad_scale is not None:
            grads = grads * grad_scale
        updates, opt_state = self.tx.update(grads, opt_state,
                                            self.ravel.ravel())
        self.ravel.add(updates)
        for p in self.params.values():
            p.grad = None
        if shard_stats:
            with torch.no_grad():
                for n, b in self.buffers.items():
                    if b.is_floating_point():
                        b.copy_(_psum([s[n] for s in shard_stats])
                                / len(shard_stats))
        v = to_jax_variables(self.model)
        return v["params"], v["batch_stats"], opt_state

    def shards(self):
        """(d, t, device) of every shard, in shard order."""
        for d, row in enumerate(self.mesh.devices):
            for t, dev in enumerate(row):
                yield d, t, dev


def make_sharded_f2f_step(model, mesh, tx, dist_crit="l2", residual=True,
                          train_bn=True):
    """The sharded train step of the frame2frame (warped) loss.

    ``step(params, batch_stats, opt_state, noisy, bflow) -> (params,
    batch_stats, opt_state, loss)``: noisy (B, T, H, W, C), bflow (B, T, H,
    W, 2) with bflow[:, t] mapping frame t to frame t - 1 (bflow[:, 0]
    unused), split over the mesh's (data, time) grid. Each time shard takes
    the last frame of its left neighbour as its halo (zeros on time shard
    0); the loss is the mean over the B (T - 1) pairs of frames t, t - 1.

    ``train_bn=True``: BatchNorm statistics a shard (data-parallel local
    BN), and the running averages become the mean of the shards'.
    ``train_bn=False``: the running averages, which makes the step the
    unsharded one."""
    sm = _ShardedModel(model, mesh, tx)
    n_time = mesh.shape["time"]

    def step(params, batch_stats, opt_state, noisy, bflow):
        sm.load(params, batch_stats)
        noisy = torch.as_tensor(noisy, dtype=torch.float32)
        B, T, H, W, C = noisy.shape
        t_loc = T // n_time
        n_pairs = B * (T - 1)
        vids, flows = shard_video(mesh, noisy), shard_video(mesh, bflow)
        loss, stats = [], []
        for d, t, dev in sm.shards():
            x, fl = vids[d][t], flows[d][t].to(torch.float32)
            if t:
                halo = vids[d][t - 1][:, -1:].to(dev)
            else:
                halo = torch.zeros_like(x[:, :1])
            prev = torch.cat([halo, x[:, :-1]], 1)
            with _current(dev):
                out, st = sm.forward(x.reshape((-1,) + x.shape[2:]), dev,
                                     train_bn)
                deno = out.reshape(x.shape)
                if not residual:
                    deno = x - deno
                # every pair but the one of the sequence's first frame
                pairs = [warped_dist_loss(deno[b, i], prev[b, i], fl[b, i],
                                          dist_crit=dist_crit)
                         for b in range(x.shape[0]) for i in range(t_loc)
                         if t * t_loc + i > 0]
                term = (sum(pairs) if pairs else 0 * deno.sum()) / n_pairs
                term.backward()
            loss.append(term.detach())
            stats.append(st)
        out = sm.update(opt_state, stats if train_bn else None)
        return (*out, _psum(loss))

    return step


def halo_exchange_time(blocks, halo):
    """The time shards of one data row, ``blocks[t]`` (b, t_loc, ...) on
    its device, each extended to (b, t_loc + 2 halo, ...) with ``halo``
    frames from each time neighbour (zeros beyond the sequence's ends).
    Differentiable: a halo frame's gradient flows back to its owner."""
    if halo == 0:
        return list(blocks)
    out = []
    for t, x in enumerate(blocks):
        pad = torch.zeros_like(x[:, :halo])
        left = blocks[t - 1][:, -halo:].to(x.device) if t else pad
        right = (blocks[t + 1][:, :halo].to(x.device)
                 if t + 1 < len(blocks) else pad)
        out.append(torch.cat([left, x, right], 1))
    return out


def _halo_window_tables(tix, t_loc, n_time, wt):
    """Window tables of time shard ``tix``'s extended block, in the block's
    own frame indices: ``(tj_local (T_ext, 2 wt) int32, valid (T_ext, 2 wt)
    bool, frame_weight (T_ext,) f32)`` with T_ext = t_loc + 4 wt.

    The block is frames [start, start + T_ext) with start = tix t_loc -
    2 wt; the windows follow the global clamped layout
    (``ops/nls.time_window_frames``), so the shard's own frames see the
    unsharded windows, and ``frame_weight`` is 1 on them, 0 on the halo."""
    halo = 2 * wt
    T_g = t_loc * n_time
    T_ext = t_loc + 2 * halo
    start = tix * t_loc - halo
    li = np.arange(T_ext)
    g = start + li  # the global frame of each block row (may lie outside)
    lo = np.clip(np.minimum(g - wt, T_g - (2 * wt + 1)), 0, None)
    win = lo[:, None] + np.arange(2 * wt + 1)[None, :]
    # drop the reference frame from each row, keeping the order
    not_ref = win != g[:, None]
    order = np.argsort(~not_ref, axis=1, kind="stable")
    tj_g = np.take_along_axis(win, order[:, :2 * wt], axis=1)
    valid = ((tj_g >= 0) & (tj_g < T_g) & (g >= 0)[:, None]
             & (g < T_g)[:, None])
    tj_local = np.clip(tj_g - start, 0, T_ext - 1).astype(np.int32)
    frame_weight = ((li >= halo) & (li < halo + t_loc)).astype(np.float32)
    return tj_local, valid, frame_weight


def make_sharded_window_step(model, mesh, tx, loss, kind="warped", wt=1,
                             residual=True, train_bn=False, step_i=0):
    """The sharded train step of the temporal-window losses: ``WarpedLoss``
    (``kind="warped"``, ``losses/warped.py`` ``run_pairs``) and ``DnlsLoss``
    (``kind="stnls"``, ``losses/stnls.py``), time-sharded with a +/-2 wt
    frame halo (2 wt covers the clamped windows at the sequence's ends).

    ``step(params, batch_stats, opt_state, noisy, clean, fflow, bflow) ->
    (params, batch_stats, opt_state, loss)``. ``step_i``, the schedule's
    step, is fixed when the step is built, as in the JAX package (the
    losses' ps / ws / k schedules).

    With ``train_bn=False`` the step is the unsharded loss: each shard runs
    the model on its halo frames too, the windows are the global ones, and
    the frame-weighted sums over the shards make the global mean. The
    shards' weighted sums are backpropagated one shard at a time and the
    summed gradient is divided once by the global count, which is not
    differentiated. ``train_bn=True``: BatchNorm statistics a shard over
    its extended block, the running averages the shards' mean.
    ``search_input="noisy-g-*"`` draws each shard's noise from a
    ``torch.Generator`` of its own (seeded with the shard's index, kept
    across steps): not the unsharded draw, as in the JAX package."""
    sm = _ShardedModel(model, mesh, tx)
    n_time = mesh.shape["time"]
    halo = 2 * wt
    if kind not in ("warped", "stnls"):
        raise ValueError(kind)
    gens = [torch.Generator(dev).manual_seed(k)
            for k, (_, _, dev) in enumerate(sm.shards())]

    def check_shapes(noisy):
        t_loc = noisy.shape[1] // n_time
        if noisy.shape[1] % n_time or t_loc < halo:
            raise ValueError(
                f"time-sharded window losses need each of the {n_time} time "
                f"shards to hold at least 2*wt={halo} frames (the halo "
                f"reaches only the adjacent shard); got T={noisy.shape[1]} "
                f"-> {t_loc} frames/shard. Use fewer time shards or more "
                f"frames.")

    def step(params, batch_stats, opt_state, noisy, clean, fflow, bflow):
        check_shapes(noisy)
        sm.load(params, batch_stats)
        t_loc = noisy.shape[1] // n_time
        ext = {}
        for name, v in (("noisy", noisy), ("clean", clean), ("fflow", fflow),
                        ("bflow", bflow)):
            grid = shard_video(mesh, torch.as_tensor(v, dtype=torch.float32))
            ext[name] = [halo_exchange_time(row, halo) for row in grid]
        wsums, counts, stats = [], [], []
        for k, (d, t, dev) in enumerate(sm.shards()):
            tj, valid, fw = _halo_window_tables(t, t_loc, n_time, wt)
            x, cl = ext["noisy"][d][t], ext["clean"][d][t]
            flows = Config(fflow=ext["fflow"][d][t], bflow=ext["bflow"][d][t])
            with _current(dev):
                out, st = sm.forward(x.reshape((-1,) + x.shape[2:]), dev,
                                     train_bn)
                deno = out.reshape(x.shape)
                if not residual:
                    deno = x - deno
                if kind == "warped":
                    wsum, wcount = loss.run_pairs(
                        deno, x, flows, step=step_i, tables=(tj, valid),
                        frame_weight=fw)
                else:
                    wsum, wcount = loss(x, cl, deno, dict(flows), step_i,
                                        key=gens[k], tables=(tj, valid),
                                        frame_weight=fw)
                wsum.backward()
            wsums.append(wsum.detach())
            counts.append(torch.as_tensor(wcount).detach())
            stats.append(st)
        denom = _psum(counts)
        out = sm.update(opt_state, stats if train_bn else None,
                        grad_scale=1.0 / denom.to(mesh.first))
        return (*out, _psum(wsums) / denom)

    return step


def make_sharded_sup_step(model, mesh, tx, residual=True):
    """The sharded supervised (MSE against clean) train step: the same mesh
    layout, no halo, BatchNorm statistics a shard, the running averages the
    shards' mean.

    ``step(params, batch_stats, opt_state, noisy, clean) -> (params,
    batch_stats, opt_state, loss)``; the loss is the sum of the shards'
    squared errors over the whole batch's element count, and the update is
    from the gradient of that loss (the JAX package's is D times it)."""
    sm = _ShardedModel(model, mesh, tx)

    def step(params, batch_stats, opt_state, noisy, clean):
        sm.load(params, batch_stats)
        noisy = torch.as_tensor(noisy, dtype=torch.float32)
        clean = torch.as_tensor(clean, dtype=torch.float32)
        n = clean.numel()
        vids, cleans = shard_video(mesh, noisy), shard_video(mesh, clean)
        loss, stats = [], []
        for d, t, dev in sm.shards():
            x, cl = vids[d][t], cleans[d][t]
            with _current(dev):
                out, st = sm.forward(x.reshape((-1,) + x.shape[2:]), dev,
                                     True)
                deno = out.reshape(x.shape)
                if not residual:
                    deno = x - deno
                term = ((deno - cl) ** 2).sum() / n
                term.backward()
            loss.append(term.detach())
            stats.append(st)
        out = sm.update(opt_state, stats)
        return (*out, _psum(loss))

    return step
