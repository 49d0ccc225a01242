"""Online per-frame fine-tuning ("frame2frame" blind denoising) and the
serving entry points of the online denoiser.

Counterpart of ``frame2frame_tpu/train/online.py``: ``torch_adam``,
``make_denoise``, ``make_online_step`` and ``OnlineDenoiser`` with
``process_frame``, ``denoise_only`` and ``denoise_batch``.
``make_online_step`` takes the whole-iteration flat step
(``train/flat_step.py``: every layer and the loss on kernels) where it is
eligible, as the JAX package does on its accelerator, else the body that runs
``fused_train_apply`` with the end convs and the loss in plain ops. The
reference hot loop (blind_denoising.py:187-256) per
frame: warp the previous noisy frame by the flow and mask occlusions, once;
``iters`` Adam updates of the DnCNN in training mode on the summed masked L1
loss; then the eval-mode denoise with the updated weights. PyTorch runs
eagerly, so the JAX package's ``lax.scan`` is a Python loop here. The flow
comes from ``AsyncFlowSolver`` (TV-L1, ``flow/tvl1.py``), which solves ahead
of the fine-tune on a CUDA stream of its own. ``run_blind_denoising`` is not
ported yet: the caller feeds ``AsyncFlowSolver`` and hands ``process_frame``
its flows.
"""

from __future__ import annotations

import copy
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..models.dncnn import JaxRavel, load_jax_variables, to_jax_variables
from ..models.fused_apply import (
    _eval_impl,
    can_fuse,
    can_fuse_batch,
    fused_eval_apply,
    fused_eval_apply_batch,
    fused_train_apply,
)
from ..ops.warp import bilinear_warp_with_mask, occlusion_mask
from ..utils.device import resolve_device
from .flat_step import eligible, run_flat_scan

BATCH_ROUTES = ("stacked", "perframe")


class torch_adam:
    """``torch.optim.Adam`` with L2 ``weight_decay`` (decay added to the
    gradient before the moment updates) over ONE raveled vector, as the JAX
    package's ``torch_adam``.

    State: ``{"count": int, "m": (N,) f32, "v": (N,) f32}`` with ``m`` and
    ``v`` in the JAX package's ``ravel_pytree`` order of the parameters
    (``models.dncnn.JaxRavel``), so that the state crosses over
    (``models.dncnn.opt_state_from_jax`` / ``opt_state_to_jax``). The bias
    corrections ``1 - beta ** count`` are taken in f32 and ``eps`` is added
    outside the square root."""

    def __init__(self, lr, weight_decay=0.0, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.weight_decay = lr, weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params):
        """Zero state for the raveled parameter vector ``params``."""
        return {"count": 0, "m": torch.zeros_like(params),
                "v": torch.zeros_like(params)}

    @torch.no_grad()
    def update(self, grads, state, params=None):
        """(updates, new_state) for raveled ``grads``; ``params`` is needed
        when there is weight decay. Add ``updates`` to the parameters."""
        g = grads
        if self.weight_decay:
            g = g + self.weight_decay * params
        count = state["count"] + 1
        m = self.b1 * state["m"] + (1 - self.b1) * g
        v = self.b2 * state["v"] + (1 - self.b2) * (g * g)
        c = np.float32(count)
        mhat = m / float(np.float32(1) - np.float32(self.b1) ** c)
        vhat = v / float(np.float32(1) - np.float32(self.b2) ** c)
        u = (-self.lr) * (mhat / (torch.sqrt(vhat) + self.eps))
        return u, {"count": count, "m": m, "v": v}


def make_denoise(model, residual_model=False):
    """Build ``denoise(x, train=False, eval_impl=None) -> deno`` for one
    (H, W, C) frame, through the fused kernels where the model allows it.

    With ``train=True`` the forward runs in training mode (batch statistics,
    running statistics updated in place), builds the autograd graph and
    ignores ``eval_impl``. ``residual_model`` says whether the model returns
    the denoised image (harness convention) or the noise (submodule
    convention, blind_denoising.py:218 subtracts)."""
    fused = can_fuse(model)

    def denoise(x, train=False, eval_impl=None):
        if train:
            if fused:
                y = fused_train_apply(model, x[None])[0]
            else:
                model.train()
                try:
                    y = model(x[None])[0]
                finally:
                    model.eval()
            return y if residual_model else x - y
        with torch.no_grad():
            if fused:
                y = fused_eval_apply(model, x[None], eval_impl=eval_impl)[0]
            else:
                y = model(x[None])[0]
            return y if residual_model else x - y

    return denoise


def make_online_step(model, tx, iters=20, residual_model=False,
                     flat_step=None):
    """Build the per-frame program

        step(opt_state, cur, prev, flow, eval_impl=None)
            -> (opt_state, deno, losses)

    cur/prev: (H, W, C) in [0, 1]; flow: (H, W, 2) mapping cur -> prev
    coords. The mask and the warped target depend only on prev and flow, so
    they are built once per frame. ``model``'s parameters and running
    statistics are updated in place; the optimizer state is returned.

    ``flat_step``: None takes the flat step (``flat_step.run_flat_scan``)
    where ``flat_step.eligible``, else the per-iteration body on
    ``fused_train_apply``; False always takes that body; True raises where
    the flat step is not eligible. (The JAX package switches with the
    environment variable ``F2F_FLATSTEP``; the port reads no implementation
    from the environment.)"""
    denoise = make_denoise(model, residual_model=residual_model)
    flat = JaxRavel(model)

    def use_flat_step(x_shape):
        if flat_step is False:
            return False
        ok = eligible(model, x_shape, residual_model)
        if flat_step and not ok:
            raise ValueError(
                "flat_step=True, but the flat step does not cover this model "
                f"on frames of shape {tuple(x_shape)}: it needs 64 features, "
                "a mid stack, one channel and residual_model == "
                "model.residual")
        return ok

    def step(opt_state, cur, prev, flow, eval_impl=None):
        with torch.no_grad():
            warped, mask = bilinear_warp_with_mask(prev, flow)
            mask = occlusion_mask(flow, mask)
            target = mask * warped
        if use_flat_step(cur.shape):
            opt_state, losses = run_flat_scan(model, tx, iters, opt_state,
                                              cur, mask, target, flat=flat)
            deno = denoise(cur, train=False, eval_impl=eval_impl)
            return opt_state, deno, losses
        losses = []
        for _ in range(iters):
            with torch.enable_grad():
                deno = denoise(cur, train=True)
                # summed L1 (nn.L1Loss(size_average=False),
                # blind_denoising.py:47)
                loss = (mask * deno - target).abs().sum()
            loss.backward()
            updates, opt_state = tx.update(flat.ravel(grads=True), opt_state,
                                           flat.ravel())
            for p in flat.params:
                p.grad = None
            flat.add(updates)
            losses.append(loss.detach())
        deno = denoise(cur, train=False, eval_impl=eval_impl)
        return opt_state, deno, torch.stack(losses)

    return step


class AsyncFlowSolver:
    """TV-L1 flows solved ahead of the fine-tune by a worker thread.

    Counterpart of the JAX package's ``AsyncFlowSolver``, with the same
    interface. That class solves on the host CPU because its accelerator runs
    one program at a time; a CUDA card runs several streams, so the worker
    solves ON THE CARD, on a stream of its own, beside the fine-tune's
    kernels. A solve is several thousand small launches, and the fine-tune
    keeps the host busy with its own: the worker's first solve is made
    launch by launch and then recorded into one CUDA graph, which every
    solve from then on replays (the counterpart of the JAX package's
    ``jax.jit``; the eager solve's bits). The graph and its buffers belong
    to this object and go with ``close()``. ``get(i)`` waits for the worker,
    which returns once solve ``i`` has ended on its stream, makes the
    caller's current stream wait on the event recorded after the solve, and
    hands over the ``(H, W, 2)`` tensor.

    ``params``: keywords of ``make_tvl1_solver`` (``DENOISING_PARAMS``);
    ``lookahead``: how many flows a caller should keep in flight (read by the
    caller, as in the JAX package); ``device``: None means the CUDA card and
    raises where there is none, ``"cpu"`` solves on the host with the plain
    version of the inner loop. ``solve_times`` holds what each solve took in
    seconds by the worker's clock, from the frames' upload to the end of the
    solve on the worker's stream."""

    def __init__(self, W, H, params, lookahead=3, device=None):
        from ..flow.tvl1 import make_tvl1_solver

        self.device = resolve_device(device)
        self._solve = make_tvl1_solver(W, H, device=self.device, **params)
        self._cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._graph = self._frames = self._flow = None
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._futs = {}
        self.lookahead = lookahead
        self.solve_times = []

    def _record(self):
        """Solve once launch by launch (kernels build and load, which must
        not happen while a stream records), then record the same solve on
        the graph's own input, output and intermediate buffers."""
        self._solve(*self._frames)
        self._stream.synchronize()
        self._graph = torch.cuda.CUDAGraph()
        # thread_local: the caller's thread may allocate while this records
        with torch.cuda.graph(self._graph, capture_error_mode="thread_local"):
            self._flow = self._solve(*self._frames)

    def _work(self, cur_np, prev_np):
        t0 = time.perf_counter()
        cur = np.asarray(cur_np)[..., 0] * 255.0
        prev = np.asarray(prev_np)[..., 0] * 255.0
        if not self._cuda:
            flow = self._solve(cur, prev)
            self.solve_times.append(time.perf_counter() - t0)
            return flow, None
        # the current device and the current stream are per thread
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            if self._graph is None:
                self._frames = torch.empty(2, *cur.shape, dtype=torch.float32,
                                           device=self.device)
            self._frames[0].copy_(torch.from_numpy(cur))
            self._frames[1].copy_(torch.from_numpy(prev))
            if self._graph is None:
                self._record()
            # every solve runs on the one stream, in order: the replay
            # starts after the solve before it has been copied out
            self._graph.replay()
            flow = self._flow.clone()
            done = torch.cuda.Event()
            done.record(self._stream)
            self._stream.synchronize()
        self.solve_times.append(time.perf_counter() - t0)
        return flow, done

    def prefetch(self, i, cur_np, prev_np):
        """Schedule flow i (cur -> prev coords) if not already in flight.
        cur_np, prev_np: (H, W, C) frames in [0, 1]; channel 0 is solved."""
        if i not in self._futs:
            self._futs[i] = self._pool.submit(self._work, cur_np, prev_np)

    def get(self, i):
        """Flow i as an (H, W, 2) tensor on the solver's device, ordered
        after its solve on the caller's current stream."""
        flow, done = self._futs.pop(i).result()
        if done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            flow.record_stream(stream)
        return flow

    def close(self):
        """Drop what is still queued, wait for the solve that runs, and
        free the graph and its buffers."""
        self._pool.shutdown(wait=True, cancel_futures=True)
        self._graph = self._frames = self._flow = None


def _memory_budget(device):
    """Free memory of ``device`` in bytes: the card's free memory, or the
    host's physical memory for the CPU."""
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[0]
    return os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


class OnlineDenoiser:
    """Frame-by-frame denoiser holding one DnCNN on one device.

    ``model``: a ``DnCNN`` giving the architecture and output convention;
    ``variables``: the JAX-layout ``{"params", "batch_stats"}`` tree whose
    weights the engine serves (the caller's model is not modified);
    ``lr``, ``weight_decay``, ``iters``: the fine-tune's Adam and its updates
    per frame; ``batch_route``: default ``denoise_batch`` route, "stacked" or
    "perframe"; ``eval_impl``: "affine" (default), "act-bf16" or "act-f32";
    ``flat_step``: the fine-tune's route, as ``make_online_step`` takes it;
    ``device``: None means the CUDA card, and raises where there is none.
    The optimizer state ``opt_state`` persists across frames.
    """

    def __init__(self, model, variables, lr=5e-5, weight_decay=1e-5, iters=20,
                 residual_model=False, batch_route="stacked", eval_impl=None,
                 device=None, flat_step=None):
        if batch_route not in BATCH_ROUTES:
            raise ValueError(f"batch_route must be one of {BATCH_ROUTES}")
        _eval_impl(eval_impl)
        self.device = resolve_device(device)
        self.model = load_jax_variables(copy.deepcopy(model), variables)
        self.model = self.model.to(self.device).eval()
        self.tx = torch_adam(lr, weight_decay)
        self.opt_state = self.tx.init(JaxRavel(self.model).ravel())
        self.iters = iters
        self.batch_route = batch_route
        self.eval_impl = eval_impl
        self._residual_model = residual_model
        self._denoise = make_denoise(self.model, residual_model)
        self._step = make_online_step(self.model, self.tx, iters=iters,
                                      residual_model=residual_model,
                                      flat_step=flat_step)

    def _tensor(self, x):
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def process_frame(self, cur, prev, flow):
        """Fine-tune on (cur, prev, flow) and return (deno, losses): the
        eval-mode denoise of ``cur`` with the updated weights, and the
        ``iters`` losses, one before each update."""
        self.opt_state, deno, losses = self._step(
            self.opt_state, self._tensor(cur), self._tensor(prev),
            self._tensor(flow), self.eval_impl)
        return deno, losses

    def denoise_only(self, cur):
        """Eval-mode denoise of one (H, W, C) frame in [0, 1]."""
        return self._denoise(self._tensor(cur), eval_impl=self.eval_impl)

    @torch.no_grad()
    def denoise_batch(self, frames, route=None):
        """Eval-mode denoise of (B, H, W, C) frames.

        - "stacked": the whole batch through one kernel launch per layer;
          falls back to "perframe" when the batch would not fit the
          device's free memory (``can_fuse_batch``);
        - "perframe": ``denoise_only`` on each frame in turn.
        """
        route = route or self.batch_route
        if route not in BATCH_ROUTES:
            raise ValueError(f"route must be one of {BATCH_ROUTES}")
        x = self._tensor(frames)
        if route == "stacked" and not can_fuse_batch(
                self.model, tuple(x.shape), _memory_budget(self.device),
                self.eval_impl):
            route = "perframe"
        if route == "perframe":
            return torch.stack([self._denoise(f, eval_impl=self.eval_impl)
                                for f in x])
        y = fused_eval_apply_batch(self.model, x, eval_impl=self.eval_impl)
        return y if self._residual_model else x - y

    @property
    def variables(self):
        """The served weights as a JAX-layout tree of numpy arrays."""
        return to_jax_variables(self.model)
