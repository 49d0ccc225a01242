"""Online per-frame fine-tuning ("frame2frame" blind denoising) and the
serving entry points of the online denoiser.

Counterpart of ``frame2frame_tpu/train/online.py``: ``torch_adam``,
``make_denoise``, ``make_online_step``, ``AsyncFlowSolver``,
``OnlineDenoiser`` with ``process_frame``, ``denoise_only`` and
``denoise_batch``, and the streaming loop ``run_blind_denoising``.
``make_online_step`` takes the whole-iteration flat step
(``train/flat_step.py``: every layer and the loss on kernels) where it is
eligible, as the JAX package does on its accelerator, else the body that runs
``fused_train_apply`` with the end convs and the loss in plain ops, and for a
model whose ``conv_impl`` is not ``"fused"`` the body on the model's own
forward (``models/dncnn.py``; the ``"pallas"``, ``"hybrid"``, ``"bf16res"``
and ``"packed_bf16"`` routes run the kernels of ``ops/conv3x3.py`` and
``ops/conv_dw.py``). The reference hot loop (blind_denoising.py:187-256) per
frame: warp the previous noisy frame by the flow and mask occlusions, once;
``iters`` Adam updates of the DnCNN in training mode on the summed masked L1
loss; then the eval-mode denoise with the updated weights. PyTorch runs
eagerly, so the JAX package's ``lax.scan`` is a Python loop here. The flow
comes from ``.flo`` files, from ``AsyncFlowSolver`` (TV-L1,
``flow/tvl1.py``), which solves ahead of the fine-tune on a CUDA stream of
its own, or from the batched solver in line (``run_blind_denoising``).
"""

from __future__ import annotations

import copy
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
    fused_eval_apply_spatial,
    fused_train_apply,
    fused_train_apply_spatial,
)
from ..ops.warp import bilinear_warp_with_mask, occlusion_mask
from ..utils.device import memory_budget as _memory_budget
from ..utils.device import resolve_device
from ..utils.profiling import annotate, count
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


def make_denoise(model, residual_model=False, spatial_mesh=None,
                 store_dtype=torch.bfloat16):
    """Build ``denoise(x, train=False, eval_impl=None) -> deno`` for one
    (H, W, C) frame, through the fused kernels where the model allows it
    (``fused_apply.can_fuse``: ``conv_impl="fused"``, 64 features), else
    through the model's forward, which routes by its ``conv_impl``.

    With ``train=True`` the forward runs in training mode (batch statistics,
    running statistics updated in place), builds the autograd graph and
    ignores ``eval_impl``. ``residual_model`` says whether the model returns
    the denoised image (harness convention) or the noise (submodule
    convention, blind_denoising.py:218 subtracts). ``spatial_mesh``: a mesh
    (``parallel.spatial.make_space_mesh``) over whose devices the fused
    forwards split the frame by rows (``fused_apply.fused_*_spatial``); a
    model that does not fuse runs unsplit. ``store_dtype``: the fused
    chain's dtype (bf16 in production, f32 in the strict mode of the
    tests)."""
    fused = can_fuse(model)
    mesh = spatial_mesh if fused else None

    def denoise(x, train=False, eval_impl=None):
        if train:
            if mesh is not None:
                y = fused_train_apply_spatial(model, x[None], mesh,
                                              store_dtype)[0]
            elif fused:
                y = fused_train_apply(model, x[None], store_dtype)[0]
            else:
                model.train()
                try:
                    y = model(x[None])[0]
                finally:
                    model.eval()
            return y if residual_model else x - y
        with torch.no_grad():
            if mesh is not None:
                y = fused_eval_apply_spatial(model, x[None], mesh, store_dtype,
                                             eval_impl)[0]
            elif fused:
                y = fused_eval_apply(model, x[None], store_dtype,
                                     eval_impl)[0]
            else:
                y = model(x[None])[0]
            return y if residual_model else x - y

    return denoise


def make_online_step(model, tx, iters=20, residual_model=False,
                     flat_step=None, spatial_mesh=None,
                     store_dtype=torch.bfloat16):
    """Build the per-frame program

        step(opt_state, cur, prev, flow, eval_impl=None)
            -> (opt_state, deno, losses)

    cur/prev: (H, W, C) in [0, 1]; flow: (H, W, 2) mapping cur -> prev
    coords. The mask and the warped target depend only on prev and flow, so
    they are built once per frame. ``model``'s parameters and running
    statistics are updated in place; the optimizer state is returned.

    ``flat_step``: None takes the flat step (``flat_step.run_flat_scan``)
    where ``flat_step.eligible``, else the per-iteration body (on
    ``fused_train_apply``, or on the model's forward for a ``conv_impl``
    other than ``"fused"``); False always takes that body; True raises where
    the flat step is not eligible, at once for a ``conv_impl`` other than
    ``"fused"``. (The JAX package switches with the environment variable
    ``F2F_FLATSTEP``; the port reads no implementation from the
    environment.)

    ``spatial_mesh``: split the frame by rows over the mesh's devices
    (``parallel.spatial.make_spatial_online_step``); the step then takes
    the per-iteration body, as the JAX package's does, and ``flat_step=True``
    raises. The warp, the mask and the loss run on the whole frame.
    ``store_dtype``: the fused chain's dtype; the flat step runs the bf16
    chain only, so f32 takes the per-iteration body (``flat_step=True``
    raises)."""
    if flat_step and model.conv_impl != "fused":
        raise ValueError(
            "flat_step=True, but the flat step runs only conv_impl='fused'; "
            f"this model has conv_impl={model.conv_impl!r}")
    if flat_step and spatial_mesh is not None:
        raise ValueError("flat_step=True, but the flat step does not split "
                         "a frame: a spatial_mesh takes the per-iteration body")
    if flat_step and store_dtype != torch.bfloat16:
        raise ValueError(f"flat_step=True, but the flat step runs the bf16 "
                         f"chain only, not {store_dtype}")
    denoise = make_denoise(model, residual_model=residual_model,
                           spatial_mesh=spatial_mesh, store_dtype=store_dtype)
    flat = JaxRavel(model)

    def use_flat_step(x_shape):
        if (flat_step is False or spatial_mesh is not None
                or store_dtype != torch.bfloat16):
            return False
        ok = eligible(model, x_shape, residual_model)
        if flat_step and not ok:
            raise ValueError(
                "flat_step=True, but the flat step does not cover this model "
                f"on frames of shape {tuple(x_shape)}: it needs "
                "conv_impl='fused', 64 features, a mid stack, one channel "
                "and residual_model == model.residual")
        return ok

    def step(opt_state, cur, prev, flow, eval_impl=None):
        with annotate("online.warp"), torch.no_grad():
            warped, mask = bilinear_warp_with_mask(prev, flow)
            mask = occlusion_mask(flow, mask)
            target = mask * warped
        if use_flat_step(cur.shape):
            count("online.route.flat")
            opt_state, losses = run_flat_scan(model, tx, iters, opt_state,
                                              cur, mask, target, flat=flat)
        else:
            count("online.route.iter")
            losses = []
            for _ in range(iters):
                with annotate("online.iter"):
                    with annotate("online.forward"), torch.enable_grad():
                        deno = denoise(cur, train=True)
                        # summed L1 (nn.L1Loss(size_average=False),
                        # blind_denoising.py:47)
                        loss = (mask * deno - target).abs().sum()
                    with annotate("online.backward"):
                        loss.backward()
                    with annotate("online.update"):
                        updates, opt_state = tx.update(
                            flat.ravel(grads=True), opt_state, flat.ravel())
                        for p in flat.params:
                            p.grad = None
                        flat.add(updates)
                        losses.append(loss.detach())
            losses = torch.stack(losses)
        with annotate("online.denoise"):
            deno = denoise(cur, train=False, eval_impl=eval_impl)
        return opt_state, deno, losses

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
    solve on the worker's stream.

    Spans (``utils.profiling``), each with the solve's index as its id: on
    the worker's thread ``flow.solve``, around ``flow.prep`` (the frames
    scaled and uploaded), ``flow.record`` (the first solve on a card),
    ``flow.replay`` (the graph's replay, the flow's copy, the event) and
    ``flow.wait`` (the worker waiting for its stream); on the caller's
    ``flow.result``, in ``get``."""

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

    def _work(self, i, cur_np, prev_np):
        with annotate("flow.solve", i):
            return self._solve_one(cur_np, prev_np)

    def _solve_one(self, cur_np, prev_np):
        t0 = time.perf_counter()
        if not self._cuda:
            with annotate("flow.prep"):
                cur = np.asarray(cur_np)[..., 0] * 255.0
                prev = np.asarray(prev_np)[..., 0] * 255.0
            flow = self._solve(cur, prev)
            self.solve_times.append(time.perf_counter() - t0)
            return flow, None
        # the current device and the current stream are per thread
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            with annotate("flow.prep"):
                cur = np.asarray(cur_np)[..., 0] * 255.0
                prev = np.asarray(prev_np)[..., 0] * 255.0
                if self._graph is None:
                    self._frames = torch.empty(2, *cur.shape,
                                               dtype=torch.float32,
                                               device=self.device)
                self._frames[0].copy_(torch.from_numpy(cur))
                self._frames[1].copy_(torch.from_numpy(prev))
            if self._graph is None:
                with annotate("flow.record"):
                    self._record()
            # every solve runs on the one stream, in order: the replay
            # starts after the solve before it has been copied out
            with annotate("flow.replay"):
                self._graph.replay()
                flow = self._flow.clone()
                done = torch.cuda.Event()
                done.record(self._stream)
            with annotate("flow.wait"):
                self._stream.synchronize()
        self.solve_times.append(time.perf_counter() - t0)
        return flow, done

    def prefetch(self, i, cur_np, prev_np):
        """Schedule flow i (cur -> prev coords) if not already in flight.
        cur_np, prev_np: (H, W, C) frames in [0, 1]; channel 0 is solved."""
        if i not in self._futs:
            self._futs[i] = self._pool.submit(self._work, i, cur_np, prev_np)

    def get(self, i):
        """Flow i as an (H, W, 2) tensor on the solver's device, ordered
        after its solve on the caller's current stream."""
        with annotate("flow.result", i):
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

    Spans (``utils.profiling``): ``process_frame`` is ``online.frame``, its
    id the engine's count of frames, around the step's ``online.warp`` (the
    warp, the occlusion mask and the target), the flat route's
    ``online.prep``, one ``online.iter`` an update (``online.forward``,
    ``online.backward``, ``online.update``) and ``online.denoise``.
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
        self._frames = 0

    def _tensor(self, x):
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def process_frame(self, cur, prev, flow):
        """Fine-tune on (cur, prev, flow) and return (deno, losses): the
        eval-mode denoise of ``cur`` with the updated weights, and the
        ``iters`` losses, one before each update."""
        self._frames += 1
        with annotate("online.frame", self._frames):
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


FLOW_BACKENDS = ("auto", True, "cpu", False, "off", "tpu")


def run_blind_denoising(
    model,
    variables,
    input_tmpl,
    flow_tmpl=None,
    ref_tmpl=None,
    output_tmpl=None,
    output_psnr=None,
    output_network=None,
    first=1,
    last=300,
    iters=20,
    lr=5e-5,
    weight_decay=1e-5,
    residual_model=False,
    compute_flow=False,
    flow_params=None,
    progress=False,
    flow_batch=8,
    flow_backend="auto",
    device=None,
):
    """Streaming blind denoising over a frame sequence, the reference CLI's
    semantics (blind_denoising.py:125-259); counterpart of the JAX package's
    ``run_blind_denoising`` with the same arguments and ``device`` (None:
    the CUDA card, which raises where there is none).

    Frames ``first`` .. ``last`` are read by a pool of two threads, up to
    ``K`` frames ahead. Where ``g++`` is on the PATH
    (``io/native.available``), PGM frames, and PNG frames where the native
    library was built against libpng (``io/native.has_png``), are decoded
    (with their ``.flo`` flows) by the native prefetch ring
    (``io/native.py``), which the pool's threads read from; other frames
    (TIFF; PNG without libpng; every format on a host without ``g++``) by
    the Python readers. A failed build or open of the ring raises; ``results["loader"]`` says which loader ran ("native" or
    "python"). Frame i (from ``first + 1``) is fine-tuned against
    frame i - 1 with flow i (cur -> prev coordinates) and denoised. Flows
    come from ``flow_tmpl`` (``.flo``) unless ``compute_flow`` is set or no
    template is given; then TV-L1 with ``DENOISING_PARAMS`` updated by
    ``flow_params`` solves them on the engine's device: ``flow_backend``
    "auto", True or "cpu" hands them to ``AsyncFlowSolver`` (``K`` = its
    lookahead of 3), which solves ahead on a stream of its own; False,
    "off" or "tpu" solves windows of ``flow_batch`` pairs in line with the
    batched solver (``K = flow_batch``, the tail window padded with its last
    pair). The names follow the JAX package, whose CPU worker and on-device
    solver these are; its ``F2F_ASYNC_FLOW`` variable is not read.

    Writes each denoised frame to ``output_tmpl`` (float TIFF unscaled,
    other formats as 8-bit after clipping), the PSNR against ``ref_tmpl``
    one line a frame to ``output_psnr``, and the engine's parameters,
    optimizer state and running statistics to ``output_network`` (flax
    msgpack, ``models.serialization.save_train_state``). Returns
    ``{"psnr": [...], "loss": [(iters,) arrays], "frames": [...],
    "loader": ...}``."""
    from ..flow.tvl1 import DENOISING_PARAMS, make_batched_tvl1, \
        make_tvl1_solver
    from ..io.flo import read_flo
    from ..io import native as native_io
    from ..io.image import is_pgm, is_tiff, read_frame, write_gray
    from ..models.dncnn import opt_state_to_jax
    from ..models.serialization import save_train_state
    from ..utils.metrics import psnr as psnr_fn

    if flow_backend not in FLOW_BACKENDS:
        raise ValueError(f"flow_backend must be one of {FLOW_BACKENDS}, got "
                         f"{flow_backend!r}")
    engine = OnlineDenoiser(model, variables, lr=lr,
                            weight_decay=weight_decay, iters=iters,
                            residual_model=residual_model, device=device)
    dev = engine.device

    compute = compute_flow or flow_tmpl is None
    async_flow = solver = None
    if compute:
        H, W = read_frame(input_tmpl, first).shape[:2]
        kw = dict(DENOISING_PARAMS)
        kw.update(flow_params or {})
        if flow_backend in ("auto", True, "cpu"):
            async_flow = AsyncFlowSolver(W, H, kw, device=dev)
            K = async_flow.lookahead
        else:
            K = flow_batch = max(1, min(flow_batch, last - first))
            solver = (make_batched_tvl1 if flow_batch > 1
                      else make_tvl1_solver)(W, H, device=dev, **kw)
    else:
        K = 1

    def load(i):
        """Frame i in [0, 1] as (H, W, 1) f32, and flow i when it is read
        from a file (frames from first + 1 on have one,
        blind_denoising.py:206)."""
        arr = np.asarray(read_frame(input_tmpl, i), dtype=np.float32)
        if arr.ndim == 2:
            arr = arr[..., None]
        # every frame is divided by 255, tiff included
        # (blind_denoising.py:177-180,198-201)
        arr = arr / 255.0
        flow = None
        if i > first and not compute:
            flow = read_flo(flow_tmpl % i).astype(np.float32)
        return arr, flow

    def path(i):
        return input_tmpl % i if "%" in input_tmpl else input_tmpl

    ring = None
    if native_io.available() and (
            is_pgm(path(first)) or (path(first).lower().endswith(".png")
                                    and native_io.has_png())):
        ring = native_io.NativePrefetcher(
            [path(i) for i in range(first, last + 1)],
            [None] + [None if compute else flow_tmpl % i
                      for i in range(first + 1, last + 1)],
            capacity=4, nthreads=2)

    def load_ring(i):
        """``load``'s frame and flow, decoded by the ring."""
        frame, flow = ring.get(i - first)
        return frame[..., None] / np.float32(255.0), flow

    pool = ThreadPoolExecutor(max_workers=2)
    futures, frames = {}, {}
    flow_cache = {}

    def ensure(j):
        if first <= j <= last and j not in futures and j not in frames:
            futures[j] = pool.submit(load if ring is None else load_ring, j)

    def frame(j):
        """(tensor on the device, flow read from its file, host array)."""
        if j not in frames:
            arr, fl = futures.pop(j).result()
            frames[j] = (torch.from_numpy(arr).to(dev), fl, arr)
        return frames[j]

    def flow_for(i):
        if not compute:
            return torch.from_numpy(frame(i)[1]).to(dev)
        if async_flow is not None:
            for j in range(i, min(i + async_flow.lookahead, last) + 1):
                ensure(j)
                async_flow.prefetch(j, frame(j)[2], frame(j - 1)[2])
            return async_flow.get(i)
        if i not in flow_cache:
            idx = list(range(i, min(i + K - 1, last) + 1))
            if K > 1:
                pad = idx + [idx[-1]] * (K - len(idx))
                cur = torch.stack([frame(j)[0][..., 0] for j in pad]) * 255.0
                prev = torch.stack([frame(j - 1)[0][..., 0]
                                    for j in pad]) * 255.0
                flows = solver(cur, prev)
                for k, j in enumerate(idx):
                    flow_cache[j] = flows[k]
            else:
                c, p = frame(i)[0], frame(i - 1)[0]
                flow_cache[i] = solver(c[..., 0] * 255.0, p[..., 0] * 255.0)
        return flow_cache.pop(i)

    results = {"psnr": [], "loss": [], "frames": [],
               "loader": "python" if ring is None else "native"}
    psnr_lines = []
    try:
        for j in range(first, min(first + K, last) + 1):
            ensure(j)
        for i in range(first + 1, last + 1):
            for j in range(i + 1, min(i + K, last) + 1):
                ensure(j)
            cur, prev = frame(i)[0], frame(i - 1)[0]
            flow = flow_for(i)
            frames.pop(i - 1, None)  # consumed: i - 1 is never needed again
            deno, losses = engine.process_frame(cur, prev, flow)
            deno_np = deno.cpu().numpy()
            results["loss"].append(losses.cpu().numpy())
            results["frames"].append(i)
            if output_tmpl:
                out_path = output_tmpl % i
                img = deno_np.squeeze()
                write_gray(out_path, 255.0 * (img if is_tiff(out_path)
                                              else np.clip(img, 0.0, 1.0)))
            if ref_tmpl:
                ref = np.asarray(read_frame(ref_tmpl, i),
                                 dtype=np.float64) / 255.0
                quant = psnr_fn(ref, deno_np)
                results["psnr"].append(quant)
                psnr_lines.append(str(quant) + "\n")
                if progress:
                    print(i, quant)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
        if async_flow is not None:
            async_flow.close()
        if ring is not None:
            ring.close()

    if output_psnr and psnr_lines:
        with open(output_psnr, "w") as f:
            f.writelines(psnr_lines)
    if output_network:
        v = engine.variables
        save_train_state(output_network, v["params"],
                         opt_state_to_jax(engine.opt_state), v["batch_stats"])
    return results
