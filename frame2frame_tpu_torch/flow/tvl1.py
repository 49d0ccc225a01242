"""TV-L1 optical flow (Zach-Pock-Bischof dual formulation), multiscale.

Counterpart of ``frame2frame_tpu/flow/tvl1.py``, the rebuild of the
reference's CPU solver (tvl1flow/tvl1flow_lib.c):

- the image pyramid has host-computed shapes per level (``pyramid_shapes``);
- the <= 300-iteration primal-dual inner loop (tvl1flow_lib.c:170-256) is one
  kernel launch a warp (``flow/tvl1_inner.py``) on a CUDA tensor and the
  plain PyTorch loop on a CPU tensor: the tensor's device picks, so the JAX
  package's ``inner_impl=`` is not carried over;
- warping uses the exact Keys-bicubic/Neumann sampler (``ops/interp.py``),
  gradients and divergence the exact border-corrected operators
  (``ops/grad.py``); the warps stay plain torch ops;
- a batch of pairs is a leading axis, not a ``vmap``: every op takes
  ``(P, H, W)``, and the inner loop keeps per-pair convergence.

Defaults mirror tvl1flow/main.c:25-35; the denoising pipeline overrides
lambda=0.2, fscale=2 (tvl1flow/tvl1flow.sh:10-18).
"""

from __future__ import annotations

from functools import lru_cache

import torch

from ..ops.gaussian import gaussian_smooth
from ..ops.grad import centered_gradient
from ..ops.interp import bicubic_warp
from ..ops.pyramid import num_scales, pyramid_shapes, zoom_in, zoom_out
from ..utils.device import resolve_device
from .tvl1_inner import tvl1_inner_loop, tvl1_inner_loop_plain

MAX_ITERATIONS = 300
PRESMOOTHING_SIGMA = 0.8


def _normalize_pair(I0, I1):
    """Joint min-max normalisation of both images of a pair to [0, 255]
    (tvl1flow_lib.c:314-348); the minimum and maximum are per pair."""
    mn = torch.minimum(I0.amin((-2, -1), keepdim=True),
                       I1.amin((-2, -1), keepdim=True))
    mx = torch.maximum(I0.amax((-2, -1), keepdim=True),
                       I1.amax((-2, -1), keepdim=True))
    den = mx - mn
    ok = den > 0
    scale = torch.where(ok, 255.0 / torch.where(ok, den, torch.ones_like(den)),
                        torch.ones_like(den))
    off = torch.where(ok, mn, torch.zeros_like(mn))
    return (I0 - off) * scale, (I1 - off) * scale


def _tvl1_scale(I0, I1, u1, u2, tau, lambda_, theta, warps, epsilon,
                max_iters, inner=tvl1_inner_loop, iterations=None):
    """Single-scale dual TV-L1 solve (tvl1flow_lib.c:96-263).

    The dual variables p persist across the ``warps`` fixed-point updates, as
    in the reference (p initialised once per scale, tvl1flow_lib.c:139-143).
    ``inner`` runs the primal-dual loop of one warp; ``iterations``, a list,
    collects each launch's ``(P, 2)`` tensor of iteration counts and errors."""
    I1x, I1y = centered_gradient(I1)
    # I1 and its gradients share every warp's sample positions: one sampling
    # pass over the three, each image's arithmetic as if warped alone
    stack = torch.stack([I1, I1x, I1y], dim=-3)
    p11 = p12 = p21 = p22 = torch.zeros_like(I0)
    for _ in range(warps):  # fixed trip count (nwarps, main.c:33)
        warped = bicubic_warp(stack, u1.unsqueeze(-3), u2.unsqueeze(-3),
                              border_out=True)
        I1w, I1wx, I1wy = warped.unbind(-3)
        grad = I1wx * I1wx + I1wy * I1wy
        rho_c = I1w - I1wx * u1 - I1wy * u2 - I0
        state, stats = inner(I1wx, I1wy, rho_c, grad, u1, u2, p11, p12, p21,
                             p22, tau, lambda_, theta, epsilon, max_iters,
                             return_iterations=True)
        u1, u2, p11, p12, p21, p22 = state
        if iterations is not None:
            iterations.append(stats)
    return u1, u2


@lru_cache(maxsize=32)
def _make_solver(nx, ny, tau, lambda_, theta, nscales, fscale, zfactor, warps,
                 epsilon, max_iters, dtype, device, plain):
    nscales = num_scales(nx, ny, nscales, zfactor)
    fscale = min(fscale, nscales)
    shapes = pyramid_shapes(nx, ny, nscales, zfactor)  # [(nx, ny)] finest first
    inner = tvl1_inner_loop_plain if plain else tvl1_inner_loop

    @torch.no_grad()
    def solve(I0, I1, iterations=None):
        I0 = torch.as_tensor(I0).to(device=device, dtype=dtype)
        I1 = torch.as_tensor(I1).to(device=device, dtype=dtype)
        if I0.shape != I1.shape or I0.shape[-2:] != (ny, nx) or I0.dim() > 3:
            raise ValueError(f"solver for ({ny}, {nx}) frames got "
                             f"{tuple(I0.shape)} and {tuple(I1.shape)}")
        # both images of a pair go through the pyramid as one stack, and
        # both flow components through every zoom: half the launches
        pair = torch.stack(_normalize_pair(I0, I1))
        levels = [gaussian_smooth(pair, PRESMOOTHING_SIGMA)]
        for s in range(1, nscales):
            nxs, nys = shapes[s]
            levels.append(zoom_out(levels[-1], zfactor, (nys, nxs)))

        nxc, nyc = shapes[nscales - 1]
        u1 = torch.zeros(*I0.shape[:-2], nyc, nxc, dtype=dtype, device=device)
        u2 = torch.zeros_like(u1)

        # coarse to fine (tvl1flow_lib.c:421-447); scales finer than fscale
        # are reached by upsampling only (lib.c:449-466)
        for s in range(nscales - 1, -1, -1):
            if s >= fscale:
                u1, u2 = _tvl1_scale(
                    levels[s][0], levels[s][1], u1, u2, tau, lambda_, theta,
                    warps, epsilon, max_iters, inner=inner,
                    iterations=iterations)
            if s == 0:
                break
            nxf, nyf = shapes[s - 1]
            u1, u2 = zoom_in(torch.stack([u1, u2]), (nyf, nxf)) * (1.0 / zfactor)

        return torch.stack([u1, u2], dim=-1)

    return solve


def make_tvl1_solver(nx, ny, tau=0.25, lambda_=0.15, theta=0.3, nscales=100,
                     fscale=0, zfactor=0.5, warps=5, epsilon=0.01,
                     max_iters=MAX_ITERATIONS, dtype=torch.float32,
                     device=None, plain=False):
    """Build a solver ``(I0, I1) -> flow (..., ny, nx, 2)`` for frames of one
    size: ``(ny, nx)`` images give one flow, ``(P, ny, nx)`` a batch of them.
    Images may be numpy arrays or tensors; the flow is a tensor on ``device``.

    ``device``: None means the CUDA card, and raises where there is none;
    ``"cpu"`` solves with the plain version of the inner loop. ``plain=True``
    takes the plain version on any device (what ``chip_smoke.py`` holds the
    kernel solver against on the card). ``solve(I0, I1, iterations=[])``
    collects each inner launch's iteration counts. Solvers are cached per
    size, parameters and device; f32 is the only dtype the inner loop takes.
    """
    return _make_solver(nx, ny, tau, lambda_, theta, nscales, fscale, zfactor,
                        warps, epsilon, max_iters, dtype,
                        resolve_device(device), plain)


def tvl1_flow(I0, I1, device=None, **params):
    """Compute TV-L1 flow from I0 to I1 for a single (H, W) image pair."""
    ny, nx = I0.shape
    return make_tvl1_solver(nx, ny, device=device, **params)(I0, I1)


# parameters used by the reference denoising pipeline (tvl1flow.sh:10-18)
DENOISING_PARAMS = dict(tau=0.25, lambda_=0.2, theta=0.3, nscales=100, fscale=2,
                        zfactor=0.5, warps=5, epsilon=0.01)


def make_batched_tvl1(nx, ny, device=None, **params):
    """Solver over a leading pair axis: (P, ny, nx) x2 -> (P, ny, nx, 2)."""
    base = make_tvl1_solver(nx, ny, device=device, **params)

    def solve(I0, I1, iterations=None):
        if len(I0.shape) != 3:
            raise ValueError(f"expected (P, {ny}, {nx}), got {tuple(I0.shape)}")
        return base(I0, I1, iterations=iterations)

    return solve
