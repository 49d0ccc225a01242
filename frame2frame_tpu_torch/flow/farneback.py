"""Farneback polynomial-expansion optical flow (the ``ftype="cv2"`` estimator).

Counterpart of ``frame2frame_tpu/flow/farneback.py`` (Farneback 2003,
"Two-frame motion estimation based on polynomial expansion"), the algorithm
family behind OpenCV's ``calcOpticalFlowFarneback``, which the reference
runs for ``ftype="cv2"``:

1. polynomial expansion: each neighbourhood of a frame is fit as
   ``f(x + d) ~ c + b.d + d^T A d`` by Gaussian-weighted least squares, six
   separable correlations with zero padding and a ``G^-1`` combination that
   depends only on ``(poly_n, poly_sigma)`` (host numpy, float64);
2. displacement: with the prior flow d0, ``A = (A1(x) + A2(x + d0)) / 2``
   and ``db = -(b2(x + d0) - b1(x)) / 2 + A d0``; the normal equations of
   ``A d = db`` are Gaussian-averaged over ``winsize`` and solved in closed
   form per pixel, ``iterations`` times a level;
3. coarse to fine over a ``pyr_scale`` pyramid of the TV-L1 zooms, the flow
   zoomed in and rescaled between levels.

Plain tensor ops on the frames' device, on the port's ``ops/gaussian.py``,
``ops/pyramid.py`` and ``ops/warp.py``: the JAX package has no TPU kernel
behind this module either. A batch of pairs is a leading axis written out;
only the bilinear warp, which takes one (H, W, C) image, runs pair by pair.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.gaussian import gaussian_smooth
from ..ops.pyramid import pyramid_shapes, zoom_in, zoom_out
from ..ops.warp import bilinear_warp_with_mask
from ..utils.device import resolve_device

DEFAULT_PARAMS = dict(pyr_scale=0.5, levels=5, winsize=15, iterations=3,
                      poly_n=5, poly_sigma=1.2)


def _poly_inv(poly_n, poly_sigma):
    """Host-side G^-1 for the basis [1, x, y, x^2, y^2, xy] under the
    separable Gaussian applicability on the (2n+1)^2 window, float64."""
    x = np.arange(-poly_n, poly_n + 1, dtype=np.float64)
    g = np.exp(-(x * x) / (2.0 * poly_sigma * poly_sigma))
    xx, yy = np.meshgrid(x, x, indexing="xy")  # rows = y, cols = x
    w = np.outer(g, g)
    basis = np.stack([np.ones_like(xx), xx, yy, xx * xx, yy * yy, xx * yy])
    G = np.einsum("iyx,jyx,yx->ij", basis, basis, w)
    return np.linalg.inv(G)


def _poly_expand(f, poly_n, poly_sigma, g_inv):
    """Quadratic expansion of (..., H, W) frames.

    Returns (A11, A12, A22, b1, b2): f(p + d) ~ c + b.d + d^T A d with
    d = (dx, dy), per pixel p."""
    x = torch.arange(-poly_n, poly_n + 1, dtype=f.dtype, device=f.device)
    g = torch.exp(-(x * x) / (2.0 * poly_sigma * poly_sigma))
    k0, k1, k2 = g, x * g, x * x * g
    n = poly_n
    H, W = f.shape[-2:]

    def corr(img, ky, kx):
        """Separable correlation with zero padding (the window shrinks off
        the border as OpenCV's BORDER_CONSTANT variant would); taps added in
        rising order, as the JAX function adds them."""
        pad = F.pad(img, (0, 0, n, n))
        out = 0
        for i in range(2 * n + 1):
            out = out + pad[..., i:i + H, :] * ky[i]
        pad = F.pad(out, (n, n))
        out = 0
        for i in range(2 * n + 1):
            out = out + pad[..., i:i + W] * kx[i]
        return out

    # moments m_pq = sum w * x^p y^q * f(shifted): the basis evaluated at the
    # neighbour's offset, so the kernels are the basis itself
    m = torch.stack([corr(f, k0, k0), corr(f, k0, k1), corr(f, k1, k0),
                     corr(f, k0, k2), corr(f, k2, k0), corr(f, k1, k1)])
    gi = torch.as_tensor(g_inv, dtype=f.dtype, device=f.device)
    coef = torch.einsum("ij,j...->i...", gi, m)
    c_x, c_y, c_xx, c_yy, c_xy = coef[1], coef[2], coef[3], coef[4], coef[5]
    return c_xx, 0.5 * c_xy, c_yy, c_x, c_y


def _warp(e2_stack, d0):
    """Frame 2's stacked expansion (..., H, W, 5) sampled at x + d0, one
    pair at a time."""
    if e2_stack.dim() == 3:
        return bilinear_warp_with_mask(e2_stack, d0)[0]
    return torch.stack([bilinear_warp_with_mask(e, d)[0]
                        for e, d in zip(e2_stack, d0)])


def _solve_level(e1, e2, flow, winsize, iterations):
    """Refine ``flow`` (frame-1 coordinates to frame-2 positions) at one
    pyramid level from both frames' expansions (each a 5-tuple of maps)."""
    H, W = e1[0].shape[-2:]
    dtype, device = e1[0].dtype, e1[0].device
    sigma = 0.3 * ((winsize - 1) * 0.5 - 1) + 0.8  # cv2's getGaussianKernel rule
    a11_1, a12_1, a22_1, b1_1, b2_1 = e1
    e2_stack = torch.stack(e2, dim=-1)  # (..., H, W, 5)
    xx = torch.arange(W, dtype=dtype, device=device)[None, :]
    yy = torch.arange(H, dtype=dtype, device=device)[:, None]

    for _ in range(iterations):
        # sample frame 2's expansion at x + flow, the target clamped into the
        # image first so that every bilinear sample is whole (cv2 clamps to
        # the border the same way)
        fx = torch.clamp(xx + flow[..., 0], 0.0, W - 1.0) - xx
        fy = torch.clamp(yy + flow[..., 1], 0.0, H - 1.0) - yy
        d0 = torch.stack([fx, fy], dim=-1)
        w2 = _warp(e2_stack, d0)
        a11 = 0.5 * (a11_1 + w2[..., 0])
        a12 = 0.5 * (a12_1 + w2[..., 1])
        a22 = 0.5 * (a22_1 + w2[..., 2])
        db1 = -0.5 * (w2[..., 3] - b1_1) + a11 * d0[..., 0] + a12 * d0[..., 1]
        db2 = -0.5 * (w2[..., 4] - b2_1) + a12 * d0[..., 0] + a22 * d0[..., 1]

        # Gaussian-averaged normal equations of A d = db over the window
        g11 = gaussian_smooth(a11 * a11 + a12 * a12, sigma)
        g12 = gaussian_smooth(a11 * a12 + a12 * a22, sigma)
        g22 = gaussian_smooth(a12 * a12 + a22 * a22, sigma)
        h1 = gaussian_smooth(a11 * db1 + a12 * db2, sigma)
        h2 = gaussian_smooth(a12 * db1 + a22 * db2, sigma)
        det = g11 * g22 - g12 * g12
        det = torch.where(det.abs() < 1e-9, torch.full_like(det, 1e-9), det)
        flow = torch.stack([(g22 * h1 - g12 * h2) / det,
                            (g11 * h2 - g12 * h1) / det], dim=-1)
    return flow


@lru_cache(maxsize=32)
def _make_solver(nx, ny, pyr_scale, levels, winsize, iterations, poly_n,
                 poly_sigma, dtype, device):
    shapes = [(nx, ny)]
    for _ in range(1, levels):
        nxs, nys = pyramid_shapes(shapes[-1][0], shapes[-1][1], 2,
                                  pyr_scale)[1]
        if min(nxs, nys) < 2 * poly_n + 1:
            break
        shapes.append((nxs, nys))
    g_inv = _poly_inv(poly_n, poly_sigma)

    @torch.no_grad()
    def solve(I0, I1):
        I0 = torch.as_tensor(I0).to(device=device, dtype=dtype)
        I1 = torch.as_tensor(I1).to(device=device, dtype=dtype)
        if I0.shape != I1.shape or I0.shape[-2:] != (ny, nx) or I0.dim() > 3:
            raise ValueError(f"solver for ({ny}, {nx}) frames got "
                             f"{tuple(I0.shape)} and {tuple(I1.shape)}")
        # joint range normalisation of each pair, as the TV-L1 front end
        # (tvl1flow_lib.c:314-348): matching that ignores the scale
        lo = torch.minimum(I0.amin((-2, -1), keepdim=True),
                           I1.amin((-2, -1), keepdim=True))
        hi = torch.maximum(I0.amax((-2, -1), keepdim=True),
                           I1.amax((-2, -1), keepdim=True))
        den = torch.clamp(hi - lo, min=1e-6)
        I0 = 255.0 * (I0 - lo) / den
        I1 = 255.0 * (I1 - lo) / den

        pyr = [(I0, I1)]
        for s in range(1, len(shapes)):
            nxs, nys = shapes[s]
            p0, p1 = pyr[-1]
            pyr.append((zoom_out(p0, pyr_scale, (nys, nxs)),
                        zoom_out(p1, pyr_scale, (nys, nxs))))

        nxs, nys = shapes[-1]
        flow = torch.zeros(*I0.shape[:-2], nys, nxs, 2, dtype=dtype,
                           device=device)
        for s in range(len(shapes) - 1, -1, -1):
            p0, p1 = pyr[s]
            if s != len(shapes) - 1:
                nxs, nys = shapes[s]
                flow = torch.stack(
                    [zoom_in(flow[..., 0], (nys, nxs)) * (nxs / shapes[s + 1][0]),
                     zoom_in(flow[..., 1], (nys, nxs)) * (nys / shapes[s + 1][1])],
                    dim=-1)
            e0 = _poly_expand(p0, poly_n, poly_sigma, g_inv)
            e1 = _poly_expand(p1, poly_n, poly_sigma, g_inv)
            flow = _solve_level(e0, e1, flow, winsize, iterations)
        return flow

    return solve


def make_farneback_solver(nx, ny, pyr_scale=0.5, levels=5, winsize=15,
                          iterations=3, poly_n=5, poly_sigma=1.2,
                          dtype=torch.float32, device=None):
    """Build a solver ``(I0, I1) -> flow (ny, nx, 2)``: the flow maps I0
    coordinates to I1 positions (I0(p) ~ I1(p + flow(p)), the convention of
    ``make_tvl1_solver``). Parameter names and defaults follow
    ``cv2.calcOpticalFlowFarneback``; the levels are clamped so that the
    coarsest keeps at least 2 * poly_n + 1 pixels on both axes. Images may be
    numpy arrays or tensors; ``(P, ny, nx)`` images give a batch of flows.

    ``device``: None means the CUDA card, and raises where there is none;
    the CPU runs only when the caller names it. Solvers are cached per size,
    parameters and device."""
    return _make_solver(nx, ny, pyr_scale, levels, winsize, iterations,
                        poly_n, poly_sigma, dtype, resolve_device(device))


def make_batched_farneback(nx, ny, device=None, **params):
    """Solver over a leading pair axis: (P, ny, nx) x2 -> (P, ny, nx, 2)."""
    base = make_farneback_solver(nx, ny, device=device, **params)

    def solve(I0, I1):
        if len(I0.shape) != 3:
            raise ValueError(f"expected (P, {ny}, {nx}), got {tuple(I0.shape)}")
        return base(I0, I1)

    return solve


def fb_params(params):
    """The Farneback parameters of a mixed keyword dict (known keys only):
    TV-L1's keys (tau, lambda_, ...) are left out, so that the two
    estimators can share one call site."""
    keys = ("pyr_scale", "levels", "winsize", "iterations", "poly_n",
            "poly_sigma")
    return {k: params[k] for k in keys if k in params}
