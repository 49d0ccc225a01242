"""TV-L1 optical flow (Zach, Pock, Bischof; the dual formulation of
Sanchez, Meinhardt-Llopis, Facciolo, IPOL 2013, ``tvl1flow``), multiscale, a
frozen copy in plain PyTorch ops with the reference C solver's semantics:

- joint min-max normalisation of the pair to [0, 255], a Gaussian
  presmoothing (sigma 0.8) and a pyramid of zoom factor ``zfactor`` whose
  coarsest level keeps 16 px (``tvl1flow_lib.c``, ``main.c``);
- at each solved scale ``warps`` bicubic warps (Keys, Neumann boundary,
  samples flagged out where a tap clamps) and, for each, the primal-dual
  inner loop until the mean squared update falls to ``epsilon**2`` or
  ``max_iters`` iterations (``tvl1flow_lib.c:170-256``), the error summed in
  float64; scales finer than ``fscale`` are reached by upsampling only;
- gradients and divergence with the solver's border rules (``mask.c``).

``solve(I0, I1, dtype=torch.float32)`` takes (H, W) images in [0, 255] and
returns the (H, W, 2) flow from I0 to I1's coordinates. ``dtype`` is the
arithmetic: float32 for the reference, bfloat16 for its control.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

GRAD_IS_ZERO = 1e-10
PRESMOOTHING_SIGMA = 0.8
ZOOM_SIGMA_ZERO = 0.6
MAX_ITERATIONS = 300
# the denoising pipeline's parameters (tvl1flow.sh)
DENOISING_PARAMS = dict(tau=0.25, lambda_=0.2, theta=0.3, nscales=100,
                        fscale=2, zfactor=0.5, warps=5, epsilon=0.01)


@lru_cache(maxsize=64)
def gaussian_kernel(sigma: float):
    """Half-kernel B[0..size-1] (mask.c:243-255) as numpy float64."""
    size = int(5 * sigma) + 1
    i = np.arange(size, dtype=np.float64)
    B = np.exp(-(i * i) / (2.0 * sigma * sigma)) / (sigma * np.sqrt(2.0 * np.pi))
    norm = 2.0 * B.sum() - B[0]
    return B / norm


def _reflect_pad_1d(x, m, axis):
    """Pad ``axis`` by ``m`` on both sides with the solver's asymmetric
    reflecting boundary."""
    if m == 0:
        return x
    n = x.shape[axis]
    # left: positions -1..-m hold I[1]..I[m] (mirror about 0, edge excluded)
    left = x.narrow(axis, 1, m).flip(axis)
    # right: positions n..n+m-1 hold I[n-1]..I[n-m] (mirror with the edge)
    right = x.narrow(axis, n - m, m).flip(axis)
    return torch.cat([left, x, right], dim=axis)


def _conv_sym_1d(x, B, axis):
    """out[i] = B[0] * x[i] + sum_j B[j] * (x[i-j] + x[i+j]), j = 1..size-1,
    added in that order; ``B`` a sequence of Python floats."""
    size = len(B)
    m = size - 1
    xp = _reflect_pad_1d(x, m, axis)
    n = x.shape[axis]
    out = B[0] * xp.narrow(axis, m, n)
    for j in range(1, size):
        out = out + B[j] * (xp.narrow(axis, m - j, n) + xp.narrow(axis, m + j, n))
    return out


def gaussian_smooth(img, sigma):
    """Separable Gaussian blur of ``(..., H, W)`` tensors; rows then columns.
    The taps are rounded to the image's dtype before they multiply."""
    if sigma <= 0:
        return img
    B = torch.from_numpy(gaussian_kernel(float(sigma))).to(img.dtype).tolist()
    out = _conv_sym_1d(img, B, axis=-1)   # rows pass (along x)
    return _conv_sym_1d(out, B, axis=-2)  # columns pass (along y)


def divergence(v1, v2):
    """Backward-difference divergence (mask.c:43-94): column 0 keeps v1,
    column nx-1 contributes -v1[..., nx-2]; the same for the rows of v2."""
    dx = torch.cat([v1[..., :, :1], v1[..., :, 1:-1] - v1[..., :, :-2],
                    -v1[..., :, -2:-1]], dim=-1)
    dy = torch.cat([v2[..., :1, :], v2[..., 1:-1, :] - v2[..., :-2, :],
                    -v2[..., -2:-1, :]], dim=-2)
    return dx + dy


def forward_gradient(f):
    """Forward differences with a zero last column (fx) and last row (fy)
    (mask.c:103-148)."""
    fx = torch.cat([f[..., :, 1:] - f[..., :, :-1],
                    torch.zeros_like(f[..., :, :1])], dim=-1)
    fy = torch.cat([f[..., 1:, :] - f[..., :-1, :],
                    torch.zeros_like(f[..., :1, :])], dim=-2)
    return fx, fy


def centered_gradient(f):
    """Centered differences with one-sided halves at the borders
    (mask.c:156-215): half the central difference of the edge-replicated
    image."""
    fpx = torch.cat([f[..., :, :1], f, f[..., :, -1:]], dim=-1)
    fpy = torch.cat([f[..., :1, :], f, f[..., -1:, :]], dim=-2)
    dx = 0.5 * (fpx[..., :, 2:] - fpx[..., :, :-2])
    dy = 0.5 * (fpy[..., 2:, :] - fpy[..., :-2, :])
    return dx, dy


def _cubic(v0, v1, v2, v3, t):
    """Keys cubic kernel, as bicubic_interpolation.c:102-110."""
    return v1 + 0.5 * t * (
        v2 - v0 + t * (2.0 * v0 - 5.0 * v1 + 4.0 * v2 - v3
                       + t * (3.0 * (v1 - v2) + v3 - v0))
    )


def bicubic_at(img, uu, vv, border_out):
    """Bicubic samples of ``img`` (..., H, W) at the positions (uu, vv): uu is
    the x (column) coordinate, vv the y (row) coordinate. Their broadcast
    shape ends in the two sample axes; any leading axes broadcast against
    ``img``'s. Returns (..., oy, ox).

    The four taps of an axis ride on a leading axis of 4 and the sixteen
    samples come from one gather: each sample and each cubic is computed as
    it would be tap by tap, in a quarter of the launches."""
    ny, nx = img.shape[-2:]
    dtype = img.dtype
    dev = img.device
    shape = torch.broadcast_shapes(uu.shape, vv.shape, (1, 1))
    uu = uu.to(dtype).expand(shape)
    vv = vv.to(dtype).expand(shape)

    sx = torch.where(uu < 0, -1, 1)
    sy = torch.where(vv < 0, -1, 1)
    x = torch.trunc(uu).long()
    y = torch.trunc(vv).long()

    # made on the device: a host-to-device copy cannot be recorded in a graph
    taps = torch.arange(-1, 3, device=dev).view(4, *([1] * len(shape)))
    xs = x + sx * taps  # x - sx, x, x + sx, x + 2 sx
    # the first y tap uses sx (reference quirk, line 159)
    ys = torch.stack([y - sx, y, y + sy, y + 2 * sy])

    out = (((xs < 0) | (xs >= nx)).any(0) | ((ys < 0) | (ys >= ny)).any(0))
    xc = xs.clamp(0, nx - 1)
    yc = ys.clamp(0, ny - 1)

    lead = torch.broadcast_shapes(img.shape[:-2], shape[:-2])
    full = lead + shape[-2:]
    flat = img.reshape(*img.shape[:-2], ny * nx).expand(*lead, ny * nx)
    # idx[a, b]: x tap a, y tap b
    idx = yc[None, :] * nx + xc[:, None]
    idx = idx.reshape(4, 4, *([1] * (len(full) - len(shape))), *shape)
    idx = idx.expand(4, 4, *full)
    idx = idx.movedim((0, 1), (-2, -1)).reshape(*lead, -1)
    vals = torch.gather(flat, -1, idx).reshape(*full, 4, 4)
    vals = vals.movedim((-2, -1), (0, 1))

    # interpolate along y within each x column, then along x
    fy = vv - y.to(dtype)
    fx = uu - x.to(dtype)
    cols = _cubic(vals[:, 0], vals[:, 1], vals[:, 2], vals[:, 3], fy)
    val = _cubic(cols[0], cols[1], cols[2], cols[3], fx)
    if border_out:
        val = torch.where(out, torch.zeros_like(val), val)
    return val


def bicubic_warp(img, u, v, border_out=True):
    """Dense bicubic warp: ``output[i, j] = img(j + u[i, j], i + v[i, j])``
    (bicubic_interpolation.c:242-266). ``u`` and ``v`` end in (H, W) and
    broadcast against ``img``'s leading axes."""
    ny, nx = img.shape[-2:]
    jj = torch.arange(nx, dtype=img.dtype, device=img.device)[None, :]
    ii = torch.arange(ny, dtype=img.dtype, device=img.device)[:, None]
    return bicubic_at(img, jj + u, ii + v, border_out)


def zoom_size(nx, ny, factor):
    """New size after zooming (zoom.c:24-36): round half up by +0.5 and
    truncation."""
    return int(nx * factor + 0.5), int(ny * factor + 0.5)


def pyramid_shapes(nx, ny, nscales, zfactor):
    """(nx, ny) of every scale, finest first (tvl1flow_lib.c:400-414)."""
    shapes = [(nx, ny)]
    for _ in range(1, nscales):
        nxs, nys = zoom_size(shapes[-1][0], shapes[-1][1], zfactor)
        shapes.append((nxs, nys))
    return shapes


def num_scales(nx, ny, nscales, zfactor):
    """``nscales`` clamped so that the coarsest level keeps 16 px
    (main.c:159-163)."""
    N = 1 + math.log(math.hypot(nx, ny) / 16.0) / math.log(1.0 / zfactor)
    if N < nscales:
        nscales = int(N)
    return max(nscales, 1)


def _positions(n, factor, like):
    """``arange(n) / factor`` in ``like``'s dtype. The factor is rounded to
    that dtype first and the division is a true one, tensor by tensor: a
    Python-scalar divisor may be turned into a multiplication by its
    reciprocal, which moves a position by one bit and can flip a truncation."""
    f = torch.full((), factor, dtype=like.dtype, device=like.device)
    return torch.arange(n, dtype=like.dtype, device=like.device) / f


def zoom_out(img, factor, out_shape):
    """Anti-aliased downsample (zoom.c:43-81): Gaussian, then bicubic
    resampling. ``out_shape`` is (ny_out, nx_out) from :func:`zoom_size`."""
    nyy, nxx = out_shape
    sigma = ZOOM_SIGMA_ZERO * math.sqrt(1.0 / (factor * factor) - 1.0)
    Is = gaussian_smooth(img, sigma)
    j2 = _positions(nxx, factor, img)
    i2 = _positions(nyy, factor, img)
    return bicubic_at(Is, j2[None, :], i2[:, None], border_out=False)


def zoom_in(img, out_shape):
    """Bicubic upsample to an explicit target size (zoom.c:89-115)."""
    ny, nx = img.shape[-2:]
    nyy, nxx = out_shape
    j2 = _positions(nxx, nxx / nx, img)
    i2 = _positions(nyy, nyy / ny, img)
    return bicubic_at(img, j2[None, :], i2[:, None], border_out=False)


def _f32(x):
    """A Python scalar rounded to f32, as a Python float."""
    return float(np.float32(x))


def _scalars(tau, lambda_, theta, epsilon):
    """(l_t, taut, theta, eps2) from Python floats, each rounded to f32 once,
    as a weakly typed scalar meets an f32 array."""
    return (_f32(lambda_ * theta), _f32(tau / theta), _f32(theta),
            _f32(epsilon * epsilon))


def tvl1_inner_loop_plain(I1wx, I1wy, rho_c, grad, u1, u2, p11, p12, p21,
                          p22, tau, lambda_, theta, epsilon, max_iters,
                          return_iterations=False):
    """Plain version of ``tvl1_inner_loop`` on any device: the same function
    in torch ops in the reference's order, a Python ``while`` on the error
    with the ``active`` gate per pair."""
    single = u1.dim() == 2
    if single:
        (I1wx, I1wy, rho_c, grad, u1, u2, p11, p12, p21, p22) = (
            x[None] for x in (I1wx, I1wy, rho_c, grad, u1, u2, p11, p12, p21,
                              p22))
    l_t, taut, theta, eps2 = _scalars(tau, lambda_, theta, epsilon)
    P, ny, nx = u1.shape
    dev = u1.device
    # a tensor divisor: a true division, as the kernel's
    size = torch.full((), float(ny * nx), dtype=torch.float32, device=dev)
    zero_grad = grad < GRAD_IS_ZERO
    safe_grad = torch.where(zero_grad, torch.ones_like(grad), grad)
    below = -l_t * grad
    above = l_t * grad
    n = torch.zeros(P, dtype=torch.int32, device=dev)
    error = torch.full((P,), float("inf"), dtype=torch.float32, device=dev)
    while True:
        active = (error > eps2) & (n < max_iters)
        if not bool(active.any()):
            break
        rho = rho_c + I1wx * u1 + I1wy * u2
        fi = torch.where(zero_grad, torch.zeros_like(rho), -rho / safe_grad)
        lo, hi = rho < below, rho > above
        d1 = torch.where(lo, l_t * I1wx,
                         torch.where(hi, -l_t * I1wx, fi * I1wx))
        d2 = torch.where(lo, l_t * I1wy,
                         torch.where(hi, -l_t * I1wy, fi * I1wy))
        v1 = u1 + d1
        v2 = u2 + d2
        u1n = v1 + theta * divergence(p11, p12)
        u2n = v2 + theta * divergence(p21, p22)
        e1 = u1n - u1
        e2 = u2n - u2
        ssd = ((e1 * e1).sum((-2, -1), dtype=torch.float64)
               + (e2 * e2).sum((-2, -1), dtype=torch.float64))
        err = ssd.to(torch.float32) / size
        u1x, u1y = forward_gradient(u1n)
        u2x, u2y = forward_gradient(u2n)
        ng1 = 1.0 + taut * torch.sqrt(u1x * u1x + u1y * u1y)
        ng2 = 1.0 + taut * torch.sqrt(u2x * u2x + u2y * u2y)
        p11n = (p11 + taut * u1x) / ng1
        p12n = (p12 + taut * u1y) / ng1
        p21n = (p21 + taut * u2x) / ng2
        p22n = (p22 + taut * u2y) / ng2
        gate = active[:, None, None]
        u1, u2, p11, p12, p21, p22 = (
            torch.where(gate, new, old) for new, old in (
                (u1n, u1), (u2n, u2), (p11n, p11), (p12n, p12), (p21n, p21),
                (p22n, p22)))
        n = n + active.to(torch.int32)
        error = torch.where(active, err, error)
    out = (u1, u2, p11, p12, p21, p22)
    if max_iters <= 0:
        out = tuple(x.clone() for x in out)
    if single:
        out = tuple(x[0] for x in out)
    if return_iterations:
        return out, torch.stack([n.to(torch.float32), error], dim=1)
    return out


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


def _scale(I0, I1, u1, u2, tau, lambda_, theta, warps, epsilon, max_iters):
    """One scale's dual TV-L1 solve; p persists across the warps."""
    I1x, I1y = centered_gradient(I1)
    stack = torch.stack([I1, I1x, I1y], dim=-3)
    p11 = p12 = p21 = p22 = torch.zeros_like(I0)
    for _ in range(warps):
        warped = bicubic_warp(stack, u1.unsqueeze(-3), u2.unsqueeze(-3),
                              border_out=True)
        I1w, I1wx, I1wy = warped.unbind(-3)
        grad = I1wx * I1wx + I1wy * I1wy
        rho_c = I1w - I1wx * u1 - I1wy * u2 - I0
        u1, u2, p11, p12, p21, p22 = tvl1_inner_loop_plain(
            I1wx, I1wy, rho_c, grad, u1, u2, p11, p12, p21, p22, tau,
            lambda_, theta, epsilon, max_iters)
    return u1, u2


@torch.no_grad()
def solve(I0, I1, dtype=torch.float32, tau=0.25, lambda_=0.2, theta=0.3,
          nscales=100, fscale=2, zfactor=0.5, warps=5, epsilon=0.01,
          max_iters=MAX_ITERATIONS):
    """The flow (H, W, 2) from ``I0`` to ``I1`` (both (H, W))."""
    I0, I1 = I0.to(dtype), I1.to(dtype)
    ny, nx = I0.shape
    nscales = num_scales(nx, ny, nscales, zfactor)
    fscale = min(fscale, nscales)
    shapes = pyramid_shapes(nx, ny, nscales, zfactor)
    pair = torch.stack(_normalize_pair(I0, I1))
    levels = [gaussian_smooth(pair, PRESMOOTHING_SIGMA)]
    for s in range(1, nscales):
        nxs, nys = shapes[s]
        levels.append(zoom_out(levels[-1], zfactor, (nys, nxs)))
    nxc, nyc = shapes[nscales - 1]
    u1 = torch.zeros(nyc, nxc, dtype=dtype, device=I0.device)
    u2 = torch.zeros_like(u1)
    for s in range(nscales - 1, -1, -1):
        if s >= fscale:
            u1, u2 = _scale(levels[s][0], levels[s][1], u1, u2, tau, lambda_,
                            theta, warps, epsilon, max_iters)
        if s == 0:
            break
        nxf, nyf = shapes[s - 1]
        u1, u2 = zoom_in(torch.stack([u1, u2]), (nyf, nxf)) * (1.0 / zfactor)
    return torch.stack([u1, u2], dim=-1).float()
