"""The TV-L1 primal-dual inner loop: one CUDA kernel for Hopper
(``csrc/tvl1_inner.cu``) and its plain PyTorch version.

Counterpart of ``frame2frame_tpu/flow/tvl1_pallas.py``: ``tvl1_inner_loop``
runs the loop of one warp of one scale to convergence (tvl1flow_lib.c:170-256).
With ``rho_c``, ``I1wx``, ``I1wy`` and ``grad`` fixed, while ``err > epsilon^2``
and ``n < max_iters``:

- thresholding: ``rho = rho_c + I1wx u1 + I1wy u2`` and ``v = u + d`` with
  ``d = l_t I1w`` where ``rho < -l_t grad``, ``-l_t I1w`` where ``rho > l_t
  grad``, else ``-rho / grad I1w`` (0 where ``grad < 1e-10``), ``l_t = lambda
  theta``;
- primal: ``u' = v + theta div(p)`` and ``err = (sum (u1' - u1)^2 + sum (u2' -
  u2)^2) / size``;
- dual: ``p' = (p + taut grad(u')) / (1 + taut |grad(u')|)``, ``taut = tau /
  theta``.

Arrays are ``(ny, nx)`` for one pair or ``(P, ny, nx)`` for a batch, f32 only.
A batch keeps per-pair convergence: each pair has its own ``n`` and ``err``, a
pair that has stopped no longer changes, and the loop ends when none is
active. A pair's result does not depend on what else is in the batch.

The TPU kernel holds all state in VMEM and therefore asks whether a scale
fits (``vmem_fits``). The port's kernel has two bodies and takes every size:
``cluster_plan(ny, nx)``, a function of the shape alone, gives the cluster
body (a pair's state in the shared memory of one thread-block cluster of up
to 16 blocks) for levels of up to 144 tiles of 8 x 32 (every solved level
of a 540p flow with the denoising parameters), and ``None`` for larger
ones, which take the cooperative body (state in global memory, one grid
barrier an iteration). Both give the same bits. The kernel returns each
pair's iteration count and last error, which the TPU kernel drops
(``return_iterations=True``; a device tensor, reading it is the caller's
synchronisation).

The error is summed in double and then rounded to f32, in the kernel and
here, where the reference sums in f32: the order of the additions, which
differs between the two, then leaves the f32 error and with it every stop
decision unchanged (but for a double rounding that falls on an f32 tie).
Every other operation is the reference's, in its order, each rounded to f32.

A wrapper given a CPU tensor computes the plain version; given a CUDA tensor
it launches the kernel or raises. ``tvl1_inner_loop.launches`` counts the
launches the wrapper makes, here and nowhere else (a launch recorded into a
CUDA graph is not one, and neither is its replay);
``ops/fused_stack.py`` keeps the registry.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..ops._build import load
from ..ops._common import _bind_error_string, _on_current_cuda, _raise_on
from ..ops.grad import divergence, forward_gradient

GRAD_IS_ZERO = 1e-10
MAX_PAIRS = 512  # pairs a launch (csrc/tvl1_inner.cu MAXP)
TILE_H, TILE_W = 8, 32
# the cluster body (csrc/tvl1_inner.cu): at most 16 blocks a cluster and 9
# tiles a block (one to three pixels a thread); shared memory of a block:
# six f32 state planes of 9 tiles with a row and a column of halo each, 64
# bytes, two doubles for each tile of the cluster (the partials) and eight
# for each of the block's tiles (its row sums)
MAX_CLUSTER = 16
MAX_TILES_PER_BLOCK = 9
STATE_SMEM = 6 * MAX_TILES_PER_BLOCK * (TILE_H * TILE_W + TILE_H + TILE_W) * 4
HEAD_SMEM = 64
NAMES = ("I1wx", "I1wy", "rho_c", "grad", "u1", "u2", "p11", "p12", "p21",
         "p22")


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


def cluster_plan(ny, nx):
    """The cluster body's layout for an ``(ny, nx)`` level: ``(blocks,
    tiles_per_block, smem_bytes)``, or ``None`` for a level of more than
    144 tiles, which takes the cooperative body.

    The level is cut into 8 x 32 tiles in raster order; block ``b`` of the
    cluster owns the tiles ``[b * tiles_per_block, (b + 1) *
    tiles_per_block)``. A level of up to 4 tiles is one block, a pixel a
    thread, which exchanges nothing; a larger one is spread over as many
    blocks as the cluster takes (16), with the fewest tiles each. Whole
    tiles in raster order, not bands of whole tile rows: 135 x 240 has 17
    tile rows, which 16 blocks take no finer than two rows (16 tiles) a
    block, where a raster split gives each at most 9. (Measured on an H100,
    ``chip_smoke.py``: an iteration costs 1.4 us in one block at 9 x 15,
    1.5 us on 10 blocks at 34 x 60, 2.1 us on 12 blocks of 3 tiles at
    68 x 120 and 4.2 us on 16 blocks of 9 at 135 x 240, where the
    cooperative body takes 4.5-5.5 us at every level.)"""
    tiles = -(-ny // TILE_H) * -(-nx // TILE_W)
    if tiles <= 4:
        return 1, tiles, cluster_smem(1, tiles)
    per = -(-tiles // MAX_CLUSTER)
    if per > MAX_TILES_PER_BLOCK:
        return None
    blocks = -(-tiles // per)
    return blocks, per, cluster_smem(blocks, per)


def cluster_smem(blocks, tiles_per_block):
    """Bytes of shared memory a block of the cluster body takes (as
    ``f2f_tvl1_cluster`` reckons it)."""
    return (STATE_SMEM + HEAD_SMEM + 16 * blocks * tiles_per_block
            + 8 * TILE_H * tiles_per_block)


@functools.cache
def _lib():
    lib = load("tvl1_inner")
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.f2f_tvl1_inner.argtypes = ([vp] * 6 + [ci] * 3 + [cf] * 4 + [ci, vp])
    lib.f2f_tvl1_cluster.argtypes = ([vp] * 4 + [ci] * 5 + [cf] * 4
                                     + [ci, vp])
    lib.f2f_tvl1_inner_blocks.argtypes = [ci] * 3
    lib.f2f_tvl1_barrier_probe.argtypes = [ci, ci, vp]
    lib.f2f_tvl1_cluster_probe.argtypes = [ci, ci, ci, vp]
    lib.f2f_tvl1_cluster_check.argtypes = [ci, ci]
    lib.f2f_tvl1_cluster_probe_check.argtypes = [ci, ci]
    for fn in (lib.f2f_tvl1_inner, lib.f2f_tvl1_cluster,
               lib.f2f_tvl1_inner_blocks, lib.f2f_tvl1_barrier_probe,
               lib.f2f_tvl1_cluster_probe, lib.f2f_tvl1_cluster_check,
               lib.f2f_tvl1_cluster_probe_check):
        fn.restype = ci
    _bind_error_string(lib)
    return lib


@functools.cache
def _cluster_taken(check, device, *shape):
    """Raise unless the current device, ``device``, takes the cluster that
    ``check`` (``f2f_tvl1_cluster_check`` or ``..._probe_check``) asks about
    for ``shape``; asked once a device and shape, before its first launch.
    A refusal is not cached: it raises again on the next launch."""
    lib = _lib()
    _raise_on(lib, "tvl1_inner_loop", getattr(lib, check)(*shape))


def _pointers(tensors):
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def tvl1_inner_loop(I1wx, I1wy, rho_c, grad, u1, u2, p11, p12, p21, p22,
                    tau, lambda_, theta, epsilon, max_iters,
                    return_iterations=False):
    """Run the primal-dual iteration to convergence, one launch.

    The ten arrays are ``(ny, nx)`` or ``(P, ny, nx)`` f32 on one device; the
    scalars are Python numbers. Returns new ``(u1, u2, p11, p12, p21, p22)``
    (the inputs are not written), and with ``return_iterations`` also a
    ``(P, 2)`` f32 tensor of each pair's iterations run and last error. The
    error sum is reduced in a fixed order: the same inputs give the same
    bits, whatever else is in the batch and whichever body runs. The body is
    the one ``cluster_plan`` gives the shape: the cluster body for a plan,
    the cooperative body for ``None``."""
    name = "tvl1_inner_loop"
    arrays = (I1wx, I1wy, rho_c, grad, u1, u2, p11, p12, p21, p22)
    if u1.dim() not in (2, 3) or not u1.numel():
        raise ValueError(f"{name}: expected (ny, nx) or (P, ny, nx) arrays, "
                         f"got {tuple(u1.shape)}")
    for key, x in zip(NAMES, arrays):
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: f32 only, {key} is {x.dtype}")
        if x.shape != u1.shape or x.device != u1.device:
            raise ValueError(f"{name}: {key} must be {tuple(u1.shape)} on "
                             f"{u1.device}, got {tuple(x.shape)} on {x.device}")
    if u1.device.type == "cpu":
        return tvl1_inner_loop_plain(*arrays, tau, lambda_, theta, epsilon,
                                     max_iters, return_iterations)
    _on_current_cuda(name, u1)
    lib = _lib()
    dev = u1.device
    single = u1.dim() == 2
    arrays = [x[None] if single else x for x in arrays]
    arrays = [x.contiguous() for x in arrays]
    P, ny, nx = arrays[0].shape
    l_t, taut, theta, eps2 = _scalars(tau, lambda_, theta, epsilon)
    tiles = -(-ny // TILE_H) * -(-nx // TILE_W)
    plan = cluster_plan(ny, nx)
    out = torch.empty(6, P, ny, nx, dtype=torch.float32, device=dev)
    tmp = None if plan else torch.empty_like(out)
    stats = torch.empty(P, 2, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    # more pairs than a launch takes go in chunks; a pair's result does not
    # depend on its chunk
    for lo in range(0, P, MAX_PAIRS):
        hi = min(lo + MAX_PAIRS, P)
        fixed = _pointers([x[lo:hi] for x in arrays[:4]])
        state = _pointers([x[lo:hi] for x in arrays[4:]])
        outs = _pointers([out[k, lo:hi] for k in range(6)])
        if plan:
            blocks, per, _ = plan
            _cluster_taken("f2f_tvl1_cluster_check", dev.index, blocks, per)
            rc = lib.f2f_tvl1_cluster(
                fixed, state, outs, stats[lo:hi].data_ptr(), hi - lo, ny, nx,
                blocks, per, l_t, taut, theta, eps2, int(max_iters), stream)
        else:
            partial = torch.empty(2, hi - lo, tiles, dtype=torch.float64,
                                  device=dev)
            rc = lib.f2f_tvl1_inner(
                fixed, state, outs,
                _pointers([tmp[k, lo:hi] for k in range(6)]),
                partial.data_ptr(), stats[lo:hi].data_ptr(), hi - lo, ny, nx,
                l_t, taut, theta, eps2, int(max_iters), stream)
        _raise_on(lib, name, rc)
        # a stream that records a CUDA graph takes the launch down and runs
        # nothing: only a launch that runs is counted
        if not torch.cuda.is_current_stream_capturing():
            tvl1_inner_loop.launches += 1
    res = tuple(out[k, 0] if single else out[k] for k in range(6))
    return (res, stats) if return_iterations else res


tvl1_inner_loop.launches = 0


def launch_blocks(P, ny, nx):
    """Blocks that a launch of the cooperative body for ``P`` pairs of
    ``(ny, nx)`` takes on the current CUDA device."""
    return _lib().f2f_tvl1_inner_blocks(P, ny, nx)


def cluster_threads(tiles_per_block):
    """Threads a block of the cluster body takes for a plan's
    ``tiles_per_block`` (as ``f2f_tvl1_cluster`` reckons them): one to three
    pixels a thread, at most four tiles' threads."""
    px = -(-tiles_per_block // 4)
    return TILE_H * TILE_W * -(-tiles_per_block // px)


def grid_barrier_probe(blocks, syncs):
    """Launch a kernel that does ``syncs`` barriers across ``blocks`` blocks
    of the inner kernel's size and nothing else: a measuring aid for the
    least a launch of this design can take an iteration."""
    lib = _lib()
    rc = lib.f2f_tvl1_barrier_probe(
        int(blocks), int(syncs), torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, "grid_barrier_probe", rc)


def cluster_barrier_probe(blocks, threads, syncs):
    """Launch one cluster of ``blocks`` blocks of ``threads`` threads that
    does ``syncs`` cluster barriers and nothing else: what an iteration would
    pay for each cluster barrier at the cluster body's shape, which the body
    avoids in its loop (it has one, at set-up)."""
    lib = _lib()
    _cluster_taken("f2f_tvl1_cluster_probe_check",
                   torch.cuda.current_device(), int(blocks), int(threads))
    rc = lib.f2f_tvl1_cluster_probe(
        int(blocks), int(threads), int(syncs),
        torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, "cluster_barrier_probe", rc)
