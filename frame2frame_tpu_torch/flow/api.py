"""In-pipeline optical-flow API for videos.

Counterpart of ``frame2frame_tpu/flow/api.py``, the replacement for the
reference's two flow paths: the filesystem .flo interop (tvl1flow.sh +
readFlowFile.py) and the external ``dev_basics.flow.orun`` (lightning.py:303,
test.py:162). All pairs of a video batch solve in one batched call.

Flow conventions (the harness's fflow/bflow fields, lightning.py:299-301):
- ``fflow[t]`` maps frame t coordinates to frame t+1 positions (last frame: 0);
- ``bflow[t]`` maps frame t coordinates to frame t-1 positions (first frame: 0).

The denoising CLI consumes ``bflow`` of the current frame, matching
``tvl1flow.sh``'s ``out_bflow.flo % (i+1)`` = flow(I_{i+1} -> I_i).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Config
from ..ops.pyramid import num_scales
from ..utils.device import resolve_device
from .farneback import DEFAULT_PARAMS as FB_DEFAULT_PARAMS
from .farneback import fb_params, make_batched_farneback
from .tvl1 import DENOISING_PARAMS, make_batched_tvl1


def _to_gray_bt(vid, device):
    """(B,T,H,W,C)/(T,H,W,C)/(T,H,W) -> (B,T,H,W) luma-by-mean f32."""
    vid = torch.as_tensor(vid).to(device=device, dtype=torch.float32)
    if vid.ndim == 3:
        vid = vid[None, ..., None]
    elif vid.ndim == 4:
        vid = vid[None]
    return vid.mean(dim=-1)


def run_flows(vid, use_flow=True, ftype="tvl1", device=None, **params):
    """Compute fflow/bflow for a video.

    vid: (B, T, H, W, C) (or (T, H, W[, C])) in any consistent range (the
    solver normalises each pair jointly, tvl1flow_lib.c:314-348). Returns
    ``Config(fflow=(B, T, H, W, 2), bflow=(B, T, H, W, 2))``, tensors on
    ``device`` (None: the CUDA card, raising where there is none).

    ``use_flow=False`` returns zero flows, as ``flow.orun(vid, False)``.

    ``ftype`` selects the estimator, like the reference's
    ``dev_basics.flow.orun(ftype=...)``: ``"tvl1"`` is the multiscale dual
    TV-L1 solver (``flow/tvl1.py``) with the denoising parameters by default;
    ``"svnlb"`` is an explicit alias of it (the reference's svnlb flow is the
    VNLB package's bundled TV-L1 variant); ``"cv2"`` is Farneback's
    polynomial-expansion flow (``flow/farneback.py``,
    ``make_batched_farneback`` with ``DEFAULT_PARAMS`` updated by the
    Farneback keys of ``params``), a different estimator, as in the JAX
    package.
    """
    device = resolve_device(device)
    g = _to_gray_bt(vid, device)
    B, T, H, W = g.shape
    zeros = torch.zeros(B, T, H, W, 2, dtype=g.dtype, device=device)
    if not use_flow or T == 1:
        return Config(fflow=zeros, bflow=zeros)
    if ftype not in ("tvl1", "svnlb", "cv2"):
        raise ValueError(f"unknown flow type [{ftype}]")
    if ftype == "cv2":
        kw = dict(FB_DEFAULT_PARAMS)
        kw.update(fb_params(params))
        solver = make_batched_farneback(W, H, device=device, **kw)
    else:
        kw = dict(DENOISING_PARAMS)
        kw.update(params)
        # small frames: the denoising parameters' fscale=2 (stop two levels
        # above the finest, tvl1flow.sh:12-18) can exceed the clamped pyramid
        # depth (coarsest >= 16 px, main.c:159-163), which in the C code
        # solves no level at all (zero flow). Clamp so that at least the
        # coarsest level solves.
        ns = num_scales(W, H, kw.get("nscales", 100), kw.get("zfactor", 0.5))
        if kw.get("fscale", 0) >= ns:
            kw["fscale"] = max(ns - 1, 0)
        solver = make_batched_tvl1(W, H, device=device, **kw)

    # forward: pairs (t, t+1) for t in 0..T-2; backward: (t, t-1) for t in
    # 1..T-1; both directions solve in ONE batched call
    src_f = g[:, :-1].reshape(-1, H, W)
    dst_f = g[:, 1:].reshape(-1, H, W)
    both = solver(torch.cat([src_f, dst_f]), torch.cat([dst_f, src_f]))
    P = src_f.shape[0]
    fflow = both[:P].reshape(B, T - 1, H, W, 2)
    bflow = both[P:].reshape(B, T - 1, H, W, 2)
    fflow = torch.cat([fflow, zeros[:, :1]], dim=1)
    bflow = torch.cat([zeros[:, :1], bflow], dim=1)
    return Config(fflow=fflow, bflow=bflow)


def orun(vid, use_flow=True, ftype="tvl1", device=None, **params):
    """dev_basics-style alias (reference lightning.py:303)."""
    return run_flows(vid, use_flow=use_flow, ftype=ftype, device=device,
                     **params)


def precompute_flo_files(frames, out_tmpl, first=1, device=None, **params):
    """Batch-produce Middlebury .flo files like tvl1flow.sh (bflow naming):
    ``out_tmpl % (first + i + 1)`` holds flow(I_{i+1} -> I_i).

    frames: (T, H, W) numpy array in [0, 255]. Returns the written paths."""
    from ..io.flo import write_flo

    frames = np.asarray(frames)
    T, H, W = frames.shape
    kw = dict(DENOISING_PARAMS)
    kw.update(params)
    solver = make_batched_tvl1(W, H, device=device, **kw)
    flows = solver(frames[1:], frames[:-1]).cpu().numpy()
    paths = []
    for i in range(T - 1):
        path = out_tmpl % (first + i + 1)
        write_flo(path, flows[i])
        paths.append(path)
    return paths
