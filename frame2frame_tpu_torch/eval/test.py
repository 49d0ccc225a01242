"""Model evaluation pipeline — counterpart of ``frame2frame_tpu/eval/test.py``,
the reference's ``frame2frame.test.run(cfg)`` (lib/frame2frame/test.py:
74-306): per-video flow, optional x8 self-ensemble, chunked inference,
burn-in, optional internal adaptation, timed/memory-metered denoising, the
B2U masked-ensemble second pass, video saving, and PSNR/SSIM/ST-RRED
metrics — with per-stage timers mirroring the reference's result columns
(test.py:109-117).

Everything runs on one device, the card unless the caller names another:
the model (``load_model``; a ``"fused"`` DnCNN serves through the fused
kernels there), the flows, the adaptation and the memory meters. The
timers wait for the card before they stop.
"""

from __future__ import annotations

import contextlib
import copy
from pathlib import Path

import numpy as np
import torch

from ..config import Config, extract_pairs, optional
from ..data import filter_subseq, noise, sets, slice_sample
from ..flow import api as flow_api
from ..io.video import save_video
from ..losses.b2u import B2ULoss
from ..models import load_model
from ..utils.device import resolve_device
from ..utils.mem import GpuMemer, MemIt
from ..utils.metrics import compute_psnrs, compute_ssims, compute_strred
from ..utils.misc import set_seed
from ..utils.profiling import trace_if
from ..utils.timer import ExpTimer, TimeIt
from .aug import test_x8
from .chunks import chunk, extract_chunks_config


def test_pairs():
    """Config keys + defaults mirroring test.py:36-47. ``device`` names the
    card; the device ``run`` takes is its argument."""
    return {
        "device": "cuda", "seed": 123,
        "frame_start": 0, "frame_end": -1, "dset": "val",
        "aug_test": False, "longest_space_chunk": False,
        "flow": False, "burn_in": False, "arch_name": "default",
        "saved_dir": "./output/saved_examples/", "uuid": "uuid_def",
        "flow_sigma": -1, "internal_adapt_nsteps": 0,
        "internal_adapt_nepochs": 0, "internal_adapt_nframes": 5,
        "nframes": 0, "read_flows": False,
        "save_deno": True, "bench_bwd": False, "append_noise_map": False,
        "crit_name": "warp", "vid_name": "vid00", "sigma": 25,
        "profile_dir": "",  # capture a torch.profiler trace here
    }


def _host(x):
    return x.detach().cpu().numpy()


def run(cfg, device=None):
    """Evaluate per config on ``device`` (None: the CUDA card, and raises
    where there is none); returns a results Config of per-video lists."""
    cfg = Config(cfg)
    device = resolve_device(device)
    tcfg = extract_pairs(cfg, test_pairs())
    if tcfg.frame_end == -1 and tcfg.nframes > 0:
        tcfg.frame_end = tcfg.frame_start + tcfg.nframes - 1

    set_seed(tcfg.seed)
    imax = 255.0

    results = Config()
    for k in ("psnrs", "ssims", "strred", "psnrs_pp", "ssims_pp", "strred_pp",
              "strred_method", "noisy_psnrs", "deno_fns", "vid_frames",
              "vid_name"):
        results[k] = []
    time_fields = ["flow", "deno", "deno_pp", "adapt", "fwd_grad", "bwd"]
    for f in time_fields:
        results[f"timer_{f}"] = []
    for f in ["deno", "deno_pp", "adapt", "fwd_grad", "bwd"]:
        results[f"{f}_mem_res"] = []
        results[f"{f}_mem_alloc"] = []

    ms = load_model(cfg, device=device)
    state_apply = ms.apply

    data, loaders = sets.load(cfg, device=device)
    dset = data[tcfg.dset]
    indices = filter_subseq(dset, tcfg.vid_name, tcfg.frame_start,
                            tcfg.frame_end)

    def tensor(x):
        return torch.as_tensor(x).to(device, torch.float32)

    burn_in = tcfg.burn_in
    prof = contextlib.ExitStack()
    prof.enter_context(trace_if(tcfg.profile_dir))
    try:
        for index in indices:
            timer = ExpTimer()
            memer = GpuMemer()

            sample = slice_sample(dset[index], tcfg.frame_start, tcfg.frame_end)
            noisy = tensor(sample["noisy"])[None]  # (1, T, H, W, C), [0,255]
            clean = tensor(sample["clean"])[None]
            vid_frames = np.asarray(sample["fnums"])

            # resample noise for flow input (test.py:151-154)
            if tcfg.flow_sigma >= 0:
                gen = torch.Generator(device).manual_seed(tcfg.seed)
                noisy_f = clean + tcfg.flow_sigma * noise._normal(
                    gen, clean.shape, clean.dtype, device)
            else:
                noisy_f = noisy

            with TimeIt(timer, "flow"):
                if tcfg.read_flows and "fflow" in sample:
                    flows = Config(fflow=tensor(sample["fflow"])[None],
                                   bflow=tensor(sample["bflow"])[None])
                else:
                    flows = flow_api.run_flows(noisy_f, tcfg.flow,
                                               device=device)

            # forward fn: model (+ optional x8 ensemble) (+ chunking);
            # video models (FastDVDnet) consume (B, T, H, W, C) directly,
            # frame models (DnCNN) flatten time into batch
            def model_fwd(vid, fl=None):
                if ms.get("video_model", False):
                    return state_apply(vid)
                B, T = vid.shape[:2]
                out = state_apply(vid.reshape((B * T,) + tuple(vid.shape[2:])))
                return out.reshape(tuple(vid.shape[:2]) + tuple(out.shape[1:]))

            if tcfg.aug_test:
                def aug_fwd(vid, fl=None):
                    return test_x8(model_fwd, vid, fl)
                base_fwd = aug_fwd
            else:
                base_fwd = model_fwd

            chunk_cfg = extract_chunks_config(cfg)
            if tcfg.longest_space_chunk and chunk_cfg.spatial_chunk_size:
                # stretch the spatial chunk to the longest frame side
                # (set_longest_spatial_chunk, reference test.py:172-174)
                chunk_cfg.spatial_chunk_size = max(noisy.shape[-3],
                                                   noisy.shape[-2])
            fwd_fxn = chunk(chunk_cfg, base_fwd)

            # burn-in once (test.py:180-186)
            if burn_in:
                fwd_fxn(noisy[:, :, :128, :128, :] / imax)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                burn_in = False

            # internal adaptation (test.py:189-203), on a copy of the model:
            # the served model and the B2U pass keep the loaded weights
            run_adapt = (tcfg.internal_adapt_nsteps > 0
                         and tcfg.internal_adapt_nepochs > 0)
            with MemIt(memer, "adapt", device=device):
                with TimeIt(timer, "adapt"):
                    if run_adapt:
                        from .. import get_loss_fxn
                        from ..train.schedules import make_optimizer
                        from ..train.state import TrainState

                        acfg = Config(cfg)
                        acfg.adapt_nepochs = tcfg.internal_adapt_nepochs
                        acfg.adapt_nsteps = tcfg.internal_adapt_nsteps
                        loss_fxn = get_loss_fxn(acfg, optional(cfg, "loss_type",
                                                               "f2f"))
                        tx, _ = make_optimizer(Config(
                            cfg, scheduler_name="cosa",
                            nepochs=tcfg.internal_adapt_nepochs))
                        st = TrainState.create(copy.deepcopy(ms.model), None,
                                               tx, residual=True)
                        # adapt window: first internal_adapt_nframes frames
                        # (config-driven; the reference hardcodes the first 5,
                        # test.py:195-196)
                        nf_a = max(int(tcfg.internal_adapt_nframes), 1)
                        st, _ = loss_fxn(st, noisy[:, :nf_a] / imax,
                                         clean[:, :nf_a] / imax)

                        def model_fwd(vid, fl=None, _st=st):
                            B, T = vid.shape[:2]
                            out = _st.eval_apply(
                                vid.reshape((B * T,) + tuple(vid.shape[2:])))
                            return out.reshape(tuple(vid.shape[:2])
                                               + tuple(out.shape[1:]))

                        fwd_fxn = chunk(chunk_cfg, model_fwd)

            # optional sigma noise-map channel (test.py:207-211)
            noisy_input = noisy
            if tcfg.append_noise_map:
                B, T, H, W, C = noisy.shape
                nm = torch.full((B, T, H, W, 1), float(tcfg.sigma),
                                dtype=noisy.dtype, device=device)
                noisy_input = torch.cat([noisy, nm], dim=-1)

            # denoise (test.py:214-219)
            with MemIt(memer, "deno", device=device):
                with TimeIt(timer, "deno"):
                    deno = fwd_fxn(noisy_input / imax, flows)
                    deno = _host(deno.clamp(0.0, 1.0) * imax)

            # B2U masked-ensemble second pass (test.py:222-229,
            # run_ub2_test :49-71)
            with MemIt(memer, "deno_pp", device=device):
                with TimeIt(timer, "deno_pp"):
                    if tcfg.crit_name == "b2u":
                        b2u = B2ULoss.for_test()
                        pp_cfg = Config(chunk_cfg)
                        pp_cfg.temporal_chunk_size = 1
                        pp_cfg.spatial_chunk_size = 512
                        pp_cfg.spatial_chunk_overlap = 0.1

                        def b2u_fwd(vid, fl=None):
                            return b2u.test(state_apply, vid)

                        deno_pp = chunk(pp_cfg, b2u_fwd)(noisy_input / imax,
                                                         flows)
                        deno_pp = _host(deno_pp.clamp(0, 1) * imax)
                    else:
                        deno_pp = deno.copy()

            # save denoised video (test.py:237-242)
            out_dir = Path(tcfg.saved_dir) / str(tcfg.arch_name) / str(tcfg.uuid)
            if tcfg.save_deno:
                deno_fns = save_video(deno, out_dir, "deno")
            else:
                deno_fns = [""] * deno.shape[0]

            # metrics (test.py:245-252)
            noisy_np, clean_np = _host(noisy), _host(clean)
            results.psnrs.append(compute_psnrs(clean_np, deno, div=imax))
            results.ssims.append(compute_ssims(clean_np, deno, div=imax))
            results.strred.append(compute_strred(clean_np, deno, div=imax))
            results.psnrs_pp.append(compute_psnrs(clean_np, deno_pp, div=imax))
            results.ssims_pp.append(compute_ssims(clean_np, deno_pp, div=imax))
            results.strred_pp.append(compute_strred(clean_np, deno_pp,
                                                    div=imax))
            # tag the band method: the spyr/analytic implementations differ
            # ~4x in absolute scale (utils/metrics.compute_strred docstring),
            # so cross-run aggregation must never mix them silently
            results.strred_method.append(["spyr"])
            results.noisy_psnrs.append(compute_psnrs(noisy_np, clean_np,
                                                     div=imax))
            results.deno_fns.append(deno_fns)
            results.vid_frames.append(vid_frames)
            results.vid_name.append([tcfg.vid_name])

            # backward benchmark (test.py:273-275,308-328)
            if tcfg.bench_bwd:
                measure_bwd(ms, fwd_fxn, flows, noisy / imax, clean / imax,
                            timer, memer, device=device)

            for name, (mem_res, mem_alloc) in memer.items():
                results[f"{name}_mem_res"].append([mem_res])
                results[f"{name}_mem_alloc"].append([mem_alloc])
            for name, t in timer.items():
                results.setdefault(name, []).append(t)

    finally:
        prof.close()
    return results


def measure_bwd(ms, fwd_fxn, flows, noisy, clean, timer, memer, device=None):
    """Forward+backward timing (test.py:308-328): the forward as served,
    then the gradient of the eval-mode module's MSE by ``torch.autograd``
    (the module's running statistics as they are)."""
    with MemIt(memer, "fwd_grad", device=device):
        with TimeIt(timer, "fwd_grad"):
            _host(fwd_fxn(noisy, flows))

    model = ms.model
    with MemIt(memer, "bwd", device=device):
        with TimeIt(timer, "bwd"):
            model.eval()
            B, T = noisy.shape[:2]
            out = model(noisy.reshape((B * T,) + tuple(noisy.shape[2:])))
            loss = ((out.reshape(clean.shape) - clean) ** 2).mean()
            grads = torch.autograd.grad(loss, list(model.parameters()))
            _host(grads[0])
