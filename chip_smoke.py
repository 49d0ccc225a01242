#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``frame2frame_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, any failure exits non-zero:
1. card name and power limit (nvidia-smi), torch and CUDA versions;
2. build of the CUDA kernels from ``frame2frame_tpu_torch/csrc``;
3. each kernel against its plain PyTorch version at small shapes that leave
   partial tiles, then at 540x960x64, B=1 and B=4 (bf16 storage; f32 too
   for ``fwd_layer_eval``), with CUDA-event times of
   the kernel, the plain version and a library yardstick (``F.conv2d`` on
   bf16 channels-last, which the port never calls);
4. the serving path: the pretrained DnCNN-17 (results/dncnn17_s25) loaded
   through the port, ``OnlineDenoiser.denoise_only`` and ``denoise_batch``
   (both routes) on four 540p synthetic noisy frames under the "affine" and
   "act-bf16" eval implementations, each held against the same model's
   plain forward on the card, with a denoising gain and the kernels' launch
   counts checked; then per-call host-clock and device times of the
   serving calls, with their kernels by device time (torch.profiler);
5. a JSON line of per-kernel numbers, then the card line, then the result
   line ``{"ok": true, "device": {...}}``.

The script imports torch, numpy and the port only.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
CKPT = REPO / "results" / "dncnn17_s25" / "checkpoint.msgpack"
H, W, FEAT = 540, 960, 64
NMID = 15
SIGMA = 25.0 / 255.0
# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
# max |kernel - plain| <= KERNEL_RTOL * max |plain|: the kernels round their
# MMA operands to bf16 (weights, and f32 activations) where the plain
# versions multiply in f32, and a bf16 output is itself rounded to 2^-8.
KERNEL_RTOL = 1e-2
# served frames against the same model's f32 forward: 17 layers of a bf16
# activation chain; the PSNR limit is far below a visible difference
SERVE_ATOL = 2e-2
SERVE_PSNR_TOL = 0.05  # dB
MIN_GAIN_DB = 1.0
REPLACES = {
    "fwd_layer": "frame2frame_tpu/ops/fused_stack.py:673",
    "fwd_layer_eval": "frame2frame_tpu/ops/fused_stack.py:870",
}
SOURCE = "frame2frame_tpu_torch/csrc/fused_stack.cu"


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def edge_shapes(torch, fs, w, s, b):
    """Both kernels at shapes that leave partial tiles in both directions,
    tiny frames and batches, in both storage dtypes, against the plain
    versions."""
    rng = np.random.default_rng(1)
    for B, h, wd in ((3, 13, 20), (2, 37, 50), (1, 5, 7), (1, 1, 1)):
        x = torch.from_numpy(rng.standard_normal(
            (B, h, wd, FEAT), dtype=np.float32)).cuda()
        for dt in (torch.bfloat16, torch.float32):
            for name, kern, plain, inp in (
                    ("fwd_layer", fs.fwd_layer, fs.fwd_layer_plain, x),
                    ("fwd_layer_eval", fs.fwd_layer_eval,
                     fs.fwd_layer_eval_plain, torch.relu(x))):
                inp = inp.to(dt).contiguous()
                got = kern(inp, w, s, b)
                torch.cuda.synchronize()
                ref = plain(inp, w, s, b)
                err = float((got.float() - ref.float()).abs().max())
                scale = float(ref.float().abs().max())
                check(err <= KERNEL_RTOL * scale + 1e-6,
                      f"{name} {(B, h, wd)} {dt}: max|kernel-plain| {err} "
                      f"> {KERNEL_RTOL} * {scale}")
    print("kernel edge shapes: ok", flush=True)


def kernel_phase(torch, F, fs, cuda_time_ms):
    """Each kernel against its plain version; returns the per-kernel rows."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    z4 = torch.from_numpy(
        rng.standard_normal((4, H, W, FEAT), dtype=np.float32)).to(dev)
    w = torch.from_numpy((rng.standard_normal((3, 3, FEAT, FEAT))
                          * np.sqrt(2.0 / (9 * FEAT))).astype(np.float32)).to(dev)
    s = torch.from_numpy(
        (1.0 + 0.2 * rng.standard_normal(FEAT)).astype(np.float32)).to(dev)
    b = torch.from_numpy(
        (0.1 * rng.standard_normal(FEAT)).astype(np.float32)).to(dev)
    wk = fs.kernel_weights(w)  # as the main path hands them to the kernels
    w_lib = w.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)

    def library(a):
        """F.conv2d on bf16 channels-last, operand prepared outside."""
        x = a.to(torch.bfloat16).permute(0, 3, 1, 2)
        return lambda: F.conv2d(x, w_lib, padding=1)

    cases = []
    for B in (1, 4):
        zb = z4[:B].to(torch.bfloat16).contiguous()
        cases.append(("fwd_layer", B, zb,
                      lambda x: fs.fwd_layer(x, wk, s, b),
                      lambda x: fs.fwd_layer_plain(x, w, s, b),
                      torch.relu(zb.float() * s + b)))
        for dt in (torch.bfloat16, torch.float32):
            a = torch.relu(z4[:B]).to(dt).contiguous()
            cases.append(("fwd_layer_eval", B, a,
                          lambda x: fs.fwd_layer_eval(x, wk, s, b),
                          lambda x: fs.fwd_layer_eval_plain(x, w, s, b), a))

    edge_shapes(torch, fs, w, s, b)
    warm = cases[0]
    for _ in range(100):  # bring the clocks up before the first timing
        warm[3](warm[2])
    rows = {}
    for name, B, x, kern, plain, lib_in in cases:
        got = kern(x)
        torch.cuda.synchronize()
        ref = plain(x)
        check(got.shape == ref.shape and got.dtype == ref.dtype,
              f"{name}: shape/dtype {tuple(got.shape)} {got.dtype}")
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        err = float((got.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        tag = f"{name} B={B} {str(x.dtype).replace('torch.', '')}"
        check(err <= KERNEL_RTOL * scale,
              f"{tag}: max|kernel-plain| {err} > {KERNEL_RTOL} * {scale}")
        ms = cuda_time_ms(lambda: kern(x))
        plain_ms = cuda_time_ms(lambda: plain(x))
        library_ms = cuda_time_ms(library(lib_in))
        nbytes = (2 * x.numel() * x.element_size()
                  + wk.numel() * wk.element_size() + 2 * FEAT * 4)
        flops = 2 * B * H * W * FEAT * FEAT * 9
        bms, by = bound_ms(nbytes, flops)
        row = {"B": B, "dtype": str(x.dtype).replace("torch.", ""),
               "max_abs_err": err, "max_abs_plain": scale, "ms": ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bms, "bound_by": by}
        print(f"kernel {tag}: err {err:.3e} (plain max {scale:.3e}) "
              f"ms {ms:.4f} plain {plain_ms:.4f} library {library_ms:.4f} "
              f"bound {bms:.4f} ({by})", flush=True)
        rows.setdefault(name, []).append(row)
    del z4
    torch.cuda.empty_cache()
    return rows


def synthetic_frames(n, seed=0):
    """Smooth textured clean frames in [0.1, 0.9] and their noisy versions
    (additive Gaussian noise, sigma 25/255)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    clean = []
    for _ in range(n):
        img = np.zeros((H, W), np.float32)
        for _ in range(6):
            fy, fx = rng.uniform(0.002, 0.03, 2)
            ph = rng.uniform(0, 2 * np.pi)
            img += rng.uniform(0.3, 1.0) * np.sin(2 * np.pi * (fy * yy + fx * xx) + ph)
        for _ in range(8):
            cy, cx = rng.uniform(0, H), rng.uniform(0, W)
            r = rng.uniform(20, 120)
            img += rng.uniform(-1, 1) * (((yy - cy) ** 2 + (xx - cx) ** 2) < r * r)
        img = (img - img.min()) / (img.max() - img.min())
        clean.append(0.1 + 0.8 * img)
    clean = np.stack(clean)[..., None].astype(np.float32)
    noisy = clean + SIGMA * rng.standard_normal(clean.shape).astype(np.float32)
    return clean, noisy.astype(np.float32)


def profile_call(torch, fn, iters=10):
    """Host-clock milliseconds per call of ``fn`` (median of ``iters``, each
    ending in a synchronize), then one torch.profiler pass over ``iters``
    calls: device kernel time per call, the device's busy share of the
    profiled wall time, and the kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(e.name[:70], [0, 0.0])
            k[0] += 1
            k[1] += e.time_range.elapsed_us() / 1e3
    device_ms = sum(v[1] for v in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:6]
    return {"ms": float(np.median(ts)),
            "device_ms": device_ms / iters if kernels else None,
            "busy_share": device_ms / wall_ms if kernels else None,
            "top_kernels": [{"name": n, "calls": c // iters,
                             "ms": t / iters} for n, (c, t) in top]}


def serving_phase(torch, fs, psnr):
    """The main path; returns (launch counts of the counted run, timings)."""
    from frame2frame_tpu_torch.models.dncnn import from_jax_variables
    from frame2frame_tpu_torch.models.serialization import load_variables
    from frame2frame_tpu_torch.train.online import OnlineDenoiser

    B = 4
    variables = load_variables(CKPT)
    model = from_jax_variables(variables, residual=True)
    check(model.num_layers == 17 and model.features == 64,
          "checkpoint is not DnCNN-17 with 64 features")
    clean, noisy = synthetic_frames(B)
    dev = torch.device("cuda")
    with torch.no_grad():
        plain = model.to(dev).eval()(torch.from_numpy(noisy).to(dev)).cpu().numpy()
    check(np.isfinite(plain).all(), "plain forward: non-finite output")
    p_noisy = [psnr(clean[k], noisy[k]) for k in range(B)]
    p_plain = [psnr(clean[k], plain[k]) for k in range(B)]
    print(f"serving: psnr noisy {np.mean(p_noisy):.4f} dB, plain forward "
          f"{np.mean(p_plain):.4f} dB", flush=True)

    engines = {impl: OnlineDenoiser(model, variables, residual_model=True,
                                    eval_impl=impl, device="cuda")
               for impl in ("affine", "act-bf16")}
    kname = {"affine": "fwd_layer", "act-bf16": "fwd_layer_eval"}

    def hold(out, what):
        out = out.cpu().numpy()
        check(out.shape == noisy.shape, f"{what}: shape {out.shape}")
        check(np.isfinite(out).all(), f"{what}: non-finite output")
        err = float(np.abs(out - plain).max())
        p = [psnr(clean[k], out[k]) for k in range(B)]
        dp = max(abs(a - c) for a, c in zip(p, p_plain))
        gain = min(a - c for a, c in zip(p, p_noisy))
        print(f"serving {what}: max|served-plain| {err:.3e}, psnr "
              f"{np.mean(p):.4f} dB (max |d| vs plain {dp:.4f}), min gain "
              f"{gain:.4f} dB", flush=True)
        check(err <= SERVE_ATOL, f"{what}: max|served-plain| {err}")
        check(dp <= SERVE_PSNR_TOL, f"{what}: psnr off plain by {dp} dB")
        check(gain > MIN_GAIN_DB, f"{what}: denoising gain {gain} dB")

    def counted(fn, impl, expect, what):
        before = dict(fs.launch_counts())
        out = fn()
        torch.cuda.synchronize()
        after = fs.launch_counts()
        for k in after:
            want = expect if k == kname[impl] else 0
            check(after[k] - before[k] == want,
                  f"{what}: {k} launched {after[k] - before[k]} times, "
                  f"expected {want}")
        return out

    x = torch.from_numpy(noisy).to(dev)
    fs.reset_launch_counts()
    for impl, eng in engines.items():
        outs = [counted(lambda: eng.denoise_only(x[k]), impl, NMID,
                        f"{impl} denoise_only") for k in range(B)]
        hold(torch.stack(outs), f"{impl} denoise_only")
        hold(counted(lambda: eng.denoise_batch(x, route="stacked"), impl,
                     NMID, f"{impl} stacked"), f"{impl} denoise_batch stacked")
        hold(counted(lambda: eng.denoise_batch(x, route="perframe"), impl,
                     NMID * B, f"{impl} perframe"),
             f"{impl} denoise_batch perframe")
    launches = fs.launch_counts()
    for k, n in launches.items():
        check(n > 0, f"{k} was not launched on the main path")

    timings = {}
    for impl, eng in engines.items():
        for what, fn, frames in (
                ("denoise_only", lambda: eng.denoise_only(x[0]), 1),
                ("denoise_batch_stacked",
                 lambda: eng.denoise_batch(x, route="stacked"), B)):
            timings[f"{impl}/{what}"] = dict(profile_call(torch, fn),
                                             frames=frames)
            print(f"serving {impl}/{what}: "
                  + json.dumps(timings[f"{impl}/{what}"]), flush=True)
    return launches, timings


def main():
    if not (REPO / "frame2frame_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke: the port's package frame2frame_tpu_torch is not "
              "beside this script", file=sys.stderr)
        return 2
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from frame2frame_tpu_torch.ops import _build
    from frame2frame_tpu_torch.ops import fused_stack as fs
    from frame2frame_tpu_torch.utils.metrics import psnr
    from frame2frame_tpu_torch.utils.timer import cuda_time_ms

    try:
        card = card_line()
        print(card, flush=True)
        print(f"python {sys.version.split()[0]} torch {torch.__version__} "
              f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}",
              flush=True)

        t0 = time.perf_counter()
        report = _build.build("fused_stack")
        print(f"build: fused_stack.cu in {time.perf_counter() - t0:.1f} s",
              flush=True)
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("  ptxas: " + line.strip(), flush=True)

        rows = kernel_phase(torch, F, fs, cuda_time_ms)
        launches, timings = serving_phase(torch, fs, psnr)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1

    kernels = []
    for name, cfgs in rows.items():
        main_row = cfgs[0]  # B=1 bf16: the shape denoise_only gives it
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": main_row["max_abs_err"], "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"], "configs": cfgs})
    print(json.dumps({"kernels": kernels, "serving": timings}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
