#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``frame2frame_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, any failure exits non-zero:
1. card name and power limit (nvidia-smi), torch and CUDA versions;
2. build of the CUDA kernels from ``frame2frame_tpu_torch/csrc``, one
   ``nvcc`` process a source, all at once, with ptxas's registers, spills
   and any serialised wgmma;
3. each kernel against its plain PyTorch version at small shapes that leave
   partial tiles and a ragged 541x963, then at 540x960x64 (the three
   forward forms at B=1 and B=4 on both chains, their sums bit-equal on two
   runs; the host's cost of a forward call), with CUDA-event times of the
   kernel, the plain version and a library yardstick that the port never
   calls (``F.conv2d``, and ``aten.convolution_backward`` for
   ``bwd_layer``, on bf16 channels-last);
   the four end kernels of the flat step (``first_conv``, ``last_loss_fwd``,
   ``last_loss_bwd``, ``first_dw``) the same way, one frame, with their
   reductions run twice for equal bits; ``last_loss_fwd`` and
   ``last_loss_bwd`` also with relu(b) > 0 in every channel (the zero
   border of the activation) at 540x960, 541x963, 1x1, 2x3 and 13x21 on
   both chains, each with the same bits on two runs, and both timed on the
   f32 chain too;
4. the serving path: the pretrained DnCNN-17 (results/dncnn17_s25) loaded
   through the port, ``OnlineDenoiser.denoise_only`` and ``denoise_batch``
   (both routes) on four 540p synthetic noisy frames under the "affine" and
   "act-bf16" eval implementations, each held against the same model's
   plain forward on the card, with a denoising gain and the kernels' launch
   counts checked; then per-call host-clock and device times of the
   serving calls, with their kernels by device time (torch.profiler);
5. the online fine-tune: three synthetic 540p frames of one moving texture
   with their flow; one step's loss and parameter gradients on the kernels
   against the same step on their plain versions, for the per-iteration
   route (``fused_train_apply``) and for the flat step (``flat_net_loss``);
   ``OnlineDenoiser.process_frame`` (20 Adam updates, then the eval denoise)
   on two frames on the flat route, which the engine takes by itself, and on
   the per-iteration route, with the launch counts and the losses checked;
   the same two frames fine-tuned by the plain module's autograd in f32,
   losses and PSNR compared, and the two routes against each other;
   host-clock and device times of ``process_frame`` on both routes;
6. the flow's inner loop (``tvl1_inner_loop``) against its plain version on
   inputs built the way the solver builds them: tiny and odd frames, frames
   that are all border, every solved level of a 540p flow, 270x480 and
   540x960, with 1, 30 and 300 iterations allowed, on the body that
   ``cluster_plan`` gives the shape and on the cooperative body wherever
   that is the cluster body; batches of four pairs that stop at different
   iterations at 68x120 and 135x240, each pair equal to its launch alone:
   equal iteration counts, the same bits as the plain loop and on two runs;
   which body each shape takes; for every solved level of a 540p flow ms,
   iterations and us an iteration (beside the cooperative body's), and the
   cost of an empty cluster or grid barrier;
7. the flow path: the golden pair (tests/golden) through the solver on the
   card against the reference binary's flows; a 540p flow with the denoising
   parameters on the kernel against the same solver on the plain loop, its
   end-point error against the sequence's analytic flow, the batched solver
   against single solves; then ``AsyncFlowSolver`` feeding
   ``process_frame`` its flows for two frames (its worker records a solve
   into a CUDA graph while the first frame is denoised, and replays it; the
   inner kernels that ran on the card are counted from the profiler's
   record, since a replay goes through no wrapper), the replayed solve
   against the eager one, and the time of a flow alone (with its inner
   launches' device ms) and of a frame with its flow prefetched on a second
   stream; Farneback's flow
   (``run_flows(ftype="cv2")``) of a clean 540p pair against the analytic
   flow and against the same solve on the CPU, with no kernel launched;
8. the ``conv_impl`` routes' kernels (``ops/conv3x3.py`` kernel A,
   ``ops/conv_dw.py`` kernel B): the port's library convolution against
   float64 under PyTorch's default TF32 flags (the script sets none), and
   A and B on f32 operands (split-f32 products on the tensor cores) against
   float64 on the same 64x96 inputs; the body that the C dispatch picks
   against the wrappers' rule (``conv_dw.conv_body``), and a misaligned view
   refused for every operand read in 16-byte chunks; A and B against their
   plain versions at edge shapes (``CONV_EDGE_SHAPES``: every body of each,
   the thin class at 1->64, 64->1, 3->64, 64->3, batches and 541x963) and
   at 540x960 64->64, 1->64 and 64->1 (B on f32 and bf16 operands), within
   1e-5 of the largest plain value, B's bits on two runs, the body that ran
   on each line; ``conv3x3_p2`` and ``conv3x3_dwflat`` once each; times
   (behind a head start of the device) beside the bound of the body that
   ran (and the f32 FMA bound), the plain version and a library call
   (``F.conv2d``, ``aten.convolution_backward`` weight-only, with TF32
   off);
9. the ``conv_impl`` routes of the pretrained DnCNN-17 ("pallas", "hybrid",
   "bf16res", "packed_bf16"): one step's gradients on the kernels against
   the plain versions' backward from the same forward; two 540p frames
   through ``process_frame`` (20 updates) on each route and on the f32
   ``"xla"`` module route, with the launches a frame, losses within 0.5 %
   and PSNR within 0.1 dB of the ``"xla"`` route's (1.5 % and 0.4 dB for
   the bf16 graph of "packed_bf16"); times a frame;
10. the streaming loop: a 5-frame 540p PGM sequence through the
   ``blind_denoising`` CLI (``--network`` the checkpoint,
   ``--compute_flow``: the flat route fed by ``AsyncFlowSolver``), then
   ``run_blind_denoising`` with a ``"pallas"`` model over 3 frames with
   ``.flo`` files: ``plot_psnr.txt``, a gain over the noisy frames, the
   frames written, ``final.msgpack`` read back equal to the engine's state
   bit for bit, launch counts, frames/s;
11. the H-split step (``parallel/spatial.py``): after phase 3, the four
   mid-layer kernels with a row window against their windowed plain
   versions on both chains (``WINDOW_CASES``: every slab of 540x960 as 1,
   2 and 4 slabs and of 1080x1920 as 2, both slabs of 541x963 split in
   two, the interior slab of 540x960 split in three), the whole frame's
   window bit-equal to no window, and the times of the launches without a
   window, with the whole frame's and with one slab's; at the end, the
   pretrained DnCNN-17's split backward (D = 2, 4) against the unsplit
   backward from the same forward (dW, dgamma, dbeta and the stack input's
   cotangent): on the kernels, both chains, ``STEP_GRAD_RTOL``; on the
   plain versions in f32, ``SPATIAL_PLAIN_GRAD_RTOL``; the model fine-tuned on
   one 540p frame (20 updates) as 1, 2 and 4 slabs on ``cuda:0``, f32 and
   bf16 chains, against the unsplit per-iteration route (the first loss
   1e-4; the updates: losses 0.5 %, PSNR 0.1 dB, frame rms 5e-3, the
   slabs' edge rows no farther off than 1.5 times the others), exactly
   D x 15 launches of each mid-layer kernel an update; a 1080p frame
   fine-tuned and served at D = 2 on both eval routes (served frames
   bit-equal to the unsplit route's); host and device ms, and the peak
   device memory of the 1080p steps;
12. the config-driven entry point (``load_model``, ``models/__init__.py``):
   the pretrained DnCNN-17 with ``conv_impl="fused"`` built on the card
   without a device argument, its ``apply`` on the serving phase's four
   frames at B=4 (exactly 15 ``fwd_layer`` launches and no other kernel,
   the serving holds, bit-equal to ``denoise_batch(route="stacked")``),
   scored by ``compute_psnrs``, ``compute_ssims`` and ``compute_strred``
   with their host ms; FastDVDnet at its published widths on a seeded
   7-frame 540p RGB clip with a sigma 25/255 noise map (one 96x160 window
   on the card within 1e-4 of the same module on the CPU; the clip's
   shape, finite values, host and device ms a frame, peak memory); a
   training state (``save_train_state(extra=)`` -> ``load_train_state(
   like=)``) read back bit for bit; the noise simulator's ``run_rgb`` on a
   540p frame with known a, b and its ``fit`` (200 steps) recovering them
   (``SIM_A_TOL``, ``SIM_B_TOL``) and agreeing with a CPU fit of the same
   pair;
13. a JSON line of per-kernel numbers (launches by path: each kernel is
   launched on every path it belongs to and on no other), then the card
   line, then the result line ``{"ok": true, "device": {...}}``.

The script imports torch, numpy and the port only. It sets no global flag:
its library yardsticks on f32 operands run in the port's local no-TF32
context (``no_tf32``).
"""

from __future__ import annotations

import contextlib
import copy
import functools
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
GOLDEN = REPO / "tests" / "golden"
CKPT = REPO / "results" / "dncnn17_s25" / "checkpoint.msgpack"
H, W, FEAT = 540, 960, 64
NMID = 15
SIGMA = 25.0 / 255.0
# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12  # outside the tensor cores
TF32_FLOP_PER_S = 495e12
# max |kernel - plain| <= KERNEL_RTOL * max |plain|: the kernels round their
# MMA operands to bf16 (weights, and f32 activations) where the plain
# versions multiply in f32, and a bf16 output is itself rounded to 2^-8.
KERNEL_RTOL = 1e-2
# served frames against the same model's f32 forward: 17 layers of a bf16
# activation chain; the PSNR limit is far below a visible difference
SERVE_ATOL = 2e-2
SERVE_PSNR_TOL = 0.05  # dB
MIN_GAIN_DB = 1.0
# sums over the pixels (BN sums, dW) against the plain version's, relative
# to the largest of the same output: the plain versions round their dot
# operands as the kernels do, so only the order of the f32 additions differs
SUMS_RTOL = 2e-3
# one fine-tune step, kernels against their plain versions. Forward: the
# loss, and the new running statistics relative to the largest of their
# kind. Backward, from the same forward: per parameter max |d grad| /
# max |grad|
# (measured on an H100: 6.3e-5, 3.1e-6 and 1.8e-3)
STEP_LOSS_RTOL = 5e-4
STEP_STATS_RTOL = 1e-4
STEP_GRAD_RTOL = 5e-3
# the bf16 kernel fine-tune against the f32 module's: per-iteration losses,
# and PSNR of the denoised frames against the clean ones (measured on an
# H100: 1.9e-3 and 0.044 dB)
TRAIN_LOSS_RTOL = 5e-3
TRAIN_PSNR_TOL = 0.1  # dB
# the flat route against the per-iteration route on the same frames: the
# routes round noise and the cotangent at different points and 20 Adam
# updates compound it (the bounds of the JAX package's own comparison of its
# two routes)
ROUTES_LOSS_RTOL = 1e-2
ROUTES_DENO_RMS = 5e-3
# noise and the loss of last_loss_fwd against the plain version: f32 sums of
# the same products of the same bf16 operands, in another order
ENDS_F32_RTOL = 1e-4
# spin of the device ahead of a timing, about 3 ms: the end kernels are
# shorter than their wrappers' host time
HEAD_START_CYCLES = 5_000_000
ITERS = 20
# kernels A and B (ops/conv3x3.py, ops/conv_dw.py) against their plain
# versions: the same f32 products, summed in another order
CONV_RTOL = 1e-5
# one fine-tune step on a conv_impl route, gradients of the kernels' backward
# against the plain versions' from the same forward: f32 sums in another
# order through 17 layers, per parameter max |d| / max |ref|
CONV_STEP_RTOL = 1e-4
CONV_ROUTES = ("pallas", "hybrid", "bf16res", "packed_bf16")
# launches a 540p frame of DnCNN-17 with ITERS updates: kernel A runs the 17
# forwards and the 16 dX (the frame needs none) of every update and the 17
# forwards of the eval denoise; kernel B every layer's dW of every update
CONV_LAUNCHES = {
    "pallas": {"conv3x3_fwd": ITERS * (17 + 16) + 17,
               "dw_conv3x3": ITERS * 17},
    "hybrid": {"dw_conv3x3": ITERS * 17},
    "bf16res": {"dw_conv3x3": ITERS * 17},
    "packed_bf16": {"dw_conv3x3": ITERS * 17},
    "xla": {},
}
# "packed_bf16" against the f32 "xla" route: the JAX model's bf16 graph
# rounds every activation and the BatchNorm affine to bf16 and carries bf16
# cotangents, which takes it farther from f32 than the f32 routes' bounds
# (measured on an H100: 0.91 % and 0.28 dB)
BF16_GRAPH_LOSS_RTOL = 1.5e-2
BF16_GRAPH_PSNR_TOL = 0.4  # dB
STREAM_FRAMES = 5
# the windowed kernels' holds, (H, W, D, slab k): every slab shape and
# window the split path runs (a 540p frame as 1, 2 and 4 slabs, a 1080p
# frame as 2), both slabs of a 541x963 frame (its last slab holds a pad
# row), the interior slab of a 540p frame split in three
WINDOW_CASES = ((540, 960, 1, 0), (540, 960, 2, 0), (540, 960, 2, 1),
                (540, 960, 4, 0), (540, 960, 4, 1), (540, 960, 4, 2),
                (540, 960, 4, 3), (1080, 1920, 2, 0), (1080, 1920, 2, 1),
                (541, 963, 2, 0), (541, 963, 2, 1), (540, 960, 3, 1))
# the H-split fine-tune (parallel/spatial.py) on one card, slabs on cuda:0,
# against the unsplit per-iteration route on the same inputs, on both chains.
# The split sums the BN statistics in another order; the kernels round their
# MMA operands to bf16 on the f32 chain too, so an ulp of a statistic rounds
# some operands the other way, and 20 Adam updates (whose steps do not
# shrink with the gradient) compound it: a single slab (D = 1: no halo, no
# psum, only the tiles shifted by a row) drifts as far as D = 2 and 4
# (measured on an H100, f32: worst loss 1.4e-4 / 1.4e-4 / 1.6e-4, frame
# rms 1.2e-3 / 1.1e-3 / 1.1e-3). So the first loss,
# the forward of the same weights, is held tightly; the 20 updates by the
# bounds of the flat route against the per-iteration route; and the rows at
# the slabs' edges, where a fault of the halos would show, by the frame's
# other rows (measured 0.79-0.89 of them). Served frames are the same bits:
# eval sums nothing.
SPATIAL_D = (1, 2, 4)
SPATIAL_FIRST_LOSS_RTOL = 1e-4
# the split backward against the unsplit one from the same forward, on the
# plain versions in f32 (no bf16 operand): only the order of f32 sums
# differs, where a row summed by two slabs or by none moves a gradient by
# about its share of the frame's rows, 2e-3 at 540p
SPATIAL_PLAIN_GRAD_RTOL = 1e-4
SPATIAL_EDGE_RMS_RATIO = 1.5
SPATIAL_PHASE_S = 120
# FastDVDnet on the card against the same module on the CPU, one window at
# 96x160: both f32 (cuDNN with TF32 off), sums in another order
FDV_CPU_RTOL = 1e-4
# the noise simulator's fit (200 Adam steps from a=2, b=0) on one 540p RGB
# frame drawn with sigma = softplus(SIM_A + SIM_B * x), x in [0, 255]: on
# the CPU (seeds 0, 1) the fit stops 0.079-0.080 from a and 5.9e-4-6.4e-4
# from b (200 steps do not converge); the bounds allow 1.5 times that. The
# card's fit against a CPU fit of the same pair: the same 200 steps, the
# loss's sums in another order
SIM_A, SIM_B = 2.0, 0.01
SIM_A_TOL, SIM_B_TOL = 0.12, 1e-3
SIM_VS_CPU = (1e-2, 1e-4)
# golden flows of the reference binary: the JAX package's own bounds
# (tests/test_tvl1_golden.py)
GOLDEN_MEAN_TOL, GOLDEN_MAX_TOL = 1e-5, 5e-4
# a 540p flow, kernel solver against plain solver, px
FLOW_SOLVER_ATOL = 1e-3
# median end-point error against the analytic flow on clean frames inside a
# 10 px margin (the bound of the JAX package's known-shift test)
FLOW_EPE_TOL, FLOW_MARGIN = 0.35, 10
# PSNR of the fine-tune on TV-L1 flows of the noisy frames against the same
# frames fine-tuned on the analytic flow
FLOW_PSNR_TOL = 0.5  # dB
FLOW_LAUNCHES_540P = 25  # 5 solved scales x 5 warps
# Farneback's flow on the card against the same solve on the CPU, mean px:
# the same plain ops, rounded in another order by the two devices' kernels
FB_DEVICE_ATOL = 1e-3
# the inner loop's kernels in a profiler record (the cooperative body
# tvl1_inner_k, the cluster body tvl1_inner_cluster_k)
INNER_KERNEL = "tvl1_inner_"
# the solved levels of a 540p flow with DENOISING_PARAMS, finest first
FLOW_LEVELS_540P = ((135, 240), (68, 120), (34, 60), (17, 30), (9, 15))
# f32 operations a pixel and iteration of the inner loop (thresholding 13,
# primal and error 15, dual 26)
FLOW_OPS_PER_PIXEL = 54
REPLACES = {
    "fwd_layer": "frame2frame_tpu/ops/fused_stack.py:673",
    "fwd_layer_train": "frame2frame_tpu/ops/fused_stack.py:673",
    "fwd_layer_eval": "frame2frame_tpu/ops/fused_stack.py:870",
    "bwd_layer": "frame2frame_tpu/ops/fused_stack.py:1161",
    "first_conv": "frame2frame_tpu/ops/fused_ends.py:132",
    "last_loss_fwd": "frame2frame_tpu/ops/fused_ends.py:233",
    "last_loss_bwd": "frame2frame_tpu/ops/fused_ends.py:378",
    "first_dw": "frame2frame_tpu/ops/fused_ends.py:485",
    "tvl1_inner_loop": "frame2frame_tpu/flow/tvl1_pallas.py:98",
    "conv3x3_fwd": "frame2frame_tpu/ops/pallas_conv.py:91",
    "dw_conv3x3": "frame2frame_tpu/ops/conv_dw.py:95",
}
# TPU kernels that compute the same function as the one named in REPLACES
ALSO_REPLACES = {
    "conv3x3_fwd": ["frame2frame_tpu/ops/pallas_conv.py:307"],
    "dw_conv3x3": ["frame2frame_tpu/ops/conv_dw.py:163",
                   "frame2frame_tpu/ops/pallas_conv.py:116",
                   "frame2frame_tpu/ops/pallas_conv.py:331"],
}
SOURCES = {
    "fwd_layer": "frame2frame_tpu_torch/csrc/fused_stack.cu",
    "fwd_layer_train": "frame2frame_tpu_torch/csrc/fused_stack.cu",
    "fwd_layer_eval": "frame2frame_tpu_torch/csrc/fused_stack.cu",
    "bwd_layer": "frame2frame_tpu_torch/csrc/fused_stack_bwd.cu",
    "first_conv": "frame2frame_tpu_torch/csrc/fused_ends.cu",
    "last_loss_fwd": "frame2frame_tpu_torch/csrc/fused_ends.cu",
    "last_loss_bwd": "frame2frame_tpu_torch/csrc/fused_ends.cu",
    "first_dw": "frame2frame_tpu_torch/csrc/fused_ends.cu",
    "tvl1_inner_loop": "frame2frame_tpu_torch/csrc/tvl1_inner.cu",
    "conv3x3_fwd": "frame2frame_tpu_torch/csrc/conv3x3.cu",
    "dw_conv3x3": "frame2frame_tpu_torch/csrc/conv3x3.cu",
}


class SmokeFailure(Exception):
    pass


def read_png_gray8(path):
    """An 8-bit greyscale, non-interlaced PNG as uint8 (H, W), decoded with
    the standard library: the machine with the card may have no PIL."""
    import struct
    import zlib

    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, b"", None
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
    w, h, depth, colour, _, _, interlace = header
    if (depth, colour, interlace) != (8, 0, 0):
        raise ValueError(f"{path}: only 8-bit greyscale without interlacing")
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w + 1)
    out = np.zeros((h + 1, w + 1), np.int32)  # a zero row above, column left
    for y in range(h):
        kind, line = int(raw[y, 0]), raw[y, 1:].astype(np.int32)
        up = out[y, 1:]
        if kind in (0, 2):  # None, Up
            out[y + 1, 1:] = (line + (up if kind else 0)) & 255
            continue
        for x in range(w):  # Sub, Average, Paeth: need the pixel to the left
            a, b, c = int(out[y + 1, x]), int(up[x]), int(out[y, x])
            if kind == 1:
                pred = a
            elif kind == 3:
                pred = (a + b) // 2
            elif kind == 4:
                pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            else:
                raise ValueError(f"{path}: unknown filter type {kind}")
            out[y + 1, x + 1] = (int(line[x]) + pred) & 255
    return out[1:, 1:].astype(np.uint8)


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def no_tf32(fn):
    """``fn`` run inside the port's local context that turns cuDNN's TF32
    off (``ops._common._cudnn_f32``): a library yardstick on f32 operands
    computes in f32, as the port's convolutions do, and the caller's flags
    are left as they were."""
    from frame2frame_tpu_torch.ops._common import _cudnn_f32

    def run():
        with _cudnn_f32():
            return fn()
    return run


def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def ptxas_entries(report):
    """(kernel, registers, spill line) for each entry function in the
    output of ``nvcc -Xptxas -v``."""
    entry = spill = None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry, spill = m.group(1), None
        elif "spill" in line:
            spill = line.strip()
        elif entry and (m := re.search(r"Used (\d+) registers", line)):
            yield entry, m.group(1), spill
            entry = None


def bound_ms(nbytes, flops, flop_per_s=BF16_FLOP_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# frames that leave partial 8 x 16 tiles in both directions, frames narrower
# than one tile, and a ragged full-size frame whose blocks take many tiles
# through the forward kernels' ring of stages
EDGE_SHAPES = ((3, 13, 20), (2, 37, 50), (1, 5, 7), (1, 1, 1), (1, 541, 963))


def edge_shapes(torch, fs, w, s, b):
    """Both kernels at the edge shapes, in both storage dtypes, against the
    plain versions."""
    rng = np.random.default_rng(1)
    for B, h, wd in EDGE_SHAPES:
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


def host_us_per_call(torch, fs, wk, s, b, n=400):
    """Host microseconds a ``fwd_layer`` call at a tiny frame (the device is
    never the limit), the wrapper's and the launch's (two TMA tensor maps
    encoded a call), on one input and cycling through 16."""
    xs = [torch.randn(1, 8, 16, FEAT, device="cuda").to(torch.bfloat16)
          for _ in range(16)]
    us = {}
    for what, pick in (("one input", lambda i: xs[0]),
                       ("16 inputs", lambda i: xs[i % 16])):
        for i in range(32):
            fs.fwd_layer(pick(i), wk, s, b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            fs.fwd_layer(pick(i), wk, s, b)
        us[what] = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
    print("fwd_layer host us a call: " + ", ".join(
        f"{k} {v:.1f}" for k, v in us.items()), flush=True)


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
        return no_tf32(lambda: F.conv2d(x, w_lib, padding=1))

    cases = []
    for B in (1, 4):
        for dt in (torch.bfloat16, torch.float32):
            zb = z4[:B].to(dt).contiguous()
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
    host_us_per_call(torch, fs, wk, s, b)
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


def rel_err(got, ref):
    """(max |got - ref|, max |ref|) over f32 copies."""
    return (float((got.float() - ref.float()).abs().max()),
            float(ref.float().abs().max()))


def hold_close(tag, what, got, ref, rtol, atol=1e-6):
    err, scale = rel_err(got, ref)
    check(got.shape == ref.shape and got.dtype == ref.dtype,
          f"{tag} {what}: shape/dtype {tuple(got.shape)} {got.dtype}")
    check(err <= rtol * scale + atol,
          f"{tag} {what}: max|kernel-plain| {err} > {rtol} * {scale}")
    return err, scale


def train_inputs(torch, rng, shape, dt):
    """Inputs of the training kernels at ``shape`` (B, H, W): z_prev, z_i, g
    in ``dt`` and the (8, 64) vectors of one backward layer."""
    def t(scale=1.0):
        return (scale * torch.from_numpy(rng.standard_normal(
            shape + (FEAT,), dtype=np.float32)).cuda()).to(dt).contiguous()

    def vec(mean, std):
        return mean + std * rng.standard_normal(FEAT)

    vecs = np.stack([vec(1.0, 0.2), vec(0.0, 0.1), vec(0.0, 1e-3),
                     vec(0.0, 1e-3), vec(1.0, 0.2), vec(0.0, 0.1),
                     0.5 + rng.random(FEAT), vec(0.0, 0.1)])
    return t(), t(), t(0.1), torch.from_numpy(vecs.astype(np.float32)).cuda()


def hold_train_kernels(torch, fs, tag, z_prev, z_i, g, w, wk, vecs, vb=None):
    """``fwd_layer_train`` and ``bwd_layer`` (``first_layer`` both ways)
    against their plain versions with the kernels' operand rounding, with
    the row window ``vb`` where given; returns the errors by output."""
    errs = {}
    s, b = vecs[fs.V_SP].contiguous(), vecs[fs.V_BP].contiguous()
    z, stats = fs.fwd_layer_train(z_prev, wk, s, b, valid_bounds=vb)
    torch.cuda.synchronize()
    z_ref, stats_ref = fs.fwd_layer_train_plain(z_prev, w, s, b,
                                                mma_bf16=True,
                                                valid_bounds=vb)
    errs["z"] = hold_close(tag, "z", z, z_ref, KERNEL_RTOL)
    for k, name in enumerate(("sum_z", "sum_z2")):
        errs[name] = hold_close(tag, name, stats[k], stats_ref[k], SUMS_RTOL)
    for first in (False, True):
        sfx = "_first" if first else ""
        da, dw, sp = fs.bwd_layer(g, z_i, z_prev, wk, vecs, first,
                                  valid_bounds=vb)
        torch.cuda.synchronize()
        da_ref, dw_ref, sp_ref = fs.bwd_layer_plain(g, z_i, z_prev, w, vecs,
                                                    first, mma_bf16=True,
                                                    valid_bounds=vb)
        errs["da" + sfx] = hold_close(tag, "da" + sfx, da, da_ref, KERNEL_RTOL)
        errs["dW" + sfx] = hold_close(tag, "dW" + sfx, dw, dw_ref, SUMS_RTOL)
        for k, name in enumerate(("sum_gp", "sum_gp_zhat")):
            errs[name + sfx] = hold_close(tag, name + sfx, sp[k], sp_ref[k],
                                    SUMS_RTOL)
    return errs


def train_kernel_phase(torch, F, fs, cuda_time_ms):
    """The training kernels against their plain versions; returns the
    per-kernel rows."""
    rng = np.random.default_rng(2)
    w = torch.from_numpy((rng.standard_normal((3, 3, FEAT, FEAT))
                          * np.sqrt(2.0 / (9 * FEAT))).astype(np.float32)).cuda()
    wk = fs.kernel_weights(w)
    for shape in EDGE_SHAPES:
        for dt in (torch.bfloat16, torch.float32):
            z_prev, z_i, g, vecs = train_inputs(torch, rng, shape, dt)
            hold_train_kernels(torch, fs, f"train kernels {shape} {dt}",
                               z_prev, z_i, g, w, wk, vecs)
    print("training kernel edge shapes: ok", flush=True)

    z_prev, z_i, g, vecs = train_inputs(torch, rng, (1, H, W), torch.bfloat16)
    errs = hold_train_kernels(torch, fs, "train kernels 540p bf16", z_prev,
                              z_i, g, w, wk, vecs)
    print("training kernels 540p bf16: " + ", ".join(
        f"{k} {e:.3e}/{s:.3e}" for k, (e, s) in errs.items()), flush=True)
    # the same inputs twice: the reductions must give the same bits
    s, b = vecs[fs.V_SP].contiguous(), vecs[fs.V_BP].contiguous()
    for what, fn in (("fwd_layer_train", lambda: fs.fwd_layer_train(
            z_prev, wk, s, b)[1]), ("bwd_layer", lambda: torch.cat([
                o.reshape(-1) for o in fs.bwd_layer(
                    g, z_i, z_prev, wk, vecs, False)[1:]]))):
        check(torch.equal(fn(), fn()), f"{what}: sums differ between two "
              "runs on the same inputs")

    # library yardsticks on bf16 channels-last, operands prepared outside
    w_lib = w.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    a_lib = torch.relu(z_prev.float() * s + b).to(torch.bfloat16).permute(
        0, 3, 1, 2)
    dz_lib = g.permute(0, 3, 1, 2)

    library_bwd = no_tf32(lambda: torch.ops.aten.convolution_backward(
        dz_lib, a_lib, w_lib, None, [1, 1], [1, 1], [1, 1], False,
        [0, 0], 1, [True, True, False]))

    act = z_prev.numel() * z_prev.element_size()
    small = wk.numel() * wk.element_size() + 2 * FEAT * 4
    flops = 2 * H * W * FEAT * FEAT * 9
    rows = {}
    for name, kern, plain, library, nbytes, nflops, err in (
            ("fwd_layer_train",
             lambda: fs.fwd_layer_train(z_prev, wk, s, b),
             lambda: fs.fwd_layer_train_plain(z_prev, w, s, b, mma_bf16=True),
             no_tf32(lambda: F.conv2d(a_lib, w_lib, padding=1)),
             2 * act + small + 2 * FEAT * 4, flops, errs["z"]),
            ("bwd_layer",
             lambda: fs.bwd_layer(g, z_i, z_prev, wk, vecs, False),
             lambda: fs.bwd_layer_plain(g, z_i, z_prev, w, vecs, False,
                                        mma_bf16=True),
             library_bwd,
             4 * act + small + 8 * FEAT * 4 + 9 * FEAT * FEAT * 4,
             2 * flops, errs["da"])):
        ms = cuda_time_ms(kern)
        plain_ms = cuda_time_ms(plain, iters=5)
        library_ms = cuda_time_ms(library)
        bms, by = bound_ms(nbytes, nflops)
        rows[name] = [{
            "B": 1, "dtype": "bfloat16", "max_abs_err": err[0],
            "max_abs_plain": err[1], "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bms, "bound_by": by,
            "errors": {k: {"max_abs_err": e, "max_abs_plain": sc}
                       for k, (e, sc) in errs.items()}}]
        print(f"kernel {name} B=1 bfloat16: err {err[0]:.3e} (plain max "
              f"{err[1]:.3e}) ms {ms:.4f} plain {plain_ms:.4f} library "
              f"{library_ms:.4f} bound {bms:.4f} ({by})", flush=True)
    # the training forward at B=4 and on the f32 chain too
    for B, dt in ((4, torch.bfloat16), (1, torch.float32)):
        zp, _, _, _ = train_inputs(torch, rng, (B, H, W), dt)
        z, stats = fs.fwd_layer_train(zp, wk, s, b)
        torch.cuda.synchronize()
        z_ref, stats_ref = fs.fwd_layer_train_plain(zp, w, s, b, mma_bf16=True)
        tag = f"fwd_layer_train B={B} {str(dt).replace('torch.', '')}"
        err = hold_close(tag, "z", z, z_ref, KERNEL_RTOL)
        for k, name in enumerate(("sum_z", "sum_z2")):
            hold_close(tag, name, stats[k], stats_ref[k], SUMS_RTOL)
        check(torch.equal(fs.fwd_layer_train(zp, wk, s, b)[1], stats),
              f"{tag}: sums differ between two runs on the same inputs")
        a_lib = torch.relu(zp.float() * s + b).to(torch.bfloat16).permute(
            0, 3, 1, 2)
        ms = cuda_time_ms(lambda: fs.fwd_layer_train(zp, wk, s, b))
        plain_ms = cuda_time_ms(lambda: fs.fwd_layer_train_plain(
            zp, w, s, b, mma_bf16=True), iters=5)
        library_ms = cuda_time_ms(no_tf32(lambda: F.conv2d(a_lib, w_lib,
                                                           padding=1)))
        bms, by = bound_ms(2 * zp.numel() * zp.element_size() + small
                           + 2 * FEAT * 4, B * flops)
        rows["fwd_layer_train"].append({
            "B": B, "dtype": str(dt).replace("torch.", ""),
            "max_abs_err": err[0], "max_abs_plain": err[1], "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bms,
            "bound_by": by})
        print(f"kernel {tag}: err {err[0]:.3e} (plain max {err[1]:.3e}) ms "
              f"{ms:.4f} plain {plain_ms:.4f} library {library_ms:.4f} "
              f"bound {bms:.4f} ({by})", flush=True)
        del zp, z, z_ref
    # as run, bwd_layer reads g, z_i and z_prev as (8+2) x (16+2) halo tiles
    # of its 8 x 16 pixel tiles
    halo = (8 + 2) * (16 + 2) / (8 * 16)
    rows["bwd_layer"][0]["bound_ms_as_run"] = bound_ms(
        (3 * halo + 1) * act + small, 2 * flops)[0]
    torch.cuda.empty_cache()
    return rows


def ends_inputs(torch, rng, h, wd, dt):
    """Inputs of the four end kernels for one (h, wd) frame on a ``dt``
    chain: the frame and its loss constants, z_L and da0, and the last
    BatchNorm's vectors."""
    def img():
        return torch.from_numpy(rng.random((h, wd), dtype=np.float32)).cuda()

    def act(scale=1.0):
        return (scale * torch.from_numpy(rng.standard_normal(
            (1, h, wd, FEAT), dtype=np.float32)).cuda()).to(dt).contiguous()

    def vec(mean, std):
        return mean + std * rng.standard_normal(FEAT)

    mask = (img() > 0.1).float()
    vecs = torch.from_numpy(np.stack([
        vec(1.0, 0.2), vec(0.0, 0.1), 0.5 + rng.random(FEAT),
        vec(0.0, 0.1)]).astype(np.float32)).cuda()
    x = img()
    return {"x": x.to(dt).contiguous(), "aux_c": mask * x - mask * img(),
            "aux_m": mask, "z": act(), "da": act(0.1), "vecs": vecs}


def hold_end_kernels(torch, fe, tag, d, w_in, w_out):
    """The four end kernels against their plain versions with the kernels'
    operand rounding; ``last_loss_bwd`` and ``first_dw`` from the kernels'
    own forward outputs, so both sides decide the same signs and masks.
    Returns the errors by output."""
    errs = {}
    s, b = d["vecs"][fe.E_S].contiguous(), d["vecs"][fe.E_B].contiguous()
    z1 = fe.first_conv(d["x"], w_in)
    torch.cuda.synchronize()
    errs["z1"] = hold_close(tag, "z1", z1, fe.first_conv_plain(
        d["x"], w_in, mma_bf16=True), KERNEL_RTOL)
    noise, loss = fe.last_loss_fwd(d["z"], s, b, w_out, d["aux_c"],
                                   d["aux_m"])
    torch.cuda.synchronize()
    noise_ref, loss_ref = fe.last_loss_fwd_plain(
        d["z"], s, b, w_out, d["aux_c"], d["aux_m"], mma_bf16=True)
    errs["noise"] = hold_close(tag, "noise", noise, noise_ref, ENDS_F32_RTOL)
    errs["loss"] = hold_close(tag, "loss", loss, loss_ref, ENDS_F32_RTOL)
    g, dw_out, stats = fe.last_loss_bwd(noise, d["aux_c"], d["aux_m"],
                                        d["z"], w_out, d["vecs"])
    torch.cuda.synchronize()
    g_ref, dw_ref, stats_ref = fe.last_loss_bwd_plain(
        noise, d["aux_c"], d["aux_m"], d["z"], w_out, d["vecs"],
        mma_bf16=True)
    errs["g_L"] = hold_close(tag, "g_L", g, g_ref, KERNEL_RTOL)
    errs["dW_out"] = hold_close(tag, "dW_out", dw_out.contiguous(), dw_ref,
                                SUMS_RTOL)
    for k, name in enumerate(("sum_gp_L", "sum_gp_zhat_L")):
        errs[name] = hold_close(tag, name, stats[k], stats_ref[k], SUMS_RTOL)
    dw_in = fe.first_dw(d["da"], z1, d["x"])
    torch.cuda.synchronize()
    errs["dW_in"] = hold_close(tag, "dW_in", dw_in, fe.first_dw_plain(
        d["da"], z1, d["x"], mma_bf16=True), SUMS_RTOL)
    for name, (err, _) in errs.items():
        check(np.isfinite(err), f"{tag} {name}: non-finite output")
    return errs, z1, noise


def positive_b(fe, vecs):
    """The last BatchNorm's vectors with b drawn so that relu(b) > 0 in
    every channel: SAME padding applies to a, not to z, so a pixel outside
    the image must give a = 0, not relu(b)."""
    vecs = vecs.clone()
    vecs[fe.E_B] = vecs[fe.E_B].abs() + 0.05
    return vecs


def hold_last_fwd(torch, fe, tag, d, w_out):
    """``last_loss_fwd`` with ``b`` drawn so that relu(b) > 0 in every
    channel (``positive_b``) against its plain version with the kernel's
    operand rounding, and the same bits on two runs. Returns the noise's
    and the loss's (max |kernel - plain|, max |plain|)."""
    vecs = positive_b(fe, d["vecs"])
    s, b = vecs[fe.E_S].contiguous(), vecs[fe.E_B].contiguous()
    args = (d["z"], s, b, w_out, d["aux_c"], d["aux_m"])
    noise, loss = fe.last_loss_fwd(*args)
    noise2, loss2 = fe.last_loss_fwd(*args)
    torch.cuda.synchronize()
    check(torch.equal(noise, noise2) and torch.equal(loss, loss2),
          f"{tag}: two runs on the same inputs differ")
    noise_ref, loss_ref = fe.last_loss_fwd_plain(*args, mma_bf16=True)
    check(bool(torch.isfinite(noise).all()) and bool(torch.isfinite(loss)),
          f"{tag}: non-finite output")
    return (hold_close(tag, "noise", noise, noise_ref, ENDS_F32_RTOL),
            hold_close(tag, "loss", loss, loss_ref, ENDS_F32_RTOL))


def hold_last_bwd(torch, fe, tag, d, w_out, vecs):
    """``last_loss_bwd`` from the kernel forward's own noise (so both sides
    decide the same L1 signs) against its plain version with the kernel's
    operand rounding, and the same bits on two runs. Returns the errors by
    output and the noise."""
    s, b = vecs[fe.E_S].contiguous(), vecs[fe.E_B].contiguous()
    noise, _ = fe.last_loss_fwd(d["z"], s, b, w_out, d["aux_c"], d["aux_m"])
    args = (noise, d["aux_c"], d["aux_m"], d["z"], w_out, vecs)
    g, dw_out, stats = fe.last_loss_bwd(*args)
    g2, dw_out2, stats2 = fe.last_loss_bwd(*args)
    torch.cuda.synchronize()
    check(torch.equal(g, g2) and torch.equal(dw_out, dw_out2)
          and torch.equal(stats, stats2),
          f"{tag}: two runs on the same inputs differ")
    g_ref, dw_ref, stats_ref = fe.last_loss_bwd_plain(*args, mma_bf16=True)
    errs = {"g_L": hold_close(tag, "g_L", g, g_ref, KERNEL_RTOL),
            "dW_out": hold_close(tag, "dW_out", dw_out.contiguous(), dw_ref,
                                 SUMS_RTOL)}
    for k, name in enumerate(("sum_gp_L", "sum_gp_zhat_L")):
        errs[name] = hold_close(tag, name, stats[k], stats_ref[k], SUMS_RTOL)
    for name, (err, _) in errs.items():
        check(np.isfinite(err), f"{tag} {name}: non-finite output")
    return errs, noise


def ends_kernel_phase(torch, F, fe, cuda_time_ms):
    """The flat step's end kernels against their plain versions; returns the
    per-kernel rows."""
    rng = np.random.default_rng(4)
    w_in = torch.from_numpy((rng.standard_normal((3, 3, 1, FEAT))
                             * np.sqrt(2.0 / 9)).astype(np.float32)).cuda()
    w_out = torch.from_numpy((rng.standard_normal((3, 3, FEAT, 1))
                              * np.sqrt(2.0 / (9 * FEAT))).astype(np.float32)).cuda()
    for h, wd in ((13, 20), (37, 50), (5, 7), (1, 1)):
        for dt in (torch.bfloat16, torch.float32):
            hold_end_kernels(torch, fe, f"end kernels {(h, wd)} {dt}",
                             ends_inputs(torch, rng, h, wd, dt), w_in, w_out)
    print("end kernel edge shapes: ok", flush=True)
    for h, wd in ((H, W), (541, 963), (1, 1), (2, 3), (13, 21)):
        for dt in (torch.bfloat16, torch.float32):
            d = ends_inputs(torch, rng, h, wd, dt)
            tag = f"last_loss_fwd {(h, wd)} {dt} relu(b) > 0"
            (en, sn), (el, sl) = hold_last_fwd(torch, fe, tag, d, w_out)
            print(f"{tag}: noise {en:.3e}/{sn:.3e}, loss {el:.3e}/{sl:.3e}, "
                  "the same bits on two runs", flush=True)
            tag = f"last_loss_bwd {(h, wd)} {dt} relu(b) > 0"
            errs, _ = hold_last_bwd(torch, fe, tag, d, w_out,
                                    positive_b(fe, d["vecs"]))
            print(f"{tag}: " + ", ".join(
                f"{k} {e:.3e}/{sc:.3e}" for k, (e, sc) in errs.items())
                + ", the same bits on two runs", flush=True)
            del d

    d = ends_inputs(torch, rng, H, W, torch.bfloat16)
    errs, z1, noise = hold_end_kernels(torch, fe, "end kernels 540p bf16", d,
                                       w_in, w_out)
    print("end kernels 540p bf16: " + ", ".join(
        f"{k} {e:.3e}/{s:.3e}" for k, (e, s) in errs.items()), flush=True)
    s, b = d["vecs"][fe.E_S].contiguous(), d["vecs"][fe.E_B].contiguous()
    kern = {
        "first_conv": lambda: fe.first_conv(d["x"], w_in),
        "last_loss_fwd": lambda: fe.last_loss_fwd(
            d["z"], s, b, w_out, d["aux_c"], d["aux_m"]),
        "last_loss_bwd": lambda: fe.last_loss_bwd(
            noise, d["aux_c"], d["aux_m"], d["z"], w_out, d["vecs"]),
        "first_dw": lambda: fe.first_dw(d["da"], z1, d["x"]),
    }
    plain = {
        "first_conv": lambda: fe.first_conv_plain(d["x"], w_in, mma_bf16=True),
        "last_loss_fwd": lambda: fe.last_loss_fwd_plain(
            d["z"], s, b, w_out, d["aux_c"], d["aux_m"], mma_bf16=True),
        "last_loss_bwd": lambda: fe.last_loss_bwd_plain(
            noise, d["aux_c"], d["aux_m"], d["z"], w_out, d["vecs"],
            mma_bf16=True),
        "first_dw": lambda: fe.first_dw_plain(d["da"], z1, d["x"],
                                              mma_bf16=True),
    }
    # the same inputs twice: the reductions must give the same bits
    for name in ("last_loss_fwd", "last_loss_bwd", "first_dw"):
        def sums():
            out = kern[name]()
            out = out[1:] if isinstance(out, tuple) else (out,)
            return torch.cat([o.reshape(-1) for o in out])
        check(torch.equal(sums(), sums()), f"{name}: sums differ between "
              "two runs on the same inputs")

    # library yardsticks on bf16 channels-last, operands prepared outside:
    # one call computes first_conv and first_dw; last_loss_fwd and
    # last_loss_bwd are several functions at once (affine + ReLU, conv, loss;
    # sign, transposed conv, weight gradient, masked sums) and have none
    x_lib = d["x"][None, None].contiguous(memory_format=torch.channels_last)
    w_in_lib = w_in.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    gp_lib = (d["da"] * (z1 > 0)).permute(0, 3, 1, 2)
    library = {
        "first_conv": no_tf32(lambda: F.conv2d(x_lib, w_in_lib, padding=1)),
        "first_dw": no_tf32(lambda: torch.nn.grad.conv2d_weight(
            x_lib, (FEAT, 1, 3, 3), gp_lib, padding=1)),
    }

    def nbytes(*tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    conv_flops = 2 * H * W * 9 * FEAT
    g = torch.empty_like(d["z"])
    small = torch.empty(9 * FEAT, dtype=torch.float32)
    work = {
        "first_conv": (nbytes(d["x"], w_in, z1), conv_flops, errs["z1"]),
        "last_loss_fwd": (nbytes(d["z"], s, b, w_out, d["aux_c"], d["aux_m"],
                                 noise) + 4, conv_flops, errs["noise"]),
        "last_loss_bwd": (nbytes(noise, d["aux_c"], d["aux_m"], d["z"], w_out,
                                 d["vecs"], g, small) + 2 * FEAT * 4,
                          2 * conv_flops, errs["g_L"]),
        "first_dw": (nbytes(d["da"], z1, d["x"], small), conv_flops,
                     errs["dW_in"]),
    }
    own = {"first_conv": ("z1",), "last_loss_fwd": ("noise", "loss"),
           "last_loss_bwd": ("g_L", "dW_out", "sum_gp_L", "sum_gp_zhat_L"),
           "first_dw": ("dW_in",)}
    rows = {}
    for name, (nb, flops, err) in work.items():
        ms = cuda_time_ms(kern[name], head_start_cycles=HEAD_START_CYCLES)
        plain_ms = cuda_time_ms(plain[name], iters=5)
        library_ms = (cuda_time_ms(library[name],
                                   head_start_cycles=HEAD_START_CYCLES)
                      if name in library else None)
        bms, by = bound_ms(nb, flops)
        rows[name] = [{
            "B": 1, "dtype": "bfloat16", "max_abs_err": err[0],
            "max_abs_plain": err[1], "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bms, "bound_by": by,
            "errors": {k: {"max_abs_err": errs[k][0],
                           "max_abs_plain": errs[k][1]} for k in own[name]}}]
        lib = "none" if library_ms is None else f"{library_ms:.4f}"
        print(f"kernel {name} B=1 bfloat16: err {err[0]:.3e} (plain max "
              f"{err[1]:.3e}) ms {ms:.4f} plain {plain_ms:.4f} library "
              f"{lib} bound {bms:.4f} ({by})", flush=True)

    # last_loss_fwd on the f32 chain: 4 bytes an activation
    d32 = ends_inputs(torch, rng, H, W, torch.float32)
    s32, b32 = (d32["vecs"][k].contiguous() for k in (fe.E_S, fe.E_B))
    (err32, scale32), _ = hold_last_fwd(torch, fe, "last_loss_fwd 540p f32",
                                        d32, w_out)
    args32 = (d32["z"], s32, b32, w_out, d32["aux_c"], d32["aux_m"])
    ms = cuda_time_ms(lambda: fe.last_loss_fwd(*args32),
                      head_start_cycles=HEAD_START_CYCLES)
    plain_ms = cuda_time_ms(lambda: fe.last_loss_fwd_plain(
        *args32, mma_bf16=True), iters=5)
    bms, by = bound_ms(nbytes(*args32, noise) + 4, conv_flops)
    rows["last_loss_fwd"].append({
        "B": 1, "dtype": "float32", "max_abs_err": err32,
        "max_abs_plain": scale32, "ms": ms, "plain_ms": plain_ms,
        "library_ms": None, "bound_ms": bms, "bound_by": by})
    print(f"kernel last_loss_fwd B=1 float32: err {err32:.3e} (plain max "
          f"{scale32:.3e}) ms {ms:.4f} plain {plain_ms:.4f} library none "
          f"bound {bms:.4f} ({by})", flush=True)
    # last_loss_bwd on the f32 chain: z read and g written at 4 bytes
    errs32, noise32 = hold_last_bwd(torch, fe, "last_loss_bwd 540p f32", d32,
                                    w_out, d32["vecs"])
    args32 = (noise32, d32["aux_c"], d32["aux_m"], d32["z"], w_out,
              d32["vecs"])
    ms = cuda_time_ms(lambda: fe.last_loss_bwd(*args32),
                      head_start_cycles=HEAD_START_CYCLES)
    plain_ms = cuda_time_ms(lambda: fe.last_loss_bwd_plain(
        *args32, mma_bf16=True), iters=5)
    bms, by = bound_ms(nbytes(*args32, torch.empty_like(d32["z"]), small)
                       + 2 * FEAT * 4, 2 * conv_flops)
    err32, scale32 = errs32["g_L"]
    rows["last_loss_bwd"].append({
        "B": 1, "dtype": "float32", "max_abs_err": err32,
        "max_abs_plain": scale32, "ms": ms, "plain_ms": plain_ms,
        "library_ms": None, "bound_ms": bms, "bound_by": by,
        "errors": {k: {"max_abs_err": e, "max_abs_plain": sc}
                   for k, (e, sc) in errs32.items()}})
    print(f"kernel last_loss_bwd B=1 float32: err {err32:.3e} (plain max "
          f"{scale32:.3e}) ms {ms:.4f} plain {plain_ms:.4f} library none "
          f"bound {bms:.4f} ({by}); " + ", ".join(
              f"{k} {e:.3e}/{sc:.3e}" for k, (e, sc) in errs32.items()),
          flush=True)
    del d32, args32, noise32
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


def device_kernels(torch, prof):
    """``{name: [calls, ms]}`` of what a torch.profiler record shows to have
    run on the device, a graph's replayed kernels included."""
    kernels = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(e.name[:70], [0, 0.0])
            k[0] += 1
            k[1] += e.time_range.elapsed_us() / 1e3
    return kernels


def calls_of(kernels, name):
    """Calls of the device kernels whose name holds ``name``."""
    return sum(c for n, (c, _) in kernels.items() if name in n)


def profile_call(torch, fn, iters=10, top=6, count=None):
    """Host-clock milliseconds per call of ``fn`` (median of ``iters``, each
    ending in a synchronize), then one torch.profiler pass over ``iters``
    calls: device kernel time per call, the device's busy share of the
    profiled wall time, the number of device kernels and of the library's
    weight-gradient kernels among them per call (and, under ``counted`` and
    ``counted_ms``, the calls and device ms of the kernels whose name holds
    ``count``), and the kernels by device time."""
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
    kernels = device_kernels(torch, prof)
    device_ms = sum(v[1] for v in kernels.values())
    wgrad = sum(c for n, (c, _) in kernels.items() if "wgrad" in n.lower())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:top]
    return {"ms": float(np.median(ts)),
            "device_ms": device_ms / iters if kernels else None,
            "busy_share": device_ms / wall_ms if kernels else None,
            "device_kernels": sum(c for c, _ in kernels.values()) // iters,
            "library_wgrad_kernels": wgrad // iters,
            "counted": calls_of(kernels, count) / iters if count else None,
            "counted_ms": (sum(t for n, (_, t) in kernels.items()
                               if count in n) / iters if count else None),
            "top_kernels": [{"name": n, "calls": c // iters,
                             "ms": t / iters} for n, (c, t) in top]}


def moving_frames(n, seed=3):
    """``n`` 540p frames of one textured scene that moves by a known
    displacement per frame, and the flow from each frame to the one before.

    The scene is an analytic texture sampled at displaced coordinates, so
    sub-pixel motion needs no interpolation: a global translation of
    (0.6, -0.4) px a frame, a smooth vertical wave of 0.3 px, and a
    rectangle that moves 3 px a frame faster than its surround, whose edges
    the occlusion mask must reject. Returns (clean, noisy) (n, H, W, 1) f32
    and flows (n, H, W, 2) f32 (``flows[k]``: frame k -> frame k-1; entry 0
    unused), noise sigma 25/255."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    waves = [(rng.uniform(0.002, 0.03, 2), rng.uniform(0, 2 * np.pi),
              rng.uniform(0.3, 1.0)) for _ in range(6)]
    discs = [(rng.uniform(0, H), rng.uniform(0, W), rng.uniform(20, 120),
              rng.uniform(-1, 1)) for _ in range(8)]

    def scene(y, x):
        img = np.zeros_like(y)
        for (fy, fx), ph, amp in waves:
            img += amp * np.sin(2 * np.pi * (fy * y + fx * x) + ph)
        for cy, cx, r, amp in discs:
            img += amp / (1.0 + np.exp((np.hypot(y - cy, x - cx) - r) / 2.0))
        return img

    rect = ((yy > 0.3 * H) & (yy < 0.6 * H) & (xx > 0.4 * W) & (xx < 0.7 * W))
    u = 0.6 + 3.0 * rect                      # x displacement a frame
    v = -0.4 + 0.3 * np.sin(2 * np.pi * xx / 400.0)
    clean = np.stack([scene(yy + k * v, xx + k * u) for k in range(n)])
    clean = 0.1 + 0.8 * (clean - clean.min()) / (clean.max() - clean.min())
    clean = clean[..., None].astype(np.float32)
    noisy = clean + SIGMA * rng.standard_normal(clean.shape).astype(np.float32)
    # frame k samples the scene at p + k d(p), frame k-1 at p + (k-1) d(p):
    # the content of frame k at p lies in frame k-1 at p + d(p), exactly
    # where d is constant around p
    flow = np.stack([u, v], -1).astype(np.float32)
    return clean, noisy.astype(np.float32), np.stack([flow] * n)


def training_phase(torch, fs, psnr, variables, model):
    """The online fine-tune; returns (launch counts of the counted runs on
    the per-iteration route and on the flat route, timings and
    comparisons)."""
    from frame2frame_tpu_torch.models import fused_apply as fa
    from frame2frame_tpu_torch.train import flat_step
    from frame2frame_tpu_torch.models.dncnn import (
        JaxRavel, from_jax_variables, param_leaves)
    from frame2frame_tpu_torch.ops.warp import (
        bilinear_warp_with_mask, occlusion_mask)
    from frame2frame_tpu_torch.train.online import OnlineDenoiser, torch_adam

    dev = torch.device("cuda")
    clean, noisy, flows = moving_frames(3)
    frames = torch.from_numpy(noisy).to(dev)
    flow_t = torch.from_numpy(flows).to(dev)
    out = {}

    def mask_and_target(k):
        with torch.no_grad():
            warped, mask = bilinear_warp_with_mask(frames[k - 1], flow_t[k])
            mask = occlusion_mask(flow_t[k], mask)
        return mask, mask * warped

    mask, target = mask_and_target(1)
    kept = float(mask.mean())
    # the flow is right: the warped clean frame lies on the clean frame
    with torch.no_grad():
        cw, _ = bilinear_warp_with_mask(torch.from_numpy(clean[0]).to(dev),
                                        flow_t[1])
        align = float((mask * (cw - torch.from_numpy(clean[1]).to(dev)))
                      .abs().sum() / mask.sum())
    print(f"training: mask keeps {kept:.4f} of the pixels, mean |warped "
          f"clean - clean| under it {align:.5f}", flush=True)
    check(0.5 < kept < 0.999, f"occlusion mask keeps {kept} of the pixels")
    check(align < 5e-3, f"flow misaligns the clean frames by {align}")

    # (a) one step on the kernels against the same step on their plain
    # versions. Two forwards that round one operand differently drift apart
    # layer by layer (each rounding to bf16 and each ReLU is a decision), and
    # the pretrained model sits near its optimum, where a gradient entry is
    # a sum of 518 400 terms that nearly cancel: a few hundred decisions
    # that fall the other way move it by percents, whatever computed it.
    # So the forward is held by what it delivers (loss, batch statistics),
    # and the backward kernels are held against their plain versions from
    # the SAME forward, the kernels'. The gradients of the two independent
    # routes are printed beside that.
    def one_step(mid_stack):
        m = copy.deepcopy(model).to(dev)
        y = fa.fused_train_apply(m, frames[1][None], mid_stack=mid_stack)[0]
        loss = (mask * y - target).abs().sum()
        loss.backward()
        torch.cuda.synchronize()
        stats = {k: torch.stack([getattr(m.mid(i)[1], k)
                                 for i in range(m.nmid)])
                 for k in ("running_mean", "running_var")}
        return (float(loss.detach()), stats,
                {n: p.grad for n, p in param_leaves(m)})

    def grad_errors(grads, ref):
        rel = {}
        for name, gk in grads.items():
            check(bool(torch.isfinite(gk).all()),
                  f"one step: non-finite gradient of {name}")
            err, scale = rel_err(gk, ref[name])
            rel[name] = err / scale
        return rel

    plain = functools.partial(fs.fused_mid_stack_plain, mma_bf16=True)
    loss_k, stats_k, grads_k = one_step(fs.fused_mid_stack)
    loss_p, stats_p, grads_p = one_step(plain)
    _, _, grads_b = one_step(functools.partial(plain, kernel_forward=True))
    check(np.isfinite(loss_k), "one step: non-finite loss")
    dl = abs(loss_k - loss_p) / abs(loss_p)
    ds = max(e / s for e, s in (rel_err(stats_k[k], stats_p[k])
                                for k in stats_k))
    independent = max(grad_errors(grads_k, grads_p).values())
    rel = grad_errors(grads_k, grads_b)
    by_err = sorted(rel, key=rel.get, reverse=True)
    worst = rel[by_err[0]]
    print(f"training one step: loss kernels {loss_k:.4f} plain {loss_p:.4f} "
          f"(rel {dl:.3e}), running statistics rel {ds:.3e}; gradients "
          f"from the kernels' forward, max|d|/max|ref| over {len(rel)} "
          "parameters, worst first: "
          + ", ".join(f"{n} {rel[n]:.3e}" for n in by_err[:5])
          + f"; from each route's own forward {independent:.3e}", flush=True)
    check(dl <= STEP_LOSS_RTOL, f"one step: loss off plain by {dl}")
    check(ds <= STEP_STATS_RTOL, f"one step: statistics off plain by {ds}")
    check(worst <= STEP_GRAD_RTOL, f"one step: gradient off plain by {worst}")
    out["one_step"] = {"loss": loss_k, "loss_plain": loss_p,
                       "running_stats_rel_err": ds,
                       "worst_grad_rel_err": worst,
                       "worst_grad_rel_err_independent_forwards": independent}
    del grads_b
    del grads_k, grads_p
    torch.cuda.empty_cache()

    # (a') the same for the flat step: loss and batch statistics of the
    # kernels against the plain twin's own forward, gradients against the
    # plain backward from the kernels' forward (its activations and noise)
    with torch.no_grad():
        data = flat_step.prep_frame(frames[1], mask, target)

    def one_flat_step(net_loss):
        m = copy.deepcopy(model).to(dev)
        loss, means, vars_ = net_loss(flat_step.diff_of(m), data)
        loss.backward()
        torch.cuda.synchronize()
        return (float(loss.detach()), {"means": means, "vars": vars_},
                {n: p.grad for n, p in param_leaves(m)})

    twin = functools.partial(flat_step.flat_net_loss_plain, mma_bf16=True)
    loss_k, stats_k, grads_k = one_flat_step(flat_step.flat_net_loss)
    loss_p, stats_p, grads_p = one_flat_step(twin)
    _, _, grads_b = one_flat_step(functools.partial(twin, kernel_forward=True))
    check(np.isfinite(loss_k), "one flat step: non-finite loss")
    dl = abs(loss_k - loss_p) / abs(loss_p)
    ds = max(e / s for e, s in (rel_err(stats_k[k], stats_p[k])
                                for k in stats_k))
    independent = max(grad_errors(grads_k, grads_p).values())
    rel = grad_errors(grads_k, grads_b)
    by_err = sorted(rel, key=rel.get, reverse=True)
    worst = rel[by_err[0]]
    print(f"training one flat step: loss kernels {loss_k:.4f} plain "
          f"{loss_p:.4f} (rel {dl:.3e}), batch statistics rel {ds:.3e}; "
          f"gradients from the kernels' forward, max|d|/max|ref| over "
          f"{len(rel)} parameters, worst first: "
          + ", ".join(f"{n} {rel[n]:.3e}" for n in by_err[:5])
          + f"; from each route's own forward {independent:.3e}", flush=True)
    check(dl <= STEP_LOSS_RTOL, f"one flat step: loss off plain by {dl}")
    check(ds <= STEP_STATS_RTOL, f"one flat step: statistics off plain by {ds}")
    check(worst <= STEP_GRAD_RTOL,
          f"one flat step: gradient off plain by {worst}")
    out["one_flat_step"] = {
        "loss": loss_k, "loss_plain": loss_p, "batch_stats_rel_err": ds,
        "worst_grad_rel_err": worst,
        "worst_grad_rel_err_independent_forwards": independent}
    del grads_b, grads_k, grads_p, data
    torch.cuda.empty_cache()

    # (b) the main path: two fine-tuned frames through the engine, which
    # takes the flat route by itself; then the per-iteration route
    nmid = model.nmid
    ends = ("first_conv", "last_loss_fwd", "last_loss_bwd", "first_dw")
    mids = {"fwd_layer": nmid, "fwd_layer_train": nmid * ITERS,
            "fwd_layer_eval": 0, "bwd_layer": nmid * ITERS}

    def fine_tune(route, eng, want):
        fs.reset_launch_counts()
        denos, losses = [], []
        for k in (1, 2):
            before = dict(fs.launch_counts())
            deno, ls = eng.process_frame(frames[k], frames[k - 1], flow_t[k])
            torch.cuda.synchronize()
            after = fs.launch_counts()
            for name, n in want.items():
                check(after[name] - before[name] == n,
                      f"{route} process_frame {k}: {name} launched "
                      f"{after[name] - before[name]} times, expected {n}")
            ls = ls.cpu().numpy()
            check(deno.shape == (H, W, 1) and ls.shape == (ITERS,),
                  f"{route} process_frame {k}: shapes {tuple(deno.shape)} "
                  f"{ls.shape}")
            check(np.isfinite(ls).all() and bool(torch.isfinite(deno).all()),
                  f"{route} process_frame {k}: non-finite output")
            check(ls[-1] < ls[0], f"{route} process_frame {k}: loss did not "
                  f"fall ({ls[0]} -> {ls[-1]})")
            denos.append(deno.cpu().numpy())
            losses.append(ls)
        return denos, losses, fs.launch_counts()

    eng = OnlineDenoiser(model, variables, iters=ITERS, residual_model=True)
    denos, losses, flat_launches = fine_tune(
        "flat", eng, {**mids, **dict.fromkeys(ends, ITERS)})
    eng_old = OnlineDenoiser(model, variables, iters=ITERS,
                             residual_model=True, flat_step=False)
    old_denos, old_losses, launches = fine_tune(
        "per-iteration", eng_old, {**mids, **dict.fromkeys(ends, 0)})
    routes_loss = max(float(np.abs(a / b - 1).max())
                      for a, b in zip(losses, old_losses))
    routes_deno = max(float(np.sqrt(np.mean((a - b) ** 2)))
                      for a, b in zip(denos, old_denos))
    routes_max = max(float(np.abs(a - b).max())
                     for a, b in zip(denos, old_denos))
    print(f"training routes: flat against per-iteration, worst loss rel "
          f"{routes_loss:.3e}, denoised frames rms {routes_deno:.3e} max "
          f"{routes_max:.3e}", flush=True)
    check(routes_loss <= ROUTES_LOSS_RTOL,
          f"flat route's losses off the per-iteration route's by {routes_loss}")
    check(routes_deno <= ROUTES_DENO_RMS,
          f"flat route's frames off the per-iteration route's by {routes_deno}")
    out["routes"] = {"worst_loss_rel_err": routes_loss,
                     "rms_denoised_diff": routes_deno,
                     "max_abs_denoised_diff": routes_max}

    # (c) the same two frames through the plain module's autograd in f32
    # (conv_impl "xla": the library's convolutions without TF32), with the
    # same optimizer
    ref = from_jax_variables(variables, residual=True,
                             conv_impl="xla").to(dev)
    tx = torch_adam(5e-5, 1e-5)
    flat = JaxRavel(ref)
    state = tx.init(flat.ravel())
    ref_denos, ref_losses = [], []
    for k in (1, 2):
        mask, target = mask_and_target(k)
        ls = []
        ref.train()
        for _ in range(ITERS):
            loss = (mask * ref(frames[k][None])[0] - target).abs().sum()
            ref.zero_grad(set_to_none=True)
            loss.backward()
            upd, state = tx.update(flat.ravel(grads=True), state,
                                   flat.ravel())
            flat.add(upd)
            ls.append(loss.detach())
        ref.eval()
        with torch.no_grad():
            ref_denos.append(ref(frames[k][None])[0].cpu().numpy())
        ref_losses.append(torch.stack(ls).cpu().numpy())
    for route, r_denos, r_losses in (("flat", denos, losses),
                                     ("per-iteration", old_denos, old_losses)):
        worst_loss, worst_psnr = 0.0, 0.0
        for i, k in enumerate((1, 2)):
            dls = float(np.abs(r_losses[i] / ref_losses[i] - 1).max())
            pk, pr = psnr(clean[k], r_denos[i]), psnr(clean[k], ref_denos[i])
            pn = psnr(clean[k], noisy[k])
            d = r_denos[i] - ref_denos[i]
            print(f"training {route} frame {k}: denoised against the f32 "
                  f"module's rms {np.sqrt(np.mean(d ** 2)):.3e} max "
                  f"{np.abs(d).max():.3e}", flush=True)
            print(f"training {route} frame {k}: loss {r_losses[i][0]:.2f} -> "
                  f"{r_losses[i][-1]:.2f} (f32 module {ref_losses[i][0]:.2f} "
                  f"-> {ref_losses[i][-1]:.2f}, worst rel {dls:.3e}); psnr "
                  f"noisy {pn:.4f} kernels {pk:.4f} f32 module {pr:.4f} dB",
                  flush=True)
            check(pk - pn > MIN_GAIN_DB,
                  f"{route} frame {k}: denoising gain {pk - pn} dB")
            worst_loss = max(worst_loss, dls)
            worst_psnr = max(worst_psnr, abs(pk - pr))
            out[f"{route}/frame_{k}"] = {
                "loss_first": float(r_losses[i][0]),
                "loss_last": float(r_losses[i][-1]),
                "psnr_noisy": pn, "psnr": pk, "psnr_f32": pr}
        check(worst_loss <= TRAIN_LOSS_RTOL,
              f"{route}: losses off the f32 module's by {worst_loss}")
        check(worst_psnr <= TRAIN_PSNR_TOL,
              f"{route}: psnr off the f32 module's by {worst_psnr} dB")
        out[f"{route}/worst_loss_rel_err"] = worst_loss
        out[f"{route}/worst_psnr_diff_db"] = worst_psnr
    del ref
    torch.cuda.empty_cache()

    # (d) where a fine-tuned frame's time goes, on both routes in turn
    deno_ms = profile_call(torch, lambda: eng.denoise_only(frames[2]),
                           iters=5)["ms"]
    for key, e in (("process_frame", eng),
                   ("process_frame_per_iteration", eng_old)):
        torch.cuda.reset_peak_memory_stats()
        prof = profile_call(
            torch, lambda: e.process_frame(frames[2], frames[1], flow_t[2]),
            iters=3, top=14)
        prof["iters"] = ITERS
        prof["ms_per_iter"] = (prof["ms"] - deno_ms) / ITERS
        prof["frames_per_s"] = 1e3 / prof["ms"]
        prof["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out[key] = prof
        print(f"training {key}: " + json.dumps(prof), flush=True)
    check(out["process_frame"]["library_wgrad_kernels"] == 0,
          "the flat route ran a library weight-gradient kernel")
    return launches, flat_launches, out


def hold_served(psnr, out, plain, clean, noisy, what):
    """Served frames against the same model's plain f32 forward: max
    difference, PSNR against the plain forward's, and the denoising gain
    over the noisy frames."""
    out = out.cpu().numpy()
    check(out.shape == noisy.shape, f"{what}: shape {out.shape}")
    check(np.isfinite(out).all(), f"{what}: non-finite output")
    B = len(out)
    err = float(np.abs(out - plain).max())
    p = [psnr(clean[k], out[k]) for k in range(B)]
    p_plain = [psnr(clean[k], plain[k]) for k in range(B)]
    p_noisy = [psnr(clean[k], noisy[k]) for k in range(B)]
    dp = max(abs(a - c) for a, c in zip(p, p_plain))
    gain = min(a - c for a, c in zip(p, p_noisy))
    print(f"{what}: max|served-plain| {err:.3e}, psnr {np.mean(p):.4f} dB "
          f"(max |d| vs plain {dp:.4f}), min gain {gain:.4f} dB", flush=True)
    check(err <= SERVE_ATOL, f"{what}: max|served-plain| {err}")
    check(dp <= SERVE_PSNR_TOL, f"{what}: psnr off plain by {dp} dB")
    check(gain > MIN_GAIN_DB, f"{what}: denoising gain {gain} dB")
    return {"max_abs_err": err, "psnr_db": float(np.mean(p)),
            "psnr_vs_plain_db": dp, "min_gain_db": gain}


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
        # the f32 module forward: conv_impl "xla" (the default, "fused",
        # runs the JAX model's bf16 graph on the module route)
        f32_model = from_jax_variables(variables, residual=True,
                                       conv_impl="xla")
        plain = f32_model.to(dev).eval()(
            torch.from_numpy(noisy).to(dev)).cpu().numpy()
        del f32_model
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
        hold_served(psnr, out, plain, clean, noisy, f"serving {what}")

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
    for k in kname.values():
        check(launches[k] > 0, f"{k} was not launched on the serving path")

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
    return launches, timings, variables, model


def flow_inner_inputs(torch, shape, shifts, seed, p_scale=0.0):
    """The ten arrays of one launch of the flow's inner loop on the card,
    built the way ``_tvl1_scale`` builds them: a smooth texture pair a
    ``(dx, dy)`` of ``shifts``, the second image and its gradients warped by
    a starting flow, dual variables of scale ``p_scale``. One pair gives
    ``(ny, nx)`` arrays, several ``(P, ny, nx)``."""
    from frame2frame_tpu_torch.ops.grad import centered_gradient
    from frame2frame_tpu_torch.ops.interp import bicubic_warp

    rng = np.random.default_rng(seed)
    ny, nx = shape
    yy, xx = np.mgrid[0:ny, 0:nx].astype(np.float64)

    def scene(y, x):
        return (128 + 50 * np.sin(0.31 * x + 0.17 * y) + 40 * np.cos(0.23 * y)
                + 30 * np.sin(0.011 * x + 0.007 * x * y / ny))

    def card(a):
        a = np.stack(a).astype(np.float32)
        return torch.from_numpy(a[0] if len(shifts) == 1 else a).cuda()

    I0 = card([scene(yy, xx) for _ in shifts])
    I1 = card([scene(yy + dy, xx + dx) for dx, dy in shifts])
    u1 = card([0.5 * dx + 0.2 * rng.standard_normal(shape) for dx, _ in shifts])
    u2 = card([0.5 * dy + 0.2 * rng.standard_normal(shape) for _, dy in shifts])
    ps = [card([p_scale * rng.standard_normal(shape) for _ in shifts])
          for _ in range(4)]
    I1x, I1y = centered_gradient(I1)
    I1w, I1wx, I1wy = bicubic_warp(
        torch.stack([I1, I1x, I1y], -3), u1.unsqueeze(-3), u2.unsqueeze(-3),
        border_out=True).unbind(-3)
    grad = I1wx * I1wx + I1wy * I1wy
    rho_c = I1w - I1wx * u1 - I1wy * u2 - I0
    return [x.contiguous() for x in (I1wx, I1wy, rho_c, grad, u1, u2, *ps)]


@contextlib.contextmanager
def body_of(ti, plan):
    """``tvl1_inner_loop`` on the body that ``plan`` gives (a cluster plan,
    or None for the cooperative body) in place of the one ``cluster_plan``
    gives the shape: how this script holds both bodies to the plain loop at
    one shape. ``plan="shape"`` changes nothing."""
    chosen = ti.cluster_plan
    if plan != "shape":
        ti.cluster_plan = lambda ny, nx: plan
    try:
        yield
    finally:
        ti.cluster_plan = chosen


def hold_inner_loop(torch, ti, tag, arrays, max_iters, epsilon=0.01,
                    plan="shape"):
    """One launch of the flow's inner loop against its plain version: equal
    iteration counts a pair, the same bits in every output, the same bits on
    a second run. ``plan="shape"`` takes the body that ``cluster_plan``
    gives the shape; a plan or ``None`` (the cooperative body) takes that
    body (``body_of``). Returns (iterations a pair, max |kernel - plain|,
    max |plain|)."""
    kw = dict(tau=0.25, lambda_=0.2, theta=0.3, epsilon=epsilon,
              max_iters=max_iters, return_iterations=True)

    def run():
        with body_of(ti, plan):
            return ti.tvl1_inner_loop(*arrays, **kw)

    got, stats = run()
    torch.cuda.synchronize()
    again, stats2 = run()
    ref, stats_ref = ti.tvl1_inner_loop_plain(*arrays, **kw)
    n, n_ref = stats[:, 0].tolist(), stats_ref[:, 0].tolist()
    check(n == n_ref, f"{tag}: iterations kernel {n} plain {n_ref} (errors "
          f"{stats[:, 1].tolist()} / {stats_ref[:, 1].tolist()})")
    check(torch.equal(stats, stats2)
          and all(torch.equal(a, b) for a, b in zip(got, again)),
          f"{tag}: two runs on the same inputs differ")
    err = scale = 0.0
    for name, g, r in zip(("u1", "u2", "p11", "p12", "p21", "p22"), got, ref):
        check(g.shape == r.shape and g.dtype == r.dtype
              and bool(torch.isfinite(g).all()),
              f"{tag} {name}: shape, dtype or non-finite output")
        e, sc = rel_err(g, r)
        check(torch.equal(g, r), f"{tag} {name}: max|kernel-plain| {e}, "
              "not the same bits")
        err, scale = max(err, e), max(scale, sc)
    check(torch.equal(stats, stats_ref), f"{tag}: last errors differ")
    return [int(x) for x in n], err, scale


def inner_body(ti, shape):
    """Which body of the inner loop ``cluster_plan`` gives a shape."""
    plan = ti.cluster_plan(*shape)
    if plan is None:
        return "cooperative"
    return f"cluster of {plan[0]} block(s) x {plan[1]} tile(s)"


def flow_kernel_phase(torch, cuda_time_ms):
    """The flow's inner loop against its plain version; returns the
    kernel's rows."""
    from frame2frame_tpu_torch.flow import tvl1_inner as ti

    # both bodies at every shape: the one cluster_plan gives it, and the
    # cooperative one where that is the cluster body
    def hold_bodies(tag, arrays, mi, shape):
        out = hold_inner_loop(torch, ti, tag, arrays, mi)
        if ti.cluster_plan(*shape) is not None:
            hold_inner_loop(torch, ti, tag + " cooperative", arrays, mi,
                            plan=None)
        return out

    rng = np.random.default_rng(6)
    for shape in ((1, 1), (2, 3)):  # every pixel takes a border rule
        arrays = [torch.from_numpy(rng.standard_normal(shape)
                                   .astype(np.float32)).cuda()
                  for _ in range(10)]
        arrays[3] = arrays[0] ** 2 + arrays[1] ** 2
        for mi in (1, 30, 300):
            hold_bodies(f"inner loop {shape} max_iters {mi}", arrays, mi,
                        shape)
    seen = {}
    shapes = ((9, 15), (17, 30), (13, 21), (34, 60), (68, 120), (135, 240),
              (270, 480), (H, W))
    for shape in shapes:
        arrays = flow_inner_inputs(torch, shape, [(1.3, -0.7)], seed=shape[0],
                                   p_scale=0.1)
        for mi in (1, 30, 300):
            n, err, _ = hold_bodies(f"inner loop {shape} max_iters {mi}",
                                    arrays, mi, shape)
            seen[shape, mi] = (n[0], err)
    print("inner loop bodies: " + ", ".join(
        f"{sh[0]}x{sh[1]} {inner_body(ti, sh)}" for sh in shapes), flush=True)
    print("inner loop shapes (iterations, max|kernel-plain|; both bodies "
          "bit-equal to the plain loop): " + ", ".join(
              f"{sh[0]}x{sh[1]}/{mi}: {n}, {e:.1e}"
              for (sh, mi), (n, e) in seen.items()), flush=True)
    check(all(n == mi for (_, mi), (n, _) in seen.items() if mi == 1)
          and any(1 < n < 300 for (_, mi), (n, _) in seen.items() if mi == 300),
          "inner loop: no launch stopped on its error before max_iters")

    # a batch of four pairs that stop at different iterations, and each pair
    # alone: the same bits whatever else is in the batch, on both bodies (the
    # cooperative body's batch, per-pair stops and all, is what
    # make_batched_tvl1 takes at levels of more than 144 tiles)
    shifts = [(0.2, 0.1), (2.5, -1.5), (1.0, 0.8), (0.0, 0.0)]
    kw = dict(tau=0.25, lambda_=0.2, theta=0.3, epsilon=0.01, max_iters=300,
              return_iterations=True)
    for shape in ((68, 120), (135, 240)):
        batch = flow_inner_inputs(torch, shape, shifts, seed=7)
        for plan in ("shape", None):
            body = inner_body(ti, shape) if plan == "shape" else "cooperative"
            tag = f"inner loop P=4 {shape} {body}"
            n, err, _ = hold_inner_loop(torch, ti, tag, batch, 300, plan=plan)
            check(len(set(n)) > 2, f"{tag}: pairs stopped alike, {n}")
            with body_of(ti, plan):
                got, stats = ti.tvl1_inner_loop(*batch, **kw)
                for q in range(len(shifts)):
                    alone, s = ti.tvl1_inner_loop(*(x[q] for x in batch),
                                                  **kw)
                    check(torch.equal(s[0], stats[q])
                          and all(torch.equal(a, b[q])
                                  for a, b in zip(alone, got)),
                          f"{tag}: pair {q} differs from its launch alone")
            print(f"inner loop P=4 {shape[0]}x{shape[1]} ({body}): "
                  f"iterations {n}, max|kernel-plain| {err:.1e}, each pair "
                  "equal to its launch alone", flush=True)

    def us_per_iteration(arrays, plan="shape"):
        """(ms of 300 iterations, us an iteration from 300 and 100
        iterations): epsilon 0, so that all of them run."""
        kw = dict(tau=0.25, lambda_=0.2, theta=0.3, epsilon=0.0)

        def run(mi):
            return lambda: ti.tvl1_inner_loop(*arrays, max_iters=mi, **kw)

        with body_of(ti, plan):
            ms300 = cuda_time_ms(run(300), iters=10)
            ms100 = cuda_time_ms(run(100), iters=10)
        return ms300, (ms300 - ms100) / 200 * 1e3

    # every solved level of a 540p flow: its body, iterations, ms and us an
    # iteration, beside the cooperative body's and an empty barrier's
    levels = {}
    for shape in FLOW_LEVELS_540P:
        ny, nx = shape
        arrays = flow_inner_inputs(torch, shape, [(1.3, -0.7)], seed=ny,
                                   p_scale=0.1)
        plan = ti.cluster_plan(ny, nx)
        n, _, _ = hold_inner_loop(torch, ti, f"inner loop level {shape}",
                                  arrays, 300)
        ms = cuda_time_ms(lambda: ti.tvl1_inner_loop(
            *arrays, tau=0.25, lambda_=0.2, theta=0.3, epsilon=0.01,
            max_iters=300), iters=10)
        ms300, us = us_per_iteration(arrays)
        level = {"body": inner_body(ti, shape), "plan": plan,
                 "iterations": n[0], "ms": ms, "ms_300_iterations": ms300,
                 "us_per_iteration": us}
        if plan is None:
            blocks = ti.launch_blocks(1, ny, nx)
            level["grid_barrier_us"] = cuda_time_ms(
                lambda: ti.grid_barrier_probe(blocks, 1000), iters=3)
            barrier = f"empty grid barrier on {blocks} blocks " \
                      f"{level['grid_barrier_us']:.3f} us"
        else:
            _, coop_us = us_per_iteration(arrays, plan=None)
            level["cooperative_us_per_iteration"] = coop_us
            threads = ti.cluster_threads(plan[1])
            level["cluster_barrier_us"] = cuda_time_ms(
                lambda: ti.cluster_barrier_probe(plan[0], threads, 1000),
                iters=3)
            barrier = f"cooperative body {coop_us:.3f} us an iteration; " \
                      f"empty cluster barrier on {plan[0]} x {threads} " \
                      f"threads {level['cluster_barrier_us']:.3f} us"
        levels[f"{ny}x{nx}"] = level
        print(f"inner loop level {ny}x{nx} ({level['body']}): {n[0]} "
              f"iterations {ms:.4f} ms; 300 iterations {ms300:.4f} ms = "
              f"{us:.3f} us each; {barrier}", flush=True)

    rows = []
    for shape in ((135, 240), (H, W)):
        ny, nx = shape
        arrays = flow_inner_inputs(torch, shape, [(1.3, -0.7)], seed=ny,
                                   p_scale=0.1)
        n, err, scale = hold_inner_loop(torch, ti, f"inner loop {shape}",
                                        arrays, 300)
        kw = dict(tau=0.25, lambda_=0.2, theta=0.3, max_iters=300)
        ms = cuda_time_ms(lambda: ti.tvl1_inner_loop(
            *arrays, epsilon=0.01, **kw), iters=10)
        plain_ms = cuda_time_ms(lambda: ti.tvl1_inner_loop_plain(
            *arrays, epsilon=0.01, **kw), iters=1, warmup=1)
        # epsilon 0: the error never falls to it, all 300 iterations run
        _, st = ti.tvl1_inner_loop(*arrays, epsilon=0.0,
                                   return_iterations=True, **kw)
        check(int(st[0, 0]) == 300, f"inner loop {shape}: epsilon 0 ran "
              f"{int(st[0, 0])} iterations")
        ms300 = cuda_time_ms(lambda: ti.tvl1_inner_loop(
            *arrays, epsilon=0.0, **kw), iters=10)
        plain300 = cuda_time_ms(lambda: ti.tvl1_inner_loop_plain(
            *arrays, epsilon=0.0, **kw), iters=1, warmup=0, repeats=1)
        blocks = ti.launch_blocks(1, ny, nx)
        barrier_us = cuda_time_ms(
            lambda: ti.grid_barrier_probe(blocks, 1000), iters=3)
        # every input read once, every output written once; the operations
        # of the iterations that this run's data needed
        bms, by = bound_ms(16 * ny * nx * 4,
                           FLOW_OPS_PER_PIXEL * ny * nx * n[0],
                           F32_FLOP_PER_S)
        row = {"B": 1, "shape": [ny, nx], "dtype": "float32",
               "body": inner_body(ti, shape),
               "iterations": n[0], "max_abs_err": err, "max_abs_plain": scale,
               "ms": ms, "plain_ms": plain_ms, "library_ms": None,
               "bound_ms": bms, "bound_by": by,
               "us_per_iteration": ms / n[0] * 1e3,
               "ms_300_iterations": ms300,
               "us_per_iteration_300": ms300 / 300 * 1e3,
               "plain_ms_300_iterations": plain300,
               "blocks": blocks, "barrier_us": barrier_us,
               "barrier_floor_ms": n[0] * barrier_us / 1e3}
        if shape == FLOW_LEVELS_540P[0]:
            row["levels_540p"] = levels
        rows.append(row)
        print(f"kernel tvl1_inner_loop {ny}x{nx} float32 ({row['body']}): "
              f"{n[0]} iterations, err {err:.3e} (plain max {scale:.3e}) ms "
              f"{ms:.4f} plain {plain_ms:.4f} library none bound {bms:.5f} "
              f"({by}); 300 iterations {ms300:.4f} ms = {ms300 / 0.3:.3f} us "
              f"each (plain {plain300:.1f} ms); {blocks} blocks, empty grid "
              f"barrier {barrier_us:.3f} us, {n[0]} barriers "
              f"{n[0] * barrier_us / 1e3:.4f} ms", flush=True)
    torch.cuda.empty_cache()
    return {"tvl1_inner_loop": rows}


def flow_path_phase(torch, fs, psnr, variables, model, training):
    """The flow path; returns (launch counts of the counted run, the main
    loop fed by ``AsyncFlowSolver``; timings and comparisons)."""
    from torch.profiler import ProfilerActivity, profile

    from frame2frame_tpu_torch.flow.tvl1 import (
        DENOISING_PARAMS, make_batched_tvl1, make_tvl1_solver)
    from frame2frame_tpu_torch.io.flo import read_flo
    from frame2frame_tpu_torch.train.online import (
        AsyncFlowSolver, OnlineDenoiser)

    out = {}
    # (a) the golden pair of the reference binary, on the kernel
    I0, I1 = (read_png_gray8(GOLDEN / n).astype(np.float32) / np.float32(255)
              for n in ("i0.png", "i1.png"))
    ny, nx = I0.shape
    for golden, params in (("flow_default.flo", dict(lambda_=0.15, fscale=0)),
                           ("flow_denoise.flo", dict(lambda_=0.2, fscale=2))):
        ref = read_flo(GOLDEN / golden)
        flow = make_tvl1_solver(nx, ny, **params)(I0, I1).cpu().numpy()
        err = np.abs(flow - ref)
        print(f"flow golden {golden}: mean |d| {err.mean():.3e} max "
              f"{err.max():.3e} px", flush=True)
        check(flow.shape == ref.shape and np.isfinite(flow).all(),
              f"golden {golden}: shape {flow.shape} or non-finite flow")
        check(err.mean() < GOLDEN_MEAN_TOL and err.max() < GOLDEN_MAX_TOL,
              f"golden {golden}: mean {err.mean()} max {err.max()}")
        out[f"golden/{golden}"] = {"mean_abs_err": float(err.mean()),
                                   "max_abs_err": float(err.max())}

    # (b) a 540p flow with the denoising parameters
    clean, noisy, flows = moving_frames(3)

    def gray(frames, k):
        return frames[k][..., 0] * 255.0

    solve = make_tvl1_solver(W, H, **DENOISING_PARAMS)
    solve_plain = make_tvl1_solver(W, H, plain=True, **DENOISING_PARAMS)
    its = []
    fs.reset_launch_counts()
    flow_noisy = solve(gray(noisy, 1), gray(noisy, 0), iterations=its)
    torch.cuda.synchronize()
    # five warps of five scales: a kernel launch for every inner loop the
    # solve runs, so none of them took the plain version
    launched = fs.launch_counts()["tvl1_inner_loop"]
    check(launched == len(its) == FLOW_LAUNCHES_540P,
          f"a 540p flow of {len(its)} inner loops launched tvl1_inner_loop "
          f"{launched} times, expected {FLOW_LAUNCHES_540P} of each")
    its_plain = []
    flow_plain = solve_plain(gray(noisy, 1), gray(noisy, 0),
                             iterations=its_plain)
    check(fs.launch_counts()["tvl1_inner_loop"] == launched,
          "the plain solver launched the kernel")
    counts = [int(s[0, 0]) for s in its]
    for i, (a, b) in enumerate(zip(its, its_plain)):
        check(torch.equal(a[:, 0], b[:, 0]),
              f"540p flow: launch {i} ran {a[:, 0].tolist()} iterations on "
              f"the kernel and {b[:, 0].tolist()} on the plain loop (errors "
              f"{a[:, 1].tolist()} / {b[:, 1].tolist()})")
    d_solver = float((flow_noisy - flow_plain).abs().max())
    print(f"flow 540p: {launched} launches, iterations {counts} "
          f"(sum {sum(counts)}), max |kernel solver - plain solver| "
          f"{d_solver:.3e} px", flush=True)
    check(flow_noisy.shape == (H, W, 2)
          and bool(torch.isfinite(flow_noisy).all()),
          "540p flow: shape or non-finite flow")
    check(d_solver <= FLOW_SOLVER_ATOL,
          f"540p flow: kernel solver off the plain solver by {d_solver} px")

    def epe(flow, k):
        d = flow.cpu().numpy() - flows[k]
        m = FLOW_MARGIN
        return float(np.median(np.sqrt((d ** 2).sum(-1))[m:-m, m:-m]))

    flow_clean = solve(gray(clean, 1), gray(clean, 0))
    epe_clean, epe_noisy = epe(flow_clean, 1), epe(flow_noisy, 1)
    print(f"flow 540p: median end-point error against the analytic flow, "
          f"clean frames {epe_clean:.4f} px, noisy frames {epe_noisy:.4f} px",
          flush=True)
    check(epe_clean <= FLOW_EPE_TOL,
          f"540p flow of the clean frames misses the analytic flow by "
          f"{epe_clean} px (median)")
    src = np.stack([gray(noisy, 1), gray(noisy, 2), gray(clean, 1),
                    gray(clean, 2)])
    dst = np.stack([gray(noisy, 0), gray(noisy, 1), gray(clean, 0),
                    gray(clean, 1)])
    its4 = []
    fs.reset_launch_counts()
    batched = make_batched_tvl1(W, H, **DENOISING_PARAMS)(src, dst,
                                                          iterations=its4)
    check(fs.launch_counts()["tvl1_inner_loop"] == FLOW_LAUNCHES_540P,
          "the batched solver did not take one launch a warp")
    for q in range(4):
        check(torch.equal(batched[q], solve(src[q], dst[q])),
              f"batched 540p solver: pair {q} differs from its single solve")
    spread = max(int(s[:, 0].max() - s[:, 0].min()) for s in its4)
    print(f"flow 540p: batched P=4 equals four single solves bit for bit "
          f"(iteration counts within a launch up to {spread} apart)",
          flush=True)
    check(spread > 0, "batched 540p solver: all pairs stopped alike")
    out["flow_540p"] = {
        "launches": launched, "iterations": counts,
        "max_abs_kernel_vs_plain_solver": d_solver,
        "median_epe_clean": epe_clean, "median_epe_noisy": epe_noisy}

    # (c) the main loop with its own flow: the worker solves on its stream
    # while the engine fine-tunes; frames handed over as the loop of the
    # JAX package hands them (cur -> prev, noisy, in [0, 1]). The worker's
    # first solve makes its launches one by one, through the wrapper, and
    # then records the solve into a CUDA graph, while this thread denoises
    # the first frame, which has no frame before it; every flow handed over
    # is a replay. A replay goes through no wrapper and adds nothing to the
    # launch count, so the profiler's record of this run says how many inner
    # kernels ran on the card.
    frames = torch.from_numpy(noisy).cuda()
    nmid = model.nmid
    want = {"fwd_layer": nmid, "fwd_layer_train": nmid * ITERS,
            "fwd_layer_eval": 0, "bwd_layer": nmid * ITERS,
            **dict.fromkeys(("first_conv", "last_loss_fwd", "last_loss_bwd",
                             "first_dw"), ITERS)}
    eng = OnlineDenoiser(model, variables, iters=ITERS, residual_model=True)
    afs = AsyncFlowSolver(W, H, DENOISING_PARAMS, lookahead=3)
    fs.reset_launch_counts()
    handed = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as path_prof:
        afs.prefetch(1, noisy[1], noisy[0])
        first = eng.denoise_only(frames[0])
        check(bool(torch.isfinite(first).all()), "flow path: first frame")
        before = fs.launch_counts()
        check(before["fwd_layer"] == nmid, "flow path: the first frame's "
              f"denoise launched fwd_layer {before['fwd_layer']} times")
        for k in (1, 2):
            if k < 2:
                afs.prefetch(k + 1, noisy[k + 1], noisy[k])
            flow = afs.get(k)
            handed.append(flow)
            before = dict(fs.launch_counts())
            deno, ls = eng.process_frame(frames[k], frames[k - 1], flow)
            torch.cuda.synchronize()
            after = fs.launch_counts()
            for name, n in want.items():
                check(after[name] - before[name] == n,
                      f"flow path process_frame {k}: {name} launched "
                      f"{after[name] - before[name]} times, expected {n}")
            ls = ls.cpu().numpy()
            check(flow.shape == (H, W, 2) and deno.shape == (H, W, 1)
                  and ls.shape == (ITERS,), f"flow path frame {k}: shapes")
            check(np.isfinite(ls).all() and bool(torch.isfinite(deno).all())
                  and bool(torch.isfinite(flow).all()),
                  f"flow path frame {k}: non-finite output")
            check(ls[-1] < ls[0], f"flow path frame {k}: loss did not fall "
                  f"({ls[0]} -> {ls[-1]})")
            pk = psnr(clean[k], deno.cpu().numpy())
            pa = training[f"flat/frame_{k}"]["psnr"]
            print(f"flow path frame {k}: loss {ls[0]:.2f} -> {ls[-1]:.2f}; "
                  f"psnr with the TV-L1 flow {pk:.4f} dB, with the analytic "
                  f"flow {pa:.4f} dB; flow median end-point error "
                  f"{epe(flow, k):.4f} px", flush=True)
            check(abs(pk - pa) <= FLOW_PSNR_TOL,
                  f"flow path frame {k}: psnr {pk} dB with the TV-L1 flow, "
                  f"{pa} dB with the analytic one")
            out[f"frame_{k}"] = {"loss_first": float(ls[0]),
                                 "loss_last": float(ls[-1]), "psnr": pk,
                                 "psnr_analytic_flow": pa,
                                 "median_epe": epe(flow, k)}
    launches = fs.launch_counts()
    ran = calls_of(device_kernels(torch, path_prof), INNER_KERNEL)
    print(f"flow path: tvl1_inner_loop's wrapper launched "
          f"{launches['tvl1_inner_loop']} times (the solve before the "
          f"recording); {ran} inner kernels ran on the card (that solve and "
          f"two replays)", flush=True)
    check(launches["tvl1_inner_loop"] == FLOW_LAUNCHES_540P,
          f"flow path: tvl1_inner_loop's wrapper launched "
          f"{launches['tvl1_inner_loop']} times for the solve before the "
          f"recording, expected {FLOW_LAUNCHES_540P}")
    check(ran == 3 * FLOW_LAUNCHES_540P,
          f"flow path: {ran} inner kernels ran on the card for the solve "
          f"before the recording and two replays, expected "
          f"{3 * FLOW_LAUNCHES_540P}")
    out["inner_kernels_run"] = ran
    out["solve_times_ms"] = [t * 1e3 for t in afs.solve_times]
    afs.close()
    # replays on the worker's stream against the same solves made launch by
    # launch on this thread's
    flow2 = solve(gray(noisy, 2), gray(noisy, 1))
    for k, eager in ((1, flow_noisy), (2, flow2)):
        check(torch.equal(handed[k - 1], eager), f"AsyncFlowSolver's flow "
              f"{k} differs from the same solve on the caller's stream")
    print("flow 540p: the solves replayed from a CUDA graph equal the eager "
          "solves bit for bit", flush=True)

    # one flow alone, frames uploaded from the host as the worker does:
    # replayed from the worker's graph (handed to its thread and back),
    # launched one by one, and on the plain loop
    afs = AsyncFlowSolver(W, H, DENOISING_PARAMS)
    asked = iter(range(1000))

    def replayed():
        i = next(asked)
        afs.prefetch(i, noisy[2], noisy[1])
        return afs.get(i)

    fs.reset_launch_counts()
    prof = profile_call(torch, replayed, iters=5, top=8, count=INNER_KERNEL)
    afs.close()
    eager = profile_call(torch, lambda: solve(
        gray(noisy, 2), gray(noisy, 1)), iters=5, top=8, count=INNER_KERNEL)
    # the first call above recorded the graph; the replays launched nothing
    # through the wrapper, and ran what the eager solve runs
    check(fs.launch_counts()["tvl1_inner_loop"] == 12 * FLOW_LAUNCHES_540P,
          "a replayed 540p flow went through tvl1_inner_loop's wrapper")
    check(prof["counted"] == eager["counted"] == FLOW_LAUNCHES_540P,
          f"a 540p flow ran {prof['counted']} inner kernels replayed and "
          f"{eager['counted']} launched one by one, expected "
          f"{FLOW_LAUNCHES_540P}")
    t0 = time.perf_counter()
    solve_plain(gray(noisy, 2), gray(noisy, 1))
    torch.cuda.synchronize()
    prof["plain_solver_ms"] = (time.perf_counter() - t0) * 1e3
    out["flow_alone"] = prof
    out["flow_alone_eager"] = eager
    print("flow 540p alone, graph replay: " + json.dumps(prof), flush=True)
    print(f"flow 540p: its {FLOW_LAUNCHES_540P} inner launches take "
          f"{prof['counted_ms']:.4f} device ms replayed, "
          f"{eager['counted_ms']:.4f} launched one by one (profiler)",
          flush=True)
    print("flow 540p alone, eager: " + json.dumps(eager), flush=True)

    # a frame of flow + fine-tune with the flow prefetched on its stream,
    # against the two alone, in turns on the same engine

    def alone():
        t0 = time.perf_counter()
        eng.process_frame(frames[2], frames[1], flow2)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def overlapped(n):
        afs = AsyncFlowSolver(W, H, DENOISING_PARAMS, lookahead=3)
        order = [(1, 0), (2, 1)] * n
        afs.prefetch(0, noisy[1], noisy[0])
        ts = []
        for i, (c, p) in enumerate(order[:-1]):
            t0 = time.perf_counter()
            afs.prefetch(i + 1, noisy[order[i + 1][0]], noisy[order[i + 1][1]])
            eng.process_frame(frames[c], frames[p], afs.get(i))
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        afs.get(len(order) - 1)  # nothing left running beside what follows
        afs.close()
        # the first flow was not solved ahead of its frame
        return ts[1:], [t * 1e3 for t in afs.solve_times]

    a1 = [alone() for _ in range(3)]
    o1, st1 = overlapped(3)
    o2, st2 = overlapped(3)
    a2 = [alone() for _ in range(3)]
    timing = {
        "finetune_alone_ms": float(np.median(a1 + a2)),
        "flow_alone_ms": prof["ms"],
        "flow_alone_eager_ms": eager["ms"],
        "frame_with_prefetched_flow_ms": float(np.median(o1 + o2)),
        "frame_with_prefetched_flow_all_ms": o1 + o2,
        "finetune_alone_all_ms": a1 + a2,
        "solve_times_beside_finetune_ms": st1 + st2}
    timing["sum_alone_ms"] = (timing["finetune_alone_ms"]
                              + timing["flow_alone_ms"])
    out["flow_and_finetune"] = timing
    print("flow path timing: " + json.dumps(timing), flush=True)
    return launches, out


def farneback_phase(torch, fs):
    """Farneback flow (``run_flows(ftype="cv2")``, plain torch ops, no
    kernel) on the card: a 540p pair of the moving texture, its median
    end-point error against the analytic flow on clean frames, the same
    solve on the CPU, no kernel launched, ms a pair."""
    from frame2frame_tpu_torch.flow.api import run_flows

    clean, _, flows = moving_frames(2)
    done = count_run(torch, fs, {}, "farneback")
    got = run_flows(clean, ftype="cv2").bflow[0, 1]
    torch.cuda.synchronize()
    done()
    check(got.device.type == "cuda" and got.shape == (H, W, 2)
          and bool(torch.isfinite(got).all()), "farneback: flow on the card")
    f = got.cpu().numpy()
    m = FLOW_MARGIN
    epe = float(np.median(np.hypot(*(f - flows[1])[m:-m, m:-m]
                                   .transpose(2, 0, 1))))
    cpu = run_flows(clean, ftype="cv2", device="cpu").bflow[0, 1].numpy()
    diff = np.abs(f - cpu)
    secs = []
    for _ in range(3):
        t0 = time.perf_counter()
        run_flows(clean, ftype="cv2")
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    out = {"median_epe_px": epe, "card_vs_cpu_mean_px": float(diff.mean()),
           "card_vs_cpu_max_px": float(diff.max()),
           "ms_a_pair": 1e3 * float(np.median(secs))}
    print("farneback 540p (ftype='cv2'): " + json.dumps(out), flush=True)
    check(epe <= FLOW_EPE_TOL, f"farneback: median end-point error {epe} px")
    check(out["card_vs_cpu_mean_px"] <= FB_DEVICE_ATOL,
          f"farneback: card and CPU differ by {diff.mean()} px on average")
    return out


# kernels A and B at shapes that leave partial tiles, strips and runs: every
# body of each (the tensor cores at 64->64, 8->8, 64->16, 80->72; the thin
# class at n->64 and 64->n for grayscale and colour, batches, a ragged
# 541x963, wide sides that are not multiples of 4 or exceed 64; f32 FMAs at
# 12->20 and 20->6)
CONV_EDGE_SHAPES = (
    (1, 13, 21, 1, 64), (2, 13, 21, 64, 64), (1, 13, 21, 64, 1),
    (2, 13, 21, 3, 64), (2, 13, 21, 64, 3), (4, 13, 21, 1, 64),
    (4, 13, 21, 64, 1), (1, 541, 963, 1, 64), (1, 541, 963, 64, 1),
    (1, 13, 21, 2, 70), (1, 13, 21, 70, 3), (1, 1, 1, 1, 64),
    (1, 1, 1, 64, 1), (2, 13, 21, 12, 20), (1, 13, 21, 20, 6),
    (2, 13, 21, 8, 8), (1, 1, 1, 64, 64), (1, 37, 50, 64, 16),
    (1, 9, 20, 80, 72))


def conv_inputs(torch, rng, B, h, wd, cin, cout):
    """x (B, h, wd, cin), HWIO weights scaled to unit output variance, and a
    cotangent (B, h, wd, cout), f32 on the card."""
    x = rng.standard_normal((B, h, wd, cin), dtype=np.float32)
    w = (rng.standard_normal((3, 3, cin, cout))
         / np.sqrt(9 * cin)).astype(np.float32)
    g = rng.standard_normal((B, h, wd, cout), dtype=np.float32)
    return tuple(torch.from_numpy(a).cuda() for a in (x, w, g))


def conv_kernel_phase(torch, F, cuda_time_ms):
    """Kernels A (``conv3x3_fwd``) and B (``dw_conv3x3``) against their
    plain versions at edge shapes and at 540x960 64->64, 1->64 and 64->1
    (B on f32 and bf16 operands), A and B on f32 against float64, B's bits
    on two runs, times beside the bound and a library yardstick;
    ``conv3x3_p2`` and ``conv3x3_dwflat`` once each. Returns the per-kernel
    rows (the 540p 64->64 f32 row first)."""
    from frame2frame_tpu_torch.ops import conv3x3 as c3
    from frame2frame_tpu_torch.ops import conv_dw as cdw
    from frame2frame_tpu_torch.ops import fused_stack as fs
    from frame2frame_tpu_torch.ops._common import conv2d

    rng = np.random.default_rng(11)

    def hold(tag, got, ref):
        check(got.shape == ref.shape and got.dtype == ref.dtype,
              f"{tag}: shape/dtype {tuple(got.shape)} {got.dtype}")
        check(bool(torch.isfinite(got).all()), f"{tag}: non-finite output")
        err, scale = rel_err(got, ref)
        check(err <= CONV_RTOL * scale,
              f"{tag}: max|kernel-plain| {err} > {CONV_RTOL} * {scale}")
        return err, scale

    # the port's library convolution is f32 under PyTorch's default flags,
    # which let cuDNN take TF32 (10-bit mantissa, ~1e-3 off)
    x, w, g = conv_inputs(torch, rng, 1, 64, 96, FEAT, FEAT)
    results = []
    for dt in (torch.float64, torch.float32):
        xr = x.to(dt).permute(0, 3, 1, 2).requires_grad_()
        wr = w.to(dt).permute(3, 2, 0, 1).requires_grad_()
        y = (no_tf32(lambda: F.conv2d(xr, wr, padding=1))()
             if dt == torch.float64 else conv2d(xr, wr))
        y.backward(g.to(dt).permute(0, 3, 1, 2))
        results.append((y.detach(), xr.grad, wr.grad))
    for what, ref, got in zip(("forward", "dX", "dW"), *results):
        err, scale = rel_err(got, ref)
        print(f"conv f32: the port's library convolution, {what}, against "
              f"float64 {err / scale:.3e} of its largest value "
              f"(cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32}, "
              f"matmul.allow_tf32 {torch.backends.cuda.matmul.allow_tf32})",
              flush=True)
        check(err <= CONV_RTOL * scale, f"the port's f32 convolution's {what}"
              f" ran in reduced precision: {err / scale} off float64")
    check(not torch.backends.cuda.matmul.allow_tf32,
          "f32 matmuls (the plain versions' einsums) would run in TF32")
    # kernels A and B on f32 operands take split-f32 products on the TF32
    # tensor cores: held to float64 like the library, where one TF32 pass
    # would read ~1e-3
    y64, _, dw64 = results[0]
    lib = {what: rel_err(got, ref) for what, ref, got in
           zip(("forward", "dW"), (y64, dw64), (results[1][0], results[1][2]))}
    for name, what, got, ref in (
            ("conv3x3_fwd", "forward", c3.conv3x3_fwd(x, w),
             y64.permute(0, 2, 3, 1)),
            ("dw_conv3x3", "dW", cdw.dw_conv3x3(x, g),
             dw64.permute(2, 3, 1, 0))):
        torch.cuda.synchronize()
        err, scale = rel_err(got, ref)
        print(f"conv f32: kernel {name} against float64 {err / scale:.3e} of "
              f"its largest value (the library's {what} "
              f"{lib[what][0] / lib[what][1]:.3e})", flush=True)
        check(err <= CONV_RTOL * scale, f"{name} f32: {err / scale} off "
              "float64, not an f32 product")
    # the body that the C dispatch runs (f2f_conv3x3_body) is the one that
    # the wrappers' rule names (conv_dw.conv_body, which cp_async_reads and
    # so the alignment checks read)
    def body(kernel_b, f32, cin, cout):
        code = cdw._lib().f2f_conv3x3_body(int(kernel_b), int(f32), cin, cout)
        name = cdw.BODIES[code]
        check(name == cdw.conv_body(f32, cin, cout),
              f"{'B' if kernel_b else 'A'} {cin}->{cout} f32={f32}: C runs "
              f"{name}, conv_body says {cdw.conv_body(f32, cin, cout)}")
        return name

    for cin in (1, 2, 3, 4, 5, 8, 12, 16, 20, 64, 65, 80):
        for cout in (1, 2, 3, 4, 5, 6, 8, 16, 20, 64, 70):
            body(0, True, cin, cout)
            for f32 in (True, False):
                body(1, f32, cin, cout)
    print("conv kernels: the C dispatch agrees with conv_body on 132 "
          "channel pairs (A; B on f32 and bf16)", flush=True)

    # a contiguous view at an odd offset is refused before a launch wherever
    # a body reads that operand in 16-byte chunks: x and g in the tensor-core
    # bodies, the wide operand of the thin ones
    for cin, cout in ((FEAT, FEAT), (FEAT, 1), (1, FEAT), (FEAT, 3),
                      (3, FEAT)):
        xs, ws, gs = conv_inputs(torch, rng, 1, 13, 21, cin, cout)
        reads = cdw.cp_async_reads(True, cin, cout)
        check(any(reads), f"{cin}->{cout}: no operand read in 16-byte "
              "chunks")
        for k, t in enumerate((xs, gs)):
            if not reads[k]:
                continue
            odd = torch.zeros(1 + t.numel(), device="cuda")[1:].view(t.shape)
            calls = [(cdw.dw_conv3x3, (odd, gs) if k == 0 else (xs, odd))]
            if k == 0:  # kernel A reads x as kernel B does
                calls.append((c3.conv3x3_fwd, (odd, ws)))
            for fn, args in calls:
                launches = fn.launches
                try:
                    fn(*args)
                    check(False, f"{fn.__name__} {cin}->{cout}: a view 4 "
                          "bytes off a 16-byte boundary was launched")
                except ValueError:
                    pass
                check(fn.launches == launches, f"{fn.__name__}: counted a "
                      "launch it refused")
    torch.cuda.synchronize()
    print("conv kernels: unaligned f32 views refused (64->64 x and g, 64->n "
          "x, n->64 g)", flush=True)

    ran = {"A": set(), "B": set()}
    for B, h, wd, cin, cout in CONV_EDGE_SHAPES:
        tag = f"{(B, h, wd, cin, cout)}"
        x, w, g = conv_inputs(torch, rng, B, h, wd, cin, cout)
        y = c3.conv3x3_fwd(x, w)
        torch.cuda.synchronize()
        err, scale = hold(f"conv3x3_fwd {tag}", y, c3.conv3x3_fwd_plain(x, w))
        ran["A"].add(body(0, True, cin, cout))
        print(f"conv3x3_fwd {tag} f32 [{body(0, True, cin, cout)}]: err "
              f"{err:.3e} (plain max {scale:.3e})", flush=True)
        for dt in (torch.float32, torch.bfloat16):
            xd, gd = x.to(dt), g.to(dt)
            d1 = cdw.dw_conv3x3(xd, gd)
            d2 = cdw.dw_conv3x3(xd, gd)
            torch.cuda.synchronize()
            check(torch.equal(d1, d2), f"dw_conv3x3 {tag} {dt}: two runs "
                  "differ")
            err, scale = hold(f"dw_conv3x3 {tag} {dt}", d1,
                              cdw.dw_conv3x3_plain(xd, gd))
            name = body(1, dt == torch.float32, cin, cout)
            ran["B"].add(name)
            print(f"dw_conv3x3 {tag} {str(dt)[6:]} [{name}]: err {err:.3e} "
                  f"(plain max {scale:.3e}), same bits on two runs",
                  flush=True)
    for k, want in (("A", {"FMA", "tensor cores", "thin"}),
                    ("B", {"FMA", "tensor cores", "thin",
                           "bf16 tensor cores"})):
        check(ran[k] == want, f"kernel {k} edge shapes ran {sorted(ran[k])}")
    print("conv kernels edge shapes: ok (every body of A and B ran)",
          flush=True)

    # the differentiable convolutions on rows 11-12 and row 8's names, once
    # each, against the same functions on the plain versions
    x, w, g = conv_inputs(torch, rng, 2, 24, 40, FEAT, FEAT)
    for name, fn, launches in (
            ("conv3x3_p2", c3.conv3x3_p2, {"conv3x3_fwd": 2,
                                           "dw_conv3x3": 1}),
            ("conv3x3_dwflat", cdw.conv3x3_dwflat, {"dw_conv3x3": 1})):
        results = []
        for plain in (False, True):
            xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
            before = dict(fs.launch_counts())
            if plain:
                y = (c3.conv3x3(xr, wr, c3.plain_dx, cdw.dw_conv3x3_plain)
                     if name == "conv3x3_p2"
                     else cdw.conv3x3_dwflat(xr, wr, cdw.dw_conv3x3_plain))
            else:
                y = fn(xr, wr)
            y.backward(g)
            torch.cuda.synchronize()
            after = fs.launch_counts()
            if not plain:
                for k, n in after.items():
                    check(n - before[k] == launches.get(k, 0),
                          f"{name}: {k} launched {n - before[k]} times")
            results.append((y.detach(), xr.grad, wr.grad))
        for what, a, b in zip(("y", "dX", "dW"), *results):
            if name == "conv3x3_p2" or what == "dW":
                hold(f"{name} {what}", a, b)
    print("conv3x3_p2, conv3x3_dwflat: forward, dX and dW against the plain "
          "versions: ok", flush=True)

    # 540x960: 64 -> 64, the shape of the mid layers, and the thin layers
    # 1 -> 64 and 64 -> 1 of every route (A and B on f32 operands, B on
    # bf16 for "packed_bf16" and "bf16res")
    x, w, g = conv_inputs(torch, rng, 1, H, W, FEAT, FEAT)
    w_lib = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    warm = lambda: c3.conv3x3_fwd(x, w)  # noqa: E731
    for _ in range(20):  # bring the clocks up before the first timing
        warm()
    rows = {"conv3x3_fwd": [], "dw_conv3x3": []}
    cases = []
    for cin, cout in ((FEAT, FEAT), (1, FEAT), (FEAT, 1)):
        xc, wc = x[..., :cin].contiguous(), w[:, :, :cin, :cout].contiguous()
        cases.append((
            "conv3x3_fwd", "float32", cin, cout,
            functools.partial(c3.conv3x3_fwd, xc, wc),
            functools.partial(c3.conv3x3_fwd_plain, xc, wc),
            no_tf32(functools.partial(F.conv2d, xc.permute(0, 3, 1, 2),
                                      w_lib[:cout, :cin], padding=1)),
            (xc.numel() + H * W * cout + wc.numel()) * 4))
    for dt, cin, cout in ((torch.float32, FEAT, FEAT),
                          (torch.float32, 1, FEAT),
                          (torch.float32, FEAT, 1),
                          (torch.bfloat16, FEAT, FEAT),
                          (torch.bfloat16, 1, FEAT),
                          (torch.bfloat16, FEAT, 1)):
        xd = x[..., :cin].contiguous().to(dt)
        gd = g[..., :cout].contiguous().to(dt)
        xl, gl = xd.permute(0, 3, 1, 2), gd.permute(0, 3, 1, 2)
        wl = w_lib[:cout, :cin].to(dt)
        cases.append((
            "dw_conv3x3", str(dt).replace("torch.", ""), cin, cout,
            functools.partial(cdw.dw_conv3x3, xd, gd),
            functools.partial(cdw.dw_conv3x3_plain, xd, gd),
            no_tf32(functools.partial(
                torch.ops.aten.convolution_backward, gl, xl, wl, None,
                [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                [False, True, False])),
            (xd.numel() + gd.numel()) * xd.element_size() + 9 * cin * cout * 4))
    for name, dtype, cin, cout, kern, plain, library, nbytes in cases:
        tag = f"{name} 540p {cin}->{cout} {dtype}"
        got = kern()
        torch.cuda.synchronize()
        err, scale = hold(tag, got, plain())
        if name == "dw_conv3x3":
            again = kern()
            torch.cuda.synchronize()
            check(torch.equal(got, again), f"{tag}: two runs differ")
        # the thin bodies are shorter than their wrappers' host time: the
        # device starts ITERS calls behind a head start
        ms = cuda_time_ms(kern, head_start_cycles=HEAD_START_CYCLES)
        plain_ms = cuda_time_ms(plain, iters=5)
        library_ms = cuda_time_ms(library, head_start_cycles=HEAD_START_CYCLES)
        flops = 2 * H * W * cin * cout * 9
        # the bound of the body that ran: bf16 MMAs; on f32 operands three
        # TF32 products (split f32) in the tensor-core body, else f32 FMAs;
        # the FMA bound of the f32 function beside it
        which = body(name == "dw_conv3x3", dtype == "float32", cin, cout)
        if dtype == "bfloat16":
            bms, by = bound_ms(nbytes, flops)
        elif which == "tensor cores":
            bms, by = bound_ms(nbytes, 3 * flops, TF32_FLOP_PER_S)
        else:
            bms, by = bound_ms(nbytes, flops, F32_FLOP_PER_S)
        row = {"B": 1, "dtype": dtype, "cin": cin, "cout": cout,
               "body": which, "max_abs_err": err, "max_abs_plain": scale,
               "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bms, "bound_by": by}
        if dtype == "float32":
            row["bound_f32_fma_ms"] = bound_ms(nbytes, flops,
                                               F32_FLOP_PER_S)[0]
        print(f"kernel {tag} [{which}]: err {err:.3e} (plain max "
              f"{scale:.3e}) ms {ms:.4f} plain {plain_ms:.4f} library "
              f"{library_ms:.4f} bound {bms:.4f} ({by})" + (
                  f", f32 FMA bound {row['bound_f32_fma_ms']:.4f}"
                  if dtype == "float32" else ""), flush=True)
        rows[name].append(row)
    del x, g, cases
    torch.cuda.empty_cache()
    return rows


def count_run(torch, fs, want, what):
    """The launch counts of the run between two calls, held to ``want``
    (every kernel not named there: 0)."""
    before = dict(fs.launch_counts())

    def done():
        after = fs.launch_counts()
        for k, n in after.items():
            check(n - before[k] == want.get(k, 0),
                  f"{what}: {k} launched {n - before[k]} times, expected "
                  f"{want.get(k, 0)}")
    return done


def conv_impl_phase(torch, fs, psnr, variables):
    """The pretrained DnCNN-17 fine-tuned on two 540p frames through
    ``OnlineDenoiser.process_frame`` on the ``conv_impl`` routes; returns
    (launch counts by route, timings and comparisons)."""
    from frame2frame_tpu_torch.models.dncnn import (
        from_jax_variables, param_leaves)
    from frame2frame_tpu_torch.ops.warp import (
        bilinear_warp_with_mask, occlusion_mask)
    from frame2frame_tpu_torch.train.online import OnlineDenoiser

    dev = torch.device("cuda")
    clean, noisy, flows = moving_frames(3)
    frames = torch.from_numpy(noisy).to(dev)
    flow_t = torch.from_numpy(flows).to(dev)
    with torch.no_grad():
        warped, mask = bilinear_warp_with_mask(frames[0], flow_t[1])
        mask = occlusion_mask(flow_t[1], mask)
        target = mask * warped
    out, launches = {}, {}

    # (a) one step on each route: the kernels' backward against the plain
    # versions' from the same forward (the same activations, ReLU decisions
    # and L1 signs)
    for impl in CONV_ROUTES:
        grads = []
        for plain in (False, True):
            m = from_jax_variables(variables, residual=True,
                                   conv_impl=impl).to(dev)
            m.plain_backward = plain
            m.train()
            loss = (mask * m(frames[1][None])[0] - target).abs().sum()
            loss.backward()
            torch.cuda.synchronize()
            grads.append({n: p.grad for n, p in param_leaves(m)})
            del m
        rel = {}
        for n, gk in grads[0].items():
            check(bool(torch.isfinite(gk).all()),
                  f"{impl} one step: non-finite gradient of {n}")
            err, scale = rel_err(gk, grads[1][n])
            rel[n] = err / scale
        worst = max(rel, key=rel.get)
        print(f"conv_impl {impl} one step: gradients of the kernels' "
              f"backward against the plain versions', worst {worst} "
              f"{rel[worst]:.3e}", flush=True)
        check(rel[worst] <= CONV_STEP_RTOL,
              f"{impl} one step: gradient of {worst} off by {rel[worst]}")
        out[f"{impl}/one_step_worst_grad_rel_err"] = rel[worst]
        del grads
        torch.cuda.empty_cache()

    # (b) two frames through the engine on each route and on the f32 module
    # route ("xla"), launch counts a frame
    results = {}
    for impl in ("xla",) + CONV_ROUTES:
        model = from_jax_variables(variables, residual=True, conv_impl=impl)
        eng = OnlineDenoiser(model, variables, iters=ITERS,
                             residual_model=True)
        fs.reset_launch_counts()
        denos, losses, secs = [], [], []
        for k in (1, 2):
            done = count_run(torch, fs, CONV_LAUNCHES[impl],
                             f"{impl} process_frame {k}")
            t0 = time.perf_counter()
            deno, ls = eng.process_frame(frames[k], frames[k - 1], flow_t[k])
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            done()
            ls = ls.cpu().numpy()
            check(deno.shape == (H, W, 1) and ls.shape == (ITERS,)
                  and np.isfinite(ls).all()
                  and bool(torch.isfinite(deno).all()),
                  f"{impl} process_frame {k}: shapes or non-finite output")
            check(ls[-1] < ls[0], f"{impl} process_frame {k}: loss did not "
                  f"fall ({ls[0]} -> {ls[-1]})")
            denos.append(deno.cpu().numpy())
            losses.append(ls)
        launches[impl] = fs.launch_counts()
        prof = profile_call(
            torch, lambda: eng.process_frame(frames[2], frames[1], flow_t[2]),
            iters=1, top=8)
        prof["frames_per_s"] = 1e3 / prof["ms"]
        prof["counted_run_s"] = secs
        out[f"{impl}/process_frame"] = prof
        print(f"conv_impl {impl} process_frame: " + json.dumps(prof),
              flush=True)
        results[impl] = (denos, losses)
        del eng, model
        torch.cuda.empty_cache()
    ref_denos, ref_losses = results["xla"]
    for impl in CONV_ROUTES:
        denos, losses = results[impl]
        worst_loss = worst_psnr = 0.0
        for i, k in enumerate((1, 2)):
            dls = float(np.abs(losses[i] / ref_losses[i] - 1).max())
            pk, pr = psnr(clean[k], denos[i]), psnr(clean[k], ref_denos[i])
            pn = psnr(clean[k], noisy[k])
            print(f"conv_impl {impl} frame {k}: loss {losses[i][0]:.2f} -> "
                  f"{losses[i][-1]:.2f} (xla {ref_losses[i][0]:.2f} -> "
                  f"{ref_losses[i][-1]:.2f}, worst rel {dls:.3e}); psnr "
                  f"noisy {pn:.4f} route {pk:.4f} xla {pr:.4f} dB",
                  flush=True)
            check(pk - pn > MIN_GAIN_DB,
                  f"{impl} frame {k}: denoising gain {pk - pn} dB")
            worst_loss = max(worst_loss, dls)
            worst_psnr = max(worst_psnr, abs(pk - pr))
            out[f"{impl}/frame_{k}"] = {"psnr_noisy": pn, "psnr": pk,
                                        "psnr_xla": pr}
        bf16 = impl == "packed_bf16"
        loss_tol = BF16_GRAPH_LOSS_RTOL if bf16 else TRAIN_LOSS_RTOL
        psnr_tol = BF16_GRAPH_PSNR_TOL if bf16 else TRAIN_PSNR_TOL
        check(worst_loss <= loss_tol,
              f"{impl}: losses off the f32 xla route's by {worst_loss}")
        check(worst_psnr <= psnr_tol,
              f"{impl}: psnr off the f32 xla route's by {worst_psnr} dB")
        out[f"{impl}/worst_loss_rel_err"] = worst_loss
        out[f"{impl}/worst_psnr_diff_db"] = worst_psnr
    return launches, out


def _same_tree(a, b, path="", what="final.msgpack"):
    if isinstance(b, dict):
        check(isinstance(a, dict) and a.keys() == b.keys(),
              f"{what}: keys at {path or 'the top'} differ")
        for k in b:
            _same_tree(a[k], b[k], f"{path}/{k}", what)
        return
    a, b = np.asarray(a), np.asarray(b)
    check(a.dtype == b.dtype and a.shape == b.shape
          and a.tobytes() == b.tobytes(),
          f"{what}: {path} differs from the state written")


def streaming_phase(torch, fs, psnr, variables):
    """The streaming loop: a 5-frame 540p PGM sequence through the CLI on
    the flat route with ``AsyncFlowSolver``, then ``run_blind_denoising``
    with a ``"pallas"`` model over 3 frames with ``.flo`` files; returns
    (launch counts of both runs, timings and checks)."""
    import tempfile

    from frame2frame_tpu_torch.cli import blind_denoising as cli
    from frame2frame_tpu_torch.io.flo import write_flo
    from frame2frame_tpu_torch.io.image import read_pgm, write_pgm
    from frame2frame_tpu_torch.models.dncnn import (
        from_jax_variables, opt_state_to_jax)
    from frame2frame_tpu_torch.models.serialization import load_variables
    from frame2frame_tpu_torch.train import online

    clean, noisy, flows = moving_frames(STREAM_FRAMES, seed=5)
    made = []
    engine_class = online.OnlineDenoiser

    class Recording(engine_class):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    out, launches = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        for i in range(1, STREAM_FRAMES + 1):
            for name, img in (("noisy", noisy), ("clean", clean)):
                write_pgm(d / f"{name}_{i:03d}.pgm",
                          np.round(255.0 * img[i - 1, ..., 0]))
            write_flo(d / f"flow_{i:03d}.flo", flows[i - 1])

        def gain_check(tag, run_dir, first, last):
            lines = (run_dir / "plot_psnr.txt").read_text().splitlines()
            check(len(lines) == last - first,
                  f"{tag}: {len(lines)} lines in plot_psnr.txt")
            gains = []
            for i, line in zip(range(first + 1, last + 1), lines):
                ref = read_pgm(d / f"clean_{i:03d}.pgm") / 255.0
                pn = psnr(ref, read_pgm(d / f"noisy_{i:03d}.pgm") / 255.0)
                frame = read_pgm(run_dir / f"{i:03d}.pgm")
                check(frame.shape == (H, W), f"{tag}: frame {i} shape")
                gains.append(float(line) - pn)
            check(min(gains) > MIN_GAIN_DB, f"{tag}: psnr gains {gains}")
            return [float(v) for v in lines], gains

        def read_back(tag, run_dir):
            eng = made.pop()
            v = eng.variables
            _same_tree(load_variables(run_dir / "final.msgpack"),
                       {"params": v["params"],
                        "opt_state": opt_state_to_jax(eng.opt_state),
                        "batch_stats": v["batch_stats"]})

        online.OnlineDenoiser = Recording
        try:
            run = d / "cli"
            run.mkdir()
            fs.reset_launch_counts()
            nf = STREAM_FRAMES - 1
            done = count_run(torch, fs, {
                "fwd_layer": NMID * nf, "fwd_layer_train": NMID * ITERS * nf,
                "bwd_layer": NMID * ITERS * nf,
                **dict.fromkeys(("first_conv", "last_loss_fwd",
                                 "last_loss_bwd", "first_dw"), ITERS * nf),
                "tvl1_inner_loop": FLOW_LAUNCHES_540P}, "streaming CLI")
            t0 = time.perf_counter()
            cli.main(["--input", str(d / "noisy_%03d.pgm"),
                      "--ref", str(d / "clean_%03d.pgm"),
                      "--output", str(run / "%03d.pgm"),
                      "--output_psnr", str(run / "plot_psnr.txt"),
                      "--output_network", str(run / "final.msgpack"),
                      "--first", "1", "--last", str(STREAM_FRAMES),
                      "--iter", str(ITERS), "--network", str(CKPT),
                      "--compute_flow"])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            done()
            launches["stream"] = fs.launch_counts()
            lines, gains = gain_check("streaming CLI", run, 1, STREAM_FRAMES)
            read_back("streaming CLI", run)
            out["cli"] = {"frames": nf, "s": secs, "frames_per_s": nf / secs,
                          "psnr": lines, "gain_db": gains}
            print("streaming CLI (flat route, AsyncFlowSolver): "
                  + json.dumps(out["cli"]), flush=True)

            run = d / "pallas"
            run.mkdir()
            fs.reset_launch_counts()
            want = {k: 2 * n for k, n in CONV_LAUNCHES["pallas"].items()}
            done = count_run(torch, fs, want, "streaming pallas")
            t0 = time.perf_counter()
            online.run_blind_denoising(
                from_jax_variables(variables, conv_impl="pallas"), variables,
                input_tmpl=str(d / "noisy_%03d.pgm"),
                flow_tmpl=str(d / "flow_%03d.flo"),
                ref_tmpl=str(d / "clean_%03d.pgm"),
                output_tmpl=str(run / "%03d.pgm"),
                output_psnr=str(run / "plot_psnr.txt"),
                output_network=str(run / "final.msgpack"),
                first=1, last=3, iters=ITERS)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            done()
            launches["stream_pallas"] = fs.launch_counts()
            lines, gains = gain_check("streaming pallas", run, 1, 3)
            read_back("streaming pallas", run)
            out["pallas"] = {"frames": 2, "s": secs,
                             "frames_per_s": 2 / secs, "psnr": lines,
                             "gain_db": gains}
            print("streaming run_blind_denoising (pallas, .flo files): "
                  + json.dumps(out["pallas"]), flush=True)
        finally:
            online.OnlineDenoiser = engine_class
    return launches, out


def spatial_kernel_phase(torch, fs, cuda_time_ms):
    """The four mid-layer kernels with a row window (``valid_bounds``)
    against their windowed plain versions on both chains (``WINDOW_CASES``);
    the window of a whole 540p frame against the launch without one, bit for
    bit (the wrappers launch the window entry points only, with [0, H)
    where no window is given: the hold keeps it so); CUDA-event times of the launches without a window, with the whole
    frame's window and with the window of one slab of a 540p frame split in
    two. Returns ``{kernel: what the kernels line records of its window}``."""
    from frame2frame_tpu_torch.ops.fused_spatial import _valid_bounds, pad_h

    rng = np.random.default_rng(12)
    w = torch.from_numpy((rng.standard_normal((3, 3, FEAT, FEAT))
                          * np.sqrt(2.0 / (9 * FEAT))).astype(np.float32)).cuda()
    wk = fs.kernel_weights(w)
    for hf, wf, D, k in WINDOW_CASES:
        R = pad_h(hf, D) // D
        vb = _valid_bounds(k, R, hf)
        for dt in (torch.bfloat16, torch.float32):
            z_prev, z_i, g, vecs = train_inputs(torch, rng, (1, R + 2, wf), dt)
            tag = (f"windowed kernels {hf}x{wf} D={D} slab {k} window {vb} "
                   f"{str(dt).replace('torch.', '')}")
            hold_train_kernels(torch, fs, tag, z_prev, z_i, g, w, wk, vecs, vb)
            s, b = vecs[fs.V_SP].contiguous(), vecs[fs.V_BP].contiguous()
            a = torch.relu(z_prev)
            hold_close(tag, "fwd_layer",
                       fs.fwd_layer(z_prev, wk, s, b, valid_bounds=vb),
                       fs.fwd_layer_plain(z_prev, w, s, b, valid_bounds=vb),
                       KERNEL_RTOL)
            hold_close(tag, "fwd_layer_eval",
                       fs.fwd_layer_eval(a, wk, s, b, valid_bounds=vb),
                       fs.fwd_layer_eval_plain(a, w, s, b, valid_bounds=vb),
                       KERNEL_RTOL)
    print(f"windowed kernels: {len(WINDOW_CASES)} windows x 2 chains held "
          "against their windowed plain versions", flush=True)

    z_prev, z_i, g, vecs = train_inputs(torch, rng, (1, H, W), torch.bfloat16)
    s, b = vecs[fs.V_SP].contiguous(), vecs[fs.V_BP].contiguous()
    R = H // 2
    slab = [x[:, :R + 2].contiguous() for x in (z_prev, z_i, g)]

    def launch(name, zp, zi, gg, vb, first=False):
        if name == "fwd_layer":
            return lambda: [fs.fwd_layer(zp, wk, s, b, valid_bounds=vb)]
        if name == "fwd_layer_eval":
            a = torch.relu(zp)
            return lambda: [fs.fwd_layer_eval(a, wk, s, b, valid_bounds=vb)]
        if name == "fwd_layer_train":
            return lambda: list(fs.fwd_layer_train(zp, wk, s, b,
                                                   valid_bounds=vb))
        return lambda: list(fs.bwd_layer(gg, zi, zp, wk, vecs, first,
                                         valid_bounds=vb))

    full = (0, H, 0, H)
    out = {}
    for name in ("fwd_layer", "fwd_layer_train", "fwd_layer_eval",
                 "bwd_layer"):
        for first in ((False, True) if name == "bwd_layer" else (False,)):
            got = launch(name, z_prev, z_i, g, full, first)()
            ref = launch(name, z_prev, z_i, g, None, first)()
            check(all(torch.equal(x, y) for x, y in zip(got, ref)),
                  f"{name}: the window of the whole frame changes the bits")
        ms = {what: cuda_time_ms(launch(name, *xs, vb),
                                 head_start_cycles=HEAD_START_CYCLES)
              for what, xs, vb in (
                  ("no_window", (z_prev, z_i, g), None),
                  ("whole_frame_window", (z_prev, z_i, g), full),
                  ("slab_of_2", slab, _valid_bounds(0, R, H)))}
        out[name] = {"valid_bounds": "held", "window_ms": ms,
                     "window_cases": [list(c) for c in WINDOW_CASES]}
        print(f"windowed kernel {name} 540p bf16: ms no window "
              f"{ms['no_window']:.4f}, whole frame's window "
              f"{ms['whole_frame_window']:.4f}, one slab of two "
              f"({R + 2} rows) {ms['slab_of_2']:.4f}; bit-equal without a "
              "window", flush=True)
    del z_prev, z_i, g, slab
    torch.cuda.empty_cache()
    return out


def spatial_backward_hold(torch, fs, variables, frame, dt, D, plain=False):
    """The split backward against the unsplit one from the SAME forward: the
    unsplit forward of the pretrained DnCNN-17 on one 540p frame, its conv
    outputs split into D slabs on ``cuda:0``, and the split layer loop
    (windows, halo exchange, psums, the last BatchNorm's sums per slab)
    against the unsplit loop on the cotangent of the fine-tune's L1 loss.
    Per parameter max |d| / max |ref| of dW, dgamma and dbeta, and of the
    stack input's cotangent: a row summed by two slabs or by none moves them
    by its share, which Adam's steps would hide. On the kernels (bf16 MMA
    operands on either chain, so an ulp of a sum flips some roundings)
    within ``STEP_GRAD_RTOL`` (a bf16 cotangent ``KERNEL_RTOL``); on the
    plain versions in f32 (``plain``), the same split machinery with no
    bf16 operand, within ``SPATIAL_PLAIN_GRAD_RTOL``. Returns the worst by
    kind."""
    from frame2frame_tpu_torch.models.dncnn import from_jax_variables
    from frame2frame_tpu_torch.models.fused_apply import _make_end_conv
    from frame2frame_tpu_torch.ops import fused_spatial as fsp
    from frame2frame_tpu_torch.parallel.spatial import make_space_mesh

    cur, prev = frame[0], frame[1]
    dev = cur.device
    fwd, bwd = ((fs.fwd_layer_train_plain, fs.bwd_layer_plain) if plain
                else (fs.fwd_layer_train, fs.bwd_layer))
    model = from_jax_variables(variables, residual=True).to(dev)
    mids = [model.mid(i) for i in range(model.nmid)]
    end_conv = _make_end_conv(dt)
    with torch.no_grad():
        a_in = torch.relu(end_conv(cur[None], model.conv_in.weight)).to(dt)
        ws = torch.stack([c.weight for c, _ in mids]).permute(0, 3, 4, 2, 1)
        wk = fs.kernel_weights(ws)
        gammas = torch.stack([bn.weight for _, bn in mids])
        betas = torch.stack([bn.bias for _, bn in mids])
        count = a_in.shape[0] * a_in.shape[1] * a_in.shape[2]
        zs, ss, bs, means, vars_ = fs.mid_forward(
            fwd, wk, gammas, betas, a_in, count)
        rstd, nmr = fs.bn_norm(means, vars_)
    a_out = torch.relu(zs[-1].float() * ss[-1] + bs[-1]).requires_grad_()
    noise = end_conv(a_out, model.conv_out.weight).float()
    loss = (cur[None] - noise - prev[None]).abs().sum()
    g = torch.autograd.grad(loss, a_out)[0].to(dt).contiguous()
    whole = [(0, a_in.shape[1], 0, a_in.shape[1])]
    with torch.no_grad():
        ref = fs.mid_backward(
            bwd, wk, zs, a_in, ss, bs, means, rstd, nmr, count, g,
            *fsp._last_bn_sums([g], [zs[-1]], ss[-1], bs[-1], rstd[-1],
                               nmr[-1], whole))
        mesh = make_space_mesh(devices=[dev] * D)
        bounds = fsp._geometry(a_in, a_in.shape[1], mesh)
        gk = fsp.split_frame(g, mesh)
        zk = [fsp.split_frame(z, mesh) for z in zs]
        got = fs.mid_backward(
            fsp._sharded_bwd(bwd, bounds), wk, zk,
            fsp.split_frame(a_in, mesh), ss, bs, means, rstd, nmr, count, gk,
            *fsp._last_bn_sums(gk, zk[-1], ss[-1], bs[-1], rstd[-1], nmr[-1],
                               bounds))
        torch.cuda.synchronize()
    worst = {}
    for kind, x, y in (("dW", got[0], ref[0]), ("dgamma", got[1], ref[1]),
                       ("dbeta", got[2], ref[2])):
        check(bool(torch.isfinite(x).all()), f"split backward: {kind}")
        worst[kind] = max(e / sc for e, sc in (rel_err(x[i], y[i])
                                               for i in range(len(x))))
    e, sc = rel_err(fsp.gather_frame(got[3]), ref[3])
    worst["da1"] = e / sc
    what = (f"split backward D={D} {str(dt).replace('torch.', '')} "
            f"{'plain versions' if plain else 'kernels'}")
    print(f"{what}, against the unsplit backward from the same forward, "
          "max|d|/max|ref| worst over the layers: "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()), flush=True)
    # the cotangent is stored in the chain's dtype: on bf16 the sums' other
    # order flips some of its roundings, each by 2^-8 of its value
    bounds = {k: SPATIAL_PLAIN_GRAD_RTOL if plain else STEP_GRAD_RTOL
              for k in worst}
    if dt == torch.bfloat16 and not plain:
        bounds["da1"] = KERNEL_RTOL
    for kind, v in worst.items():
        check(v <= bounds[kind], f"{what}: {kind} off by {v}")
    return worst


def spatial_phase(torch, fs, psnr, variables):
    """The H-split online fine-tune (``parallel.spatial``), the pretrained
    DnCNN-17 on one card as D = 1, 2 and 4 slabs on ``cuda:0``, 20 Adam
    updates of one 540p frame on each chain against the unsplit
    per-iteration route on the same inputs; one 1080p frame (the 540p scene
    at twice the size) fine-tuned and served at D = 2 on both eval routes;
    host and device ms of the split steps. Returns (launch counts of the
    counted run, timings and comparisons)."""
    import torch.nn.functional as F

    from frame2frame_tpu_torch.models.dncnn import JaxRavel, from_jax_variables
    from frame2frame_tpu_torch.parallel.spatial import (
        make_space_mesh, make_spatial_online_step)
    from frame2frame_tpu_torch.train.online import (
        make_denoise, make_online_step, torch_adam)

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    bf16, f32 = torch.bfloat16, torch.float32
    clean, noisy, flows = moving_frames(2)
    f540 = [torch.from_numpy(a).to(dev)
            for a in (noisy[1], noisy[0], flows[1])]

    def up(a):
        x = torch.from_numpy(a).to(dev).permute(2, 0, 1)[None]
        x = F.interpolate(x, scale_factor=2, mode="bilinear",
                          align_corners=False)
        return x[0].permute(1, 2, 0).contiguous()

    rng = np.random.default_rng(13)
    clean_hd = [up(clean[k]) for k in (1, 0)]
    f1080 = [c + SIGMA * torch.from_numpy(rng.standard_normal(
        c.shape, dtype=np.float32)).to(dev) for c in clean_hd]
    f1080.append(2 * up(flows[1]))
    clean_hd = clean_hd[0].cpu().numpy()

    def engine(D, dt):
        model = from_jax_variables(variables, residual=True).to(dev)
        tx = torch_adam(5e-5, 1e-5)
        state = tx.init(JaxRavel(model).ravel())
        if D is None:
            step = make_online_step(model, tx, iters=ITERS,
                                    residual_model=True, flat_step=False,
                                    store_dtype=dt)
        else:
            step = make_spatial_online_step(
                model, tx, make_space_mesh(devices=[dev] * D), iters=ITERS,
                residual_model=True, store_dtype=dt)
        return model, step, state

    def fine_tune(D, dt, frame, what):
        model, step, state = engine(D, dt)
        t0 = time.perf_counter()
        _, deno, losses = step(state, *frame)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        ls = losses.cpu().numpy()
        check(deno.shape == frame[0].shape and ls.shape == (ITERS,),
              f"{what}: shapes {tuple(deno.shape)} {ls.shape}")
        check(np.isfinite(ls).all() and bool(torch.isfinite(deno).all()),
              f"{what}: non-finite output")
        check(ls[-1] < ls[0], f"{what}: loss did not fall ({ls[0]} -> "
              f"{ls[-1]})")
        return {"deno": deno.cpu().numpy(), "losses": ls, "ms": ms,
                "model": model, "step": step, "state": state}

    grads = {f"D={D} {str(dt).replace('torch.', '')} "
             f"{'plain' if plain else 'kernels'}":
             spatial_backward_hold(torch, fs, variables, f540, dt, D, plain)
             for dt, plain in ((bf16, False), (f32, False), (f32, True))
             for D in (2, 4)}
    torch.cuda.empty_cache()

    def peak_gib(run):
        # the most device memory the run held above what was held before it
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        r = run()
        r["peak_gib"] = (torch.cuda.max_memory_allocated() - before) / 2 ** 30
        return r

    # the unsplit references, outside the counted run
    ref = {dt: fine_tune(None, dt, f540, f"unsplit {dt}") for dt in (bf16, f32)}
    ref_hd = peak_gib(lambda: fine_tune(None, bf16, f1080, "unsplit 1080p"))

    def mids(D, eval_layers=True):
        return {"fwd_layer_train": D * NMID * ITERS,
                "bwd_layer": D * NMID * ITERS,
                "fwd_layer": D * NMID if eval_layers else 0}

    fs.reset_launch_counts()
    runs = {}
    for dt in (bf16, f32):
        for D in SPATIAL_D:
            what = f"split D={D} {str(dt).replace('torch.', '')}"
            done = count_run(torch, fs, mids(D), what)
            runs[what] = (D, dt, fine_tune(D, dt, f540, what))
            done()
    done = count_run(torch, fs, mids(2), "split D=2 1080p")
    hd = peak_gib(lambda: fine_tune(2, bf16, f1080, "split D=2 1080p"))
    done()
    mesh2 = make_space_mesh(devices=[dev] * 2)
    served = {}
    for impl, kname in (("affine", "fwd_layer"), ("act-bf16", "fwd_layer_eval")):
        done = count_run(torch, fs, {kname: 2 * NMID}, f"serve 1080p {impl}")
        served[impl] = make_denoise(hd["model"], residual_model=True,
                                    spatial_mesh=mesh2)(f1080[0],
                                                        eval_impl=impl)
        torch.cuda.synchronize()
        done()
    launches = fs.launch_counts()

    out = {}
    for what, (D, dt, r) in runs.items():
        rr = ref[dt]
        dl = float(np.abs(r["losses"] / rr["losses"] - 1).max())
        dl0 = float(abs(r["losses"][0] / rr["losses"][0] - 1))
        d = r["deno"] - rr["deno"]
        dmax, drms = float(np.abs(d).max()), float(np.sqrt(np.mean(d ** 2)))
        # rows within 2 of a slab's edge against the others: a fault of the
        # halos would show there first
        R = H // D
        edge = np.zeros(H, bool)
        for k in range(1, D):
            edge[max(k * R - 2, 0):k * R + 2] = True
        rms_edge = (float(np.sqrt(np.mean(d[edge] ** 2))) if edge.any()
                    else 0.0)
        rms_rest = float(np.sqrt(np.mean(d[~edge] ** 2)))
        p, pr = psnr(clean[1], r["deno"]), psnr(clean[1], rr["deno"])
        print(f"spatial {what}: loss {r['losses'][0]:.2f} -> "
              f"{r['losses'][-1]:.2f}, against unsplit first loss rel "
              f"{dl0:.3e} worst {dl:.3e}, frame max {dmax:.3e} rms {drms:.3e} "
              f"(rows at slab edges {rms_edge:.3e}, others {rms_rest:.3e}), "
              f"psnr {p:.4f} (unsplit {pr:.4f}) dB, host {r['ms']:.1f} ms "
              f"(unsplit {rr['ms']:.1f})", flush=True)
        out[what] = {"first_loss_rel_err": dl0, "worst_loss_rel_err": dl,
                     "max_abs_denoised_diff": dmax, "rms_denoised_diff": drms,
                     "rms_slab_edge_rows": rms_edge,
                     "rms_other_rows": rms_rest, "psnr": p,
                     "psnr_unsplit": pr, "host_ms_first_call": r["ms"]}
    for what, o in out.items():
        check(o["first_loss_rel_err"] <= SPATIAL_FIRST_LOSS_RTOL,
              f"{what}: first loss off by {o['first_loss_rel_err']}")
        check(o["worst_loss_rel_err"] <= TRAIN_LOSS_RTOL,
              f"{what}: losses off by {o['worst_loss_rel_err']}")
        check(abs(o["psnr"] - o["psnr_unsplit"]) <= TRAIN_PSNR_TOL,
              f"{what}: psnr off by {o['psnr'] - o['psnr_unsplit']} dB")
        check(o["rms_denoised_diff"] <= ROUTES_DENO_RMS,
              f"{what}: frame rms off by {o['rms_denoised_diff']}")
        check(o["rms_slab_edge_rows"]
              <= SPATIAL_EDGE_RMS_RATIO * o["rms_other_rows"],
              f"{what}: rows at the slabs' edges off by "
              f"{o['rms_slab_edge_rows']}, others {o['rms_other_rows']}")
    dl = float(np.abs(hd["losses"] / ref_hd["losses"] - 1).max())
    d = hd["deno"] - ref_hd["deno"]
    drms = float(np.sqrt(np.mean(d ** 2)))
    p, pr = psnr(clean_hd, hd["deno"]), psnr(clean_hd, ref_hd["deno"])
    pn = psnr(clean_hd, f1080[0].cpu().numpy())
    print(f"spatial split D=2 1080p: loss {hd['losses'][0]:.2f} -> "
          f"{hd['losses'][-1]:.2f}, against unsplit worst loss rel {dl:.3e}, "
          f"frame rms {drms:.3e}, psnr noisy {pn:.4f} split {p:.4f} unsplit "
          f"{pr:.4f} dB; peak device memory of the step split "
          f"{hd['peak_gib']:.3f} GiB, unsplit {ref_hd['peak_gib']:.3f} GiB",
          flush=True)
    check(dl <= TRAIN_LOSS_RTOL, f"split 1080p: losses off by {dl}")
    check(abs(p - pr) <= TRAIN_PSNR_TOL, f"split 1080p: psnr off by {p - pr}")
    check(drms <= ROUTES_DENO_RMS, f"split 1080p: frame rms off by {drms}")
    check(p - pn > MIN_GAIN_DB, f"split 1080p: denoising gain {p - pn} dB")
    out["split D=2 1080p"] = {"worst_loss_rel_err": dl,
                              "rms_denoised_diff": drms, "psnr": p,
                              "psnr_unsplit": pr, "psnr_noisy": pn,
                              "peak_gib": hd["peak_gib"],
                              "peak_gib_unsplit": ref_hd["peak_gib"]}
    unsplit_serve = make_denoise(hd["model"], residual_model=True)
    for impl, y in served.items():
        err = float((y - unsplit_serve(f1080[0], eval_impl=impl)).abs().max())
        print(f"spatial serve 1080p D=2 {impl}: max|split - unsplit| "
              f"{err:.3e}", flush=True)
        check(err == 0, f"split serving {impl}: off by {err}")
        out[f"serve 1080p D=2 {impl}"] = {"max_abs_diff_unsplit": err}

    # where a split frame's time goes (the steps train on: each call is
    # another 20 updates of the same frame)
    for what, r in (("unsplit 540p bf16", ref[bf16]),
                    ("split D=2 540p bf16", runs["split D=2 bfloat16"][2]),
                    ("split D=4 540p bf16", runs["split D=4 bfloat16"][2]),
                    ("unsplit 1080p bf16", ref_hd),
                    ("split D=2 1080p bf16", hd)):
        frame = f1080 if "1080p" in what else f540
        prof = profile_call(torch, lambda: r["step"](r["state"], *frame),
                            iters=1 if "1080p" in what else 2, top=8)
        out[f"time {what}"] = prof
        print(f"spatial time {what}: " + json.dumps(prof), flush=True)
    prof = profile_call(torch, lambda: make_denoise(
        hd["model"], residual_model=True, spatial_mesh=mesh2)(f1080[0]),
        iters=5)
    out["time serve 1080p D=2 affine"] = prof
    print("spatial time serve 1080p D=2 affine: " + json.dumps(prof),
          flush=True)
    out["backward_from_the_same_forward"] = grads
    elapsed = time.perf_counter() - t_phase
    out["phase_s"] = elapsed
    print(f"phase time: spatial split {elapsed:.1f} s", flush=True)
    check(elapsed <= SPATIAL_PHASE_S,
          f"the spatial phase took {elapsed} s (limit {SPATIAL_PHASE_S})")
    return launches, out


def rgb_clip(n, seed):
    """``n`` 540p RGB frames in [0.1, 0.9], frame t the grey frames t, t+1
    and t+2 of ``synthetic_frames`` as its channels, and their noisy
    versions (sigma 25/255): (1, n, H, W, 3) each."""
    grey = synthetic_frames(n + 2, seed)[0][..., 0]
    clean = np.stack([np.stack(grey[t:t + 3], -1) for t in range(n)])[None]
    rng = np.random.default_rng(seed + 1)
    noisy = clean + SIGMA * rng.standard_normal(clean.shape)
    return clean.astype(np.float32), noisy.astype(np.float32)


def fastdvdnet_flops(torch, net, h, w):
    """Operations of one ``FastDVDnet`` window at h x w: two a multiply-add
    of every convolution, each DenBlock's blocks at their level's size,
    ``temp1`` three times and ``temp2`` once."""
    level = {"inc": 1, "downc0": 2, "downc1": 4, "upc2": 4, "upc1": 2,
             "outc": 1}

    def den(block):
        return sum(2 * m.weight[0].numel() * m.out_channels
                   * -(-h // level[name]) * -(-w // level[name])
                   for name, sub in block.named_children()
                   for m in sub.modules()
                   if isinstance(m, torch.nn.Conv2d))
    return 3 * den(net.temp1) + den(net.temp2)


def registry_phase(torch, fs, psnr):
    """The config-driven entry point (``load_model``): the pretrained
    DnCNN-17 served at B=4 through the fused kernels and scored by the
    harness's metrics; FastDVDnet at its published widths on a 540p RGB
    clip; a training state written and read back on this machine; the noise
    simulator's sample and fit. Returns (launch counts of the served batch,
    timings and checks)."""
    import tempfile

    import frame2frame_tpu_torch as port
    from frame2frame_tpu_torch.models.dncnn import (
        from_jax_variables, opt_state_to_jax)
    from frame2frame_tpu_torch.models.noise_sim import load_sim
    from frame2frame_tpu_torch.models.serialization import (
        load_train_state, save_train_state)
    from frame2frame_tpu_torch.train.online import OnlineDenoiser
    from frame2frame_tpu_torch.utils import (
        ExpTimer, GpuMemer, MemIt, TimeIt, compute_psnrs, compute_ssims,
        compute_strred)

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    out = {}
    B = 4
    loaded = port.load_model({
        "net_name": "dncnn", "channels": 1, "num_of_layers": 17,
        "residual": True, "conv_impl": "fused", "pretrained_load": True,
        "pretrained_path": str(CKPT)})
    check(next(loaded.model.parameters()).device.type == "cuda",
          "load_model without a device did not build on the card")
    clean, noisy = synthetic_frames(B)
    x = torch.from_numpy(noisy).to(dev)
    with torch.no_grad():
        f32_model = from_jax_variables(loaded.variables, residual=True,
                                       conv_impl="xla").to(dev).eval()
        plain = f32_model(x).cpu().numpy()
        del f32_model
    fs.reset_launch_counts()
    done = count_run(torch, fs, {"fwd_layer": NMID}, "registry apply")
    served = loaded.apply(noisy)
    torch.cuda.synchronize()
    done()
    launches = fs.launch_counts()
    out["dncnn_b4"] = hold_served(psnr, served, plain, clean, noisy,
                                  "registry load_model(dncnn).apply")
    eng = OnlineDenoiser(from_jax_variables(loaded.variables, residual=True),
                         loaded.variables, residual_model=True, device="cuda")
    stacked = eng.denoise_batch(x, route="stacked")
    check(torch.equal(served, stacked),
          "registry apply: not bit-equal to denoise_batch(route='stacked')")
    out["dncnn_b4"]["time"] = dict(
        profile_call(torch, lambda: loaded.apply(x)), frames=B)
    print("registry apply B=4: " + json.dumps(out["dncnn_b4"]), flush=True)

    deno = served.cpu().numpy()
    scores = {}
    for name, fn, args in (
            ("compute_psnrs", compute_psnrs, (deno, clean)),
            ("compute_ssims", compute_ssims, (deno, clean)),
            ("compute_strred", compute_strred, (clean, deno))):
        t0 = time.perf_counter()
        val = fn(*args, div=1.0)
        ms = (time.perf_counter() - t0) * 1e3
        noisy_args = (noisy, clean) if name != "compute_strred" else (
            clean, noisy)
        scores[name] = {"deno": [float(v) for v in val], "host_ms": ms,
                        "noisy": [float(v) for v in fn(*noisy_args, div=1.0)]}
        check(np.isfinite(val).all(), f"{name}: non-finite values")
    p = scores["compute_psnrs"]
    check(np.allclose(p["deno"], [psnr(clean[k], deno[k]) for k in range(B)],
                      rtol=0, atol=1e-9),
          "compute_psnrs disagrees with psnr")
    check(min(np.subtract(scores["compute_ssims"]["deno"],
                          scores["compute_ssims"]["noisy"])) > 0,
          "compute_ssims: the denoised frames score no better")
    check(min(scores["compute_strred"]["deno"]) >= 0,
          "compute_strred: a negative value")
    out["metrics"] = scores
    print("registry metrics: " + json.dumps(
        {k: {"deno_mean": float(np.mean(v["deno"])),
             "noisy_mean": float(np.mean(v["noisy"])),
             "host_ms": v["host_ms"]} for k, v in scores.items()}),
        flush=True)

    # FastDVDnet, published widths, seeded weights
    T = 7
    fdv = port.load_model({"net_name": "fastdvdnet", "channels": 3,
                           "seed": 0})
    clean_v, noisy_v = rgb_clip(T, seed=2)
    nm = np.full((1, H, W, 1), SIGMA, np.float32)
    win = noisy_v[:, :5, :96, :160]
    with torch.no_grad():
        on_card = fdv.model.net(torch.from_numpy(win).to(dev),
                                torch.from_numpy(nm[:, :96, :160]).to(dev))
        on_cpu = copy.deepcopy(fdv.model.net).cpu()(
            torch.from_numpy(win), torch.from_numpy(nm[:, :96, :160]))
    scale = float(on_cpu.abs().max())
    err = float((on_card.cpu() - on_cpu).abs().max())
    print(f"registry fastdvdnet 96x160 window: max|card-cpu| {err:.3e} of "
          f"{scale:.3e}", flush=True)
    check(err <= FDV_CPU_RTOL * scale,
          f"fastdvdnet window: card off the CPU by {err} (scale {scale})")
    timer, memer = ExpTimer(), GpuMemer()
    torch.cuda.reset_peak_memory_stats(dev)
    with MemIt(memer, "fastdvdnet"), TimeIt(timer, "fastdvdnet"):
        vid = fdv.apply(noisy_v, noise_map=nm)
    check(tuple(vid.shape) == (1, T, H, W, 3),
          f"fastdvdnet: output shape {tuple(vid.shape)}")
    check(bool(torch.isfinite(vid).all()), "fastdvdnet: non-finite output")
    prof = profile_call(torch, lambda: fdv.apply(noisy_v, noise_map=nm),
                        iters=3)
    peak_gb, _ = dict(memer.items())["fastdvdnet"]
    flops = fastdvdnet_flops(torch, fdv.model.net, H, W)
    out["fastdvdnet_540p"] = {
        "frames": T, "gflop_a_frame": flops / 1e9,
        "f32_bound_ms_a_frame": flops / F32_FLOP_PER_S * 1e3,
        "first_call_ms_a_frame":
            timer["timer_fastdvdnet"] * 1e3 / T,
        "ms_a_frame": prof["ms"] / T, "device_ms_a_frame":
            prof["device_ms"] / T, "busy_share": prof["busy_share"],
        "peak_gb": peak_gb, "window_max_abs_err": err,
        "top_kernels": prof["top_kernels"]}
    print("registry fastdvdnet 540p: " + json.dumps(out["fastdvdnet_540p"]),
          flush=True)
    del fdv, vid
    torch.cuda.empty_cache()

    # a training state on this machine (no flax, no msgpack package)
    params = loaded.variables["params"]
    stats = loaded.variables["batch_stats"]
    opt_state = opt_state_to_jax(eng.opt_state)
    extra = {"frame": np.asarray(3, np.int32),
             "psnr": np.asarray(p["deno"][0], np.float32),
             "shape": np.asarray([H, W])}
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "state.msgpack"
        save_train_state(path, params, opt_state, batch_stats=stats,
                         extra=extra)
        like = {"params": params, "opt_state": opt_state,
                "batch_stats": stats, "extra": extra}
        _same_tree(load_train_state(path, like), like, what="train state")
        out["train_state_bytes"] = path.stat().st_size
    print(f"registry train state: {out['train_state_bytes']} bytes read "
          "back bit-equal", flush=True)

    # the noise simulator: a known model's sample, then a fit from defaults
    a, b = SIM_A, SIM_B
    frame = clean_v[0, 0] * 255.0
    sim = load_sim({"sim_channels": 3, "sim_sigma_a": a, "sim_sigma_b": b})
    noisy_f = sim.run_rgb(frame,
                          generator=torch.Generator(dev).manual_seed(1))
    resid = (noisy_f - torch.from_numpy(frame).to(dev)) / sim.sigma(frame)
    fit = load_sim()
    t0 = time.perf_counter()
    loss = fit.fit(frame, noisy_f)
    torch.cuda.synchronize()
    fit_ms = (time.perf_counter() - t0) * 1e3
    cpu_fit = load_sim(device="cpu")
    cpu_fit.fit(frame, noisy_f.cpu())
    got = {k: v.cpu().numpy() for k, v in fit.params.items()}
    ref = {k: v.numpy() for k, v in cpu_fit.params.items()}
    out["noise_sim"] = {
        "residual_std": float(resid.std()), "fit_ms": fit_ms, "loss": loss,
        "a": got["a"].tolist(), "b": got["b"].tolist(),
        "a_err": float(np.abs(got["a"] - a).max()),
        "b_err": float(np.abs(got["b"] - b).max()),
        "a_vs_cpu": float(np.abs(got["a"] - ref["a"]).max()),
        "b_vs_cpu": float(np.abs(got["b"] - ref["b"]).max())}
    print("registry noise_sim: " + json.dumps(out["noise_sim"]), flush=True)
    check(abs(out["noise_sim"]["residual_std"] - 1) < 0.01,
          "run_rgb: the residual is not unit normal over sigma")
    check(out["noise_sim"]["a_err"] <= SIM_A_TOL
          and out["noise_sim"]["b_err"] <= SIM_B_TOL,
          "noise_sim fit: a or b not recovered")
    check(out["noise_sim"]["a_vs_cpu"] <= SIM_VS_CPU[0]
          and out["noise_sim"]["b_vs_cpu"] <= SIM_VS_CPU[1],
          "noise_sim fit: the card's fit is off the CPU's")

    elapsed = time.perf_counter() - t_phase
    out["phase_s"] = elapsed
    print(f"phase time: registry {elapsed:.1f} s", flush=True)
    return launches, out


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
    from frame2frame_tpu_torch.ops import _build
    from frame2frame_tpu_torch.ops import fused_ends as fe
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
        reports = _build.build_all()
        print(f"build: {', '.join(n + '.cu' for n in reports)} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for name, report in reports.items():
            for entry, regs, spill in ptxas_entries(report):
                print(f"  ptxas {name}: {entry} {regs} registers, {spill}",
                      flush=True)
            # ptxas serialises wgmma it cannot keep in flight: none expected
            for line in report.splitlines():
                if "Performance Loss" in line:
                    print(f"  ptxas {name}: {line.strip()}", flush=True)

        rows = kernel_phase(torch, F, fs, cuda_time_ms)
        rows.update(train_kernel_phase(torch, F, fs, cuda_time_ms))
        t0 = time.perf_counter()
        windows = spatial_kernel_phase(torch, fs, cuda_time_ms)
        print(f"phase time: windowed kernels {time.perf_counter() - t0:.1f} "
              "s", flush=True)
        t0 = time.perf_counter()
        rows.update(ends_kernel_phase(torch, F, fe, cuda_time_ms))
        print(f"phase time: end kernels {time.perf_counter() - t0:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        rows.update(flow_kernel_phase(torch, cuda_time_ms))
        print(f"phase time: flow inner loop {time.perf_counter() - t0:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        rows.update(conv_kernel_phase(torch, F, cuda_time_ms))
        print(f"phase time: conv kernels {time.perf_counter() - t0:.1f} s",
              flush=True)
        serve_launches, timings, variables, model = serving_phase(
            torch, fs, psnr)
        train_launches, flat_launches, training = training_phase(
            torch, fs, psnr, variables, model)
        flow_launches, flow = flow_path_phase(
            torch, fs, psnr, variables, model, training)
        flow["farneback"] = farneback_phase(torch, fs)
        del model
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        conv_launches, conv_impl = conv_impl_phase(torch, fs, psnr, variables)
        print(f"phase time: conv_impl routes {time.perf_counter() - t0:.1f} "
              "s", flush=True)
        t0 = time.perf_counter()
        stream_launches, stream = streaming_phase(torch, fs, psnr, variables)
        print(f"phase time: streaming loop {time.perf_counter() - t0:.1f} s",
              flush=True)
        torch.cuda.empty_cache()
        spatial_launches, spatial = spatial_phase(torch, fs, psnr, variables)
        torch.cuda.empty_cache()
        registry_launches, registry = registry_phase(torch, fs, psnr)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1

    # each path ran with the counts set to 0 just before it and read just
    # after; a kernel must have been launched on every path it belongs to
    # (training: the per-iteration route; flat: the flat route, which the
    # engine takes by itself; flow: the flat route fed by AsyncFlowSolver;
    # conv_<impl>: the engine on a conv_impl route; stream: the CLI's loop
    # on the flat route with AsyncFlowSolver; stream_pallas: the loop on
    # the "pallas" route; spatial: the H-split fine-tune and serving;
    # registry: load_model's apply of a "fused" DnCNN), and on no other path
    ends = ("flat", "flow", "stream")
    fused = ("training",) + ends + ("spatial",)
    conv_paths = tuple(f"conv_{impl}" for impl in CONV_ROUTES)
    paths = {"fwd_layer": ("serving",) + fused + ("registry",),
             "fwd_layer_eval": ("serving", "spatial"),
             "fwd_layer_train": fused, "bwd_layer": fused,
             "first_conv": ends, "last_loss_fwd": ends,
             "last_loss_bwd": ends, "first_dw": ends,
             "tvl1_inner_loop": ("flow", "stream"),
             "conv3x3_fwd": ("conv_pallas", "stream_pallas"),
             "dw_conv3x3": conv_paths + ("stream_pallas",)}
    by_path = {"serving": serve_launches, "training": train_launches,
               "flat": flat_launches, "flow": flow_launches,
               "stream": stream_launches["stream"],
               "stream_pallas": stream_launches["stream_pallas"],
               "spatial": spatial_launches, "registry": registry_launches,
               **{f"conv_{impl}": conv_launches[impl]
                  for impl in CONV_ROUTES}}
    for name, on in paths.items():
        for path, counts in by_path.items():
            if (counts[name] > 0) != (path in on):
                print(f"chip_smoke: FAIL: {name} was launched "
                      f"{counts[name]} times on the {path} path",
                      file=sys.stderr)
                return 1
    kernels = []
    for name, cfgs in rows.items():
        # B=1 bf16, 135x240 for the flow's inner loop (the finest scale a
        # 540p flow solves), 540p f32 for the conv_impl routes' kernels
        # (their first row): the shape the main paths give them
        main_row = cfgs[0]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "also_replaces": ALSO_REPLACES.get(name, []),
            "launches": sum(by_path[p][name] for p in paths[name]),
            "launches_by_path": {p: by_path[p][name] for p in paths[name]},
            "max_abs_err": main_row["max_abs_err"], "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"], "configs": cfgs,
            **windows.get(name, {})})
    print(json.dumps({"kernels": kernels, "serving": timings,
                      "training": training, "flow": flow,
                      "conv_impl": conv_impl, "streaming": stream,
                      "spatial": spatial, "registry": registry}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
