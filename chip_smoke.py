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
13. the adaptation path (``get_loss_fxn(cfg, t)`` -> ``train/adapt.py``
   wrapper -> loss -> Adam, ``adapt_phase``): the pretrained DnCNN-17
   through ``load_model`` on a 7-frame 540p clip of the moving texture
   (seed 21) with two held-out frames, for ``f2f``, ``stnls`` and ``sup`` at
   the registry's defaults (128x128 crops, ws 9, ps 7, k 5, stride0 4, wt 1,
   TV-L1 flows), Adam at 1e-4 on a cosine schedule; one window on the f32
   "xla" route on the card against the CPU (the loss within 1e-4; in
   float64 every parameter's gradient within 1e-9 and the update within
   1e-4; the f32 update equal to Adam's first step from the card's
   gradient) and "fused" against "xla" (the loss 0.5 %, ``sup``'s
   MSE by the denoised crops' rms; gradients by cosine and norm) and
   against its own backward on the plain dW; the search of a 128x128 window
   against the CPU (distances 1e-4, 99 % of inds equal) with its time and
   the refine's; kernel B at each of the 17 convolutions of a "fused"
   window and ``tvl1_inner_loop`` at each launch of its flow (the 128x128
   pyramid's levels, every pair of the window in one batch) against their
   plain versions on the inputs the path gave them; then on "fused" the
   windows, host ms, stream ms (CUDA events) and profiled device ms a
   window, peak memory, exactly 17 kernel B and one flow's
   ``tvl1_inner_loop`` launches a window (none for ``sup``), first and last
   loss, PSNR of the held-out frames before and after, and after the same
   windows on "xla": the gap within 1.25 times the JAX package's own gap
   between its bf16 and f32 graphs on the CPU
   (``ADAPT_JAX_FUSED_PSNR_GAP``);
14. the offline trainer (``train/trainer.run``, ``offline_phase``): the
   pretrained DnCNN-17 on "fused" over two 5-frame 540p clips of the mixed
   synthetic texture, two epochs of the warped loss on TV-L1 flows solved
   each step, Adam at 1e-4; one step on a 128x128 crop (flows handed in)
   on the f32 "xla" route on the card against the CPU (the loss within
   1e-4, the updated weights within 1e-4 of the largest but for at most
   0.5 % of the elements, by at most two learning rates) and on "fused"
   against "xla" (the loss 0.5 %); kernel B at each of a full-width step's
   17 convolutions and the inner loop at each launch of its flow against
   their plain versions; then ``trainer.run``: exactly 17 kernel B and one
   solve's inner launches a step, the final checkpoint read back bit for
   bit, the CSV's rows and the files written, finite ``val_psnr`` and
   ``train_loss``, host ms a step, profiled device ms a step, busy share
   and peak memory;
15. the evaluation pipeline (``eval/test.run``, ``eval_phase``): a 4-frame
   540p PGM clip of the mixed texture moving (1, 2) px a frame, the
   pretrained DnCNN-17 on "fused", ``read_flows``: the first run (chunked,
   256 px tiles, overlap 0.1) solves the flows on the card into 8 ``.flo``
   sidecars (their median within 0.1 px of the motion), the later runs read
   them back bit for bit with no inner launch; the plain run's clip
   bit-equal to ``load_model(cfg).apply`` on exactly 15 ``fwd_layer``
   launches, with a gain over noisy and its timer and memory meter; the x8
   self-ensemble no more than 0.05 dB below it, the chunked run within
   0.1 dB; internal adaptation (one f2f window, 17 kernel B); the B2U second
   pass (``psnrs_pp``); each run's metrics, launches, timers and wall time;
16. the experiment launchers (``scripts/torch_trte_*``, ``launcher_phase``)
   in a fresh working directory: the ``trte_dncnn`` train launcher on the
   grid of ``exps/trte_dncnn/train.cfg`` on "fused" (DnCNN-17, three
   sigmas, 64x64 clips) through the port's process backend, one worker on
   cuda:0 running ``launch_train_run``, which reports the worker's pid,
   card and kernel launches (17 kernel B a step) in its record; no record
   holds an error; each worker's ``val_psnr`` within 1e-3 dB of the same
   config run in process, whose kernel B inputs are held against the plain
   version; a second call skips every config and launches nothing; the
   ``trte_dncnn`` test launcher in process (``fwd_layer`` held on its
   inputs); the ``trte_net`` pair (FastDVDnet);
17. multi-device training with the card repeated (``shard_phase``): the
   pretrained DnCNN-17 on "fused"; the f2f step (``parallel/shard.py``) at
   540p, B = 2, T = 4 on meshes (1, 1), (2, 1), (1, 2), (2, 2) with
   ``train_bn=False`` (the loss within 1e-4 of the unsharded step, the
   weights by the adaptation rule, 17 kernel B a shard a step, peak
   memory), with ``train_bn=True`` on (2, 2) twice (the same bits); the
   warped and stnls window steps on 128x128 crops on (1, 2); the sup step
   on (2, 2); ``trainer.run`` on ``exps/trte_dncnn/train.cfg``'s 64x64
   clips at batch size 2 on two shards against one device, on "fused" and
   "pallas" (one more shard's kernel A and B a step); kernel B on the
   (2, 2) step's inputs and kernels A, B and the inner loop on a
   data-parallel "pallas" step's against their plain versions;
18. ``load_model`` with ``model_dtype="bfloat16"`` on "pallas"
   (``model_dtype_phase``): the pretrained DnCNN-17 serves a 540p frame and
   takes one training forward and backward on a 128x128 crop (50 kernel A,
   17 kernel B), the kernels held on those inputs, the bf16 output on the
   crop against the CPU's at the bf16 graph's bound;
19. a JSON line of per-kernel numbers (launches by path: each kernel is
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
# the adaptation path (get_loss_fxn -> wrapper -> loss -> Adam): the
# registry's defaults for the losses, a 7-frame 540p clip and two held-out
# frames of the same scene, Adam at eval/test.py's adaptation learning rate
# on its cosine schedule
ADAPT_LOSSES = ("f2f", "stnls", "sup")
ADAPT_CFG = dict(adapt_isize="128_128", adapt_nepochs=1, nbatch_sample=1,
                 flow=True, flow_method="tvl1", ws=9, ps=7, k=5, stride0=4,
                 wt=1)
ADAPT_T, ADAPT_HELD, ADAPT_SEED = 7, 2, 21
ADAPT_LR = 1e-4
# one window on the f32 module route ("xla", TF32 off) on the card against
# the same window on the CPU: the loss, f32 sums in another order
ADAPT_CPU_RTOL = 1e-4
# the same window in float64 on the card and on the CPU, each parameter's
# gradient relative to its own largest: float64 sums in another order. Near
# the loss's minimum a gradient is a small sum of large terms, so the f32
# gradients of this window lie 1.1e-3 apart (measured on an H100) from an
# f32 rounding of 6e-8; float64's 1.1e-16 takes that to ~2e-12. Its update,
# by leaf against the update's largest, within ADAPT_CPU_RTOL: Adam's first
# step lr * g / (|g| + eps) multiplies a gradient's difference by up to
# max |g| / (4 eps), ~1e6 here. (The f32 updates are not held to each
# other: where an f32 gradient element is at its rounding noise, its sign,
# and so a whole step of 1e-4, differs between the devices: 1.1e-4 of the
# largest weight on an H100.)
ADAPT_F64_RTOL = 1e-9
# that window's update on the card against Adam's first step from the card's
# own gradient, lr * g / (|g| + eps), per element: one ulp of the weight (the
# new weight's f32 rounding) and this share of the learning rate
ADAPT_UPDATE_RTOL = 1e-5
# "fused" (the bf16 graph) against "xla" on the card, from the same window.
# The self-supervised losses within the loss's 0.5 % of PERF.md section 2.
# The denoised crops within ROUTES_DENO_RMS; "sup", the MSE against the
# clean crops, within 2 sqrt(mse) r + r^2 of xla's MSE, r = ROUTES_DENO_RMS:
# the most that an output error of rms r moves an MSE.
ADAPT_ROUTE_RTOL = 5e-3
# ... and each kind of parameter's gradient (GRAD_KINDS, each kind as one
# vector) no farther from xla's, |fused - xla| / |xla|, than BF16_GRAPH_RATIO
# times the JAX package's bf16 graph ("fused") from its f32 graph ("xla") on
# the same window: the rule of tests/test_torch_bf16_graph.py. The JAX
# package's distances, measured on the CPU by
# scripts/torch_adapt_bf16_grad.py (the port's own there: 0.96-1.05 times
# them)
BF16_GRAPH_RATIO = 1.25
ADAPT_JAX_BF16_GRAD_REL = {
    "f2f": {"conv": 0.3906, "bn_scale": 0.4029, "bn_bias": 0.5828},
    "stnls": {"conv": 0.2770, "bn_scale": 0.2593, "bn_bias": 0.4006},
    "sup": {"conv": 0.3770, "bn_scale": 0.3624, "bn_bias": 0.5742}}
# the held-out PSNR after adapting on "fused" against "xla" (the same
# windows): the JAX package's own gap between its bf16 and f32 graphs (dB),
# measured on the CPU by scripts/torch_adapt_fused_psnr_gap.py (the port's
# own there: 0.02881, 0.12550, 0.11050); the card's gap is held to
# BF16_GRAPH_RATIO times it
ADAPT_JAX_FUSED_PSNR_GAP = {"f2f": 0.03096, "stnls": 0.12734, "sup": 0.10367}
# the parameter kinds of a DnCNN by name: the convolutions' weights, the
# BatchNorm scales, the BatchNorm biases
GRAD_KINDS = {
    "conv": lambda n: n.startswith("conv"),
    "bn_scale": lambda n: n.startswith("bn") and n.endswith("weight"),
    "bn_bias": lambda n: n.startswith("bn") and n.endswith("bias")}
# non_local_search of a 128x128 window on the card against the CPU: the
# distances relative to the largest; the share of equal inds (a near tie
# may swap two offsets)
SEARCH_CPU_RTOL, SEARCH_INDS_SHARE = 1e-4, 0.99
# the offline trainer (trainer.run) at full width: the pretrained DnCNN-17
# on "fused" over two 5-frame 540p clips of the mixed synthetic texture,
# two epochs, the warped loss on TV-L1 flows solved each step
OFFLINE_CFG = dict(
    net_name="dncnn", channels=1, num_of_layers=17, residual=True,
    conv_impl="fused", pretrained_load=True, pretrained_path=str(CKPT),
    dname="synthetic", texture="mixed", isize_data=(540, 960), nvideos=2,
    nframes_data=5, ntype="g", sigma=25, nepochs=2, crit_name="warped",
    flow=True, flow_method="tvl1", lr_init=1e-4, seed=0, uuid="offline")
OFFLINE_STEPS = 4  # 2 videos x 2 epochs at batch size 1
# one step on a 128x128 crop of the clip (3 frames, flows handed in): "xla"
# on the card against the CPU, the loss within ADAPT_CPU_RTOL and the
# updated weights within OFFLINE_WEIGHT_RTOL of the largest weight, but for
# at most OFFLINE_KINK_SHARE of the elements: where an f32 gradient element
# is at its rounding noise its sign, and so Adam's first step, differs
# between the devices (adapt_phase's note above), and BatchNorm trains here;
# those elements within two learning rates. "fused" against "xla" on the
# card: the loss within ADAPT_ROUTE_RTOL
OFFLINE_WEIGHT_RTOL = 1e-4
OFFLINE_KINK_SHARE = 5e-3
OFFLINE_CROP = (slice(0, 3), slice(200, 328), slice(300, 428))
# the evaluation pipeline (eval.test.run) at full width: the pretrained
# DnCNN-17 on "fused" over a 4-frame 540p PGM clip of the mixed texture
# moving EVAL_SHIFT (dy, dx) pixels a frame, noise sigma 25, flows solved
# once into .flo sidecars
EVAL_T, EVAL_SHIFT = 4, (1, 2)
EVAL_FLOW_TOL = 0.1  # px, the solved flows' median against the shift
EVAL_AUG_TOL = 0.05  # dB below the plain run at most
# the chunked run (EVAL_CHUNK tiles) against the plain run on the pixels
# that lie deeper than the network's receptive field (EVAL_CHUNK_R px,
# one a 3x3 layer) inside every tile that holds them, on the [0, 255]
# scale; nearer a tile's inner edge a tile sees zeros where the frame has
# pixels, so there the clip differs, as in the JAX package
EVAL_CHUNK = dict(spatial_chunk_size=256, spatial_chunk_overlap=0.1)
EVAL_CHUNK_R = 17
EVAL_CHUNK_INTERIOR_ATOL = 1e-3
# the launchers (launcher_phase): a dispatched config's val_psnr against
# the same config run in process
LAUNCH_PSNR_DB = 1e-3
# model_dtype="bfloat16" (model_dtype_phase): the frame's seed
DTYPE_SEED = 31
EVAL_CFG = dict(
    net_name="dncnn", channels=1, num_of_layers=17, residual=True,
    conv_impl="fused", pretrained_load=True, pretrained_path=str(CKPT),
    dname="evalset", dset="te", vid_name="vid00", sigma=25, read_flows=True,
    save_deno=False, seed=123, lr_init=1e-4)
# multi-device training on one card (shard_phase): the pretrained
# DnCNN-17 on "fused", the f2f step at 540p on SHARD_B rows of SHARD_T
# frames over each of SHARD_MESHES (the card repeated), Adam at SHARD_LR;
# with train_bn=False a sharded step is the unsharded one but for the sums'
# order: the loss within SHARD_LOSS_RTOL, the weights by the adaptation
# rule (SHARD_SHARE of the elements within 1e-5, all within two learning
# rates a step); the window steps on a SHARD_CROP crop; trainer.run on two
# shards against one device, one SGD step at train.cfg's lr_init: the loss
# within SHARD_TRAINER_LOSS_RTOL, the update (the learning rate times the
# gradient) within SHARD_TRAINER_UPDATE_RTOL and the running statistics'
# move within SHARD_TRAINER_STATS_RTOL of one device's, relative in the
# 2-norm (the whole batch's statistics summed by shard round differently);
# the shards' own statistics, or the whole batch's detached, fail it
SHARD_B, SHARD_T = 2, 4
SHARD_MESHES = ((1, 1), (2, 1), (1, 2), (2, 2))
SHARD_LR = 1e-4
SHARD_LOSS_RTOL = 1e-4
SHARD_SHARE = 0.995
SHARD_CROP = (slice(200, 328), slice(300, 428))
SHARD_TRAINER_LOSS_RTOL = 1e-4
# the H100's readings (NVIDIA H100 80GB HBM3, 700 W): the update 5.7e-3
# "fused", 1.1e-3 "pallas", the planted faults 0.53 and 3.3; the running
# statistics 1.9e-7, the shards' own statistics 9.4e-3
SHARD_TRAINER_UPDATE_RTOL = 2e-2
SHARD_TRAINER_STATS_RTOL = 1e-5
SHARD_PHASE_S = 60
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


# bwd_layer_phase: frames and crops the backward body runs at (B, H, W);
# slabs of H-split frames (hf, wf, D, k) as WINDOW_CASES
BWD_BODY_SHAPES = (("540p", (1, H, W)), ("1080p", (1, 2 * H, 2 * W)),
                   ("B=4 540p", (4, H, W)), ("13x20", (3, 13, 20)),
                   ("96x128", (2, 96, 128)))
BWD_BODY_SLABS = ((1080, 1920, 2, 1), (540, 960, 4, 2), (540, 960, 4, 3))


def bwd_layer_phase(torch, fs, variables, model, cuda_time_ms):
    """The mid layers' backward body (``csrc/fused_stack_bwd.cu``: wgmma fed
    by a TMA ring) against its plain version with the kernel's operand
    rounding: at 540p and 1080p, at B = 4, on ragged crops and on the slabs
    of H-split frames, ``first_layer`` both ways, on the bf16 chain and (the
    crops and 540p) the f32 chain; two launches on the same inputs give the
    same bits; and over one flat fine-tune step under a profiler the
    recorder's ``kernel.bwd_layer.wgmma`` counts every ``bwd_layer``
    launch. Returns the CUDA-event ms a bf16 launch by case."""
    from frame2frame_tpu_torch.ops.fused_spatial import _valid_bounds, pad_h
    from frame2frame_tpu_torch.train.online import OnlineDenoiser
    from frame2frame_tpu_torch.utils import profiling

    rng = np.random.default_rng(22)
    w = torch.from_numpy((rng.standard_normal((3, 3, FEAT, FEAT))
                          * np.sqrt(2.0 / (9 * FEAT))).astype(np.float32)).cuda()
    wk = fs.kernel_weights(w)
    cases = [(tag, shape, None) for tag, shape in BWD_BODY_SHAPES]
    for hf, wf, D, k in BWD_BODY_SLABS:
        R = pad_h(hf, D) // D
        cases.append((f"slab {k} of {hf}x{wf} D={D}", (1, R + 2, wf),
                      _valid_bounds(k, R, hf)))
    out = {}
    for tag, shape, vb in cases:
        small = shape[1] * shape[2] <= H * W
        for dt in (torch.bfloat16, torch.float32) if small else (
                torch.bfloat16,):
            z_prev, z_i, g, vecs = train_inputs(torch, rng, shape, dt)
            name = f"bwd_layer {tag} {str(dt).replace('torch.', '')}"
            for first in (False, True):
                got = fs.bwd_layer(g, z_i, z_prev, wk, vecs, first,
                                   valid_bounds=vb)
                again = fs.bwd_layer(g, z_i, z_prev, wk, vecs, first,
                                     valid_bounds=vb)
                torch.cuda.synchronize()
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      f"{name} first={first}: two launches on the same "
                      "inputs differ")
                ref = fs.bwd_layer_plain(g, z_i, z_prev, w, vecs, first,
                                         mma_bf16=True, valid_bounds=vb)
                what = f"{name} first={first}"
                hold_close(what, "da", got[0], ref[0], KERNEL_RTOL)
                hold_close(what, "dW", got[1], ref[1], KERNEL_RTOL)
                for k, part in enumerate(("sum_gp", "sum_gp_zhat")):
                    hold_close(what, part, got[2][k], ref[2][k],
                               KERNEL_RTOL)
                del got, again, ref
            if dt == torch.bfloat16:
                out[tag] = cuda_time_ms(
                    lambda: fs.bwd_layer(g, z_i, z_prev, wk, vecs, False,
                                         valid_bounds=vb),
                    head_start_cycles=HEAD_START_CYCLES)
                print(f"{name}: held, bit-equal twice, ms {out[tag]:.4f}",
                      flush=True)
            del z_prev, z_i, g
        torch.cuda.empty_cache()

    # one flat fine-tune step under a profiler: the recorder counts the
    # wgmma body at every launch
    dev = torch.device("cuda")
    _, noisy, flows = moving_frames(2)
    frames = torch.from_numpy(noisy).to(dev)
    eng = OnlineDenoiser(model, variables, iters=ITERS, residual_model=True)
    before = fs.bwd_layer.launches
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        profiling.clear()
        eng.process_frame(frames[1], frames[0],
                          torch.from_numpy(flows[1]).to(dev))
        torch.cuda.synchronize()
        counters = profiling.recorded()["counters"]
    profiling.clear()
    launches = fs.bwd_layer.launches - before
    counted = counters.get(fs.BWD_BODY_COUNTER, 0)
    check(launches == NMID * ITERS and counted == launches,
          f"flat step: {launches} bwd_layer launches, the recorder counted "
          f"{counted} on the wgmma body")
    print(f"bwd_layer body: kernel.bwd_layer.wgmma {counted} = "
          f"bwd_layer.launches {launches} over a flat step", flush=True)
    out["flat_step_counted"] = counted
    del eng, frames
    torch.cuda.empty_cache()
    return out


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
                    plan="shape", tau=0.25, lambda_=0.2, theta=0.3):
    """One launch of the flow's inner loop against its plain version: equal
    iteration counts a pair, the same bits in every output, the same bits on
    a second run. ``plan="shape"`` takes the body that ``cluster_plan``
    gives the shape; a plan or ``None`` (the cooperative body) takes that
    body (``body_of``). Returns (iterations a pair, max |kernel - plain|,
    max |plain|)."""
    kw = dict(tau=tau, lambda_=lambda_, theta=theta, epsilon=epsilon,
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


def ring_check(d):
    """The native prefetch ring over ``d``'s ``noisy_NNN.pgm`` frames and
    ``flow_NNN.flo`` flows (frames 2 on) against the Python readers, bit
    for bit; the host ms a frame of each, and whether the library has
    PNG."""
    from frame2frame_tpu_torch.io import native as native_io
    from frame2frame_tpu_torch.io.flo import read_flo
    from frame2frame_tpu_torch.io.image import read_frame

    t0 = time.perf_counter()
    has_png = native_io.has_png()
    build_s = time.perf_counter() - t0
    frames = [str(d / f"noisy_{i:03d}.pgm")
              for i in range(1, STREAM_FRAMES + 1)]
    flos = [None] + [str(d / f"flow_{i:03d}.flo")
                     for i in range(2, STREAM_FRAMES + 1)]
    t0 = time.perf_counter()
    with native_io.NativePrefetcher(frames, flos) as pf:
        ring = [pf.get(k) for k in range(STREAM_FRAMES)]
    ring_ms = (time.perf_counter() - t0) * 1e3 / STREAM_FRAMES
    t0 = time.perf_counter()
    py = [(np.asarray(read_frame(f, 0), np.float32),
           None if fl is None else read_flo(fl).astype(np.float32))
          for f, fl in zip(frames, flos)]
    py_ms = (time.perf_counter() - t0) * 1e3 / STREAM_FRAMES
    for k, ((a, fa), (b, fb)) in enumerate(zip(ring, py)):
        check(a.dtype == b.dtype and np.array_equal(a, b)
              and (fa is None) == (fb is None)
              and (fa is None or np.array_equal(fa, fb)),
              f"streaming: the ring's frame {k + 1} differs from the "
              "Python readers'")
    return {"frames": STREAM_FRAMES, "bit_equal": True, "has_png": has_png,
            "build_or_load_s": build_s, "ring_ms_a_frame": ring_ms,
            "python_ms_a_frame": py_ms}


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

        # the native ring (io/native.py, built here with g++) against the
        # Python readers on the sequence's PGM frames and .flo files
        out["ring"] = ring_check(d)
        print("streaming native ring: " + json.dumps(out["ring"]),
              flush=True)

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
            res = online.run_blind_denoising(
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
            check(res["loader"] == "native", "streaming pallas: the frames "
                  f"were read by the {res['loader']} loader, not the ring")
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


@functools.lru_cache(maxsize=1)
def adapt_clip():
    """The adaptation's clip: (noisy, clean) of ``ADAPT_T`` frames as
    (1, T, H, W, 1), and the held-out (noisy, clean) frames."""
    clean, noisy, _ = moving_frames(ADAPT_T + ADAPT_HELD, seed=ADAPT_SEED)
    return ((noisy[None, :ADAPT_T], clean[None, :ADAPT_T]),
            (noisy[ADAPT_T:], clean[ADAPT_T:]))


def adapt_state(conv_impl, device=None, nwin=1):
    """The pretrained DnCNN-17 through ``load_model`` in a ``TrainState``
    with Adam at ``ADAPT_LR`` on a cosine schedule over ``nwin`` windows:
    ``(state, sched)``."""
    import frame2frame_tpu_torch as port
    from frame2frame_tpu_torch.train.schedules import make_optimizer
    from frame2frame_tpu_torch.train.state import TrainState

    loaded = port.load_model({
        "net_name": "dncnn", "channels": 1, "num_of_layers": 17,
        "residual": True, "conv_impl": conv_impl, "pretrained_load": True,
        "pretrained_path": str(CKPT)}, device=device)
    tx, sched = make_optimizer({"scheduler_name": "cosa",
                                "lr_init": ADAPT_LR, "nepochs": 1},
                               steps_per_epoch=nwin)
    return TrainState.create(loaded.model, loaded.variables, tx,
                             residual=True), sched


def adapt_first_window(torch, lt, conv_impl, device=None,
                       plain_backward=False, dtype=None):
    """One window of loss ``lt`` without flow (the same inputs on every
    route and device), the model in ``dtype`` where given: its loss,
    denoised and clean crops, and each parameter's gradient, weight before
    and after the update (float64 on the host), and the update's learning
    rate. The wrapper runs as it is; its forward and update are wrapped to
    read them."""
    import frame2frame_tpu_torch as port
    from frame2frame_tpu_torch.train import adapt as adapt_mod
    from frame2frame_tpu_torch.train.schedules import adam_lr_factor

    (vid_n, vid_c), _ = adapt_clip()
    cfg = dict(ADAPT_CFG, flow=False, adapt_nsteps=1)
    st, sched = adapt_state(conv_impl, device)
    st.model.plain_backward = plain_backward
    if dtype is not None:
        st.model.to(dtype)
    wrapper = port.get_loss_fxn(cfg, lt)
    rec, fwd, update = {}, wrapper._fwd_video, adapt_mod.apply_gradients

    def params64(model):  # copies, also where a float64 CPU view would do
        return {n: p.detach().double().cpu().clone()
                for n, p in model.named_parameters()}

    def fwd_read(apply_fn, vid):
        deno = fwd(apply_fn, vid)
        rec["deno"] = deno.detach().double().cpu()
        return deno

    def update_read(state, *a, **kw):
        rec["grad"] = {n: p.grad.detach().double().cpu().clone()
                       for n, p in state.model.named_parameters()}
        rec["before"] = params64(state.model)
        rec["lr"] = (float(state.tx.sched(state.step))
                     * adam_lr_factor(state.step + 1))
        return update(state, *a, **kw)

    wrapper._fwd_video = fwd_read
    adapt_mod.apply_gradients = update_read
    try:
        st, info = wrapper(st, vid_n, vid_c, seed=ADAPT_SEED, sched=sched)
    finally:
        adapt_mod.apply_gradients = update
    rec["after"] = params64(st.model)
    rec["loss"] = info.loss[0]
    # the window's clean crops: the wrapper's own crop of the clip
    _, cc = wrapper._crops(vid_n, vid_c, 0, np.random.default_rng(ADAPT_SEED))
    rec["clean"] = torch.from_numpy(
        np.asarray(cc, np.float64).reshape(rec["deno"].shape))
    return rec


def grad_distance(got, ref):
    """A gradient against a reference, by parameter kind (``GRAD_KINDS``,
    each kind's leaves as one vector): ``{kind: {"rel": |got - ref| /
    |ref|, "cosine", "norm_ratio"}}``; ``got`` and ``ref`` map names to
    float64 arrays or tensors."""
    out = {}
    for kind, of in GRAD_KINDS.items():
        names = sorted(n for n in ref if of(n))
        r = np.concatenate([np.asarray(ref[n], np.float64).ravel()
                            for n in names])
        g = np.concatenate([np.asarray(got[n], np.float64).ravel()
                            for n in names])
        nr, ng = float(np.linalg.norm(r)), float(np.linalg.norm(g))
        out[kind] = {"rel": float(np.linalg.norm(g - r)) / nr,
                     "cosine": float(g @ r) / (nr * ng),
                     "norm_ratio": ng / nr}
    return out


def read_path_kernels(torch, run):
    """Run ``run()`` with kernel B (``ops.conv3x3.dw_conv3x3``), kernel A
    (``ops.conv3x3.conv3x3_fwd``), the eval mid layer
    (``models.fused_apply.fwd_layer``) and the flow's inner loop
    (``flow.tvl1.tvl1_inner_loop``) wrapped to keep copies of the inputs
    the path hands them: ``{"b": [(x, g)], "a": [(x, w)], "fwd": [(z_prev,
    w, s, b)], "flow": [(arrays, (tau, lambda, theta, epsilon,
    max_iters))]}``, one entry a launch. The solver binds its inner loop
    when it is built, so the solver cache is cleared around the run."""
    from frame2frame_tpu_torch.flow import tvl1 as tvl1_mod
    from frame2frame_tpu_torch.models import fused_apply as fa
    from frame2frame_tpu_torch.ops import conv3x3 as c3

    seen = {"b": [], "a": [], "fwd": [], "flow": []}
    kernel_b, kernel_a = c3.dw_conv3x3, c3.conv3x3_fwd
    fwd, inner = fa.fwd_layer, tvl1_mod.tvl1_inner_loop

    class Reader:
        """Stands in for a kernel and keeps copies of its inputs. Its
        ``launches`` is the kernel's own, so a kernel that counts itself
        through its module global (kernel A: ``conv3x3_fwd.launches``)
        still counts on itself while a reader stands in that global."""

        def __init__(self, key, fn):
            self.key, self.fn = key, fn

        def __call__(self, *a):
            seen[self.key].append(tuple(t.detach().clone() for t in a))
            return self.fn(*a)

        launches = property(lambda self: self.fn.launches,
                            lambda self, n: setattr(self.fn, "launches", n))

    def read_inner(*a, **kw):
        seen["flow"].append(([t.clone() for t in a[:10]], a[10:15]))
        return inner(*a, **kw)

    c3.dw_conv3x3, c3.conv3x3_fwd = Reader("b", kernel_b), Reader("a",
                                                                  kernel_a)
    fa.fwd_layer, tvl1_mod.tvl1_inner_loop = Reader("fwd", fwd), read_inner
    tvl1_mod._make_solver.cache_clear()
    try:
        run()
        torch.cuda.synchronize()
    finally:
        c3.dw_conv3x3, c3.conv3x3_fwd = kernel_b, kernel_a
        fa.fwd_layer, tvl1_mod.tvl1_inner_loop = fwd, inner
        tvl1_mod._make_solver.cache_clear()
    return seen


def hold_path_kernels(torch, tag, seen, terms_scale=False):
    """Each kernel against its plain version on the inputs the path handed
    it (``read_path_kernels``' records): kernels A and B within
    ``CONV_RTOL``, ``fwd_layer`` within ``KERNEL_RTOL`` of the largest plain
    value, the inner loop at each launch bit-equal. The scale of kernel B's
    hold is the largest plain value, or with ``terms_scale`` the largest
    sum of the products' magnitudes that a weight's gradient adds up (the
    plain version on |x| and |g|): the bound of an f32 sum's rounding in
    any order, for gradients whose millions of products cancel. Returns the
    worst relative error of each kernel by shape (for kernel B against the
    largest plain value, and against the scale held), and the inner loop's
    launches and iterations by level."""
    from frame2frame_tpu_torch.flow import tvl1_inner as ti
    from frame2frame_tpu_torch.ops import conv3x3 as c3
    from frame2frame_tpu_torch.ops import conv_dw as cdw
    from frame2frame_tpu_torch.ops import fused_stack as fs

    def shape_of(x, cout):
        return (f"{tuple(x.shape[:3])} {x.shape[-1]}->{cout} "
                f"{str(x.dtype)[6:]}")

    b_err, b_held = {}, {}
    for x, g in seen["b"]:
        got, ref = cdw.dw_conv3x3(x, g), cdw.dw_conv3x3_plain(x, g)
        torch.cuda.synchronize()
        err, scale = rel_err(got, ref)
        held = scale
        if terms_scale:
            held = float(cdw.dw_conv3x3_plain(x.abs(), g.abs()).max())
        shape = shape_of(x, g.shape[-1])
        check(bool(torch.isfinite(got).all()) and err <= CONV_RTOL * held,
              f"{tag}: kernel B at {shape} off plain by {err} of {held}")
        b_err[shape] = max(b_err.get(shape, 0.0), err / scale)
        b_held[shape] = max(b_held.get(shape, 0.0), err / held)
        del got, ref
    a_err = {}
    for x, w in seen["a"]:
        got, ref = c3.conv3x3_fwd(x, w), c3.conv3x3_fwd_plain(x, w)
        err, scale = rel_err(got, ref)
        shape = shape_of(x, w.shape[-1])
        check(bool(torch.isfinite(got).all()) and err <= CONV_RTOL * scale,
              f"{tag}: kernel A at {shape} off plain by {err} of {scale}")
        a_err[shape] = max(a_err.get(shape, 0.0), err / scale)
        del got, ref
    fwd_err = {}
    for z, w, s, b in seen["fwd"]:
        got, ref = fs.fwd_layer(z, w, s, b), fs.fwd_layer_plain(z, w, s, b)
        err, scale = rel_err(got, ref)
        shape = shape_of(z, w.shape[-1])
        check(bool(torch.isfinite(got).all()) and err <= KERNEL_RTOL * scale,
              f"{tag}: fwd_layer at {shape} off plain by {err} of {scale}")
        fwd_err[shape] = max(fwd_err.get(shape, 0.0), err / scale)
        del got, ref
    levels = {}
    for k, (arrays, (tau, lam, theta, eps, mi)) in enumerate(seen["flow"]):
        n, err, _ = hold_inner_loop(
            torch, ti, f"{tag} flow launch {k}", arrays, mi, epsilon=eps,
            tau=tau, lambda_=lam, theta=theta)
        lv = levels.setdefault("x".join(map(str, arrays[0].shape)),
                               {"launches": 0, "iterations": []})
        lv["launches"] += 1
        lv["iterations"].append(n)
    out = {"kernel_b_rel_err": b_err, "tvl1_inner_levels": levels}
    if terms_scale:
        out["kernel_b_err_of_terms"] = b_held
    if a_err:
        out["kernel_a_rel_err"] = a_err
    if fwd_err:
        out["fwd_layer_rel_err"] = fwd_err
    return out


def adapt_phase(torch, fs, psnr):
    """The adaptation path (``get_loss_fxn(cfg, t)`` -> wrapper -> loss ->
    Adam): the pretrained DnCNN-17 through ``load_model`` on a 7-frame 540p
    clip, for ``f2f``, ``stnls`` and ``sup`` at the registry's defaults, on
    ``conv_impl="fused"``; holds against the CPU, the f32 route, the plain
    versions of the path's kernels on the inputs the path gave them, and the
    wrappers' launches a window. Returns (launch counts of the fused runs,
    timings and checks)."""
    import frame2frame_tpu_torch as port
    from frame2frame_tpu_torch.flow.api import run_flows
    from frame2frame_tpu_torch.ops import nls
    from frame2frame_tpu_torch.train import adapt as adapt_mod
    from frame2frame_tpu_torch.utils.timer import cuda_time_ms

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    (vid_n, vid_c), (held_n, held_c) = adapt_clip()
    noisy = np.concatenate([vid_n[0], held_n])
    out = {}

    def rel_by_leaf(got, ref):
        return {n: float((got[n] - r).abs().max() / r.abs().max())
                for n, r in ref.items()}

    # (a) one window on the f32 route, card against CPU; "fused" against
    # "xla" on the card, and against its own backward on the plain dW
    for lt in ADAPT_LOSSES:
        card = adapt_first_window(torch, lt, "xla")
        cpu = adapt_first_window(torch, lt, "xla", device="cpu")
        card64 = adapt_first_window(torch, lt, "xla", dtype=torch.float64)
        cpu64 = adapt_first_window(torch, lt, "xla", device="cpu",
                                   dtype=torch.float64)
        fused = adapt_first_window(torch, lt, "fused")
        fused_plain = adapt_first_window(torch, lt, "fused",
                                         plain_backward=True)
        hold = {"xla_card": card["loss"], "xla_cpu": cpu["loss"],
                "fused_card": fused["loss"],
                "loss_rel_err_vs_cpu":
                    abs(card["loss"] - cpu["loss"]) / cpu["loss"]}
        w_err = max(float((card["after"][n] - r).abs().max())
                    for n, r in cpu["after"].items())
        w_scale = max(float(r.abs().max()) for r in cpu["after"].values())
        hold["weights_f32_rel_err_vs_cpu"] = w_err / w_scale
        # the gradients: f32 on each device against float64 (the f32
        # rounding of a gradient near the loss's minimum), and float64 on the
        # card against float64 on the CPU, by leaf
        hold["grad_f32"] = {
            "card_vs_cpu": grad_distance(card["grad"], cpu["grad"]),
            "card_vs_f64": grad_distance(card["grad"], card64["grad"]),
            "cpu_vs_f64": grad_distance(cpu["grad"], cpu64["grad"])}
        grad_cpu = rel_by_leaf(card64["grad"], cpu64["grad"])
        worst = max(grad_cpu, key=grad_cpu.get)
        hold["grad_f64_worst_vs_cpu"] = [worst, grad_cpu[worst]]
        # ... and the float64 window's update, by leaf against its largest
        step_cpu = rel_by_leaf(
            {n: card64["after"][n] - w for n, w in card64["before"].items()},
            {n: cpu64["after"][n] - w for n, w in cpu64["before"].items()})
        worst_step = max(step_cpu, key=step_cpu.get)
        hold["update_f64_worst_vs_cpu"] = [worst_step, step_cpu[worst_step]]
        # Adam's first step from the card's own gradient: every weight moved
        # by lr * g / (|g| + eps), up to the new weight's rounding
        upd = 0.0
        for n, g in card["grad"].items():
            step = card["after"][n] - card["before"][n]
            want = -card["lr"] * g / (g.abs() + 1e-8)
            w32 = card["before"][n].float().abs().numpy()
            tol = (np.spacing(np.maximum(w32, np.abs(
                card["after"][n].float().numpy()))).astype(np.float64)
                + ADAPT_UPDATE_RTOL * card["lr"])
            excess = ((step - want).abs().numpy() / tol).max()
            upd = max(upd, float(excess))
        hold["update_err_over_tol"] = upd
        check(hold["loss_rel_err_vs_cpu"] <= ADAPT_CPU_RTOL,
              f"adapt {lt}: card loss off the CPU's by "
              f"{hold['loss_rel_err_vs_cpu']}")
        check(grad_cpu[worst] <= ADAPT_F64_RTOL,
              f"adapt {lt}: float64 card gradient of {worst} off the CPU's "
              f"by {grad_cpu[worst]} of its largest")
        check(step_cpu[worst_step] <= ADAPT_CPU_RTOL,
              f"adapt {lt}: float64 card update of {worst_step} off the "
              f"CPU's by {step_cpu[worst_step]} of its largest")
        check(upd <= 1.0, f"adapt {lt}: the update is off Adam's first step "
              f"from the card's gradient by {upd} x its tolerance")
        # "fused" (kernel B in the backward) against the plain dW from the
        # same forward
        kb = rel_by_leaf(fused["grad"], fused_plain["grad"])
        worst = max(kb, key=kb.get)
        hold["fused_grad_worst_vs_plain_dw"] = [worst, kb[worst]]
        check(fused["loss"] == fused_plain["loss"],
              f"adapt {lt}: the fused forward differs between two runs")
        check(kb[worst] <= CONV_STEP_RTOL,
              f"adapt {lt}: fused gradient of {worst} off the plain dW's by "
              f"{kb[worst]}")
        # "fused" against "xla": loss, denoised crops, gradients
        e = fused["deno"] - card["deno"]
        rms = float(e.pow(2).mean().sqrt())
        mse_x = float((card["deno"] - card["clean"]).pow(2).mean())
        r = ROUTES_DENO_RMS
        hold["fused_vs_xla_rel"] = (abs(fused["loss"] - card["loss"])
                                    / card["loss"])
        hold["fused_vs_xla_deno_rms"] = rms
        check(rms <= r, f"adapt {lt}: fused denoised crops off xla's by rms "
              f"{rms}")
        if lt == "sup":
            bound = 2 * np.sqrt(mse_x) * r + r * r
            hold["fused_vs_xla_db"] = 10 * np.log10(fused["loss"]
                                                    / card["loss"])
            hold["sup_mse_bound"] = bound
            hold["sup_clean_crops_mse"] = mse_x
            check(abs(mse_x - card["loss"]) <= 1e-5 * card["loss"],
                  f"adapt sup: the clean crops read back give MSE {mse_x}, "
                  f"the wrapper {card['loss']}")
            check(abs(fused["loss"] - card["loss"]) <= bound,
                  f"adapt sup: fused MSE {fused['loss']} off xla's "
                  f"{card['loss']} by more than {bound} "
                  f"({hold['fused_vs_xla_db']:.4f} dB)")
        else:
            check(hold["fused_vs_xla_rel"] <= ADAPT_ROUTE_RTOL,
                  f"adapt {lt}: fused first loss off xla's by "
                  f"{hold['fused_vs_xla_rel']}")
        # the bf16 graph's gradient, by parameter kind, no farther from
        # xla's than BF16_GRAPH_RATIO times the JAX package's own bf16
        # graph from its f32 graph on the same window
        dist = grad_distance(fused["grad"], card["grad"])
        hold["fused_vs_xla_grad"] = dist
        hold["jax_bf16_vs_f32_grad_rel"] = ADAPT_JAX_BF16_GRAD_REL[lt]
        print(f"adapt {lt} first window: " + json.dumps(hold), flush=True)
        for kind, d in dist.items():
            bound = BF16_GRAPH_RATIO * ADAPT_JAX_BF16_GRAD_REL[lt][kind]
            check(d["rel"] <= bound,
                  f"adapt {lt}: fused {kind} gradient {d['rel']} off xla's, "
                  f"more than {bound} ({BF16_GRAPH_RATIO} x the JAX "
                  "package's bf16 graph)")
        out[f"{lt}/first_window"] = hold
        del card, cpu, card64, cpu64, fused, fused_plain
    torch.cuda.empty_cache()

    # (b) the search of a stnls window (3 frames, 128x128) on the card
    # against the CPU, with its time and the refine's
    crop = torch.from_numpy(noisy[None, :3, 200:328, 300:428]).to(dev)
    flows = run_flows(crop, True, ftype="tvl1", device=dev)
    kw = dict(ws=ADAPT_CFG["ws"], wt=1, ps=ADAPT_CFG["ps"],
              k=ADAPT_CFG["k"], stride0=ADAPT_CFG["stride0"])
    d_card, i_card = nls.non_local_search(crop, flows, **kw)
    d_cpu, i_cpu = nls.non_local_search(
        crop.cpu(), {k: v.cpu() for k, v in flows.items()}, **kw)
    d_err = float((d_card.cpu() - d_cpu).abs().max())
    d_scale = float(d_cpu.abs().max())
    same = float((i_card.cpu() == i_cpu).all(-1).float().mean())
    search_ms = cuda_time_ms(lambda: nls.non_local_search(crop, flows, **kw),
                             iters=5)
    refine_ms = cuda_time_ms(lambda: nls.refine_search(
        crop, crop, i_card, wt=1, ps=ADAPT_CFG["ps"],
        stride0=ADAPT_CFG["stride0"]), iters=5)
    prof = profile_call(torch, lambda: nls.non_local_search(crop, flows,
                                                            **kw), iters=3)
    out["search_128"] = {
        "dists_rel_err_vs_cpu": d_err / d_scale, "inds_equal_share": same,
        "search_ms": search_ms, "refine_ms": refine_ms,
        "search_host_ms": prof["ms"], "search_device_ms": prof["device_ms"],
        "device_kernels": prof["device_kernels"],
        "top_kernels": prof["top_kernels"]}
    print("adapt search 128x128: " + json.dumps(out["search_128"]),
          flush=True)
    check(d_err <= SEARCH_CPU_RTOL * d_scale,
          f"non_local_search: card off the CPU by {d_err} of {d_scale}")
    check(same >= SEARCH_INDS_SHARE,
          f"non_local_search: only {same} of the inds equal the CPU's")

    # the flow launches of one solve at a window's shape (5 frames for f2f,
    # 3 for stnls): the wrappers solve once a window
    flow_launches = {}
    for nf in (5, 3):
        before = fs.launch_counts()["tvl1_inner_loop"]
        run_flows(torch.from_numpy(noisy[None, :nf, :128, :128]).to(dev),
                  True, ftype="tvl1", device=dev)
        torch.cuda.synchronize()
        flow_launches[nf] = fs.launch_counts()["tvl1_inner_loop"] - before
    check(min(flow_launches.values()) > 0, "run_flows launched no inner loop")

    def warm_up_and_hold(lt, st, sched):
        """One "fused" window with flow, its kernels' inputs read as the
        path hands them over (kernel B: each convolution's x and cotangent;
        the inner loop: every launch of the window's flow, all its pairs in
        one batch); then each kernel against its plain version on them."""
        seen = read_path_kernels(
            torch, lambda: port.get_loss_fxn(dict(ADAPT_CFG, adapt_nsteps=1),
                                             lt)(
                st, vid_n, vid_c, seed=ADAPT_SEED, sched=sched))
        seen_flow = seen["flow"]
        check(len(seen["b"]) == 17, f"adapt {lt}: {len(seen['b'])} dW calls "
              "in a window, expected 17")
        held = hold_path_kernels(torch, f"adapt {lt}", seen)
        print(f"adapt {lt} kernels on the path's inputs (kernel B within "
              f"{CONV_RTOL} of plain, the inner loop bit-equal): "
              + json.dumps(held), flush=True)
        check(lt == "sup" or len(seen_flow) == flow_launches[
            port.get_loss_fxn(dict(ADAPT_CFG), lt).nf],
              f"adapt {lt}: {len(seen_flow)} inner loops in a window's flow")
        return held

    # (c) the adaptation on "fused" at full width: windows, host, stream and
    # device ms a window, peak memory, launches, losses, PSNR of the
    # held-out frames
    launches = {k: 0 for k in fs.launch_counts()}
    for lt in ADAPT_LOSSES:
        wrapper = port.get_loss_fxn(dict(ADAPT_CFG), lt)
        nwin = wrapper.windows(ADAPT_T)
        st, sched = adapt_state("fused", nwin=nwin)  # warm-up, thrown away
        held = warm_up_and_hold(lt, st, sched)
        st, sched = adapt_state("fused", nwin=nwin)
        psnr_before = [psnr(held_c[k], st.eval_apply(held_n[k:k + 1])[0])
                       for k in range(ADAPT_HELD)]
        # each window ends in its update: mark the host clock and the
        # stream there (measurement only; the update runs as it is)
        marks, update = [], adapt_mod.apply_gradients

        def marked(*a, **kw):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((time.perf_counter(), ev))
            return update(*a, **kw)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        adapt_mod.apply_gradients = marked
        fs.reset_launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        try:
            st, info = wrapper(st, vid_n, vid_c, seed=ADAPT_SEED, sched=sched)
            torch.cuda.synchronize()
        finally:
            adapt_mod.apply_gradients = update
        counts = fs.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        spans = [(t0, start)] + marks
        host = [(b[0] - a[0]) * 1e3 for a, b in zip(spans, spans[1:])]
        stream = [a[1].elapsed_time(b[1]) for a, b in zip(spans, spans[1:])]
        for k, n in counts.items():
            launches[k] += n
        want = {"dw_conv3x3": 17 * nwin,
                "tvl1_inner_loop": 0 if lt == "sup"
                else flow_launches[wrapper.nf] * nwin}
        for k, n in counts.items():
            check(n == want.get(k, 0), f"adapt {lt}: {k} launched {n} "
                  f"times in {nwin} windows, expected {want.get(k, 0)}")
        psnr_after = [psnr(held_c[k], st.eval_apply(held_n[k:k + 1])[0])
                      for k in range(ADAPT_HELD)]
        check(len(info.loss) == nwin and np.isfinite(info.loss).all(),
              f"adapt {lt}: losses {info.loss}")
        check(np.isfinite(psnr_after).all(), f"adapt {lt}: PSNR {psnr_after}")
        # the same windows on the f32 graph ("xla"): the held-out PSNR after
        # adapting on "fused" within BF16_GRAPH_RATIO times the JAX
        # package's own gap between its bf16 and f32 graphs
        st_x, sched_x = adapt_state("xla", nwin=nwin)
        st_x, _ = wrapper(st_x, vid_n, vid_c, seed=ADAPT_SEED, sched=sched_x)
        psnr_xla = [psnr(held_c[k], st_x.eval_apply(held_n[k:k + 1])[0])
                    for k in range(ADAPT_HELD)]
        del st_x
        gap = abs(float(np.mean(psnr_after)) - float(np.mean(psnr_xla)))
        gap_bound = BF16_GRAPH_RATIO * ADAPT_JAX_FUSED_PSNR_GAP[lt]
        print(f"adapt {lt} held-out PSNR after adapting: fused {psnr_after}, "
              f"xla {psnr_xla}, gap {gap:.4f} dB (bound {gap_bound:.4f})",
              flush=True)
        check(gap <= gap_bound, f"adapt {lt}: held-out PSNR after adapting "
              f"on fused {gap} dB off xla's, more than {gap_bound}")
        one = dict(ADAPT_CFG, adapt_nsteps=1)
        prof = profile_call(torch, lambda: port.get_loss_fxn(one, lt)(
            st, vid_n, vid_c, seed=ADAPT_SEED, sched=sched), iters=3)
        out[lt] = {
            "windows": nwin, "host_ms_a_window": host,
            "median_host_ms": float(np.median(host)),
            # CUDA events recorded as the host reaches each update: the
            # stream's wall time, which the host paces here
            "stream_ms_a_window": stream,
            "median_stream_ms": float(np.median(stream)),
            # the profiler's device kernel time of one window
            "device_ms_a_window": prof["device_ms"],
            "profiled": {k: prof[k] for k in (
                "ms", "busy_share", "device_kernels", "top_kernels")},
            "peak_gb": peak_gb, "kernel_b_launches": counts["dw_conv3x3"],
            "tvl1_inner_launches": counts["tvl1_inner_loop"],
            "first_loss": info.loss[0], "last_loss": info.loss[-1],
            "lr": info.lr, "psnr_held_before": psnr_before,
            "psnr_held_after": psnr_after, "psnr_held_after_xla": psnr_xla,
            "fused_vs_xla_psnr_gap_db": gap,
            "jax_fused_vs_xla_psnr_gap_db": ADAPT_JAX_FUSED_PSNR_GAP[lt],
            "kernels_held": held}
        print(f"adapt {lt}: " + json.dumps(out[lt]), flush=True)
        del st
        torch.cuda.empty_cache()

    elapsed = time.perf_counter() - t_phase
    out["phase_s"] = elapsed
    print(f"phase time: adapt {elapsed:.1f} s", flush=True)
    return launches, out


def offline_step(torch, batch, conv_impl, device):
    """One ``TrainModule.training_step`` of ``OFFLINE_CFG`` on ``batch``
    (flows handed in) with the model on ``conv_impl`` and ``device``:
    (loss, weights after the update as float64 on the host)."""
    import frame2frame_tpu_torch as port
    from frame2frame_tpu_torch.train.lit import TrainModule
    from frame2frame_tpu_torch.train.schedules import make_optimizer
    from frame2frame_tpu_torch.train.state import TrainState

    cfg = dict(OFFLINE_CFG, conv_impl=conv_impl, read_flows=True)
    ms = port.load_model(cfg, device=device)
    module = TrainModule(cfg, ms.model)
    tx, _ = make_optimizer(module.cfg, steps_per_epoch=2)
    st = TrainState.create(ms.model, ms.variables, tx)
    st, m = module.training_step(st, batch, 0,
                                 torch.Generator(device).manual_seed(0))
    return m.train_loss, {n: p.detach().double().cpu()
                          for n, p in st.model.named_parameters()}


def offline_phase(torch, fs):
    """The offline trainer (``train/trainer.run``): the pretrained DnCNN-17
    on "fused" over two 5-frame 540p synthetic clips, two epochs of the
    warped loss on TV-L1 flows solved each step; one step on a 128x128
    crop on "xla" against the CPU and on "fused" against "xla"; kernel B
    and the flow's inner loop against their plain versions on the inputs
    one warm-up step hands them; launches a step, the checkpoint read back,
    the CSV's rows, host and device ms a step. Returns (launch counts of
    ``trainer.run``, timings and checks)."""
    import tempfile

    import frame2frame_tpu_torch as port
    from frame2frame_tpu_torch.data import sets
    from frame2frame_tpu_torch.flow.api import run_flows
    from frame2frame_tpu_torch.models.serialization import load_variables
    from frame2frame_tpu_torch.train import lit as lit_mod
    from frame2frame_tpu_torch.train import trainer
    from frame2frame_tpu_torch.train.schedules import make_optimizer
    from frame2frame_tpu_torch.train.state import TrainState

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    out = {}
    data, _ = sets.load(OFFLINE_CFG, device=dev)
    sample = data.tr[0]
    clip = {k: sample[k][None] for k in ("noisy", "clean")}

    # (a) one step on a 128x128 crop, flows handed in: "xla" on the card
    # against the CPU, "fused" against "xla"
    crop = {k: np.ascontiguousarray(v[(slice(None),) + OFFLINE_CROP])
            for k, v in clip.items()}
    flows = run_flows(torch.from_numpy(crop["noisy"]), True, device=dev)
    crop.update({k: v.cpu().numpy() for k, v in flows.items()})
    card = offline_step(torch, crop, "xla", dev)
    cpu = offline_step(torch, crop, "xla", torch.device("cpu"))
    fused = offline_step(torch, crop, "fused", dev)
    scale = max(float(w.abs().max()) for w in cpu[1].values())
    err = torch.cat([(card[1][n] - w).abs().flatten()
                     for n, w in cpu[1].items()])
    lr = OFFLINE_CFG["lr_init"]
    hold = {"loss_card": card[0], "loss_cpu": cpu[0], "loss_fused": fused[0],
            "loss_rel_err_vs_cpu": abs(card[0] - cpu[0]) / abs(cpu[0]),
            "fused_vs_xla_rel": abs(fused[0] - card[0]) / abs(card[0]),
            "weights_max_err_vs_cpu": float(err.max()),
            "largest_weight": scale,
            "weights_beyond_share": float(
                (err > OFFLINE_WEIGHT_RTOL * scale).double().mean())}
    out["step_128"] = hold
    print("offline one step 128x128: " + json.dumps(hold), flush=True)
    check(hold["loss_rel_err_vs_cpu"] <= ADAPT_CPU_RTOL,
          f"offline: card loss off the CPU's by {hold['loss_rel_err_vs_cpu']}")
    check(hold["weights_beyond_share"] <= OFFLINE_KINK_SHARE
          and hold["weights_max_err_vs_cpu"]
          <= OFFLINE_WEIGHT_RTOL * scale + 2 * lr,
          f"offline: updated weights off the CPU's: {hold}")
    check(hold["fused_vs_xla_rel"] <= ADAPT_ROUTE_RTOL,
          f"offline: fused loss off xla's by {hold['fused_vs_xla_rel']}")
    del card, cpu, fused

    # (b) one warm-up step at full width: kernel B and the inner loop
    # against their plain versions on the inputs the step hands them
    ms = port.load_model(OFFLINE_CFG)
    module = lit_mod.TrainModule(OFFLINE_CFG, ms.model)
    tx, _ = make_optimizer(module.cfg, steps_per_epoch=2)
    st = TrainState.create(ms.model, ms.variables, tx)
    gen = torch.Generator(dev).manual_seed(0)
    seen = read_path_kernels(
        torch, lambda: module.training_step(st, clip, 0, gen))
    check(len(seen["b"]) == 17, f"offline: {len(seen['b'])} dW calls in a "
          "step, expected 17")
    check(len(seen["flow"]) > 0, "offline: the step's flow launched no "
          "inner loop")
    held = hold_path_kernels(torch, "offline", seen, terms_scale=True)
    solve_launches = len(seen["flow"])
    del seen
    torch.cuda.empty_cache()
    print(f"offline kernels on the path's inputs (kernel B within "
          f"{CONV_RTOL} of plain, of the products' magnitudes, the inner "
          "loop bit-equal): "
          + json.dumps(held), flush=True)
    out["kernels_held"] = held

    # (c) trainer.run, counted; each step's host ms, ending in a
    # synchronize (measurement only; the step runs as it is)
    step_ms, step = [], lit_mod.TrainModule.training_step

    def timed(self, *a, **kw):
        t0 = time.perf_counter()
        res = step(self, *a, **kw)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return res

    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        lit_mod.TrainModule.training_step = timed
        fs.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            res = trainer.run(dict(OFFLINE_CFG, checkpoint_dir=tmp))
            torch.cuda.synchronize()
        finally:
            lit_mod.TrainModule.training_step = step
        run_s = time.perf_counter() - t0
        launches = dict(fs.launch_counts())
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        want = {"dw_conv3x3": 17 * OFFLINE_STEPS,
                "tvl1_inner_loop": solve_launches * OFFLINE_STEPS}
        for k, n in launches.items():
            check(n == want.get(k, 0), f"offline: {k} launched {n} times in "
                  f"{OFFLINE_STEPS} steps, expected {want.get(k, 0)}")
        _same_tree(load_variables(res.checkpoint, like=res.state.variables),
                   res.state.variables, what="offline final checkpoint")
        with open(Path(tmp) / "offline-metrics.csv") as f:
            rows = f.read().splitlines()
        files = sorted(p.name for p in Path(tmp).iterdir())
    check(len(rows) == 1 + OFFLINE_STEPS, f"offline: CSV rows {rows}")
    check(files == ["offline-epoch000.msgpack", "offline-epoch001.msgpack",
                    "offline-final.msgpack", "offline-metrics.csv"],
          f"offline: files written {files}")
    check(np.isfinite(res.val_psnr) and np.isfinite(res.train_loss),
          f"offline: val_psnr {res.val_psnr}, train_loss {res.train_loss}")
    check(res.state.step == OFFLINE_STEPS, f"offline: {res.state.step} steps")

    # device ms a step: the profiler over steps on the trained state
    prof = profile_call(torch, lambda: module.training_step(
        res.state, clip, 1, gen), iters=3)
    out["trainer"] = {
        "steps": OFFLINE_STEPS, "run_s": run_s, "host_ms_a_step": step_ms,
        "median_host_ms": float(np.median(step_ms)),
        "device_ms_a_step": prof["device_ms"],
        "profiled": {k: prof[k] for k in (
            "ms", "busy_share", "device_kernels", "top_kernels")},
        "peak_gb": peak_gb, "launches": {k: n for k, n in launches.items()
                                         if n},
        "tvl1_inner_launches_a_solve": solve_launches,
        "train_loss": res.train_loss, "val_psnr": res.val_psnr,
        "final": {k: v for k, v in res.final.items()
                  if k in ("train_loss", "val_psnr", "val_ssim", "lr")}}
    print("offline trainer.run: " + json.dumps(out["trainer"]), flush=True)
    del res, ms, module, st
    torch.cuda.empty_cache()
    elapsed = time.perf_counter() - t_phase
    out["phase_s"] = elapsed
    print(f"phase time: offline {elapsed:.1f} s", flush=True)
    return launches, out


def tree_flat(tree):
    """The leaves of a nested dict of arrays in sorted-key order, raveled
    into one float64 vector."""
    if isinstance(tree, dict):
        return np.concatenate([tree_flat(tree[k]) for k in sorted(tree)])
    return np.asarray(tree, np.float64).ravel()


def hold_update(tag, got, ref, lr, steps=1, rtol=0.0, atol=1e-5,
                share_min=SHARD_SHARE):
    """Two updated weight trees by the adaptation rule: at least
    ``share_min`` of the elements within ``atol + rtol |ref|``, every
    element within two learning rates a step. Returns (share, largest)."""
    g, r = tree_flat(got), tree_flat(ref)
    err = np.abs(g - r)
    share = float(np.mean(err <= atol + rtol * np.abs(r)))
    worst = float(err.max())
    check(np.isfinite(g).all() and share >= share_min
          and worst <= 2 * lr * steps,
          f"{tag}: {share} of the weights within bounds, largest off "
          f"{worst} (two learning rates a step: {2 * lr * steps})")
    return share, worst


def update_distance(got, ref, w0):
    """Two ``trainer.run`` results of one step from the weights ``w0``: the
    loss's relative distance, and the 2-norm of the difference of their
    updates over the 2-norm of ``ref``'s, for the parameters and for the
    running statistics."""
    def rel(key):
        u = tree_flat(got.state.variables[key]) - tree_flat(w0[key])
        v = tree_flat(ref.state.variables[key]) - tree_flat(w0[key])
        return float(np.linalg.norm(u - v) / np.linalg.norm(v))

    return {"loss_rel": abs(got["train_loss"] - ref["train_loss"])
            / abs(ref["train_loss"]),
            "params_rel": rel("params"), "stats_rel": rel("batch_stats")}


def shard_clip():
    """(noisy, clean, bflow) of ``SHARD_B`` rows of ``SHARD_T`` 540p frames
    (``moving_frames`` at two seeds), (B, T, H, W, C) numpy."""
    rows = [moving_frames(SHARD_T, seed=s) for s in (3, 7)][:SHARD_B]
    return (np.stack([r[1] for r in rows]), np.stack([r[0] for r in rows]),
            np.stack([r[2] for r in rows]))


def shard_phase(torch, fs, dev):
    """Multi-device training on one card (``parallel/mesh.py``,
    ``parallel/shard.py``, ``parallel/data.py``): every mesh is the card
    repeated, its shards run one after another. The pretrained DnCNN-17 on
    "fused" (the module route: the bf16 graph, kernel B for every dW):

    - the f2f step at 540p, B = 2, T = 4 (``moving_frames``, analytic
      flows) on meshes (1, 1), (2, 1), (1, 2), (2, 2) with
      ``train_bn=False``: the loss within ``SHARD_LOSS_RTOL`` of the
      unsharded (1, 1) step, the weights by the adaptation rule, 17 kernel
      B a shard a step, peak memory; ``train_bn=True`` on (2, 2) twice,
      the same bits;
    - the warped and stnls window steps on 128x128 crops, wt = 1, mesh
      (1, 2) against (1, 1);
    - the sup step on (2, 2);
    - ``trainer.run`` on ``exps/trte_dncnn/train.cfg``'s base (64x64
      clips) at ``batch_size=2`` on ``[cuda:0] * 2`` against one device, on
      "fused" and on "pallas", one SGD step: the loss, the update and the
      running statistics, one more shard's kernel A and B launches, the
      flows' inner loop as on one device; on "fused", the shards' own
      BatchNorm statistics and the whole batch's detached, planted, fail
      that hold;
    - kernel B on the (2, 2) f2f step's inputs, and kernels A, B and the
      inner loop on the "pallas" data-parallel step's, against their plain
      versions.

    ``dev`` is the card. The holds run first; the counts are set to 0
    before the counted runs and read after them. Returns (launch counts,
    timings and checks)."""
    import tempfile

    import frame2frame_tpu_torch as port
    from frame2frame_tpu_torch.losses.stnls import DnlsLoss
    from frame2frame_tpu_torch.losses.warped import WarpedLoss
    from frame2frame_tpu_torch.models.dncnn import (
        JaxRavel, from_jax_variables)
    from frame2frame_tpu_torch.models.serialization import load_variables
    from frame2frame_tpu_torch.parallel import mesh as pm
    from frame2frame_tpu_torch.parallel import shard as ps
    from frame2frame_tpu_torch.train import trainer
    from frame2frame_tpu_torch.train.online import torch_adam

    t_phase = time.perf_counter()
    card4 = [dev] * 4
    variables = load_variables(CKPT)
    model = from_jax_variables(variables, residual=True,
                               conv_impl="fused").to(dev)
    tx = torch_adam(SHARD_LR)
    opt0 = tx.init(JaxRavel(model).ravel())
    noisy, clean, bflow = (torch.from_numpy(a).to(dev) for a in shard_clip())
    out = {}

    def f2f(shape, train_bn=False):
        step = ps.make_sharded_f2f_step(
            model, pm.make_mesh(*shape, devices=card4), tx,
            train_bn=train_bn)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        b0 = fs.launch_counts()["dw_conv3x3"]
        t0 = time.perf_counter()
        p, bs, _, loss = step(variables["params"], variables["batch_stats"],
                              opt0, noisy, bflow)
        torch.cuda.synchronize()
        return {"params": p, "batch_stats": bs, "loss": float(loss),
                "ms": (time.perf_counter() - t0) * 1e3,
                "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
                "kernel_b": fs.launch_counts()["dw_conv3x3"] - b0}

    # (a) the holds, on inputs the path hands the kernels (not counted)
    seen = read_path_kernels(torch, lambda: f2f((2, 2)))
    check(len(seen["b"]) == 17 * 4, f"shard f2f (2, 2): {len(seen['b'])} "
          "dW calls, expected 68")
    out["kernels_held_f2f"] = hold_path_kernels(torch, "shard f2f", seen,
                                                terms_scale=True)
    del seen
    torch.cuda.empty_cache()

    def trainer_cfg(conv_impl, tmp, tag):
        spec = json.loads((REPO / "exps" / "trte_dncnn"
                           / "train.cfg").read_text())
        return dict(spec["base"], sigma=25, batch_size=2, seed=0,
                    conv_impl=conv_impl, checkpoint_dir=str(Path(tmp) / tag),
                    uuid=tag, nepochs=1, limit_train_batches=1,
                    optim_name="sgd", sgd_momentum=0.0, sgd_dampening=0.0)

    with tempfile.TemporaryDirectory() as tmp:
        # kernels A, B and the inner loop on one data-parallel step
        from frame2frame_tpu_torch.train import lit as lit_mod
        step = lit_mod.TrainModule.training_step
        calls = []

        def first_step(self, *a, **kw):
            if calls:
                return step(self, *a, **kw)
            calls.append(1)
            res = []
            seen = read_path_kernels(
                torch, lambda: res.append(step(self, *a, **kw)))
            calls.append(seen)
            return res[0]

        lit_mod.TrainModule.training_step = first_step
        try:
            trainer.run(trainer_cfg("pallas", tmp, "hold"),
                        devices=[dev] * 2)
        finally:
            lit_mod.TrainModule.training_step = step
        seen = calls[1]
        check(len(seen["a"]) > 0 and len(seen["b"]) > 0
              and len(seen["flow"]) > 0,
              f"shard trainer: kernels seen {[len(v) for v in seen.values()]}")
        out["kernels_held_trainer"] = hold_path_kernels(
            torch, "shard trainer", seen, terms_scale=True)
        del seen, calls
        torch.cuda.empty_cache()

        # (b) the counted runs
        fs.reset_launch_counts()
        t_counted = time.perf_counter()
        f2f_out = {}
        ref = f2f((1, 1))
        for shape in SHARD_MESHES:
            r = ref if shape == (1, 1) else f2f(shape)
            n = shape[0] * shape[1]
            check(r["kernel_b"] == 17 * n, f"shard f2f {shape}: kernel B "
                  f"launched {r['kernel_b']} times, expected {17 * n}")
            rel = abs(r["loss"] - ref["loss"]) / abs(ref["loss"])
            check(rel <= SHARD_LOSS_RTOL, f"shard f2f {shape}: loss "
                  f"{r['loss']} off the unsharded {ref['loss']} by {rel}")
            share, worst = hold_update(f"shard f2f {shape}", r["params"],
                                       ref["params"], SHARD_LR)
            f2f_out[str(shape)] = {
                "loss": r["loss"], "loss_rel": rel, "weights_share": share,
                "weights_max_err": worst, "ms": r["ms"],
                "peak_gb": r["peak_gb"], "kernel_b": r["kernel_b"]}
        bn = [f2f((2, 2), train_bn=True) for _ in range(2)]
        same = (bn[0]["loss"] == bn[1]["loss"]
                and np.array_equal(tree_flat(bn[0]["params"]),
                                   tree_flat(bn[1]["params"]))
                and np.array_equal(tree_flat(bn[0]["batch_stats"]),
                                   tree_flat(bn[1]["batch_stats"])))
        check(same, "shard f2f (2, 2) train_bn: two runs differ")
        check(not np.array_equal(tree_flat(bn[0]["batch_stats"]),
                                 tree_flat(variables["batch_stats"])),
              "shard f2f train_bn: the running statistics did not move")
        f2f_out["(2, 2) train_bn"] = {"loss": bn[0]["loss"],
                                      "ms": bn[0]["ms"], "same_bits": same}
        out["f2f"] = f2f_out
        print("shard f2f 540p B=2 T=4: " + json.dumps(f2f_out), flush=True)

        # (c) the window steps on 128x128 crops, (1, 2) against (1, 1)
        crop = (slice(0, 1), slice(None), SHARD_CROP[0], SHARD_CROP[1])
        vids = [noisy[crop], clean[crop], -bflow[crop], bflow[crop]]
        windows = {}
        for kind, loss in (
                ("warped", WarpedLoss(wt=1, dist_crit="l2")),
                ("stnls", DnlsLoss(ws=3, wt=1, ps=3, k=2, stride0=2,
                                   dist_crit="v0", dist_mask=10.0,
                                   search_input="deno", nepochs=10))):
            res = {}
            for shape in ((1, 1), (1, 2)):
                step = ps.make_sharded_window_step(
                    model, pm.make_mesh(*shape, devices=card4), tx, loss,
                    kind=kind, wt=1)
                t0 = time.perf_counter()
                p, _, _, lv = step(variables["params"],
                                   variables["batch_stats"], opt0, *vids)
                torch.cuda.synchronize()
                res[shape] = (p, float(lv), (time.perf_counter() - t0) * 1e3)
            rel = abs(res[(1, 2)][1] - res[(1, 1)][1]) / abs(res[(1, 1)][1])
            check(rel <= SHARD_LOSS_RTOL, f"shard {kind} window: loss off "
                  f"the unsharded by {rel}")
            share, worst = hold_update(f"shard {kind} window",
                                       res[(1, 2)][0], res[(1, 1)][0],
                                       SHARD_LR)
            windows[kind] = {"loss": res[(1, 2)][1], "loss_rel": rel,
                             "weights_share": share,
                             "weights_max_err": worst,
                             "ms": {str(k): v[2] for k, v in res.items()}}
        out["windows"] = windows
        print("shard window steps 128x128 (1, 2): " + json.dumps(windows),
              flush=True)

        # (d) the sup step on (2, 2)
        step = ps.make_sharded_sup_step(
            model, pm.make_mesh(2, 2, devices=card4), tx)
        t0 = time.perf_counter()
        p, bs, _, lv = step(variables["params"], variables["batch_stats"],
                            opt0, noisy, clean)
        torch.cuda.synchronize()
        sup = {"loss": float(lv), "ms": (time.perf_counter() - t0) * 1e3}
        check(np.isfinite(sup["loss"]) and np.isfinite(tree_flat(p)).all()
              and np.isfinite(tree_flat(bs)).all(),
              f"shard sup (2, 2): {sup}")
        out["sup"] = sup

        # (e) trainer.run on two shards of the card against one device, one
        # SGD step each: its update is the learning rate times the gradient
        # (Adam's first step would move nearly every weight by a whole
        # learning rate, its sign set by rounding where a gradient is near
        # 0). Two planted faults, the shards' own BatchNorm statistics and
        # the whole batch's detached from the graph, must fail the hold
        from frame2frame_tpu_torch.models import sync_bn
        whole = sync_bn.mean
        faults = {"local_bn": lambda x, dims: x.mean(dims),
                  "detached_bn": lambda x, dims: whole(x, dims).detach()}
        runs = {}
        for conv_impl in ("fused", "pallas"):
            w0 = port.load_model(trainer_cfg(conv_impl, tmp, "w0"),
                                 device=dev).variables
            res = {}
            tags = [("dp", [dev] * 2, None), ("one", [dev], None)]
            if conv_impl == "fused":
                tags += [(k, [dev] * 2, fn) for k, fn in faults.items()]
            for tag, devices, fault in tags:
                before = dict(fs.launch_counts())
                t0 = time.perf_counter()
                sync_bn.mean = fault or whole
                try:
                    r = trainer.run(trainer_cfg(conv_impl, tmp,
                                                f"{conv_impl}_{tag}"),
                                    devices=devices)
                finally:
                    sync_bn.mean = whole
                torch.cuda.synchronize()
                after = fs.launch_counts()
                res[tag] = (r, time.perf_counter() - t0,
                            {k: after[k] - before[k] for k in after})
            dp, one = res["dp"], res["one"]
            check(dp[0].state.data_parallel is not None
                  and one[0].state.data_parallel is None,
                  f"shard trainer {conv_impl}: the mesh did not engage")
            steps = dp[0].state.step
            check(steps == 1, f"shard trainer {conv_impl}: {steps} steps")
            extra = {k: dp[2][k] - one[2][k] for k in dp[2]}
            want = {"dw_conv3x3": 17,
                    "conv3x3_fwd": 33 if conv_impl == "pallas" else 0}
            for k, n in extra.items():
                check(n == want.get(k, 0), f"shard trainer {conv_impl}: "
                      f"{k} launched {n} more times on two shards, "
                      f"expected {want.get(k, 0)}")
            check(dp[2]["tvl1_inner_loop"] > 0,
                  f"shard trainer {conv_impl}: no flow solved")
            readings = {tag: update_distance(res[tag][0], one[0], w0)
                        for tag in res if tag != "one"}
            for tag, rd in readings.items():
                sound = tag == "dp"
                held = (rd["loss_rel"] <= SHARD_TRAINER_LOSS_RTOL
                        and rd["params_rel"] <= SHARD_TRAINER_UPDATE_RTOL
                        and rd["stats_rel"] <= SHARD_TRAINER_STATS_RTOL)
                check(held == sound, f"shard trainer {conv_impl} {tag}: "
                      f"{rd} {'outside' if sound else 'inside'} the hold "
                      f"(loss {SHARD_TRAINER_LOSS_RTOL}, update "
                      f"{SHARD_TRAINER_UPDATE_RTOL}, running statistics "
                      f"{SHARD_TRAINER_STATS_RTOL})")
            runs[conv_impl] = {
                "readings": readings,
                "s": {tag: v[1] for tag, v in res.items()},
                "launches_dp": {k: n for k, n in dp[2].items() if n}}
        out["trainer"] = runs
        print("shard trainer.run 64x64 B=2 on two shards, one SGD step: "
              + json.dumps(runs), flush=True)
        launches = dict(fs.launch_counts())
        out["counted_s"] = time.perf_counter() - t_counted
    elapsed = time.perf_counter() - t_phase
    out["phase_s"] = elapsed
    print(f"phase time: shard {elapsed:.1f} s", flush=True)
    check(elapsed <= SHARD_PHASE_S, f"shard phase took {elapsed:.1f} s "
          f"(limit {SHARD_PHASE_S})")
    del model, noisy, clean, bflow
    torch.cuda.empty_cache()
    return launches, out


def write_eval_clip(root):
    """The evaluation clip: ``EVAL_T`` 540p frames of the mixed synthetic
    texture moving ``EVAL_SHIFT`` a frame, as PGM files of
    ``root/evalset/vid00``."""
    from frame2frame_tpu_torch.data import synthetic_video
    from frame2frame_tpu_torch.io.image import write_pgm

    vid = synthetic_video(7, EVAL_T, H, W, shift=EVAL_SHIFT, texture="mixed")
    d = Path(root) / "evalset" / "vid00"
    d.mkdir(parents=True)
    for t, frame in enumerate(vid[..., 0]):
        write_pgm(d / f"{t:03d}.pgm", np.round(frame))
    return d


def interior_mask(size, overlap, r):
    """(H, W) bool: the pixels deeper than ``r`` inside every ``chunk``
    tile that holds them (a tile's sides on the frame's border count as
    deep)."""
    from frame2frame_tpu_torch.eval.chunks import _tile_starts

    def axis(n):
        cover, deep = np.zeros(n, int), np.zeros(n, int)
        length = min(size, n)
        for a in _tile_starts(n, length, max(int(size * (1 - overlap)), 1)):
            cover[a:a + length] += 1
            lo = a + (r if a > 0 else 0)
            hi = a + length - (r if a + length < n else 0)
            deep[lo:hi] += 1
        return cover, deep

    (ch, dh), (cw, dw) = axis(H), axis(W)
    return np.outer(ch, cw) == np.outer(dh, dw)


def eval_phase(torch, fs):
    """The evaluation pipeline (``eval/test.run``) on a 4-frame 540p PGM
    clip with the pretrained DnCNN-17 on "fused": the flows solved on the
    card into .flo sidecars, then read back; the plain run (the served clip
    bit-equal to ``load_model(cfg).apply``, a gain over noisy), the x8
    self-ensemble, chunked inference, internal adaptation and the B2U second
    pass, each with its launches. Returns (launch counts of the runs,
    timings and checks)."""
    import tempfile

    import frame2frame_tpu_torch as port
    from frame2frame_tpu_torch.data import datasets, sets
    from frame2frame_tpu_torch.eval import test as test_mod

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    out, served, flows_seen = {}, [], []
    psnrs, read_flows = test_mod.compute_psnrs, datasets.VideoDataset._flows

    def keep_served(clean, deno, div):
        if len(served) <= len(runs):  # a run's first call: its deno
            served.append(deno)
        return psnrs(clean, deno, div=div)

    def keep_flows(self, index, clean):
        flows_seen.append(read_flows(self, index, clean))
        return flows_seen[-1]

    # (name, config, launches) of each run; None: held below
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        vdir = write_eval_clip(tmp)
        base = dict(EVAL_CFG, data_root=tmp)
        cases = [
            ("solve_chunks", EVAL_CHUNK),
            ("plain", {}), ("aug_test", dict(aug_test=True)),
            ("adapt", dict(internal_adapt_nsteps=1, internal_adapt_nepochs=1)),
            ("b2u", dict(crit_name="b2u"))]
        test_mod.compute_psnrs = keep_served
        datasets.VideoDataset._flows = keep_flows
        fs.reset_launch_counts()
        try:
            for name, kw in cases:
                before = dict(fs.launch_counts())
                # the run's MemIt meters read the peak since this reset
                torch.cuda.reset_peak_memory_stats(dev)
                t0 = time.perf_counter()
                res = test_mod.run(dict(base, **kw))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                after = fs.launch_counts()
                runs.append((name, res, {k: after[k] - before[k]
                                         for k in after
                                         if after[k] > before[k]}, wall))
                if name == "solve_chunks":
                    sidecars = sorted(p.name for p in
                                      (vdir / ".flows").iterdir())
        finally:
            test_mod.compute_psnrs = psnrs
            datasets.VideoDataset._flows = read_flows
        launches = dict(fs.launch_counts())
        data, _ = sets.load(base, device=dev)
        noisy = torch.from_numpy(data.te[0].noisy).to(dev)
    by = {name: (res, n, wall) for name, res, n, wall in runs}

    def mean_psnr(name):
        return float(np.mean(by[name][0].psnrs[0]))

    summary = {name: {
        "psnr": mean_psnr(name),
        "psnr_pp": float(np.mean(res.psnrs_pp[0])),
        "noisy_psnr": float(np.mean(res.noisy_psnrs[0])),
        "ssim": float(np.mean(res.ssims[0])),
        "strred": float(np.mean(res.strred[0])),
        "launches": n, "wall_s": wall,
        "timers_s": {k: v[0] for k, v in res.items()
                     if k.startswith("timer_") and v},
        "deno_mem_res_gb": res.deno_mem_res[0][0]}
        for name, (res, n, wall) in by.items()}
    out["runs"] = summary
    print("eval runs: " + json.dumps(summary), flush=True)

    # the flows: solved once on the card into 8 sidecars, then read back
    # with no inner launch, bit for bit; their median against the shift
    check(sidecars == [f"{d}_{t:05d}.flo" for d in "bf"
                       for t in range(EVAL_T)],
          f"eval: sidecars written {sidecars}")
    check(by["solve_chunks"][1].get("tvl1_inner_loop", 0) > 0,
          "eval: the first run solved its flows with no inner launch")
    check(by["plain"][1].get("tvl1_inner_loop", 0) == 0,
          "eval: the second run launched the inner loop")
    ff0, bf0 = flows_seen[0]
    for ff, bf in flows_seen[1:]:
        check(np.array_equal(ff, ff0) and np.array_equal(bf, bf0),
              "eval: the flows read back differ from the solved ones")
    med = np.median(ff0[:-1].reshape(-1, 2), axis=0)
    out["flow_median"] = med.tolist()
    print(f"eval flows: {sidecars} solved, then read back; median forward "
          f"flow {med.tolist()} px", flush=True)
    check(np.abs(med - [-EVAL_SHIFT[1], -EVAL_SHIFT[0]]).max()
          <= EVAL_FLOW_TOL, f"eval: median forward flow {med.tolist()}, "
          f"the clip moves {EVAL_SHIFT} (dy, dx) a frame")

    # the plain run: the served clip bit-equal to load_model(cfg).apply on
    # the same noisy clip, one batch of 15 fwd_layer launches, a gain
    names = [name for name, _, _, _ in runs]
    deno = served[names.index("plain")]
    res = by["plain"][0]
    ms = port.load_model(base)
    ref = ms.apply(noisy / 255.0).clamp(0.0, 1.0) * 255.0
    check(np.array_equal(deno[0], ref.cpu().numpy()),
          "eval: the served clip differs from load_model(cfg).apply")
    check(by["plain"][1] == {"fwd_layer": NMID},
          f"eval plain: launches {by['plain'][1]}, expected {NMID} fwd_layer")
    gain = mean_psnr("plain") - summary["plain"]["noisy_psnr"]
    out["plain_gain_db"] = gain
    check(gain > MIN_GAIN_DB, f"eval plain: gain {gain} dB over noisy")
    check(res.timer_deno[0] > 0 and res.deno_mem_res[0][0] > 0,
          f"eval plain: timer_deno {res.timer_deno}, deno_mem_res "
          f"{res.deno_mem_res}")
    check(mean_psnr("aug_test") >= mean_psnr("plain") - EVAL_AUG_TOL,
          f"eval aug_test: PSNR {mean_psnr('aug_test')} against the plain "
          f"run's {mean_psnr('plain')}")
    inner = interior_mask(EVAL_CHUNK["spatial_chunk_size"],
                          EVAL_CHUNK["spatial_chunk_overlap"], EVAL_CHUNK_R)
    chunk_err = np.abs(served[names.index("solve_chunks")][0] - deno[0])
    out["chunks"] = {
        "psnr_minus_plain_db": mean_psnr("solve_chunks") - mean_psnr("plain"),
        "interior_share": float(inner.mean()),
        "interior_max_abs_err": float(chunk_err[:, inner].max()),
        "edge_max_abs_err": float(chunk_err[:, ~inner].max())}
    print("eval chunks against plain: " + json.dumps(out["chunks"]),
          flush=True)
    check(out["chunks"]["interior_max_abs_err"] <= EVAL_CHUNK_INTERIOR_ATOL,
          f"eval chunks: the tiles' interior off the plain run: "
          f"{out['chunks']}")
    check(by["adapt"][1].get("dw_conv3x3", 0) == 17,
          f"eval adapt: launches {by['adapt'][1]}, expected one window's 17 "
          "kernel B")
    check(by["adapt"][0].timer_adapt[0] > 0, "eval adapt: no adaptation time")
    check(np.isfinite(by["b2u"][0].psnrs_pp[0]).all()
          and by["b2u"][1].get("fwd_layer", 0) > 0,
          f"eval b2u: psnrs_pp {by['b2u'][0].psnrs_pp}, launches "
          f"{by['b2u'][1]}")
    for name in names:
        check(np.isfinite(by[name][0].psnrs[0]).all(),
              f"eval {name}: PSNR {by[name][0].psnrs}")
    del ms, ref
    torch.cuda.empty_cache()
    elapsed = time.perf_counter() - t_phase
    out["phase_s"] = elapsed
    print(f"phase time: eval {elapsed:.1f} s", flush=True)
    return launches, out


def launch_train_run(cfg, device=None):
    """The run function ``launcher_phase`` dispatches (``fn_spec`` names it
    ``<path>/chip_smoke.py::launch_train_run``): ``trainer.run`` in the
    worker, with the worker's pid, device, card and kernel launch counts
    added to its results, since the counters live in the worker."""
    import os

    import torch

    sys.path.insert(0, str(REPO))
    from frame2frame_tpu_torch.ops import fused_stack as fs
    from frame2frame_tpu_torch.train import trainer

    fs.reset_launch_counts()
    t0 = time.perf_counter()
    out = trainer.run(cfg, device=device)
    torch.cuda.synchronize()
    dev = torch.device(device or "cuda")
    out["worker"] = {"pid": os.getpid(), "device": str(dev),
                     "run_s": time.perf_counter() - t0,
                     "card": torch.cuda.get_device_name(dev),
                     "launches": fs.launch_counts()}
    return out


def launcher_script(rel):
    """A launcher under ``scripts/`` loaded as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "launcher_" + rel.replace("/", "_")[:-3], REPO / "scripts" / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def launcher_phase(torch, fs):
    """The experiment launchers (``scripts/torch_trte_*``) through the
    port's cache and dispatch backends, in a fresh working directory: the
    ``trte_dncnn`` train launcher on the grid of
    ``exps/trte_dncnn/train.cfg`` on "fused" (DnCNN-17, three sigmas, the
    config's 64x64 clips, TV-L1 flows on each step's pairs) through the
    process backend, one worker on cuda:0; each worker's record against an in-process run of its config;
    a second call on the same cache, which must skip every config; the
    ``trte_dncnn`` test launcher on "fused" in process; the ``trte_net``
    pair (FastDVDnet) in process. Returns (launch counts of the launchers:
    the workers' own counts, reported in their records, and the in-process
    launchers', timings and checks)."""
    import os
    import tempfile

    from frame2frame_tpu_torch import cache
    from frame2frame_tpu_torch.train import trainer

    t_phase = time.perf_counter()
    train_l = launcher_script("torch_trte_dncnn/train.py")
    test_l = launcher_script("torch_trte_dncnn/test.py")
    net_train = launcher_script("torch_trte_net/train.py")
    net_test = launcher_script("torch_trte_net/test.py")
    launches = {k: 0 for k in fs.launch_counts()}
    out, cwd = {}, os.getcwd()
    with tempfile.TemporaryDirectory() as td:
        td = Path(td)
        cfgs = {}
        for name in ("train", "test"):
            spec = json.loads((REPO / "exps" / "trte_dncnn"
                               / f"{name}.cfg").read_text())
            spec["base"]["conv_impl"] = "fused"
            cfgs[name] = td / f"dncnn_{name}.cfg"
            cfgs[name].write_text(json.dumps(spec))
        os.chdir(td)
        try:
            # (a) the train launcher through the process backend
            fs.reset_launch_counts()
            t0 = time.perf_counter()
            recs = train_l.main(enable_dispatch="process", device="cuda:0",
                                cfg_path=cfgs["train"],
                                run_fn=launch_train_run)
            train_s = time.perf_counter() - t0
            parent = fs.launch_counts()
            check(not any(parent.values()), "launcher: the dispatching "
                  f"process launched kernels itself: {parent}")
            pids = set()
            for rec in recs:
                res = rec["results"]
                check("error" not in res, f"launcher: config {rec['uuid']} "
                      f"failed in its worker: {res.get('error')}")
                w = res["worker"]
                check(w["pid"] != os.getpid() and w["pid"] not in pids
                      and w["device"] == "cuda:0"
                      and w["card"] == torch.cuda.get_device_name(0),
                      f"launcher: worker {w} of {rec['uuid']}")
                pids.add(w["pid"])
                check(np.isfinite(res["val_psnr"]), f"launcher: val_psnr "
                      f"{res['val_psnr']}")
                for k, n in w["launches"].items():
                    launches[k] += n
            steps = 2 * 2  # 2 videos x 2 epochs at batch size 1
            check(all(r["results"]["worker"]["launches"]["dw_conv3x3"]
                      == 17 * steps for r in recs),
                  "launcher: kernel B launches a worker "
                  f"{[r['results']['worker']['launches'] for r in recs]}")
            # (b) a second call on the same cache: every config skipped,
            # no worker, no launch
            fs.reset_launch_counts()
            t0 = time.perf_counter()
            again = train_l.main(enable_dispatch="process", device="cuda:0",
                                 cfg_path=cfgs["train"],
                                 run_fn=launch_train_run)
            rerun_s = time.perf_counter() - t0
            check(not any(fs.launch_counts().values())
                  and [r["results"]["worker"]["pid"] for r in again]
                  == [r["results"]["worker"]["pid"] for r in recs],
                  "launcher: the second call ran configs again")
            # (c) the test launcher in process ("fused": load_model's apply
            # on fwd_layer), its kernels read on the way
            fs.reset_launch_counts()
            t0 = time.perf_counter()
            te = {}
            seen = read_path_kernels(torch, lambda: te.setdefault(
                "recs", test_l.main(device="cuda", cfg_path=cfgs["test"])))
            test_s = time.perf_counter() - t0
            counts = fs.launch_counts()
            for k, n in counts.items():
                launches[k] += n
            check(counts["fwd_layer"] > 0 and counts["fwd_layer"] % 15 == 0
                  and not seen["b"],
                  f"launcher: the test launcher launched {counts}")
            psnr_te = []
            for rec in te["recs"]:
                check("error" not in rec["results"], "launcher: test config "
                      f"{rec['uuid']} failed: {rec['results'].get('error')}")
                psnr_te.append(float(np.mean(rec["results"]["psnrs"])))
            check(np.isfinite(psnr_te).all(), f"launcher: PSNR {psnr_te}")
            held = hold_path_kernels(torch, "launcher test", seen)
            del seen
            # (d) the FastDVDnet pair in process (no kernel of the port)
            fs.reset_launch_counts()
            t0 = time.perf_counter()
            net_tr = net_train.main(device="cuda")
            net_te = net_test.main(device="cuda")
            net_s = time.perf_counter() - t0
            counts = fs.launch_counts()
            for k, n in counts.items():
                launches[k] += n
            for rec in net_tr + net_te:
                check("error" not in rec["results"], "launcher: FastDVDnet "
                      f"config {rec['uuid']} failed: "
                      f"{rec['results'].get('error')}")
            net_psnr = [r["results"]["val_psnr"] for r in net_tr] + [
                float(np.mean(r["results"]["psnrs"])) for r in net_te]
            check(np.isfinite(net_psnr).all(), f"launcher: FastDVDnet "
                  f"val_psnr and test PSNR {net_psnr}")
            # (e) each worker's record against an in-process run of its
            # config, kernel B held on the inputs of the first
            exps, uuids = cache.train_stages.run(cfgs["train"])
            inproc, seen = [], None
            t0 = time.perf_counter()
            for k, (cfg, uuid) in enumerate(zip(exps, uuids)):
                cfg = dict(cfg, uuid=uuid,
                           checkpoint_dir=str(td / "inproc"))
                if k == 0:
                    res = {}
                    seen = read_path_kernels(torch, lambda: res.setdefault(
                        "r", trainer.run(cfg)))
                    res = res["r"]
                else:
                    res = trainer.run(cfg)
                inproc.append(float(res["val_psnr"]))
            inproc_s = time.perf_counter() - t0
            worker_psnr = [float(r["results"]["val_psnr"]) for r in recs]
            diff = max(abs(a - b) for a, b in zip(worker_psnr, inproc))
            check(diff <= LAUNCH_PSNR_DB, f"launcher: worker val_psnr "
                  f"{worker_psnr} off in-process {inproc} by {diff} dB")
            check(len(seen["b"]) == 17 * steps, f"launcher: {len(seen['b'])} "
                  "dW calls in a config's run")
            held.update(hold_path_kernels(torch, "launcher train", seen,
                                          terms_scale=True))
            del seen
        finally:
            os.chdir(cwd)
    torch.cuda.empty_cache()
    run_s = [r["results"]["worker"]["run_s"] for r in recs]
    out = {"train_configs": len(recs), "steps_a_config": steps,
           "train_process_s": train_s,
           "train_s_a_config": train_s / len(recs),
           "worker_run_s": run_s,
           # a worker's interpreter, imports, context and kernel libraries
           "worker_startup_s": (train_s - sum(run_s)) / len(recs),
           "in_process_s_a_config": inproc_s / len(recs),
           "rerun_s": rerun_s, "test_s": test_s, "fastdvdnet_pair_s": net_s,
           "worker_pids": sorted(pids), "val_psnr_workers": worker_psnr,
           "val_psnr_in_process": inproc, "val_psnr_max_diff_db": diff,
           "test_psnr": psnr_te, "fastdvdnet_psnr": net_psnr,
           "launches": {k: n for k, n in launches.items() if n},
           "kernels_held": held}
    elapsed = time.perf_counter() - t_phase
    out["phase_s"] = elapsed
    print("launcher: " + json.dumps(out), flush=True)
    print(f"phase time: launcher {elapsed:.1f} s", flush=True)
    return launches, out


def model_dtype_phase(torch, fs, psnr):
    """``load_model`` with ``model_dtype="bfloat16"`` on the "pallas" route
    (bf16 activations, f32 parameters; kernels A and B on f32 operands): the
    pretrained DnCNN-17 serves a 540p frame and takes one training forward
    and backward on a 128x128 crop, counted; kernels A and B held against
    their plain versions on the inputs that run gave them; the bf16 output
    on a crop against the CPU's at the bf16 graph's bound. Returns (launch
    counts, checks)."""
    import frame2frame_tpu_torch as port

    t_phase = time.perf_counter()
    cfg = dict(net_name="dncnn", channels=1, num_of_layers=17, residual=True,
               conv_impl="pallas", model_dtype="bfloat16",
               pretrained_load=True, pretrained_path=str(CKPT))
    clean, noisy, _ = moving_frames(1, seed=DTYPE_SEED)
    crop = noisy[:, 200:328, 300:428]
    card = port.load_model(cfg)
    check(card.model.dtype == torch.bfloat16 and all(
        p.dtype == torch.float32 for p in card.model.parameters()),
        "model_dtype: not bf16 activations on f32 parameters")
    got = {}

    def drive():
        got["served"] = card.apply(noisy)
        y, _ = card.apply(crop, train=True)
        (y.float() ** 2).mean().backward()

    fs.reset_launch_counts()
    seen = read_path_kernels(torch, drive)
    launches = fs.launch_counts()
    want = {"conv3x3_fwd": 17 + 17 + 16, "dw_conv3x3": 17}
    for k, n in launches.items():
        check(n == want.get(k, 0), f"model_dtype: {k} launched {n} times, "
              f"expected {want.get(k, 0)}")
    # the activations the card computed are bf16: every kernel-A input
    # but a forward's 1-channel input image (the 64-channel activations of
    # both forwards and the backward's dX operands) holds bf16 values,
    # which an f32 activation would not
    wide = [x for x, _ in seen["a"] if x.shape[-1] > 1]
    bf16_inputs = sum(bool((x == x.to(torch.bfloat16).float()).all())
                      for x in wide)
    check(len(wide) == 16 + 16 + 15 and bf16_inputs == len(wide),
          f"model_dtype: {bf16_inputs} of {len(wide)} wide kernel A inputs "
          "hold bf16 values")
    held = hold_path_kernels(torch, "model_dtype", seen, terms_scale=True)
    del seen, wide
    served = got["served"]
    check(served.dtype == torch.float32 and bool(
        torch.isfinite(served).all()), "model_dtype: served frame")
    gain = psnr(clean[0], served[0]) - psnr(clean[0], noisy[0])
    # the bf16 output on the crop: the card's distance from the CPU's f32
    # model at most BF16_GRAPH_RATIO times the CPU's bf16 model's, or one
    # bf16 ulp (tests/test_torch_bf16_graph.py)
    out_card = card.apply(crop).double().cpu()
    out_cpu = port.load_model(cfg, device="cpu").apply(crop).double()
    out_f32 = port.load_model(dict(cfg, model_dtype="float32"),
                              device="cpu").apply(crop).double()
    d_card = float((out_card - out_f32).abs().max())
    d_cpu = float((out_cpu - out_f32).abs().max())
    ulp = 2.0 ** (np.floor(np.log2(float(out_f32.abs().max()))) - 7)
    bound = max(BF16_GRAPH_RATIO * d_cpu, ulp)
    out = {"launches": {k: n for k, n in launches.items() if n},
           "served_gain_db": gain, "card_vs_cpu_f32": d_card,
           "cpu_bf16_vs_cpu_f32": d_cpu, "bound": bound,
           "card_vs_cpu_bf16": float((out_card - out_cpu).abs().max()),
           "mean_abs": {
               "card_vs_cpu_f32": float((out_card - out_f32).abs().mean()),
               "cpu_bf16_vs_cpu_f32": float((out_cpu - out_f32).abs()
                                            .mean()),
               "card_vs_cpu_bf16": float((out_card - out_cpu).abs().mean())},
           "bf16_kernel_a_inputs": bf16_inputs,
           "kernels_held": held}
    check(d_card <= bound, f"model_dtype: the card's bf16 output {d_card} "
          f"off the CPU's f32, more than {bound}")
    check(gain > MIN_GAIN_DB, f"model_dtype: gain {gain} dB")
    elapsed = time.perf_counter() - t_phase
    out["phase_s"] = elapsed
    print("model_dtype: " + json.dumps(out), flush=True)
    print(f"phase time: model_dtype {elapsed:.1f} s", flush=True)
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
        t0 = time.perf_counter()
        bwd_body = bwd_layer_phase(torch, fs, variables, model, cuda_time_ms)
        print(f"phase time: bwd_layer body {time.perf_counter() - t0:.1f} s",
              flush=True)
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
        torch.cuda.empty_cache()
        adapt_launches, adapt = adapt_phase(torch, fs, psnr)
        torch.cuda.empty_cache()
        offline_launches, offline = offline_phase(torch, fs)
        torch.cuda.empty_cache()
        shard_launches, shard = shard_phase(torch, fs,
                                            torch.device("cuda", 0))
        torch.cuda.empty_cache()
        eval_launches, evaluation = eval_phase(torch, fs)
        torch.cuda.empty_cache()
        launch_launches, launcher = launcher_phase(torch, fs)
        torch.cuda.empty_cache()
        dtype_launches, dtype_out = model_dtype_phase(torch, fs, psnr)
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
    # registry: load_model's apply of a "fused" DnCNN; adapt: the
    # get_loss_fxn wrappers on a "fused" DnCNN; offline: trainer.run on a
    # "fused" DnCNN; shard: the sharded steps and the data-parallel
    # trainer on "fused" and "pallas"; eval: eval.test.run's runs; launch:
    # the launchers,
    # the dispatched workers' own counts included; model_dtype: load_model
    # with model_dtype="bfloat16" on "pallas"), and on no other path
    ends = ("flat", "flow", "stream")
    fused = ("training",) + ends + ("spatial",)
    conv_paths = tuple(f"conv_{impl}" for impl in CONV_ROUTES)
    paths = {"fwd_layer": ("serving",) + fused + ("registry", "eval",
                                                 "launch"),
             "fwd_layer_eval": ("serving", "spatial"),
             "fwd_layer_train": fused, "bwd_layer": fused,
             "first_conv": ends, "last_loss_fwd": ends,
             "last_loss_bwd": ends, "first_dw": ends,
             "tvl1_inner_loop": ("flow", "stream", "adapt", "offline",
                                 "shard", "eval", "launch"),
             "conv3x3_fwd": ("conv_pallas", "stream_pallas", "shard",
                             "model_dtype"),
             "dw_conv3x3": conv_paths + ("stream_pallas", "adapt", "offline",
                                         "shard", "eval", "launch",
                                         "model_dtype")}
    by_path = {"serving": serve_launches, "training": train_launches,
               "flat": flat_launches, "flow": flow_launches,
               "stream": stream_launches["stream"],
               "stream_pallas": stream_launches["stream_pallas"],
               "spatial": spatial_launches, "registry": registry_launches,
               "adapt": adapt_launches, "offline": offline_launches,
               "shard": shard_launches,
               "eval": eval_launches, "launch": launch_launches,
               "model_dtype": dtype_launches,
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
                      "spatial": spatial, "registry": registry,
                      "adapt": adapt, "offline": offline, "shard": shard,
                      "eval": evaluation, "launcher": launcher,
                      "model_dtype": dtype_out, "bwd_body": bwd_body}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
