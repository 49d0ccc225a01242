"""Batch serving through the program's config-driven entry point,
``load_model(cfg).apply``, in a closed loop: a call's frames leave host
memory, the output comes back to the host, then the next call is sent.

A call is ``batch`` frames (B, H, W, C) for an image model, or a clip of
``clip`` frames (1, T, H, W, C) for a video model, which denoises each
frame with its clamped window. Calls cycle through a pool of ``pool_calls``
distinct inputs made from the seed (the moving scene of ``scene.py`` with
Gaussian noise of ``sigma``). Outputs are read back into host buffers that
set-up allocates and touches once, as a client with its own frame buffers
does: one for every call, and one of its own for each sampled call, which
the plain reference recomputes (``sample_calls`` calls drawn from the seed
among the window's first ``sample_within``).

The configuration's ``family`` picks how the model is built and what the
reference is: ``dncnn`` (the configuration's weights file, read by the
benchmark's own reader for the reference) or ``fastdvdnet`` (weights made
on the card from the seed and handed to both sides).
"""

from __future__ import annotations

import gc
import time
from types import SimpleNamespace

import numpy as np
import torch

from .. import flops, scene
from ..harness import ROOT
from ..reference import dncnn as ref_dncnn
from ..reference import fastdvdnet as ref_fastdvdnet
from ..reference import msgpack


def _program_cfg(config):
    cfg = {"net_name": config["net_name"], "channels": config["channels"]}
    if config["family"] == "dncnn":
        cfg.update(num_of_layers=config["num_of_layers"],
                   residual=config["residual"],
                   conv_impl=config["conv_impl"], pretrained_load=True,
                   pretrained_path=str(ROOT / config["weights"]))
    return cfg


def setup(config, params, seed, devices, spans):
    from frame2frame_tpu_torch import load_model

    dev = devices[0]
    parts = {}
    t = time.perf_counter()
    H, W, C = params["height"], params["width"], config["channels"]
    per_call = params.get("batch", params.get("clip"))
    n = params["pool_calls"] * per_call
    _, noisy = scene.moving(n, H, W, seed, dev, channels=C,
                            sigma=params["sigma"])
    shape = ((params["pool_calls"], per_call, H, W, C) if "batch" in params
             else (params["pool_calls"], 1, per_call, H, W, C))
    pool = list(noisy.reshape(shape).cpu().numpy())
    del noisy
    parts["frames"] = time.perf_counter() - t
    t = time.perf_counter()
    loaded = load_model(_program_cfg(config), device=dev)
    weights = None
    if config["family"] == "fastdvdnet":
        weights = ref_fastdvdnet.init(seed, dev, C)
        res = loaded.model.net.load_state_dict(weights, strict=False)
        left = [k for k in res.missing_keys if "num_batches" not in k]
        if left or res.unexpected_keys:
            raise RuntimeError(f"weights do not fit the model: {left} "
                               f"{res.unexpected_keys}")
    kw = ({"sigma": params["sigma"]} if config["family"] == "fastdvdnet"
          else {})
    parts["model"] = time.perf_counter() - t
    rng = np.random.default_rng(seed)
    st = SimpleNamespace(config=config, params=params, dev=dev, pool=pool,
                         apply=loaded.apply, model=loaded.model, kw=kw,
                         spans=spans, setup_parts=parts, weights=weights,
                         kept={}, sample=set(rng.choice(
                             params["sample_within"], params["sample_calls"],
                             replace=False).tolist()))
    st.bufs = {}
    for i in range(params["warmup_calls"]):
        t = time.perf_counter()
        out = call(st, i)
        if i == 0:
            st.bufs = {j: np.ones_like(out) for j in
                       [None, *sorted(st.sample)]}
        parts[f"call {i}"] = time.perf_counter() - t
    return st


def call(st, i):
    """Call ``i`` through the program: its output in a host buffer (a
    fresh array until set-up has made the buffers). The ``apply`` span ends
    once the card has finished the call's work, so ``readback`` holds the
    copy alone."""
    x = st.pool[i % len(st.pool)]
    with st.spans("apply"):
        y = st.apply(x, **st.kw)
        if st.dev.type == "cuda":
            torch.cuda.current_stream(st.dev).synchronize()
    with st.spans("readback"):
        buf = st.bufs.get(i if i in st.sample else None)
        if buf is None:
            return y.cpu().numpy()
        torch.from_numpy(buf).copy_(y)
        return buf


def window(st, seconds, slice_):
    recs = []
    t0 = time.perf_counter()
    end = t0 + seconds
    i = 0
    while True:
        now = time.perf_counter()
        if now >= end:
            break
        slice_.before(now - t0)
        traced = slice_.active
        out = call(st, i)
        if i in st.sample:
            st.kept[i] = out
        recs.append({"t0": now, "t1": time.perf_counter(),
                     "items": int(np.prod(out.shape[:-3])),
                     "traced": traced})
        slice_.after()
        i += 1
    return recs


def counters(st):
    p, c = st.params, st.config
    if c["family"] == "fastdvdnet":
        per_call = flops.fastdvdnet_video(p["height"], p["width"], p["clip"],
                                          c["channels"])
    else:
        per_call = flops.dncnn_forward(p["height"], p["width"],
                                       c["channels"], c["features"],
                                       c["num_of_layers"] - 2, p["batch"])
    return {"flops_per_call": per_call}


def reference_outputs(st, mode="f32"):
    """{call: the reference's output} of the sampled calls, on the host."""
    out = {}
    if st.config["family"] == "dncnn":
        state = ref_dncnn.state_from_tree(
            msgpack.read(ROOT / st.config["weights"]), st.dev)
    for i in sorted(st.sample):
        x = torch.from_numpy(st.pool[i % len(st.pool)]).to(st.dev)
        if st.config["family"] == "dncnn":
            y = ref_dncnn.denoise(state, x, mode)
        else:
            y = ref_fastdvdnet.video(st.weights, x, st.params["sigma"], mode)
        out[i] = y.cpu()
    return out


def compare(st, got, ref):
    """The worst frame's distance from the reference against the noise the
    reference removes."""
    worst = 0.0
    for i, r in ref.items():
        if i not in got:
            return {"deno_rel": float("inf")}
        g = torch.as_tensor(got[i])
        x = torch.from_numpy(st.pool[i % len(st.pool)])
        g, r, x = (a.reshape(-1, *a.shape[-3:]).double() for a in (g, r, x))
        for a, b, c in zip(g, r, x):
            worst = max(worst, float((a - b).norm() / (c - b).norm()))
    return {"deno_rel": worst}


def judge(st, control=False):
    """Free the program, then the sampled calls against the reference; with
    ``control``, also the control (the reference one precision below the
    configuration's) against it."""
    st.apply = st.model = None
    gc.collect()
    if st.dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_outputs(st)
    numbers = compare(st, st.kept, ref)
    if not control:
        return numbers
    ctl = reference_outputs(st, st.config["control"])
    return numbers, compare(st, {i: v.numpy() for i, v in ctl.items()}, ref)
