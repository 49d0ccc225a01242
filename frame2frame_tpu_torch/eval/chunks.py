"""Overlap-tiled chunked inference — counterpart of
``frame2frame_tpu/eval/chunks.py``, the replacement for the external
``dev_basics.net_chunks`` (reference test.py:19,172-175; chunk config keys
``spatial_chunk_size`` / ``spatial_chunk_overlap`` / ``temporal_chunk_size``,
instances_adapt.py:503-504).

Spatial tiles overlap by ``overlap`` fraction and temporal chunks by
``temporal_chunk_overlap`` frames; all tiles are blended back with uniform
averaging over the overlapped regions, summed in place into tensors on the
video's device and in its dtype.
"""

from __future__ import annotations

import inspect

import torch

from ..config import Config, extract_pairs, optional


def chunk_pairs():
    return {"spatial_chunk_size": 0, "spatial_chunk_overlap": 0.0,
            "temporal_chunk_size": 0, "temporal_chunk_overlap": 0}


def extract_chunks_config(cfg):
    return extract_pairs(cfg, chunk_pairs())


def fwd_form(fwd_fxn):
    """``fwd_fxn`` as ``call(vid, flows)``: ``fwd_fxn(vid, flows)`` where its
    signature takes two positional arguments, else ``fwd_fxn(vid)``. The
    JAX package tries the first form and falls back on a ``TypeError``,
    which also catches one raised inside the call; here the form is read
    once from the signature, and an error inside the call reaches the
    caller."""
    try:
        inspect.signature(fwd_fxn).bind(None, None)
    except TypeError:
        return lambda vid, flows: fwd_fxn(vid)
    except ValueError:  # no signature to read (a builtin): two arguments
        pass
    return fwd_fxn


def _tile_starts(total, size, stride):
    if size >= total:
        return [0]
    starts = list(range(0, total - size + 1, max(stride, 1)))
    if starts[-1] != total - size:
        starts.append(total - size)
    return starts


def chunk(chunk_cfg, fwd_fxn):
    """Wrap ``fwd_fxn(vid, flows=None) -> deno`` with spatial/temporal
    tiling.

    vid: (B, T, H, W, C) tensor (or numpy array). Tiles run through fwd_fxn
    and blend by averaging overlaps, mirroring net_chunks semantics.
    """
    ssize = optional(chunk_cfg, "spatial_chunk_size", 0) or 0
    soverlap = optional(chunk_cfg, "spatial_chunk_overlap", 0.0) or 0.0
    tsize = optional(chunk_cfg, "temporal_chunk_size", 0) or 0
    toverlap = int(optional(chunk_cfg, "temporal_chunk_overlap", 0) or 0)

    if not ssize and not tsize:
        return fwd_fxn
    call = fwd_form(fwd_fxn)

    def tiled(vid, flows=None):
        vid = torch.as_tensor(vid)
        B, T, H, W, C = vid.shape
        t_len = min(tsize, T) if tsize else T
        t_stride = max(t_len - toverlap, 1)
        t_chunks = _tile_starts(T, t_len, t_stride) if tsize else [0]

        out_sum = torch.zeros_like(vid)
        out_cnt = torch.zeros((1, T, H, W, 1), dtype=vid.dtype,
                              device=vid.device)

        s_len = ssize if ssize else max(H, W)
        stride = max(int(s_len * (1 - soverlap)), 1)
        h_starts = _tile_starts(H, min(s_len, H), stride) if ssize else [0]
        w_starts = _tile_starts(W, min(s_len, W), stride) if ssize else [0]
        h_len = min(s_len, H) if ssize else H
        w_len = min(s_len, W) if ssize else W

        for t0 in t_chunks:
            tsl = slice(t0, t0 + t_len)
            for h0 in h_starts:
                for w0 in w_starts:
                    idx = (slice(None), tsl, slice(h0, h0 + h_len),
                           slice(w0, w0 + w_len), slice(None))
                    fl = None
                    if flows is not None:
                        fl = Config({k: flows[k][idx]
                                     for k in ("fflow", "bflow") if k in flows})
                    out_sum[idx] += call(vid[idx], fl)
                    out_cnt[idx] += 1.0
        return out_sum / out_cnt.clamp_min(1.0)

    return tiled
