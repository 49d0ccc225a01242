"""Space-time non-local patch search as a dense cost volume.

Counterpart of ``frame2frame_tpu/ops/nls.py``, the equivalent of the
reference's external ``stnls`` CUDA kernels (lib/frame2frame/stnls_loss.py:
274-298, warped_loss.py:228-236). The JAX package computes it with XLA, and
no TPU kernel lies on it, so the port writes it in plain tensor ops on the
videos' device: for every integer offset o of the ws x ws window, warp the
target frame by (flow + o) with bilinear sampling, square the difference
against the source frame, and sum over ps x ps patches; the top-k runs over
the offset axis.

Semantics (those of the JAX package):
- patch distances take the flow per pixel inside the patch (a warped SSD);
- samples outside the frame reflect at the border, by index
  (``_reflect_idx``), also where a pad is wider than the frame, which
  ``F.pad(mode="reflect")`` refuses and ``jnp.pad`` reflects again;
- ``inds`` are float offset triples (dt, dx, dy) a query.

Layout: videos (B, T, H, W, C), flows (..., H, W, 2) with (u, v) = (dx, dy).

Deviations from the JAX code, same values:
- the top-k is a stable sort over the ws*ws offsets (``torch.sort(stable=
  True)``), which is what ``lax.top_k``'s streaming merge gives: on a tie
  the earlier offset of ``_search_offsets`` wins;
- the offsets run in chunks that bound the warped stack (``_CHUNK``
  elements), where JAX scans them one at a time; only each offset's strided
  (nH, nW) volume is kept;
- the (t, slot, k) entries of ``refine_search``, ``non_local_stack`` and
  ``unfold_k`` run as chunked batches instead of a ``lax.map``.
"""

from __future__ import annotations

import numpy as np
import torch

# elements of the largest warped stack a chunk makes (64 MiB of f32)
_CHUNK = 1 << 24


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def scale_grad(x, scale):
    """Identity forward; multiplies the cotangent by ``scale`` on backward
    (the stnls kernels' ``normalize_bwd``, stnls_loss.py:279,287)."""
    return _ScaleGrad.apply(x, scale)


def _reflect_idx(i, n):
    """Reflect integer index tensor ``i`` into [0, n) (mirror without
    repeating the edge)."""
    i = i.abs()
    period = 2 * n - 2 if n > 1 else 1
    i = i % period
    return torch.where(i >= n, period - i, i)


def _sample(frames, fidx, sx, sy):
    """Bilinear samples of ``frames`` (F, H, W, C) with reflecting bounds:
    frame ``fidx`` (an int or an int tensor broadcastable to ``sx``) at
    float coordinates (sx, sy). Returns sx.shape + (C,)."""
    _, H, W, C = frames.shape
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    wx = (sx - x0)[..., None]
    wy = (sy - y0)[..., None]
    x0 = x0.long()
    y0 = y0.long()
    flat = frames.reshape(-1, C)
    base = fidx * (H * W)

    def at(ix, iy):
        return flat[base + _reflect_idx(iy, H) * W + _reflect_idx(ix, W)]

    v00 = at(x0, y0)
    v01 = at(x0 + 1, y0)
    v10 = at(x0, y0 + 1)
    v11 = at(x0 + 1, y0 + 1)
    return (v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy)
            + v10 * (1 - wx) * wy + v11 * wx * wy)


def bilinear_sample_reflect(img, sx, sy):
    """Bilinear sample of img (H, W, C) at float coords (sx, sy) of any
    shape, reflecting at the border; returns sx.shape + (C,)."""
    return _sample(img[None], 0, sx, sy)


def _grid(H, W, like):
    xx = torch.arange(W, dtype=like.dtype, device=like.device)[None, :]
    yy = torch.arange(H, dtype=like.dtype, device=like.device)[:, None]
    return xx, yy


def flow_warp_reflect(img, flow):
    """Warp img (..., H, W, C) by flow (..., H, W, 2) (the same leading
    dims): out[y, x] = img(x + u, y + v)."""
    *lead, H, W, C = img.shape
    frames = img.reshape(-1, H, W, C)
    fidx = torch.arange(frames.shape[0], device=img.device).view(
        *lead, 1, 1) if lead else 0
    xx, yy = _grid(H, W, flow)
    return _sample(frames, fidx, xx + flow[..., 0], yy + flow[..., 1])


def box_filter_sum(x, ps):
    """Sum over centred ps x ps windows with reflect padding; x (..., H, W).
    The pad reflects by index, so a window wider than the frame reflects
    again as ``jnp.pad`` does."""
    if ps <= 1:
        return x
    H, W = x.shape[-2], x.shape[-1]
    r = ps // 2
    ih = _reflect_idx(torch.arange(-r, H + ps - 1 - r, device=x.device), H)
    iw = _reflect_idx(torch.arange(-r, W + ps - 1 - r, device=x.device), W)
    xp = x.index_select(-2, ih).index_select(-1, iw)
    rows = sum(xp[..., i:i + H, :] for i in range(ps))
    return sum(rows[..., j:j + W] for j in range(ps))


def time_window_frames(ti, wt, T):
    """Non-ref frames of ti's clamped temporal window (size <= 2*wt), matching
    stnls get_time_window_inds minus the reference frame."""
    lo = max(0, min(ti - wt, T - (2 * wt + 1)))
    hi = min(T, lo + 2 * wt + 1)
    return [t for t in range(lo, hi) if t != ti]


def _warp_frames(frames_bt, tsel, flow):
    """Warp frame ``tsel`` of each batch entry by ``flow``.

    frames_bt: (B, T, H, W, C); tsel: int tensor (Q,) of frame indices;
    flow: (B, Q, ..., H, W, 2). Returns (B, Q, ..., H, W, C)."""
    B, T, H, W, C = frames_bt.shape
    extra = flow.ndim - 5  # dims between Q and H
    fidx = (torch.arange(B, device=flow.device).view(B, 1) * T
            + tsel.view(1, -1)).view(B, -1, *([1] * (extra + 2)))
    xx, yy = _grid(H, W, flow)
    return _sample(frames_bt.reshape(B * T, H, W, C), fidx,
                   xx + flow[..., 0], yy + flow[..., 1])


def compose_flow_pyramids(fflow, bflow, depth):
    """Cumulative composed flows: returns (comp_f, comp_b), each
    (depth, B, T, H, W, 2), where comp_f[d-1, :, t] maps frame t to frame
    t + d (and comp_b to t - d). Multi-step flows chain by warping the next
    hop's flow by the accumulated flow (stnls.nn.search_flow equivalent).
    Entries whose target would leave [0, T) compose with edge-clamped hops
    and are never consumed by a valid window slot."""
    T = fflow.shape[1]

    def build(flows, sign):
        accs = [flows]
        for d in range(1, depth):
            idx = (torch.arange(T, device=flows.device) + sign * d).clamp(
                0, T - 1)
            accs.append(accs[-1] + _warp_frames(flows, idx, accs[-1]))
        return torch.stack(accs, 0)

    return build(fflow, +1), build(bflow, -1)


def _window_tables(T, wt):
    """Per-(t, slot) tables as numpy arrays: target frame (int64) and
    validity (padded slots of short sequences are invalid and get +inf
    distances)."""
    S = 2 * wt
    tj = np.zeros((T, S), np.int64)
    valid = np.zeros((T, S), np.bool_)
    for t in range(T):
        frames = time_window_frames(t, wt, T)
        for m in range(S):
            if m < len(frames):
                tj[t, m], valid[t, m] = frames[m], True
            else:
                tj[t, m] = t
    return tj, valid


def _tables(T, wt, tables):
    """(tj, valid) as numpy arrays: the default layout or ``tables``."""
    if tables is None:
        return _window_tables(T, wt)
    tj, valid = tables
    return (np.asarray(torch.as_tensor(tj).cpu(), np.int64),
            np.asarray(torch.as_tensor(valid).cpu(), np.bool_))


def search_flow_compose(fflow, bflow, wt, tables=None):
    """Composed flows from every frame to every frame of its +/-wt window.

    fflow/bflow: (B, T, H, W, 2); fflow[t] maps t -> t+1, bflow[t] maps
    t -> t-1. Returns (B, T, 2*wt, H, W, 2) where slot m is the flow from t
    to ``time_window_frames(t, wt, T)[m]``. ``tables``: optional (tj, valid)
    arrays of shape (T, 2*wt) overriding the default window layout.

    Clamped windows at sequence ends reach targets up to 2*wt away, so the
    pyramids go to depth 2*wt."""
    T = fflow.shape[1]
    tj, valid = _tables(T, wt, tables)
    comp_f, comp_b = compose_flow_pyramids(fflow, bflow, 2 * wt)
    # [backward 2wt..1, zero, forward 1..2wt]: slot dt in [-2wt, 2wt]
    # selects pyramid level |dt| of the right direction
    stackfb = torch.cat([comp_b.flip(0), torch.zeros_like(comp_f[:1]),
                         comp_f], 0)
    dev = fflow.device
    sel = torch.as_tensor(np.clip(tj - np.arange(T)[:, None] + 2 * wt, 0,
                                  4 * wt), device=dev)
    tt = torch.arange(T, device=dev)[:, None]
    out = stackfb[sel, :, tt].permute(2, 0, 1, 3, 4, 5)  # (B, T, S, H, W, 2)
    mask = torch.as_tensor(valid, dtype=out.dtype, device=dev)
    return out * mask[None, :, :, None, None, None]


def _search_offsets(ws, dtype=torch.float32, device=None):
    """(ws*ws, 2) float (dx, dy) window offsets, row-major over dy then dx."""
    r = ws // 2
    a = torch.arange(-r, r + 1, device=device)
    dys, dxs = torch.meshgrid(a, a, indexing="ij")
    return torch.stack([dxs, dys], -1).reshape(ws * ws, 2).to(dtype)


def non_local_search(vid, flows, ws, wt, ps, k, stride0=1, srch_vid=None,
                     tables=None):
    """Top-k non-local search of ``vid`` against itself (or ``srch_vid``)
    guided by flows.

    vid: (B, T, H, W, C); flows: a Config/dict with fflow/bflow, or a
    precomposed (B, T, 2*wt, H, W, 2) tensor. Returns (dists, inds):
      dists: (B, T, nH, nW, 2*wt, k)
      inds:  (B, T, nH, nW, 2*wt, k, 3) -- float (dt, dx, dy) offsets
    Top-k is per window frame (stnls topk_mode="each"); the reference frame
    is excluded. On a tie the earlier offset of ``_search_offsets`` wins.
    Not differentiable (the callers search on detached videos)."""
    if srch_vid is None:
        srch_vid = vid
    B, T, H, W, C = vid.shape
    comp = (search_flow_compose(flows["fflow"], flows["bflow"], wt,
                                tables=tables)
            if isinstance(flows, dict) else flows)
    S = 2 * wt
    tj_tab, valid_tab = _tables(T, wt, tables)
    dev, dt_ = vid.device, vid.dtype
    offs = _search_offsets(ws, dt_, dev)
    # k leading entries at +inf with offset 0: the initial carry of the
    # JAX package's streaming top-k, which wins ties against later +inf
    offs_all = torch.cat([offs.new_zeros(k, 2), offs])
    n_off = offs.shape[0]
    chunk = max(1, _CHUNK // (B * H * W * max(C, 2)))
    xx, yy = _grid(H, W, vid)
    frames = srch_vid.reshape(B * T, H, W, C)
    dists, inds = [], []
    with torch.no_grad():
        for t in range(T):
            v0 = vid[:, t, None]  # (B, 1, H, W, C)
            for m in range(S):
                tj = int(tj_tab[t, m])
                fl = comp[:, t, m]  # (B, H, W, 2)
                fidx = (torch.arange(B, device=dev) * T + tj).view(B, 1, 1, 1)
                vols = [torch.full((B, k, -(-H // stride0), -(-W // stride0)),
                                   float("inf"), dtype=dt_, device=dev)]
                for o0 in range(0, n_off, chunk):
                    o = offs[o0:o0 + chunk]
                    sx = xx + (fl[:, None, ..., 0] + o[None, :, 0, None, None])
                    sy = yy + (fl[:, None, ..., 1] + o[None, :, 1, None, None])
                    w = _sample(frames, fidx, sx, sy)  # (B, n, H, W, C)
                    vol = box_filter_sum(((v0 - w) ** 2).sum(-1), ps)
                    vols.append(vol[..., ::stride0, ::stride0])
                vol = torch.cat(vols, 1)  # (B, k + ws*ws, nH, nW)
                d, idx = torch.sort(vol, dim=1, stable=True)
                d, idx = d[:, :k], idx[:, :k]
                if not valid_tab[t, m]:
                    d = torch.full_like(d, float("inf"))
                o_sel = offs_all[idx].permute(0, 2, 3, 1, 4)  # (B,nH,nW,k,2)
                base = fl[:, ::stride0, ::stride0, None, :]
                dt = torch.full(o_sel.shape[:-1] + (1,), float(tj - t),
                                dtype=dt_, device=dev)
                dists.append(d.permute(0, 2, 3, 1))
                inds.append(torch.cat([dt, base + o_sel], -1))
    nH, nW = dists[0].shape[1:3]
    dists = torch.stack(dists, 1).view(B, T, S, nH, nW, k).permute(
        0, 1, 3, 4, 2, 5)
    inds = torch.stack(inds, 1).view(B, T, S, nH, nW, k, 3).permute(
        0, 1, 3, 4, 2, 5, 6)
    return dists, inds


def _upsample_inds(field, H, W, stride0):
    """Nearest-neighbour upsample a (..., nH, nW, c) per-query field to
    (..., H, W, c)."""
    if stride0 > 1:
        field = field.repeat_interleave(stride0, -3).repeat_interleave(
            stride0, -2)
    return field[..., :H, :W, :]


def _flat_tmk(inds, wt, T, tables=None):
    """Flatten (t, slot, k) into one axis: returns (t_arr, tj_arr, ind_flat)
    with int64 tensors (N,) and ind_flat (B, N, nH, nW, 3), N = T*S*K."""
    B, _, nH, nW, S, K, _ = inds.shape
    tj_tab = _tables(T, wt, tables)[0]
    dev = inds.device
    t_arr = torch.arange(T, device=dev).repeat_interleave(S * K)
    tj_arr = torch.as_tensor(tj_tab.reshape(T * S), device=dev)
    tj_arr = tj_arr.repeat_interleave(K)
    ind_flat = inds.permute(0, 1, 4, 5, 2, 3, 6).reshape(B, T * S * K, nH,
                                                         nW, 3)
    return t_arr, tj_arr, ind_flat


def _entry_chunks(n, per_entry):
    """Slices of [0, n) whose warped stacks stay within ``_CHUNK``."""
    step = max(1, _CHUNK // max(per_entry, 1))
    return [slice(i, min(i + step, n)) for i in range(0, n, step)]


def refine_search(vid0, vid1, inds, wt, ps, stride0=1, tables=None):
    """Re-evaluate patch distances at given inds between vid0 and vid1
    (RefineSearch with wr=1, k=-1: no re-search, keep all offsets).

    vid0/vid1: (B, T, H, W, C); inds: (B, T, nH, nW, S, k, 3) from
    non_local_search. Returns dists (B, T, nH, nW, S, k), differentiable in
    both videos."""
    B, T, H, W, C = vid0.shape
    _, _, nH, nW, S, K, _ = inds.shape
    t_arr, tj_arr, ind_flat = _flat_tmk(inds, wt, T, tables)
    out = []
    for sl in _entry_chunks(T * S * K, B * H * W * max(C, 2)):
        flow = _upsample_inds(ind_flat[:, sl, ..., 1:3], H, W, stride0)
        w = _warp_frames(vid1, tj_arr[sl], flow)  # (B, n, H, W, C)
        d2 = ((vid0[:, t_arr[sl]] - w) ** 2).sum(-1)
        out.append(box_filter_sum(d2, ps)[..., ::stride0, ::stride0])
    D = torch.cat(out, 1).view(B, T, S, K, nH, nW)
    return D.permute(0, 1, 4, 5, 2, 3)


def paired_refine(src, tgt, flow, ps, stride0=1):
    """Patch distance between two frames at given flow offsets
    (stnls.search.PairedRefine with wr=1, warped_loss.py:228-236).

    src/tgt: (..., H, W, C); flow: (..., H, W, 2) or (..., nH, nW, 2) at the
    stride0 grid. Returns dists (..., nH, nW)."""
    H, W = src.shape[-3], src.shape[-2]
    if flow.shape[-3] != H:
        flow = _upsample_inds(flow, H, W, stride0)
    w = flow_warp_reflect(tgt, flow)
    d2 = ((src - w) ** 2).sum(-1)
    return box_filter_sum(d2, ps)[..., ::stride0, ::stride0]


def non_local_stack(vid, inds, wt, stride0=1, tables=None):
    """Stack aligned frames at the search offsets (stnls.agg.NonLocalStack,
    stnls_loss.py:79,390).

    vid: (B, T, H, W, C); inds: (B, T, nH, nW, S, k, 3).
    Returns (B, S*k, T, H, W, C): entry (m, kk) is frame tj(m) of the window
    warped onto frame t by the (kk)-th offset field."""
    B, T, H, W, C = vid.shape
    S, K = inds.shape[4], inds.shape[5]
    _, tj_arr, ind_flat = _flat_tmk(inds, wt, T, tables)
    out = []
    for sl in _entry_chunks(T * S * K, B * H * W * max(C, 2)):
        flow = _upsample_inds(ind_flat[:, sl, ..., 1:3], H, W, stride0)
        out.append(_warp_frames(vid, tj_arr[sl], flow))
    Wrp = torch.cat(out, 1).view(B, T, S, K, H, W, C)
    return Wrp.permute(0, 2, 3, 1, 4, 5, 6).reshape(B, S * K, T, H, W, C)


def refine_flow_search(src, tgt, flow, ws, ps, stride0=1):
    """Single-pair refinement (WarpedLoss.update_stnls_flow,
    warped_loss.py:250-269): search the ws x ws window around ``flow``
    between src and tgt; return the best distance and the refined flow per
    pixel.

    src/tgt: (..., H, W, C); flow: (..., H, W, 2). Returns (dists (..., H, W,
    1), refined flow (..., H, W, 2)). On a tie the earlier offset wins, as
    the JAX package's strict ``<`` keeps it. ``stride0`` is unused there as
    here: the distances are per pixel. Not differentiable."""
    offs = _search_offsets(ws, flow.dtype, flow.device)
    with torch.no_grad():
        d_best = torch.full(src.shape[:-1], float("inf"), dtype=src.dtype,
                            device=src.device)
        o_best = torch.zeros_like(flow)
        for o in offs:
            w = flow_warp_reflect(tgt, flow + o)
            d = box_filter_sum(((src - w) ** 2).sum(-1), ps)
            better = d < d_best
            d_best = torch.where(better, d, d_best)
            o_best = torch.where(better[..., None], o, o_best)
    return d_best[..., None], flow + o_best


def fold_patches(patches, shape, stride0=1):
    """Scatter-add ps x ps patches back to a video with a weight (count) map
    (the stnls ``iFoldz`` equivalent, stnls_loss.py:629): returns (vid,
    wvid) so callers divide for the overlap-normalised reconstruction.

    patches: (B, T, nH, nW, ps, ps, C), centres on the stride0 query grid;
    shape: the target (B, T, H, W, C). Contributions beyond the padded
    frame are dropped."""
    B, T, H, W, C = shape
    _, _, nH, nW, ps, _, _ = patches.shape
    r = ps // 2
    Hp, Wp = H + 2 * r, W + 2 * r
    vid = patches.new_zeros((B, T, Hp, Wp, C))
    wvid = patches.new_zeros((B, T, Hp, Wp, 1))
    for dy in range(ps):
        ny = min(nH, -(-(Hp - dy) // stride0))
        for dx in range(ps):
            nx = min(nW, -(-(Wp - dx) // stride0))
            ys = slice(dy, dy + (ny - 1) * stride0 + 1, stride0)
            xs = slice(dx, dx + (nx - 1) * stride0 + 1, stride0)
            vid[:, :, ys, xs] += patches[:, :, :ny, :nx, dy, dx]
            wvid[:, :, ys, xs] += 1
    return vid[:, :, r:r + H, r:r + W], wvid[:, :, r:r + H, r:r + W]


def unfold_k(vid, inds, ps, wt, stride0=1, tables=None):
    """Extract ps x ps patches at the search offsets (stnls.UnfoldK,
    stnls_loss.py:496): returns (B, T, nH, nW, S, k, ps, ps, C) patches of
    ``vid`` at the matched positions (reflect bounds)."""
    B, T, H, W, C = vid.shape
    _, _, nH, nW, S, K, _ = inds.shape
    r = ps // 2
    _, tj_arr, ind_flat = _flat_tmk(inds, wt, T, tables)
    a = torch.arange(-r, r + 1, dtype=vid.dtype, device=vid.device)
    dys, dxs = torch.meshgrid(a, a, indexing="ij")
    qx = (torch.arange(nW, device=vid.device) * stride0).to(vid.dtype)
    qy = (torch.arange(nH, device=vid.device) * stride0).to(vid.dtype)
    frames = vid.reshape(B * T, H, W, C)
    out = []
    for sl in _entry_chunks(T * S * K, B * nH * nW * ps * ps * max(C, 2)):
        ind = ind_flat[:, sl]  # (B, n, nH, nW, 3)
        sx = qx[:, None, None] + ind[..., 1, None, None] + dxs
        sy = qy[:, None, None, None] + ind[..., 2, None, None] + dys
        fidx = (torch.arange(B, device=vid.device).view(B, 1) * T
                + tj_arr[sl].view(1, -1)).view(B, -1, 1, 1, 1, 1)
        out.append(_sample(frames, fidx, sx, sy))
    P = torch.cat(out, 1).view(B, T, S, K, nH, nW, ps, ps, C)
    return P.permute(0, 1, 4, 5, 2, 3, 6, 7, 8)
