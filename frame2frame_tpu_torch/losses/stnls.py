"""Non-local self-supervised loss (the reference's ``DnlsLoss``,
lib/frame2frame/stnls_loss.py:180-488) on the dense cost-volume search of
``ops/nls.py``.

Counterpart of ``frame2frame_tpu/losses/stnls.py``. Criteria (stnls_loss.py:
319-424):
- ``v0``: non-local search on the search video -> mask dists below
  ``dist_mask`` -> refine (deno vs noisy) at the found inds -> mean of the
  masked refined distances;
- ``v0_sr``: integer-rounded composed flows and inds, a charbonnier mean of
  the per-pixel refine;
- ``ssims``/``v1``: non-local stack of noisy + per-k (MSE - SSIM) against the
  denoised video;
- ``global_smoothing``: spatially averaged search inds, border-cropped
  masked refine distances.

Schedules: ``get_ps`` geometric decay, ``get_k`` linear decay, ``get_ws``
linear grid, ``ps_dists`` epoch switch; search video noisy / deno / clean /
interp / noisy-g-<sigma>. Gradients stop (``.detach()``) where the JAX code
has ``lax.stop_gradient``. ``noisy-g-<sigma>`` draws its noise from a
``torch.Generator`` (``key``), where JAX takes a PRNG key: the same
distribution, other values.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import nls
from ..ops.ssim import ssim as ssim_fn


class DnlsLoss:
    def __init__(self, ws=9, wt=3, ps=7, ps_dists=-1, k=5, stride0=4,
                 dist_crit="v0", search_input="deno", alpha=0.5, nepochs=-1,
                 k_decay=1.0, ps_dist_sched=None, ws_sched=None,
                 epoch_ratio=1.0, dist_mask=-1, center_crop=0.0, sigma=30.0,
                 nmz_bwd=False, ps_scale=0.99993, ps_final=1):
        self.ws = ws
        self.wt = wt
        self.ps = ps
        self.ps_dists = ps_dists
        self.dist_mask = float(dist_mask)
        self.k = k
        self.k0 = k
        self.stride0 = stride0
        self.nepochs = nepochs
        self.k_decay = k_decay
        self.search_input = search_input
        self.alpha = alpha
        self.alpha_scale = 0.9999
        self.dist_crit = dist_crit
        self.ps_dist_sched = ps_dist_sched
        self.ws_sched = ws_sched
        self.ps_scale = ps_scale
        self.ps_final = ps_final
        self.center_crop = center_crop
        self.curr_k = k
        self.epoch_ratio = epoch_ratio
        self.sigma = sigma
        self.nmz_bwd = nmz_bwd
        self.name = "stnls"
        self._setup_ws_sched()

    # -- schedules (stnls_loss.py:218-263) --

    def _setup_ws_sched(self):
        self.ws_grid = []
        if self.ws_sched and self.ws_sched != "None":
            kind, tgt = self.ws_sched.split("_")
            if kind == "lin":
                ws_tgt = int(tgt)
                m = (ws_tgt - self.ws + 1) / self.nepochs
                self.ws_grid = [int(self.ws + x * m)
                                for x in np.arange(self.nepochs)]

    def get_k(self, curr_epoch):
        k = self.k
        if self.k_decay > 0:
            k = int(k * ((self.nepochs - curr_epoch) / self.nepochs)
                    * self.k_decay)
            k = max(k, 2)
        self.curr_k = k
        return k

    def get_ps(self, step):
        alpha = self.ps_scale**step
        ps = alpha * self.ps + (1 - alpha) * self.ps_final
        ps = int(round(ps))
        ps = max(ps, self.ps_final)
        if ps % 2 == 0:
            ps += 1
        return ps

    def get_ws(self, curr_epoch):
        if self.ws_grid:
            return self.ws_grid[min(curr_epoch, len(self.ws_grid) - 1)]
        return self.ws

    def get_ps_dists(self, curr_epoch):
        ps_dists = self.ps_dists
        if self.ps_dist_sched and self.ps_dist_sched != "None":
            switch, val = self.ps_dist_sched.split("_")
            if curr_epoch >= int(switch):
                ps_dists = int(val)
        return ps_dists

    # -- search video (stnls_loss.py:300-317) --

    def get_search_video(self, noisy, deno, clean, step, key=None):
        """``key``: a ``torch.Generator`` on the videos' device for
        ``noisy-g-<sigma>`` (None: one seeded with 0)."""
        si = self.search_input
        if si == "noisy":
            return noisy
        if si.startswith("noisy-g"):
            sigma = int(si.split("-")[-1])
            if key is None:
                key = torch.Generator(clean.device).manual_seed(0)
            noise = torch.randn(clean.shape, generator=key,
                                dtype=clean.dtype, device=clean.device)
            return clean + noise * (sigma / 255.0)
        if si == "deno":
            return deno
        if si == "interp":
            alpha = self.alpha * self.alpha_scale**step
            return alpha * noisy + (1 - alpha) * deno
        if si == "clean":
            return clean
        raise ValueError(f"Unknown search video [{si}]")

    # -- criteria --

    def __call__(self, noisy, clean, deno, flows, curr_epoch, key=None,
                 tables=None, frame_weight=None):
        return self.compute_loss(noisy, clean, deno, flows, curr_epoch, key,
                                 tables=tables, frame_weight=frame_weight)

    @staticmethod
    def _reduce(terms, frame_weight, count_scale=1.0):
        """mean(terms) when unweighted; with ``frame_weight`` (T,), the
        (weighted sum, weighted element count) pair whose cross-shard ratio
        equals the global mean."""
        if frame_weight is None:
            return terms.mean() / count_scale
        fw = torch.as_tensor(frame_weight, dtype=terms.dtype,
                             device=terms.device)
        w = fw.reshape((1, -1) + (1,) * (terms.ndim - 2))
        per_frame = terms.numel() / terms.shape[1]
        return (terms * w).sum(), fw.sum() * per_frame * count_scale

    def compute_loss(self, noisy, clean, deno, flows, curr_epoch, key=None,
                     tables=None, frame_weight=None):
        F = deno.shape[-1]
        wt, stride0 = self.wt, self.stride0
        ws = self.get_ws(curr_epoch)
        ps = self.get_ps(curr_epoch)
        ps_d = self.get_ps_dists(curr_epoch)
        ps_d = ps_d if ps_d and ps_d > 0 else self.ps
        srch = self.get_search_video(noisy, deno, clean, curr_epoch, key)

        def nmz(v, ps_eff):
            """normalize_bwd (stnls_loss.py:279,287): scale the refine's
            gradient in the video by the patch element count. The search
            runs on detached videos, so only the refine needs it."""
            if not self.nmz_bwd or ps_eff <= 1:
                return v
            return nls.scale_grad(v, 1.0 / float(ps_eff * ps_eff))

        if self.dist_crit == "v0":
            assert self.dist_mask > 0.0
            dists0, inds = nls.non_local_search(
                srch.detach(), flows, ws=ws, wt=wt, ps=ps, k=self.k,
                stride0=stride0, tables=tables)
            dists0 = dists0.detach() / (ps**2 * F)
            mask = (dists0 < self.dist_mask).to(deno.dtype)
            dists = nls.refine_search(nmz(deno, ps_d), nmz(noisy, ps_d),
                                      inds.detach(), wt=wt, ps=ps_d,
                                      stride0=stride0, tables=tables)
            return self._reduce(mask * dists, frame_weight)

        if self.dist_crit == "v0_sr":
            assert self.dist_mask > 0.0
            comp = nls.search_flow_compose(flows["fflow"], flows["bflow"], wt,
                                           tables=tables)
            comp = torch.round(comp)
            dists0, inds = nls.non_local_search(
                srch.detach(), comp, ws=ws, wt=wt, ps=ps, k=self.k,
                stride0=stride0, tables=tables)
            inds = torch.round(inds.detach())
            dists = nls.refine_search(deno, noisy, inds, wt=wt, ps=1,
                                      stride0=stride0, tables=tables)
            return self._reduce(torch.sqrt(dists + 1e-6), frame_weight)

        if self.dist_crit in ("ssims", "v1"):
            assert stride0 == 1, "ssims criterion requires stride0==1"
            dists0, inds = nls.non_local_search(
                srch.detach(), flows, ws=ws, wt=wt, ps=ps, k=1, stride0=1,
                tables=tables)
            stack = nls.non_local_stack(noisy, inds.detach(), wt,
                                        tables=tables)
            K = stack.shape[1]
            B, T = deno.shape[0], deno.shape[1]
            shape = (B * T,) + tuple(deno.shape[2:])
            deno_f = deno.reshape(shape)
            if frame_weight is None:
                loss = 0.0
                for ki in range(K):
                    st = stack[:, ki].reshape(shape)
                    loss = loss + ((deno_f - st) ** 2).mean()
                    loss = loss - ssim_fn(deno_f, st, window_size=11)
                return loss
            # weighted: per-image terms so only a shard's own frames count
            fw = torch.as_tensor(frame_weight, dtype=deno.dtype,
                                 device=deno.device)
            wsum = 0.0
            wbt = fw.repeat(B)  # (B*T,)
            for ki in range(K):
                st = stack[:, ki].reshape(shape)
                mse_img = ((deno_f - st) ** 2).mean(dim=(1, 2, 3))
                ssim_img = ssim_fn(deno_f, st, window_size=11, reduce="image")
                wsum = wsum + (wbt * (mse_img - ssim_img)).sum()
            return wsum, B * fw.sum()

        if self.dist_crit == "global_smoothing":
            dists0, inds = nls.non_local_search(
                srch.detach(), flows, ws=ws, wt=wt, ps=ps, k=self.k,
                stride0=stride0, tables=tables)
            inds = self.global_smoothing(inds.detach())
            d_self = nls.refine_search(deno.detach(), deno.detach(), inds,
                                       wt=wt, ps=ps_d, stride0=stride0,
                                       tables=tables)
            weight = (d_self / (ps**2 * F) < self.dist_mask).to(deno.dtype)
            dists = nls.refine_search(nmz(deno, ps_d), nmz(noisy, ps_d), inds,
                                      wt=wt, ps=ps_d, stride0=stride0,
                                      tables=tables)
            dists = dists[:, :, 5:-5, 5:-5]
            weight = weight[:, :, 5:-5, 5:-5]
            return self._reduce(weight * dists, frame_weight, count_scale=F)

        raise ValueError(f"Unknown criterion [{self.dist_crit}]")

    def global_smoothing(self, inds):
        """Replace the spatial flow field by its central mean
        (stnls_loss.py:426-451): offsets in the center crop become constant."""
        flow = inds[..., 1:].clone()
        nH, nW = flow.shape[2], flow.shape[3]
        center = flow[:, :, 5:nH - 5, 5:nW - 5]
        center[...] = center.mean(dim=(2, 3), keepdim=True)
        return torch.cat([inds[..., :1], flow], -1)
