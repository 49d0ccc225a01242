"""Harness warped (frame2frame) loss over temporal windows.

Counterpart of ``frame2frame_tpu/losses/warped.py``, which re-implements the
reference ``WarpedLoss`` + ``run_pairs`` (lib/frame2frame/warped_loss.py:
117-317): for each frame t and each neighbour frame in the +/-wt temporal
window, warp the noisy neighbour onto the denoised frame via (optionally
refined) flow, mask occlusions, and accumulate a charbonnier-L1 or L2
distance, averaged over all pairs. The pairs run as a loop over the
(frame, window slot) table and the batch; each pair's loss is the port's
``ops/warp.warped_dist_loss``, and the optional non-local refinement of the
flow is ``ops/nls.refine_flow_search`` on the detached denoised frames.
"""

from __future__ import annotations

import torch

from ..ops.nls import (_window_tables, paired_refine, refine_flow_search,
                       search_flow_compose)
from ..ops.warp import warped_dist_loss


class WarpedLoss:
    """Config mirror of warped_loss.py:117-131."""

    def __init__(self, dist_crit="l2", use_stnls=False, loss_type="warp",
                 ws=9, ps=7, dist_mask=2e-1, ps_scale=1.0, ps_final=1,
                 wt=1, stride0=1):
        self.dist_crit = dist_crit
        self.use_stnls = use_stnls
        self.loss_type = loss_type
        self.ws = ws
        self.ps = ps
        self.ps_scale = ps_scale
        self.ps_final = ps_final
        self.dist_mask = dist_mask
        self.wt = wt
        self.stride0 = stride0

    def get_ps(self, step):
        """Geometric patch-size decay ps -> ps_final (warped_loss.py:133-143)."""
        alpha = self.ps_scale**step
        ps = alpha * self.ps + (1 - alpha) * self.ps_final
        ps = int(round(ps))
        if ps % 2 == 0:
            ps += 1
        return max(ps, self.ps_final)

    def pair_loss(self, deno_t, noisy_j, flow, step, in_mask=None):
        """Single (deno frame, noisy neighbour, flow t->j) loss on (H, W, C)
        frames (warped_loss.py:213-237)."""
        if self.loss_type == "warp":
            return warped_dist_loss(deno_t, noisy_j, flow,
                                    dist_crit=self.dist_crit, in_mask=in_mask)
        # "stnls" path: patch-refine distance at the given flow offsets
        dists = paired_refine(deno_t, noisy_j, flow, ps=self.get_ps(step))
        if in_mask is None:
            return dists.mean()
        return (in_mask * dists).mean()

    def refine_flow(self, src, tgt, flow):
        """Optional non-local refinement of the flow between two frames
        (warped_loss.py:250-269), on detached frames (..., H, W, C).
        Returns (dists, refined_flow)."""
        if not self.use_stnls:
            return torch.zeros_like(flow[..., :1]), flow
        F = src.shape[-1]
        dists, inds = refine_flow_search(src.detach(), tgt.detach(), flow,
                                         ws=self.ws, ps=self.ps,
                                         stride0=self.stride0)
        return dists / (self.ps**2 * F), inds

    def run_pairs(self, deno, noisy, flows, step=0, tables=None,
                  frame_weight=None):
        """Accumulate the loss over all frame pairs in the +/-wt window
        (warped_loss.py:271-317).

        deno/noisy: (B, T, H, W, C); flows: Config(fflow, bflow) of
        (B, T, H, W, 2). Returns the scalar loss (mean over pairs).

        ``tables``: optional (tj, valid) (T, 2*wt) window override;
        ``frame_weight`` (T,): return (weighted sum of pair means, weighted
        pair count) instead, so shards contribute only their own frames."""
        B, T = deno.shape[:2]
        S = 2 * self.wt
        comp = search_flow_compose(flows["fflow"], flows["bflow"], self.wt,
                                   tables=tables)
        tj_tab = (_window_tables(T, self.wt) if tables is None
                  else tables)[0]
        fw = (None if frame_weight is None else torch.as_tensor(
            frame_weight, dtype=torch.float32, device=deno.device))
        loss = 0.0
        for ti in range(T):
            for m in range(S):
                tj = int(tj_tab[ti][m])
                deno_t, noisy_j = deno[:, ti], noisy[:, tj]
                dists, flow = self.refine_flow(deno_t, deno[:, tj],
                                               comp[:, ti, m])
                mask = ((dists < self.dist_mask).to(deno.dtype)
                        if self.use_stnls else None)
                pair = torch.stack([
                    self.pair_loss(deno_t[b], noisy_j[b], flow[b], step,
                                   in_mask=None if mask is None else mask[b])
                    for b in range(B)]).mean()
                loss = loss + (pair if fw is None else fw[ti] * pair)
        if fw is None:
            return loss / (T * S)
        return loss, fw.sum() * S


def time_window_inds(ti, wt, T):
    """Temporal window frame indices for reference frame ti: [ti, then the
    2*wt nearest other frames clamped into [0, T)], matching stnls
    ``get_time_window_inds`` semantics (warped_loss.py:289-293)."""
    lo = max(0, min(ti - wt, T - (2 * wt + 1)))
    hi = min(T, lo + 2 * wt + 1)
    frames = [t for t in range(lo, hi) if t != ti]
    return [ti] + frames
