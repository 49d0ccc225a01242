"""The serving entry points of the online denoiser.

Counterpart of ``frame2frame_tpu/train/online.py``'s ``make_denoise`` (eval
branch) and ``OnlineDenoiser``'s serving methods ``denoise_only`` and
``denoise_batch``: eval-mode denoising with the engine's current weights, no
fine-tune iterations and no flow (blind_denoising.py:229-230 run
standalone). The fine-tune (``process_frame``) and its optimizer belong to
the training slice and are not ported yet.
"""

from __future__ import annotations

import copy
import os

import torch

from ..models.dncnn import load_jax_variables, to_jax_variables
from ..models.fused_apply import (
    _eval_impl,
    can_fuse,
    can_fuse_batch,
    fused_eval_apply,
    fused_eval_apply_batch,
)
from ..utils.device import resolve_device

BATCH_ROUTES = ("stacked", "perframe")


def make_denoise(model, residual_model=False):
    """Build ``denoise(x, eval_impl=None) -> deno`` for one (H, W, C) frame,
    through the fused kernels where the model allows it.

    ``residual_model`` says whether the model returns the denoised image
    (harness convention) or the noise (submodule convention,
    blind_denoising.py:218 subtracts)."""
    fused = can_fuse(model)

    @torch.no_grad()
    def denoise(x, eval_impl=None):
        if fused:
            y = fused_eval_apply(model, x[None], eval_impl=eval_impl)[0]
        else:
            y = model(x[None])[0]
        return y if residual_model else x - y

    return denoise


def _memory_budget(device):
    """Free memory of ``device`` in bytes: the card's free memory, or the
    host's physical memory for the CPU."""
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[0]
    return os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


class OnlineDenoiser:
    """Frame-by-frame denoiser holding one DnCNN on one device.

    ``model``: a ``DnCNN`` giving the architecture and output convention;
    ``variables``: the JAX-layout ``{"params", "batch_stats"}`` tree whose
    weights the engine serves (the caller's model is not modified);
    ``batch_route``: default ``denoise_batch`` route, "stacked" or
    "perframe"; ``eval_impl``: "affine" (default), "act-bf16" or "act-f32";
    ``device``: None means the CUDA card, and raises where there is none.
    """

    def __init__(self, model, variables, residual_model=False,
                 batch_route="stacked", eval_impl=None, device=None):
        if batch_route not in BATCH_ROUTES:
            raise ValueError(f"batch_route must be one of {BATCH_ROUTES}")
        _eval_impl(eval_impl)
        self.device = resolve_device(device)
        self.model = load_jax_variables(copy.deepcopy(model), variables)
        self.model = self.model.to(self.device).eval()
        self.batch_route = batch_route
        self.eval_impl = eval_impl
        self._residual_model = residual_model
        self._denoise = make_denoise(self.model, residual_model)

    def _tensor(self, x):
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def denoise_only(self, cur):
        """Eval-mode denoise of one (H, W, C) frame in [0, 1]."""
        return self._denoise(self._tensor(cur), self.eval_impl)

    @torch.no_grad()
    def denoise_batch(self, frames, route=None):
        """Eval-mode denoise of (B, H, W, C) frames.

        - "stacked": the whole batch through one kernel launch per layer;
          falls back to "perframe" when the batch would not fit the
          device's free memory (``can_fuse_batch``);
        - "perframe": ``denoise_only`` on each frame in turn.
        """
        route = route or self.batch_route
        if route not in BATCH_ROUTES:
            raise ValueError(f"route must be one of {BATCH_ROUTES}")
        x = self._tensor(frames)
        if route == "stacked" and not can_fuse_batch(
                self.model, tuple(x.shape), _memory_budget(self.device),
                self.eval_impl):
            route = "perframe"
        if route == "perframe":
            return torch.stack([self._denoise(f, self.eval_impl) for f in x])
        y = fused_eval_apply_batch(self.model, x, eval_impl=self.eval_impl)
        return y if self._residual_model else x - y

    @property
    def variables(self):
        """The served weights as a JAX-layout tree of numpy arrays."""
        return to_jax_variables(self.model)
