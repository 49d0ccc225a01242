"""Test-time / instance adaptation loops: the reference's ``WrapWarpedLoss``
(warped_loss.py:63-115) and ``WrapDnlsLoss`` (stnls_loss.py:108-178), and the
supervised window loop, returned by the loss registry (``get_loss_fxn``).

Counterpart of ``frame2frame_tpu/train/adapt.py``. Each wrapper runs a
self-contained fine-tune: ``nepochs`` x sliding temporal windows (5 frames
for warped, 3 for stnls and sup) x ``nbatch_sample`` random crops, with the
flow computed on the fly from the detached denoised crops and one optimizer
update a window. ``train_bn=False`` (the reference's BN frozen in eval,
instances_adapt.py:200-206) runs the model in eval mode while gradients
flow into its parameters; ``train_bn=True`` runs the window's forward in
training mode and keeps its moved statistics.

The crops come from ``np.random.default_rng(seed)`` as in the JAX package,
so both cut the same crops; they reach the model in its parameters' dtype.
Where JAX splits a PRNG key a window, the wrappers hand the losses a
``torch.Generator`` seeded with ``seed`` on the model's device (only
``search_input="noisy-g-<sigma>"`` draws from it). The wrappers run on the
device of the state's model; the flows too.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Config
from ..data.crop import run_rand_crop
from ..flow import api as flow_api
from .state import TrainState, apply_gradients, make_train_apply


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


class _WrapBase:
    nf = 5

    def __init__(self, loss_fxn, isize, nepochs, nbatch_sample,
                 use_flow=False, flow_method="tvl1", train_bn=False,
                 nsteps=0):
        self.loss_fxn = loss_fxn
        self.nepochs = nepochs
        self.nbatch_sample = nbatch_sample
        self.use_flow = use_flow
        self.flow_method = flow_method
        self.train_bn = train_bn
        # optimizer-step budget per epoch (the reference threads
        # internal_adapt_nsteps into run_internal_adapt, test.py:189-203);
        # 0 = unlimited (every sliding window)
        self.nsteps = nsteps
        if isinstance(isize, str):
            isize = [int(x) for x in isize.split("_")]
        self.isize = isize

    def _crops(self, noisy, clean, ti, rng):
        n_w = noisy[:, ti : ti + self.nf]
        c_w = clean[:, ti : ti + self.nf]
        ns, cs = [], []
        for _ in range(self.nbatch_sample):
            n_b, c_b = run_rand_crop([n_w, c_w], self.isize, rng)
            ns.append(n_b)
            cs.append(c_b)
        return np.concatenate(ns), np.concatenate(cs)

    def _loss(self, apply_fn, noisy_i, clean_i, epoch, key):
        raise NotImplementedError

    def windows(self, T):
        """Optimizer updates an epoch for a T-frame video."""
        nwin = max(T - self.nf + 1, 1)
        return min(nwin, self.nsteps) if self.nsteps > 0 else nwin

    def __call__(self, state: TrainState, noisy, clean, seed=0, sched=None):
        """Run the adaptation; noisy/clean: (B, T, H, W, C) in [0, 1], numpy
        arrays or tensors. Returns (state, info) with info.lr / info.loss
        traces (warped_loss.py:80-83); ``sched`` is the optimizer's
        learning-rate schedule (make_optimizer's second return), stepped per
        optimizer update like the reference scheduler."""
        info = Config(lr=[], loss=[])
        rng = np.random.default_rng(seed)
        dev, dtype = state.device, state.dtype
        key = torch.Generator(dev).manual_seed(seed)
        noisy, clean = _host(noisy), _host(clean)
        for epoch in range(self.nepochs):
            for ti in range(self.windows(noisy.shape[1])):
                noisy_i, clean_i = (
                    torch.as_tensor(v, dtype=dtype, device=dev)
                    for v in self._crops(noisy, clean, ti, rng))
                captured = {}
                apply_fn = make_train_apply(state, captured)
                if not self.train_bn:
                    base = apply_fn

                    def apply_fn(x, train=False):
                        return base(x, train=False)

                state.opt_state.zero_grad(set_to_none=True)
                loss = self._loss(apply_fn, noisy_i, clean_i, epoch, key)
                loss.backward()
                state = apply_gradients(
                    state, new_buffers=captured.get("buffers")
                    if self.train_bn else None)
                info.loss.append(float(loss.detach()))
                info.lr.append(float(sched(state.step - 1))
                               if sched is not None else state.step)
        return state, info

    def _fwd_video(self, apply_fn, vid):
        B, T = vid.shape[:2]
        out = apply_fn(vid.reshape((B * T,) + tuple(vid.shape[2:])))
        return out.reshape(tuple(vid.shape[:2]) + tuple(out.shape[1:]))

    def _flows(self, deno_i):
        return flow_api.run_flows(deno_i.detach(), self.use_flow,
                                  ftype=self.flow_method,
                                  device=deno_i.device)


class WrapWarpedLoss(_WrapBase):
    """5-frame-window warped-loss adaptation (warped_loss.py:63-115)."""

    nf = 5

    def _loss(self, apply_fn, noisy_i, clean_i, epoch, key):
        deno_i = self._fwd_video(apply_fn, noisy_i)
        return self.loss_fxn.run_pairs(deno_i, noisy_i, self._flows(deno_i),
                                       epoch)


class WrapDnlsLoss(_WrapBase):
    """3-frame-window stnls-loss adaptation (stnls_loss.py:108-178)."""

    nf = 3

    def _loss(self, apply_fn, noisy_i, clean_i, epoch, key):
        deno_i = self._fwd_video(apply_fn, noisy_i)
        return self.loss_fxn(noisy_i, clean_i, deno_i, self._flows(deno_i),
                             epoch, key)


class WrapSupLoss(_WrapBase):
    """Supervised adaptation window loop ("sup" loss_type of instances_adapt)."""

    nf = 3

    def _loss(self, apply_fn, noisy_i, clean_i, epoch, key):
        deno_i = self._fwd_video(apply_fn, noisy_i)
        return ((deno_i - clean_i) ** 2).mean()
