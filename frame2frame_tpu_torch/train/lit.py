"""Offline training module — counterpart of ``frame2frame_tpu/train/lit.py``,
the reference's PyTorch-Lightning ``LitModel`` (lib/frame2frame/
lightning.py:111-551).

Same config surface (``lit_pairs``, lightning.py:77-95) and the same
``crit_name`` loss dispatch (lightning.py:330-371), structured as
``training_step(state, batch, epoch, key) -> (state, metrics)`` over a
``train/state.TrainState``: a training-mode forward, ``backward``, one
optimizer update, and the BatchNorm statistics of the step's last forward.

The step runs eagerly. The JAX package compiles it once per value of what
its cache key holds (the crit, the state's closures, and ``get_k``,
``get_ws``, ``get_ps``, ``get_ps_dists`` or the epoch, each frozen at the
step's concrete value); an eager step reads those same values from the same
``(epoch, step)`` on every call, so no cache is kept. ``key`` is a
``torch.Generator`` where JAX takes a PRNG key: the losses that draw (Nb2Nb's
masks, n2n's noise, a search video of ``noisy-g-<sigma>``) and the noise
simulator draw from it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Config, extract_pairs, optional
from ..data.noise import choose_noise_transform
from ..flow import api as flow_api
from ..losses.b2u import B2ULoss
from ..losses.basic import sup_loss
from ..losses.combo import ComboLoss
from ..losses.nb2nb import Nb2NbLoss
from ..losses.stnls import DnlsLoss
from ..losses.warped import WarpedLoss
from ..utils.metrics import compute_psnrs, compute_ssims
from .state import TrainState, apply_gradients, make_train_apply


def lit_pairs():
    """Config keys + defaults, mirroring lightning.py:77-95."""
    return {
        "batch_size": 1, "flow": True, "flow_method": "tvl1",
        "isize": None, "bw": False, "lr_init": 1e-3,
        "lr_final": 1e-8, "weight_decay": 0.0,
        "nsteps": 0, "nepochs": 0, "task": "denoising", "uuid": "",
        "scheduler_name": "default", "step_lr_size": 5,
        "step_lr_gamma": 0.1, "flow_epoch": None, "flow_from_end": None,
        "ws": 9, "wt": 3, "ps": 7, "ps_dists": 7, "k": 5, "stride0": 4,
        "dist_crit": "l2", "search_input": "deno", "alpha": 0.5,
        "crit_name": "warped", "read_flows": False,
        "ntype": "g", "rate": -1, "sigma": -1, "sigma_min": -1, "sigma_max": -1,
        "nb2nb_epoch_ratio": 2.0, "nb2nb_lambda1": 1.0, "nb2nb_lambda2": 1.0,
        "stnls_k_decay": -1, "stnls_ps_dist_sched": "None",
        "stnls_ws_sched": "None", "stnls_center_crop": 0.0,
        "optim_name": "adam", "sgd_momentum": 0.1, "sgd_dampening": 0.1,
        "coswr_T0": -1, "coswr_Tmult": 1, "coswr_eta_min": 1e-9,
        "step_lr_multisteps": "30-50", "combo_swap_epochs": 50,
        "stnls_nb2nb_alpha": 0.0, "stnls_normalize_bwd": False, "dd_in": 3,
        "dist_mask": -1, "limit_train_batches": -1,
    }


def sim_pairs():
    return {"sim_type": "g", "sim_module": "stardeno",
            "sim_device": "cuda", "load_fxn": "load_sim",
            "sim_channels": 3, "sim_sigma_a": 2.0, "sim_sigma_b": 0.0}


def init_cfg(cfg):
    return Config(lit=extract_pairs(cfg, lit_pairs()),
                  sim=extract_pairs(cfg, sim_pairs()))


def get_sim_model(cfg, device=None):
    """Learned noise-simulator hook (reference get_sim_model,
    lightning.py:102-109): sim_type "g" means analytic noise (None); a
    learned simulator module is loaded by name. The external "stardeno"
    generator is not distributable, so when its import fails (or sim_type is
    "learned_g") the built-in learned heteroscedastic Gaussian simulator
    (models/noise_sim.py) takes its place on ``device`` — same ``run_rgb``
    surface."""
    sim_type = optional(cfg, "sim_type", "g")
    if sim_type == "g":
        return None
    from ..models.noise_sim import load_sim

    if sim_type == "learned_g":
        return load_sim(cfg, device=device)
    import importlib

    name = optional(cfg, "sim_module", sim_type)
    try:
        module = importlib.import_module(name)
    except ImportError:
        if name != "stardeno":
            # a user-specified simulator that fails to import is an error,
            # not a cue to silently swap in the toy substitute
            raise
        import sys

        print("warning: the external 'stardeno' noise generator is not "
              "installed — substituting the built-in learned heteroscedastic "
              "Gaussian simulator (models/noise_sim.py)", file=sys.stderr)
        return load_sim(cfg, device=device)
    return getattr(module, optional(cfg, "load_fxn", "load_sim"))(cfg)


def _host(x):
    return x.detach().cpu().numpy()


class TrainModule:
    """Loss construction + step functions. State lives outside
    (TrainState); the step runs on the device of the state's model."""

    def __init__(self, cfg, model, residual=True, sim_model=None,
                 video_model=False):
        self.cfg = init_cfg(cfg).lit
        c = self.cfg
        self.model = model
        self.residual = residual
        self.video_model = video_model  # consumes (B,T,H,W,C) directly
        if sim_model is None:
            try:
                sim_model = get_sim_model(
                    init_cfg(cfg).sim,
                    device=next(model.parameters()).device)
            except ImportError as e:
                import sys

                print(f"warning: noise-simulator module failed to import "
                      f"({e}); proceeding without resampling (dataset noise "
                      f"kept)", file=sys.stderr)
                sim_model = None
        self.sim_model = sim_model
        self.noise_sim = choose_noise_transform(c)
        self.set_flow_epoch()
        self.crit = self.init_crit()
        self.dd_in = c.dd_in

    def set_flow_epoch(self):
        """``flow_from_end=N`` means the last N epochs run with optical flow
        (reference set_flow_epoch, lightning.py:118,157-161)."""
        c = self.cfg
        if c.flow_epoch is not None:
            return
        if not c.flow_from_end:
            return
        c.flow_epoch = c.nepochs - c.flow_from_end

    def use_flow(self, epoch):
        """Flow enable for this epoch: the configured ``flow`` flag, switched
        on from ``flow_epoch`` onwards (the reference's update_flow
        semantics, lightning.py:163-167).

        NB in the reference, update_flow's body is entirely COMMENTED OUT —
        flow_from_end sets flow_epoch (lightning.py:118,157-161) and then
        nothing ever flips flow on, so strictly the reference never
        activates it. This implements the method's evident intent, as the
        JAX package does; a strict-parity caller should leave
        flow_from_end/flow_epoch unset. The ``flow_epoch > 0`` guard is the
        reference's own: update_flow bails on ``flow_epoch <= 0``, so
        ``flow_from_end >= nepochs`` (or an explicit flow_epoch=0) never
        switches flow on — replicated deliberately, quirk included."""
        c = self.cfg
        flow = bool(c.flow)
        if c.flow_epoch is not None and c.flow_epoch > 0 and epoch >= c.flow_epoch:
            flow = True
        return flow

    def sample_noisy(self, batch, key):
        """Resample noise from a learned simulator (lightning.py:151-155)."""
        if self.sim_model is None:
            return batch
        batch = Config(batch)
        batch["noisy"] = self.sim_model.run_rgb(batch["clean"], generator=key)
        return batch

    # -- loss construction (lightning.py:373-422) --

    def _dnls(self, **kw):
        c = self.cfg
        return DnlsLoss(c.ws, c.wt, c.ps, c.ps_dists, c.k, c.stride0,
                        c.dist_crit, c.search_input, c.alpha, c.nepochs,
                        c.stnls_k_decay, c.stnls_ps_dist_sched,
                        c.stnls_ws_sched, 1.0, c.dist_mask,
                        c.stnls_center_crop,
                        nmz_bwd=c.stnls_normalize_bwd, **kw)

    def _nb2nb(self):
        c = self.cfg
        return Nb2NbLoss(c.nb2nb_lambda1, c.nb2nb_lambda2, max(c.nepochs, 1),
                         c.nb2nb_epoch_ratio)

    def init_crit(self):
        c = self.cfg
        name = c.crit_name
        if name == "warped":
            return WarpedLoss(c.dist_crit, wt=min(c.wt, 1))
        if name == "stnls":
            return self._dnls()
        if name == "nb2nb":
            return self._nb2nb()
        if name == "b2u":
            ninfo = "%s_%d_%d" % (c.ntype, c.sigma, c.rate)
            return B2ULoss(c.nb2nb_lambda1, c.nb2nb_lambda2,
                           max(c.nepochs, 1), c.nb2nb_epoch_ratio, ninfo)
        if name in ("stnls_nb2nb", "nb2nb_stnls"):
            loss0, loss1 = self._nb2nb(), self._dnls(sigma=c.sigma)
            if name == "stnls_nb2nb":
                return ComboLoss(loss0, loss1, swap=c.combo_swap_epochs,
                                 alpha=c.stnls_nb2nb_alpha)
            return Config(nb2nb=loss0, stnls=loss1, name="nb2nb_stnls")
        if name in ("sup", "sup_fdvd", "n2n"):
            return None  # handled inline
        raise ValueError(f"Unknown loss name [{name}]")

    # -- channel handling (lightning.py:129-141) --

    def ensure_chnls(self, noisy, sigma):
        if noisy.shape[-1] == self.dd_in:
            return noisy
        if noisy.shape[-1] == 4 and self.dd_in == 3:
            return noisy[..., :3]
        if self.dd_in == noisy.shape[-1] + 1:
            B, T, H, W, _ = noisy.shape
            sig = torch.as_tensor(np.asarray(sigma), dtype=noisy.dtype,
                                  device=noisy.device)
            sig = (sig.reshape(-1, 1, 1, 1, 1) / 255.0).expand(B, T, H, W, 1)
            return torch.cat([noisy, sig], dim=-1)
        return noisy

    # -- loss dispatch (lightning.py:330-371) --

    def compute_loss(self, apply_fn, clean, noisy, flows, epoch, step, key):
        c = self.cfg
        name = c.crit_name
        B, T = noisy.shape[:2]

        def fwd(v):
            if self.video_model:
                return apply_fn(v)
            out = apply_fn(v.reshape((B * T,) + tuple(v.shape[2:])))
            return out.reshape(tuple(v.shape[:2]) + tuple(out.shape[1:]))

        if name == "warped":
            deno = fwd(noisy)
            return deno, self.crit.run_pairs(deno, noisy, flows, step)
        if name == "stnls":
            deno = fwd(noisy)
            return deno, self.crit(noisy, clean, deno, flows, step, key)
        if name == "nb2nb":
            return self.crit.compute(apply_fn, noisy, epoch, key)
        if name == "b2u":
            return self.crit.compute(apply_fn, noisy, epoch)
        if name == "nb2nb_stnls":
            deno0 = fwd(noisy)
            loss0 = self.crit.stnls(noisy, clean, deno0, flows, epoch, key)
            deno1, loss1 = self.crit.nb2nb.compute(apply_fn, noisy, epoch, key)
            return 0.5 * (deno0 + deno1), 0.5 * (loss0 + loss1)
        if name == "stnls_nb2nb":
            return self.crit(apply_fn, noisy, flows, epoch, key, clean)
        if name == "sup":
            deno = fwd(noisy)
            return deno, ((deno - clean) ** 2).mean()
        if name == "sup_fdvd":
            deno = fwd(noisy)
            # center-frame supervision (lightning.py:351-356); a video model
            # returns (B,T,...) so compare its center frame
            tgt = clean[:, T // 2]
            pred = deno[:, T // 2] if deno.ndim == clean.ndim else deno
            return deno, ((pred - tgt) ** 2).mean()
        if name == "n2n":
            deno = fwd(noisy)
            noisy2 = self.noise_sim(key, clean * 255.0) / 255.0
            return deno, sup_loss(noisy2, deno, c.dist_crit)
        raise ValueError(f"Unknown loss name [{name}]")

    # -- training step --

    def _videos(self, state: TrainState, batch):
        """The batch's (noisy, clean) on the state's device and dtype, on
        [0, 1], noisy with the model's input channels."""
        def vid(x):
            return torch.as_tensor(x).to(state.device, state.dtype) / 255.0

        noisy, clean = vid(batch["noisy"]), vid(batch["clean"])
        noisy = self.ensure_chnls(noisy, batch.get("sigma", 0.0))
        return noisy, clean

    def training_step(self, state: TrainState, batch, epoch, key):
        """One optimizer step. batch: Config(noisy, clean[, fflow, bflow,
        sigma]) with videos (B, T, H, W, C) in [0, 255], numpy arrays or
        tensors; key: a ``torch.Generator``. Flows solve on the model's
        device from the detached noisy video (unless the batch carries them
        and ``read_flows`` is set)."""
        c = self.cfg
        batch = self.sample_noisy(batch, key)
        noisy, clean = self._videos(state, batch)
        noisy = noisy[..., : self.dd_in]

        if c.read_flows and "fflow" in batch:
            flows = Config({k: torch.as_tensor(batch[k]).to(state.device,
                                                             torch.float32)
                            for k in ("fflow", "bflow")})
        else:
            flows = flow_api.run_flows(noisy.detach(), self.use_flow(epoch),
                                       ftype=c.flow_method,
                                       device=state.device)

        captured = {}
        apply_fn = make_train_apply(state, captured)
        state.opt_state.zero_grad(set_to_none=True)
        deno, loss = self.compute_loss(apply_fn, clean, noisy, flows, epoch,
                                       state.step, key)
        loss.backward()
        state = apply_gradients(state, captured.get("buffers"))
        psnr = float(np.mean(compute_psnrs(_host(deno), _host(clean),
                                           div=1.0)))
        return state, Config(train_loss=float(loss.detach()), train_psnr=psnr,
                             global_step=state.step)

    # -- eval steps (lightning.py:440-519) --

    def eval_step(self, state: TrainState, batch, prefix="val"):
        noisy, clean = self._videos(state, batch)
        B, T = noisy.shape[:2]
        if self.video_model:
            deno = state.eval_apply(noisy)
        else:
            deno = state.eval_apply(noisy.reshape((B * T,)
                                                  + tuple(noisy.shape[2:])))
            deno = deno.reshape(clean.shape)
        loss = float(((clean - deno) ** 2).mean())
        d, cl = _host(deno), _host(clean)
        psnr = float(np.mean(compute_psnrs(d, cl, div=1.0)))
        ssim = float(np.mean(compute_ssims(d, cl, div=1.0)))
        return Config({f"{prefix}_loss": loss, f"{prefix}_psnr": psnr,
                       f"{prefix}_ssim": ssim,
                       f"{prefix}_index": batch.get("index", -1)})
