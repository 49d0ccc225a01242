"""Learning-rate schedules and the optimizer factory.

Counterpart of ``frame2frame_tpu/train/schedules.py``, the reference's
scheduler zoo (lightning.py:186-227): exp_decay (default), step, cosa,
cosa_step, multi_step, coswr, none. Each schedule is a plain function of the
update count, ``f(count) -> lr``, with optax's arithmetic: every value but
``none``'s is an f32 (returned as a Python float), each product and sum
rounded to f32 in optax's order and the cosine and power taken in f64 and
rounded, which gives XLA's f32 values. Epoch-interval schedules are per
update through ``steps_per_epoch``.

``make_optimizer`` gives ``torch.optim`` in place of the optax chain:
``add_decayed_weights(wd)`` + ``scale_by_adam()`` is ``torch.optim.Adam``
(betas (0.9, 0.999), eps 1e-8, ``weight_decay=wd``), and the JAX package's
``scale_by_torch_sgd_momentum`` is ``torch.optim.SGD`` (``momentum``,
``dampening``, ``weight_decay``), which it was written to match; with
``momentum=0`` the JAX transform still dampens every update after the first,
where torch keeps no buffer. The learning rate is set to ``sched(count)``
before each update, the count starting at 0, as ``optax.scale_by_schedule``
does. optax divides Adam's moments by bias corrections ``1 - beta^t``
computed in f32 (``1 - f32(0.999)`` is 9.99987e-4, 1.3e-5 below torch's f64
0.001), so Adam's learning rate carries the ratio of optax's corrections to
torch's (``adam_lr_factor``); without it every update of the first steps is
up to 6.4e-6 larger than optax's, and the losses of later windows show it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import optional

_f32 = np.float32


def _exponential_decay(init, transition_steps, rate):
    """optax.exponential_decay(staircase=True)."""
    if transition_steps <= 0 or rate == 0:
        return lambda count: init

    def sched(count):
        if count <= 0:
            return float(_f32(init))
        p = _f32(math.floor(count / transition_steps))
        return float(_f32(init) * _f32(float(_f32(rate)) ** float(p)))
    return sched


def _cosine_decay(init, decay_steps, alpha=0.0):
    """optax.cosine_decay_schedule (exponent 1)."""
    if not decay_steps > 0:
        raise ValueError("cosine decay needs positive decay_steps, got "
                         f"{decay_steps}")

    def sched(count):
        c = _f32(min(float(count), float(decay_steps)))
        arg = _f32(_f32(math.pi) * c) / _f32(decay_steps)
        cos = _f32(0.5) * (_f32(1) + _f32(math.cos(float(arg))))
        decayed = _f32(1 - alpha) * cos + _f32(alpha)
        return float(_f32(init) * decayed)
    return sched


def _piecewise_constant(init, boundaries_and_scales):
    """optax.piecewise_constant_schedule: the value is scaled at every
    boundary the count has reached."""
    def sched(count):
        v = _f32(init)
        for threshold, scale in sorted(boundaries_and_scales.items()):
            ind = _f32(1.0 if threshold - count > 0 else 0.0)
            v = v * ind + (_f32(1) - ind) * _f32(scale) * v
        return float(v)
    return sched


def _sgdr(init, end, periods):
    """optax.sgdr_schedule of warmup-free cosine pieces: piece i runs from
    the sum of the periods before it, and the last one holds its end."""
    starts = np.cumsum([0] + list(periods[:-1])).tolist()
    pieces = [_cosine_decay(init, p, alpha=end / init if init else 0.0)
              for p in periods]

    def sched(count):
        i = max(j for j, s in enumerate(starts) if j == 0 or count >= s)
        return pieces[i](count - starts[i])
    return sched


def make_schedule(cfg, steps_per_epoch=1):
    name = optional(cfg, "scheduler_name", "default")
    lr_init = optional(cfg, "lr_init", 1e-3)
    lr_final = optional(cfg, "lr_final", 1e-8)
    nepochs = max(optional(cfg, "nepochs", 0), 1)
    nsteps = optional(cfg, "nsteps", 0)
    spe = max(int(steps_per_epoch), 1)

    if name in ("default", "exp_decay"):
        # gamma chosen so lr_init -> lr_final over nepochs (lightning.py:187-191)
        gamma = math.exp(math.log(lr_final / lr_init) / nepochs)
        return _exponential_decay(lr_init, spe, gamma)
    if name in ("step", "steplr"):
        size = optional(cfg, "step_lr_size", 5)
        gamma = optional(cfg, "step_lr_gamma", 0.1)
        return _exponential_decay(lr_init, size * spe, gamma)
    if name == "cosa":
        return _cosine_decay(lr_init, nepochs * spe)
    if name == "cosa_step":
        n = nsteps if nsteps > 0 else nepochs * spe
        return _cosine_decay(lr_init, n, alpha=lr_final / lr_init)
    if name == "multi_step":
        gamma = optional(cfg, "step_lr_gamma", 0.1)
        milestones = [int(x) for x in
                      str(optional(cfg, "step_lr_multisteps", "30-50")).split("-")]
        return _piecewise_constant(lr_init, {m * spe: gamma
                                             for m in milestones})
    if name == "coswr":
        T0 = optional(cfg, "coswr_T0", 1)
        Tmult = optional(cfg, "coswr_Tmult", 1)
        eta_min = optional(cfg, "coswr_eta_min", 1e-9)
        periods = []
        t = max(T0, 1)
        total = nsteps if nsteps > 0 else nepochs * spe
        acc = 0
        while acc < total and len(periods) < 64:
            periods.append(t)
            acc += t
            t *= max(Tmult, 1)
        return _sgdr(lr_init, eta_min, periods)
    if name == "none":
        return lambda count: lr_init
    raise ValueError(f"Unknown scheduler [{name}]")


def adam_lr_factor(t, b1=0.9, b2=0.999):
    """The factor that turns torch Adam's update at step ``t`` (1-based; bias
    corrections in f64) into optax's (in f32), where eps is negligible:
    ``(bc1_f64 / bc1_f32) * sqrt(bc2_f32 / bc2_f64)``."""
    def f32_correction(b):
        return float(_f32(1) - _f32(float(_f32(b)) ** t))

    return ((1 - b1**t) / f32_correction(b1)
            * math.sqrt(f32_correction(b2) / (1 - b2**t)))


class Optimizer:
    """What ``make_optimizer`` returns as ``tx``, the counterpart of the
    optax chain: ``init(params)`` builds the ``torch.optim`` optimizer over
    the parameters (``TrainState.create`` calls it), ``step(opt, count)``
    sets the learning rate to ``sched(count)`` (Adam's times
    ``adam_lr_factor``) and applies one update from the parameters'
    ``.grad``."""

    def __init__(self, name, sched, weight_decay=0.0, momentum=0.1,
                 dampening=0.1):
        if name not in ("adam", "sgd"):
            raise ValueError(f"Unknown optim [{name}]")
        self.name = name
        self.sched = sched
        self.weight_decay = weight_decay
        self.momentum = momentum
        self.dampening = dampening

    def init(self, params):
        lr = self.sched(0)
        if self.name == "adam":
            return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999),
                                    eps=1e-8, weight_decay=self.weight_decay)
        return torch.optim.SGD(params, lr=lr, momentum=self.momentum,
                               dampening=self.dampening,
                               weight_decay=self.weight_decay)

    def step(self, opt, count):
        lr = self.sched(count)
        if self.name == "adam":
            lr *= adam_lr_factor(count + 1)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()


def make_optimizer(cfg, steps_per_epoch=1):
    """Optimizer factory matching configure_optimizers (lightning.py:169-181):
    adam or sgd with the torch weight-decay-in-gradient convention. Returns
    ``(tx, sched)``."""
    sched = make_schedule(cfg, steps_per_epoch)
    tx = Optimizer(optional(cfg, "optim_name", "adam"), sched,
                   weight_decay=optional(cfg, "weight_decay", 0.0),
                   momentum=optional(cfg, "sgd_momentum", 0.1),
                   dampening=optional(cfg, "sgd_dampening", 0.1))
    return tx, sched
