"""Training state: the module, its optimizer and the step, the counterpart
of ``frame2frame_tpu/train/state.py`` and of the reference's (model, optim,
scheduler) triple that ``get_loss_fxn`` wrappers receive
(instances_adapt.py:216-219).

The JAX state is a value: ``apply_gradients`` returns a new one. Here the
parameters, BatchNorm statistics and optimizer moments live in the module
and its ``torch.optim`` optimizer and change in place; ``apply_gradients``
still returns the state (``replace``d with the next step), so callers read
the same. ``variables`` gives the JAX package's tree (numpy leaves) of what
the module holds.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any

import torch

from ..models import _train_forward, arch_of


@dataclass
class TrainState:
    model: torch.nn.Module
    tx: Any  # train.schedules.Optimizer
    opt_state: torch.optim.Optimizer
    residual: bool = True  # model returns denoised image directly
    step: int = 0
    # parallel.data.DataParallel: the training forward split over a data
    # mesh (train/trainer.py), or None for one device
    data_parallel: Any = None

    def replace(self, **kw):
        return replace(self, **kw)

    @property
    def device(self):
        return next(self.model.parameters()).device

    @property
    def dtype(self):
        return next(self.model.parameters()).dtype

    @property
    def variables(self):
        """``{"params", "batch_stats"}`` as the JAX package's tree."""
        return arch_of(self.model).to_jax_variables(self.model)

    def eval_apply(self, x, **kw):
        """The eval-mode output (the denoised image), without a graph; ``x``
        a tensor or numpy array, moved to the model's device and dtype."""
        x = torch.as_tensor(x, dtype=self.dtype, device=self.device)
        self.model.eval()
        with torch.no_grad():
            out = self.model(x, **kw)
        return out if self.residual else x - out

    @classmethod
    def create(cls, model, variables, tx, residual=True):
        """Load ``variables`` (the JAX tree; None keeps the module's
        weights) into ``model`` and build ``tx``'s optimizer over its
        parameters."""
        if variables is not None:
            arch_of(model).load_jax_variables(model, variables)
        model.eval()
        return cls(model=model, tx=tx,
                   opt_state=tx.init(list(model.parameters())),
                   residual=residual)


def make_train_apply(state: TrainState, captured: dict):
    """``apply_fn(x, train=True) -> deno`` on the state's module. A training
    forward records the moved BatchNorm buffers (clones, on the module's
    device) into ``captured["buffers"]`` and gives the module its own back
    (``models._train_forward``): the last call wins, as in the JAX
    package. With ``state.data_parallel`` a training forward runs split
    over its data mesh, with the whole batch's BatchNorm statistics; an
    eval forward runs on the module (its rows are independent)."""
    model = state.model

    def apply_fn(x, train=True):
        if train and state.data_parallel is not None:
            out, captured["buffers"] = state.data_parallel(x)
        elif train:
            out, captured["buffers"] = _train_forward(
                model, x, {}, lambda: [b.clone() for b in model.buffers()])
        else:
            model.eval()
            out = model(x)
        return out if state.residual else x - out

    return apply_fn


def apply_gradients(state: TrainState, new_buffers=None):
    """One optimizer update at the learning rate ``sched(state.step)`` from
    the parameters' ``.grad`` (where JAX takes the gradient tree); then the
    gradients are cleared and ``new_buffers`` (``make_train_apply``'s
    capture), where given, are copied into the module's BatchNorm buffers.
    Returns the state at the next step."""
    state.tx.step(state.opt_state, state.step)
    state.opt_state.zero_grad(set_to_none=True)
    if new_buffers is not None:
        with torch.no_grad():
            for b, new in zip(state.model.buffers(), new_buffers):
                b.copy_(new)
    return state.replace(step=state.step + 1)
