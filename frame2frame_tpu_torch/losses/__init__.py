"""Loss registry: ``get_loss_fxn`` maps a ``loss_type`` to a self-contained
adaptation wrapper with the ``(state, noisy, clean) -> (state, info)``
calling convention.

Counterpart of ``frame2frame_tpu/losses/__init__.py`` (the reference's
missing ``losses.get_loss_fxn``, lib/frame2frame/__init__.py:7, called at
scripts/instances_adapt.py:25,216).
"""

from __future__ import annotations

from ..config import Config, optional
from .b2u import B2ULoss, Masker  # noqa: F401
from .basic import n2n_loss, sup_fdvd_loss, sup_loss  # noqa: F401
from .combo import ComboLoss  # noqa: F401
from .nb2nb import Nb2NbLoss  # noqa: F401
from .stnls import DnlsLoss
from .warped import WarpedLoss

def get_loss_fxn(cfg, loss_type=None):
    """Build an adaptation loss wrapper from a config.

    loss_type in {"f2f", "warped", "f2f_plus", "stnls", "sup", "none"}
    (the grids of instances_adapt.py:388-434).
    """
    from ..train.adapt import WrapDnlsLoss, WrapSupLoss, WrapWarpedLoss

    loss_type = loss_type or optional(cfg, "loss_type", "f2f")
    isize = optional(cfg, "adapt_isize", optional(cfg, "isize", "128_128"))
    nepochs = optional(cfg, "adapt_nepochs", optional(cfg, "nepochs", 1))
    nbatch = optional(cfg, "nbatch_sample", 1)
    use_flow = optional(cfg, "flow", True)
    flow_method = optional(cfg, "flow_method", "tvl1")
    train_bn = optional(cfg, "adapt_train_bn", False)
    nsteps = optional(cfg, "adapt_nsteps", 0)

    if loss_type in ("f2f", "warped", "f2f_plus"):
        crit = WarpedLoss(
            dist_crit=optional(cfg, "dist_crit", "l2"),
            use_stnls=loss_type == "f2f_plus",
            ws=optional(cfg, "ws", 9), ps=optional(cfg, "ps", 7),
            dist_mask=optional(cfg, "dist_mask", 2e-1),
            wt=1,
        )
        return WrapWarpedLoss(crit, isize, nepochs, nbatch, use_flow,
                              flow_method, train_bn, nsteps)
    if loss_type == "stnls":
        crit = DnlsLoss(
            ws=optional(cfg, "ws", 9), wt=optional(cfg, "wt", 1),
            ps=optional(cfg, "ps", 7), ps_dists=optional(cfg, "ps_dists", -1),
            k=optional(cfg, "k", 5), stride0=optional(cfg, "stride0", 4),
            dist_crit=optional(cfg, "dist_crit", "v0"),
            search_input=optional(cfg, "search_input", "deno"),
            nepochs=max(nepochs, 1),
            dist_mask=optional(cfg, "dist_mask", 0.1),
        )
        return WrapDnlsLoss(crit, isize, nepochs, nbatch, use_flow,
                            flow_method, train_bn, nsteps)
    if loss_type == "sup":
        return WrapSupLoss(None, isize, nepochs, nbatch, use_flow,
                           flow_method, train_bn, nsteps)
    if loss_type == "none":
        # the signature of _WrapBase.__call__, so direct callers that pass
        # sched= (instances_adapt.run_training) work
        def identity(state, noisy, clean, seed=0, sched=None):
            return state, Config(lr=[], loss=[])

        return identity
    raise ValueError(f"Unknown loss type [{loss_type}]")
