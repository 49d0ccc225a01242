"""The port's time-sharded window steps (``frame2frame_tpu_torch/parallel/
shard.make_sharded_window_step``) at ``tests/test_parallel.py``'s cases
(``WarpedLoss`` and ``DnlsLoss`` v0, wt = 1, B = n_data, T = 4 n_time, 16x16,
a 4-layer DnCNN, Adam at 1e-3, ``train_bn=False``) on meshes (2, 4) and
(4, 2) of repeated ``"cpu"`` devices:

- against the port's unsharded loss and one unsharded Adam step, at that
  test's bounds (loss rtol 1e-5; parameters rtol 1e-4, atol 1e-6);
- the port's unsharded loss and gradient against the JAX package's (loss
  rtol 1e-5; gradient within 1e-4 of its largest element), so that the
  sharded step is held to the JAX package through it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from frame2frame_tpu.config import Config as JConfig  # noqa: E402
from frame2frame_tpu.losses.stnls import DnlsLoss as JDnls  # noqa: E402
from frame2frame_tpu.losses.warped import WarpedLoss as JWarped  # noqa: E402
from frame2frame_tpu.models.dncnn import init_dncnn as jinit  # noqa: E402
from frame2frame_tpu_torch.config import Config  # noqa: E402
from frame2frame_tpu_torch.losses.stnls import DnlsLoss  # noqa: E402
from frame2frame_tpu_torch.losses.warped import WarpedLoss  # noqa: E402
from frame2frame_tpu_torch.models.dncnn import (  # noqa: E402
    JaxRavel,
    from_jax_variables,
    param_leaves,
    to_jax_variables,
)
from frame2frame_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from frame2frame_tpu_torch.parallel import shard as tshard  # noqa: E402
from frame2frame_tpu_torch.train.online import torch_adam as tadam  # noqa: E402

LR = 1e-3
WT = 1
CASES = [(kind, n_data, n_time) for kind in ("warped", "stnls")
         for n_data, n_time in ((2, 4), (4, 2))]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_case(kind, n_data, n_time):
    B, T, H, W, C = n_data, 4 * n_time, 16, 16, 1
    seed = 0 if kind == "warped" else 1
    rng = np.random.default_rng(seed)
    vids = [rng.random((B, T, H, W, C)).astype(np.float32),
            rng.random((B, T, H, W, C)).astype(np.float32),
            (0.5 * rng.standard_normal((B, T, H, W, 2))).astype(np.float32),
            (0.5 * rng.standard_normal((B, T, H, W, 2))).astype(np.float32)]
    _, variables = jinit(jax.random.PRNGKey(seed), channels=1, num_layers=4,
                         residual=True, spatial=(H, W))
    return vids, jax.tree_util.tree_map(np.asarray, variables)


def losses(kind):
    if kind == "warped":
        return (JWarped(wt=WT, dist_crit="l2"),
                WarpedLoss(wt=WT, dist_crit="l2"))
    kw = dict(ws=3, wt=WT, ps=3, k=2, stride0=2, dist_crit="v0",
              dist_mask=10.0, search_input="deno", nepochs=10)
    return JDnls(**kw), DnlsLoss(**kw)


def run_loss(kind, loss, deno, noisy, clean, fflow, bflow, cfg):
    if kind == "warped":
        return loss.run_pairs(deno, noisy, cfg(fflow=fflow, bflow=bflow))
    return loss(noisy, clean, deno, {"fflow": fflow, "bflow": bflow}, 0)


def port_unsharded(kind, vids, variables):
    """Loss, gradient (ravel order) and one Adam step, unsharded."""
    model = from_jax_variables(variables, residual=True,
                               conv_impl="packed").eval()
    noisy, clean, fflow, bflow = (torch.from_numpy(v) for v in vids)
    B, T = noisy.shape[:2]
    deno = model(noisy.reshape((B * T,) + noisy.shape[2:])).reshape(
        noisy.shape)
    loss = run_loss(kind, losses(kind)[1], deno, noisy, clean, fflow, bflow,
                    Config)
    loss.backward()
    ravel, tx = JaxRavel(model), tadam(LR)
    grads = ravel.ravel(grads=True).clone()
    upd, _ = tx.update(grads, tx.init(ravel.ravel()), ravel.ravel())
    ravel.add(upd)
    return float(loss.detach()), grads, to_jax_variables(model)["params"]


def jax_unsharded(kind, vids, variables):
    model, _ = jinit(jax.random.PRNGKey(0), channels=1, num_layers=4,
                     residual=True, spatial=vids[0].shape[2:4])
    noisy, clean, fflow, bflow = (jnp.asarray(v) for v in vids)
    loss_obj = losses(kind)[0]

    @jax.jit
    def value_and_grad(p):
        def f(p):
            deno = model.apply({"params": p,
                                "batch_stats": variables["batch_stats"]},
                               noisy, train=False)
            return run_loss(kind, loss_obj, deno, noisy, clean, fflow, bflow,
                            JConfig)
        return jax.value_and_grad(f)(p)

    v, g = value_and_grad(variables["params"])
    return float(v), g


@pytest.mark.parametrize("kind,n_data,n_time", CASES)
def test_sharded_window_step_parity(kind, n_data, n_time):
    vids, variables = make_case(kind, n_data, n_time)
    model = from_jax_variables(variables, residual=True, conv_impl="packed")
    tx = tadam(LR)
    step = tshard.make_sharded_window_step(
        model, tmesh.make_mesh(n_data, n_time, devices=["cpu"] * 8), tx,
        losses(kind)[1], kind=kind, wt=WT, train_bn=False, step_i=0)
    p, bs, _, loss = step(variables["params"], variables["batch_stats"],
                          tx.init(JaxRavel(model).ravel()), *vids)
    ref_loss, ref_grads, ref_params = port_unsharded(kind, vids, variables)
    assert np.allclose(float(loss), ref_loss, rtol=1e-5), (float(loss),
                                                           ref_loss)
    for a, b in zip(jax.tree_util.tree_leaves(p),
                    jax.tree_util.tree_leaves(ref_params), strict=True):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)

    jloss, jgrads = jax_unsharded(kind, vids, variables)
    assert np.allclose(ref_loss, jloss, rtol=1e-5), (ref_loss, jloss)
    names = [n for n, _ in param_leaves(model)]
    jflat = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(jgrads):
        key = ".".join(str(k.key) for k in path)
        jflat[key] = np.asarray(leaf)
    want = np.concatenate([jflat[n].ravel() for n in names])
    got = ref_grads.numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
