"""The port's training-mode forward (frame2frame_tpu_torch/models/fused_apply.py
``fused_train_apply``) and the module's own training mode vs the JAX package.

- ``fused_train_apply``: output, new running statistics and every parameter's
  gradient of the masked summed-L1 loss against the JAX ``fused_train_apply``
  (Pallas kernels in interpret mode), f32 strict and bf16 production chains.
  Gradients are compared per leaf as max |d| / max |ref|: 1e-4 in f32 and
  1e-2 in bf16, the bounds of tests/test_flat_step.py. Outputs: rtol = atol
  = 2e-4 in f32, rtol 0.03 / atol 0.02 in bf16. The bf16 bound holds for
  these seeded inputs, where the two conv implementations round every stored
  activation alike (deviations of 2e-3 to 3e-3); with 512 pixels one ReLU
  decision that falls the other way moves a gradient entry by several
  percent, on either side.
- ``DnCNN.train()``'s plain forward against ``model.apply(train=True)`` of
  the JAX module (``conv_impl="xla"``), including the biased running variance.
- the bf16 end conv: weight gradient accumulated and delivered in f32.
"""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from frame2frame_tpu.models import fused_apply as jfa  # noqa: E402
from frame2frame_tpu_torch.models import fused_apply as tfa  # noqa: E402
from frame2frame_tpu_torch.models.dncnn import from_jax_variables  # noqa: E402
from frame2frame_tpu_torch.ops import fused_stack as tfs  # noqa: E402

from test_torch_fused_apply import frames, perturbed_model  # noqa: E402

OUT_TOL = {"f32": dict(rtol=2e-4, atol=2e-4), "bf16": dict(rtol=0.03, atol=0.02)}
STAT_TOL = {"f32": dict(rtol=1e-4, atol=1e-5), "bf16": dict(rtol=1e-2, atol=1e-3)}
GRAD_TOL = {"f32": 1e-4, "bf16": 1e-2}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def loss_data(H, W, seed):
    rng = np.random.default_rng(seed)
    mask = (rng.random((1, H, W, 1)) > 0.2).astype(np.float32)
    return mask, mask * rng.random((1, H, W, 1)).astype(np.float32)


def grads_tree(model):
    """The parameters' gradients in the JAX params layout."""
    def hwio(p):
        return p.grad.permute(2, 3, 1, 0).numpy()

    tree = {"conv_in": {"kernel": hwio(model.conv_in.weight)},
            "conv_out": {"kernel": hwio(model.conv_out.weight)}}
    for i in range(model.nmid):
        conv, bn = model.mid(i)
        tree[f"conv_{i}"] = {"kernel": hwio(conv.weight)}
        tree[f"bn_{i}"] = {"scale": bn.weight.grad.numpy(),
                           "bias": bn.bias.grad.numpy()}
    return tree


def assert_grads_close(got_tree, want_tree, tol):
    want = jax.tree_util.tree_leaves_with_path(want_tree)
    got = dict(jax.tree_util.tree_leaves_with_path(got_tree))
    assert len(want) == len(got) == 2 + 3 * 3
    for path, r in want:
        r = np.asarray(r)
        scale = np.abs(r).max() + 1e-8
        np.testing.assert_allclose(got[path] / scale, r / scale, atol=tol,
                                   err_msg=str(path))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("H,W,residual,seed", [(16, 32, False, 40),
                                               (13, 20, True, 41)])
def test_fused_train_apply_matches_jax(H, W, residual, seed, dt):
    model, variables = perturbed_model(H, W, seed=seed, residual=residual,
                                       conv_impl="fused")
    x = frames(1, H, W, seed=seed + 1)
    mask, target = loss_data(H, W, seed=seed + 2)

    def loss_fn(p):
        y, bs = jfa.fused_train_apply(model, p, variables["batch_stats"],
                                      jnp.asarray(x), store_dtype=JDT[dt])
        deno = y if residual else jnp.asarray(x) - y
        return jnp.sum(jnp.abs(mask * deno - target)), (y, bs)

    (loss_j, (y_j, bs_j)), grads_j = jax.value_and_grad(
        loss_fn, has_aux=True)(
            jax.tree_util.tree_map(jnp.asarray, variables["params"]))

    tm = from_jax_variables(variables, residual=residual)
    xt = torch.from_numpy(x)
    tfs.reset_launch_counts()
    y = tfa.fused_train_apply(tm, xt, store_dtype=TDT[dt])
    deno = y if residual else xt - y
    loss = (torch.from_numpy(mask) * deno - torch.from_numpy(target)).abs().sum()
    loss.backward()

    assert y.dtype == torch.float32 and y.shape == x.shape
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j),
                               **OUT_TOL[dt])
    np.testing.assert_allclose(float(loss.detach()), float(loss_j),
                               rtol=2e-4 if dt == "f32" else 1e-2)
    for i in range(tm.nmid):
        _, bn = tm.mid(i)
        for buf, key in ((bn.running_mean, "mean"), (bn.running_var, "var")):
            np.testing.assert_allclose(
                buf.numpy(), np.asarray(bs_j[f"bn_{i}"][key]),
                err_msg=f"bn_{i} {key}", **STAT_TOL[dt])
    assert_grads_close(grads_tree(tm), grads_j, GRAD_TOL[dt])
    assert all(p.grad.dtype == torch.float32 for p in tm.parameters())
    assert not any(tfs.launch_counts().values())


def test_running_variance_is_the_biased_batch_variance():
    """new = 0.9 old + 0.1 batch with the biased variance, as the JAX
    package stores it; nn.BatchNorm2d would store H*W / (H*W - 1) of it."""
    H, W = 13, 20
    _, variables = perturbed_model(H, W, seed=30)
    tm = from_jax_variables(variables)
    x = torch.from_numpy(frames(1, H, W, seed=31))
    old = {k: v.clone() for k, v in tm.state_dict().items() if "running" in k}

    with torch.no_grad():
        z = tm.conv_0(torch.relu(tm.conv_in(x.permute(0, 3, 1, 2))))
        biased = z.var(dim=(0, 2, 3), unbiased=False)
        mean = z.mean(dim=(0, 2, 3))
    tfa.fused_train_apply(tm, x, store_dtype=torch.float32)
    np.testing.assert_allclose(
        tm.bn_0.running_var.numpy(),
        (0.9 * old["bn_0.running_var"] + 0.1 * biased).numpy(), rtol=1e-5)
    np.testing.assert_allclose(
        tm.bn_0.running_mean.numpy(),
        (0.9 * old["bn_0.running_mean"] + 0.1 * mean).numpy(), rtol=1e-4,
        atol=1e-6)
    unbiased = 0.9 * old["bn_0.running_var"] + 0.1 * biased * (H * W) / (H * W - 1)
    assert (tm.bn_0.running_var - unbiased).abs().max() > 1e-5


@pytest.mark.parametrize("residual,channels", [(False, 1), (True, 3)])
def test_module_training_mode_matches_jax_module(residual, channels):
    """The plain module in train(): batch statistics, biased running
    variance, and gradients, against the JAX module on XLA convs."""
    H, W = 16, 20
    model, variables = perturbed_model(H, W, seed=32, residual=residual,
                                       conv_impl="xla", channels=channels)
    x = frames(2, H, W, seed=33, C=channels)
    gref = np.random.default_rng(34).standard_normal(x.shape).astype(np.float32)

    def loss_fn(p):
        y, upd = model.apply({"params": p,
                              "batch_stats": variables["batch_stats"]},
                             jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
        return jnp.sum(y * gref), (y, upd["batch_stats"])

    (_, (y_j, bs_j)), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, variables["params"]))
    tm = from_jax_variables(variables, residual=residual,
                            conv_impl="xla").train()
    y = tm(torch.from_numpy(x))
    (y * torch.from_numpy(gref)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j),
                               **OUT_TOL["f32"])
    for i in range(tm.nmid):
        _, bn = tm.mid(i)
        for buf, key in ((bn.running_mean, "mean"), (bn.running_var, "var")):
            np.testing.assert_allclose(
                buf.numpy(), np.asarray(bs_j[f"bn_{i}"][key]),
                err_msg=f"bn_{i} {key}", **STAT_TOL["f32"])
    assert_grads_close(grads_tree(tm), grads_j, GRAD_TOL["f32"])
    # eval mode reads the running statistics it has just written
    tm.eval()
    want = np.asarray(model.apply({"params": variables["params"],
                                   "batch_stats": bs_j}, jnp.asarray(x),
                                  train=False))
    with torch.no_grad():
        np.testing.assert_allclose(tm(torch.from_numpy(x)).numpy(), want,
                                   **OUT_TOL["f32"])


def test_bf16_end_conv_delivers_an_f32_weight_gradient():
    """Forward, dX and the cotangent are bf16; dW is the f32 sum of the
    products of the bf16 operands, where autograd of a bf16 conv rounds dW
    to bf16."""
    rng = np.random.default_rng(35)
    x = torch.from_numpy(rng.random((1, 3, 40, 48)).astype(np.float32))
    w = torch.from_numpy((0.1 * rng.standard_normal((64, 3, 3, 3)))
                         .astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((1, 64, 40, 48)).astype(np.float32))
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    out = tfa._EndConvBf16.apply(xr, wr)
    assert out.dtype == torch.bfloat16
    out.backward(g)
    assert wr.grad.dtype == torch.float32
    assert torch.equal(xr.grad, xr.grad.bfloat16().float())  # a bf16 dX

    x16, w16, g16 = (v.bfloat16().double() for v in (x, w, g))
    exact = torch.nn.grad.conv2d_weight(x16, w.shape, g16, padding=1)
    scale = float(exact.abs().max())
    assert float((wr.grad.double() - exact).abs().max()) < 1e-5 * scale
    want_dx = torch.nn.grad.conv2d_input(x.shape, w16, g16, padding=1)
    np.testing.assert_allclose(xr.grad.float().numpy(), want_dx.numpy(),
                               rtol=0.02, atol=0.02)
    # what plain autograd of the bf16 conv would have delivered
    w_plain = w.bfloat16().requires_grad_()
    torch.nn.functional.conv2d(x.bfloat16(), w_plain, padding=1).backward(
        g.bfloat16())
    assert float((w_plain.grad.double() - exact).abs().max()) > 1e-4 * scale


def test_fused_train_apply_takes_the_plain_mid_stack():
    """``mid_stack=fused_mid_stack_plain`` is the same function on the CPU."""
    H, W = 13, 20
    _, variables = perturbed_model(H, W, seed=36)
    x = torch.from_numpy(frames(1, H, W, seed=37))
    outs = []
    for mid in (tfs.fused_mid_stack, tfs.fused_mid_stack_plain):
        tm = from_jax_variables(variables)
        y = tfa.fused_train_apply(tm, x, mid_stack=mid)
        y.abs().sum().backward()
        outs.append((y.detach(), tm.conv_1.weight.grad, tm.bn_2.running_var))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_fused_train_apply_leaves_the_callers_graph_alone():
    """No gradient reaches the input frame, and a second call starts from
    the updated running statistics."""
    H, W = 13, 20
    _, variables = perturbed_model(H, W, seed=38)
    tm = from_jax_variables(variables)
    x = torch.from_numpy(frames(1, H, W, seed=39))
    first = copy.deepcopy(tm)
    tfa.fused_train_apply(tm, x)
    assert not torch.equal(tm.bn_1.running_mean, first.bn_1.running_mean)
    with torch.no_grad():
        got = tfa.fused_eval_apply(tm, x)
        stale = tfa.fused_eval_apply(first, x)
    assert not torch.equal(got, stale)
    assert x.grad is None and not x.requires_grad
