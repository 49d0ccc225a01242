"""``model_dtype="bfloat16"``: the port's DnCNN and FastDVDnet with bf16
activations and f32 parameters against the JAX package's models built with
``dtype=jnp.bfloat16``, on the CPU.

- DnCNN, a 5-layer model with numpy-seeded BatchNorm parameters and running
  statistics, one 16x32 and one 13x21 frame, every
  ``conv_impl``. On an unpacked route ("xla", "pallas", "hybrid",
  "bf16res"; "packed", "packed_bf16", "fused" at the odd width) each
  convolution's output and each BatchNorm's output is bf16: the eval
  output, the training output and the moved running statistics, and every
  parameter's gradient of ``sum(y * g)`` are held at the bf16 graph's
  bounds (``tests/test_torch_bf16_graph.py``, ``chip_smoke.adapt_phase``):
  the port's distance from the JAX package's f32 model at most ``max(1.25
  x the JAX bf16 model's, one bf16 ulp)`` for the outputs; for the
  gradient, each parameter kind (the convolutions' weights, the BatchNorm
  scales, the BatchNorm biases, each kind as one vector) no farther from
  the f32 gradient than 1.25 times JAX's, ``|bf16 - f32| / |f32|``
  (measured 0.96-1.10 times), and within ``GRAD_VS_JAX`` of JAX's bf16
  gradient (measured at most 0.033). A single leaf's worst element is not
  held to a ratio: at these sizes a cotangent that rounds to the next bf16
  value moves it by 10-20 % of the leaf's largest, in both packages (two
  f32 routes of one package, "pallas" and "hybrid", lie 0.03-0.13 apart
  there). The JAX package runs its
  Pallas kernels in interpret mode on the CPU, the port its kernels' plain
  versions. On the packed routes at the even width the dtype changes
  nothing, in both packages: the port's bf16 model gives the f32 model's
  bits.
- FastDVDnet at its published widths on one 5-frame 16x16 window with a
  noise map: eval and training outputs at the same bound, every activation
  bf16 and the output f32, as in the JAX model.
- ``load_model`` builds both with ``model_dtype="bfloat16"`` and f32
  parameters, and refuses a name that is not a floating dtype.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from frame2frame_tpu.models import fastdvdnet as jf  # noqa: E402
from frame2frame_tpu.models.dncnn import DnCNN as JaxDnCNN  # noqa: E402
import frame2frame_tpu_torch as tpkg  # noqa: E402
from frame2frame_tpu_torch.models import fastdvdnet as tf  # noqa: E402
from frame2frame_tpu_torch.models.dncnn import (  # noqa: E402
    CONV_IMPLS,
    from_jax_variables,
)

from test_torch_fused_apply import frames, perturbed_model  # noqa: E402
from test_torch_fused_apply_train import grads_tree  # noqa: E402

BF16 = torch.bfloat16
RATIO = 1.25
CASES = [(16, 32, False, 70), (13, 21, True, 71)]
PACKED = ("packed", "packed_bf16", "fused")
GRAD_VS_JAX = 0.1
KINDS = {"conv": lambda p: p[0].startswith("conv"),
         "bn_scale": lambda p: p[1] == "scale",
         "bn_bias": lambda p: p[0].startswith("bn") and p[1] == "bias"}


def ulp(ref):
    """One bf16 ulp at the scale of ``ref``'s largest magnitude."""
    return 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)


def assert_bf16_bound(got, jax_bf16, f32, what):
    """The port's distance from f32 at most max(RATIO x JAX's, one ulp)."""
    f32 = np.asarray(f32, np.float64)
    d_port = np.abs(np.asarray(got, np.float64) - f32).max()
    d_jax = np.abs(np.asarray(jax_bf16, np.float64) - f32).max()
    assert d_port <= max(RATIO * d_jax, ulp(f32)), (what, d_port, d_jax)


def kind_rel(got, ref):
    """``{kind: |got - ref| / |ref|}``, each kind's leaves as one vector;
    ``got`` and ``ref`` JAX-layout gradient trees."""
    def by_kind(tree):
        out = {k: [] for k in KINDS}
        for path, v in jax.tree_util.tree_leaves_with_path(tree):
            key = tuple(p.key for p in path)
            for k, of in KINDS.items():
                if of(key):
                    out[k].append(np.asarray(v, np.float64).ravel())
        return {k: np.concatenate(v) for k, v in out.items()}

    g, r = by_kind(got), by_kind(ref)
    return {k: float(np.linalg.norm(g[k] - r[k]) / np.linalg.norm(r[k]))
            for k in KINDS}


def case_inputs(H, W, seed):
    x = frames(1, H, W, seed=seed + 100)
    gref = np.random.default_rng(seed).standard_normal(x.shape).astype(
        np.float32)
    return x, gref


@pytest.fixture(scope="module")
def models():
    """Each case's weights and the JAX package's f32 model on them (the
    "xla" route: every f32 route of the JAX model within f32 rounding of
    it)."""
    out = {}
    for H, W, residual, seed in CASES:
        variables = perturbed_model(H, W, seed=seed)[1]
        ev, y, _, grads = jax_run("xla", residual, jnp.float32, variables,
                                  *case_inputs(H, W, seed))
        out[(H, W)] = variables, (ev, y, grads)
    return out


def jax_run(impl, residual, dtype, variables, x, gref):
    """The JAX model's eval output, and its training output, moved
    statistics and parameter gradient of sum(y * gref)."""
    model = JaxDnCNN(channels=1, num_layers=5, residual=residual,
                     conv_impl=impl, dtype=dtype)
    ev = model.apply(variables, jnp.asarray(x), train=False)

    def loss_fn(p):
        y, upd = model.apply({"params": p,
                              "batch_stats": variables["batch_stats"]},
                             jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * gref), (y, upd["batch_stats"])

    (_, (y, stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, variables["params"]))
    return ev, y, stats, grads


def port_run(impl, residual, dtype, variables, x, gref):
    tm = from_jax_variables(variables, residual=residual, conv_impl=impl,
                            dtype=dtype)
    with torch.no_grad():
        ev = tm.eval()(torch.from_numpy(x))
    tm.train()
    y = tm(torch.from_numpy(x))
    (y.float() * torch.from_numpy(gref)).sum().backward()
    tm.eval()
    return ev, y.detach(), tm


@pytest.mark.parametrize("H,W,residual,seed", CASES)
@pytest.mark.parametrize("impl", CONV_IMPLS)
def test_dncnn_bf16_matches_jax(models, impl, H, W, residual, seed):
    variables, (ev_f, y_f, grads_f) = models[(H, W)]
    x, gref = case_inputs(H, W, seed)
    ev, y, tm = port_run(impl, residual, BF16, variables, x, gref)
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    if impl in PACKED and W % 2 == 0:
        # the packed routes take no dtype: the f32 model's bits
        ev32, y32, tm32 = port_run(impl, residual, torch.float32, variables,
                                   x, gref)
        assert torch.equal(ev, ev32) and torch.equal(y, y32)
        for (n, p), p32 in zip(tm.named_parameters(), tm32.parameters()):
            assert torch.equal(p.grad, p32.grad), n
        return
    ev_j, y_j, stats_j, grads_j = jax_run(impl, residual, jnp.bfloat16,
                                          variables, x, gref)
    # the output's dtype is the JAX model's: the noise in bf16, the
    # denoised image (x - noise) in f32
    want = torch.float32 if residual else BF16
    assert ev.dtype == y.dtype == want and ev_j.dtype == jnp.dtype(
        "float32" if residual else "bfloat16")
    assert_bf16_bound(ev.float().numpy(), ev_j.astype(jnp.float32), ev_f,
                      "eval")
    assert_bf16_bound(y.float().numpy(), y_j.astype(jnp.float32), y_f,
                      "train")
    for i in range(tm.nmid):
        _, bn = tm.mid(i)
        for buf, key in ((bn.running_mean, "mean"), (bn.running_var, "var")):
            np.testing.assert_allclose(
                buf.numpy(), np.asarray(stats_j[f"bn_{i}"][key]), rtol=1e-2,
                atol=1e-3, err_msg=f"bn_{i} {key}")
    ours, theirs = kind_rel(grads_tree(tm), grads_f), kind_rel(grads_j, grads_f)
    apart = kind_rel(grads_tree(tm), grads_j)
    for k in KINDS:
        assert ours[k] <= RATIO * theirs[k], (k, ours, theirs)
        assert apart[k] <= GRAD_VS_JAX, (k, apart)


@pytest.fixture(scope="module")
def fdv_window():
    """A 5-frame 16x16 grayscale window, its noise map and the weights."""
    rng = np.random.default_rng(5)
    frames5 = rng.random((1, 5, 16, 16, 1)).astype(np.float32)
    nm = np.full((1, 16, 16, 1), 25.0 / 255.0, np.float32)
    _, v = tf.init_fastdvdnet(3, channels=1)
    net = {"params": v["params"]["net"], "batch_stats": v["batch_stats"]["net"]}
    return frames5, nm, net


@pytest.mark.parametrize("train", [False, True])
def test_fastdvdnet_bf16_matches_jax(fdv_window, train):
    frames5, nm, net = fdv_window
    outs = {}
    for name, dt in (("bf16", jnp.bfloat16), ("f32", jnp.float32)):
        model = jf.FastDVDnet(channels=1, dtype=dt)
        fn = jax.jit(lambda v, f, m, model=model: model.apply(
            v, f, m, train=train, mutable=["batch_stats"] if train else False))
        out = fn(net, jnp.asarray(frames5), jnp.asarray(nm))
        outs[name] = out[0] if train else out
    assert outs["bf16"].dtype == jnp.float32
    tm = tf.from_jax_variables(net, dtype=BF16)
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    seen = []
    hooks = [m.register_forward_hook(lambda m, a, o: seen.append(o.dtype))
             for m in tm.modules() if isinstance(m, tf._Block)]
    tm.train(train)
    with torch.no_grad():
        got = tm(torch.from_numpy(frames5), torch.from_numpy(nm))
    for h in hooks:
        h.remove()
    assert got.dtype == torch.float32
    assert seen and all(d == BF16 for d in seen)
    assert_bf16_bound(got.numpy(), outs["bf16"], outs["f32"],
                      f"fastdvdnet train={train}")


def test_load_model_bf16():
    dn = tpkg.load_model({"net_name": "dncnn", "channels": 1,
                          "num_of_layers": 5, "model_dtype": "bfloat16",
                          "conv_impl": "pallas"}, device="cpu")
    assert dn.model.dtype == BF16 and dn.cfg.model_dtype == "bfloat16"
    assert all(p.dtype == torch.float32 for p in dn.model.parameters())
    x = frames(1, 12, 12, seed=3)
    out = dn.apply(x)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    fdv = tpkg.load_model({"net_name": "fastdvdnet", "channels": 1,
                           "model_dtype": "bfloat16"}, device="cpu")
    assert all(m.dtype == BF16 for m in fdv.model.modules()
               if isinstance(m, tf._Block))
    with pytest.raises(ValueError, match="model_dtype"):
        tpkg.load_model({"model_dtype": "int8"}, device="cpu")
