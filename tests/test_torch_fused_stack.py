"""Port kernels (frame2frame_tpu_torch/ops/fused_stack.py) vs the JAX Pallas
kernels they replace.

On the CPU the port's wrappers compute their plain PyTorch versions; the
Pallas kernels run in interpret mode, fed through the pair-packed flat
layout (``pack_image`` -> ``to_flat``) and read back (``from_flat`` ->
``unpack_image``). Same numpy-seeded inputs on both sides. Tolerances:
rtol = atol = 2e-4 with f32 storage (as tests/test_fused_stack.py), and
rtol 0.03 / atol 0.02 on a bf16 chain, where the JAX kernel also rounds its
weights to bf16.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from frame2frame_tpu.ops import fused_stack as jfs  # noqa: E402
from frame2frame_tpu.ops.packed import pack_image, unpack_image  # noqa: E402
from frame2frame_tpu_torch.ops import fused_stack as tfs  # noqa: E402

TOL = {"f32": dict(rtol=2e-4, atol=2e-4), "bf16": dict(rtol=0.03, atol=0.02)}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def make_inputs(B, H, W, seed, relu_input):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, 64)).astype(np.float32)
    if relu_input:
        x = np.maximum(x, 0.0)
    w = (rng.standard_normal((3, 3, 64, 64)) * 0.06).astype(np.float32)
    s = (1.0 + 0.2 * rng.standard_normal(64)).astype(np.float32)
    b = (0.3 * rng.standard_normal(64)).astype(np.float32)
    return x, w, s, b


def jax_layer(kernel, x, w2, vecs, dt, stack, odd):
    """Run a JAX flat-layout kernel on NHWC frames x (B, H, W, 64)."""
    B, H, W, _ = x.shape
    W2 = W // 2
    th = jfs.default_tile_h(W2)
    a2 = pack_image(jnp.asarray(x, JDT[dt]))
    if stack:
        T_f = jfs.stack_tiles(H, th)
        g = jfs.Geom(B * T_f * th, W2, th)
        flat = jfs.to_flat_stack(a2, g, T_f)
        out, = kernel(flat, w2, *vecs, g, odd=odd, stack=(T_f, H))
        back = jfs.from_flat_stack(out, H, g, T_f)
    else:
        assert B == 1
        g = jfs.Geom(H, W2, th)
        out, = kernel(jfs.to_flat(a2, g), w2, *vecs, g, odd=odd)
        back = jfs.from_flat(out, g)
    return np.asarray(unpack_image(back).astype(jnp.float32))


def pack(w, odd):
    return jfs.pack_kernel_odd(w) if odd else jfs.pack_kernel_flat(w)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("odd,stack", [(True, False), (False, False),
                                       (True, True), (False, True)])
@pytest.mark.parametrize("H,W", [(16, 32), (13, 20)])
def test_fwd_layer_matches_pallas(H, W, odd, stack, dt):
    """fwd_layer (eval affine route, emit_stats=False) in both JAX forms,
    single frame and stacked batch: the affine + ReLU is applied before the
    zero padding, so relu(b) does not leak into the border."""
    B = 3 if stack else 1
    x, w, s, b = make_inputs(B, H, W, seed=H + W, relu_input=False)
    want = jax_layer(
        lambda *a, **k: jfs.fwd_layer(*a, emit_stats=False, **k), x,
        pack(jnp.asarray(w), odd),
        (jfs.tile_vec(jnp.asarray(s)), jfs.tile_vec(jnp.asarray(b))),
        dt, stack, odd)
    tfs.reset_launch_counts()
    got = tfs.fwd_layer(torch.from_numpy(x).to(TDT[dt]), torch.from_numpy(w),
                        torch.from_numpy(s), torch.from_numpy(b))
    assert got.dtype == TDT[dt] and got.shape == x.shape
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dt])
    assert tfs.launch_counts() == {"fwd_layer": 0, "fwd_layer_eval": 0}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("odd,stack", [(True, False), (False, False),
                                       (True, True), (False, True)])
@pytest.mark.parametrize("H,W", [(16, 32), (13, 20)])
def test_fwd_layer_eval_matches_pallas(H, W, odd, stack, dt):
    """fwd_layer_eval (act route): the JAX kernel takes the BN scale folded
    into its weights, the port takes it separately."""
    B = 2 if stack else 1
    x, w, s, b = make_inputs(B, H, W, seed=2 * H + W, relu_input=True)
    want = jax_layer(
        jfs.fwd_layer_eval, x, pack(jnp.asarray(w * s), odd),
        (jfs.tile_vec(jnp.asarray(b)),), dt, stack, odd)
    tfs.reset_launch_counts()
    got = tfs.fwd_layer_eval(torch.from_numpy(x).to(TDT[dt]),
                             torch.from_numpy(w), torch.from_numpy(s),
                             torch.from_numpy(b))
    assert got.dtype == TDT[dt] and got.shape == x.shape
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dt])
    assert tfs.launch_counts() == {"fwd_layer": 0, "fwd_layer_eval": 0}


def test_affine_from_stats_matches_jax():
    rng = np.random.default_rng(0)
    mean, gamma, beta = (rng.standard_normal(64).astype(np.float32)
                         for _ in range(3))
    var = rng.random(64).astype(np.float32) + 0.01
    want = jfs._affine_from_stats(*(jnp.asarray(v)
                                    for v in (mean, var, gamma, beta)))
    got = tfs._affine_from_stats(*(torch.from_numpy(v)
                                   for v in (mean, var, gamma, beta)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("bad", ["channels", "dtype", "layout", "weights",
                                 "vector"])
def test_wrappers_reject_bad_inputs(bad):
    x = torch.zeros(1, 4, 6, 64)
    w, v = torch.zeros(3, 3, 64, 64), torch.zeros(64)
    if bad == "channels":
        x = torch.zeros(1, 4, 6, 32)
    elif bad == "dtype":
        x = x.half()
    elif bad == "layout":
        x = torch.zeros(1, 64, 4, 6).permute(0, 2, 3, 1)
    elif bad == "weights":
        w = torch.zeros(64, 64, 3, 3)
    else:
        v = torch.zeros(64, dtype=torch.float64)
    with pytest.raises((ValueError, TypeError)):
        tfs.fwd_layer(x, w, v, v)
    with pytest.raises((ValueError, TypeError)):
        tfs.fwd_layer_eval(x, w, v, v)
