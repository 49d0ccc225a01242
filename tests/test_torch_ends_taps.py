"""The inside-out formulation of the port's ``last_loss_fwd`` kernel
(frame2frame_tpu_torch/csrc/fused_ends.cu ``last_fwd_k``), as a plain,
test-only PyTorch function, against the port's plain version
(``last_loss_fwd_plain``) and the JAX package's Pallas kernel in interpret
mode (frame2frame_tpu.ops.fused_ends.last_loss_fwd, called as
tests/test_torch_fused_ends.py calls it).

The kernel computes ``a = relu(s * z + b)`` (a rounded product and a
rounded sum), zeroes ``a`` outside the image by position, takes the nine tap
products of every pixel as one matrix product ``q = a . W16`` (64 channels
by taps 0-8 and seven zero columns; bf16 operands and f32 sums on the
tensor cores), and gathers ``noise[y, x] = sum_t q[(y, x) + off_t][t]`` in
tap order. ``b`` is drawn with ``relu(b) > 0`` in every channel, so a
formulation that pads ``z`` with zeros and not ``a`` differs at the border;
the last test shows that this one would be caught.

Tolerances. Against ``last_loss_fwd_plain`` with the same operand rounding
(``mma_bf16``): f32 sums of the same products in another order, 1e-5 of the
largest noise value and rtol 1e-5 for the loss. Against the JAX kernel: the
bounds of tests/test_torch_fused_ends.py (f32 chain rtol = atol = 2e-4 and
loss rtol 1e-5; bf16 chain rtol 0.03 / atol 0.02 and loss rtol 2e-3), with
the JAX kernel's own operand rounding (the chain's dtype).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from frame2frame_tpu.ops import fused_ends as jfe  # noqa: E402
from frame2frame_tpu.ops import fused_stack as jfs  # noqa: E402
from frame2frame_tpu.ops.packed import pack_image, unpack_image  # noqa: E402
from frame2frame_tpu.train import flat_step as jflat  # noqa: E402
from frame2frame_tpu_torch.ops import fused_ends as tfe  # noqa: E402
from frame2frame_tpu_torch.ops._common import _round_operand  # noqa: E402
from frame2frame_tpu_torch.train.flat_step import prep_frame  # noqa: E402

C = 64
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
ACT_TOL = {"f32": dict(rtol=2e-4, atol=2e-4), "bf16": dict(rtol=0.03, atol=0.02)}
LOSS_RTOL = {"f32": 1e-5, "bf16": 2e-3}
SAME_ROUNDING_RTOL = 1e-5
CASES = [(H, W, dt) for H, W in ((13, 20), (16, 32)) for dt in ("f32", "bf16")]


def taps_inside_out(z, s, b, w, aux_c, aux_m, mma_bf16, pad_z=False):
    """``last_loss_fwd`` as the kernel forms it: (noise (H, W), loss).

    z: (1, H, W, 64) in the chain's dtype; s, b: (64,); w: (3, 3, 64, 1);
    aux_c, aux_m: (H, W) f32. ``mma_bf16`` rounds ``a`` and the weights to
    bf16 as the kernel does; else ``a`` stays f32 and the weights are
    rounded to the chain's dtype, as in ``last_loss_fwd_plain``. ``pad_z``
    zeroes z, not a, outside the image: the wrong border, for the last
    test."""
    _, H, W, _ = z.shape
    zp = z.float()[0]
    if pad_z:
        zp = torch.nn.functional.pad(zp, (0, 0, 1, 1, 1, 1))
    a = torch.relu(zp * s + b)
    if not pad_z:  # a outside the image is zero by position, not relu(b)
        a = torch.nn.functional.pad(a, (0, 0, 1, 1, 1, 1))
    a = _round_operand(a, mma_bf16)
    w16 = torch.zeros(C, 16)
    w16[:, :9] = _round_operand(w.to(z.dtype), mma_bf16).reshape(9, C).T
    q = (a.reshape(-1, C) @ w16).reshape(H + 2, W + 2, 16)
    noise = torch.zeros(H, W)
    for t in range(9):
        dy, dx = divmod(t, 3)
        noise = noise + q[dy:dy + H, dx:dx + W, t]
    return noise, (aux_c - aux_m * noise).abs().sum()


def inputs(H, W, dt, seed):
    """The frame constants as the flat step builds them, and z, w, s, b
    with relu(b) > 0, as numpy."""
    rng = np.random.default_rng(seed)
    cur = rng.random((H, W, 1)).astype(np.float32)
    mask = (rng.random((H, W, 1)) > 0.2).astype(np.float32)
    target = mask * rng.random((H, W, 1)).astype(np.float32)
    z = np.array(jnp.asarray(rng.standard_normal((1, H, W, C)), JDT[dt])
                 .astype(jnp.float32))
    w = (0.06 * rng.standard_normal((3, 3, C, 1))).astype(np.float32)
    s = (1.0 + 0.2 * rng.standard_normal(C)).astype(np.float32)
    b = (0.05 + np.abs(0.3 * rng.standard_normal(C))).astype(np.float32)
    return cur, mask, target, z, w, s, b


def torch_args(cur, mask, target, z, w, s, b, dt):
    data = prep_frame(torch.from_numpy(cur), torch.from_numpy(mask),
                      torch.from_numpy(target), store_dtype=TDT[dt])
    return (torch.from_numpy(z).to(TDT[dt]), torch.from_numpy(s),
            torch.from_numpy(b), torch.from_numpy(w), data["aux_c"],
            data["aux_m"])


@pytest.mark.parametrize("mma_bf16", [True, False])
@pytest.mark.parametrize("H,W,dt", CASES)
def test_inside_out_matches_plain(H, W, dt, mma_bf16):
    args = torch_args(*inputs(H, W, dt, seed=H * W), dt)
    noise, loss = taps_inside_out(*args, mma_bf16=mma_bf16)
    want_noise, want_loss = tfe.last_loss_fwd_plain(*args, mma_bf16=mma_bf16)
    scale = float(want_noise.abs().max())
    assert scale > 0.1
    np.testing.assert_allclose(noise.numpy(), want_noise.numpy(), rtol=0,
                               atol=SAME_ROUNDING_RTOL * scale)
    np.testing.assert_allclose(float(loss), float(want_loss),
                               rtol=SAME_ROUNDING_RTOL)


@pytest.mark.parametrize("H,W,dt", CASES)
def test_inside_out_matches_pallas(H, W, dt):
    cur, mask, target, z, w, s, b = inputs(H, W, dt, seed=H + W)
    g = jfs.Geom(H, W // 2, jfs.default_tile_h(W // 2))
    data_j = jflat.prep_frame(jnp.asarray(cur), jnp.asarray(mask),
                              jnp.asarray(target), g, store_dtype=JDT[dt])
    noise_j, _, lossp = jfe.last_loss_fwd(
        jfs.to_flat(pack_image(jnp.asarray(z, JDT[dt])), g),
        data_j["aux_c"], data_j["aux_m"],
        jfs.pack_kernel_odd(jfe.embed_w_out(jnp.asarray(w))),
        jfs.tile_vec(jnp.asarray(s)), jfs.tile_vec(jnp.asarray(b)), g)
    noise_j = np.asarray(unpack_image(jfs.from_flat(noise_j, g))
                         .astype(jnp.float32))[0, :, :, 0]
    noise, loss = taps_inside_out(
        *torch_args(cur, mask, target, z, w, s, b, dt), mma_bf16=False)
    np.testing.assert_allclose(noise.numpy(), noise_j, **ACT_TOL[dt])
    np.testing.assert_allclose(float(loss), float(jnp.sum(lossp)),
                               rtol=LOSS_RTOL[dt])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_padding_z_instead_of_a_is_caught(dt):
    """With relu(b) > 0, zero padding of z in place of a moves every border
    pixel of the noise far beyond the tolerance above, and no inner one."""
    args = torch_args(*inputs(16, 32, dt, seed=5), dt)
    good, _ = taps_inside_out(*args, mma_bf16=True)
    bad, _ = taps_inside_out(*args, mma_bf16=True, pad_z=True)
    d = (good - bad).abs()
    scale = float(good.abs().max())
    border = torch.ones_like(d, dtype=torch.bool)
    border[1:-1, 1:-1] = False
    assert float(d[border].min()) > 100 * SAME_ROUNDING_RTOL * scale
    assert float(d[~border].max()) == 0.0
