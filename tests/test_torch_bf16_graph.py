"""The bf16 graph of ``conv_impl="packed_bf16"``, rounding point by rounding
point: how far each package's bf16 op lies from an f32 evaluation of the same
op on the same inputs, the port's held to at most 1.25 times the JAX
package's.

A DnCNN of 4 layers (``conv_in``, two mid layers, ``conv_out``), 64 features,
one 16x32 frame; weights, BatchNorm parameters, frames and flow made with
numpy from a seed, the port's model built from the same tree with
``from_jax_variables``. The JAX side runs its XLA route (``F2F_PALLAS_DW``
unset: dW is the batch<->feature-swapped XLA convolution of
``frame2frame_tpu/ops/packed.py``), each op jitted as the engine's step is,
and is read after ``unpack_image`` (its BatchNorm's parameter cotangents come
out of ``tile_packed``'s transpose already folded per channel).

The inputs of every op are the JAX bf16 graph's own values at that point: the
activations of its forward, and the cotangents of one backward of the warped
L1 loss of ``OnlineDenoiser`` (residual model, ``deno = x - noise``). On
these inputs three evaluations of the op are compared:

- the JAX package's bf16 op (``conv3x3_packed_bf16`` and its VJP,
  ``PackedBatchNorm`` in training mode, ``nn.relu``);
- the port's bf16 op, as ``DnCNN.forward`` runs it on "packed_bf16"
  (``conv_function("bf16")``, ``_bn_bf16``, ``torch.relu``);
- the same op in f32, by plain PyTorch ops on the same values (f32 weights).

The points: each conv output, BatchNorm output and ReLU; each layer's dX, dW,
d``scale`` and d``bias``. A point's deviation is ``max |op - f32|``; the
port's must be at most ``max(1.25 * JAX's, ulp)``, with ``ulp`` one bf16 ulp
at the f32 value's scale, ``2 ** (floor(log2(max |f32|)) - 7)``: a single
rounding to bf16 lies within half of it, so where both packages round once
(or not at all, as a ReLU and the f32 dW do) the floor decides, and where
either rounds more the ratio does.

The last point is the parameters after 3 Adam updates of
``OnlineDenoiser.process_frame`` on "packed_bf16" and on the f32 "xla" route
in each package: the rms over the whole parameter vector of (bf16 route -
f32 route), over the rms of the f32 route's update. Taken per leaf, the
ratio of the two packages swings widely with the seed: a BatchNorm vector
has 64 entries, and the first Adam updates are close to ``lr * sign(g)``,
so a few entries near a sign change decide it. Over the whole vector it is
a stable measure.

``python tests/test_torch_bf16_graph.py`` prints every point's deviations.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from frame2frame_tpu.models.dncnn import DnCNN as JaxDnCNN  # noqa: E402
from frame2frame_tpu.models.dncnn import PackedBatchNorm  # noqa: E402
from frame2frame_tpu.ops import packed as jpacked  # noqa: E402
from frame2frame_tpu.ops.warp import (  # noqa: E402
    bilinear_warp_with_mask,
    occlusion_mask,
)
from frame2frame_tpu.train import online as jonline  # noqa: E402
from frame2frame_tpu_torch.models.dncnn import (  # noqa: E402
    _bn_bf16,
    from_jax_variables,
    to_jax_variables,
)
from frame2frame_tpu_torch.ops.conv3x3 import conv_function  # noqa: E402
from frame2frame_tpu_torch.train import online as tonline  # noqa: E402

SEED = 7
H, W, C = 16, 32, 64
NUM_LAYERS = 4
RATIO = 1.25
ADAM_UPDATES = 3
EPS = 1e-5
CONVS = ("conv_in", "conv_0", "conv_1", "conv_out")
BF16 = jnp.bfloat16

MIDS = range(NUM_LAYERS - 2)
POINTS = (
    ["conv_in.y", "relu_in.y"]
    + [f"{op}_{i}.y" for i in MIDS for op in ("conv", "bn", "relu")]
    + ["conv_out.y", "conv_out.dx", "conv_out.dw"]
    + [f"{op}_{i}.{d}" for i in reversed(MIDS)
       for op, d in (("relu", "dx"), ("bn", "dz"), ("bn", "dscale"),
                     ("bn", "dbias"), ("conv", "dx"), ("conv", "dw"))]
    + ["relu_in.dx", "conv_in.dw"])


def make_case():
    """(variables, cur, prev, flow): numpy, from SEED."""
    rng = np.random.default_rng(SEED)

    def kernel(cin, cout):
        return (rng.standard_normal((3, 3, cin, cout))
                / np.sqrt(9 * cin)).astype(np.float32)

    params = {"conv_in": {"kernel": kernel(1, C)},
              "conv_out": {"kernel": kernel(C, 1)}}
    stats = {}
    for i in range(NUM_LAYERS - 2):
        params[f"conv_{i}"] = {"kernel": kernel(C, C)}
        params[f"bn_{i}"] = {
            "scale": (1 + 0.2 * rng.standard_normal(C)).astype(np.float32),
            "bias": (0.1 * rng.standard_normal(C)).astype(np.float32)}
        stats[f"bn_{i}"] = {
            "mean": (0.1 * rng.standard_normal(C)).astype(np.float32),
            "var": (0.5 + rng.random(C)).astype(np.float32)}
    clean = rng.random((H, W, 1)).astype(np.float32)
    noise = 0.1 * rng.standard_normal((2, H, W, 1))
    cur = np.clip(clean + noise[0], 0, 1).astype(np.float32)
    prev = np.clip(np.roll(clean, 1, axis=1) + noise[1], 0, 1).astype(
        np.float32)
    flow = np.zeros((H, W, 2), np.float32)
    flow[..., 0] = -1.0 + 0.3 * rng.random((H, W))
    return {"params": params, "batch_stats": stats}, cur, prev, flow


# ---------------------------------------------------------------------------
# the JAX package's bf16 ops, jitted, in image space (pack / unpack around)


def _unpack(x2):
    return jpacked.unpack_image(x2).astype(jnp.float32)


@jax.jit
def jax_conv(x, w, g):
    y, vjp = jax.vjp(jpacked.conv3x3_packed_bf16,
                     jpacked.pack_image(x).astype(BF16), w)
    dx2, dw = vjp(jpacked.pack_image(g).astype(BF16))
    return _unpack(y), _unpack(dx2), dw


@jax.jit
def jax_bn(z, scale, bias, g):
    def f(z2, scale, bias):
        y, _ = PackedBatchNorm().apply(
            {"params": {"scale": scale, "bias": bias},
             "batch_stats": {"mean": jnp.zeros(C), "var": jnp.ones(C)}},
            z2, use_running_average=False, mutable=["batch_stats"])
        return y

    y, vjp = jax.vjp(f, jpacked.pack_image(z).astype(BF16), scale, bias)
    dz2, dscale, dbias = vjp(jpacked.pack_image(g).astype(BF16))
    return _unpack(y), _unpack(dz2), dscale, dbias


@jax.jit
def jax_relu(x, g):
    y, vjp = jax.vjp(jax.nn.relu, x.astype(BF16))
    (dx,) = vjp(g.astype(BF16))
    return y.astype(jnp.float32), dx.astype(jnp.float32)


def _np(*xs):
    return [np.asarray(x, np.float32) for x in xs]


# ---------------------------------------------------------------------------
# the port's bf16 ops, as DnCNN.forward runs them on "packed_bf16"


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


def _grad(t):
    return t.grad.float().numpy()


def torch_conv(x, w, g):
    xt = _t(x, torch.bfloat16).requires_grad_()
    wt = _t(w).requires_grad_()
    y = conv_function("bf16")(xt, wt)
    y.backward(_t(g, torch.bfloat16))
    return y.detach().float().numpy(), _grad(xt), _grad(wt)


def torch_bn(bn, z, g):
    zt = _t(z, torch.bfloat16).requires_grad_()
    bn.zero_grad()
    y, _ = _bn_bf16(bn, zt, True)
    y.backward(_t(g, torch.bfloat16))
    return (y.detach().float().numpy(), _grad(zt), _grad(bn.weight),
            _grad(bn.bias))


def torch_relu(x, g):
    xt = _t(x, torch.bfloat16).requires_grad_()
    y = torch.relu(xt)
    y.backward(_t(g, torch.bfloat16))
    return y.detach().float().numpy(), _grad(xt)


# ---------------------------------------------------------------------------
# the same ops in f32


def f32_conv(x, w, g):
    xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
    y = F.conv2d(xt.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1),
                 padding=1).permute(0, 2, 3, 1)
    y.backward(_t(g))
    return y.detach().numpy(), _grad(xt), _grad(wt)


def f32_bn(z, scale, bias, g):
    zt = _t(z).requires_grad_()
    st, bt = _t(scale).requires_grad_(), _t(bias).requires_grad_()
    m = zt.mean((0, 1, 2))
    v = (zt * zt).mean((0, 1, 2)) - m * m
    inv = torch.rsqrt(v + EPS) * st
    y = zt * inv + (bt - m * inv)
    y.backward(_t(g))
    return y.detach().numpy(), _grad(zt), _grad(st), _grad(bt)


def f32_relu(x, g):
    xt = _t(x).requires_grad_()
    y = torch.relu(xt)
    y.backward(_t(g))
    return y.detach().numpy(), _grad(xt)


# ---------------------------------------------------------------------------


def warped_loss_cotangent(x, noise, prev, flow):
    """d loss / d noise of the engine's summed L1 loss on the residual
    model's ``deno = x - noise``."""
    warped, mask = bilinear_warp_with_mask(jnp.asarray(prev),
                                           jnp.asarray(flow))
    mask = occlusion_mask(jnp.asarray(flow), mask)
    target = mask * warped

    def loss(n):
        return jnp.sum(jnp.abs(mask * (x - n) - target))

    return np.asarray(jax.grad(loss)(jnp.asarray(noise)), np.float32)


@pytest.fixture(scope="module")
def case():
    assert not jpacked._PALLAS_DW, "the JAX side runs its XLA dW route"
    return make_case()


@pytest.fixture(scope="module")
def points(case):
    return rounding_points(case)


def rounding_points(case):
    """{point: (port, jax, f32)} over the graph's rounding points."""
    variables, cur, prev, flow = case
    p = variables["params"]
    tm = from_jax_variables(variables, residual=True,
                            conv_impl="packed_bf16")
    out = {}

    def record(name, port, jx, ref):
        out[name] = (port, jx, ref)

    x = cur[None]
    zeros = np.zeros
    # forward: each op on the JAX bf16 graph's own activations
    acts = {}
    h = x
    for li, name in enumerate(CONVS):
        w = p[name]["kernel"]
        g0 = zeros(h.shape[:3] + (w.shape[3],), np.float32)
        jy = _np(*jax_conv(h, w, g0))[0]
        record(f"{name}.y", torch_conv(h, w, g0)[0], jy, f32_conv(h, w, g0)[0])
        acts[name] = (h, jy)
        if name == "conv_out":
            break
        z = jy
        if li > 0:
            i = li - 1
            s, b = p[f"bn_{i}"]["scale"], p[f"bn_{i}"]["bias"]
            jz = _np(*jax_bn(z, s, b, zeros(z.shape, np.float32)))[0]
            record(f"bn_{i}.y", torch_bn(tm.mid(i)[1], z, zeros(z.shape))[0],
                   jz, f32_bn(z, s, b, zeros(z.shape, np.float32))[0])
            acts[f"bn_{i}"] = z
            z = jz
        relu = "relu_in" if li == 0 else f"relu_{li - 1}"
        jh = _np(*jax_relu(z, zeros(z.shape, np.float32)))[0]
        record(f"{relu}.y", torch_relu(z, zeros(z.shape))[0], jh,
               f32_relu(z, zeros(z.shape, np.float32))[0])
        acts[relu] = z
        h = jh

    # backward: each op on the JAX bf16 graph's own cotangents
    g = warped_loss_cotangent(x, acts["conv_out"][1], prev, flow)
    for li in range(len(CONVS) - 1, -1, -1):
        name = CONVS[li]
        h, _ = acts[name]
        w = p[name]["kernel"]
        t, j, r = (torch_conv(h, w, g), _np(*jax_conv(h, w, g)),
                   f32_conv(h, w, g))
        if li > 0:
            record(f"{name}.dx", t[1], j[1], r[1])
        record(f"{name}.dw", t[2], j[2], r[2])
        g = j[1]
        if li == 0:
            break
        relu = "relu_in" if li == 1 else f"relu_{li - 2}"
        z = acts[relu]
        t, j, r = torch_relu(z, g), _np(*jax_relu(z, g)), f32_relu(z, g)
        record(f"{relu}.dx", t[1], j[1], r[1])
        g = j[1]
        if li > 1:
            i = li - 2
            z = acts[f"bn_{i}"]
            s, b = p[f"bn_{i}"]["scale"], p[f"bn_{i}"]["bias"]
            t = torch_bn(tm.mid(i)[1], z, g)
            j = _np(*jax_bn(z, s, b, g))
            r = f32_bn(z, s, b, g)
            for k, d in enumerate(("dz", "dscale", "dbias"), start=1):
                record(f"bn_{i}.{d}", t[k], j[k], r[k])
            g = j[1]
    assert sorted(out) == sorted(POINTS)
    return out


def bf16_ulp(scale):
    """One bf16 ulp at ``scale``: 8 significant bits."""
    return 2.0 ** (np.floor(np.log2(scale)) - 7)


def deviations(port, jx, ref):
    """(port's max |op - f32|, JAX's, the bound on the port's, the f32
    value's scale)."""
    dev_port = float(np.abs(port - ref).max())
    dev_jax = float(np.abs(jx - ref).max())
    scale = float(np.abs(ref).max())
    return dev_port, dev_jax, max(RATIO * dev_jax, bf16_ulp(scale)), scale


@pytest.mark.parametrize("point", POINTS)
def test_port_rounding_no_farther_from_f32_than_jax(points, point):
    port, jx, ref = points[point]
    assert port.shape == jx.shape == ref.shape
    dev_port, dev_jax, bound, scale = deviations(port, jx, ref)
    assert scale > 0
    assert dev_port <= bound, (
        f"{point}: port {dev_port:.3e} from f32, JAX {dev_jax:.3e} "
        f"(bound {bound:.3e}, value scale {scale:.3e})")


def _flat(params):
    return np.concatenate([np.asarray(v, np.float32).ravel() for _, v in
                           sorted(jax.tree_util.tree_leaves_with_path(params),
                                  key=lambda kv: jax.tree_util.keystr(kv[0]))])


def test_params_after_adam_updates_no_farther_from_f32_than_jax(case):
    variables, cur, prev, flow = case
    p0 = _flat(variables["params"])

    def jax_run(impl):
        eng = jonline.OnlineDenoiser(
            JaxDnCNN(channels=1, num_layers=NUM_LAYERS, residual=True,
                     conv_impl=impl),
            variables, iters=ADAM_UPDATES, residual_model=True)
        eng.process_frame(cur, prev, flow)
        return _flat(eng.params)

    def torch_run(impl):
        model = from_jax_variables(variables, residual=True, conv_impl=impl)
        eng = tonline.OnlineDenoiser(model, variables, iters=ADAM_UPDATES,
                                     residual_model=True, device="cpu")
        eng.process_frame(cur, prev, flow)
        return _flat(to_jax_variables(eng.model)["params"])

    def rms(v):
        return float(np.sqrt(np.mean(v.astype(np.float64) ** 2)))

    jf, jb = jax_run("xla"), jax_run("packed_bf16")
    tf, tb = torch_run("xla"), torch_run("packed_bf16")
    step = rms(jf - p0)
    assert step > 0
    assert rms(tf - jf) < 1e-2 * step, "the f32 routes of both packages agree"
    dev_port, dev_jax = rms(tb - tf) / step, rms(jb - jf) / step
    assert dev_port <= RATIO * dev_jax, (
        f"after {ADAM_UPDATES} Adam updates: port {dev_port:.3f} of an "
        f"update from its f32 route, JAX {dev_jax:.3f}")


if __name__ == "__main__":
    print(f"{'point':14s} {'port':>10s} {'jax':>10s} {'bound':>10s} "
          f"{'scale':>10s}")
    for name, vals in rounding_points(make_case()).items():
        print(f"{name:14s}" + "".join(f" {v:10.3e}"
                                      for v in deviations(*vals)))
