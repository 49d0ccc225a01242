"""The mid stack and the eval forward of one frame split by rows
(frame2frame_tpu_torch/ops/fused_spatial.py, models/fused_apply.py; CPU
meshes, the kernels' plain versions) vs the JAX package's
``ops/fused_spatial.py`` on its virtual CPU devices, Pallas in interpret
mode.

- ``fused_mid_stack_spatial``, f32, L=3, H=28, W=32 (the case of
  tests/test_parallel.py:385-437), at D = 1 and 2 against the JAX function
  at the same D, and at D = 1..4 against the port's unsplit
  ``fused_mid_stack``: the loss value rtol 1e-6, outputs and statistics
  atol 1e-5, weight and BN gradients atol 5e-3 / rtol 1e-4, the input's
  gradient atol 1e-4; the loss value is taken in float64 from the outputs
  on both sides, so that it compares them and not two f32 summations;
- ``split_frame`` / ``gather_frame``, ``pad_h`` and its refusals;
- each slab's launches run with its slab's device current: ``_per_slab``
  on stand-in slabs of two CUDA device indices (``torch.cuda.device``
  faked), and every kernel call of the split stack's forward and backward
  and of both eval routes inside its slab's ``_current`` context.
"""

import contextlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from frame2frame_tpu.ops import fused_spatial as jsp  # noqa: E402
from frame2frame_tpu.ops.packed import pack_image, unpack_image  # noqa: E402
from frame2frame_tpu_torch.ops import fused_spatial as tsp  # noqa: E402
from frame2frame_tpu_torch.ops import fused_stack as tfs  # noqa: E402
from frame2frame_tpu_torch.parallel.spatial import make_space_mesh  # noqa: E402

L, H, W, TH = 3, 28, 32, 8
GRAD_TOL = dict(atol=5e-3, rtol=1e-4)


def stack_inputs():
    rng = np.random.default_rng(0)
    return (rng.normal(0, 0.1, (L, 3, 3, 64, 64)).astype(np.float32),
            (rng.random((L, 64)) + 0.5).astype(np.float32),
            rng.normal(0, 0.1, (L, 64)).astype(np.float32),
            np.maximum(rng.normal(0, 1, (1, H, W, 64)), 0).astype(np.float32))


def jax_mesh(D):
    return Mesh(np.array(jax.devices()[:D]), ("space",))


@pytest.fixture(scope="module")
def jax_stack():
    """(value, a, means, vars, grads) of the JAX split stack, D = 1 and 2."""
    ws, gammas, betas, a1 = (jnp.asarray(v) for v in stack_inputs())
    a1 = pack_image(a1)
    out = {}
    for D in (1, 2):
        mesh = jax_mesh(D)
        Hp = jsp.pad_h(H, D, TH)
        a1p = jnp.pad(a1, ((0, 0), (0, Hp - H), (0, 0), (0, 0)))

        def loss(ws, gammas, betas, a1p, mesh=mesh):
            a, m, v = jsp.fused_mid_stack_spatial(ws, gammas, betas, a1p, H,
                                                  TH, jnp.float32, mesh)
            a = unpack_image(a[:, :H])
            return jnp.sum(a ** 2) + jnp.sum(m * v), (a, m, v)

        (_, (a, m, v)), g = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2, 3), has_aux=True))(ws, gammas, betas, a1p)
        da1 = unpack_image(g[3][:, :H])
        a, m, v = (np.asarray(x) for x in (a, m, v))
        out[D] = [value(a, m, v), a, m, v] + [
            [np.asarray(x) for x in g[:3]] + [np.asarray(da1)]]
    return out


def value(a, m, v):
    """The loss of the outputs, in float64."""
    a, m, v = (np.asarray(x, np.float64) for x in (a, m, v))
    return float(np.sum(a * a) + np.sum(m * v))


def port_stack(mid_stack):
    """(value, a, means, vars, grads) of the port's stack, f32."""
    t = [torch.from_numpy(v).requires_grad_() for v in stack_inputs()]
    a, m, v = mid_stack(*t)
    a = a[:, :H]
    grads = torch.autograd.grad((a * a).sum() + (m * v).sum(), t)
    a, m, v = (x.detach().numpy() for x in (a, m, v))
    return [value(a, m, v), a, m, v] + [[g.numpy() for g in grads]]


def split_stack(D):
    mesh = make_space_mesh(D, device="cpu")

    def mid_stack(ws, gammas, betas, a1):
        Hp = tsp.pad_h(H, D)
        a1p = torch.nn.functional.pad(a1, (0, 0, 0, 0, 0, Hp - H))
        return tsp.fused_mid_stack_spatial(ws, gammas, betas, a1p, H,
                                           torch.float32, mesh)
    return port_stack(mid_stack)


def assert_stack_close(got, want, what):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, err_msg=what)
    for x, y, name in zip(got[1:4], want[1:4], ("a", "means", "vars")):
        np.testing.assert_allclose(x, y, atol=1e-5, err_msg=f"{what} {name}")
    for x, y, name in zip(got[4][:3], want[4][:3],
                          ("dW", "dgamma", "dbeta")):
        np.testing.assert_allclose(x, y, err_msg=f"{what} {name}", **GRAD_TOL)
    np.testing.assert_allclose(got[4][3], want[4][3], atol=1e-4,
                               err_msg=f"{what} da1")


@pytest.mark.parametrize("D", [1, 2])
def test_fused_mid_stack_spatial_matches_jax(D, jax_stack):
    tfs.reset_launch_counts()
    assert_stack_close(split_stack(D), jax_stack[D], f"D={D}")
    assert not any(tfs.launch_counts().values())


@pytest.mark.parametrize("D", [1, 2, 3, 4])
def test_fused_mid_stack_spatial_matches_unsplit(D):
    unsplit = port_stack(lambda *t: tfs.fused_mid_stack(*t, torch.float32))
    assert_stack_close(split_stack(D), unsplit, f"D={D}")


def test_split_and_gather_frame():
    x = torch.arange(2 * 6 * 3, dtype=torch.float32).view(2, 6, 3, 1)
    mesh = make_space_mesh(3, device="cpu")
    slabs = tsp.split_frame(x, mesh)
    assert [tuple(s.shape) for s in slabs] == [(2, 4, 3, 1)] * 3
    assert torch.equal(slabs[0][:, 0], torch.zeros(2, 3, 1))
    assert torch.equal(slabs[1][:, 0], x[:, 1])
    assert torch.equal(slabs[1][:, 3], x[:, 4])
    assert torch.equal(slabs[2][:, 3], torch.zeros(2, 3, 1))
    assert torch.equal(tsp.gather_frame(slabs), x)
    # each slab owns its memory: an exchange writes halo rows in place
    slabs[1][:, 1] = -1.0
    assert torch.equal(tsp.gather_frame(slabs)[:, 2], torch.full((2, 3, 1),
                                                                  -1.0))
    tsp._exchange(slabs)
    assert torch.equal(slabs[0][:, 3], slabs[1][:, 1])
    assert torch.equal(tsp.gather_frame(slabs, halo=0)[:, :4], slabs[0])


def test_pad_h():
    assert [tsp.pad_h(28, d) for d in (1, 2, 3, 4)] == [28, 28, 30, 28]
    assert tsp.pad_h(541, 2) == 542
    with pytest.raises(ValueError, match="slab"):
        tsp.pad_h(5, 4)  # 8 rows: the last slab would hold pad rows only
    assert tsp._valid_bounds(0, 14, 28) == (1, 29, 1, 15)
    assert tsp._valid_bounds(1, 14, 28) == (-13, 15, 1, 15)
    assert tsp._valid_bounds(2, 10, 28) == (-19, 9, 1, 9)  # 2 pad rows
    with pytest.raises(ValueError, match="first device"):
        tsp.fused_mid_stack_spatial(
            torch.zeros(1, 3, 3, 64, 64), torch.ones(1, 64),
            torch.zeros(1, 64), torch.zeros(1, 4, 8, 64), 4, torch.float32,
            (torch.device("meta"),))


class _FakeCudaDevice:
    """Stands in for ``torch.cuda.device``: records the index made current."""
    current = []

    def __init__(self, device):
        self.index = torch.device(device).index

    def __enter__(self):
        self.current.append(self.index)

    def __exit__(self, *exc):
        self.current.pop()


def test_per_slab_makes_each_slab_device_current(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device", _FakeCudaDevice)
    slabs = [types.SimpleNamespace(device=torch.device("cuda", k))
             for k in (1, 0, 2)]
    seen = tsp._per_slab(lambda x, k: (k, list(_FakeCudaDevice.current)),
                         slabs, ["a", "b", "c"])
    assert seen == [("a", [1]), ("b", [0]), ("c", [2])]
    assert _FakeCudaDevice.current == []
    # the CPU has no current device to set
    cpu = types.SimpleNamespace(device=torch.device("cpu"))
    assert tsp._per_slab(lambda x: list(_FakeCudaDevice.current), [cpu]) == [[]]


def test_every_slab_launch_runs_with_its_device_current(monkeypatch):
    current, calls = [], []

    @contextlib.contextmanager
    def recording_current(device):
        current.append(device)
        yield
        current.pop()

    def checked(name, kernel):
        def launch(x, *args, **kwargs):
            assert current and current[-1] == x.device, name
            assert kwargs["valid_bounds"] is not None, name
            calls.append(name)
            return kernel(x, *args, **kwargs)
        return launch

    monkeypatch.setattr(tsp, "_current", recording_current)
    for name in ("fwd_layer", "fwd_layer_eval", "fwd_layer_train",
                 "bwd_layer"):
        monkeypatch.setattr(tsp, name, checked(name, getattr(tsp, name)))
    D = 2
    split_stack(D)
    assert calls == ["fwd_layer_train"] * (D * L) + ["bwd_layer"] * (D * L)
    ws, gammas, betas, a1 = (torch.from_numpy(v) for v in stack_inputs())
    s, b = gammas, betas
    mesh = make_space_mesh(D, device="cpu")
    for route, name in (("affine", "fwd_layer"), ("act", "fwd_layer_eval")):
        calls.clear()
        tsp.eval_mid_stack_spatial(tfs.kernel_weights(ws), s, b, a1, H, mesh,
                                   torch.float32, route)
        assert calls == [name] * (D * L), route
    assert current == []
