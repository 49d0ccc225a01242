"""The eval forward of one frame split by rows
(frame2frame_tpu_torch/models/fused_apply.py ``fused_eval_apply_spatial``;
CPU meshes, the kernels' plain versions) vs the JAX package's, Pallas in
interpret mode on its virtual CPU devices.

Both eval routes on the f32 chain, a DnCNN of 5 layers at 28x32 (the case
of tests/test_parallel.py:440-469): against the JAX function at D = 2 and
the JAX model's XLA forward (that test's reference), 2e-4; the port's split
against its unsplit forward at D = 1, 3, 4, 2e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from frame2frame_tpu.models import fused_apply as jfa  # noqa: E402
from frame2frame_tpu_torch.models import fused_apply as tfa  # noqa: E402
from frame2frame_tpu_torch.models.dncnn import from_jax_variables  # noqa: E402
from frame2frame_tpu_torch.parallel.spatial import make_space_mesh  # noqa: E402

from test_torch_fused_apply import frames, perturbed_model  # noqa: E402

H, W = 28, 32
EVAL_TOL = dict(rtol=2e-4, atol=2e-4)


def jax_mesh(D):
    return Mesh(np.array(jax.devices()[:D]), ("space",))


@pytest.fixture(scope="module")
def eval_case():
    """The JAX model, its perturbed running statistics, a frame, and the
    references: the XLA forward, and the JAX split forward at D = 2 on both
    routes (f32 chain)."""
    model, variables = perturbed_model(H, W, seed=2)
    x = frames(1, H, W, seed=21)
    xj = jnp.asarray(x)
    ref = np.asarray(model.apply(variables, xj, train=False))
    split = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("F2F_EVAL_DTYPE", "f32")
        for impl in ("affine", "act"):
            split[impl] = np.asarray(jfa.fused_eval_apply_spatial(
                model, variables["params"], variables["batch_stats"], xj,
                jax_mesh(2), store_dtype=jnp.float32, eval_impl=impl))
    return from_jax_variables(variables).eval(), torch.from_numpy(x), ref, split


PORT_IMPL = {"affine": "affine", "act": "act-f32"}


@pytest.mark.parametrize("impl", ["affine", "act"])
def test_fused_eval_apply_spatial_matches_jax(impl, eval_case):
    model, x, ref, split = eval_case
    got = tfa.fused_eval_apply_spatial(
        model, x, make_space_mesh(2, device="cpu"), store_dtype=torch.float32,
        eval_impl=PORT_IMPL[impl]).numpy()
    np.testing.assert_allclose(got, split[impl], **EVAL_TOL)
    np.testing.assert_allclose(got, ref, **EVAL_TOL)


@pytest.mark.parametrize("impl", ["affine", "act"])
@pytest.mark.parametrize("D", [1, 3, 4])
def test_fused_eval_apply_spatial_matches_unsplit(D, impl, eval_case):
    model, x, ref, _ = eval_case
    want = tfa.fused_eval_apply(model, x, store_dtype=torch.float32,
                                eval_impl=PORT_IMPL[impl]).numpy()
    got = tfa.fused_eval_apply_spatial(
        model, x, make_space_mesh(D, device="cpu"), store_dtype=torch.float32,
        eval_impl=PORT_IMPL[impl]).numpy()
    np.testing.assert_allclose(got, want, **EVAL_TOL)
    np.testing.assert_allclose(got, ref, **EVAL_TOL)
