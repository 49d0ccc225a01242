"""The H-split online fine-tune (frame2frame_tpu_torch/parallel/spatial.py
``make_spatial_online_step``; CPU meshes, the kernels' plain versions) vs
the port's unsplit step and the JAX package's split step.

At the case of tests/test_parallel.py:340-382: a "fused" DnCNN of 4 layers,
32x32, 2 Adam updates, D = 2 and 4.

- On the f32 chain the split step against the port's unsplit per-iteration
  step (``make_online_step(flat_step=False)``): losses rtol 2e-5, the
  denoised frame, the parameters and the running statistics atol 2e-5, the
  bounds of the JAX package's own split-against-unsplit test.
- On the bf16 chain, which the JAX package's split step runs, against that
  step (``F2F_FUSED=force``, Pallas in interpret mode on its virtual CPU
  devices): the port's and the JAX package's steps round the chain at the
  same points but sum in another order, so they are held by the bounds of
  tests/test_torch_online_train.py (losses rtol 1e-2, frames atol 5e-3,
  parameters atol 1e-3, statistics rtol 1e-2 / atol 1e-3), as are the two
  packages' unsplit steps (measured: losses 1.0e-4 split, 5.8e-5 unsplit;
  the JAX split step is itself 4.6e-5 off its unsplit step at D = 2); the
  port's bf16 split step against its unsplit step: losses 2e-5, parameters
  1e-4, the denoised frame within 2^-8.
- A model whose ``conv_impl`` is not "fused" runs unsplit: the same bits as
  the unsplit step.
- ``flat_step=True`` with a mesh raises; ``make_space_mesh()`` raises
  without a card; no module under ``parallel/`` imports JAX.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from frame2frame_tpu.models.dncnn import init_dncnn  # noqa: E402
from frame2frame_tpu.parallel import spatial as jspatial  # noqa: E402
from frame2frame_tpu.train import online as jonline  # noqa: E402
from frame2frame_tpu_torch.models.dncnn import (  # noqa: E402
    JaxRavel,
    from_jax_variables,
    to_jax_variables,
)
from frame2frame_tpu_torch.ops import fused_stack as tfs  # noqa: E402
from frame2frame_tpu_torch.parallel import spatial as tspatial  # noqa: E402
from frame2frame_tpu_torch.train import online as tonline  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
H = W = 32
ITERS = 2
TIGHT = 2e-5
CROSS = dict(loss=1e-2, deno=5e-3, params=1e-3)


@pytest.fixture(scope="module")
def setup():
    model, variables = init_dncnn(jax.random.PRNGKey(1), channels=1,
                                  num_layers=4, residual=True,
                                  spatial=(H, W), conv_impl="fused")
    rng = np.random.default_rng(2)
    frames = (rng.random((H, W, 1)).astype(np.float32),
              rng.random((H, W, 1)).astype(np.float32),
              rng.normal(0, 0.4, (H, W, 2)).astype(np.float32))
    return model, jax.tree_util.tree_map(np.asarray, variables), frames


def result(variables, deno, losses):
    return {"variables": jax.tree_util.tree_map(np.asarray, variables),
            "deno": np.asarray(deno), "losses": np.asarray(losses)}


@pytest.fixture(scope="module")
def jax_steps(setup):
    """The JAX package's split steps at D = 2 and 4 and its unsplit step,
    bf16 chain on the fused engine."""
    model, variables, frames = setup
    tx = jonline.torch_adam(5e-5, 1e-5)
    params, bs = variables["params"], variables["batch_stats"]
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("F2F_FUSED", "force")
        mp.setenv("F2F_FLATSTEP", "0")
        for D in (2, 4):
            step = jspatial.make_spatial_online_step(
                model, tx, jspatial.make_space_mesh(D), iters=ITERS)
            p, b, _, deno, losses = step(params, bs, tx.init(params), *frames)
            out[D] = result({"params": p, "batch_stats": b}, deno, losses)
        step = jonline.make_online_step(model, tx, iters=ITERS, unroll=True)
        p, b, _, deno, losses = step(params, bs, tx.init(params), *frames)
        out[None] = result({"params": p, "batch_stats": b}, deno, losses)
    return out


def port_step(setup, D, store_dtype, conv_impl="fused"):
    """The port's split step on a CPU mesh of D (unsplit: D None)."""
    _, variables, frames = setup
    model = from_jax_variables(variables, residual=True, conv_impl=conv_impl)
    tx = tonline.torch_adam(5e-5, 1e-5)
    state = tx.init(JaxRavel(model).ravel())
    if D is None:
        step = tonline.make_online_step(model, tx, iters=ITERS,
                                        flat_step=False,
                                        store_dtype=store_dtype)
    else:
        step = tspatial.make_spatial_online_step(
            model, tx, tspatial.make_space_mesh(D, device="cpu"), iters=ITERS,
            store_dtype=store_dtype)
    _, deno, losses = step(state, *(torch.from_numpy(f) for f in frames))
    return result(to_jax_variables(model), deno, losses)


def distances(a, b):
    """Largest differences of losses (relative), frame, parameters and
    running statistics."""
    def leaves(r, k):
        return jax.tree_util.tree_leaves(r["variables"][k])

    return {
        "loss": float(np.abs(a["losses"] / b["losses"] - 1).max()),
        "deno": float(np.abs(a["deno"] - b["deno"]).max()),
        "params": max(float(np.abs(x - y).max()) for x, y in
                      zip(leaves(a, "params"), leaves(b, "params"))),
        "stats": max(float(np.abs(x - y).max()) for x, y in
                     zip(leaves(a, "batch_stats"), leaves(b, "batch_stats"))),
    }


@pytest.mark.parametrize("D", [2, 4])
def test_split_step_matches_unsplit_f32(setup, D):
    tfs.reset_launch_counts()
    got = port_step(setup, D, torch.float32)
    want = port_step(setup, None, torch.float32)
    d = distances(got, want)
    assert all(v <= TIGHT for v in d.values()), d
    assert got["losses"].shape == (ITERS,) and got["deno"].shape == (H, W, 1)
    assert not any(tfs.launch_counts().values())


@pytest.mark.parametrize("D", [2, 4])
def test_split_step_matches_jax_split_step(setup, jax_steps, D):
    got = port_step(setup, D, torch.bfloat16)
    d = distances(got, jax_steps[D])
    assert d["loss"] <= CROSS["loss"] and d["deno"] <= CROSS["deno"], d
    assert d["params"] <= CROSS["params"], d
    for x, y in zip(*(jax.tree_util.tree_leaves(r["variables"]["batch_stats"])
                      for r in (got, jax_steps[D]))):
        np.testing.assert_allclose(x, y, rtol=1e-2, atol=1e-3)
    # the unsplit steps of the two packages, by the same bounds
    unsplit = distances(port_step(setup, None, torch.bfloat16),
                        jax_steps[None])
    assert all(unsplit[k] <= CROSS[k] for k in CROSS), unsplit
    # the port's split step is its unsplit step but for the sums' order,
    # which on the bf16 chain may round a stored activation the other way
    alone = distances(got, port_step(setup, None, torch.bfloat16))
    assert alone["loss"] <= TIGHT and alone["params"] <= 1e-4, alone
    assert alone["deno"] <= 2 ** -8, alone


def test_non_fused_model_runs_unsplit(setup):
    got = port_step(setup, 4, torch.float32, conv_impl="xla")
    want = port_step(setup, None, torch.float32, conv_impl="xla")
    np.testing.assert_array_equal(got["losses"], want["losses"])
    np.testing.assert_array_equal(got["deno"], want["deno"])
    for x, y in zip(jax.tree_util.tree_leaves(got["variables"]),
                    jax.tree_util.tree_leaves(want["variables"])):
        np.testing.assert_array_equal(x, y)


def test_flat_step_with_a_mesh_raises(setup):
    _, variables, _ = setup
    model = from_jax_variables(variables, residual=True)
    tx = tonline.torch_adam(5e-5)
    mesh = tspatial.make_space_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="spatial_mesh"):
        tonline.make_online_step(model, tx, flat_step=True, spatial_mesh=mesh)
    with pytest.raises(ValueError, match="bf16"):
        tonline.make_online_step(model, tx, flat_step=True,
                                 store_dtype=torch.float32)


def test_make_space_mesh(monkeypatch):
    cpu = torch.device("cpu")
    assert tspatial.make_space_mesh(3, device="cpu") == (cpu,) * 3
    assert tspatial.make_space_mesh(devices=["cpu", "cpu"]) == (cpu, cpu)
    assert tspatial.make_space_mesh(1, devices=["cpu", "meta"]) == (cpu,)
    with pytest.raises(ValueError, match="a mesh of 3"):
        tspatial.make_space_mesh(3, devices=["cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tspatial.make_space_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tspatial.make_space_mesh(2)


def test_parallel_modules_import_no_jax():
    """The port's ``parallel`` package, imported in a fresh interpreter,
    leaves jax, flax and frame2frame_tpu out of sys.modules, and its
    sources name none of them."""
    code = """
import sys
import frame2frame_tpu_torch.parallel.spatial
import frame2frame_tpu_torch.ops.fused_spatial
bad = [k for k in sys.modules if k.split(".")[0] in ("jax", "flax", "frame2frame_tpu")]
assert not bad, bad
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    files = sorted((REPO / "frame2frame_tpu_torch" / "parallel").glob("*.py"))
    files.append(REPO / "frame2frame_tpu_torch" / "ops" / "fused_spatial.py")
    # __init__, data, mesh, shard, spatial and ops/fused_spatial.py
    assert len(files) == 6
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = ([a.name for a in node.names]
                         if isinstance(node, ast.Import)
                         else [node.module or ""])
                for n in names:
                    assert n.split(".")[0] not in (
                        "jax", "flax", "optax", "frame2frame_tpu"), (f, n)
