"""The port's (data, time) mesh and sharded steps (``frame2frame_tpu_torch/
parallel/mesh.py``, ``parallel/shard.py``) against the JAX package's, on the
CPU: the port's meshes repeat the ``"cpu"`` device, the JAX package's run on
the 8 virtual CPU devices of ``tests/conftest.py``.

- the mesh helpers build the same grids, blocks and pass-throughs;
- ``halo_exchange_time`` and ``_halo_window_tables`` equal JAX's;
- the f2f step at ``tests/test_parallel.py``'s case on meshes (4, 2),
  (2, 4), (4, 1) and (1, 4): with ``train_bn=False`` against the port's
  unsharded step at that test's bounds (loss rtol 1e-5; parameters rtol
  1e-5, atol 1e-7) and against JAX's sharded step (loss rtol 1e-5,
  parameters by the rule of ``tests/test_torch_adapt.py``: 99.5 % of the
  elements within 1e-5, all within two learning rates; measured: every
  element within 1e-5); with ``train_bn=True`` against JAX's at the same
  bounds;
- the sup step: with SGD at learning rate 1, JAX's update is D times the
  gradient of the loss it returns (the shards' local-BatchNorm loss,
  differentiated here in one JAX function), and the port's update is that
  gradient; with ``torch_adam`` the port stays within the two-learning-rate
  rule of JAX's;
- the window step's shard-size ``ValueError``.
The window steps are in ``tests/test_torch_parallel_window.py``.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from frame2frame_tpu.models.dncnn import init_dncnn as jinit  # noqa: E402
from frame2frame_tpu.parallel import mesh as jmesh  # noqa: E402
from frame2frame_tpu.parallel import shard as jshard  # noqa: E402
from frame2frame_tpu.train.online import torch_adam as jadam  # noqa: E402
from frame2frame_tpu_torch.models.dncnn import (  # noqa: E402
    JaxRavel,
    from_jax_variables,
    to_jax_variables,
)
from frame2frame_tpu_torch.ops.warp import warped_dist_loss  # noqa: E402
from frame2frame_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from frame2frame_tpu_torch.parallel import shard as tshard  # noqa: E402
from frame2frame_tpu_torch.train.online import torch_adam as tadam  # noqa: E402

PKG = Path(__file__).resolve().parents[1] / "frame2frame_tpu_torch"
CPU8 = ["cpu"] * 8
LR, WD = 1e-4, 1e-5
MESHES = [(4, 2), (2, 4), (4, 1), (1, 4)]
VAR_ATOL = 1e-5
SHARE = 0.995


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def assert_tree_close(got, want, rtol, atol):
    for a, b in zip(leaves(got), leaves(want), strict=True):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def assert_adapt_rule(got, want, lr, steps=1):
    """``tests/test_torch_adapt.py``'s rule: 99.5 % of the elements within
    1e-5, all within two learning rates a step. Returns the share."""
    a = np.concatenate([x.ravel() for x in leaves(got)])
    b = np.concatenate([x.ravel() for x in leaves(want)])
    err = np.abs(a - b)
    share = float(np.mean(err <= VAR_ATOL))
    assert share >= SHARE, share
    assert err.max() <= 2 * lr * steps, err.max()
    return share


# ------------------------------------------------------------- mesh helpers


@pytest.mark.parametrize("shape", [(4, 2), (2, 4), (8, 1), (1, 8), (3, 2),
                                   (None, 2), (None, 1)])
def test_make_mesh_shape(shape):
    n_data, n_time = shape
    want = jmesh.make_mesh(n_data=n_data, n_time=n_time)
    got = tmesh.make_mesh(n_data=n_data, n_time=n_time, devices=CPU8)
    assert got.shape == dict(want.shape)
    assert got.axis_names == tuple(want.axis_names)
    assert got.size == want.size


def test_make_mesh_needs_a_card_or_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh(2, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.data_parallel_mesh(4)
    with pytest.raises(ValueError):
        tmesh.make_mesh(4, 4, devices=CPU8)


@pytest.mark.parametrize("n_dev", [1, 2, 3, 4, 8])
def test_data_parallel_mesh(n_dev):
    for batch in range(1, 10):
        want = jmesh.data_parallel_mesh(batch, jax.devices()[:n_dev])
        got = tmesh.data_parallel_mesh(batch, ["cpu"] * n_dev)
        assert (got is None) == (want is None), (n_dev, batch)
        if want is not None:
            assert got.shape == dict(want.shape), (n_dev, batch)


def _jax_blocks(arr, mesh):
    """{(d, t): block} of a JAX array sharded over a (data, time) mesh."""
    where = {dev: (d, t) for d, row in enumerate(mesh.devices)
             for t, dev in enumerate(row)}
    return {where[s.device]: np.asarray(s.data)
            for s in arr.addressable_shards}


@pytest.mark.parametrize("shape", [(2, 4), (4, 2), (1, 8)])
def test_shard_video(shape):
    rng = np.random.default_rng(3)
    vid = rng.random((4, 8, 3, 5, 1)).astype(np.float32)
    jm = jmesh.make_mesh(*shape)
    want = _jax_blocks(jmesh.shard_video(jm, jnp.asarray(vid)), jm)
    got = tmesh.shard_video(tmesh.make_mesh(*shape, devices=CPU8), vid)
    for (d, t), block in want.items():
        np.testing.assert_array_equal(got[d][t].numpy(), block)
    assert tmesh.video_sharding(tmesh.make_mesh(*shape, devices=CPU8)).spec \
        == tuple(jmesh.video_sharding(jm).spec)
    assert tmesh.replicated(tmesh.make_mesh(1, 1, devices=CPU8)).spec == ()


def test_shard_batch_and_replicate_tree():
    rng = np.random.default_rng(4)
    batch = {"noisy": rng.random((4, 2, 3, 3, 1)).astype(np.float32),
             "index": np.arange(4), "odd": np.ones(3, np.float32),
             "sigma": 25.0, "names": ["a", ["b", "c"], "d", "e"]}
    jm = jmesh.make_mesh(4, 1)
    want = jmesh.shard_batch(jm, batch)
    tm = tmesh.make_mesh(4, 1, devices=CPU8)
    got = tmesh.shard_batch(tm, batch)
    for k, v in want.items():
        sharded = isinstance(v, jax.Array) and not v.is_fully_replicated
        if sharded:
            blocks = _jax_blocks(v, jm)
            for d, block in enumerate(got[k]):
                np.testing.assert_array_equal(block.numpy(), blocks[(d, 0)])
        else:
            assert got[k] is batch[k], k
    tree = {"a": {"k": rng.random((3, 3)).astype(np.float32)}, "n": 3}
    rep = tmesh.replicate_tree(tm, tree)
    jrep = jmesh.replicate_tree(jm, tree)
    np.testing.assert_array_equal(rep["a"]["k"].numpy(),
                                  np.asarray(jrep["a"]["k"]))
    assert rep["a"]["k"].device == tm.first and rep["n"] == 3


@pytest.mark.parametrize("n_time,halo", [(2, 1), (4, 2), (1, 2), (4, 0)])
def test_halo_exchange_time(n_time, halo):
    rng = np.random.default_rng(5)
    vid = rng.random((2, 8, 3, 3, 1)).astype(np.float32)
    jm = jmesh.make_mesh(1, n_time)
    f = jax.shard_map(lambda x: jshard.halo_exchange_time(x, halo, n_time),
                      mesh=jm, in_specs=P("data", "time"),
                      out_specs=P("data", "time"), check_vma=False)
    want = np.asarray(f(jnp.asarray(vid)))
    blocks = tmesh.shard_video(tmesh.make_mesh(1, n_time, devices=CPU8),
                               vid)[0]
    got = torch.cat(tshard.halo_exchange_time(blocks, halo), 1).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("t_loc,n_time,wt", [(4, 2, 1), (2, 4, 1), (4, 4, 2),
                                             (6, 1, 2), (3, 3, 1)])
def test_halo_window_tables(t_loc, n_time, wt):
    for tix in range(n_time):
        want = jshard._halo_window_tables(tix, t_loc, n_time, wt)
        got = tshard._halo_window_tables(tix, t_loc, n_time, wt)
        for a, b in zip(got, want, strict=True):
            assert a.dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, np.asarray(b))


# ------------------------------------------------------------ the f2f step


@pytest.fixture(scope="module")
def setup():
    model, variables = jinit(jax.random.PRNGKey(0), channels=1, num_layers=4,
                             residual=True, spatial=(16, 16))
    rng = np.random.default_rng(0)
    B, T, H, W = 4, 4, 16, 16
    noisy = rng.random((B, T, H, W, 1)).astype(np.float32)
    bflow = rng.normal(0, 0.3, (B, T, H, W, 2)).astype(np.float32)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    return model, variables, noisy, bflow


def port_model(variables):
    return from_jax_variables(variables, residual=True, conv_impl="packed")


def port_opt(model, tx):
    return tx.init(JaxRavel(model).ravel())


@pytest.fixture(scope="module")
def jax_f2f(setup):
    """JAX's sharded f2f step on every mesh, train_bn False and (4, 2) True."""
    model, variables, noisy, bflow = setup
    tx = jadam(LR, WD)
    out = {}
    for shape, train_bn in [(m, False) for m in MESHES] + [((4, 2), True)]:
        step = jshard.make_sharded_f2f_step(model, jmesh.make_mesh(*shape),
                                            tx, train_bn=train_bn)
        p, bs, _, loss = step(variables["params"], variables["batch_stats"],
                              tx.init(variables["params"]), noisy, bflow)
        out[shape, train_bn] = (float(loss), jax.tree_util.tree_map(
            np.asarray, p), jax.tree_util.tree_map(np.asarray, bs))
    return out


def port_reference_f2f(variables, noisy, bflow):
    """The port's unsharded step: the model on the whole batch, the mean
    over the B (T - 1) pairs, one torch_adam update."""
    model = port_model(variables).eval()
    tx, ravel = tadam(LR, WD), JaxRavel(model)
    x = torch.from_numpy(noisy)
    fl = torch.from_numpy(bflow)
    B, T = x.shape[:2]
    deno = model(x.reshape((B * T,) + x.shape[2:])).reshape(x.shape)
    loss = torch.stack([warped_dist_loss(deno[b, t], x[b, t - 1], fl[b, t])
                        for b in range(B) for t in range(1, T)]).mean()
    loss.backward()
    upd, _ = tx.update(ravel.ravel(grads=True), tx.init(ravel.ravel()),
                       ravel.ravel())
    ravel.add(upd)
    return float(loss.detach()), to_jax_variables(model)["params"]


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_f2f_matches_unsharded(setup, jax_f2f, shape):
    _, variables, noisy, bflow = setup
    model = port_model(variables)
    tx = tadam(LR, WD)
    step = tshard.make_sharded_f2f_step(
        model, tmesh.make_mesh(*shape, devices=CPU8), tx, train_bn=False)
    p, bs, _, loss = step(variables["params"], variables["batch_stats"],
                          port_opt(model, tx), noisy, bflow)
    ref_loss, ref_params = port_reference_f2f(variables, noisy, bflow)
    assert float(loss) == pytest.approx(ref_loss, rel=1e-5)
    assert_tree_close(p, ref_params, rtol=1e-5, atol=1e-7)
    assert_tree_close(bs, variables["batch_stats"], rtol=0, atol=0)
    jloss, jparams, _ = jax_f2f[shape, False]
    assert float(loss) == pytest.approx(jloss, rel=1e-5)
    assert assert_adapt_rule(p, jparams, LR) == 1.0


def test_sharded_f2f_train_bn_matches_jax(setup, jax_f2f):
    _, variables, noisy, bflow = setup
    model = port_model(variables)
    tx = tadam(LR, WD)
    step = tshard.make_sharded_f2f_step(
        model, tmesh.make_mesh(4, 2, devices=CPU8), tx, train_bn=True)
    p, bs, _, loss = step(variables["params"], variables["batch_stats"],
                          port_opt(model, tx), noisy, bflow)
    jloss, jparams, jbs = jax_f2f[(4, 2), True]
    assert float(loss) == pytest.approx(jloss, rel=1e-5)
    assert_adapt_rule(p, jparams, LR)
    assert_tree_close(bs, jbs, rtol=1e-5, atol=1e-6)
    # the running averages moved: the mean of the shards' statistics
    assert not np.allclose(leaves(bs)[0], leaves(variables["batch_stats"])[0])


def test_sharded_f2f_same_bits_twice(setup):
    _, variables, noisy, bflow = setup
    runs = []
    for _ in range(2):
        model = port_model(variables)
        tx = tadam(LR, WD)
        step = tshard.make_sharded_f2f_step(
            model, tmesh.make_mesh(2, 2, devices=CPU8), tx, train_bn=True)
        runs.append(step(variables["params"], variables["batch_stats"],
                         port_opt(model, tx), noisy, bflow))
    for a, b in zip(leaves(runs[0][:2]), leaves(runs[1][:2]), strict=True):
        np.testing.assert_array_equal(a, b)
    assert float(runs[0][3]) == float(runs[1][3])


# ------------------------------------------------------------- the sup step


class sgd:
    """optax.sgd(lr) over the port's raveled vector."""

    def __init__(self, lr):
        self.lr = lr

    def init(self, params):
        return {}

    def update(self, grads, state, params=None):
        return -self.lr * grads, state


def jax_local_bn_grad(model, variables, noisy, clean, shape):
    """The gradient of the loss the sharded sup step returns: each block's
    squared error with its own BatchNorm statistics, summed over the
    blocks, over the whole batch's element count."""
    n_data, n_time = shape
    b, tl = noisy.shape[0] // n_data, noisy.shape[1] // n_time

    def loss_fn(p):
        tot = 0.0
        for d in range(n_data):
            for t in range(n_time):
                blk = (slice(d * b, (d + 1) * b), slice(t * tl, (t + 1) * tl))
                deno, _ = model.apply(
                    {"params": p, "batch_stats": variables["batch_stats"]},
                    noisy[blk], train=True, mutable=["batch_stats"])
                tot = tot + jnp.sum((deno - clean[blk]) ** 2)
        return tot / clean.size

    return jax.grad(loss_fn)(variables["params"])


@pytest.mark.parametrize("shape", [(2, 1), (4, 2)])
def test_sharded_sup_gradient(setup, shape):
    """JAX's update is D times the gradient of its loss; the port's is the
    gradient."""
    model, variables, noisy, _ = setup
    clean = np.clip(noisy + 0.1, 0, 1).astype(np.float32)
    D = shape[0] * shape[1]
    g = leaves(jax_local_bn_grad(model, variables, noisy, clean, shape))
    jtx = optax.sgd(1.0)
    jstep = jshard.make_sharded_sup_step(model, jmesh.make_mesh(*shape), jtx)
    jp, _, _, jloss = jstep(variables["params"], variables["batch_stats"],
                            jtx.init(variables["params"]), noisy, clean)
    tm = port_model(variables)
    step = tshard.make_sharded_sup_step(
        tm, tmesh.make_mesh(*shape, devices=CPU8), sgd(1.0))
    p, bs, _, loss = step(variables["params"], variables["batch_stats"], {},
                          noisy, clean)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    p0 = leaves(variables["params"])

    def flat(xs):
        return np.concatenate([x.ravel() for x in xs])

    g = flat(g)
    upd_jax = flat([a - j for a, j in zip(p0, leaves(jp), strict=True)])
    upd_port = flat([a - b for a, b in zip(p0, leaves(p), strict=True)])
    norm = np.linalg.norm(g)
    # measured: 2.1e-7 .. 9.5e-5 (the (4, 2) blocks hold two 16x16 frames,
    # whose BatchNorm statistics put pre-activations near the ReLU's kink)
    assert np.linalg.norm(upd_jax / D - g) <= 1e-3 * norm
    assert np.linalg.norm(upd_port - g) <= 1e-3 * norm
    assert np.linalg.norm(upd_jax) / norm == pytest.approx(D, rel=1e-3)


def test_sharded_sup_adam_close_to_jax(setup):
    model, variables, noisy, _ = setup
    clean = np.clip(noisy + 0.1, 0, 1).astype(np.float32)
    jtx = jadam(LR)
    jstep = jshard.make_sharded_sup_step(model, jmesh.make_mesh(4, 2), jtx)
    jp, jbs, _, jloss = jstep(variables["params"], variables["batch_stats"],
                              jtx.init(variables["params"]), noisy, clean)
    tm = port_model(variables)
    tx = tadam(LR)
    step = tshard.make_sharded_sup_step(
        tm, tmesh.make_mesh(4, 2, devices=CPU8), tx)
    p, bs, _, loss = step(variables["params"], variables["batch_stats"],
                          port_opt(tm, tx), noisy, clean)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    assert_adapt_rule(p, jax.tree_util.tree_map(np.asarray, jp), LR)
    assert_tree_close(bs, jax.tree_util.tree_map(np.asarray, jbs),
                      rtol=1e-5, atol=1e-6)


def test_sharded_window_step_validates_shard_size(setup):
    _, variables, _, _ = setup
    model = port_model(variables)
    tx = tadam(LR)
    step = tshard.make_sharded_window_step(
        model, tmesh.make_mesh(1, 8, devices=CPU8), tx, loss="l1",
        kind="warped", wt=1)
    vid = np.zeros((1, 8, 16, 16, 1), np.float32)
    flows = np.zeros((1, 8, 16, 16, 2), np.float32)
    with pytest.raises(ValueError, match="at least 2\\*wt"):
        step(variables["params"], variables["batch_stats"],
             port_opt(model, tx), vid, vid, flows, flows)


# ------------------------------------------------------------------ guards

NEW_MODULES = sorted(
    [str(f.relative_to(PKG)) for d in ("parallel", "io")
     for f in (PKG / d).glob("*.py")] + ["models/sync_bn.py"])


@pytest.mark.parametrize("rel", NEW_MODULES)
def test_module_names_no_jax(rel):
    tree = ast.parse((PKG / rel).read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for n in names:
            assert n.split(".")[0] not in ("jax", "flax", "optax",
                                           "frame2frame_tpu"), (rel, n)


def test_parallel_and_io_import_no_jax():
    code = ("import sys\n"
            "import frame2frame_tpu_torch.parallel, "
            "frame2frame_tpu_torch.io.native, "
            "frame2frame_tpu_torch.train.trainer\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'frame2frame_tpu')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=PKG.parent)
    assert res.returncode == 0, res.stderr
