"""The offline trainer's data parallelism (``frame2frame_tpu_torch/parallel/
data.py``, ``train/state.make_train_apply``, ``train/trainer.run``) on the
CPU, on meshes of repeated ``"cpu"`` devices.

- ``tests/test_parallel.py``'s case (4-layer DnCNN, C = 3, B = 4, T = 3,
  16x16, ``sup``, 2 steps): the data-parallel steps against the port's
  single-device steps and against the JAX package's data-parallel steps,
  at that test's bounds (loss rtol 1e-5; parameters rtol 1e-2, atol 1e-4);
- every ``conv_impl``: the f32 routes at those bounds; the bf16 routes
  ("packed_bf16", "fused") hold the loss within 1e-3 relative (measured
  1.7e-4) and the parameters by the rule of ``tests/test_torch_adapt.py``
  over two Adam steps (99.5 % of the elements within the bounds above,
  all within two learning rates a step; measured 99.83 %, the rest at
  2.0e-3): the whole batch's statistics, summed by shard, round to bf16
  differently from the single device's, and Adam's first step moves an
  element by a whole learning rate whichever the gradient's size;
- the sync-BN gradient itself, in float64, for DnCNN and FastDVDnet: the
  shards' gradients and moved running statistics equal the single
  device's to 1e-10;
- the same bits on two runs;
- ``trainer.run`` on two repeated devices: the mesh engages, its
  checkpoint is read back bit-equal into a fresh mesh (``tests/
  test_parallel.py:471-502``), and the run matches the single-device run.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from frame2frame_tpu.config import Config as JConfig  # noqa: E402
from frame2frame_tpu.models.dncnn import init_dncnn as jinit  # noqa: E402
from frame2frame_tpu.parallel import mesh as jmesh  # noqa: E402
from frame2frame_tpu.train.lit import TrainModule as JModule  # noqa: E402
from frame2frame_tpu.train.schedules import (  # noqa: E402
    make_optimizer as jmake_optimizer,
)
from frame2frame_tpu.train.state import TrainState as JState  # noqa: E402
from frame2frame_tpu_torch.config import Config  # noqa: E402
from frame2frame_tpu_torch.models.dncnn import (  # noqa: E402
    CONV_IMPLS,
    from_jax_variables,
    init_dncnn,
)
from frame2frame_tpu_torch.models.fastdvdnet import (  # noqa: E402
    init_fastdvdnet,
)
from frame2frame_tpu_torch.models.serialization import (  # noqa: E402
    load_variables,
)
from frame2frame_tpu_torch.parallel.data import DataParallel  # noqa: E402
from frame2frame_tpu_torch.parallel.mesh import (  # noqa: E402
    data_parallel_mesh,
    replicate_tree,
)
from frame2frame_tpu_torch.train import trainer  # noqa: E402
from frame2frame_tpu_torch.train.lit import TrainModule  # noqa: E402
from frame2frame_tpu_torch.train.schedules import make_optimizer  # noqa: E402
from frame2frame_tpu_torch.train.state import (  # noqa: E402
    TrainState,
    make_train_apply,
)

B, T, H, W, C = 4, 3, 16, 16, 3
LR = 1e-3
CPU8 = ["cpu"] * 8
BF16_ROUTES = ("packed_bf16", "fused")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flat(tree):
    return np.concatenate([np.asarray(x).ravel()
                           for x in jax.tree_util.tree_leaves(tree)])


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    clean = (rng.random((B, T, H, W, C)) * 255).astype(np.float32)
    noisy = np.clip(clean + rng.normal(0, 15, clean.shape), 0, 255).astype(
        np.float32)
    cfg = {"net_name": "dncnn", "channels": C, "num_layers": 4,
           "crit_name": "sup", "nepochs": 2, "lr_init": LR, "flow": False,
           "batch_size": B}
    _, variables = jinit(jax.random.PRNGKey(0), channels=C, num_layers=4,
                         residual=True, spatial=(H, W))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    return {"noisy": noisy, "clean": clean}, cfg, variables


def port_steps(case, conv_impl, dp, variables=None):
    batch, cfg, jvars = case
    if variables is None:
        model = from_jax_variables(jvars, residual=True, conv_impl=conv_impl)
        variables = jvars
    else:
        model, variables = init_dncnn(0, channels=C, num_layers=4,
                                      residual=True, conv_impl=conv_impl)
    module = TrainModule(Config(cfg), model, residual=True)
    tx, _ = make_optimizer(module.cfg, steps_per_epoch=1)
    state = TrainState.create(model, variables, tx, residual=True)
    if dp:
        mesh = data_parallel_mesh(B, CPU8)
        assert mesh.shape == {"data": 4, "time": 1}
        state = state.replace(data_parallel=DataParallel(model, mesh))
    key = torch.Generator().manual_seed(7)
    for _ in range(2):
        state, metrics = module.training_step(state, batch, 0, key)
    return state, metrics


@pytest.fixture(scope="module")
def jax_dp(case):
    """``tests/test_parallel.py``'s data-parallel run."""
    batch, cfg, variables = case
    from frame2frame_tpu.models.dncnn import DnCNN

    model = DnCNN(channels=C, num_layers=4, residual=True, conv_impl="packed")
    module = JModule(JConfig(cfg), model, residual=True)
    tx, _ = jmake_optimizer(module.cfg, steps_per_epoch=1)
    state = JState.create(model, variables, tx, residual=True)
    mesh = jmesh.data_parallel_mesh(B)
    state = state.replace(
        params=jmesh.replicate_tree(mesh, state.params),
        batch_stats=jmesh.replicate_tree(mesh, state.batch_stats),
        opt_state=jmesh.replicate_tree(mesh, state.opt_state))
    b = jmesh.shard_batch(mesh, batch)
    key = jax.random.PRNGKey(7)
    for _ in range(2):
        state, metrics = module.training_step(state, b, 0, key)
    return float(metrics["train_loss"]), flat(state.params)


def test_trainer_data_parallel_parity(case, jax_dp):
    s1, m1 = port_steps(case, "packed", dp=False)
    s2, m2 = port_steps(case, "packed", dp=True)
    assert np.allclose(m1["train_loss"], m2["train_loss"], rtol=1e-5)
    p1, p2 = flat(s1.variables["params"]), flat(s2.variables["params"])
    np.testing.assert_allclose(p2, p1, rtol=1e-2, atol=1e-4)
    jloss, jparams = jax_dp
    assert np.allclose(m2["train_loss"], jloss, rtol=1e-5)
    np.testing.assert_allclose(p2, jparams, rtol=1e-2, atol=1e-4)


@pytest.mark.parametrize("conv_impl", CONV_IMPLS)
def test_data_parallel_every_conv_impl(case, conv_impl):
    s1, m1 = port_steps(case, conv_impl, dp=False, variables="init")
    s2, m2 = port_steps(case, conv_impl, dp=True, variables="init")
    p1, p2 = flat(s1.variables), flat(s2.variables)
    if conv_impl in BF16_ROUTES:
        assert np.allclose(m1["train_loss"], m2["train_loss"], rtol=1e-3)
        close = np.isclose(p2, p1, rtol=1e-2, atol=1e-4)
        assert close.mean() >= 0.995, close.mean()
        assert np.abs(p2 - p1).max() <= 2 * LR * 2
    else:
        assert np.allclose(m1["train_loss"], m2["train_loss"], rtol=1e-5)
        np.testing.assert_allclose(p2, p1, rtol=1e-2, atol=1e-4)


def test_data_parallel_same_bits_twice(case):
    runs = [port_steps(case, "fused", dp=True, variables="init")
            for _ in range(2)]
    np.testing.assert_array_equal(flat(runs[0][0].variables),
                                  flat(runs[1][0].variables))
    assert runs[0][1]["train_loss"] == runs[1][1]["train_loss"]


def sync_bn_grads(model, x, dp):
    """The training forward's gradient of a fixed loss and the moved
    buffers, on one device or split over two."""
    model.zero_grad()
    state = TrainState(model=model, tx=None, opt_state=None)
    if dp:
        state.data_parallel = DataParallel(
            model, data_parallel_mesh(x.shape[0], ["cpu"] * 2))
    captured = {}
    out = make_train_apply(state, captured)(x)
    (out.square().mean() + out.mean()).backward()
    return ([p.grad.clone() for p in model.parameters()],
            captured["buffers"], out.detach())


@pytest.mark.parametrize("arch", ["dncnn", "fastdvdnet"])
def test_sync_bn_gradient_float64(arch):
    """Split over two shards, the whole batch's BatchNorm: the output, every
    gradient and the moved running statistics are the single device's."""
    rng = np.random.default_rng(11)
    if arch == "dncnn":
        model, _ = init_dncnn(3, channels=1, num_layers=5, conv_impl="xla")
        x = rng.random((4, 12, 10, 1))
    else:
        model, _ = init_fastdvdnet(3, channels=1)
        x = rng.random((2, 5, 8, 12, 1))
    model = model.double()
    x = torch.from_numpy(x)
    g1, b1, o1 = sync_bn_grads(model, x, dp=False)
    g2, b2, o2 = sync_bn_grads(model, x, dp=True)
    torch.testing.assert_close(o2, o1, rtol=1e-10, atol=1e-12)
    for a, b in zip(g2, g1, strict=True):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)
    for a, b in zip(b2, b1, strict=True):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)


def test_lockstep_reraises_a_shard_failure():
    """A shard that fails stops the others at their next turn; the failure
    reaches the caller."""
    model, _ = init_dncnn(3, channels=1, num_layers=4, conv_impl="xla")
    dp = DataParallel(model, data_parallel_mesh(2, ["cpu"] * 2))
    bad = torch.zeros(2, 8, 8, 2)  # two channels where the model takes one
    with pytest.raises(RuntimeError):
        dp(bad)
    with pytest.raises(ValueError, match="do not split"):
        dp(torch.zeros(1, 8, 8, 1))


def trainer_cfg(tmp_path, **kw):
    return Config(
        net_name="dncnn", channels=1, num_of_layers=3, seed=0,
        dname="synthetic", nvideos=2 * 4, nframes_data=2,
        isize_data=(16, 16), ntype="g", sigma=25, crit_name="sup",
        nepochs=1, lr_init=1e-3, scheduler_name="cosa", flow=False,
        batch_size=4, checkpoint_dir=str(tmp_path), log_csv=False,
        conv_impl="xla", **kw)


def test_trainer_run_dp_and_checkpoint_roundtrip(tmp_path):
    out = trainer.run(trainer_cfg(tmp_path / "dp"), devices=["cpu"] * 2)
    assert np.isfinite(out["train_loss"])
    assert out.state.data_parallel.mesh.shape == {"data": 2, "time": 1}
    saved = load_variables(out.checkpoint)
    fresh = data_parallel_mesh(4, ["cpu"] * 2)
    restored = replicate_tree(fresh, saved["params"])
    for a, b in zip(jax.tree_util.tree_leaves(restored),
                    jax.tree_util.tree_leaves(out.state.variables["params"]),
                    strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    one = trainer.run(trainer_cfg(tmp_path / "one"), device="cpu")
    assert one.state.data_parallel is None
    assert np.allclose(out["train_loss"], one["train_loss"], rtol=1e-5)
    np.testing.assert_allclose(flat(out.state.variables),
                               flat(one.state.variables), rtol=1e-2,
                               atol=1e-4)
    off = trainer.run(trainer_cfg(tmp_path / "off", data_parallel=False),
                      devices=["cpu"] * 2)
    assert off.state.data_parallel is None


def test_trainer_dp_fastdvdnet(tmp_path):
    """FastDVDnet's BatchNorm meets over the shards as DnCNN's does."""
    cfg = Config(trainer_cfg(tmp_path), net_name="fastdvdnet", channels=1,
                 nframes_data=5, batch_size=2, nvideos=2, crit_name="sup",
                 lr_init=1e-6)
    out = trainer.run(cfg, devices=["cpu"] * 2)
    assert out.state.data_parallel.mesh.shape == {"data": 2, "time": 1}
    one = trainer.run(Config(cfg, checkpoint_dir=str(tmp_path / "one")),
                      device="cpu")
    assert np.allclose(out["train_loss"], one["train_loss"], rtol=1e-5)


def test_trainer_mesh_must_start_on_the_model_device(tmp_path):
    with pytest.raises(ValueError, match="starts on"):
        trainer.run(trainer_cfg(tmp_path), device="meta",
                    devices=["cpu"] * 2)



def test_trainer_default_devices_follow_the_model_device(tmp_path,
                                                          monkeypatch):
    """Without ``devices=`` the trainer's mesh is built from ``device``
    alone, not from the cards: on a host of two cards a run on the second
    neither raises nor splits its batch."""
    from frame2frame_tpu_torch.parallel import mesh as pmesh

    class Stop(Exception):
        pass

    seen = []

    def record(batch_size, devices):
        seen.append(list(devices))
        raise Stop

    monkeypatch.setattr(pmesh, "cards", lambda: [torch.device("cuda", 0),
                                                 torch.device("cuda", 1)])
    monkeypatch.setattr(trainer, "data_parallel_mesh", record)
    with pytest.raises(Stop):
        trainer.run(trainer_cfg(tmp_path), device="cuda:1")
    assert seen == [[torch.device("cuda", 1)]]
