"""The port's offline training module (``frame2frame_tpu_torch/train/lit.py``)
against the JAX package's, on the CPU.

- ``TrainModule.training_step`` for every ``crit_name`` (warped, stnls,
  nb2nb, b2u, stnls_nb2nb, nb2nb_stnls, sup, sup_fdvd, n2n) on a 4-layer
  DnCNN (``conv_impl="xla"`` on both sides) over a 3-frame 16x16 clip, flows
  handed in (``read_flows``), and JAX's draws where a loss draws: Nb2Nb's
  masks and n2n's noise are replaced in the port by the ones JAX draws from
  its key, since the port draws from a ``torch.Generator``. The loss within
  1e-5 relative; the updated variables, BatchNorm's statistics included,
  with at least 99.5 % of their elements within 1e-5: the step trains
  BatchNorm, and where a pre-activation sits at the ReLU's kink two f32
  implementations differ by a whole Adam step in a few elements (the rule
  of ``tests/test_torch_adapt.py``), the rest within two learning rates;
- ``eval_step``'s metrics; ``ensure_chnls``; ``set_flow_epoch`` and
  ``use_flow``; ``get_sim_model``; ``init_crit``'s dispatch.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from scipy.ndimage import gaussian_filter  # noqa: E402

from frame2frame_tpu.config import Config as JConfig  # noqa: E402
from frame2frame_tpu.losses import nb2nb as jnb2nb  # noqa: E402
from frame2frame_tpu.models.dncnn import DnCNN as JDnCNN  # noqa: E402
from frame2frame_tpu.train import lit as jlit  # noqa: E402
from frame2frame_tpu.train.schedules import make_optimizer as jopt  # noqa: E402
from frame2frame_tpu.train.state import TrainState as JState  # noqa: E402
from frame2frame_tpu_torch.data import noise as tnoise  # noqa: E402
from frame2frame_tpu_torch.losses import nb2nb as tnb2nb  # noqa: E402
from frame2frame_tpu_torch.models.dncnn import init_dncnn  # noqa: E402
from frame2frame_tpu_torch.models.noise_sim import (  # noqa: E402
    HeteroscedasticGaussianSim)
from frame2frame_tpu_torch.train import lit as tlit  # noqa: E402
from frame2frame_tpu_torch.train.schedules import make_optimizer as topt  # noqa: E402
from frame2frame_tpu_torch.train.state import TrainState as TState  # noqa: E402

from test_torch_nls import one_torch_thread  # noqa: E402,F401

B, T, H, W = 1, 3, 16, 16
LOSS_RTOL = 1e-5
VAR_ATOL = 1e-5
TRAIN_BN_SHARE = 0.995
LR = 1e-3
KEY = 1
EPOCH = 1

STNLS = dict(dist_crit="v0", dist_mask=0.5)
CRITS = {
    "warped": {}, "stnls": STNLS, "nb2nb": {}, "b2u": {},
    # combo_swap_epochs 0: the stnls side of the combo at epoch 1
    "stnls_nb2nb": dict(STNLS, combo_swap_epochs=0),
    "nb2nb_stnls": STNLS, "sup": {}, "sup_fdvd": {}, "n2n": {},
}


@pytest.fixture(scope="module")
def net():
    """A 4-layer grayscale DnCNN: the port's seeded weights as the JAX tree,
    and the JAX module that runs them."""
    _, variables = init_dncnn(0, channels=1, num_layers=4, residual=True,
                              conv_impl="xla")
    return JDnCNN(channels=1, num_layers=4, residual=True,
                  conv_impl="xla"), variables


@pytest.fixture(scope="module")
def batch():
    """A 3-frame 16x16 clip on [0, 255] with smooth flows."""
    rng = np.random.default_rng(7)
    clean = gaussian_filter(rng.random((B, T, H, W, 1)), (0, 0, 2, 2, 0))
    clean = (255 * (clean - clean.min()) / np.ptp(clean)).astype(np.float32)
    noisy = (clean + 25 * rng.standard_normal(clean.shape)).astype(np.float32)
    fl = [(gaussian_filter(rng.standard_normal((B, T, H, W, 2)),
                           (0, 0, 3, 3, 0)) * 6).astype(np.float32)
          for _ in range(2)]
    return dict(noisy=noisy, clean=clean, fflow=fl[0], bflow=fl[1],
                sigma=25.0, index=0)


def lit_cfg(crit, **kw):
    cfg = dict(crit_name=crit, nepochs=4, lr_init=LR, lr_final=1e-5,
               ntype="g", sigma=25, flow=False, read_flows=True, wt=1, ws=3,
               ps=3, k=2, stride0=2, ps_dists=3, dd_in=1)
    cfg.update(CRITS.get(crit, {}))
    cfg.update(kw)
    return cfg


def modules(net, cfg):
    model, variables = net
    jm = jlit.TrainModule(JConfig(cfg), model, residual=True)
    jtx, _ = jopt(jm.cfg)
    port, _ = init_dncnn(1, channels=1, num_layers=4, residual=True,
                         conv_impl="xla")
    tm = tlit.TrainModule(cfg, port, residual=True)
    ttx, _ = topt(tm.cfg)
    return ((jm, JState.create(model, variables, jtx, residual=True)),
            (tm, TState.create(port, variables, ttx, residual=True)))


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    else:
        yield path, np.asarray(tree, np.float64)


def jax_draws(monkeypatch, shape):
    """The port's draws replaced by JAX's from ``PRNGKey(KEY)``: Nb2Nb's
    masks and the Gaussian noise of n2n."""
    key = jax.random.PRNGKey(KEY)
    sel = jnb2nb.generate_mask_pair(key, (shape[0] * shape[1],) + shape[2:4])
    sel = tuple(torch.from_numpy(np.array(s, np.int64)) for s in sel)
    monkeypatch.setattr(tnb2nb, "generate_mask_pair",
                        lambda key, shape, device=None: sel)
    normal = torch.from_numpy(np.array(jax.random.normal(key, shape)))
    monkeypatch.setattr(tnoise, "_normal",
                        lambda gen, shape_, dtype, device: normal)


@pytest.mark.parametrize("crit", sorted(CRITS))
def test_training_step(net, batch, crit, monkeypatch):
    cfg = lit_cfg(crit)
    (jm, js), (tm, ts) = modules(net, cfg)
    jax_draws(monkeypatch, batch["noisy"].shape)
    js2, jmet = jm.training_step(js, JConfig(batch), EPOCH,
                                 jax.random.PRNGKey(KEY))
    ts2, tmet = tm.training_step(ts, batch, EPOCH,
                                 torch.Generator().manual_seed(KEY))
    assert ts2.step == js2.step == tmet.global_step == 1
    assert abs(tmet.train_loss - jmet.train_loss) <= LOSS_RTOL * abs(
        jmet.train_loss), (tmet.train_loss, jmet.train_loss)
    assert abs(tmet.train_psnr - jmet.train_psnr) <= 1e-4
    got = dict(leaves(ts2.variables))
    want = dict(leaves(jax.tree.map(np.asarray, js2.variables)))
    assert got.keys() == want.keys()
    err = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    assert np.mean(err <= VAR_ATOL) >= TRAIN_BN_SHARE, np.mean(err <= VAR_ATOL)
    assert err.max() <= 2 * LR, err.max()
    # the update moved the parameters
    before = dict(leaves(net[1]))
    assert max(np.abs(got[k] - before[k]).max() for k in before
               if k[0] == "params") > 0


def test_training_step_solves_flows(net, batch):
    """Without flows in the batch the step solves them from the noisy
    video on the model's device (here zero flows: ``flow=False``)."""
    cfg = lit_cfg("warped", read_flows=False)
    (jm, js), (tm, ts) = modules(net, cfg)
    plain = {k: v for k, v in batch.items() if k not in ("fflow", "bflow")}
    _, jmet = jm.training_step(js, JConfig(plain), 0, jax.random.PRNGKey(0))
    _, tmet = tm.training_step(ts, plain, 0, torch.Generator())
    assert abs(tmet.train_loss - jmet.train_loss) <= LOSS_RTOL * abs(
        jmet.train_loss)


def test_eval_step(net, batch):
    (jm, js), (tm, ts) = modules(net, lit_cfg("sup"))
    want = jm.eval_step(js, JConfig(batch), prefix="te")
    got = tm.eval_step(ts, batch, prefix="te")
    assert sorted(got) == sorted(want)
    assert got.te_index == want.te_index == 0
    assert abs(got.te_loss - want.te_loss) <= 1e-5 * want.te_loss
    assert abs(got.te_psnr - want.te_psnr) <= 1e-4
    assert abs(got.te_ssim - want.te_ssim) <= 1e-5


@pytest.mark.parametrize("dd_in,C,sigma", [
    (3, 3, 25.0), (3, 4, 25.0), (4, 3, 25.0), (4, 3, [10.0, 40.0]),
    (2, 4, 25.0)])
def test_ensure_chnls(net, dd_in, C, sigma):
    rng = np.random.default_rng(2)
    noisy = rng.random((2, 2, 4, 5, C)).astype(np.float32)
    jm = jlit.TrainModule(JConfig(lit_cfg("sup", dd_in=dd_in)), net[0])
    port, _ = init_dncnn(0, channels=1, num_layers=4, conv_impl="xla")
    tm = tlit.TrainModule(lit_cfg("sup", dd_in=dd_in), port)
    want = np.asarray(jm.ensure_chnls(jax.numpy.asarray(noisy), sigma))
    got = tm.ensure_chnls(torch.from_numpy(noisy), sigma).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("flow,flow_epoch,flow_from_end", [
    (False, None, None), (True, None, None), (False, None, 2),
    (False, 3, None), (False, 0, None), (False, None, 4), (False, None, 6)])
def test_use_flow(net, flow, flow_epoch, flow_from_end):
    cfg = lit_cfg("sup", flow=flow, flow_epoch=flow_epoch,
                  flow_from_end=flow_from_end)
    port, _ = init_dncnn(0, channels=1, num_layers=4, conv_impl="xla")
    jm = jlit.TrainModule(JConfig(cfg), net[0])
    tm = tlit.TrainModule(cfg, port)
    assert tm.cfg.flow_epoch == jm.cfg.flow_epoch
    for epoch in range(5):
        assert tm.use_flow(epoch) == jm.use_flow(epoch), epoch


def test_get_sim_model(capsys):
    assert tlit.get_sim_model({"sim_type": "g"}) is None
    sim = tlit.get_sim_model({"sim_type": "learned_g", "sim_channels": 1,
                              "sim_sigma_a": 1.5}, device="cpu")
    assert isinstance(sim, HeteroscedasticGaussianSim)
    assert sim.channels == 1 and float(sim.params["a"][0]) == 1.5
    # the external "stardeno" generator is not installed: the built-in
    # simulator stands in, with a warning
    sim = tlit.get_sim_model({"sim_type": "learned", "sim_module": "stardeno"},
                             device="cpu")
    assert isinstance(sim, HeteroscedasticGaussianSim)
    assert "stardeno" in capsys.readouterr().err
    with pytest.raises(ImportError):
        tlit.get_sim_model({"sim_type": "learned",
                            "sim_module": "no_such_noise_module"})


def test_sample_noisy_draws_from_the_simulator(net, batch):
    port, _ = init_dncnn(0, channels=1, num_layers=4, conv_impl="xla")
    tm = tlit.TrainModule(lit_cfg("sup", sim_type="learned_g",
                                  sim_channels=1), port)
    assert tm.sim_model.device.type == "cpu"
    out = [tm.sample_noisy(batch, torch.Generator().manual_seed(4))
           for _ in range(2)]
    assert torch.equal(out[0]["noisy"], out[1]["noisy"])
    assert not np.array_equal(out[0]["noisy"].numpy(), batch["noisy"])
    assert tm.sample_noisy(batch, None) is not batch
    assert tlit.TrainModule(lit_cfg("sup"), port).sample_noisy(
        batch, None) is batch


def test_init_crit(net):
    port, _ = init_dncnn(0, channels=1, num_layers=4, conv_impl="xla")
    for crit in CRITS:
        got = tlit.TrainModule(lit_cfg(crit), port).crit
        want = jlit.TrainModule(JConfig(lit_cfg(crit)), net[0]).crit
        assert type(got).__name__ == type(want).__name__, crit
        assert getattr(got, "name", None) == getattr(want, "name", None)
    with pytest.raises(ValueError):
        tlit.TrainModule(lit_cfg("nope"), port)
