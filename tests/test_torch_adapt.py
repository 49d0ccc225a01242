"""The port's adaptation path (``frame2frame_tpu_torch.get_loss_fxn`` ->
``train/adapt.py`` wrappers -> losses -> ``train/state.py`` ->
``train/schedules.py``) against the JAX package's, on the CPU.

- ``make_schedule``: all seven names against optax at steps 0-40, at every
  boundary and beyond the last, equal to the bit;
- ``make_optimizer``: adam and sgd, with and without ``weight_decay``, three
  updates of the same tree against the optax chain;
- ``get_loss_fxn(cfg, t)`` end to end for ``f2f``, ``f2f_plus`` and
  ``sup`` here, and ``stnls`` in ``tests/test_torch_adapt_stnls.py``
  (``flow=False``, ``adapt_isize="16_16"``, T = 6, seed 5,
  Adam at the package's adaptation learning rate, ``eval/test.py``'s 1e-4),
  with ``train_bn`` both ways: ``info.lr`` equal, ``info.loss`` within 1e-5
  relative, the final ``state.variables`` within 1e-5 of JAX's.

  With ``train_bn=True`` the forward normalises by the batch's statistics,
  which divides the convolutions' f32 rounding (~1e-7) by a channel's batch
  standard deviation (~0.1): in nearly every window some pre-activation
  lies within that noise of the ReLU's kink, so its mask, and one pixel's
  share of a channel's gradient, differ between any two f32
  implementations; Adam normalises each element, so where that share
  decides an element's sign the element moves by a whole step. There the
  losses and traces are held as above, and at least 99.5 % of the final
  variables' elements within 1e-5 (measured: 99.85 % and up over three
  seeds), the rest within two learning rates a step (an Adam step moves an
  element by at most about one learning rate, here in either direction);
- ``none`` returns the state unchanged; the window count is that of the JAX
  package's own harness test (``tests/test_harness.py``,
  ``test_adapt_wrapper``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from scipy.ndimage import gaussian_filter  # noqa: E402

import frame2frame_tpu as jpkg  # noqa: E402
import frame2frame_tpu_torch as tpkg  # noqa: E402
from frame2frame_tpu.config import Config as JConfig  # noqa: E402
from frame2frame_tpu.models.dncnn import DnCNN as JDnCNN  # noqa: E402
from frame2frame_tpu.train import schedules as jsched  # noqa: E402
from frame2frame_tpu.train.state import TrainState as JState  # noqa: E402
from frame2frame_tpu_torch.models.dncnn import init_dncnn  # noqa: E402
from frame2frame_tpu_torch.train import schedules as tsched  # noqa: E402
from frame2frame_tpu_torch.train.state import TrainState as TState  # noqa: E402

from test_torch_nls import one_torch_thread  # noqa: E402,F401

LOSS_RTOL = 1e-5
VAR_ATOL = 1e-5
LR = 1e-4
TRAIN_BN_SHARE = 0.995


SCHED_CFGS = {
    "default": dict(lr_init=1e-3, lr_final=1e-8, nepochs=4),
    "exp_decay": dict(lr_init=2e-3, lr_final=1e-6, nepochs=3),
    "step": dict(lr_init=1e-3, step_lr_size=2, step_lr_gamma=0.5,
                 nepochs=6),
    "cosa": dict(lr_init=1e-3, nepochs=4),
    "cosa_step": dict(lr_init=1e-3, lr_final=1e-5, nsteps=13),
    "multi_step": dict(lr_init=1e-3, step_lr_multisteps="3-5",
                       step_lr_gamma=0.2, nepochs=8),
    "coswr": dict(lr_init=1e-3, coswr_T0=3, coswr_Tmult=2,
                  coswr_eta_min=1e-6, nsteps=30),
    "none": dict(lr_init=3e-4),
}
SPE = 5  # steps an epoch: the epoch schedules' boundaries at 5, 10, ...


@pytest.mark.parametrize("name", sorted(SCHED_CFGS))
def test_make_schedule_is_optax(name):
    cfg = dict(SCHED_CFGS[name], scheduler_name=name)
    want = jsched.make_schedule(JConfig(cfg), SPE)
    got = tsched.make_schedule(cfg, SPE)
    # 0-40 hold every boundary (5, 10, 15, 20, 25, ...; coswr 3, 9, 21;
    # cosa_step's end 13); 45 and 60 lie past the last
    for k in list(range(41)) + [45, 60]:
        assert got(k) == float(want(k)), (name, k, got(k), float(want(k)))


def test_make_schedule_unknown():
    with pytest.raises(ValueError):
        tsched.make_schedule({"scheduler_name": "nope"})


@pytest.mark.parametrize("optim", ["adam", "sgd"])
@pytest.mark.parametrize("wd", [0.0, 1e-2])
def test_make_optimizer_is_optax(optim, wd):
    """Three updates of one tree from the same gradients, on a decaying
    schedule (a new learning rate every update)."""
    cfg = dict(optim_name=optim, weight_decay=wd, scheduler_name="exp_decay",
               lr_init=1e-2, lr_final=1e-4, nepochs=3, sgd_momentum=0.5,
               sgd_dampening=0.2)
    rng = np.random.default_rng(4)
    tree = {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in tree.items()} for _ in range(3)]
    tx, _ = jsched.make_optimizer(JConfig(cfg))
    params, state = tree, tx.init(tree)
    for g in grads:
        upd, state = tx.update(g, state, params)
        params = optax.apply_updates(params, upd)
    ptx, sched = tsched.make_optimizer(cfg)
    assert sched(2) == float(jsched.make_schedule(JConfig(cfg))(2))
    ts = {k: torch.from_numpy(v.copy()).requires_grad_(True)
          for k, v in tree.items()}
    opt = ptx.init(list(ts.values()))
    for count, g in enumerate(grads):
        for k, p in ts.items():
            p.grad = torch.from_numpy(g[k])
        ptx.step(opt, count)
    for k, p in ts.items():
        want = np.asarray(params[k])
        err = np.abs(p.detach().numpy() - want).max()
        assert err <= 1e-6 * np.abs(want).max(), (k, err)


def test_make_optimizer_unknown():
    with pytest.raises(ValueError):
        tsched.make_optimizer({"optim_name": "rmsprop"})


@pytest.fixture(scope="module")
def clip():
    rng = np.random.default_rng(3)
    clean = gaussian_filter(rng.random((1, 6, 24, 32, 1)), (0, 0, 1.5, 1.5, 0))
    clean = clean.astype(np.float32)
    noisy = (clean + 0.1 * rng.standard_normal(clean.shape)).astype(
        np.float32)
    return noisy, clean


@pytest.fixture(scope="module")
def net():
    """A 4-layer DnCNN: the port's seeded weights as the JAX tree, and the
    JAX module that runs them."""
    _, variables = init_dncnn(0, channels=1, num_layers=4, residual=True,
                              conv_impl="xla")
    return JDnCNN(channels=1, num_layers=4, residual=True,
                  conv_impl="xla"), variables


def states(net, opt_cfg):
    model, variables = net
    jtx, jsch = jsched.make_optimizer(JConfig(opt_cfg))
    ttx, tsch = tsched.make_optimizer(opt_cfg)
    port, _ = init_dncnn(1, channels=1, num_layers=4, residual=True,
                         conv_impl="xla")
    return ((JState.create(model, variables, jtx, residual=True), jsch),
            (TState.create(port, variables, ttx, residual=True), tsch))


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    else:
        yield path, np.asarray(tree, np.float64)


def run_end_to_end(net, clip, loss_type, train_bn):
    """Both packages' ``get_loss_fxn(cfg)`` wrappers on the same clip and
    weights, held as the module docstring says."""
    noisy, clean = clip
    cfg = dict(loss_type=loss_type, adapt_isize="16_16", adapt_nepochs=1,
               nbatch_sample=1, flow=False, adapt_train_bn=train_bn, ws=3,
               ps=3, k=2, stride0=2)
    opt_cfg = dict(scheduler_name="exp_decay", lr_init=LR, lr_final=1e-6,
                   nepochs=2)
    (js, jsch), (ts, tsch) = states(net, opt_cfg)
    js, jinfo = jpkg.get_loss_fxn(JConfig(cfg))(js, noisy, clean, seed=5,
                                                sched=jsch)
    ts2, tinfo = tpkg.get_loss_fxn(cfg)(ts, noisy, clean, seed=5,
                                        sched=tsch)
    nwin = 6 - (5 if loss_type.startswith("f2f") else 3) + 1
    assert len(tinfo.loss) == len(jinfo.loss) == nwin
    assert ts2.step == js.step == nwin
    assert tinfo.lr == jinfo.lr
    np.testing.assert_allclose(tinfo.loss, jinfo.loss, rtol=LOSS_RTOL,
                               atol=0)
    got = dict(leaves(ts2.variables))
    want = dict(leaves(jax.tree.map(np.asarray, js.variables)))
    assert got.keys() == want.keys()
    err = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    if not train_bn:
        assert err.max() <= VAR_ATOL, err.max()
    else:
        assert np.mean(err <= VAR_ATOL) >= TRAIN_BN_SHARE, np.mean(
            err <= VAR_ATOL)
        assert err.max() <= 2 * LR * nwin, err.max()


@pytest.mark.parametrize("loss_type", ["f2f", "f2f_plus", "sup"])
@pytest.mark.parametrize("train_bn", [False, True])
def test_get_loss_fxn_end_to_end(net, clip, loss_type, train_bn):
    run_end_to_end(net, clip, loss_type, train_bn)


def test_none_returns_the_state(net, clip):
    noisy, clean = clip
    (_, _), (ts, sch) = states(net, dict(scheduler_name="none", lr_init=LR))
    before = dict(leaves(ts.variables))
    out, info = tpkg.get_loss_fxn({}, "none")(ts, noisy, clean, seed=1,
                                             sched=sch)
    assert out is ts and info.lr == [] and info.loss == []
    after = dict(leaves(out.variables))
    assert all(np.array_equal(before[k], after[k]) for k in before)
    with pytest.raises(ValueError):
        tpkg.get_loss_fxn({}, "nope")


def test_window_count_is_the_harness_test(net):
    """``tests/test_harness.py::test_adapt_wrapper`` on the port: f2f over a
    6-frame 24x24 clip, 16x16 crops, one epoch: 2 windows, finite losses;
    ``adapt_nsteps`` caps the windows an epoch."""
    (_, _), (ts, _) = states(net, dict(scheduler_name="none", lr_init=LR,
                                       nepochs=1))
    cfg = dict(loss_type="f2f", adapt_isize="16_16", adapt_nepochs=1,
               nbatch_sample=1, flow=False)
    noisy = np.random.default_rng(3).random((1, 6, 24, 24, 1)).astype(
        np.float32)
    ts2, info = tpkg.get_loss_fxn(cfg, "f2f")(ts, noisy, noisy.copy())
    assert len(info.loss) == 2 and all(np.isfinite(info.loss))
    assert info.lr == [1, 2]  # no sched: the step count
    cfg.update(adapt_nsteps=1, adapt_nepochs=3)
    _, info = tpkg.get_loss_fxn(cfg)(ts2, noisy, noisy.copy())
    assert len(info.loss) == 3


@pytest.mark.parametrize("residual", [True, False])
def test_state_eval_apply(net, clip, residual):
    """``eval_apply`` (residual: the model returns the denoised image; else
    the noise, and the state subtracts it) against JAX's."""
    _, variables = net
    model = JDnCNN(channels=1, num_layers=4, residual=residual,
                   conv_impl="xla")
    port, _ = init_dncnn(2, channels=1, num_layers=4, residual=residual,
                         conv_impl="xla")
    tx, _ = tsched.make_optimizer({})
    ts = TState.create(port, variables, tx, residual=residual)
    jtx, _ = jsched.make_optimizer(JConfig())
    js = JState.create(model, variables, jtx, residual=residual)
    x = clip[0][0]
    want = np.asarray(js.eval_apply(jnp.asarray(x)))
    got = ts.eval_apply(x).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
