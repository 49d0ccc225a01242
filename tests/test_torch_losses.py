"""The port's losses (``frame2frame_tpu_torch/losses/``) against the JAX
package's, on the CPU.

- ``sup``, ``sup_fdvd``, ``n2n``;
- ``WarpedLoss.run_pairs`` for ``l1`` and ``l2``, with ``use_stnls`` both
  ways and with ``frame_weight``, and its gradient in the denoised video;
- ``DnlsLoss`` for ``v0`` (also with ``nmz_bwd`` and ``frame_weight``),
  ``v0_sr``, ``ssims`` and ``global_smoothing``, with gradients in the
  denoised video, its schedules and its search videos;
- ``Nb2NbLoss`` on JAX's masks (the port's draw is replaced in the test by
  JAX's, since the port draws from a ``torch.Generator``);
- ``B2ULoss.compute``, and ``test`` at 8x8 and 20x28 (reflect pads as wide
  as the frame);
- ``ComboLoss`` on both sides of ``swap``.

The denoiser is a 4-layer DnCNN, JAX's ``conv_impl="xla"`` module carried
across with ``from_jax_variables(conv_impl="xla")``. Losses within 1e-5
relative; gradients in the denoised video or the parameters within 1e-4 of
the largest.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from scipy.ndimage import gaussian_filter  # noqa: E402

from frame2frame_tpu.config import Config as JConfig  # noqa: E402
from frame2frame_tpu.losses import b2u as jb2u  # noqa: E402
from frame2frame_tpu.losses import basic as jbasic  # noqa: E402
from frame2frame_tpu.losses import nb2nb as jnb2nb  # noqa: E402
from frame2frame_tpu.losses.combo import ComboLoss as JCombo  # noqa: E402
from frame2frame_tpu.losses.stnls import DnlsLoss as JDnls  # noqa: E402
from frame2frame_tpu.losses.warped import WarpedLoss as JWarped  # noqa: E402
from frame2frame_tpu.losses.warped import time_window_inds as jtwi  # noqa: E402
from frame2frame_tpu.models.dncnn import DnCNN as JDnCNN  # noqa: E402
from frame2frame_tpu_torch.config import Config as TConfig  # noqa: E402
from frame2frame_tpu_torch.losses import b2u as tb2u  # noqa: E402
from frame2frame_tpu_torch.losses import basic as tbasic  # noqa: E402
from frame2frame_tpu_torch.losses import nb2nb as tnb2nb  # noqa: E402
from frame2frame_tpu_torch.losses.combo import ComboLoss as TCombo  # noqa: E402
from frame2frame_tpu_torch.losses.stnls import DnlsLoss as TDnls  # noqa: E402
from frame2frame_tpu_torch.losses.warped import WarpedLoss as TWarped  # noqa: E402
from frame2frame_tpu_torch.losses.warped import time_window_inds as ttwi  # noqa: E402
from frame2frame_tpu_torch.models.dncnn import init_dncnn  # noqa: E402

from test_torch_nls import hold, one_torch_thread, t_  # noqa: E402,F401

B, T, H, W, C = 1, 4, 16, 24, 1
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4


@pytest.fixture(scope="module")
def vids():
    """clean, noisy, deno (B, T, H, W, C) and fflow / bflow."""
    rng = np.random.default_rng(11)
    clean = gaussian_filter(rng.random((B, T, H, W, C)), (0, 0, 2, 2, 0))
    clean = ((clean - clean.min()) / np.ptp(clean)).astype(np.float32)
    noisy = (clean + 0.1 * rng.standard_normal(clean.shape)).astype(
        np.float32)
    deno = (clean + 0.02 * rng.standard_normal(clean.shape)).astype(
        np.float32)
    fl = [(gaussian_filter(rng.standard_normal((B, T, H, W, 2)),
                           (0, 0, 4, 4, 0)) * 10).astype(np.float32)
          for _ in range(2)]
    return clean, noisy, deno, fl[0], fl[1]


@pytest.fixture(scope="module")
def net():
    """(JAX model, variables, port module) of a 4-layer DnCNN: the port's
    seeded weights, as the JAX tree both packages run."""
    port, variables = init_dncnn(0, channels=C, num_layers=4, residual=True,
                                 conv_impl="xla")
    model = JDnCNN(channels=C, num_layers=4, residual=True, conv_impl="xla")
    return model, variables, port.eval()


def jax_apply(model, variables):
    def make(params):
        def apply_fn(x):
            return model.apply({"params": params,
                                "batch_stats": variables["batch_stats"]},
                               x, train=False)
        return apply_fn
    return make


def hold_param_grads(port, jgrads):
    """The port module's ``.grad`` against JAX's params gradient tree."""
    for name, p in port.named_parameters():
        mod, leaf = name.split(".")
        key = ("kernel" if mod.startswith("conv")
               else {"weight": "scale", "bias": "bias"}[leaf])
        g = p.grad.numpy()
        if g.ndim == 4:
            g = g.transpose(2, 3, 1, 0)
        hold(g, jgrads[mod][key], GRAD_RTOL, name)
    port.zero_grad(set_to_none=True)


@pytest.mark.parametrize("crit", ["l1", "l2"])
def test_basic_losses(vids, crit):
    clean, noisy, deno = vids[:3]
    hold(tbasic.sup_loss(t_(clean), t_(deno), crit),
         jbasic.sup_loss(clean, deno, crit), LOSS_RTOL, "sup")
    hold(tbasic.sup_fdvd_loss(t_(clean), t_(deno[:, 1]), crit),
         jbasic.sup_fdvd_loss(clean, deno[:, 1], crit), LOSS_RTOL, "fdvd")
    hold(tbasic.n2n_loss(t_(noisy), t_(deno), crit),
         jbasic.n2n_loss(noisy, deno, crit), LOSS_RTOL, "n2n")
    with pytest.raises(ValueError):
        tbasic.sup_loss(t_(clean), t_(deno), "l3")


def test_time_window_inds():
    for t in (3, 5, 6):
        for wt in (1, 2):
            for ti in range(t):
                assert ttwi(ti, wt, t) == jtwi(ti, wt, t)


@pytest.mark.parametrize("crit", ["l1", "l2"])
@pytest.mark.parametrize("use_stnls", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_warped_run_pairs(vids, crit, use_stnls, weighted):
    """The loss and its gradient in the denoised video; with
    ``frame_weight``, the (weighted sum, count) pair."""
    _, noisy, deno, ff, bf = vids
    kw = dict(dist_crit=crit, use_stnls=use_stnls, ws=3, ps=3, wt=1)
    fw = np.array([1.0, 0.0, 1.0, 0.5], np.float32) if weighted else None

    def jloss(d):
        out = JWarped(**kw).run_pairs(d, noisy, JConfig(fflow=ff, bflow=bf),
                                      frame_weight=fw)
        return out if fw is None else out[0] / out[1]

    want, grad = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(deno))
    d = t_(deno).requires_grad_(True)
    out = TWarped(**kw).run_pairs(d, t_(noisy),
                                  TConfig(fflow=t_(ff), bflow=t_(bf)),
                                  frame_weight=fw)
    if fw is not None:
        assert float(out[1]) == float(np.sum(fw) * 2)
        out = out[0] / out[1]
    hold(out, want, LOSS_RTOL, "loss")
    out.backward()
    hold(d.grad, grad, GRAD_RTOL, "d/ddeno")


DNLS_CASES = [
    dict(dist_crit="v0", stride0=2, dist_mask=0.05),
    dict(dist_crit="v0", stride0=2, dist_mask=0.05, nmz_bwd=True,
         ps_dists=5),
    dict(dist_crit="v0_sr", stride0=2, dist_mask=0.05),
    dict(dist_crit="ssims", stride0=1, k=1),
    dict(dist_crit="global_smoothing", stride0=1, dist_mask=0.05),
]


@pytest.mark.parametrize("case,weighted", [(c, False) for c in range(5)]
                         + [(0, True), (3, True)])
def test_dnls_criteria(vids, case, weighted):
    """Each criterion's loss and its gradient in the denoised video; the
    ``frame_weight`` form (as the ratio of its pair) on its two paths:
    ``_reduce`` (v0, v0_sr, global_smoothing) and the per-image ssims."""
    clean, noisy, deno, ff, bf = vids
    kw = {**dict(ws=3, wt=1, ps=3, k=2, search_input="deno", nepochs=2),
          **DNLS_CASES[case]}
    fw = np.array([1.0, 0.5, 0.0, 1.0], np.float32) if weighted else None

    def ratio(out):
        return out if fw is None else out[0] / out[1]

    def jloss(d):
        return ratio(JDnls(**kw)(noisy, clean, d, {"fflow": ff, "bflow": bf},
                                 0, frame_weight=fw))

    want, grad = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(deno))
    d = t_(deno).requires_grad_(True)
    out = ratio(TDnls(**kw)(t_(noisy), t_(clean), d,
                            {"fflow": t_(ff), "bflow": t_(bf)}, 0,
                            frame_weight=fw))
    hold(out, want, LOSS_RTOL, "loss")
    out.backward()
    hold(d.grad, grad, GRAD_RTOL, "d/ddeno")


def test_dnls_schedules():
    kw = dict(ws=5, ps=7, k=6, nepochs=5, ws_sched="lin_11",
              ps_dist_sched="2_3", ps_scale=0.7, k_decay=0.8)
    j, t = JDnls(**kw), TDnls(**kw)
    assert t.ws_grid == j.ws_grid
    for e in range(8):
        assert t.get_k(e) == j.get_k(e)
        assert t.get_ps(e) == j.get_ps(e)
        assert t.get_ps_dists(e) == j.get_ps_dists(e)
        assert t.get_ws(e) == j.get_ws(e)
    for kw in (dict(ps=7, ps_scale=0.5), dict(ps=6, ps_final=3)):
        j, t = JWarped(**kw), TWarped(**kw)
        assert [t.get_ps(s) for s in range(6)] == \
            [j.get_ps(s) for s in range(6)]


def test_dnls_search_videos(vids):
    clean, noisy, deno = vids[:3]
    for si in ("noisy", "deno", "clean", "interp"):
        got = TDnls(search_input=si).get_search_video(
            t_(noisy), t_(deno), t_(clean), 3)
        want = JDnls(search_input=si).get_search_video(noisy, deno, clean, 3)
        hold(got, want, LOSS_RTOL, si)
    # noisy-g-<sigma>: clean + sigma/255 normal noise from the generator
    loss = TDnls(search_input="noisy-g-25")
    draw = [loss.get_search_video(t_(noisy), t_(deno), t_(clean), 0,
                                  torch.Generator().manual_seed(4))
            for _ in range(2)]
    assert torch.equal(draw[0], draw[1])
    noise = (draw[0] - t_(clean)).numpy() * 255 / 25
    assert abs(noise.std() - 1) < 0.1 and abs(noise.mean()) < 0.1
    with pytest.raises(ValueError):
        TDnls(search_input="nope").get_search_video(noisy, deno, clean, 0)


def test_nb2nb_on_jax_masks(vids, net, monkeypatch):
    """The loss, the detached full denoise and the parameter gradients, on
    the masks JAX draws from its key."""
    model, variables, port = net
    noisy = vids[1]
    key = jax.random.PRNGKey(3)
    sel = jnb2nb.generate_mask_pair(key, (B * T, H, W))
    sel = tuple(torch.from_numpy(np.asarray(s, np.int64)) for s in sel)
    monkeypatch.setattr(tnb2nb, "generate_mask_pair",
                        lambda key, shape, device=None: sel)
    kw = dict(nepochs=10, epoch_ratio=2.0)
    make = jax_apply(model, variables)

    def jloss(params):
        deno, loss = jnb2nb.Nb2NbLoss(**kw).compute(make(params),
                                                    jnp.asarray(noisy), 4,
                                                    key)
        return loss, deno

    (want, deno_j), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        variables["params"])
    deno, loss = tnb2nb.Nb2NbLoss(**kw).compute(port, t_(noisy), 4,
                                                torch.Generator())
    hold(loss, want, LOSS_RTOL, "loss")
    hold(deno, deno_j, LOSS_RTOL, "deno")
    loss.backward()
    hold_param_grads(port, grads)


def test_nb2nb_masks_and_subimages():
    """The port's own draw: valid neighbour pairs, reproducible from the
    generator's seed; subimages as JAX selects them."""
    draw = [tnb2nb.generate_mask_pair(torch.Generator().manual_seed(1),
                                      (3, 8, 12)) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*draw))
    s1, s2 = draw[0]
    assert s1.shape == (3, 4, 6)
    pairs = set(zip(s1.flatten().tolist(), s2.flatten().tolist()))
    assert pairs <= set(tnb2nb._IDX_PAIRS)
    img = np.random.default_rng(2).random((3, 8, 12, 2)).astype(np.float32)
    hold(tnb2nb.generate_subimages(t_(img), s1),
         jnb2nb.generate_subimages(img, jnp.asarray(s1.numpy())), 0, "sub")


@pytest.mark.parametrize("epoch", [10, 75, 200])
def test_b2u_compute(vids, net, epoch):
    """epoch / nepochs on each side of the beta ramp."""
    model, variables, port = net
    noisy = vids[1][:, :2]
    make = jax_apply(model, variables)

    def jloss(params):
        out, loss = jb2u.B2ULoss(nepochs=100).compute(make(params),
                                                      jnp.asarray(noisy),
                                                      epoch)
        return loss, out

    (want, out_j), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        variables["params"])
    out, loss = tb2u.B2ULoss(nepochs=100).compute(port, t_(noisy), epoch)
    hold(loss, want, LOSS_RTOL, "loss")
    hold(out, out_j, LOSS_RTOL, "output")
    loss.backward()
    hold_param_grads(port, grads)


@pytest.mark.parametrize("hw", [(8, 8), (20, 28)])
def test_b2u_test(net, hw):
    """Pad-to-32 by reflection: 8x8 pads by 24 (three times the side),
    20x28 pads 12 and 4."""
    model, variables, port = net
    noisy = np.random.default_rng(hw[0]).random(
        (1, 2) + hw + (C,)).astype(np.float32)
    want = jb2u.B2ULoss.for_test().test(
        jax_apply(model, variables)(variables["params"]), jnp.asarray(noisy))
    with torch.no_grad():
        got = tb2u.B2ULoss.for_test().test(port, t_(noisy))
    hold(got, want, LOSS_RTOL)


def test_b2u_masker():
    img = np.random.default_rng(0).random((2, 8, 12, 3)).astype(np.float32)
    inputs, masks = tb2u.Masker().train(t_(img))
    j_in, j_masks = jb2u.Masker().train(jnp.asarray(img))
    hold(masks, j_masks, 0, "masks")
    hold(inputs, j_in, LOSS_RTOL, "inputs")
    m, mask = tb2u.Masker().mask(t_(img), 5)
    jm, jmask = jb2u.Masker().mask(jnp.asarray(img), 5)
    hold(m, jm, LOSS_RTOL, "mask 5")
    assert float(mask.sum()) == 6  # (8 / 4) * (12 / 4) pixels


@pytest.mark.parametrize("epoch", [1, 3])
def test_combo(vids, net, monkeypatch, epoch):
    """swap = 2: epoch 1 is Nb2Nb's, epoch 3 the stnls loss's, blended with
    Nb2Nb's at alpha 0.3."""
    model, variables, port = net
    clean, noisy, _, ff, bf = vids
    key = jax.random.PRNGKey(5)
    sel = jnb2nb.generate_mask_pair(key, (B * T, H, W))
    sel = tuple(torch.from_numpy(np.asarray(s, np.int64)) for s in sel)
    monkeypatch.setattr(tnb2nb, "generate_mask_pair",
                        lambda key, shape, device=None: sel)
    dkw = dict(ws=3, wt=1, ps=3, k=2, stride0=2, dist_mask=0.05,
               search_input="noisy")
    make = jax_apply(model, variables)

    def jloss(params):
        combo = JCombo(jnb2nb.Nb2NbLoss(nepochs=4), JDnls(**dkw), swap=2,
                       alpha=0.3)
        deno, loss = combo(make(params), jnp.asarray(noisy),
                           {"fflow": ff, "bflow": bf}, epoch, key,
                           clean=clean)
        return loss, deno

    (want, deno_j), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        variables["params"])
    combo = TCombo(tnb2nb.Nb2NbLoss(nepochs=4), TDnls(**dkw), swap=2,
                   alpha=0.3)
    deno, loss = combo(port, t_(noisy), {"fflow": t_(ff), "bflow": t_(bf)},
                       epoch, torch.Generator(), clean=t_(clean))
    hold(loss, want, LOSS_RTOL, "loss")
    hold(deno, deno_j, LOSS_RTOL, "deno")
    loss.backward()
    hold_param_grads(port, grads)
