"""The port's FastDVDnet (``frame2frame_tpu_torch/models/fastdvdnet.py``)
against the JAX package's at 32x40 at the published widths.

- ``pixel_shuffle`` against JAX's, bit for bit;
- ``FastDVDnet`` (one 5-frame window, also packed) and ``FastDVDnetVideo``
  (7 frames) in eval mode, channels 1 and 3, with a noise map, with
  ``sigma`` and with neither, weights carried by ``from_jax_variables``, at
  the JAX package's own bound against the published torch model (max 3e-4,
  mean 3e-5, ``tests/test_models.py``);
- training mode (grayscale): the output and the moved ``batch_stats``
  against ``mutable=["batch_stats"]``, each within 1e-4 of the largest
  value of its kind, and the parameters' gradient of a mean-square loss
  against ``jax.grad``. The JAX references run in float64
  (``jax.enable_x64``, the flax modules at ``dtype=float64``). The port in
  float64 gives the same gradient to 1e-13 (held at 1e-9 in every leaf).
  In float32 the gradient of this cascade is ill-conditioned at 32x40:
  BatchNorm's batch statistics over the 80 pixels of an 8x10 level cancel,
  so the port's f32 gradient lies 4.4e-3 from float64 as a whole and 2.1e-2
  in its worst leaf, and JAX's own f32 run (flax's ``E[x^2] - E[x]^2``
  variance) up to 6e-2 in a leaf; held at 1e-2 and 5e-2;
- ``import_fastdvdnet_state_dict`` of the published torch model equal to
  JAX's import; that model's official state dict loads into the port's
  ``FastDVDnet`` with ``load_state_dict`` and gives its outputs;
- ``to_jax_variables`` after ``from_jax_variables`` bit-equal, and
  ``init_fastdvdnet``'s tree shaped as flax's ``init``.

The JAX references are jitted windows (a few seconds to compile) computed
once a module: JAX's ``FastDVDnetVideo`` runs eagerly, ~5 s a call on a CPU,
so the port's video wrapper is held frame by frame against the JAX window
model on the windows that wrapper takes.
"""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from frame2frame_tpu.models import fastdvdnet as jf  # noqa: E402
from frame2frame_tpu_torch.models import fastdvdnet as tf  # noqa: E402
from frame2frame_tpu_torch.models.serialization import (  # noqa: E402
    strip_prefix,
)

from test_models import _torch_fastdvdnet  # noqa: E402

H, W, T = 32, 40, 7
SIGMA = np.float32(25.0 / 255.0)
EVAL_MAX, EVAL_MEAN = 3e-4, 3e-5
TRAIN_RTOL = 1e-4
# gradients of the f32 port against float64: the whole vector (relative
# 2-norm) and each leaf (of its largest entry); measured 4.4e-3 and 2.1e-2
# (temp2's first BatchNorm bias). JAX's own f32 run reaches 6e-2 in a leaf
GRAD_F32_RTOL, GRAD_F32_LEAF_RTOL = 1e-2, 5e-2
F64_RTOL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one thread for this file: the suite runs several worker
    processes at once, and torch's default of a thread a core then
    oversubscribes the CPU (a 7-frame 32x40 FastDVDnet forward took 0.2 s
    alone and 30-45 s beside five other workers on eight cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def windows(T):
    """The clamped 5-frame windows of ``FastDVDnetVideo``."""
    return [[min(max(t + d, 0), T - 1) for d in (-2, -1, 0, 1, 2)]
            for t in range(T)]


def perturbed_variables(C, seed):
    """``init_fastdvdnet``'s JAX-layout tree with numpy-seeded BatchNorm
    parameters and running statistics away from 1 and 0."""
    _, v = tf.init_fastdvdnet(seed, channels=C)
    rng = np.random.default_rng(seed)

    def walk(params, stats):
        for k, p in params.items():
            if "scale" in p:
                n = p["scale"].shape[0]
                f32 = np.float32
                p["scale"] = (1 + 0.2 * rng.standard_normal(n)).astype(f32)
                p["bias"] = (0.1 * rng.standard_normal(n)).astype(f32)
                stats[k]["mean"] = (0.1 * rng.standard_normal(n)).astype(f32)
                stats[k]["var"] = (0.5 + rng.random(n)).astype(f32)
            elif "kernel" not in p:
                walk(p, stats[k])

    walk(v["params"], v["batch_stats"])
    return v


def net_level(v):
    return {"params": v["params"]["net"],
            "batch_stats": v["batch_stats"]["net"]}


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    else:
        yield path, np.asarray(tree)


def assert_eval_close(got, want):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert err.max() <= EVAL_MAX and err.mean() <= EVAL_MEAN, (err.max(),
                                                              err.mean())


def assert_rel_close(got, want, rtol=TRAIN_RTOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rtol * scale, (what,
                                                     np.abs(got - want).max(),
                                                     scale)


def f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


class Cases:
    """Weights, a 7-frame video and a noise map for C channels, with the JAX
    window model's eval outputs (f32) and its training output, moved
    statistics and (grayscale) parameter gradients of ``mean(y^2)``
    (float64), each jitted once and built on first use."""

    def __init__(self):
        self._built = {}

    def __call__(self, C):
        if C not in self._built:
            self._built[C] = self._build(C)
        return self._built[C]

    @staticmethod
    def _build(C):
        v = perturbed_variables(C, seed=10 + C)
        rng = np.random.default_rng(C)
        vid = rng.random((1, T, H, W, C)).astype(np.float32)
        nm = np.full((1, H, W, 1), SIGMA, np.float32)
        nv = net_level(v)
        net = jf.FastDVDnet(channels=C)
        ev = jax.jit(lambda x, n: net.apply(nv, x, n, train=False))
        zeros = np.zeros_like(nm)
        win = [vid[:, i] for i in windows(T)]
        out = {"C": C, "v": v, "vid": vid, "nm": nm, "window": win[3],
               "eval_nm": [np.asarray(ev(w, nm)) for w in win],
               "eval_zero": [np.asarray(ev(w, zeros)) for w in win]}
        with jax.enable_x64(True):
            net64 = jf.FastDVDnet(channels=C, dtype=jnp.float64)
            stats = f64(nv["batch_stats"])

            def loss(p, x, n):
                y, upd = net64.apply({"params": p, "batch_stats": stats}, x,
                                     n, train=True, mutable=["batch_stats"])
                return jnp.mean(y ** 2), (y, upd["batch_stats"])

            if C == 1:  # a float64 compile takes ~8 s: one channel count
                (_, (y, st)), g = jax.jit(jax.value_and_grad(
                    loss, has_aux=True))(f64(nv["params"]), f64(win[3]),
                                         f64(nm))
                out["grads"] = jax.tree_util.tree_map(np.asarray, g)
                out["train"] = (np.asarray(y),
                                jax.tree_util.tree_map(np.asarray, st))
        return out


@pytest.fixture(scope="module")
def cases():
    return Cases()


def test_pixel_shuffle_matches_jax():
    x = np.random.default_rng(0).random((2, 3, 5, 12)).astype(np.float32)
    got = tf.pixel_shuffle(torch.from_numpy(x), 2).numpy()
    want = np.asarray(jf.pixel_shuffle(jnp.asarray(x), 2))
    assert got.shape == (2, 6, 10, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("noise", ["noise_map", "none"])
def test_window_eval_matches_jax(cases, C, noise):
    case = cases(C)
    model = tf.from_jax_variables(net_level(case["v"])).eval()
    assert isinstance(model, tf.FastDVDnet)
    w = torch.from_numpy(case["vid"][:, windows(T)[3]])
    nm = torch.from_numpy(case["nm"]) if noise == "noise_map" else None
    with torch.no_grad():
        got = model(w, nm).numpy()
        # (B, H, W, 5*C) packed windows unpack to the same frames (strided
        # views: the convolutions may sum in another order)
        packed = model(w.permute(0, 2, 3, 1, 4).reshape(1, H, W, -1),
                       nm).numpy()
    want = case["eval_nm" if noise == "noise_map" else "eval_zero"][3]
    assert got.shape == (1, H, W, case["C"])
    assert_eval_close(got, want)
    np.testing.assert_allclose(packed, got, rtol=0, atol=1e-5)


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("noise", ["noise_map", "sigma", "none"])
def test_video_eval_matches_jax(cases, C, noise):
    """Every frame of the 7-frame video against the JAX window model on the
    same window, clamped at the ends as JAX's ``FastDVDnetVideo`` clamps
    them; ``sigma`` is the constant map that JAX's wrapper builds."""
    case = cases(C)
    model = tf.from_jax_variables(case["v"]).eval()
    assert isinstance(model, tf.FastDVDnetVideo)
    vid = torch.from_numpy(case["vid"])
    kw = {"noise_map": {"noise_map": torch.from_numpy(case["nm"])},
          "sigma": {"sigma": float(SIGMA)}, "none": {}}[noise]
    with torch.no_grad():
        got = model(vid, **kw).numpy()
    want = case["eval_zero" if noise == "none" else "eval_nm"]
    assert got.shape == case["vid"].shape
    assert_eval_close(got, np.stack(want, axis=1))


def test_train_forward_and_batch_stats_match_jax(cases):
    case = cases(1)
    model = tf.from_jax_variables(net_level(case["v"])).train()
    w = torch.from_numpy(case["window"])
    y = model(w, torch.from_numpy(case["nm"]))
    want_y, want_stats = case["train"]
    assert_rel_close(y.detach().numpy(), want_y, what="output")
    got = dict(leaves(tf.to_jax_variables(model)["batch_stats"]))
    want = dict(leaves(want_stats))
    assert got.keys() == want.keys()
    for path, w_leaf in want.items():
        assert_rel_close(got[path], w_leaf, what=path)
    # temp1 moved its statistics three times, temp2 once
    before = dict(leaves(case["v"]["batch_stats"]["net"]))
    k1, k2 = ("temp1", "inc", "bn0", "mean"), ("temp2", "inc", "bn0", "mean")
    for k in (k1, k2):
        assert not np.array_equal(got[k], before[k])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_parameter_gradients_match_jax_grad(cases, dtype):
    """d mean(y^2) / d params in training mode, grayscale, one window,
    against ``jax.grad`` in float64: the port in float64 the same function
    to rounding; in float32 within its conditioning."""
    case = cases(1)
    dt = getattr(torch, dtype)
    model = tf.from_jax_variables(net_level(case["v"])).to(dt).train()
    y = model(torch.from_numpy(case["window"]).to(dt),
              torch.from_numpy(case["nm"]).to(dt))
    (y ** 2).mean().backward()
    grads = copy.deepcopy(model)
    with torch.no_grad():
        for g, p in zip(grads.parameters(), model.parameters()):
            g.copy_(p.grad)
    got = dict(leaves(tf.to_jax_variables(grads)["params"]))
    want = dict(leaves(case["grads"]))
    assert got.keys() == want.keys() and len(got) == 2 * 42
    if dtype == "float64":
        for path, w_leaf in want.items():
            assert_rel_close(got[path], w_leaf, rtol=F64_RTOL, what=path)
        return
    diff = np.concatenate([(got[k] - want[k]).ravel() for k in want])
    ref = np.concatenate([want[k].ravel() for k in want])
    assert np.linalg.norm(diff) <= GRAD_F32_RTOL * np.linalg.norm(ref)
    for path, w_leaf in want.items():
        assert_rel_close(got[path], w_leaf, rtol=GRAD_F32_LEAF_RTOL,
                         what=path)


@pytest.fixture(scope="module")
def official():
    """The published torch FastDVDnet with non-trivial running statistics."""
    torch.manual_seed(0)
    tmodel = _torch_fastdvdnet().eval()
    with torch.no_grad():
        for m in tmodel.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.05)
                m.running_var.uniform_(0.7, 1.3)
    return tmodel


@pytest.mark.parametrize("video_wrapper", [False, True])
def test_import_state_dict_equals_jax_import(official, video_wrapper):
    sd = {"module." + k: v for k, v in official.state_dict().items()}
    got = dict(leaves(tf.import_fastdvdnet_state_dict(sd, video_wrapper)))
    want = dict(leaves(jf.import_fastdvdnet_state_dict(sd, video_wrapper)))
    assert got.keys() == want.keys()
    for path, w_leaf in want.items():
        assert got[path].dtype == w_leaf.dtype, path
        np.testing.assert_array_equal(got[path], w_leaf, err_msg=str(path))


def test_official_state_dict_loads_into_the_module(official):
    """The official key layout: a DataParallel state dict loads strictly
    after ``strip_prefix(sd, "module.")``; the port gives the published
    model's outputs (both on torch's CPU convolutions)."""
    sd = {"module." + k: v for k, v in official.state_dict().items()}
    model = tf.FastDVDnet(channels=3)
    model.load_state_dict(strip_prefix(sd, "module."), strict=True)
    model.eval()
    frames = np.random.default_rng(0).random((1, 5, H, W, 3)).astype(
        np.float32)
    nm = torch.full((1, 1, H, W), float(SIGMA))
    x_t = torch.from_numpy(
        frames.transpose(0, 1, 4, 2, 3).reshape(1, 15, H, W))
    with torch.no_grad():
        want = official(x_t, nm).numpy().transpose(0, 2, 3, 1)
        got = model(torch.from_numpy(frames), nm.permute(0, 2, 3, 1)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("C", [1, 3])
def test_jax_variables_round_trip_bit_equal(C):
    v = perturbed_variables(C, seed=40 + C)
    for tree in (v, net_level(v)):
        back = tf.to_jax_variables(tf.from_jax_variables(tree))
        got, want = dict(leaves(back)), dict(leaves(tree))
        assert got.keys() == want.keys()
        for path, w_leaf in want.items():
            assert got[path].tobytes() == w_leaf.tobytes(), path


def test_init_tree_shaped_as_the_official_model(official):
    """``init_fastdvdnet``'s tree has the keys and shapes of the official
    model's import, which ``tests/test_models.py`` holds to flax's model."""
    model, v = tf.init_fastdvdnet(seed=0, channels=3)
    assert isinstance(model, tf.FastDVDnetVideo)
    want = jf.import_fastdvdnet_state_dict(official.state_dict())
    assert ({p: a.shape for p, a in leaves(v)}
            == {p: a.shape for p, a in leaves(want)})
    # the published widths: 30 features a frame group in InputCvBlock
    k = v["params"]["net"]["temp1"]["inc"]["conv_group"]["kernel"]
    assert k.shape == (3, 3, 4, 90)
    # lecun normal: variance 1 / fan_in (truncated at two deviations)
    k = v["params"]["net"]["temp1"]["down1"]["cv"]["conv0"]["kernel"]
    assert abs(k.std() * np.sqrt(9 * 128) - 1) < 0.05
    last = ("params", "net", "temp2", "outc", "conv1", "kernel")
    again = dict(leaves(tf.init_fastdvdnet(seed=0, channels=3)[1]))
    other = dict(leaves(tf.init_fastdvdnet(seed=1, channels=3)[1]))
    assert np.array_equal(again[last], dict(leaves(v))[last])
    assert not np.array_equal(other[last], again[last])
