"""The port's model registry (``frame2frame_tpu_torch/models/__init__.py``)
and checkpoint I/O against the JAX package's, on the CPU.

- ``load_model(cfg, device="cpu").apply`` against JAX's ``load_model(cfg).
  apply``: DnCNN-4 on ``conv_impl="xla"`` within 1e-5, on ``"fused"`` (the
  module route on the CPU: the bf16 graph) at that graph's bound (rtol 0.03,
  atol 0.02, ``tests/test_torch_dncnn_conv_impl.py``), FastDVDnet within the
  JAX package's own bound (max 3e-4, mean 3e-5) against the model JAX's
  ``apply`` runs; both packages restore the same msgpack file
  (``pretrained_load``), which JAX's ``save_variables`` wrote;
- ``apply(train=True)``: the output and the moved ``batch_stats`` against
  ``mutable=["batch_stats"]``; the module keeps its own statistics;
- the registry's names: an unknown ``net_name``, ``extract_model_config``;
- ``load_checkpoint`` from that msgpack file and from a ``.pth`` of the
  reference torch DnCNN (``tests/test_online_parity.py``), equal to JAX's;
- ``load_variables(like=)`` on a mismatched tree, ``save_train_state(
  extra=)`` read by JAX's ``load_train_state`` and the reverse, bit-equal;
- without ``device``, ``load_model`` runs on the card, and raises on a host
  without one.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import frame2frame_tpu as jpkg  # noqa: E402
import frame2frame_tpu_torch as tpkg  # noqa: E402
from frame2frame_tpu import models as jmodels  # noqa: E402
from frame2frame_tpu.models import serialization as jser  # noqa: E402
from frame2frame_tpu_torch import models as tmodels  # noqa: E402
from frame2frame_tpu_torch.models import serialization as tser  # noqa: E402

from test_online_parity import build_torch_dncnn  # noqa: E402
from test_torch_fused_apply import perturbed_model  # noqa: E402

H, W = 16, 32
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=0.03, atol=0.02)
FDV_MAX, FDV_MEAN = 3e-4, 3e-5


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


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    else:
        yield path, tree


def assert_same_tree(got, want):
    got, want = dict(leaves(got)), dict(leaves(want))
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = np.asarray(got[path])
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert g.tobytes() == w.tobytes(), path


def dncnn_cfg(path, conv_impl):
    return {"net_name": "dncnn", "channels": 1, "num_of_layers": 4,
            "conv_impl": conv_impl, "pretrained_load": True,
            "pretrained_path": str(path)}


@pytest.fixture(scope="module")
def dncnn_ckpt(tmp_path_factory):
    """A DnCNN-4 with non-trivial BatchNorm, written by JAX's
    ``save_variables``."""
    _, variables = perturbed_model(H, W, seed=3, residual=True,
                                   conv_impl="xla", num_layers=4)
    path = tmp_path_factory.mktemp("dncnn") / "dncnn4.msgpack"
    jser.save_variables(path, variables)
    return path, variables


def frames(seed, B=2):
    return np.random.default_rng(seed).random((B, H, W, 1)).astype(np.float32)


@pytest.mark.parametrize("conv_impl,tol", [("xla", F32_TOL),
                                           ("fused", BF16_TOL)])
def test_load_model_dncnn_matches_jax(dncnn_ckpt, conv_impl, tol):
    path, _ = dncnn_ckpt
    cfg = dncnn_cfg(path, conv_impl)
    x = frames(4)
    want = np.asarray(jpkg.load_model(cfg).apply(jnp.asarray(x)))
    got = tpkg.load_model(cfg, device="cpu")
    assert isinstance(got.model, tmodels.DnCNN) and not got.video_model
    assert got.model.conv_impl == conv_impl and got.model.residual
    out = got.apply(x)
    assert isinstance(out, torch.Tensor) and not out.requires_grad
    np.testing.assert_allclose(out.numpy(), want, **tol)


def test_train_apply_matches_jax_mutable(dncnn_ckpt):
    path, _ = dncnn_ckpt
    cfg = dncnn_cfg(path, "xla")
    x = frames(5)
    jl = jpkg.load_model(cfg)
    want_y, want_upd = jl.apply(jnp.asarray(x), train=True)
    got = tpkg.load_model(cfg, device="cpu")
    before = got.apply(x).numpy()
    y, upd = got.apply(x, train=True)
    assert set(upd) == {"batch_stats"} and y.requires_grad
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               **F32_TOL)
    want = dict(leaves(jax.tree_util.tree_map(np.asarray,
                                              want_upd["batch_stats"])))
    stats = dict(leaves(upd["batch_stats"]))
    assert stats.keys() == want.keys()
    for path_, w in want.items():
        np.testing.assert_allclose(stats[path_], w, **F32_TOL)
    # the gradient reaches the module's parameters
    y.square().mean().backward()
    assert got.model.conv_in.weight.grad is not None
    # functional, as JAX's apply: the module's statistics are unchanged
    np.testing.assert_array_equal(got.apply(x).numpy(), before)
    assert not got.model.training


@pytest.fixture(scope="module")
def fdv_ckpt(tmp_path_factory):
    from test_torch_fastdvdnet import perturbed_variables

    variables = perturbed_variables(1, seed=7)
    path = tmp_path_factory.mktemp("fdv") / "fdv.msgpack"
    jser.save_variables(path, variables)
    return path


@pytest.mark.parametrize("net_name", ["fastdvdnet", "fdvd"])
def test_load_model_fastdvdnet_matches_jax(fdv_ckpt, net_name):
    """Three 32x40 grayscale frames (windows clamped at both ends) with a
    sigma map. JAX's ``load_model`` first runs flax's ``init`` eagerly (17 s
    on a CPU), so the reference is what its ``apply`` then runs: JAX's
    ``FastDVDnetVideo`` on the variables JAX's ``load_checkpoint`` restores
    from the same file, jitted."""
    cfg = {"net_name": net_name, "channels": 1, "pretrained_load": True,
           "pretrained_path": str(fdv_ckpt)}
    vid = np.random.default_rng(6).random((1, 3, 32, 40, 1)).astype(
        np.float32)
    got = tpkg.load_model(cfg, device="cpu")
    assert got.video_model and isinstance(got.model,
                                          tmodels.FastDVDnetVideo)
    out = got.apply(vid, sigma=25.0 / 255.0).numpy()
    assert_same_tree(got.variables, tser.load_variables(fdv_ckpt))
    if net_name == "fdvd":  # the same model by its other name
        other = tpkg.load_model(dict(cfg, net_name="fastdvdnet"),
                                device="cpu")
        np.testing.assert_array_equal(
            other.apply(vid, sigma=25.0 / 255.0).numpy(), out)
        return
    variables = jmodels.load_checkpoint(got.variables, str(fdv_ckpt))
    model = jmodels.FastDVDnetVideo(channels=1)
    want = np.asarray(jax.jit(lambda v, x: model.apply(
        v, x, train=False, sigma=25.0 / 255.0))(variables, jnp.asarray(vid)))
    err = np.abs(out - want)
    assert out.shape == vid.shape
    assert err.max() <= FDV_MAX and err.mean() <= FDV_MEAN


def test_fastdvdnet_train_apply_with_a_noise_map():
    """``apply(train=True, noise_map=array)``: the map becomes a tensor on
    the model's device, and the statistics come back at the JAX layout."""
    got = tpkg.load_model({"net_name": "fastdvdnet", "channels": 3},
                          device="cpu")
    vid = np.random.default_rng(8).random((1, 5, 16, 24, 3)).astype(
        np.float32)
    nm = np.full((1, 16, 24, 1), 0.1, np.float32)
    y, upd = got.apply(vid, train=True, noise_map=nm)
    assert y.shape == vid.shape
    before = dict(leaves(got.variables["batch_stats"]))
    after = dict(leaves(upd["batch_stats"]))
    assert before.keys() == after.keys()
    assert all(p[0] == "net" for p in after)
    assert not np.array_equal(after[("net", "temp1", "inc", "bn0", "mean")],
                              before[("net", "temp1", "inc", "bn0", "mean")])


def test_unknown_net_name_raises():
    with pytest.raises(ValueError, match="Unknown model type"):
        tpkg.load_model({"net_name": "unet"}, device="cpu")
    with pytest.raises(ValueError, match="model_dtype"):
        tpkg.load_model({"model_dtype": "bfloat16"}, device="cpu")


@pytest.mark.parametrize("cfg", [
    None, {}, {"net_name": "fastdvdnet", "channels": 1, "extra": 3},
    {"num_of_layers": 5, "conv_impl": "fused", "pretrained_path": "x",
     "residual": None}])
def test_extract_model_config_matches_jax(cfg):
    got = tpkg.extract_model_config(cfg)
    want = jpkg.extract_model_config(cfg)
    assert got == want and type(got).__name__ == "Config"
    assert tmodels.arch_pairs() == jmodels.arch_pairs()
    assert tmodels.io_pairs() == jmodels.io_pairs()
    assert tmodels.FASTDVD_NAMES == jmodels.FASTDVD_NAMES


def test_load_checkpoint_msgpack_matches_jax(dncnn_ckpt):
    path, variables = dncnn_ckpt
    _, like = tmodels.init_dncnn(seed=1, channels=1, num_layers=4)
    got = tmodels.load_checkpoint(like, path, num_layers=4)
    want = jax.tree_util.tree_map(np.asarray, jmodels.load_checkpoint(
        like, path, num_layers=4))
    assert_same_tree(got, want)
    assert_same_tree(got, variables)


@pytest.mark.parametrize("suffix", [".pth", ".pt"])
def test_load_checkpoint_pth_matches_jax(tmp_path, suffix):
    """A reference torch DnCNN's state dict (``dncnn.*`` keys behind
    DataParallel's ``module.``), loaded as JAX's ``load_checkpoint`` loads
    it; the loaded model denoises as the torch model does."""
    torch.manual_seed(0)
    seq = build_torch_dncnn(channels=1, num_of_layers=4).eval()
    with torch.no_grad():
        for m in seq:
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.05)
                m.running_var.uniform_(0.7, 1.3)
    path = tmp_path / f"net{suffix}"
    torch.save({"module.dncnn." + k: v for k, v in seq.state_dict().items()},
               path)
    _, like = tmodels.init_dncnn(seed=1, channels=1, num_layers=4)
    got = tmodels.load_checkpoint(like, path, num_layers=4)
    want = jax.tree_util.tree_map(np.asarray, jmodels.load_checkpoint(
        like, str(path), num_layers=4))
    assert_same_tree(got, want)
    loaded = tpkg.load_model(dict(dncnn_cfg(path, "xla")), device="cpu")
    x = frames(9)
    with torch.no_grad():
        noise = seq(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(loaded.apply(x).numpy(),
                               x - noise.permute(0, 2, 3, 1).numpy(),
                               **F32_TOL)


def test_fused_model_takes_the_module_route_on_the_cpu(dncnn_ckpt,
                                                       monkeypatch):
    """The fused kernels serve a ``"fused"`` DnCNN on a card only; on the
    CPU ``apply`` is the module's forward."""
    def no_fused(*a, **k):
        raise AssertionError("fused_eval_apply_batch on the CPU")

    monkeypatch.setattr(tmodels, "fused_eval_apply_batch", no_fused)
    path, _ = dncnn_ckpt
    loaded = tpkg.load_model(dncnn_cfg(path, "fused"), device="cpu")
    x = frames(10)
    with torch.no_grad():
        want = loaded.model(torch.from_numpy(x))
    np.testing.assert_array_equal(loaded.apply(x).numpy(), want.numpy())


@pytest.mark.parametrize("bad", ["missing", "extra", "leaf"])
def test_load_variables_like_raises_on_a_mismatched_tree(dncnn_ckpt, bad):
    path, variables = dncnn_ckpt
    like = jax.tree_util.tree_map(np.asarray, variables)
    if bad == "missing":
        like["params"]["conv_9"] = {"kernel": np.zeros(1, np.float32)}
    elif bad == "extra":
        del like["batch_stats"]
    else:
        like["params"]["conv_in"] = np.zeros(1, np.float32)
    with pytest.raises(ValueError):
        tser.load_variables(path, like=like)


def _train_state():
    rng = np.random.default_rng(12)
    params = {"conv_in": {"kernel": rng.random((3, 3, 1, 4), np.float32)}}
    opt_state = {"count": np.asarray(7, np.int32),
                 "m": rng.random(36).astype(np.float32),
                 "v": rng.random(36).astype(np.float32)}
    stats = {"bn_0": {"mean": rng.random(4).astype(np.float32),
                      "var": rng.random(4).astype(np.float32)}}
    extra = {"frame": 5, "lr": 5e-5, "losses": [np.float32(0.25), 0.5],
             "name": "f2f", "shape": (540, 960), "none": None}
    return params, opt_state, stats, extra


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_train_state_crosses_between_packages(tmp_path, writer):
    params, opt_state, stats, extra = _train_state()
    like = {"params": params, "opt_state": opt_state, "batch_stats": stats,
            "extra": extra}
    paths = {}
    for who, ser in (("port", tser), ("jax", jser)):
        paths[who] = tmp_path / f"{who}.msgpack"
        ser.save_train_state(paths[who], params, opt_state,
                             batch_stats=stats, extra=extra)
    # the port writes the JAX package's bytes
    assert paths["port"].read_bytes() == paths["jax"].read_bytes()
    reader = jser if writer == "port" else tser
    back = reader.load_train_state(paths[writer], like)
    back = jax.tree_util.tree_map(np.asarray, back)
    for name in ("params", "opt_state", "batch_stats"):
        assert_same_tree(back[name], like[name])
    got = back["extra"]
    assert isinstance(got["losses"], list) and isinstance(got["shape"], tuple)
    assert got["shape"] == (540, 960) and got["none"] is None
    assert got["frame"] == 5 and got["name"] == "f2f" and got["lr"] == 5e-5
    assert np.float32(got["losses"][0]) == np.float32(0.25)


def test_load_model_without_a_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpkg.load_model({"channels": 1, "num_of_layers": 4})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmodels.load_model({"net_name": "fastdvdnet"})
