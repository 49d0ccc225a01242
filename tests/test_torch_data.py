"""The port's datasets and noise (``frame2frame_tpu_torch/data/``) against
the JAX package's, on the CPU.

- ``synthetic_video`` gives the JAX package's bits for both textures;
  ``pack_raw_bayer`` its values;
- the three noise transforms on JAX's draws: the port's draw functions
  (``_normal``, ``_poisson``, ``_uniform``) are replaced by JAX's draws
  from the key JAX seeds with the same integer, and the transforms match
  within 1e-6 relative; on the port's own draws (a ``torch.Generator``)
  their moments match sigma and the rate;
- ``choose_noise_transform``'s dispatch, the Anscombe pair, JPEG artifacts
  (where PIL is installed);
- ``VideoDataset``'s samples (the ``msg`` sigma included), ``_SimpleLoader``
  at batch sizes 1 and 2 (the tail dropped as in JAX) and its
  ``ValueError`` where the split is smaller than the batch,
  ``filter_subseq`` and ``slice_sample``;
- a directory dataset of PGM frames the test writes, with ``read_flows``:
  flows within 1e-4 px of the JAX package's (the golden flows' limit of
  ``tests/test_torch_tvl1.py``), and the ``.flo`` sidecars each package
  writes are read by the other, bit for bit.
"""

import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from frame2frame_tpu.config import Config as JConfig  # noqa: E402
from frame2frame_tpu.data import datasets as jds  # noqa: E402
from frame2frame_tpu.data import noise as jnoise  # noqa: E402
from frame2frame_tpu_torch.data import datasets as tds  # noqa: E402
from frame2frame_tpu_torch.data import noise as tnoise  # noqa: E402
from frame2frame_tpu_torch.data import sets  # noqa: E402
from frame2frame_tpu_torch.io.image import write_pgm  # noqa: E402

from test_torch_nls import one_torch_thread  # noqa: E402,F401

FLOW_ATOL = 1e-4  # px


def arr(x):
    return torch.from_numpy(np.array(x))


def patch_draws(monkeypatch, ntype):
    """Replace the port's draws by JAX's: a draw from a generator seeded
    with s is JAX's draw from ``PRNGKey(s)`` (split as JAX's transform
    splits it)."""
    def keys(gen):
        key = jax.random.PRNGKey(gen.initial_seed())
        return jax.random.split(key) if ntype != "g" else (key, key)

    def normal(gen, shape, dtype, device):
        return arr(jax.random.normal(keys(gen)[1], tuple(shape), jnp.float32))

    def poisson(gen, lam):
        return arr(jax.random.poisson(keys(gen)[0], jnp.asarray(lam.numpy())))

    def uniform(gen, shape, low, high, dtype, device):
        return arr(jax.random.uniform(keys(gen)[0], tuple(shape), jnp.float32,
                                      low, high))

    monkeypatch.setattr(tnoise, "_normal", normal)
    monkeypatch.setattr(tnoise, "_poisson", poisson)
    monkeypatch.setattr(tnoise, "_uniform", uniform)


@pytest.mark.parametrize("texture,channels", [
    ("smooth", 1), ("mixed", 1), ("mixed", 3)])
def test_synthetic_video_bits(texture, channels):
    for seed in (0, 1001):
        want = jds.synthetic_video(seed, 4, 24, 40, channels, shift=(2, -1),
                                   texture=texture)
        got = tds.synthetic_video(seed, 4, 24, 40, channels, shift=(2, -1),
                                  texture=texture)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_pack_raw_bayer():
    raw = np.random.default_rng(0).random((2, 8, 12))
    for x in (raw, raw[0]):
        want = jds.pack_raw_bayer(x)
        got = tds.pack_raw_bayer(x)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


NOISE_CFGS = {
    "g": dict(ntype="g", sigma=25.0),
    "pg": dict(ntype="pg", rate=8.0, sigma=5.0),
    "msg": dict(ntype="msg", sigma_min=5.0, sigma_max=50.0),
}


@pytest.mark.parametrize("ntype,shape", [
    ("g", (3, 8, 10, 1)), ("pg", (3, 8, 10, 1)), ("msg", (3, 8, 10, 1)),
    ("msg", (2, 3, 8, 10, 1))])
def test_noise_on_jax_draws(ntype, shape, monkeypatch):
    patch_draws(monkeypatch, ntype)
    clean = (255 * np.random.default_rng(1).random(shape)).astype(np.float32)
    seed = 7919 + 2
    jt = jnoise.choose_noise_transform(JConfig(NOISE_CFGS[ntype]))
    tt = tnoise.choose_noise_transform(NOISE_CFGS[ntype])
    key, gen = jax.random.PRNGKey(seed), torch.Generator().manual_seed(seed)
    if ntype == "msg":
        want, wsig = jt(key, jnp.asarray(clean), return_sigma=True)
        got, gsig = tt(gen, clean, return_sigma=True)
        np.testing.assert_allclose(gsig.numpy(), np.asarray(wsig),
                                   rtol=1e-6)
        assert gsig.shape == (shape[0],)
    else:
        want, got = jt(key, jnp.asarray(clean)), tt(gen, clean)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()


def test_noise_own_draws():
    """The port's own draws: reproducible from the generator's seed, with
    the moments of each model."""
    clean = np.full((4, 64, 64, 1), 128.0, np.float32)
    g = tnoise.GaussianNoise(20.0)
    a = g(torch.Generator().manual_seed(3), clean)
    assert torch.equal(a, g(torch.Generator().manual_seed(3), clean))
    r = (a - 128.0).numpy()
    assert abs(r.std() - 20.0) < 0.5 and abs(r.mean()) < 0.5
    # Poisson-Gaussian: mean at the clean value, variance
    # 255^2 * (clean/255) / rate + sigma^2
    pg = tnoise.PoissonGaussianNoise(rate=30.0, sigma=4.0)
    r = pg(torch.Generator().manual_seed(3), clean).numpy()
    var = 255.0**2 * (128.0 / 255.0) / 30.0 + 16.0
    assert abs(r.mean() - 128.0) < 1.0 and abs(r.var() / var - 1) < 0.05
    # multi-scale: one sigma per video in [min, max)
    msg = tnoise.MultiScaleGaussianNoise(5.0, 50.0)
    out, sig = msg(torch.Generator().manual_seed(3), clean[None].repeat(3, 0),
                   return_sigma=True)
    assert sig.shape == (3,) and bool(((sig >= 5) & (sig < 50)).all())
    for b in range(3):
        s = float((out[b] - 128.0).std())
        assert abs(s / float(sig[b]) - 1) < 0.05


def test_choose_noise_transform():
    for cfg, cls, attrs in (
            ({}, tnoise.GaussianNoise, dict(sigma=25.0)),
            ({"ntype": "pg"}, tnoise.PoissonGaussianNoise,
             dict(rate=10.0, sigma=0.0)),
            ({"ntype": "msg", "sigma_min": 2, "sigma_max": 4},
             tnoise.MultiScaleGaussianNoise,
             dict(sigma_min=2.0, sigma_max=4.0, sigma=3.0))):
        t = tnoise.choose_noise_transform(cfg)
        j = jnoise.choose_noise_transform(JConfig(cfg))
        assert isinstance(t, cls) and t.ntype == j.ntype
        for k, v in attrs.items():
            assert getattr(t, k) == getattr(j, k) == v
    with pytest.raises(ValueError):
        tnoise.choose_noise_transform({"ntype": "nope"})


def test_anscombe():
    x = np.linspace(0, 300, 97)
    np.testing.assert_allclose(tnoise.anscombe(x), jnoise.anscombe(x),
                               rtol=1e-12, atol=0)
    y = tnoise.anscombe(x)
    np.testing.assert_allclose(tnoise.anscombe_inverse(y),
                               jnoise.anscombe_inverse(y), rtol=1e-12, atol=0)


def test_add_jpeg_artifacts():
    pytest.importorskip("PIL")
    clean = 255 * np.random.default_rng(2).random((2, 16, 24))
    got = tnoise.add_jpeg_artifacts(clean, quality=20)
    np.testing.assert_array_equal(got, jnoise.add_jpeg_artifacts(clean, 20))
    assert got.dtype == np.float32 and got.shape == clean.shape


SYN = dict(dname="synthetic", nvideos=3, nframes_data=4, isize_data=(16, 24),
           channels=1, sigma=25.0)


@pytest.mark.parametrize("ntype", sorted(NOISE_CFGS))
def test_video_dataset_sample(ntype, monkeypatch):
    patch_draws(monkeypatch, ntype)
    cfg = dict(SYN, **NOISE_CFGS[ntype])
    jdata, _ = jds.load(JConfig(cfg))
    tdata, _ = sets.load(cfg)
    for split in ("tr", "te"):
        assert len(tdata[split]) == len(jdata[split]) == 3
        assert tdata[split].names == jdata[split].names
        for i in (0, 2):
            want, got = jdata[split][i], tdata[split][i]
            assert sorted(got) == sorted(want)
            np.testing.assert_array_equal(got.clean, want.clean)
            n = np.asarray(want.noisy)
            assert got.noisy.dtype == np.float32
            assert np.abs(got.noisy - n).max() <= 1e-6 * np.abs(n).max()
            np.testing.assert_array_equal(got.fnums, want.fnums)
            assert (got.index, got.region, got.vid_name) == (
                want.index, want.region, want.vid_name)
            # msg: the sample carries the drawn sigma
            assert abs(got.sigma - want.sigma) <= 1e-6 * want.sigma
            if ntype == "msg":
                assert got.sigma != 27.5


@pytest.mark.parametrize("bs", [1, 2])
def test_simple_loader(bs, monkeypatch):
    patch_draws(monkeypatch, "g")
    cfg = dict(SYN, batch_size=bs)
    _, jl = jds.load(JConfig(cfg))
    _, tl = sets.load(cfg)
    assert len(tl.tr) == len(jl.tr) == 3 // bs
    assert len(tl.val) == len(jl.val) == 3
    for want, got in zip(jl.tr, tl.tr):
        assert sorted(got) == sorted(want)
        assert got.noisy.shape == (bs, 4, 16, 24, 1)
        np.testing.assert_array_equal(got.clean, want.clean)
        n = np.asarray(want.noisy)
        assert np.abs(got.noisy - n).max() <= 1e-6 * np.abs(n).max()
        assert got.index == want.index and got.vid_name == want.vid_name
        assert got.sigma == want.sigma
    # batch of two: the third video (the tail) is dropped
    assert [b.index for b in tl.tr] == ([0, 1, 2] if bs == 1 else [[0, 1]])


def test_loader_smaller_split_raises():
    """A split smaller than the batch yields no batch in JAX (the trainer
    then writes an untrained checkpoint); the port raises."""
    cfg = dict(SYN, batch_size=4)
    _, jl = jds.load(JConfig(cfg))
    assert list(jl.tr) == []
    _, tl = sets.load(cfg)
    with pytest.raises(ValueError, match="batch_size 4"):
        next(iter(tl.tr))
    assert len(list(tl.val)) == 3


def test_filter_subseq_and_slice_sample():
    tdata, _ = sets.load(SYN)
    jdata, _ = jds.load(JConfig(SYN))
    for name in ("vid01", "vid", "nope"):
        assert (tds.filter_subseq(tdata.val, name, 0, -1)
                == jds.filter_subseq(jdata.val, name, 0, -1))
    s = tdata.val[1]
    s.fflow = np.zeros((4, 16, 24, 2), np.float32)
    assert tds.slice_sample(s, 0, -1) is s
    got = tds.slice_sample(s, 1, 2)
    want = jds.slice_sample(JConfig(s), 1, 2)
    for k in ("noisy", "clean", "fflow", "fnums"):
        np.testing.assert_array_equal(got[k], want[k])
    assert got.clean.shape[0] == 2 and s.clean.shape[0] == 4


def test_load_errors(tmp_path):
    with pytest.raises(FileNotFoundError):
        sets.load({"dname": "none_here", "data_root": str(tmp_path)})


def write_dir_dataset(root):
    """Two 3-frame 32x48 grayscale PGM videos: a moving texture."""
    for v in range(2):
        vid = tds.synthetic_video(50 + v, 3, 32, 48, shift=(1, 2))
        d = root / "pgmset" / f"clip{v}"
        d.mkdir(parents=True)
        for t, frame in enumerate(vid[..., 0]):
            write_pgm(d / f"{t:03d}.pgm", np.round(frame))


@pytest.fixture(scope="module")
def dir_sets(tmp_path_factory):
    """The same frames in two roots: JAX solves and writes its sidecars in
    one, the port in the other."""
    a, b = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")
    write_dir_dataset(a)
    shutil.copytree(a / "pgmset", b / "pgmset")
    cfg = dict(dname="pgmset", read_flows=True, sigma=25.0)
    jdata, _ = jds.load(JConfig(cfg, data_root=str(a)))
    tdata, _ = sets.load(dict(cfg, data_root=str(b)), device="cpu")
    return a, b, cfg, jdata.te[1], tdata.te[1]


def test_dir_dataset_flows(dir_sets):
    a, b, cfg, want, got = dir_sets
    assert got.vid_name == want.vid_name == "clip1"
    np.testing.assert_array_equal(got.clean, want.clean)
    assert got.clean.shape == (3, 32, 48, 1)
    for k in ("fflow", "bflow"):
        assert got[k].shape == (3, 32, 48, 2) and got[k].dtype == np.float32
        assert np.abs(got[k] - np.asarray(want[k])).max() <= FLOW_ATOL
    assert np.abs(got.fflow[:2]).max() > 0.5
    for root in (a, b):
        fdir = root / "pgmset" / "clip1" / ".flows"
        assert sorted(p.name for p in fdir.iterdir()) == [
            f"{d}_{t:05d}.flo" for d in "bf" for t in range(3)]


def test_dir_dataset_sidecars_cross_read(dir_sets, monkeypatch):
    """Each package reads the other's sidecars, bit for bit, and solves
    nothing."""
    a, b, cfg, jsample, tsample = dir_sets
    from frame2frame_tpu.flow import api as japi
    from frame2frame_tpu_torch.flow import api as tapi

    def no_solve(*a, **k):
        raise AssertionError("solved flows where sidecars exist")

    monkeypatch.setattr(tapi, "run_flows", no_solve)
    monkeypatch.setattr(japi, "run_flows", no_solve)
    port_reads, _ = sets.load(dict(cfg, data_root=str(a)))
    jax_reads, _ = jds.load(JConfig(cfg, data_root=str(b)))
    for k in ("fflow", "bflow"):
        np.testing.assert_array_equal(port_reads.te[1][k],
                                      np.asarray(jsample[k]))
        np.testing.assert_array_equal(np.asarray(jax_reads.te[1][k]),
                                      tsample[k])


def test_flows_default_to_the_card(tmp_path):
    """Without a device the flows solve on the CUDA card, which this host
    lacks: the solve raises, and a dataset without ``read_flows`` needs no
    device."""
    write_dir_dataset(tmp_path)
    cfg = dict(dname="pgmset", data_root=str(tmp_path))
    data, _ = sets.load(cfg)
    assert data.te[0].clean.shape == (3, 32, 48, 1)
    data, _ = sets.load(dict(cfg, read_flows=True))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            data.te[0]
