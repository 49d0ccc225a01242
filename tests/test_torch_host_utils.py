"""The port's host helpers against the JAX package's, on the CPU.

- ``config``: ``optional``, ``extract_pairs``, ``dcat``, ``cfg_grid``,
  ``mesh_grids``, ``cfg_uuid`` (the same string for the same dict),
  ``ExtractConfig``;
- ``utils``: ``ExpTimer`` / ``TimeIt``, ``GpuMemer`` / ``MemIt`` and
  ``device_mem_gb`` (zeros on the CPU, raising without a card), ``set_seed``,
  ``rslice``, ``get_region_gt``, ``slice_flows``, the pickles,
  ``profiling.annotate`` and ``peak_device_memory_mb``, the packages'
  re-exports;
- ``data.run_rand_crop``: the same crop from the same seed;
- ``io.video``: ``save_video`` -> ``load_video_dir`` / ``load_video_frames``
  in PGM, equal to the JAX package's readers;
- ``models.noise_sim``: ``sigma`` against JAX's (1e-6), ``fit`` (200 Adam
  steps) against JAX's optax fit, parameters within 1e-3, and ``run_rgb``
  from a ``torch.Generator``.
"""

import random
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from frame2frame_tpu import config as jcfg  # noqa: E402
from frame2frame_tpu import utils as jutils  # noqa: E402
from frame2frame_tpu.data import crop as jcrop  # noqa: E402
from frame2frame_tpu.io import video as jvideo  # noqa: E402
from frame2frame_tpu.models import noise_sim as jsim  # noqa: E402
from frame2frame_tpu_torch import config as tcfg  # noqa: E402
from frame2frame_tpu_torch import data as tdata  # noqa: E402
from frame2frame_tpu_torch import io as tio  # noqa: E402
from frame2frame_tpu_torch import utils as tutils  # noqa: E402
from frame2frame_tpu_torch.models import noise_sim as tsim  # noqa: E402
from frame2frame_tpu_torch.utils import profiling  # noqa: E402

BASE = {"dname": "set8", "sigma": 25, "nested": {"a": [1, 2]}, "none": None}
GRIDS = [{"sigma": [15, 25, 50], "net_name": ["dncnn", "fastdvdnet"]},
         {"iters": 20, "lr": [1e-4, 5e-5]}]


def test_config_helpers_match_jax():
    for cfg in (None, BASE, tcfg.Config(BASE)):
        for key, default in (("sigma", 0), ("none", 7), ("missing", "d")):
            assert (tcfg.optional(cfg, key, default)
                    == jcfg.optional(cfg, key, default))
    pairs = {"sigma": 10, "none": 3, "new": [1]}
    assert tcfg.extract_pairs(BASE, pairs) == jcfg.extract_pairs(BASE, pairs)
    assert tcfg.dcat(BASE, None, {"sigma": 1}) == jcfg.dcat(BASE, None,
                                                            {"sigma": 1})
    grid = tcfg.cfg_grid(BASE, GRIDS[0])
    assert grid == jcfg.cfg_grid(BASE, GRIDS[0]) and len(grid) == 6
    assert all(isinstance(c, tcfg.Config) for c in grid)
    grid[0]["nested"]["a"].append(3)  # each config is a deep copy
    assert BASE["nested"]["a"] == [1, 2]
    meshed = tcfg.mesh_grids(BASE, GRIDS)
    assert meshed == jcfg.mesh_grids(BASE, GRIDS) and len(meshed) == 8
    for cfg in meshed + [BASE, {"f": 0.1, "x": np.float32(2)}]:
        assert tcfg.cfg_uuid(cfg) == jcfg.cfg_uuid(cfg)
        assert tcfg.cfg_uuid(cfg, length=20) == jcfg.cfg_uuid(cfg, length=20)
    assert len({tcfg.cfg_uuid(c) for c in meshed}) == 8


def test_extract_config_collects_declared_pairs():
    def make(mod):
        econfig = mod.ExtractConfig(__file__)
        seen = []

        @econfig.set_init
        def init(cfg):
            econfig.init(cfg)
            cfgs = econfig({"arch": {"channels": 3, "layers": 17},
                            "io": {"path": ""}})
            lr = econfig.optional(cfg, "lr", 1e-3)
            if econfig.is_init:
                return None
            seen.append((cfgs, lr))
            return cfgs, lr

        return econfig, init, seen

    user = {"channels": 1, "lr": 5e-5, "other": True}
    (te, tinit, tseen), (je, jinit, jseen) = make(tcfg), make(jcfg)
    assert te.extract_config(user) == je.extract_config(user) == {
        "channels": 1, "layers": 17, "path": "", "lr": 5e-5}
    assert not tseen and not te.is_init  # extraction does no work
    assert tinit(tcfg.Config(user)) == jinit(jcfg.Config(user))
    assert te.extract_dict_of_pairs(user, {"a": {"lr": 0}}) == \
        je.extract_dict_of_pairs(user, {"a": {"lr": 0}})


def test_exp_timer_and_time_it():
    timer = tutils.ExpTimer()
    with tutils.TimeIt(timer, "flow"):
        time.sleep(0.01)
    with tutils.TimeIt(timer, "flow", sync=False):
        pass
    timer.start("deno")
    dt = timer.stop("deno")
    assert "timer_flow" in timer and "timer_deno" in timer
    assert timer["timer_flow"] >= 0.01 and timer["timer_deno"] == dt
    assert dict(timer.items()).keys() == {"timer_flow", "timer_deno"}
    # the same columns as the JAX package's timer
    jt = jutils.ExpTimer()
    with jutils.TimeIt(jt, "flow"):
        pass
    assert set(dict(jt.items())) == {"timer_flow"}


def test_memory_meters_on_the_cpu():
    assert tutils.device_mem_gb("cpu") == (0.0, 0.0)
    assert tutils.print_peak_gpu_stats(False, "x", device="cpu") == (0.0, 0.0)
    memer = tutils.GpuMemer()
    with tutils.MemIt(memer, "deno", device="cpu"):
        np.zeros(10)
    assert dict(memer.items()) == {"deno": (0.0, 0.0)}
    if torch.cuda.is_available():
        return
    for call in (tutils.device_mem_gb, lambda: tutils.MemIt(memer, "x"),
                 lambda: tutils.print_peak_gpu_stats(True, "x")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert profiling.peak_device_memory_mb() == {}


def test_profiling_annotate_names_a_region():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.annotate("f2f_region"):
            torch.ones(4).sum()
    assert "f2f_region" in {e.name for e in prof.events()}


def test_set_seed_seeds_every_host_generator():
    g = tutils.set_seed(11)
    assert isinstance(g, torch.Generator) and g.initial_seed() == 11
    got = (random.random(), np.random.rand(), torch.rand(1).item())
    key = jutils.set_seed(11)
    assert (random.random(), np.random.rand()) == got[:2]
    assert jnp.array_equal(key, jax.random.PRNGKey(11))
    tutils.set_seed(11)
    assert torch.rand(1).item() == got[2]
    assert torch.rand(3, generator=g).tolist() == torch.rand(
        3, generator=torch.Generator().manual_seed(11)).tolist()


def test_slices_and_pickles(tmp_path):
    vid = np.arange(2 * 5 * 8 * 12 * 3).reshape(2, 5, 8, 12, 3)
    region = (1, 4, 2, 6, 3, 9)
    np.testing.assert_array_equal(tutils.rslice(vid, region),
                                  jutils.rslice(vid, region))
    assert tutils.rslice(vid, None) is vid
    t = torch.from_numpy(vid)
    np.testing.assert_array_equal(tutils.rslice(t, region).numpy(),
                                  jutils.rslice(vid, region))
    assert tutils.get_region_gt(vid.shape[1:]) == jutils.get_region_gt(
        vid.shape[1:])
    flows = {"fflow": vid[..., :2], "bflow": vid[..., 1:]}
    got, want = (tutils.slice_flows(flows, slice(1, 3)),
                 jutils.slice_flows(flows, slice(1, 3)))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert tutils.slice_flows(None, slice(0, 1)) is None
    obj = {"psnrs": [30.5, 31.0], "cfg": tcfg.Config(BASE)}
    path = tmp_path / "sub" / "r.pkl"
    tutils.write_pickle(path, obj)
    assert tutils.read_pickle(path) == obj == jutils.read_pickle(path)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_run_rand_crop_same_crop_as_jax(seed):
    vid = np.random.default_rng(9).random((4, 30, 41, 3)).astype(np.float32)
    flow = np.random.default_rng(10).random((4, 30, 41, 2))
    got = tdata.run_rand_crop([vid, flow], (16, 20),
                              rng=np.random.default_rng(seed))
    want = jcrop.run_rand_crop([vid, flow], (16, 20),
                               rng=np.random.default_rng(seed))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == (4, 16, 20, 3) and got[1].shape == (4, 16, 20, 2)
    # torch tensors crop alike
    tgot = tdata.run_rand_crop([torch.from_numpy(vid)], (16, 20),
                               rng=np.random.default_rng(seed))
    np.testing.assert_array_equal(tgot[0].numpy(), want[0])


def test_save_video_round_trip_in_pgm(tmp_path):
    rng = np.random.default_rng(3)
    vid = rng.uniform(-10, 265, (1, 4, 12, 17, 1)).astype(np.float32)
    fns = tio.save_video(torch.from_numpy(vid), tmp_path / "out", "deno",
                         fstart=3, ext="pgm")
    assert [f.rsplit("/", 1)[1] for f in fns] == [
        f"deno_{i:05d}.pgm" for i in range(3, 7)]
    got = tio.load_video_dir(tmp_path / "out", ext="pgm")
    want = np.clip(vid[0, ..., 0], 0, 255).astype(np.uint8).astype(np.float32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, jvideo.load_video_dir(tmp_path / "out", ext="pgm"))
    tmpl = str(tmp_path / "out" / "deno_%05d.pgm")
    frames = tio.load_video_frames(tmpl, 3, 6)
    np.testing.assert_array_equal(frames, jvideo.load_video_frames(tmpl, 3, 6))
    assert frames.shape == (4, 12, 17)


def test_io_and_utils_reexports_match_jax():
    import frame2frame_tpu.io as jio

    assert tio.__all__ == jio.__all__
    for name in tio.__all__:
        assert callable(getattr(tio, name)) or name == "TAG_FLOAT"
    for name in ("GpuMemer", "MemIt", "device_mem_gb", "print_peak_gpu_stats",
                 "compute_psnrs", "compute_ssims", "compute_strred", "psnr",
                 "get_region_gt", "read_pickle", "rslice", "set_seed",
                 "slice_flows", "write_pickle", "ExpTimer", "TimeIt", "mem",
                 "metrics", "misc", "timer"):
        assert hasattr(jutils, name) and hasattr(tutils, name), name
    assert tdata.__all__ == ["run_rand_crop"]


def sim_pair(seed=0, a=1.0, b=0.02, shape=(48, 64, 3)):
    """A clean frame in [0, 255] and a noisy one drawn with sigma =
    softplus(a + b * clean)."""
    rng = np.random.default_rng(seed)
    clean = rng.uniform(0, 255, shape).astype(np.float32)
    sig = np.logaddexp(a + b * clean, 0)
    noisy = (clean + sig * rng.standard_normal(shape)).astype(np.float32)
    return clean, noisy


def test_noise_sim_sigma_and_fit_match_jax():
    clean, noisy = sim_pair()
    t = tsim.load_sim({"sim_channels": 3, "sim_sigma_a": 1.5,
                       "sim_sigma_b": 0.01}, device="cpu")
    j = jsim.load_sim({"sim_channels": 3, "sim_sigma_a": 1.5,
                       "sim_sigma_b": 0.01})
    np.testing.assert_allclose(t.sigma(clean).numpy(),
                               np.asarray(j.sigma(jnp.asarray(clean))),
                               rtol=1e-6, atol=1e-6)
    t0, j0 = tsim.load_sim(device="cpu"), jsim.load_sim()
    lt, lj = t0.fit(clean, noisy), j0.fit(clean, noisy)
    assert abs(lt - lj) <= 1e-4 * abs(lj)
    for k in ("a", "b"):
        np.testing.assert_allclose(t0.params[k].numpy(),
                                   np.asarray(j0.params[k]), rtol=0,
                                   atol=1e-3)
    # the fit found the simulator that drew the pair
    assert np.abs(t0.params["a"].numpy() - 1.0).max() < 0.1
    assert np.abs(t0.params["b"].numpy() - 0.02).max() < 2e-3


def test_noise_sim_run_rgb_from_a_generator():
    sim = tsim.HeteroscedasticGaussianSim(channels=3, a=2.0, b=0.01,
                                          device="cpu")
    clean = torch.full((64, 80, 3), 100.0)
    a = sim.run_rgb(clean, generator=torch.Generator().manual_seed(4))
    b = sim.run_rgb(clean, generator=torch.Generator().manual_seed(4))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    want_sigma = float(np.logaddexp(2.0 + 0.01 * 100.0, 0))
    assert abs(float((a - clean).std()) - want_sigma) < 0.05 * want_sigma
    assert sim.run_rgb(clean.numpy()).shape == (64, 80, 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsim.load_sim()
