"""The port's study scripts (``scripts/torch_instances_adapt.py``,
``scripts/torch_noise_sweep.py``, ``scripts/torch_accuracy_artifact.py``)
against the JAX package's twins, on the CPU.

- helpers against JAX's: ``split_vids``; ``load_raw_burst`` on ``.npy``
  bursts (packed and mosaic, black and white levels, Anscombe);
  ``set_pretrained_path`` (the sigma table and the file-name fallback);
  ``make_sequence``'s frames, written as PGM, equal to JAX's PNG frames;
- ``torch_instances_adapt.run`` on a tiny config (a 4-layer DnCNN from one
  checkpoint found through ``pretrained_root``, a 6-frame 32x32 synthetic
  clip, "sup" adaptation on 32x32 crops, chunked evaluation) against JAX's
  ``run``: every held-out frame's PSNR within 1e-3 dB, SSIM within 1e-5,
  the adaptation losses within 1e-4 relative; then its ``main`` through
  the cache;
- ``torch_noise_sweep.run_condition`` (pretrain, then the streaming CLI on
  the PGM frames) and ``torch_accuracy_artifact``'s ``trajectory`` and
  ``oracle`` on the committed DnCNN-17 checkpoint, run by the port alone
  at tiny sizes (their JAX twins compile the streaming step for tens of
  seconds): the files they write, finite PSNRs, the stats' keys, and the
  artifact script refusing to write into ``results/dncnn17_s25``.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from frame2frame_tpu.models import serialization as jser  # noqa: E402
from frame2frame_tpu_torch.data import noise as tnoise  # noqa: E402
from frame2frame_tpu_torch.models.dncnn import init_dncnn  # noqa: E402

from test_torch_nls import one_torch_thread  # noqa: E402,F401

REPO = Path(__file__).resolve().parents[1]


def load_script(name):
    spec = importlib.util.spec_from_file_location(
        "study_" + name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scripts():
    return {n: load_script(n) for n in (
        "instances_adapt", "torch_instances_adapt", "noise_sweep",
        "torch_noise_sweep", "torch_accuracy_artifact")}


@pytest.fixture(autouse=True)
def jax_dataset_draws(monkeypatch):
    def normal(gen, shape, dtype, device):
        key = jax.random.PRNGKey(gen.initial_seed())
        return torch.from_numpy(np.array(
            jax.random.normal(key, tuple(shape), jnp.float32))).to(device)

    monkeypatch.setattr(tnoise, "_normal", normal)


def test_split_vids(scripts):
    rng = np.random.default_rng(0)
    n, c = rng.random((1, 6, 4, 4, 1)), rng.random((1, 6, 4, 4, 1))
    got = scripts["torch_instances_adapt"].split_vids(n, c, 4)
    want = scripts["instances_adapt"].split_vids(n, c, 4)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape,extra", [
    ((3, 8, 10, 4), {}),
    ((3, 16, 20), {"raw_black_level": 64.0, "raw_white_level": 1023.0}),
    ((16, 20), {"use_anscombe": True, "anscombe_gain": 500.0}),
])
def test_load_raw_burst_npy(scripts, tmp_path, shape, extra):
    raw = np.random.default_rng(1).uniform(0, 1023, shape).astype(np.float32)
    np.save(tmp_path / "burst.npy", raw)
    cfg = dict(raw_path=str(tmp_path / "burst.npy"), **extra)
    got = scripts["torch_instances_adapt"].load_raw_burst(cfg)
    want = scripts["instances_adapt"].load_raw_burst(cfg)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_set_pretrained_path(scripts, tmp_path):
    (tmp_path / "dncnn-sigma25.msgpack").write_bytes(b"")
    (tmp_path / "table").mkdir()
    (tmp_path / "table" / "sigma_table.json").write_text(
        json.dumps({"dncnn": {"50": "x.msgpack"}}))
    for cfg in ({"pretrained_root": str(tmp_path), "sigma": 25},
                {"pretrained_root": str(tmp_path), "sigma": 15},
                {"pretrained_root": str(tmp_path / "table"), "sigma": 50},
                {"sigma": 25}):
        got = scripts["torch_instances_adapt"].set_pretrained_path(dict(cfg))
        want = scripts["instances_adapt"].set_pretrained_path(dict(cfg))
        assert got == want


@pytest.mark.parametrize("noise", [{"kind": "g", "sigma": 25},
                                   {"kind": "pg", "rate": 30, "sigma": 5}])
def test_make_sequence_pgm(scripts, tmp_path, noise):
    from PIL import Image

    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    got = scripts["torch_noise_sweep"].make_sequence(noise, tmp_path / "p")
    want = scripts["noise_sweep"].make_sequence(noise, tmp_path / "j")
    assert got == want
    from frame2frame_tpu_torch.io.image import read_pgm

    for t in range(1, got[0] + 1):
        for kind in ("clean", "noisy"):
            a = read_pgm(tmp_path / "p" / f"{kind}{t:03d}.pgm")
            b = np.asarray(Image.open(tmp_path / "j" / f"{kind}{t:03d}.png"),
                           np.float32)
            np.testing.assert_array_equal(np.asarray(a, np.float32).squeeze(),
                                          b)


def adapt_cfg(root):
    return dict(net_name="dncnn", channels=1, num_of_layers=4,
                conv_impl="xla", dname="synthetic", nvideos=1,
                nframes_data=6, isize_data=[32, 32], ntype="g", sigma=25,
                adapt_isize="32_32", adapt_nepochs=1, nbatch_sample=1,
                spatial_chunk_size=16, spatial_chunk_overlap=0.25,
                temporal_chunk_size=3, loss_type="sup", ntrain_frames=3,
                pretrained_root=str(root), seed=5)


@pytest.fixture(scope="module")
def adapt_root(tmp_path_factory):
    """A 4-layer checkpoint where ``set_pretrained_path`` finds it."""
    root = tmp_path_factory.mktemp("pretrained")
    _, variables = init_dncnn(9, channels=1, num_layers=4, residual=True,
                              conv_impl="xla")
    jser.save_variables(root / "dncnn-sigma25.msgpack", variables)
    return root


def test_instances_adapt_run_matches_jax(scripts, adapt_root, tmp_path,
                                         monkeypatch):
    cfg = adapt_cfg(adapt_root)
    want = scripts["instances_adapt"].run(dict(cfg))
    got = scripts["torch_instances_adapt"].run(dict(cfg), device="cpu")
    assert sorted(got) == sorted(want)
    assert np.abs(np.subtract(got["psnrs"], want["psnrs"])).max() <= 1e-3
    assert np.abs(np.subtract(got["ssims"], want["ssims"])).max() <= 1e-5
    np.testing.assert_allclose(got["adapt_loss"], want["adapt_loss"],
                               rtol=1e-4)
    monkeypatch.chdir(tmp_path)
    recs = scripts["torch_instances_adapt"].main(
        device="cpu", grids=(cfg, [{"loss_type": ["none"]}]))
    assert "error" not in recs[0]["results"]
    assert (tmp_path / ".cache_f2f_torch" / "instances_adapt"
            / f"{recs[0]['uuid']}.pkl").exists()


def test_noise_sweep_condition(scripts, monkeypatch):
    ns = scripts["torch_noise_sweep"]

    def tiny(resid_std, workdir, fast):
        cfg = ns.pretrain_cfg(resid_std, workdir, fast)
        cfg.update(num_of_layers=4, nvideos=1, nepochs=1, isize_data=(32, 32))
        return cfg

    noisy, deno = ns.run_condition({"kind": "g", "sigma": 25},
                                   device="cpu", cfg_fn=tiny)
    assert np.isfinite([noisy, deno]).all() and 18 < noisy < 25


def test_accuracy_artifact_trajectory_and_oracle(scripts, tmp_path):
    aa = scripts["torch_accuracy_artifact"]
    stats = aa.trajectory(3, 32, 48, out=tmp_path, device="cpu")
    jax_keys = json.loads((REPO / "results" / "dncnn17_s25"
                           / "trajectory_stats.json").read_text())
    assert set(jax_keys) <= set(stats)
    psnrs = np.loadtxt(tmp_path / "psnr_32x48_3f.txt")
    assert psnrs.shape == (2,) and np.isfinite(psnrs).all()
    assert stats["checkpoint"] == "results/dncnn17_s25/checkpoint.msgpack"
    orc = aa.oracle(2, 32, 48, out=tmp_path, device="cpu")
    assert (tmp_path / "oracle_deviation.json").exists()
    assert np.isfinite(orc["ours_psnr"] + orc["torch_psnr"]).all()
    with pytest.raises(ValueError, match="JAX"):
        aa.main(["trajectory", "--out", str(REPO / "results" / "dncnn17_s25"),
                 "--device", "cpu"])
