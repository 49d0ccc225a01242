"""The port's offline trainer and evaluation pipeline
(``frame2frame_tpu_torch/train/trainer.py``, ``eval/test.py``) against the
JAX package's, on the CPU, each package on one msgpack checkpoint the test
writes with the JAX package's writer (a 4-layer DnCNN, ``conv_impl="xla"``),
with the datasets' noise drawn as JAX draws it (the port's
``data.noise._normal`` replaced by JAX's draw from the key JAX seeds with
the same integer).

- ``trainer.run`` with ``crit_name="sup"``, 2 epochs on two tiny synthetic
  videos, at batch sizes 1 and 2: ``val_psnr`` within 1e-3 dB of JAX's, the
  final checkpoint within 1e-4 of its largest value, the CSV's columns and
  rows, the learning rates, and the files JAX writes. BatchNorm trains, so
  the rule of ``tests/test_torch_lit.py`` applies to the checkpoint: where
  a pre-activation sits at the ReLU's kink, two f32 implementations give
  an element gradients of opposite signs and Adam moves it a whole step
  either way; at most 0.5 % of the elements may lie beyond the bound, by
  at most two learning rates an update (measured: none at batch size 1,
  0.04 % at batch size 2, where two updates compound a flip);
- ``eval.test.run`` on a directory dataset of PGM frames: per-frame PSNR
  within 1e-3 dB, SSIM within 1e-5, ST-RRED within 1e-3 relative, for the
  plain run, ``aug_test``, chunking, ``longest_space_chunk``,
  ``append_noise_map`` (a 2-channel model), ``save_deno``, ``bench_bwd``,
  the B2U second pass and internal adaptation; the result's keys and list
  structure;
- both entry points raise without a device on a host without a card.
"""

import csv

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from frame2frame_tpu.config import Config as JConfig  # noqa: E402
from frame2frame_tpu.eval import test as jtest  # noqa: E402
from frame2frame_tpu.models import serialization as jser  # noqa: E402
from frame2frame_tpu.train import trainer as jtrainer  # noqa: E402
from frame2frame_tpu_torch.data import noise as tnoise  # noqa: E402
from frame2frame_tpu_torch.eval import test as ttest  # noqa: E402
from frame2frame_tpu_torch.models.dncnn import init_dncnn  # noqa: E402
from frame2frame_tpu_torch.models.serialization import (  # noqa: E402
    load_variables)
from frame2frame_tpu_torch.train import trainer as ttrainer  # noqa: E402

from test_torch_data import write_dir_dataset  # noqa: E402
from test_torch_nls import one_torch_thread  # noqa: E402,F401

PSNR_DB = 1e-3
SSIM_ATOL = 1e-5
STRRED_RTOL = 1e-3
CKPT_RTOL = 1e-4
KINK_SHARE = 0.995
TRAIN_LR = 1e-4


@pytest.fixture(autouse=True)
def jax_dataset_draws(monkeypatch):
    def normal(gen, shape, dtype, device):
        key = jax.random.PRNGKey(gen.initial_seed())
        return torch.from_numpy(np.array(
            jax.random.normal(key, tuple(shape), jnp.float32))).to(device)

    monkeypatch.setattr(tnoise, "_normal", normal)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """msgpack checkpoints of 4-layer DnCNNs by input channels, seeded
    weights as the JAX tree, written by the JAX package's writer."""
    root = tmp_path_factory.mktemp("ckpt")
    out = {}
    for ch in (1, 2):
        _, variables = init_dncnn(3 + ch, channels=ch, num_layers=4,
                                  residual=True, conv_impl="xla")
        out[ch] = jser.save_variables(root / f"dncnn4_c{ch}.msgpack",
                                      variables)
    return out


def model_cfg(ckpts, ch=1):
    return dict(net_name="dncnn", channels=ch, num_of_layers=4,
                residual=True, conv_impl="xla", pretrained_load=True,
                pretrained_path=ckpts[ch])


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    else:
        yield path, np.asarray(tree, np.float64)


def read_csv(path):
    with open(path) as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("bs", [1, 2])
def test_trainer_run(ckpts, tmp_path, bs):
    cfg = dict(model_cfg(ckpts), seed=0, dname="synthetic", nvideos=2,
               nframes_data=3, isize_data=(24, 32), ntype="g", sigma=25,
               crit_name="sup", nepochs=2, lr_init=TRAIN_LR, lr_final=1e-6,
               scheduler_name="exp_decay", flow=False, batch_size=bs,
               uuid="tiny")
    want = jtrainer.run(JConfig(cfg, checkpoint_dir=str(tmp_path / "jax")))
    got = ttrainer.run(dict(cfg, checkpoint_dir=str(tmp_path / "port")),
                       device="cpu")
    assert sorted(got) == sorted(want)
    assert sorted(got.final) == sorted(want.final)
    for out, ref in ((got, want), (got.final, want.final)):
        assert abs(out["val_psnr"] - ref["val_psnr"]) <= PSNR_DB
        # BatchNorm trains: after the first update the losses drift apart by
        # the ReLU-kink elements (tests/test_torch_lit.py), here 4.4e-5
        assert abs(out["train_loss"] - ref["train_loss"]) <= 1e-4 * abs(
            ref["train_loss"])
        assert out["lr"] == pytest.approx(ref["lr"], rel=1e-6)
    assert got.state.step == want.state.step == 4 // bs
    assert np.isfinite(got.val_psnr) and np.isfinite(got.train_loss)
    # the files JAX writes, by name; the CSV's columns and rows
    files = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert files == ["tiny-epoch000.msgpack", "tiny-epoch001.msgpack",
                     "tiny-final.msgpack", "tiny-metrics.csv"]
    rows = read_csv(tmp_path / "port" / "tiny-metrics.csv")
    jrows = read_csv(tmp_path / "jax" / "tiny-metrics.csv")
    assert rows[0] == jrows[0]
    assert len(rows) == len(jrows) == 1 + 4 // bs
    col = rows[0].index("lr")
    assert [float(r[col]) for r in rows[1:]] == [float(r[col])
                                                 for r in jrows[1:]]
    # the final checkpoint, read back through the port's reader
    like = jax.tree.map(np.asarray, want.state.variables)
    got_ck = dict(leaves(load_variables(got.checkpoint, like=like)))
    want_ck = dict(leaves(load_variables(want.checkpoint, like=like)))
    assert got_ck.keys() == want_ck.keys()
    scale = max(np.abs(w).max() for w in want_ck.values())
    err = np.concatenate([np.abs(got_ck[k] - w).ravel()
                          for k, w in want_ck.items()])
    off = err > CKPT_RTOL * scale
    assert np.mean(off) <= 1 - KINK_SHARE, np.mean(off)
    assert err.max() <= 2 * TRAIN_LR * got.state.step, err.max()


@pytest.fixture(scope="module")
def pgm_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("pgm")
    write_dir_dataset(root)
    return root


def eval_cfg(ckpts, pgm_root, ch=1, **kw):
    cfg = dict(model_cfg(ckpts, ch), dname="pgmset", data_root=str(pgm_root),
               dset="te", vid_name="clip1", sigma=25, seed=123,
               save_deno=False, flow=False)
    cfg.update(kw)
    return cfg


EVAL_CASES = {
    "plain": {},
    "aug_test": dict(aug_test=True),
    "chunks": dict(spatial_chunk_size=16, spatial_chunk_overlap=0.25,
                   temporal_chunk_size=2, temporal_chunk_overlap=1),
    "longest_space_chunk": dict(spatial_chunk_size=16,
                                longest_space_chunk=True, burn_in=True),
    "noise_map": dict(append_noise_map=True),
    "bench_bwd": dict(bench_bwd=True, nframes=2, frame_start=1),
    "b2u": dict(crit_name="b2u"),
    "adapt": dict(internal_adapt_nsteps=1, internal_adapt_nepochs=1,
                  internal_adapt_nframes=3, loss_type="sup",
                  adapt_isize="16_16", lr_init=1e-3),
}


def hold_results(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert len(got[k]) == len(v), k
    for k in ("psnrs", "psnrs_pp", "noisy_psnrs"):
        for g, w in zip(got[k], want[k]):
            assert np.abs(np.asarray(g) - np.asarray(w)).max() <= PSNR_DB, k
    for k in ("ssims", "ssims_pp"):
        for g, w in zip(got[k], want[k]):
            assert np.abs(np.asarray(g) - np.asarray(w)).max() <= SSIM_ATOL, k
    for k in ("strred", "strred_pp"):
        for g, w in zip(got[k], want[k]):
            w = np.asarray(w)
            assert np.abs(np.asarray(g) - w).max() <= STRRED_RTOL * np.abs(
                w).max(), k
    for k in ("strred_method", "vid_name"):
        assert got[k] == want[k]
    for g, w in zip(got.vid_frames, want.vid_frames):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", sorted(EVAL_CASES))
def test_eval_run(ckpts, pgm_root, case):
    kw = EVAL_CASES[case]
    cfg = eval_cfg(ckpts, pgm_root, ch=2 if case == "noise_map" else 1, **kw)
    want = jtest.run(JConfig(cfg))
    got = ttest.run(cfg, device="cpu")
    hold_results(got, want)
    assert len(got.psnrs) == 1 and np.isfinite(got.psnrs[0]).all()
    for k in ("timer_deno", "timer_flow"):
        assert len(got[k]) == 1 and got[k][0] > 0
    # the CPU meters no device memory (zeros, as JAX off an accelerator)
    assert got.deno_mem_res == [[0.0]]
    if case == "bench_bwd":
        assert got.timer_bwd[0] > 0 and got.timer_fwd_grad[0] > 0
        assert got.bwd_mem_res == [[0.0]]
    if case == "adapt":
        assert got.timer_adapt[0] > 0
    if case == "b2u":
        assert not np.allclose(got.psnrs_pp[0], got.psnrs[0])
    else:
        np.testing.assert_array_equal(got.psnrs_pp[0], got.psnrs[0])


def test_eval_save_deno(ckpts, pgm_root, tmp_path):
    pytest.importorskip("PIL")
    from frame2frame_tpu_torch.io.image import read_image

    cfg = eval_cfg(ckpts, pgm_root, save_deno=True, arch_name="dn",
                   uuid="u1")
    want = jtest.run(JConfig(cfg, saved_dir=str(tmp_path / "jax")))
    got = ttest.run(dict(cfg, saved_dir=str(tmp_path / "port")),
                    device="cpu")
    hold_results(got, want)
    names = [[p.split("/")[-1] for p in fns] for fns in got.deno_fns]
    assert names == [[p.split("/")[-1] for p in fns]
                     for fns in want.deno_fns]
    assert names == [[f"deno_{t:05d}.png" for t in range(3)]]
    for g, w in zip(got.deno_fns[0], want.deno_fns[0]):
        assert "port/dn/u1/" in g
        diff = np.abs(read_image(g).astype(int) - read_image(w).astype(int))
        assert diff.max() <= 1


def test_eval_flow_noise(ckpts, pgm_root, monkeypatch):
    """``flow_sigma`` >= 0: the flows solve from the clean video plus
    ``flow_sigma`` times a normal draw from a generator seeded with
    ``seed``, on the run's device."""
    from frame2frame_tpu_torch.flow import api as tapi

    seen = []
    solve = tapi.run_flows

    def read(vid, use_flow=True, **kw):
        seen.append((vid.clone(), use_flow, kw))
        return solve(vid, use_flow, **kw)

    monkeypatch.setattr(tapi, "run_flows", read)
    cfg = eval_cfg(ckpts, pgm_root, flow=True, flow_sigma=5.0, seed=9)
    got = ttest.run(cfg, device="cpu")
    (vid, use_flow, kw), = seen
    assert use_flow is True and kw == {"device": torch.device("cpu")}
    clean = torch.from_numpy(np.stack([
        np.asarray(np.fromfile(p, np.uint8)[-32 * 48:], np.float32).reshape(
            32, 48, 1)
        for p in sorted((pgm_root / "pgmset" / "clip1").glob("*.pgm"))]))
    draw = tnoise._normal(torch.Generator().manual_seed(9), vid.shape,
                          torch.float32, "cpu")
    assert torch.equal(vid, clean[None] + 5.0 * draw)
    assert np.isfinite(got.psnrs[0]).all() and got.timer_flow[0] > 0


def test_entry_points_need_a_device(ckpts, pgm_root, tmp_path):
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttest.run(eval_cfg(ckpts, pgm_root))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrainer.run(dict(model_cfg(ckpts), checkpoint_dir=str(tmp_path)))
