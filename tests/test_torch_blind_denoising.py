"""The streaming loop of the port (``train/online.run_blind_denoising``), its
checkpoint writer and the ``blind_denoising`` CLI against the JAX package.

- ``run_blind_denoising`` on a four-frame 32x48 sequence (PNG, and the same
  values as PGM) with precomputed ``.flo`` files and a ``"hybrid"`` 5-layer
  DnCNN, against the JAX function on the same files and weights: the PSNR
  lines within 1e-3 dB, the written frames within one gray level, the losses
  at 1e-4;
- ``final.msgpack``: flax's reader and the JAX package's
  ``load_train_state(like=...)`` read the port's file; it holds the engine's
  state bit for bit, and the JAX package's weights to 1e-4;
- the CLI ``main(argv, device="cpu")`` with ``--compute_flow`` (TV-L1 on the
  plain inner loop) and with ``--flow``;
- PGM frames: the port reads them without PIL to the bits the JAX package's
  reader (PIL) gives, and writes the bytes PIL writes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.serialization as fser  # noqa: E402
import jax  # noqa: E402

from frame2frame_tpu.io import image as jimage  # noqa: E402
from frame2frame_tpu.models.dncnn import DnCNN as JaxDnCNN  # noqa: E402
from frame2frame_tpu.models.serialization import (  # noqa: E402
    load_train_state,
    save_variables,
)
from frame2frame_tpu.train import online as jonline  # noqa: E402
from frame2frame_tpu_torch.cli import blind_denoising as tcli  # noqa: E402
from frame2frame_tpu_torch.io import image as timage  # noqa: E402
from frame2frame_tpu_torch.io.flo import write_flo  # noqa: E402
from frame2frame_tpu_torch.models.dncnn import (  # noqa: E402
    from_jax_variables,
    opt_state_to_jax,
)
from frame2frame_tpu_torch.models.serialization import (  # noqa: E402
    load_variables,
)
from frame2frame_tpu_torch.train import online as tonline  # noqa: E402

from test_torch_fused_apply import perturbed_model  # noqa: E402

H, W, FIRST, LAST, ITERS = 32, 48, 1, 4, 2


def _tree_equal(a, b):
    la = dict(jax.tree_util.tree_leaves_with_path(a))
    lb = dict(jax.tree_util.tree_leaves_with_path(b))
    assert la.keys() == lb.keys()
    for k, v in lb.items():
        v, u = np.asarray(v), np.asarray(la[k])
        assert u.dtype == v.dtype and u.shape == v.shape, k
        assert u.tobytes() == v.tobytes(), k


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    """A smooth texture moving 1 px a frame to the right, noisy (sigma 25)
    and clean, as 8-bit PNG and PGM, and the flows cur -> prev (-1, 0)."""
    from PIL import Image

    d = tmp_path_factory.mktemp("seq")
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:H, 0:W + LAST].astype(np.float64)
    scene = (0.5 + 0.25 * np.sin(xx / 5.0) * np.cos(yy / 7.0)
             + 0.15 * np.sin((xx + 2 * yy) / 9.0))
    for i in range(FIRST, LAST + 1):
        clean = scene[:, LAST - i:LAST - i + W]
        noisy = clean + 25.0 / 255.0 * rng.standard_normal(clean.shape)
        for name, img in (("clean", clean), ("noisy", noisy)):
            u8 = np.clip(np.round(255.0 * img), 0, 255).astype(np.uint8)
            Image.fromarray(u8).save(d / f"{name}_{i:03d}.png")
            timage.write_pgm(d / f"{name}_{i:03d}.pgm", u8)
        flow = np.zeros((H, W, 2), np.float32)
        flow[..., 0] = -1.0
        write_flo(d / f"flow_{i:03d}.flo", flow)
    return d


@pytest.fixture(scope="module")
def weights():
    return perturbed_model(H, W, seed=90)[1]


class RecordingDenoiser(tonline.OnlineDenoiser):
    made = []

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        RecordingDenoiser.made.append(self)


def run_port(d, weights, ext, monkeypatch):
    monkeypatch.setattr(tonline, "OnlineDenoiser", RecordingDenoiser)
    out = d / f"port_{ext}"
    out.mkdir(exist_ok=True)
    res = tonline.run_blind_denoising(
        from_jax_variables(weights, conv_impl="hybrid"), weights,
        input_tmpl=str(d / f"noisy_%03d.{ext}"),
        flow_tmpl=str(d / "flow_%03d.flo"),
        ref_tmpl=str(d / f"clean_%03d.{ext}"),
        output_tmpl=str(out / f"%03d.{ext}"),
        output_psnr=str(out / "plot_psnr.txt"),
        output_network=str(out / "final.msgpack"),
        first=FIRST, last=LAST, iters=ITERS, device="cpu")
    return res, out, RecordingDenoiser.made.pop()


@pytest.fixture(scope="module")
def jax_run(sequence, weights):
    out = sequence / "jax"
    out.mkdir()
    res = jonline.run_blind_denoising(
        JaxDnCNN(channels=1, num_layers=5, conv_impl="hybrid"), weights,
        input_tmpl=str(sequence / "noisy_%03d.png"),
        flow_tmpl=str(sequence / "flow_%03d.flo"),
        ref_tmpl=str(sequence / "clean_%03d.png"),
        output_tmpl=str(out / "%03d.png"),
        output_psnr=str(out / "plot_psnr.txt"),
        output_network=str(out / "final.msgpack"),
        first=FIRST, last=LAST, iters=ITERS)
    return res, out


def test_run_blind_denoising_matches_jax(sequence, weights, jax_run,
                                         monkeypatch):
    res_j, out_j = jax_run
    res, out, eng = run_port(sequence, weights, "png", monkeypatch)
    assert res["frames"] == res_j["frames"] == list(range(FIRST + 1,
                                                          LAST + 1))
    np.testing.assert_allclose(np.stack(res["loss"]),
                               np.stack([np.asarray(x) for x in
                                         res_j["loss"]]), rtol=1e-4)
    lines = (out / "plot_psnr.txt").read_text().splitlines()
    lines_j = (out_j / "plot_psnr.txt").read_text().splitlines()
    assert len(lines) == len(lines_j) == LAST - FIRST
    np.testing.assert_allclose([float(v) for v in lines],
                               [float(v) for v in lines_j], atol=1e-3)
    np.testing.assert_allclose(res["psnr"], res_j["psnr"], atol=1e-3)
    for i in range(FIRST + 1, LAST + 1):
        a = jimage.read_image(out / f"{i:03d}.png").astype(int)
        b = jimage.read_image(out_j / f"{i:03d}.png").astype(int)
        assert a.shape == (H, W) and np.abs(a - b).max() <= 1

    # the same frames as PGM, read without PIL: the same run
    res_pgm, out_pgm, _ = run_port(sequence, weights, "pgm", monkeypatch)
    np.testing.assert_array_equal(np.stack(res_pgm["loss"]),
                                  np.stack(res["loss"]))
    assert res_pgm["psnr"] == res["psnr"]
    for i in range(FIRST + 1, LAST + 1):
        np.testing.assert_array_equal(
            timage.read_pgm(out_pgm / f"{i:03d}.pgm"),
            jimage.read_image(out / f"{i:03d}.png"))

    # final.msgpack: the engine's state, bit for bit, through flax's reader
    # and the port's; the JAX package restores it into its own structure
    data = (out / "final.msgpack").read_bytes()
    state = fser.msgpack_restore(data)
    _tree_equal(load_variables(out / "final.msgpack"), state)
    v = eng.variables
    _tree_equal(state, {"params": v["params"],
                        "opt_state": opt_state_to_jax(eng.opt_state),
                        "batch_stats": v["batch_stats"]})
    like = fser.msgpack_restore((out_j / "final.msgpack").read_bytes())
    restored = load_train_state(out / "final.msgpack", like=like)
    _tree_equal(restored, state)
    assert int(restored["opt_state"]["count"]) == ITERS * (LAST - FIRST)
    # the weights the two loops end with: Adam moves a parameter by up to
    # lr = 5e-5 an update whatever its gradient, so 1e-4 absolute
    for kind in ("params", "batch_stats"):
        got = dict(jax.tree_util.tree_leaves_with_path(restored[kind]))
        for path, w in jax.tree_util.tree_leaves_with_path(like[kind]):
            w = np.asarray(w)
            np.testing.assert_allclose(got[path], w, rtol=1e-4, atol=1e-4,
                                       err_msg=f"{kind} {path}")


def test_flows_in_line_equal_the_async_solver(sequence, weights, tmp_path):
    """``flow_backend="off"`` solves windows of ``flow_batch`` pairs in line
    (the last window padded with its last pair); the flows, and so the whole
    run, equal ``AsyncFlowSolver``'s one pair at a time."""
    runs = []
    for backend in ("auto", "off"):
        runs.append(tonline.run_blind_denoising(
            from_jax_variables(weights, conv_impl="hybrid"), weights,
            input_tmpl=str(sequence / "noisy_%03d.pgm"),
            ref_tmpl=str(sequence / "clean_%03d.pgm"),
            first=FIRST, last=LAST, iters=ITERS, flow_batch=2,
            flow_backend=backend, device="cpu"))
    np.testing.assert_array_equal(np.stack(runs[0]["loss"]),
                                  np.stack(runs[1]["loss"]))
    assert runs[0]["psnr"] == runs[1]["psnr"]
    with pytest.raises(ValueError, match="flow_backend"):
        tonline.run_blind_denoising(None, weights, "x%03d.pgm",
                                    flow_backend="gpu", device="cpu")


@pytest.mark.parametrize("flow", ["compute", "files"])
def test_cli_writes_frames_psnr_and_network(sequence, weights, tmp_path,
                                            flow):
    net = tmp_path / "net.msgpack"
    save_variables(net, weights)
    out = tmp_path / "out"
    out.mkdir()
    argv = ["--input", str(sequence / "noisy_%03d.pgm"),
            "--ref", str(sequence / "clean_%03d.pgm"),
            "--output", str(out / "%03d.pgm"),
            "--output_psnr", str(out / "plot_psnr.txt"),
            "--output_network", str(out / "final.msgpack"),
            "--first", str(FIRST), "--last", str(LAST), "--iter", "2",
            "--layers", "5", "--network", str(net)]
    argv += (["--compute_flow"] if flow == "compute"
             else ["--flow", str(sequence / "flow_%03d.flo")])
    res = tcli.main(argv, device="cpu")
    lines = (out / "plot_psnr.txt").read_text().splitlines()
    assert len(lines) == LAST - FIRST
    assert np.isfinite([float(v) for v in lines]).all()
    assert res["frames"] == list(range(FIRST + 1, LAST + 1))
    for i in range(FIRST + 1, LAST + 1):
        assert timage.read_pgm(out / f"{i:03d}.pgm").shape == (H, W)
    state = load_variables(out / "final.msgpack")
    assert set(state) == {"params", "opt_state", "batch_stats"}
    assert int(state["opt_state"]["count"]) == 2 * (LAST - FIRST)


def test_pgm_frames_match_the_jax_reader_and_pil_writer(sequence, tmp_path):
    for i in range(FIRST, LAST + 1):
        path = sequence / f"noisy_{i:03d}.pgm"
        got, want = timage.read_gray(path), jimage.read_gray(path)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
        frame = timage.read_frame(str(sequence / "noisy_%03d.pgm"), i)
        assert frame.tobytes() == jimage.read_frame(
            str(sequence / "noisy_%03d.pgm"), i).tobytes()
    img = 300.0 * np.random.default_rng(3).random((7, 9)) - 20.0
    timage.write_gray(tmp_path / "port.pgm", img)
    jimage.write_gray(tmp_path / "pil.pgm", img)
    assert ((tmp_path / "port.pgm").read_bytes()
            == (tmp_path / "pil.pgm").read_bytes())
    with pytest.raises(ValueError, match="maxval"):
        (tmp_path / "deep.pgm").write_bytes(b"P5\n2 1\n65535\n" + bytes(4))
        timage.read_pgm(tmp_path / "deep.pgm")
