"""The port's TV-L1 flow slice (frame2frame_tpu_torch/flow/tvl1.py,
flow/api.py, io/flo.py, io/image.py, cli/tvl1flow.py and ``AsyncFlowSolver``)
vs the reference C binary's golden flows and vs the JAX package.

Tolerances.
- Golden flows (tests/golden/*.flo, written by the reference C binary): the
  JAX test's own bounds (tests/test_tvl1_golden.py), mean |d| < 1e-5 px and
  max |d| < 5e-4 px.
- Against the JAX solver on the same images: both run the same f32
  operations in the same order, so they differ by contracted roundings
  only, as long as every inner loop stops at the same iteration: max |d| <
  5e-4 px, the golden bound (a stop decision that differed would move the
  flow by about epsilon = 1e-2).
- What must be equal is held bit for bit: the batched solver against single
  solves, "svnlb" against "tvl1", .flo files across the two packages.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from frame2frame_tpu.flow import api as japi  # noqa: E402
from frame2frame_tpu.flow import tvl1 as jtvl1  # noqa: E402
from frame2frame_tpu.io import flo as jflo  # noqa: E402
from frame2frame_tpu_torch.cli import tvl1flow as tcli  # noqa: E402
from frame2frame_tpu_torch.config import Config  # noqa: E402
from frame2frame_tpu_torch.flow import api as tapi  # noqa: E402
from frame2frame_tpu_torch.flow.farneback import (  # noqa: E402
    DEFAULT_PARAMS as FB_DEFAULT_PARAMS,
    make_batched_farneback,
)
from frame2frame_tpu_torch.flow import tvl1 as ttvl1  # noqa: E402
from frame2frame_tpu_torch.io import flo as tflo  # noqa: E402
from frame2frame_tpu_torch.io import image as timage  # noqa: E402
from frame2frame_tpu_torch.train.online import AsyncFlowSolver  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "golden"
GOLDENS = [("flow_default.flo", dict(lambda_=0.15, fscale=0)),
           ("flow_denoise.flo", dict(lambda_=0.2, fscale=2))]
MEAN_TOL, MAX_TOL = 1e-5, 5e-4


@pytest.fixture(scope="module")
def pair():
    I0 = np.asarray(timage.read_gray(GOLDEN / "i0.png"), np.float32)
    I1 = np.asarray(timage.read_gray(GOLDEN / "i1.png"), np.float32)
    return I0, I1


def video(T, H, W, seed=0, channels=None):
    """A textured scene that drifts by (0.8, -0.5) px a frame, on [0, 1]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    ph = rng.uniform(0, 2 * np.pi, 3)
    frames = []
    for t in range(T):
        x, y = xx + 0.8 * t, yy - 0.5 * t
        frames.append(0.5 + 0.2 * np.sin(0.35 * x + ph[0])
                      + 0.2 * np.cos(0.27 * y + ph[1])
                      + 0.1 * np.sin(0.13 * (x + y) + ph[2]))
    vid = np.stack(frames).astype(np.float32)
    if channels:
        vid = np.repeat(vid[..., None], channels, -1)
    return vid


@pytest.mark.parametrize("golden,params", GOLDENS)
def test_solver_matches_the_c_binary(pair, golden, params):
    I0, I1 = pair
    ref = tflo.read_flo(GOLDEN / golden)
    ny, nx = I0.shape
    iterations = []
    solver = ttvl1.make_tvl1_solver(nx, ny, device="cpu", **params)
    flow = solver(I0, I1, iterations=iterations)
    assert flow.shape == (ny, nx, 2) and flow.dtype == torch.float32
    err = np.abs(flow.numpy() - ref)
    assert err.mean() < MEAN_TOL, f"mean abs err {err.mean()}"
    assert err.max() < MAX_TOL, f"max abs err {err.max()}"
    # five warps on every solved scale, each launch's counts reported
    solved = 4 - params["fscale"]
    assert len(iterations) == 5 * solved
    assert all(s.shape == (1, 2) and 1 <= int(s[0, 0]) <= 300
               for s in iterations)


def test_solver_recovers_known_shift(pair):
    """i1 is i0's scene shifted by (+1 y, -1 x): flow(i0 -> i1) ~ (+1, -1)."""
    I0, I1 = pair
    flow = ttvl1.tvl1_flow(I0, I1, device="cpu", lambda_=0.2).numpy()
    inner = flow[10:-10, 10:-10]
    assert abs(np.median(inner[..., 0]) - 1.0) < 0.35
    assert abs(np.median(inner[..., 1]) + 1.0) < 0.35


@pytest.mark.parametrize("inner_impl", ["xla", "pallas"])
def test_solver_matches_the_jax_solver(pair, inner_impl):
    I0, I1 = pair
    small0, small1 = I0[:48, :64], I1[:48, :64]
    want = np.asarray(jtvl1.make_tvl1_solver(
        64, 48, max_iters=30, inner_impl=inner_impl)(small0, small1))
    got = ttvl1.make_tvl1_solver(64, 48, max_iters=30, device="cpu")(
        small0, small1).numpy()
    assert np.abs(want).max() > 0.5
    assert np.abs(got - want).max() < MAX_TOL
    assert np.abs(got - want).mean() < MEAN_TOL


def test_batched_solver_matches_the_jax_one_and_single_solves():
    vid = video(4, 40, 56, seed=1) * 255.0
    src, dst = vid[:-1], vid[1:]
    params = dict(ttvl1.DENOISING_PARAMS, fscale=0)
    assert ttvl1.DENOISING_PARAMS == jtvl1.DENOISING_PARAMS
    want = np.asarray(jtvl1.make_batched_tvl1(56, 40, **params)(
        jnp.asarray(src), jnp.asarray(dst)))
    solver = ttvl1.make_batched_tvl1(56, 40, device="cpu", **params)
    iterations = []
    got = solver(src, dst, iterations=iterations)
    assert got.shape == (3, 40, 56, 2)
    assert np.abs(got.numpy() - want).max() < MAX_TOL
    # the pairs stop at different iterations in at least one launch
    assert any(len({int(n) for n in s[:, 0]}) > 1 for s in iterations)
    single = ttvl1.make_tvl1_solver(56, 40, device="cpu", **params)
    for p in range(3):
        assert torch.equal(got[p], single(src[p], dst[p]))
    with pytest.raises(ValueError, match="expected"):
        solver(src[0], dst[0])


def test_solver_is_cached_and_checks_its_frames():
    a = ttvl1.make_tvl1_solver(64, 48, device="cpu")
    assert a is ttvl1.make_tvl1_solver(64, 48, device="cpu")
    assert a is not ttvl1.make_tvl1_solver(64, 48, device="cpu", plain=True)
    with pytest.raises(ValueError, match="solver for"):
        a(np.zeros((48, 65), np.float32), np.zeros((48, 65), np.float32))


def test_plain_twin_equals_the_solver_on_the_cpu(pair):
    I0, I1 = pair
    kw = dict(max_iters=20, device="cpu")
    assert torch.equal(
        ttvl1.make_tvl1_solver(64, 48, **kw)(I0[:48, :64], I1[:48, :64]),
        ttvl1.make_tvl1_solver(64, 48, plain=True, **kw)(I0[:48, :64],
                                                         I1[:48, :64]))


@pytest.mark.parametrize("layout", ["THW", "THWC", "BTHWC"])
def test_run_flows_matches_the_jax_api(layout):
    vid = video(3, 40, 56, seed=2, channels=None if layout == "THW" else 3)
    if layout == "BTHWC":
        vid = np.stack([vid, vid[::-1]])
    want = japi.run_flows(vid)
    got = tapi.run_flows(vid, device="cpu")
    assert isinstance(got, Config)
    B = 2 if layout == "BTHWC" else 1
    for key in ("fflow", "bflow"):
        assert got[key].shape == (B, 3, 40, 56, 2)
        assert got[key].dtype == torch.float32
        assert np.abs(got[key].numpy() - np.asarray(want[key])).max() < MAX_TOL
    assert not got.fflow[:, -1].any() and not got.bflow[:, 0].any()
    assert got.fflow[:, 0].abs().max() > 0.3
    # the drift is (0.8, -0.5) px a frame: forward flow follows it
    mid = got.fflow[0, 0, 8:-8, 8:-8].numpy()
    assert abs(np.median(mid[..., 0]) + 0.8) < 0.35
    assert abs(np.median(mid[..., 1]) - 0.5) < 0.35


def test_run_flows_options():
    vid = video(3, 24, 30, seed=3)
    # 30 x 24 frames have two scales: fscale=2 would solve none, so it is
    # clamped to the coarsest and the flow is not zero
    assert ttvl1.num_scales(30, 24, 100, 0.5) == 2
    got = tapi.run_flows(vid, device="cpu")
    assert got.fflow.abs().max() > 0.05
    clamped = tapi.run_flows(vid, device="cpu", fscale=1)
    assert torch.equal(got.fflow, clamped.fflow)
    alias = tapi.orun(vid, ftype="svnlb", device="cpu")
    assert torch.equal(alias.fflow, got.fflow)
    assert torch.equal(alias.bflow, got.bflow)
    off = tapi.run_flows(vid, use_flow=False, device="cpu")
    assert off.fflow.shape == (1, 3, 24, 30, 2) and not off.fflow.any()
    one = tapi.run_flows(vid[:1], device="cpu")
    assert one.bflow.shape == (1, 1, 24, 30, 2) and not one.bflow.any()
    # "cv2" is Farneback's flow, a different estimator from TV-L1
    cv = tapi.run_flows(vid, ftype="cv2", device="cpu", levels=1)
    fb = make_batched_farneback(30, 24, device="cpu",
                                **dict(FB_DEFAULT_PARAMS, levels=1))
    g = torch.as_tensor(vid, dtype=torch.float32)
    assert torch.equal(cv.fflow[0, :-1], fb(g[:-1], g[1:]))
    assert not torch.equal(cv.fflow, got.fflow)
    with pytest.raises(ValueError, match="unknown flow type"):
        tapi.run_flows(vid, ftype="raft", device="cpu")


def test_async_flow_solver_on_the_cpu():
    vid = video(4, 40, 56, seed=4)[..., None]
    params = dict(ttvl1.DENOISING_PARAMS, fscale=0)
    solver = AsyncFlowSolver(56, 40, params, lookahead=2, device="cpu")
    assert solver.lookahead == 2
    for i in (1, 2, 3):
        solver.prefetch(i, vid[i], vid[i - 1])
    solver.prefetch(2, vid[0], vid[0])  # already in flight: ignored
    direct = ttvl1.make_tvl1_solver(56, 40, device="cpu", **params)
    for i in (3, 1, 2):  # any order
        flow = solver.get(i)
        assert flow.shape == (40, 56, 2)
        assert torch.equal(flow, direct(vid[i, ..., 0] * 255.0,
                                        vid[i - 1, ..., 0] * 255.0))
    assert len(solver.solve_times) == 3
    assert all(t > 0 for t in solver.solve_times)
    with pytest.raises(KeyError):
        solver.get(2)
    solver.close()


def test_flo_files_cross_the_two_packages(tmp_path):
    rng = np.random.default_rng(5)
    flow = rng.standard_normal((7, 11, 2)).astype(np.float32)
    tflo.write_flo(tmp_path / "t.flo", flow)
    jflo.write_flo(tmp_path / "j.flo", flow)
    assert (tmp_path / "t.flo").read_bytes() == (tmp_path / "j.flo").read_bytes()
    assert np.array_equal(jflo.read_flo(tmp_path / "t.flo"), flow)
    assert np.array_equal(tflo.read_flo(tmp_path / "j.flo"), flow)
    assert np.array_equal(tflo.read_flo(GOLDEN / "flow_default.flo"),
                          jflo.read_flo(GOLDEN / "flow_default.flo"))
    (tmp_path / "bad.flo").write_bytes(b"\0" * 16)
    with pytest.raises(ValueError, match="magic"):
        tflo.read_flo(tmp_path / "bad.flo")
    with pytest.raises(ValueError, match="flow must be"):
        tflo.write_flo(tmp_path / "x.flo", flow[..., 0])


def test_precompute_flo_files(tmp_path):
    frames = video(3, 24, 30, seed=6) * 255.0
    paths = tapi.precompute_flo_files(frames, str(tmp_path / "b_%03d.flo"),
                                      first=1, device="cpu", fscale=0)
    assert [Path(p).name for p in paths] == ["b_002.flo", "b_003.flo"]
    solver = ttvl1.make_tvl1_solver(30, 24, device="cpu",
                                    **dict(ttvl1.DENOISING_PARAMS, fscale=0))
    assert np.array_equal(tflo.read_flo(paths[0]),
                          solver(frames[1], frames[0]).numpy())


def test_image_io_matches_the_jax_package(tmp_path):
    from frame2frame_tpu.io import image as jimage

    for name in ("i0.png", "i1.png"):
        assert np.array_equal(timage.read_gray(GOLDEN / name),
                              jimage.read_gray(GOLDEN / name))
    rng = np.random.default_rng(7)
    img = rng.uniform(-20, 280, (9, 14))
    timage.write_pgm(tmp_path / "a.pgm", img)
    assert np.array_equal(timage.read_pgm(tmp_path / "a.pgm"),
                          jimage.read_pgm(tmp_path / "a.pgm"))
    timage.write_gray(tmp_path / "a.png", img)
    timage.write_gray(tmp_path / "a.tiff", img)
    assert np.array_equal(timage.read_frame(str(tmp_path / "a.png"), 0),
                          np.clip(img, 0, 255).astype(np.uint8))
    assert np.array_equal(timage.read_frame(str(tmp_path / "a.tiff"), 0),
                          img.astype(np.float32))
    rgb = rng.integers(0, 256, (5, 6, 3), dtype=np.uint8)
    from PIL import Image

    Image.fromarray(rgb).save(tmp_path / "c.png")
    assert np.array_equal(timage.read_gray(tmp_path / "c.png"),
                          jimage.read_gray(tmp_path / "c.png"))
    assert timage.is_tiff("x.TIF") and not timage.is_tiff("x.png")
    assert np.array_equal(timage.read_frame(str(tmp_path / "%c.png"), ord("c")),
                          timage.read_gray(tmp_path / "c.png") * 255.0)


def test_cli_writes_the_golden_flow(tmp_path, capsys):
    out = tmp_path / "out.flo"
    argv = [str(GOLDEN / "i0.png"), str(GOLDEN / "i1.png"), str(out)]
    argv += "4 0.25 0.2 0.3 100 2 0.5 5 0.01 1".split()
    assert tcli.main(argv, device="cpu") == 0
    assert "lambda=0.2" in capsys.readouterr().err
    err = np.abs(tflo.read_flo(out) - tflo.read_flo(GOLDEN / "flow_denoise.flo"))
    assert err.mean() < MEAN_TOL and err.max() < MAX_TOL


def test_cli_validates_like_the_reference(tmp_path, capsys):
    assert tcli.main([], device="cpu") == 1
    assert "Usage" in capsys.readouterr().err
    timage.write_pgm(tmp_path / "a.pgm", np.zeros((8, 9)))
    timage.write_pgm(tmp_path / "b.pgm", np.zeros((9, 8)))
    assert tcli.main([str(tmp_path / "a.pgm"), str(tmp_path / "b.pgm")],
                     device="cpu") == 1
    assert "size mismatch" in capsys.readouterr().err
    # out-of-range parameters fall back to the defaults (main.c:101-141)
    crop = tmp_path / "c0.pgm", tmp_path / "c1.pgm"
    for path, name in zip(crop, ("i0.png", "i1.png")):
        timage.write_pgm(path, timage.read_gray(GOLDEN / name)[:40, :56] * 255)
    outs = []
    for i, extra in enumerate(("4 0.9 -1 0 0 0 1.5 0 -2", "")):
        out = tmp_path / f"o{i}.flo"
        assert tcli.main([str(crop[0]), str(crop[1]), str(out)] + extra.split(),
                         device="cpu") == 0
        outs.append(tflo.read_flo(out))
    assert np.array_equal(outs[0], outs[1])


def test_chip_smoke_png_decoder_matches_read_gray():
    """``chip_smoke.py`` decodes the two golden PNGs itself (the machine with
    the card may lack PIL): held against the port's reader here."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    for name in ("i0.png", "i1.png"):
        got = chip_smoke.read_png_gray8(GOLDEN / name)
        assert got.dtype == np.uint8
        assert np.array_equal(got / 255.0, timage.read_gray(GOLDEN / name))
