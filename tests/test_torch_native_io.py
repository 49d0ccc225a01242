"""The port's native host I/O (``frame2frame_tpu_torch/io/native.py`` over
its own ``csrc/f2fio.cpp``) on the cases of ``tests/test_native_io.py``:
the .flo codec round trip against both packages' Python codecs, PNG decode
against the JAX package's writer, the prefetch ring delivering frames and
flows in order, a missing file. Also the port's PGM rule (maxval 255 only,
``#`` comments), the ring's buffers sized from each frame, and
``run_blind_denoising`` on PGM frames taking the ring, with results
bit-equal to the Python readers'.

This host has ``g++`` and libpng's header, so the library is built with PNG
here; the H100's machine has no ``png.h``, and there it reads PGM and .flo
only (``has_png()`` False), which ``test_png_refused_without_libpng``
holds on a build without it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from frame2frame_tpu.io import flo as jflo  # noqa: E402
from frame2frame_tpu.io.image import write_gray as jwrite_gray  # noqa: E402
from frame2frame_tpu_torch.io import flo as tflo  # noqa: E402
from frame2frame_tpu_torch.io import native  # noqa: E402
from frame2frame_tpu_torch.io.image import write_pgm  # noqa: E402


@pytest.fixture(scope="module")
def lib():
    if not native.available():
        pytest.skip("no g++ on this host")
    return native.load()


def test_native_flo_roundtrip(lib, tmp_path):
    flow = np.random.default_rng(0).normal(size=(9, 7, 2)).astype(np.float32)
    p = tmp_path / "t.flo"
    native.write_flo(p, flow)
    np.testing.assert_array_equal(native.read_flo(p), flow)
    np.testing.assert_array_equal(tflo.read_flo(p), flow)
    np.testing.assert_array_equal(jflo.read_flo(p), flow)
    p2 = tmp_path / "t2.flo"
    jflo.write_flo(p2, flow)
    np.testing.assert_array_equal(native.read_flo(p2), flow)
    assert p.read_bytes() == p2.read_bytes()


def test_native_png_decode(lib, tmp_path):
    assert native.has_png()
    img = np.random.default_rng(1).integers(0, 256, (12, 17)).astype(np.uint8)
    p = tmp_path / "t.png"
    jwrite_gray(p, img)
    got = native.read_gray(p)
    assert got.dtype == np.float32 and got.shape == img.shape
    np.testing.assert_array_equal(got, img.astype(np.float32))


def test_native_pgm_rule(lib, tmp_path):
    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, (5, 9)).astype(np.uint8)
    p = tmp_path / "a.pgm"
    write_pgm(p, img)
    np.testing.assert_array_equal(native.read_gray(p), img)
    p = tmp_path / "c.pgm"
    p.write_bytes(b"P5\n# a comment\n9 5\n# another\n255\n" + img.tobytes())
    np.testing.assert_array_equal(native.read_gray(p), img)
    p = tmp_path / "w.pgm"
    p.write_bytes(b"P5\n3 2\n65535\n" + bytes(12))
    with pytest.raises(IOError, match="maxval"):
        native.read_gray(p)
    p = tmp_path / "short.pgm"
    p.write_bytes(b"P5\n9 5\n255\n" + img.tobytes()[:-1])
    with pytest.raises(IOError, match="malformed"):
        native.read_gray(p)


def _sequence(tmp_path, n, shapes, ext):
    rng = np.random.default_rng(2)
    frame_paths, flow_paths, frames, flows = [], [], [], []
    for i in range(n):
        img = rng.integers(0, 256, shapes[i]).astype(np.uint8)
        fp = tmp_path / f"f{i:03d}.{ext}"
        (write_pgm if ext == "pgm" else jwrite_gray)(fp, img)
        frames.append(img)
        frame_paths.append(fp)
        if i > 0:
            fl = rng.normal(size=shapes[i] + (2,)).astype(np.float32)
            lp = tmp_path / f"f{i:03d}.flo"
            jflo.write_flo(lp, fl)
            flows.append(fl)
            flow_paths.append(lp)
        else:
            flows.append(None)
            flow_paths.append(None)
    return frame_paths, flow_paths, frames, flows


@pytest.mark.parametrize("ext", ["png", "pgm"])
def test_prefetcher_order_and_flow(lib, tmp_path, ext):
    n = 6
    paths, fpaths, frames, flows = _sequence(tmp_path, n, [(8, 10)] * n, ext)
    with native.NativePrefetcher(paths, fpaths, capacity=3,
                                 nthreads=2) as pf:
        for i in range(n):
            frame, flow = pf.get(i)
            np.testing.assert_array_equal(frame, frames[i])
            if i == 0:
                assert flow is None
            else:
                np.testing.assert_array_equal(flow, flows[i])


def test_prefetcher_sizes_buffers_from_each_frame(lib, tmp_path):
    shapes = [(8, 10), (3, 4), (31, 17), (1, 1)]
    paths, fpaths, frames, flows = _sequence(tmp_path, 4, shapes, "pgm")
    with native.NativePrefetcher(paths, fpaths, capacity=1) as pf:
        for i, shape in enumerate(shapes):
            frame, flow = pf.get(i)
            assert frame.shape == shape
            assert flow is None or flow.shape == shape + (2,)
        # each frame is taken once
        with pytest.raises(IOError):
            pf.get(0)


def test_prefetcher_missing_file(lib, tmp_path):
    pf = native.NativePrefetcher([tmp_path / "nope.png"], capacity=1)
    with pytest.raises(IOError):
        pf.get(0)
    pf.close()
    with pytest.raises(IOError, match="closed"):
        pf.get(0)


def test_prefetcher_failure_keeps_the_ring_moving(lib, tmp_path):
    """A frame that fails still moves the window, so the frames after it
    are delivered (capacity 1)."""
    paths, fpaths, frames, _ = _sequence(tmp_path, 3, [(4, 6)] * 3, "pgm")
    fpaths[1] = tmp_path / "missing.flo"
    with native.NativePrefetcher(paths, fpaths, capacity=1) as pf:
        np.testing.assert_array_equal(pf.get(0)[0], frames[0])
        with pytest.raises(IOError):
            pf.get(1)
        np.testing.assert_array_equal(pf.get(2)[0], frames[2])


def test_png_refused_without_libpng(tmp_path, monkeypatch):
    """A build without libpng (as on a host without png.h) reads PGM and
    refuses a .png path."""
    if not native.available():
        pytest.skip("no g++ on this host")
    monkeypatch.setattr(native, "_libs", lambda cxx: ["-lpthread"])
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "CXX_FLAGS",
                        native.CXX_FLAGS + ["-D__has_include(x)=0"])
    try:
        lib = native.load()
    except RuntimeError as e:  # a compiler that refuses the definition
        pytest.skip(f"cannot hide png.h from this compiler: {e}")
    assert not native.has_png()
    img = np.arange(12, dtype=np.uint8).reshape(3, 4)
    jwrite_gray(tmp_path / "a.png", img)
    write_pgm(tmp_path / "a.pgm", img)
    np.testing.assert_array_equal(native.read_gray(tmp_path / "a.pgm"), img)
    with pytest.raises(IOError, match="without libpng"):
        native.read_gray(tmp_path / "a.png")
    assert lib is native._lib


def test_run_blind_denoising_takes_the_ring(lib, tmp_path):
    """PGM frames go through the ring, with the losses and PSNR that the
    Python readers give on the same values as float TIFF frames, bit for
    bit."""
    from frame2frame_tpu_torch.io.image import write_gray
    from frame2frame_tpu_torch.models.dncnn import init_dncnn
    from frame2frame_tpu_torch.train import online

    H, W, n = 16, 24, 4
    rng = np.random.default_rng(3)
    for i in range(1, n + 1):
        img = rng.integers(0, 256, (H, W)).astype(np.uint8)
        write_pgm(tmp_path / f"noisy_{i:03d}.pgm", img)
        write_gray(tmp_path / f"noisy_{i:03d}.tif", img.astype(np.float32))
        write_pgm(tmp_path / f"clean_{i:03d}.pgm", img // 2 + 60)
        tflo.write_flo(tmp_path / f"flow_{i:03d}.flo",
                       rng.normal(0, 0.5, (H, W, 2)).astype(np.float32))
    runs = {}
    for ext in ("pgm", "tif"):
        model, variables = init_dncnn(1, num_layers=4, conv_impl="xla")
        runs[ext] = online.run_blind_denoising(
            model, variables, str(tmp_path / f"noisy_%03d.{ext}"),
            flow_tmpl=str(tmp_path / "flow_%03d.flo"),
            ref_tmpl=str(tmp_path / "clean_%03d.pgm"),
            first=1, last=n, iters=2, device="cpu")
    assert runs["pgm"]["loader"] == "native"
    assert runs["tif"]["loader"] == "python"
    assert runs["pgm"]["psnr"] == runs["tif"]["psnr"]
    for a, b in zip(runs["pgm"]["loss"], runs["tif"]["loss"], strict=True):
        np.testing.assert_array_equal(a, b)


def test_run_blind_denoising_without_gxx_reads_in_python(tmp_path,
                                                         monkeypatch):
    """On a host without ``g++`` the ring is not built: PGM and PNG frames
    go to the Python readers, and the results say so."""
    from frame2frame_tpu_torch.models.dncnn import init_dncnn
    from frame2frame_tpu_torch.train import online

    def no_build():
        raise AssertionError("the library was loaded without g++")

    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    monkeypatch.setattr(native, "load", no_build)
    H, W, n = 16, 24, 3
    rng = np.random.default_rng(5)
    for i in range(1, n + 1):
        img = rng.integers(0, 256, (H, W)).astype(np.uint8)
        write_pgm(tmp_path / f"noisy_{i:03d}.pgm", img)
        jwrite_gray(tmp_path / f"noisy_{i:03d}.png", img)
        tflo.write_flo(tmp_path / f"flow_{i:03d}.flo",
                       rng.normal(0, 0.5, (H, W, 2)).astype(np.float32))
    assert not native.available()
    runs = {}
    for ext in ("pgm", "png"):
        model, variables = init_dncnn(1, num_layers=3, conv_impl="xla")
        runs[ext] = online.run_blind_denoising(
            model, variables, str(tmp_path / f"noisy_%03d.{ext}"),
            flow_tmpl=str(tmp_path / "flow_%03d.flo"), first=1, last=n,
            iters=1, device="cpu")
        assert runs[ext]["loader"] == "python"
    for a, b in zip(runs["pgm"]["loss"], runs["png"]["loss"], strict=True):
        np.testing.assert_array_equal(a, b)
