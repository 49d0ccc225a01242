"""ctypes bindings of the native host I/O runtime (``csrc/f2fio.cpp``): the
.flo codec, PGM / PNG grayscale decode, and a multi-threaded prefetch ring
that decodes frames and their flows ahead of the streaming loop.

Counterpart of ``frame2frame_tpu/io/native.py``. The source is the port's
own copy of the JAX package's ``native/f2fio.cpp``; it is built at first use
with ``g++`` into ``build/`` at the repository root, named by a hash of the
source and the build command, as ``ops/_build.py`` does for the CUDA
sources. ``-lpng`` is linked where the host has libpng's header; without it
the library reads PGM and .flo only, and ``has_png()`` says so (a ``.png``
path then raises). PGM frames follow ``io/image.py``'s rule: 8 bits with
maxval 255, anything else refused. A failed build raises: nothing falls
back to the Python readers here (``train/online.run_blind_denoising``
picks its loader from the input's format and ``has_png()``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "f2fio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-Wall"]

_lock = threading.Lock()
_lib = None

_ERRORS = {-1: "missing, unreadable or malformed file",
           -2: "frame index outside the sequence",
           -3: "a .png frame, but the library was built without libpng",
           -4: "PGM with a maxval other than 255: only 8-bit frames with "
               "maxval 255 are read",
           -5: "flow and frame shapes differ", -6: "the ring was closed"}

_FLOAT_P = ctypes.POINTER(ctypes.c_float)
_INT_P = ctypes.POINTER(ctypes.c_int)


def _compiler():
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native I/O library is built "
                           "with g++")
    return cxx


def _libs(cxx):
    """``-lpthread``, and ``-lpng`` where the preprocessor finds png.h."""
    probe = subprocess.run([cxx, "-E", "-x", "c++", "-", "-o", os.devnull],
                           input="#include <png.h>\n", capture_output=True,
                           text=True)
    return ["-lpthread"] + (["-lpng"] if probe.returncode == 0 else [])


def library_path(libs):
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS + libs).encode()).hexdigest()
    return BUILD_DIR / f"libf2fio.{digest[:12]}.so"


def _declare(lib):
    lib.f2f_has_png.restype = ctypes.c_int
    lib.f2f_has_png.argtypes = []
    lib.f2f_free.restype = None
    lib.f2f_free.argtypes = [_FLOAT_P]
    for name in ("f2f_read_flo", "f2f_read_gray"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_char_p, ctypes.POINTER(_FLOAT_P), _INT_P,
                       _INT_P]
    lib.f2f_write_flo.restype = ctypes.c_int
    lib.f2f_write_flo.argtypes = [ctypes.c_char_p, _FLOAT_P, ctypes.c_int,
                                  ctypes.c_int]
    lib.f2f_prefetch_open.restype = ctypes.c_void_p
    lib.f2f_prefetch_open.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.f2f_prefetch_wait.restype = ctypes.c_int
    lib.f2f_prefetch_wait.argtypes = [ctypes.c_void_p, ctypes.c_int, _INT_P,
                                      _INT_P, _INT_P]
    lib.f2f_prefetch_take.restype = ctypes.c_int
    lib.f2f_prefetch_take.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      _FLOAT_P, _FLOAT_P]
    lib.f2f_prefetch_close.restype = None
    lib.f2f_prefetch_close.argtypes = [ctypes.c_void_p]
    return lib


def load():
    """The loaded library, built at first use; raises where the build
    fails."""
    global _lib
    with _lock:
        if _lib is None:
            cxx = _compiler()
            libs = _libs(cxx)
            out = library_path(libs)
            if not out.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp),
                                      str(SOURCE), *libs],
                                     capture_output=True, text=True)
                if res.returncode != 0:
                    raise RuntimeError(f"g++ failed on {SOURCE.name}:\n"
                                       f"{res.stderr}")
                os.replace(tmp, out)
            _lib = _declare(ctypes.CDLL(str(out)))
        return _lib


def available():
    """Whether the library can be had here: a C++ compiler is on the PATH
    (the library is then built, and a failed build raises)."""
    if shutil.which("g++") is None:
        return False
    load()
    return True


def has_png():
    """Whether the library decodes PNG (it was built against libpng)."""
    return bool(load().f2f_has_png())


def _check(rc, what):
    if rc != 0:
        raise IOError(f"{what}: {_ERRORS.get(rc, f'error {rc}')}")


def _read(fn, path, shape):
    lib = load()
    out = _FLOAT_P()
    w, h = ctypes.c_int(), ctypes.c_int()
    _check(getattr(lib, fn)(os.fsencode(path), ctypes.byref(out),
                            ctypes.byref(w), ctypes.byref(h)), str(path))
    try:
        n = int(np.prod(shape(h.value, w.value)))
        return np.ctypeslib.as_array(out, (n,)).reshape(
            shape(h.value, w.value)).copy()
    finally:
        lib.f2f_free(out)


def read_flo(path):
    """A .flo file -> float32 (H, W, 2)."""
    return _read("f2f_read_flo", path, lambda h, w: (h, w, 2))


def write_flo(path, flow):
    flow = np.ascontiguousarray(flow, np.float32)
    if flow.ndim != 3 or flow.shape[-1] != 2:
        raise ValueError(f"flow must be (H, W, 2), got {flow.shape}")
    h, w = flow.shape[:2]
    _check(load().f2f_write_flo(os.fsencode(path),
                                flow.ctypes.data_as(_FLOAT_P), w, h),
           str(path))


def read_gray(path):
    """A PGM or PNG frame -> grayscale float32 (H, W) in [0, 255]."""
    return _read("f2f_read_gray", path, lambda h, w: (h, w))


class NativePrefetcher:
    """Multi-threaded decode-ahead over a frame (and optional .flo)
    sequence, delivered in order:

        pf = NativePrefetcher(frame_paths, flow_paths, capacity=4)
        for i in range(len(frame_paths)):
            frame, flow = pf.get(i)  # (H, W) f32 in [0, 255]; flow or None
        pf.close()

    At most ``capacity`` frames are decoded ahead of the last one taken;
    each frame is taken once, and its memory is freed when it is. ``get``
    sizes its buffers from the frame's shape."""

    def __init__(self, frame_paths, flow_paths=None, capacity=4, nthreads=2):
        self._lib = load()
        self.n = len(frame_paths)
        if flow_paths is None:
            flow_paths = [None] * self.n
        if len(flow_paths) != self.n:
            raise ValueError("one flow path (or None) a frame")
        # ctypes arrays of the paths, kept while the ring may read them
        self._fp = (ctypes.c_char_p * self.n)(
            *[os.fsencode(p) for p in frame_paths])
        self._lp = (ctypes.c_char_p * self.n)(
            *[os.fsencode(p) if p else None for p in flow_paths])
        self._handle = self._lib.f2f_prefetch_open(self._fp, self._lp, self.n,
                                                   capacity, nthreads)
        if not self._handle:
            raise RuntimeError("f2f_prefetch_open failed")

    def get(self, idx):
        if not self._handle:
            raise IOError("the prefetcher is closed")
        w, h, hf = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        _check(self._lib.f2f_prefetch_wait(self._handle, idx, ctypes.byref(w),
                                           ctypes.byref(h), ctypes.byref(hf)),
               f"frame {idx}")
        frame = np.empty((h.value, w.value), np.float32)
        flow = np.empty((h.value, w.value, 2), np.float32) if hf.value \
            else None
        _check(self._lib.f2f_prefetch_take(
            self._handle, idx, frame.ctypes.data_as(_FLOAT_P),
            None if flow is None else flow.ctypes.data_as(_FLOAT_P)),
            f"frame {idx}")
        return frame, flow

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.f2f_prefetch_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
