"""Build and load the port's CUDA sources (``frame2frame_tpu_torch/csrc``).

Each ``.cu`` file compiles on its own with ``nvcc`` into a shared library with
a plain C interface, loaded with ``ctypes``. PyTorch's headers are kept out
of the sources so a build takes seconds, not minutes. Libraries land in
``build/`` at the repository root, named by a hash of the source and of the
headers beside it (``csrc/*.cuh``), so an edited source is rebuilt and an
unchanged one is loaded as it is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        src += header.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}.{digest[:12]}.so"


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library exists; returns the
    compiler's report (registers, shared memory, spills), or "" when the
    library was already built."""
    out = library_path(name)
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{res.stderr}")
    os.replace(tmp, out)
    return res.stdout + res.stderr


def sources() -> list[str]:
    """Names of the CUDA sources, ``csrc/<name>.cu``."""
    return sorted(f.stem for f in CSRC.glob("*.cu"))


def build_all() -> dict[str, str]:
    """Compile every source at once, one ``nvcc`` process each; returns the
    compiler's report by source name."""
    names = sources()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(build, names)))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib
