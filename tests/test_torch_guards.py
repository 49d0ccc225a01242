"""Guards of the port's boundaries: it never imports JAX, flax or the JAX
package; its checkpoint reader decodes flax msgpack files bit for bit."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.serialization as fser  # noqa: E402

from frame2frame_tpu_torch.models.serialization import (  # noqa: E402
    load_variables,
    strip_prefix,
    unpackb,
)

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "frame2frame_tpu_torch"
CKPT = REPO / "results" / "dncnn17_s25" / "checkpoint.msgpack"


def test_port_modules_import_no_jax():
    """Every module of the package, imported in a fresh interpreter, leaves
    jax, flax and frame2frame_tpu out of sys.modules."""
    code = """
import importlib, pkgutil, sys
import frame2frame_tpu_torch as p
names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = [k for k in sys.modules if k.split(".")[0] in ("jax", "flax", "frame2frame_tpu")]
assert not bad, bad
print(len(names))
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 12


def test_port_sources_name_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|frame2frame_tpu)\b",
                     re.MULTILINE)
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) >= 13
    for f in files:
        assert not pat.search(f.read_text()), f


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _assert_same_tree(got, want):
    got_leaves = dict(_leaves(got))
    want_leaves = dict(_leaves(want))
    assert got_leaves.keys() == want_leaves.keys()
    for path, w in want_leaves.items():
        g = got_leaves[path]
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray), path
            assert g.dtype == w.dtype and g.shape == w.shape, path
            assert g.tobytes() == w.tobytes(), path
        else:
            assert type(g) is type(w) and g == w, path


def test_load_variables_bit_equal_to_flax_on_checkpoint():
    got = load_variables(CKPT)
    want = fser.msgpack_restore(CKPT.read_bytes())
    _assert_same_tree(got, want)
    assert got["params"]["conv_0"]["kernel"].shape == (3, 3, 64, 64)


def test_unpackb_matches_flax_on_assorted_types():
    tree = {
        "arr": np.arange(12, dtype=np.int64).reshape(3, 4),
        "f16": np.linspace(-1, 1, 5, dtype=np.float16),
        "scalar": np.float32(3.5),
        "nested": {"neg": -3, "neg8": -100, "big": 2**40, "u16": 60000,
                   "f": 0.25, "s": "x" * 40, "t": True, "none": None,
                   "long": list(range(20))},
        "bytes": b"\x00\x01" * 200,
    }
    data = fser.msgpack_serialize(tree)
    _assert_same_tree(unpackb(data), fser.msgpack_restore(data))
    with pytest.raises(ValueError):
        unpackb(data + b"\x00")
    with pytest.raises(ValueError):
        unpackb(data[:-3])


def test_strip_prefix():
    sd = {"net.dncnn.0.weight": 1, "dncnn.1.bias": 2}
    assert strip_prefix(sd) == {"dncnn.0.weight": 1, "dncnn.1.bias": 2}


def test_kernel_library_is_named_by_its_source(tmp_path, monkeypatch):
    """An edited CUDA source gets a new library name, so a stale build in
    build/ is never loaded for it."""
    from frame2frame_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text("// one\n")
    first = _build.library_path("k")
    (tmp_path / "k.cu").write_text("// two\n")
    second = _build.library_path("k")
    assert first != second
    assert first.parent == second.parent == _build.BUILD_DIR
    assert _build.BUILD_DIR == REPO / "build"
