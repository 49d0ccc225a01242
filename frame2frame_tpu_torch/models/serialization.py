"""Checkpoint reading and writing for the port.

``load_variables`` decodes flax's msgpack checkpoints (``flax.serialization``
``to_bytes`` / ``msgpack_restore``) with a small pure-Python msgpack reader,
and ``save_variables`` / ``save_train_state`` write them with its inverse
(``packb``), so the port needs neither flax nor the ``msgpack`` package, and
the JAX package reads what it writes. Arrays are flax's ext type 1,
``(shape, dtype name, C-order bytes)``, and numpy scalars its ext type 3 in
the same encoding; ``packb`` encodes every value in the smallest form, as the
``msgpack`` package does, and a dict in sorted key order, as JAX's tree
functions leave it, so it gives the JAX package's bytes for the same tree.
Before writing, a tree becomes flax's state dict (``to_state_dict``): lists
and tuples become dicts keyed ``"0"``, ``"1"``, ..., keys become strings,
and torch tensors and numpy scalars numpy arrays. ``load_variables(path,
like=)`` restores into ``like``'s structure as ``flax.serialization.
from_bytes`` does, and is stricter: a key missing from either side raises.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in sized:
            return bytes(self.take(self.unpack(sized[b])))
        sized = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in sized:
            return str(self.take(self.unpack(sized[b])), "utf-8")
        sized = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in sized:
            n = self.unpack(sized[b])
            return self.ext(self.unpack(">b"), self.take(n))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            code = self.unpack(">b")
            return self.ext(code, self.take(fixext[b]))
        scalar = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                  0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in scalar:
            return self.unpack(scalar[b])
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"unknown msgpack type byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def ext(self, code: int, data: memoryview):
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype, buf = unpackb(bytes(data))
        arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)
        return arr if code == _EXT_NDARRAY else arr[()]


def unpackb(data: bytes):
    """Decode one msgpack object (maps, lists, str, bin, numbers and flax's
    array ext types)."""
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after msgpack object")
    return out


def load_variables(path, like=None):
    """A flax msgpack checkpoint -> its tree of dicts with numpy leaves, or,
    given ``like``, the file restored into ``like``'s structure (dicts,
    lists, tuples; the leaves are the file's). Raises ``ValueError`` where
    the file's keys and ``like``'s differ."""
    tree = unpackb(Path(path).read_bytes())
    if isinstance(tree, dict) and _has_chunked(tree):
        raise ValueError("chunked array leaves (arrays over 1 GiB) are not "
                         "supported")
    return tree if like is None else _restore(like, tree, "")


def _restore(like, state, path):
    """flax's ``from_state_dict`` for dicts, lists and tuples, with the keys
    held equal both ways."""
    if isinstance(like, (dict, list, tuple)):
        if not isinstance(state, dict):
            raise ValueError(f"{path or '/'}: the file holds a "
                             f"{type(state).__name__} where the target holds "
                             f"a {type(like).__name__}")
        keys = ({str(k): k for k in like} if isinstance(like, dict)
                else {str(i): i for i in range(len(like))})
        missing = sorted(set(keys) - set(state))
        extra = sorted(set(state) - set(keys))
        if missing or extra:
            raise ValueError(f"{path or '/'}: keys missing from the file "
                             f"{missing}, keys the target lacks {extra}")
        out = {k: _restore(like[k], state[s], f"{path}/{s}")
               for s, k in keys.items()}
        if isinstance(like, dict):
            return out
        return type(like)(out[i] for i in range(len(like)))
    if isinstance(state, dict):
        raise ValueError(f"{path or '/'}: the file holds a dict where the "
                         f"target holds a leaf")
    return state


def _has_chunked(d):
    return any(k == "__msgpack_chunked_array__"
               or (isinstance(v, dict) and _has_chunked(v))
               for k, v in d.items())


def strip_prefix(state_dict, prefix="net."):
    """Strip a wrapper prefix (e.g. Lightning's ``net.``) from state-dict
    keys so the bare model loads them."""
    return {(k[len(prefix):] if k.startswith(prefix) else k): v
            for k, v in state_dict.items()}


def _pack(obj, out: list):
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        out.append(_pack_int(obj))
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        out.append(_head(len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        out.append(_head(len(data), None, -1, (0xC4, 0xC5, 0xC6)) + data)
    elif isinstance(obj, dict):
        out.append(_head(len(obj), 0x80, 15, (None, 0xDE, 0xDF)))
        # in sorted key order, as JAX's tree functions (``device_get``,
        # ``tree_map``) leave a dict before flax encodes it
        for k, v in sorted(obj.items()):
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        out.append(_head(len(obj), 0x90, 15, (None, 0xDC, 0xDD)))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, np.ndarray):
        out.append(_ext(_EXT_NDARRAY, _ndarray_bytes(obj)))
    elif isinstance(obj, np.generic):
        out.append(_ext(_EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj))))
    else:
        raise TypeError(f"cannot encode {type(obj).__name__} in msgpack")


def _head(n, fix, fix_max, sized):
    """Type byte and length of a str, bin, map or array of n entries: the
    fix form up to ``fix_max``, else 8-, 16- or 32-bit lengths."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for code, fmt, top in zip(sized, (">B", ">H", ">I"),
                              (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack object of {n} entries is too large")


def _pack_int(n):
    if 0 <= n <= 0x7F or -32 <= n < 0:
        return struct.pack(">b" if n < 0 else ">B", n)
    if n > 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF),
                               (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if n <= top:
                return bytes([code]) + struct.pack(fmt, n)
    else:
        for code, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                               (0xD2, ">i", -0x80000000),
                               (0xD3, ">q", -0x8000000000000000)):
            if n >= low:
                return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"integer {n} does not fit msgpack")


def _ext(code, data):
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixext:
        head = bytes([fixext[len(data)]])
    else:
        head = _head(len(data), None, -1, (0xC7, 0xC8, 0xC9))
    return head + struct.pack(">b", code) + data


def _ndarray_bytes(arr):
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not supported")
    if arr.nbytes > _MAX_CHUNK_BYTES:
        raise ValueError("arrays over 1 GiB (flax's chunked leaves) are not "
                         "supported")
    return packb((arr.shape, arr.dtype.name, arr.tobytes("C")))


_MAX_CHUNK_BYTES = 2 ** 30


def packb(obj) -> bytes:
    """Encode one object (dicts, lists and tuples, str, bytes, numbers,
    numpy arrays and scalars) as flax's ``msgpack_serialize`` does."""
    out = []
    _pack(obj, out)
    return b"".join(out)


def _state_dict(tree):
    """flax's ``to_state_dict`` of a tree after JAX's ``device_get``: dicts
    with string keys, lists and tuples as dicts keyed by their indices,
    torch tensors and numpy scalars as numpy arrays."""
    if isinstance(tree, dict):
        out = {str(k): _state_dict(v) for k, v in tree.items()}
        if len(out) != len(tree):
            raise ValueError("dict keys without a unique string form")
        return out
    if isinstance(tree, (list, tuple)):
        return {str(i): _state_dict(v) for i, v in enumerate(tree)}
    if hasattr(tree, "detach"):
        return tree.detach().cpu().numpy()
    if isinstance(tree, np.generic):
        return np.asarray(tree)
    return tree


def save_variables(path, variables):
    """Write a tree (dicts, lists, tuples; numpy or torch leaves, numbers,
    strings) to a flax msgpack file, as the JAX package's ``save_variables``
    writes it; returns the path as a string."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(packb(_state_dict(variables)))
    return str(path)


def save_train_state(path, params, opt_state, batch_stats=None, extra=None):
    """A training state as the JAX package's ``save_train_state`` writes it,
    the counterpart of ``torch.save([model, optimizer])`` at
    blind_denoising.py:258: ``{"params", "opt_state", "batch_stats",
    "extra"}`` (the last two where given), with ``opt_state`` in the JAX
    package's form (``models.dncnn.opt_state_to_jax``)."""
    state = {"params": params, "opt_state": opt_state}
    if batch_stats is not None:
        state["batch_stats"] = batch_stats
    if extra is not None:
        state["extra"] = extra
    return save_variables(path, state)


def load_train_state(path, like):
    """A training state restored into ``like``'s structure."""
    return load_variables(path, like=like)
