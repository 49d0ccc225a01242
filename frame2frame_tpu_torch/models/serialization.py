"""Checkpoint reading for the port.

``load_variables`` decodes flax's msgpack checkpoints (``flax.serialization``
``to_bytes`` / ``msgpack_restore``) with a small pure-Python msgpack reader,
so it needs neither flax nor the ``msgpack`` package. Arrays are flax's ext
type 1, ``(shape, dtype name, C-order bytes)``, and numpy scalars its ext
type 3 in the same encoding.
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


def load_variables(path):
    """A flax msgpack checkpoint -> its tree of dicts with numpy leaves."""
    tree = unpackb(Path(path).read_bytes())
    if isinstance(tree, dict) and _has_chunked(tree):
        raise ValueError("chunked array leaves (arrays over 1 GiB) are not "
                         "supported")
    return tree


def _has_chunked(d):
    return any(k == "__msgpack_chunked_array__"
               or (isinstance(v, dict) and _has_chunked(v))
               for k, v in d.items())


def strip_prefix(state_dict, prefix="net."):
    """Strip a wrapper prefix (e.g. Lightning's ``net.``) from state-dict
    keys so the bare model loads them."""
    return {(k[len(prefix):] if k.startswith(prefix) else k): v
            for k, v in state_dict.items()}
