"""A reader of flax's ``.msgpack`` parameter files, in plain Python and numpy.

The JAX package writes its converted weights with
``flax.serialization.msgpack_serialize`` (``tools/convert_weights.py:436-447``):
the MessagePack encoding of a tree of maps with array leaves, where

  * ext type 1 is an ndarray: itself the MessagePack array ``(shape, dtype
    name, C-order bytes)``;
  * ext type 3 is a numpy scalar, encoded as a 0-d ndarray;
  * an array above flax's ``MAX_CHUNK_SIZE`` bytes is a map
    ``{"__msgpack_chunked_array__": True, "shape": {"0": d0, ...},
    "chunks": {"0": flat chunk, ...}}``, put back together here.

``read_msgpack`` decodes every MessagePack format (maps, arrays, strings,
binaries, nil and booleans, every int and float width, ext and fixext) without
the ``msgpack`` package.  Leaves come back as numpy arrays, except
``bfloat16`` ones, which numpy has no dtype for: they come back as
``torch.bfloat16`` tensors, their bytes read through a ``uint16`` view.
A truncated, empty or malformed file raises ``ValueError`` naming it.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_SIMPLE = {0xC0: None, 0xC2: False, 0xC3: True}
_SIZED = {  # first byte -> (length format, what follows)
    0xC4: (">B", "binary"), 0xC5: (">H", "binary"), 0xC6: (">I", "binary"),
    0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
    0xD9: (">B", "text"), 0xDA: (">H", "text"), 0xDB: (">I", "text"),
    0xDC: (">H", "array"), 0xDD: (">I", "array"),
    0xDE: (">H", "map"), 0xDF: (">I", "map"),
}
_NUMBERS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}


class _Decoder:
    def __init__(self, data, name: str):
        self.buf = memoryview(data)
        self.pos = 0
        self.name = name

    def fail(self, why: str) -> ValueError:
        return ValueError(f"{self.name}: not a flax msgpack file ({why} at byte {self.pos})")

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError(f"{self.name}: truncated msgpack data (wants {n} bytes at byte "
                             f"{self.pos} of {len(self.buf)})")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def decode(self) -> Any:
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
            return self.text(b & 0x1F)
        if b in _SIMPLE:
            return _SIMPLE[b]
        if b in _SIZED:
            fmt, what = _SIZED[b]
            return getattr(self, what)(self.unpack(fmt))
        if b in _NUMBERS:
            return self.unpack(_NUMBERS[b])
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            return self.ext(1 << (b - 0xD4))
        raise self.fail(f"byte 0x{b:02x} starts no msgpack object")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.decode()
            out[key] = self.decode()
        return out

    def array(self, n: int) -> list:
        return [self.decode() for _ in range(n)]

    def text(self, n: int) -> str:
        try:
            return str(self.take(n), "utf-8")
        except UnicodeDecodeError as e:
            raise self.fail(f"a string that is not UTF-8 ({e})") from None

    def binary(self, n: int) -> bytes:
        return bytes(self.take(n))

    def header(self, kinds: dict, what: str) -> int:
        """The length in the header of a ``what`` whose first bytes are in
        ``kinds`` (first byte -> length format, or a mask of a fix format)."""
        b = self.unpack(">B")
        for first, fmt in kinds.items():
            if isinstance(first, range) and b in first:
                return b & fmt
            if b == first:
                return self.unpack(fmt)
        raise self.fail(f"byte 0x{b:02x} where a {what} starts")

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        payload = self.take(n)
        inner = _Decoder(payload, self.name)
        if code == _EXT_NDARRAY:
            return inner.ndarray()
        if code == _EXT_NPSCALAR:
            arr = inner.ndarray()
            return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
        raise self.fail(f"ext type {code}, which no flax parameter tree holds")

    def ndarray(self):
        """flax's ``_ndarray_from_bytes``: (shape, dtype name, C-order bytes);
        the array is a view of the file's bytes, not a copy."""
        if self.header({range(0x90, 0xA0): 0x0F, 0xDC: ">H", 0xDD: ">I"}, "array") != 3:
            raise self.fail("an ndarray ext that is not (shape, dtype, bytes)")
        shape, dtype = self.decode(), self.decode()
        raw = self.take(self.header({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}, "binary"))
        shape = tuple(int(d) for d in shape)
        if dtype == "bfloat16":
            bits = np.frombuffer(raw, np.uint16).reshape(shape)
            return torch.from_numpy(bits.copy()).view(torch.bfloat16)
        try:
            return np.frombuffer(raw, np.dtype(dtype)).reshape(shape)
        except (TypeError, ValueError) as e:
            raise self.fail(f"an ndarray of dtype {dtype!r} and shape {shape} ({e})") from None


def _unchunk(tree: Any) -> Any:
    """Chunked array leaves put back together (flax's ``_unchunk``)."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(int(tree["shape"][str(i)]) for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def read_msgpack(path: str) -> Any:
    """The tree of the flax ``.msgpack`` file ``path`` (flax's
    ``msgpack_restore`` of its bytes)."""
    with open(path, "rb") as f:
        dec = _Decoder(f.read(), path)
    if not len(dec.buf):
        raise ValueError(f"{path}: truncated msgpack data (an empty file)")
    tree = dec.decode()
    if dec.pos != len(dec.buf):
        raise dec.fail(f"{len(dec.buf) - dec.pos} bytes after the tree")
    return _unchunk(tree)
