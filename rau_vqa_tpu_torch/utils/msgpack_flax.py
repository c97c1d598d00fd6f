"""A decoder for the msgpack that ``flax.serialization.to_bytes`` writes.

The JAX package saves its snapshots with flax (``rau_vqa_tpu/utils/
checkpoint.py``): ``msgpack.packb`` of the state dict with three extension
types.  This module reads that subset in pure Python, without ``msgpack`` or
flax, and gives the arrays as tensors (``bfloat16`` as ``torch.bfloat16``):

- maps, arrays, strings, bin, nil, booleans, floats and ints of every width;
- ext 1, an ndarray: the msgpack of ``(shape, dtype name, C-order bytes)``;
- ext 3, a numpy scalar: the same, with shape ``()``;
- the ``{"__msgpack_chunked_array__": True, "shape", "chunks"}`` maps that
  flax writes for arrays over 2**30 bytes, joined back into one tensor.

Anything else (ext 2, complex numbers; other extension types; the unused
byte 0xc1) raises ``ValueError``.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import torch

_DTYPES = {
    "float64": torch.float64, "float32": torch.float32,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
    "int8": torch.int8, "uint64": torch.uint64, "uint32": torch.uint32,
    "uint16": torch.uint16, "uint8": torch.uint8, "bool": torch.bool,
}
_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated input")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:                       # positive fixint
            return b
        if b >= 0xE0:                       # negative fixint
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.text(b & 0x1F)
        if b in _SIMPLE:
            return _SIMPLE[b]
        if b in _NUMBERS:
            return self.unpack(_NUMBERS[b])
        if b in (0xC4, 0xC5, 0xC6):         # bin 8 / 16 / 32
            return bytes(self.take(self.unpack(_LENGTHS[b])))
        if b in (0xD9, 0xDA, 0xDB):         # str 8 / 16 / 32
            return self.text(self.unpack(_LENGTHS[b]))
        if b in (0xDC, 0xDD):               # array 16 / 32
            return self.array(self.unpack(_LENGTHS[b]))
        if b in (0xDE, 0xDF):               # map 16 / 32
            return self.map(self.unpack(_LENGTHS[b]))
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b])
        if b in (0xC7, 0xC8, 0xC9):         # ext 8 / 16 / 32
            return self.ext(self.unpack(_LENGTHS[b]))
        raise ValueError(f"msgpack: byte 0x{b:02x} at {self.pos - 1} is no "
                         f"type this decoder reads")

    def text(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def ext(self, n: int) -> torch.Tensor:
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack: extension type {code} is not an "
                             f"ndarray (1) or a numpy scalar (3)")
        inner = _Reader(payload)
        shape, dtype, raw = inner.obj()
        if inner.pos != len(payload):
            raise ValueError("msgpack: trailing bytes in an ndarray payload")
        return _tensor(tuple(shape), dtype, raw)


_SIMPLE = {0xC0: None, 0xC2: False, 0xC3: True}
_NUMBERS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
            0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LENGTHS = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H",
            0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I",
            0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _tensor(shape: Tuple[int, ...], dtype_name, raw: bytes) -> torch.Tensor:
    """C-order little-endian bytes of ``dtype_name`` as a tensor of ``shape``."""
    name = dtype_name.decode() if isinstance(dtype_name, bytes) else dtype_name
    if name not in _DTYPES:
        raise ValueError(f"msgpack: ndarray type {name!r} is not one this "
                         f"decoder reads")
    dtype = _DTYPES[name]
    n = 1
    for s in shape:
        n *= int(s)
    if len(raw) != n * dtype.itemsize:
        raise ValueError(f"msgpack: {len(raw)} bytes for a {name} array of "
                         f"shape {shape}")
    if n == 0:
        return torch.empty(shape, dtype=dtype)
    return torch.frombuffer(bytearray(raw), dtype=dtype).reshape(shape)


def _unchunk(tree: Any) -> Any:
    if isinstance(tree, dict):
        if tree.get(_CHUNKED) is True:
            shape = tuple(int(tree["shape"][str(i)])
                          for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def loads(data: bytes) -> Any:
    """The tree that ``flax.serialization.msgpack_restore`` gives for
    ``data``, with every array a CPU tensor (numpy scalars as 0-d ones)."""
    r = _Reader(data)
    tree = r.obj()
    if r.pos != len(data):
        raise ValueError(f"msgpack: {len(data) - r.pos} trailing bytes")
    return _unchunk(tree)
