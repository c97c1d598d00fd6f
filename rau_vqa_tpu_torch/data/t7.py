"""Minimal Torch7 (.t7) binary serialization reader/writer.

The reference stores per-image CNN features and training snapshots with
``torch.save`` (Torch7 format — NOT readable by PyTorch's ``torch.load``):
feature files at utils/vqa_prepro_loader.lua:877/941, snapshots at
Ours_SS/LstmAttCtrlGradNoiseDontSelect.lua:1188-1197.  This module implements
just enough of the format, from the published layout of torch7's
File.lua/serialization, to

- read feature tensors (Float/Double/Cuda) and snapshot tables, and
- write fixture tensors for round-trip tests.

Binary mode, little-endian: ints are 4 bytes, longs 8 bytes, numbers are
8-byte doubles, strings are int-length-prefixed bytes.

The port's own copy of ``rau_vqa_tpu/data/t7.py``.
"""

from __future__ import annotations

import struct
from typing import Any, BinaryIO, Dict

import numpy as np

TYPE_NIL = 0
TYPE_NUMBER = 1
TYPE_STRING = 2
TYPE_TABLE = 3
TYPE_TORCH = 4
TYPE_BOOLEAN = 5
TYPE_FUNCTION = 6
TYPE_RECUR_FUNCTION = 8
TYPE_LEGACY_RECUR_FUNCTION = 7

# torch storage/tensor class -> numpy dtype; Cuda classes hold float32 data
_STORAGE_DTYPES = {
    "torch.FloatStorage": np.float32,
    "torch.DoubleStorage": np.float64,
    "torch.CudaStorage": np.float32,
    "torch.LongStorage": np.int64,
    "torch.IntStorage": np.int32,
    "torch.ShortStorage": np.int16,
    "torch.CharStorage": np.int8,
    "torch.ByteStorage": np.uint8,
    "torch.HalfStorage": np.float16,
    "torch.CudaHalfStorage": np.float16,
}
_TENSOR_TO_STORAGE = {
    "torch.FloatTensor": "torch.FloatStorage",
    "torch.DoubleTensor": "torch.DoubleStorage",
    "torch.CudaTensor": "torch.CudaStorage",
    "torch.LongTensor": "torch.LongStorage",
    "torch.IntTensor": "torch.IntStorage",
    "torch.ShortTensor": "torch.ShortStorage",
    "torch.CharTensor": "torch.CharStorage",
    "torch.ByteTensor": "torch.ByteStorage",
    "torch.HalfTensor": "torch.HalfStorage",
    "torch.CudaHalfTensor": "torch.CudaHalfStorage",
}


class _Reader:
    def __init__(self, f: BinaryIO):
        self.f = f
        self.memo: Dict[int, Any] = {}
        # table idxs re-referenced WHILE still being read (cycles): those
        # keep their dict identity instead of converting to a list, so
        # every reference stays the same object (never silently stale)
        self._reffed: set = set()

    def _read(self, fmt: str):
        size = struct.calcsize(fmt)
        data = self.f.read(size)
        if len(data) != size:
            raise EOFError("truncated t7 stream")
        return struct.unpack(fmt, data)[0]

    def read_int(self) -> int:
        return self._read("<i")

    def read_long(self) -> int:
        return self._read("<q")

    def read_double(self) -> float:
        return self._read("<d")

    def read_string(self) -> str:
        n = self.read_int()
        return self.f.read(n).decode("utf-8", errors="replace")

    def read_object(self) -> Any:
        tcode = self.read_int()
        if tcode == TYPE_NIL:
            return None
        if tcode == TYPE_NUMBER:
            return self.read_double()
        if tcode == TYPE_STRING:
            return self.read_string()
        if tcode == TYPE_BOOLEAN:
            return bool(self.read_int())
        if tcode == TYPE_TABLE:
            return self._read_table()
        if tcode == TYPE_TORCH:
            return self._read_torch()
        if tcode in (TYPE_FUNCTION, TYPE_RECUR_FUNCTION, TYPE_LEGACY_RECUR_FUNCTION):
            raise NotImplementedError("t7 serialized functions are not supported")
        raise ValueError(f"unknown t7 type code {tcode}")

    def _read_table(self) -> Any:
        idx = self.read_int()
        if idx in self.memo:
            self._reffed.add(idx)
            return self.memo[idx]
        out: Dict[Any, Any] = {}
        self.memo[idx] = out
        n = self.read_int()
        for _ in range(n):
            k = self.read_object()
            v = self.read_object()
            out[k] = v
        # torch tables with consecutive 1..n numeric keys are Lua arrays —
        # but a table referenced from within itself (cycle) keeps its dict
        # identity: rebinding the memo to a new list would leave the inner
        # references pointing at a stale object
        keys = list(out.keys())
        if idx not in self._reffed and keys and all(
                isinstance(k, float) and k.is_integer() for k in keys):
            ints = sorted(int(k) for k in keys)
            if ints == list(range(1, len(ints) + 1)):
                arr = [out[float(i)] for i in ints]
                self.memo[idx] = arr
                return arr
        return out

    def _read_torch(self) -> Any:
        idx = self.read_int()
        if idx in self.memo:
            return self.memo[idx]
        version = self.read_string()
        if version.startswith("V "):
            class_name = self.read_string()
        else:
            class_name = version  # pre-versioning stream
        if class_name in _TENSOR_TO_STORAGE:
            obj = self._read_tensor(class_name)
        elif class_name in _STORAGE_DTYPES:
            obj = self._read_storage(class_name)
        else:
            # generic torch object: its state is one serialized object
            obj = {"__torch_class__": class_name, "state": self.read_object()}
        self.memo[idx] = obj
        return obj

    def _read_tensor(self, class_name: str) -> np.ndarray:
        ndim = self.read_int()
        sizes = [self.read_long() for _ in range(ndim)]
        strides = [self.read_long() for _ in range(ndim)]
        offset = self.read_long() - 1  # 1-based in the stream
        storage = self.read_object()
        if ndim == 0 or storage is None:
            dtype = _STORAGE_DTYPES[_TENSOR_TO_STORAGE[class_name]]
            return np.empty((0,), dtype=dtype)
        return np.lib.stride_tricks.as_strided(
            storage[offset:],
            shape=tuple(sizes),
            strides=tuple(s * storage.itemsize for s in strides),
        ).copy()

    def _read_storage(self, class_name: str) -> np.ndarray:
        dtype = np.dtype(_STORAGE_DTYPES[class_name])
        n = self.read_long()
        raw = self.f.read(n * dtype.itemsize)
        if len(raw) != n * dtype.itemsize:
            raise EOFError("truncated t7 storage")
        return np.frombuffer(raw, dtype=dtype).copy()


class _Writer:
    def __init__(self, f: BinaryIO):
        self.f = f
        self.next_idx = 1

    def write_int(self, v: int):
        self.f.write(struct.pack("<i", v))

    def write_long(self, v: int):
        self.f.write(struct.pack("<q", v))

    def write_double(self, v: float):
        self.f.write(struct.pack("<d", v))

    def write_string(self, s: str):
        b = s.encode("utf-8")
        self.write_int(len(b))
        self.f.write(b)

    def write_object(self, obj: Any):
        if obj is None:
            self.write_int(TYPE_NIL)
        elif isinstance(obj, bool):
            self.write_int(TYPE_BOOLEAN)
            self.write_int(int(obj))
        elif isinstance(obj, (int, float)):
            self.write_int(TYPE_NUMBER)
            self.write_double(float(obj))
        elif isinstance(obj, str):
            self.write_int(TYPE_STRING)
            self.write_string(obj)
        elif isinstance(obj, np.ndarray):
            self._write_tensor(obj)
        elif isinstance(obj, dict):
            self._write_table(obj.items())
        elif isinstance(obj, (list, tuple)):
            self._write_table((float(i + 1), v) for i, v in enumerate(obj))
        else:
            raise TypeError(f"cannot serialize {type(obj)} to t7")

    def _write_table(self, items):
        items = list(items)
        self.write_int(TYPE_TABLE)
        self.write_int(self.next_idx)
        self.next_idx += 1
        self.write_int(len(items))
        for k, v in items:
            self.write_object(k)
            self.write_object(v)

    def _write_tensor(self, arr: np.ndarray):
        tensor_cls = {
            np.dtype(np.float32): "torch.FloatTensor",
            np.dtype(np.float64): "torch.DoubleTensor",
            np.dtype(np.int64): "torch.LongTensor",
            np.dtype(np.int32): "torch.IntTensor",
            np.dtype(np.uint8): "torch.ByteTensor",
        }.get(arr.dtype)
        if tensor_cls is None:
            raise TypeError(f"no torch tensor class for dtype {arr.dtype}")
        if arr.ndim == 0:
            # Torch7 has no scalar tensor: ndim==0 means EMPTY there, so a
            # 0-d array would round-trip to an empty (0,) array, silently
            # losing the value — fail loudly instead
            raise ValueError(
                "0-d arrays have no Torch7 tensor representation "
                "(ndim==0 is an empty tensor there); reshape to (1,)")
        arr = np.ascontiguousarray(arr)
        self.write_int(TYPE_TORCH)
        self.write_int(self.next_idx)
        self.next_idx += 1
        self.write_string("V 1")
        self.write_string(tensor_cls)
        self.write_int(arr.ndim)
        for s in arr.shape:
            self.write_long(s)
        elem_strides = [st // arr.itemsize for st in arr.strides]
        for s in elem_strides:
            self.write_long(s)
        self.write_long(1)  # storageOffset, 1-based
        # storage
        self.write_int(TYPE_TORCH)
        self.write_int(self.next_idx)
        self.next_idx += 1
        self.write_string("V 1")
        self.write_string(_TENSOR_TO_STORAGE[tensor_cls])
        self.write_long(arr.size)
        self.f.write(arr.tobytes())


def load_t7(path: str) -> Any:
    """Read one serialized object from a Torch7 binary .t7 file."""
    with open(path, "rb") as f:
        return _Reader(f).read_object()


def save_t7(path: str, obj: Any) -> None:
    """Write one object in Torch7 binary format (tensors, tables, scalars)."""
    with open(path, "wb") as f:
        _Writer(f).write_object(obj)
