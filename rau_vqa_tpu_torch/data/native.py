"""ctypes bindings of the repo's native (C++) feature loader and image decoder.

``NativePackedFeatureStore`` is a ``FeatureSource`` over the packed shard
layout that ``PackedFeatureStore`` reads; its batch gather runs in the C++
worker pool of ``native/feature_loader.cpp`` (the role torch-threads and the
``.t7`` deserialization play in the reference, vqa_prepro_loader.lua:66-80,
931-958).  ``decode_image_batch`` decodes JPEG and PNG files in the C++ pool
of ``native/image_decode.cpp`` (libjpeg, libpng) with a point-sampled
Catmull-Rom shorter-side resize and a center crop.

Both libraries are compiled from the repo's own sources in ``native/`` with
``g++`` at first use, into ``rau_vqa_tpu_torch/_build/native/`` (the flags of
``native/Makefile``; nothing is written into ``native/``).  A build is
guarded against other processes by an exclusive lock on a file beside the
library and lands by an atomic rename, so a process never loads a library
that another one is still writing.  A failed build or load is remembered:
later calls raise :class:`NativeUnavailable` without compiling again, and the
callers fall back to Python.

The port's own copy of ``rau_vqa_tpu/data/native.py``.
"""

from __future__ import annotations

import ctypes
import fcntl
import json
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Sequence

import numpy as np

from rau_vqa_tpu_torch.data.features import FeatureSource

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_SRC = os.path.join(os.path.dirname(_PKG), "native")
BUILD_DIR = os.path.join(_PKG, "_build", "native")

CXXFLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-Wextra"]
LDFLAGS = ["-shared", "-pthread"]
# library name -> (source in native/, extra link flags), as native/Makefile
LIBRARIES = {"feature_loader": ("feature_loader.cpp", []),
             "image_decode": ("image_decode.cpp", ["-ljpeg", "-lpng"])}

_lock = threading.Lock()          # one loader a process; files lock processes
_libs: Dict[str, ctypes.CDLL] = {}
_errors: Dict[str, str] = {}


class NativeUnavailable(RuntimeError):
    """The native library cannot be built or loaded on this host (no
    compiler, missing headers or shared libraries).  Raised again, without
    a new build, on every later call in the process."""


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(lib: str, src: str) -> bool:
    return (not os.path.exists(lib)
            or os.path.getmtime(src) > os.path.getmtime(lib))


def _build(name: str) -> str:
    """Compile ``native/<source>`` into ``library_path(name)`` when missing
    or older than its source; returns the library's path.  Raises with the
    compiler's output on failure."""
    src_name, libs = LIBRARIES[name]
    src = os.path.join(NATIVE_SRC, src_name)
    lib = library_path(name)
    if not os.path.exists(src):
        raise FileNotFoundError(f"native source {src} not found")
    if not _stale(lib, src):
        return lib
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) on PATH")
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(lib + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)   # released when the file closes
        if not _stale(lib, src):           # another process built it
            return lib
        tmp = f"{lib}.{os.getpid()}.tmp"
        try:
            subprocess.run([cxx, *CXXFLAGS, src, "-o", tmp, *LDFLAGS, *libs],
                           check=True, capture_output=True, text=True,
                           timeout=600)
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return lib


def _error_message(e: Exception) -> str:
    """The failure with the compiler's output (``capture_output`` leaves
    ``str(CalledProcessError)`` without it)."""
    msg = str(e)
    stderr = getattr(e, "stderr", None)
    if stderr:
        msg = f"{msg}\n--- compiler output ---\n{stderr.strip()}"
    return msg


def _load(name: str, declare) -> ctypes.CDLL:
    """The loaded library ``name`` (built first where it is missing or
    stale), with its prototypes declared by ``declare(lib)``; raises
    NativeUnavailable."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name in _libs:
            return _libs[name]
        if name in _errors:
            raise NativeUnavailable(_errors[name])
        try:
            lib = ctypes.CDLL(_build(name))
        except Exception as e:  # noqa: BLE001 — no toolchain or shared deps
            _errors[name] = f"lib{name}.so: {_error_message(e)}"
            raise NativeUnavailable(_errors[name]) from e
        declare(lib)
        _libs[name] = lib
        return lib


def _declare_loader(lib: ctypes.CDLL) -> None:
    lib.fl_open.restype = ctypes.c_void_p
    lib.fl_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                            ctypes.c_uint64, ctypes.c_uint64]
    lib.fl_close.restype = None
    lib.fl_close.argtypes = [ctypes.c_void_p]
    lib.fl_gather.restype = None
    lib.fl_gather.argtypes = [ctypes.c_void_p,
                              ctypes.POINTER(ctypes.c_int64),
                              ctypes.c_uint64, ctypes.c_char_p]
    lib.fl_ring_create.restype = ctypes.c_void_p
    lib.fl_ring_create.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                   ctypes.c_uint64, ctypes.c_int]
    lib.fl_ring_submit.restype = None
    lib.fl_ring_submit.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                   ctypes.POINTER(ctypes.c_int64),
                                   ctypes.c_uint64]
    lib.fl_ring_wait.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.fl_ring_wait.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.fl_ring_destroy.restype = None
    lib.fl_ring_destroy.argtypes = [ctypes.c_void_p]


def _declare_decoder(lib: ctypes.CDLL) -> None:
    lib.id_decode_batch.restype = ctypes.c_int64
    lib.id_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8)]


def load_library() -> ctypes.CDLL:
    """The native feature loader (``libfeature_loader.so``)."""
    return _load("feature_loader", _declare_loader)


def load_image_library() -> ctypes.CDLL:
    """The native image decoder (``libimage_decode.so``; links libjpeg and
    libpng, so it fails alone where their headers are missing)."""
    return _load("image_decode", _declare_decoder)


def _npy_data_layout(path: str):
    """(data offset, shape, dtype) of a .npy file, through numpy's public
    format API."""
    with open(path, "rb") as f:
        version = np.lib.format.read_magic(f)
        if version == (1, 0):
            shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
        elif version == (2, 0):
            shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
        else:
            raise ValueError(f"{path}: unsupported .npy format version "
                             f"{version}")
        if fortran:
            raise ValueError(f"{path}: fortran-order npy not supported")
        return f.tell(), shape, dtype


class NativePackedFeatureStore(FeatureSource):
    """Packed shard reader with the native multi-threaded gather and its
    prefetch ring.

    One store serves one consumer: ``get_batch`` is not thread-safe (the
    sequence counter and the ring's slots are recycled in order, and a slot
    is overwritten ``RING_SLOTS`` batches later).  Concurrent consumers open
    a store each; the OS shares the mapped pages."""

    RING_SLOTS = 3

    def __init__(self, shard_dir: str, *, n_threads: int = 4):
        self.lib = load_library()
        self.shard_dir = shard_dir
        with open(os.path.join(shard_dir, "index.json")) as f:
            meta = json.load(f)
        self.index = meta["index"]
        self.dim = int(meta["dim"])
        self.spat = int(meta["spat"])
        self.dtype = np.dtype(meta.get("dtype", "float32"))
        fn = meta.get("feat_norm")
        self.feat_norm = None if fn is None else bool(fn)
        path = os.path.join(shard_dir, "features.npy")
        offset, shape, dtype = _npy_data_layout(path)
        if dtype != self.dtype or shape[1:] != (self.spat, self.dim):
            raise ValueError(f"{path}: layout {shape}/{dtype} disagrees with "
                             f"index.json")
        if self.index:
            # the C++ gather trusts its row indices: a stale index.json
            # pointing past features.npy would read beyond the mapping
            lo, hi = min(self.index.values()), max(self.index.values())
            if hi >= shape[0] or lo < 0:
                raise ValueError(
                    f"{shard_dir}: index.json rows span [{lo}, {hi}] but "
                    f"features.npy has {shape[0]} rows — stale shard")
        self.scales = None
        scales_path = os.path.join(shard_dir, "scales.npy")
        if os.path.exists(scales_path):
            self.scales = np.load(scales_path)
        self.row_bytes = self.spat * self.dim * self.dtype.itemsize
        self.handle = self.lib.fl_open(path.encode(), offset,
                                       self.row_bytes, shape[0])
        if not self.handle:
            raise OSError(f"fl_open failed for {path}")
        self.n_threads = n_threads
        self._ring = None
        self._ring_rows = 0
        self._seq = 0

    def _ensure_ring(self, batch_rows: int) -> None:
        if self._ring is not None and self._ring_rows == batch_rows:
            return
        if self._ring is not None:
            self.lib.fl_ring_destroy(self._ring)
        self._ring = self.lib.fl_ring_create(self.handle, batch_rows,
                                             self.RING_SLOTS, self.n_threads)
        self._ring_rows = batch_rows
        self._seq = 0

    def get_batch(self, names: Sequence[str], datatypes: Sequence[int]
                  ) -> np.ndarray:
        """float32 [B, S, D] of the named rows (int8 shards dequantized).
        Not thread-safe: one consumer a store."""
        rows = np.fromiter((self.index[n] for n in names), np.int64,
                           len(names))
        self._ensure_ring(len(rows))
        rows_p = rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        seq = self._seq
        self._seq += 1
        self.lib.fl_ring_submit(self._ring, seq, rows_p, len(rows))
        ptr = self.lib.fl_ring_wait(self._ring, seq)
        buf = ctypes.cast(ptr, ctypes.POINTER(
            ctypes.c_uint8 * (len(rows) * self.row_bytes))).contents
        arr = np.frombuffer(buf, dtype=self.dtype).reshape(
            len(rows), self.spat, self.dim)
        # a copy: the ring slot is reused RING_SLOTS batches later
        out = arr.astype(np.float32, copy=True)
        if self.scales is not None:
            out *= self.scales[rows][:, None, None]
        return out

    def close(self) -> None:
        if self._ring is not None:
            self.lib.fl_ring_destroy(self._ring)
            self._ring = None
        if self.handle:
            self.lib.fl_close(self.handle)
            self.handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


def decode_image_batch_status(paths: Sequence[str], size: int, *,
                              n_threads: int = 8):
    """JPEG/PNG paths -> (uint8 [N, size, size, 3], ok [N] bool) through the
    C++ pool: decode, Catmull-Rom shorter-side resize (the sampling of the
    JAX package's on-device transforms) and center crop.  Files that fail
    keep ``ok`` False; the others keep their pixels."""
    lib = load_image_library()
    n = len(paths)
    out = np.empty((n, size, size, 3), np.uint8)
    status = np.zeros((n,), np.uint8)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.id_decode_batch(
        arr, n, size, n_threads,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out, status.astype(bool)


def decode_image_batch(paths: Sequence[str], size: int, *,
                       n_threads: int = 8) -> np.ndarray:
    """Like :func:`decode_image_batch_status`, raising on the first file
    that does not decode."""
    out, ok = decode_image_batch_status(paths, size, n_threads=n_threads)
    if not ok.all():
        bad = int(np.argmin(ok))
        raise OSError(f"native decode failed for {paths[bad]!r}")
    return out


def decode_image_bytes(image_bytes: bytes, size: int):
    """One encoded image in memory -> (uint8 [1, size, size, 3], ok), through
    a temporary file (the C++ pool reads paths)."""
    with tempfile.NamedTemporaryFile(suffix=".img") as f:
        f.write(image_bytes)
        f.flush()
        out, ok = decode_image_batch_status([f.name], size, n_threads=1)
    return out, bool(ok[0])
