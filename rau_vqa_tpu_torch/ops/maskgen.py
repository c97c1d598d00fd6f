"""Counter-hash dropout masks: the plain version and a device check entry.

Counterpart of ``rau_vqa_tpu/ops/maskgen.py``.  The training hop-loop
kernels (``csrc/rau_train_hops_{fwd,bwd}.cu``) regenerate their dropout
masks from ``csrc/maskgen.cuh`` instead of saving them: the murmur3 fmix32
finalizer over each element's global index, salted per (seed, hop, site).
The functions here compute the same bits in plain PyTorch, bit for bit equal
to the JAX package's.

PyTorch has no general uint32 arithmetic, so the plain version works in
int64 and masks to 32 bits after every multiply: a product of two 32-bit
values overflows int64, but its low 32 bits are still right, and masking
before the next right shift keeps that shift logical.

``dropout_mask`` launches ``csrc/maskgen.cu`` for a CUDA seed; it exists so
that the device hash can be held against the plain version bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from rau_vqa_tpu_torch.ops._build import Kernel

_M32 = 0xFFFFFFFF
_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = Kernel("maskgen", "dropout_mask_launch",
                [_P, _P] + [_I] * 5 + [ctypes.c_uint32, ctypes.c_float, _P])


def _u32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64, device=device) & _M32


def _fmix32_(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 in place on ``x``, int64 holding uint32.  A mask hashes
    every element of a hop's [B, S, Dc] features, so each pass counts."""
    x ^= x >> 16
    x.mul_(0x85EBCA6B).bitwise_and_(_M32)
    x ^= x >> 13
    x.mul_(0xC2B2AE35).bitwise_and_(_M32)
    x ^= x >> 16
    return x


def mix32(x) -> torch.Tensor:
    """murmur3 fmix32 on the low 32 bits of ``x`` (int64 holding uint32)."""
    return _fmix32_(_u32(x))


def site_salt(seed, hop: int, site: int) -> torch.Tensor:
    """Per-(seed, hop, site) salt; ``seed`` an int or an integer tensor,
    whose device the salt keeps."""
    h = (int(hop) * 0x9E3779B9) & _M32
    s = ((site + 1) * 0x85EBCA6B) & _M32
    return mix32(_u32(seed) ^ h ^ s)


def mask_threshold(rate: float) -> int:
    """Bits at or above this uint32 keep their element."""
    return min(int(round(rate * 2.0 ** 32)), 2 ** 32 - 1)


def mask_scale(rate: float) -> float:
    """The kept elements' inverted-dropout scale, rounded to float32."""
    return float(np.float32(1.0 / (1.0 - rate)))


# elements a CPU mask hashes at once, so that its passes stay in the cache
_CPU_CHUNK = 1 << 18


def _span(local_shape: Sequence[int], row_offset: int):
    """(the global linear index of a tile's first element, its elements):
    dim 0 is the batch and ``row_offset`` the tile's first global row."""
    acc = 1
    for d in local_shape[1:]:
        acc *= int(d)
    return row_offset * acc, int(local_shape[0]) * acc


def _hash(start: int, n: int, salt: torch.Tensor) -> torch.Tensor:
    """The bits of the global linear indices start .. start + n - 1 (sums and
    products taken mod 2^32 once or after every step agree)."""
    idx = torch.arange(start, start + n, dtype=torch.int64, device=salt.device)
    idx.bitwise_and_(_M32).mul_(2654435761).bitwise_and_(_M32)
    idx ^= salt
    return _fmix32_(idx)


def counter_bits(local_shape: Sequence[int], row_offset: int,
                 salt: torch.Tensor) -> torch.Tensor:
    """Hash bits (int64 holding uint32) for a tile of a global array.  Dim 0
    is the batch and ``row_offset`` the tile's first global row, so the bits
    of an element depend only on its global linear index."""
    return _hash(*_span(local_shape, row_offset), _u32(salt)).reshape(tuple(local_shape))


def dropout_scale_mask(local_shape: Sequence[int], row_offset: int,
                       salt: torch.Tensor, rate: float) -> torch.Tensor:
    """Inverted-dropout scale factors, float32: ``1/(1-rate)`` where the
    element's bits are at or above the threshold, else 0.  On the CPU in
    chunks of ``_CPU_CHUNK`` elements."""
    salt = _u32(salt)
    start, n = _span(local_shape, row_offset)
    out = torch.empty(n, dtype=torch.float32, device=salt.device)
    scale = torch.tensor(mask_scale(rate), device=salt.device)
    zero = torch.zeros((), device=salt.device)
    step = max(n, 1) if salt.device.type != "cpu" else _CPU_CHUNK
    for i in range(0, n, step):
        m = min(step, n - i)
        torch.where(_hash(start + i, m, salt) >= mask_threshold(rate), scale, zero,
                    out=out[i:i + m])
    return out.reshape(tuple(local_shape))


def dropout_mask(seed: torch.Tensor, hop: int, site: int,
                 local_shape: Sequence[int], row_offset: int,
                 rate: float) -> torch.Tensor:
    """The mask of one (seed, hop, site) for a tile of ``local_shape`` from
    global row ``row_offset``.  ``seed`` is an int32 tensor: on the CPU this
    runs the plain version, on CUDA the device hash of ``csrc/maskgen.cuh``."""
    if seed.device.type == "cpu":
        return dropout_scale_mask(local_shape, row_offset,
                                  site_salt(seed, hop, site), rate)
    if seed.device.type != "cuda":
        raise ValueError(f"dropout_mask: unsupported device {seed.device}")
    if seed.dtype != torch.int32 or seed.numel() != 1:
        raise ValueError("dropout_mask: seed must be one int32")
    rows = int(local_shape[0])
    row_len = int(np.prod(local_shape[1:], dtype=np.int64))
    out = torch.empty(*local_shape, device=seed.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(seed.device).cuda_stream
    KERNEL.launch(out.data_ptr(), seed.data_ptr(), hop, site, rows, row_len,
                  row_offset, mask_threshold(rate), mask_scale(rate), stream)
    return out
