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


def mix32(x) -> torch.Tensor:
    """murmur3 fmix32 on the low 32 bits of ``x`` (int64 holding uint32)."""
    x = _u32(x)
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & _M32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & _M32
    return x ^ (x >> 16)


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


def counter_bits(local_shape: Sequence[int], row_offset: int,
                 salt: torch.Tensor) -> torch.Tensor:
    """Hash bits (int64 holding uint32) for a tile of a global array.  Dim 0
    is the batch and ``row_offset`` the tile's first global row, so the bits
    of an element depend only on its global linear index."""
    salt = _u32(salt)
    dev = salt.device
    acc = 1
    for d in local_shape[1:]:
        acc *= d
    nd = len(local_shape)

    def iota(d):
        view = [1] * nd
        view[d] = local_shape[d]
        return torch.arange(local_shape[d], dtype=torch.int64,
                            device=dev).reshape(view)

    idx = ((iota(0) + row_offset) * acc) & _M32
    stride = acc
    for d in range(1, nd):
        stride //= local_shape[d]
        idx = (idx + iota(d) * stride) & _M32
    idx = idx.expand(*local_shape)
    return mix32(((idx * 2654435761) & _M32) ^ salt)


def dropout_scale_mask(local_shape: Sequence[int], row_offset: int,
                       salt: torch.Tensor, rate: float) -> torch.Tensor:
    """Inverted-dropout scale factors, float32: ``1/(1-rate)`` where the
    element's bits are at or above the threshold, else 0."""
    keep = counter_bits(local_shape, row_offset, salt) >= mask_threshold(rate)
    return torch.where(keep, torch.tensor(mask_scale(rate), device=keep.device),
                       torch.zeros((), device=keep.device))


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
