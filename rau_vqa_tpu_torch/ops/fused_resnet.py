"""A run of ResNet identity bottlenecks: a CUDA kernel and its plain version.

Counterpart of ``rau_vqa_tpu/ops/fused_resnet.py``.  ``fused_identity_stage``
runs N stacked identity blocks (stride 1, no downsample) over an NHWC
activation: for a CUDA tensor through ``csrc/fused_resnet.cu`` (one launch of
the C entry point, one grid per block, with y1 and y2 kept in shared
memory), for a CPU tensor through ``fused_identity_stage_reference``.  The
weights come as the JAX package's stacked ``[N, ...]`` tree
(``stack_identity_blocks``).  ``KERNEL.launches`` counts one per stage call.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List

import torch
import torch.nn.functional as F

from rau_vqa_tpu_torch.ops._build import Kernel

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = Kernel("fused_resnet", "fused_identity_stage_launch",
                [_P] * 9 + [_I] * 7 + [_P])

_KEYS = ("w1", "b1", "w2", "b2", "w3", "b3")


def stack_identity_blocks(blocks: List[Dict]) -> Dict:
    """Stack a run of folded identity-block trees (no ``down``) into the
    ``[N, ...]`` tree the stage runs over: w1 [N, C, Cw], b1 [N, 1, Cw],
    w2 [N, 9, Cw, Cw] (tap t = 3 dy + dx), b2 [N, 1, Cw], w3 [N, Cw, C],
    b3 [N, 1, C]."""
    assert blocks and all("down" not in b for b in blocks)

    def stack(conv, key, lead):
        # HWIO [kh, kw, ci, co] -> [kh*kw, ci, co] (lead = (9,)) or [ci, co];
        # a bias [co] -> [1, co]
        return torch.stack([b[conv][key].reshape(*lead, *b[conv][key].shape[-2:])
                            if key == "w" else b[conv][key].reshape(1, -1)
                            for b in blocks]).contiguous()

    return {"w1": stack("conv1", "w", ()), "b1": stack("conv1", "b", ()),
            "w2": stack("conv2", "w", (9,)), "b2": stack("conv2", "b", ()),
            "w3": stack("conv3", "w", ()), "b3": stack("conv3", "b", ())}


def pick_block_b(batch: int, want: int) -> int:
    """Largest divisor of ``batch`` that is <= want (>= 1)."""
    b = max(1, min(want, batch))
    while batch % b:
        b -= 1
    return b


def fused_identity_stage_reference(x: torch.Tensor, stack: Dict) -> torch.Tensor:
    """Plain version, float32 torch ops: y1 and y2 and each block's output
    round to ``x.dtype`` where ``_stage_kernel`` rounds them
    (``rau_vqa_tpu/ops/fused_resnet.py:93-95``, ``:113``, ``:119``,
    ``:123-124``); products see operands of that type and sum in float32."""
    dt = x.dtype
    B, H, W, C = x.shape
    N, _, Cw = stack["w1"].shape

    def rnd(v):
        return v.to(dt).float()

    h = x.float()
    for n in range(N):
        w1, b1, w2, b2, w3, b3 = (stack[k][n].float() for k in _KEYS)
        y1 = rnd(torch.relu(h @ w1 + b1[0]))
        # the 3x3 pads y1 with zeros (the JAX plane is zeroed, :79)
        y1p = F.pad(y1, (0, 0, 1, 1, 1, 1))
        acc = b2[0].expand(B, H, W, Cw)
        for t in range(9):
            dy, dx = divmod(t, 3)
            acc = acc + y1p[:, dy:dy + H, dx:dx + W, :] @ w2[t]
        y2 = rnd(torch.relu(acc))
        h = rnd(torch.relu((h + y2 @ w3) + b3[0]))
    return h.to(dt)


def fused_identity_stage(x: torch.Tensor, stack: Dict, *,
                         block_b: int = 2) -> torch.Tensor:
    """Run the N stacked identity blocks of ``stack`` over x [B, H, W, C].

    A CUDA ``x`` launches the kernel (or raises); a CPU ``x`` runs
    ``fused_identity_stage_reference``.  ``block_b`` is the JAX wrapper's
    batch tile; it must divide B, as there, and is otherwise unused: the CUDA
    kernel tiles each image's pixels its own way."""
    B, H, W, C = x.shape
    if B % block_b:
        raise ValueError(f"batch {B} not divisible by block_b {block_b}")
    if x.device.type == "cpu":
        return fused_identity_stage_reference(x, stack)
    if x.device.type != "cuda":
        raise ValueError(f"fused_identity_stage: unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32) or not x.is_contiguous():
        raise ValueError("fused_identity_stage: x must be contiguous bf16 or float32 NHWC")
    N, _, Cw = stack["w1"].shape
    if C % 128 or Cw % 64 or not 64 <= Cw <= 512:
        raise ValueError(f"fused_identity_stage: the kernel takes C % 128 == 0 and Cw in "
                         f"64..512, a multiple of 64; got C={C}, Cw={Cw}")
    want = {"w1": (N, C, Cw), "b1": (N, 1, Cw), "w2": (N, 9, Cw, Cw),
            "b2": (N, 1, Cw), "w3": (N, Cw, C), "b3": (N, 1, C)}
    for k, shape in want.items():
        w = stack[k]
        if (w.dtype != x.dtype or tuple(w.shape) != shape or not w.is_contiguous()
                or w.device != x.device):
            raise ValueError(f"fused_identity_stage: {k} must be contiguous {x.dtype} "
                             f"{shape} on {x.device}")
    out = torch.empty_like(x)
    scratch = torch.empty_like(x) if N > 1 else out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    KERNEL.launch(x.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                  *(stack[k].data_ptr() for k in _KEYS),
                  B, H, W, C, Cw, N, int(x.dtype == torch.bfloat16), stream)
    return out
