"""Multi-head attention of the ViT towers: one fused op on the card, the two
products around a softmax on the CPU.

``attention(q, k, v)`` takes ``[B, heads, S, hd]`` tensors and returns
``softmax(q k^T / sqrt(hd)) v`` in the same layout and type.  For CPU
tensors it runs the two products around a softmax with a Python-float scale
(a bf16 score tensor stays bf16), the JAX package's arithmetic
(``rau_vqa_tpu/models/backbones/vit.py``), bit for bit as the port ran it
before this op.  For CUDA tensors it runs
``torch.nn.functional.scaled_dot_product_attention``, whose flash or cuDNN
kernel keeps each tile of scores on the chip: the ``[B, heads, S, S]``
scores and probabilities are never written to device memory (at SigLIP's
S = 729 and B = 32 they would be 544 MB a layer in bf16).  A head width
that is a multiple of 8 (SigLIP's 72, ViT-L/14's 64) takes the flash path
in bf16.

``KERNEL.launches`` counts the fused calls, one a layer, as the port's
hand-written kernels count theirs; CPU calls are not counted.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


class LibraryOp:
    """The launch counter of an op served by a library kernel: ``launches``
    counts the calls that reached it on the card."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0


KERNEL = LibraryOp("attention")


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The plain version: two products around a softmax, the scores
    materialised, in the operands' type."""
    # a Python-float scale keeps a bf16 score tensor in bf16, as in JAX
    att = torch.softmax((q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1])), dim=-1)
    return att @ v


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd)) v over ``[B, heads, S, hd]`` operands: the
    fused op for CUDA tensors, ``attention_reference`` for CPU tensors."""
    if q.device.type == "cuda":
        KERNEL.launches += 1
        return F.scaled_dot_product_attention(q, k, v, scale=1.0 / math.sqrt(q.shape[-1]))
    if q.device.type != "cpu":
        raise ValueError(f"attention: unsupported device {q.device}")
    return attention_reference(q, k, v)
