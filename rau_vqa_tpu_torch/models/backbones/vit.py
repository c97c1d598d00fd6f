"""ViT visual backbone in PyTorch: a pre-LN Vision Transformer whose patch
tokens [B, S, D] (no class token) are the RAU head's feature map.

Counterpart of ``rau_vqa_tpu/models/backbones/vit.py`` (:26-187), with its
tree and semantics: linear weights ``[in, out]``, the patch convolution in
HWIO, ``pos_embed`` ``[S, D]``; LayerNorm with eps 1e-6 over the biased
variance, the exact (erf) GELU, and attention as two products around a
softmax with a Python-float scale.  The ``ours_vit`` head takes ViT-L/14 at
224 px: ``cnn_dim = 1024``, ``cnn_w = cnn_h = 16``.

``vit_from_timm_state`` converts a timm state dict (``blocks.N.attn.qkv``
naming) that is already in memory; nothing is downloaded.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import torch
import torch.nn.functional as F

from rau_vqa_tpu_torch.devices import pick_device
from rau_vqa_tpu_torch.models.backbones.resnet import _nchw
from rau_vqa_tpu_torch.roadmap import still_to_port

REMAT = still_to_port("remat=True (checkpointing for backbone fine-tuning)", "fine-tuning")


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch: int = 14
    dim: int = 1024
    depth: int = 24
    heads: int = 16
    mlp_ratio: float = 4.0
    ln_eps: float = 1e-6

    @property
    def grid(self) -> int:
        if self.image_size % self.patch:
            raise ValueError(f"image_size {self.image_size} is not a multiple of "
                             f"patch {self.patch}")
        return self.image_size // self.patch

    @property
    def seq(self) -> int:
        return self.grid * self.grid


VIT_L14 = ViTConfig(image_size=224, patch=14, dim=1024, depth=24, heads=16)
VIT_B16 = ViTConfig(image_size=224, patch=16, dim=768, depth=12, heads=12)


def vit_init(generator: torch.Generator, cfg: ViTConfig, dtype=torch.float32,
             device=None) -> Dict:
    """Normal weights at the JAX package's scales (Glorot-normal linears,
    He-normal patch embedding, position embedding 0.02), unit LayerNorms,
    on ``device``: ``cuda`` when None, raising without a card.  Draws differ
    from the JAX package's for the same seed."""
    device = pick_device(device, "vit_init")

    def normal(shape, std):
        w = torch.randn(shape, generator=generator, device=generator.device) * std
        return w.to(dtype).to(device)

    def zeros(d):
        return torch.zeros((d,), dtype=dtype, device=device)

    def linear(d_in, d_out):
        return {"w": normal((d_in, d_out), (2.0 / (d_in + d_out)) ** 0.5), "b": zeros(d_out)}

    def ln(d):
        return {"scale": torch.ones((d,), dtype=dtype, device=device), "offset": zeros(d)}

    D, P = cfg.dim, cfg.patch
    params: Dict = {
        "patch_embed": {"w": normal((P, P, 3, D), (2.0 / (P * P * 3)) ** 0.5), "b": zeros(D)},
        "pos_embed": normal((cfg.seq, D), 0.02),
        "blocks": [],
        "ln_final": ln(D),
    }
    mlp = int(D * cfg.mlp_ratio)
    for _ in range(cfg.depth):
        params["blocks"].append({"ln1": ln(D), "qkv": linear(D, 3 * D),
                                 "proj": linear(D, D), "ln2": ln(D),
                                 "fc1": linear(D, mlp), "fc2": linear(mlp, D)})
    return params


def _ln(x, p, eps):
    return F.layer_norm(x, x.shape[-1:], p["scale"], p["offset"], eps)


def _linear(x, p):
    """x @ w + b with w ``[in, out]``: F.linear on w's transposed view."""
    return F.linear(x, p["w"].t(), p["b"])


def _mhsa(x, blk, heads):
    B, S, D = x.shape
    hd = D // heads
    q, k, v = (t.reshape(B, S, heads, hd).transpose(1, 2)
               for t in _linear(x, blk["qkv"]).chunk(3, dim=-1))
    # a Python-float scale keeps a bf16 score tensor in bf16, as in JAX
    att = torch.softmax((q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(hd)), dim=-1)
    out = (att @ v).transpose(1, 2).reshape(B, S, D)
    return _linear(out, blk["proj"])


def _block(x, blk, cfg: ViTConfig):
    x = x + _mhsa(_ln(x, blk["ln1"], cfg.ln_eps), blk, cfg.heads)
    h = F.gelu(_linear(_ln(x, blk["ln2"], cfg.ln_eps), blk["fc1"]), approximate="none")
    return x + _linear(h, blk["fc2"])


def vit_apply(params: Dict, cfg: ViTConfig, x: torch.Tensor,
              remat: bool = False) -> torch.Tensor:
    """x [B, H, W, 3] (ImageNet-normalized RGB) -> patch tokens [B, S, D],
    in the type of the tree's weights (x is cast to it)."""
    if remat:
        raise NotImplementedError(REMAT)
    B = x.shape[0]
    pe = params["patch_embed"]
    x = x.to(pe["w"].dtype)
    # the patch embedding: a stride-P convolution, its [B, D, g, g] output
    # read row-major over (row, column) as the JAX package's NHWC reshape
    x = F.conv2d(_nchw(x), pe["w"].permute(3, 2, 0, 1), stride=cfg.patch)
    x = x.flatten(2).transpose(1, 2) + pe["b"]
    x = x + params["pos_embed"]
    for blk in params["blocks"]:
        x = _block(x, blk, cfg)
    return _ln(x, params["ln_final"], cfg.ln_eps)


def vit_from_timm_state(state: Dict, cfg: ViTConfig) -> Dict:
    """A timm ViT state dict already in memory (tensors or numpy arrays) ->
    the JAX package's tree.  Drops the class token (RAU attends over the
    patch tokens); the position embedding keeps the patch part."""
    def t(k):
        return torch.as_tensor(state[k])

    def lin(prefix):
        return {"w": t(f"{prefix}.weight").t().contiguous(), "b": t(f"{prefix}.bias")}

    def ln(prefix):
        return {"scale": t(f"{prefix}.weight"), "offset": t(f"{prefix}.bias")}

    pos = t("pos_embed")[0]
    if pos.shape[0] == cfg.seq + 1:   # [class token + patches]
        pos = pos[1:]
    return {
        # timm's [D, 3, P, P] convolution -> HWIO
        "patch_embed": {"w": t("patch_embed.proj.weight").permute(2, 3, 1, 0).contiguous(),
                        "b": t("patch_embed.proj.bias")},
        "pos_embed": pos.contiguous(),
        "blocks": [{"ln1": ln(f"blocks.{i}.norm1"), "qkv": lin(f"blocks.{i}.attn.qkv"),
                    "proj": lin(f"blocks.{i}.attn.proj"), "ln2": ln(f"blocks.{i}.norm2"),
                    "fc1": lin(f"blocks.{i}.mlp.fc1"), "fc2": lin(f"blocks.{i}.mlp.fc2")}
                   for i in range(cfg.depth)],
        "ln_final": ln("norm"),
    }
