"""ViT visual backbones in PyTorch: pre-LN Vision Transformers whose patch
tokens [B, S, D] (no class token) are the RAU head's feature map.

Counterpart of ``rau_vqa_tpu/models/backbones/vit.py`` (:26-187), with its
tree and semantics: linear weights ``[in, out]``, the patch convolution in
HWIO, ``pos_embed`` ``[S, D]``; LayerNorm with eps 1e-6 over the biased
variance, the exact (erf) GELU, and attention with a Python-float scale
(``ops/attention.py``: two products around a softmax on the CPU, one fused
op on the card).  The ``ours_vit`` head takes ViT-L/14 at 224 px:
``cnn_dim = 1024``, ``cnn_w = cnn_h = 16``.

``ViTConfig`` also describes SigLIP's towers (Zhai et al. 2023, arXiv
2303.15343): a valid (unpadded) patch convolution whose grid is the floor of
the side over the patch, the tanh GELU, inputs normalised with mean and
deviation 0.5, and an MLP width of its own (``mlp_dim``).
``SIGLIP_SO400M_14_384`` is the shape-optimised so400m/14 tower at 384 px
(Alabdulmohsin et al. 2023, arXiv 2305.13035; the card
``google/siglip-so400m-patch14-384``): 27 blocks of width 1152, 16 heads
of 72, MLP 4304, 27 x 27 = 729 patches; the ``ours_siglip`` head reads its
patch tokens after the post-LayerNorm, without the attention-pooling head.

``vit_from_timm_state`` converts a timm state dict (``blocks.N.attn.qkv``
naming) and ``vit_from_hf_siglip_state`` a Hugging Face SigLIP vision state
dict, each already in memory; nothing is downloaded.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from rau_vqa_tpu_torch.devices import pick_device
from rau_vqa_tpu_torch.models.backbones.resnet import _nchw, remat_block
from rau_vqa_tpu_torch.ops.attention import attention
from rau_vqa_tpu_torch.ops.transforms import IMAGENET_MEAN, IMAGENET_STD
from rau_vqa_tpu_torch.utils.spans import span

# ``ViTConfig.gelu`` -> ``F.gelu``'s ``approximate``
_GELU = {"erf": "none", "tanh": "tanh"}


@dataclass(frozen=True)
class ViTConfig:
    """A ViT tower's shape.  ``mlp_dim`` (0: ``dim * mlp_ratio``) is the MLP
    width; ``gelu`` is ``"erf"`` (exact) or ``"tanh"``; ``mean`` and ``std``
    normalise RGB in [0, 1] per channel; ``valid_patches`` lets a side that
    is not a multiple of the patch drop its last pixels (a valid
    convolution), where otherwise it raises."""
    image_size: int = 224
    patch: int = 14
    dim: int = 1024
    depth: int = 24
    heads: int = 16
    mlp_ratio: float = 4.0
    ln_eps: float = 1e-6
    mlp_dim: int = 0
    gelu: str = "erf"
    mean: Tuple[float, ...] = IMAGENET_MEAN
    std: Tuple[float, ...] = IMAGENET_STD
    valid_patches: bool = False

    def __post_init__(self):
        if self.gelu not in _GELU:
            raise ValueError(f"gelu {self.gelu!r}: one of {sorted(_GELU)}")
        if self.dim % self.heads:
            raise ValueError(f"dim {self.dim} is not a multiple of heads {self.heads}")

    @property
    def grid(self) -> int:
        if self.image_size % self.patch and not self.valid_patches:
            raise ValueError(f"image_size {self.image_size} is not a multiple of "
                             f"patch {self.patch}")
        return self.image_size // self.patch

    @property
    def seq(self) -> int:
        return self.grid * self.grid

    @property
    def mlp(self) -> int:
        """The MLP's hidden width."""
        return self.mlp_dim or int(self.dim * self.mlp_ratio)


VIT_L14 = ViTConfig(image_size=224, patch=14, dim=1024, depth=24, heads=16)
VIT_B16 = ViTConfig(image_size=224, patch=16, dim=768, depth=12, heads=12)
SIGLIP_SO400M_14_384 = ViTConfig(image_size=384, patch=14, dim=1152, depth=27, heads=16,
                                 mlp_dim=4304, gelu="tanh", mean=(0.5, 0.5, 0.5),
                                 std=(0.5, 0.5, 0.5), valid_patches=True)


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
    mlp = cfg.mlp
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
    out = attention(q, k, v).transpose(1, 2).reshape(B, S, D)
    return _linear(out, blk["proj"])


def _block(x, blk, cfg: ViTConfig):
    with span("vit.attention"):
        x = x + _mhsa(_ln(x, blk["ln1"], cfg.ln_eps), blk, cfg.heads)
    with span("vit.mlp"):
        h = F.gelu(_linear(_ln(x, blk["ln2"], cfg.ln_eps), blk["fc1"]),
                   approximate=_GELU[cfg.gelu])
        return x + _linear(h, blk["fc2"])


def vit_apply(params: Dict, cfg: ViTConfig, x: torch.Tensor,
              remat: bool = False) -> torch.Tensor:
    """x [B, H, W, 3] (RGB normalised with ``cfg.mean`` / ``cfg.std``) ->
    patch tokens [B, S, D], in the type of the tree's weights (x is cast to
    it).  ``remat=True`` (fine-tuning) checkpoints each transformer block:
    the backward keeps one [B, S, D] residual a block
    (``rau_vqa_tpu/models/backbones/vit.py:127-142``).  Spans:
    ``vit.patch_embed``, then ``vit.attention`` and ``vit.mlp`` a block,
    then ``vit.final_ln``."""
    pe = params["patch_embed"]
    x = x.to(pe["w"].dtype)
    with span("vit.patch_embed"):
        # the patch embedding: a stride-P convolution without padding (the
        # pixels past the grid's last patch are dropped), its [B, D, g, g]
        # output read row-major over (row, column) as the JAX package's
        # NHWC reshape
        x = F.conv2d(_nchw(x), pe["w"].permute(3, 2, 0, 1), stride=cfg.patch)
        x = x.flatten(2).transpose(1, 2) + pe["b"]
        x = x + params["pos_embed"]
    for blk in params["blocks"]:
        x = remat_block(_block, x, blk, cfg) if remat else _block(x, blk, cfg)
    with span("vit.final_ln"):
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


def vit_from_hf_siglip_state(state: Dict, cfg: ViTConfig) -> Dict:
    """A Hugging Face SigLIP vision state dict already in memory (tensors or
    numpy arrays; ``SiglipVisionModel``'s or ``SiglipModel``'s, whose
    ``vision_model.`` keys it reads) -> the tower's tree.  The separate
    ``q_proj`` / ``k_proj`` / ``v_proj`` become one ``qkv`` ``[D, 3 D]``,
    ``post_layernorm`` the final LayerNorm; the attention-pooling ``head``
    and the text tower are dropped (RAU attends over the patch tokens)."""
    pre = "vision_model." if any(k.startswith("vision_model.") for k in state) else ""

    def t(k):
        return torch.as_tensor(state[pre + k])

    def lin(prefix):
        return {"w": t(f"{prefix}.weight").t().contiguous(), "b": t(f"{prefix}.bias")}

    def ln(prefix):
        return {"scale": t(f"{prefix}.weight"), "offset": t(f"{prefix}.bias")}

    def qkv(prefix):
        parts = [lin(f"{prefix}.{n}_proj") for n in "qkv"]
        return {"w": torch.cat([p["w"] for p in parts], 1).contiguous(),
                "b": torch.cat([p["b"] for p in parts])}

    layer = "encoder.layers.{}."
    return {
        # [D, 3, P, P] convolution -> HWIO
        "patch_embed": {"w": t("embeddings.patch_embedding.weight").permute(2, 3, 1, 0)
                        .contiguous(), "b": t("embeddings.patch_embedding.bias")},
        "pos_embed": t("embeddings.position_embedding.weight").contiguous(),
        "blocks": [{"ln1": ln(layer.format(i) + "layer_norm1"),
                    "qkv": qkv(layer.format(i) + "self_attn"),
                    "proj": lin(layer.format(i) + "self_attn.out_proj"),
                    "ln2": ln(layer.format(i) + "layer_norm2"),
                    "fc1": lin(layer.format(i) + "mlp.fc1"),
                    "fc2": lin(layer.format(i) + "mlp.fc2")}
                   for i in range(cfg.depth)],
        "ln_final": ln("post_layernorm"),
    }
