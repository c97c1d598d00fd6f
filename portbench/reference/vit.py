"""SigLIP's vision tower in plain PyTorch, float32: the reference of the
SigLIP from-pixels cell's backbone.

SigLIP so400m/14 at 384 px (Zhai et al. 2023, arXiv 2303.15343; the shape
of Alabdulmohsin et al. 2023, arXiv 2305.13035; the card
``google/siglip-so400m-patch14-384``) as published: inputs (x / 255 - 0.5)
/ 0.5; a valid stride-14 patch convolution with bias (27 x 27 patches, the
last 6 px of each side dropped); learned position embeddings; no class
token; then each block LayerNorm -> multi-head self-attention as two
products around a softmax (scale 1 / sqrt(head width)) with one output
projection -> residual, then LayerNorm -> fc1 -> tanh-GELU -> fc2 ->
residual; LayerNorm eps 1e-6 throughout; then the post-LayerNorm.

Departures from the published model, each the benchmark's: the weights are
random from the seed (``weights_backbones.siglip``), not the trained ones;
the attention-pooling (MAP) head is left out; the head reads the last
block's tokens after the post-LayerNorm (many VLMs read the penultimate
block's). The tree is the one the benchmark makes: patch convolution HWIO,
linear weights ``[in, out]``, q, k and v as one ``qkv`` ``[D, 3 D]`` in that
order. It imports nothing of the program.

Every product goes through ``rnd``-rounded operands where ``rnd`` is given
(the control's lower precision); the softmax, LayerNorms and GELU stay
float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _r(t, rnd):
    return t.float() if rnd is None else rnd(t.float())


def _lin(x, p, rnd):
    return _r(x, rnd) @ _r(p["w"], rnd) + p["b"].float()


def _ln(x, p, eps):
    return F.layer_norm(x, x.shape[-1:], p["scale"].float(), p["offset"].float(), eps)


def normalize(images_u8: torch.Tensor, mean, std) -> torch.Tensor:
    """uint8 [B, H, W, 3] RGB -> float32 [B, 3, H, W], (x / 255 - mean) / std."""
    x = images_u8.float() / 255.0
    mean = torch.tensor(mean, device=x.device)
    std = torch.tensor(std, device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2)


def attention(x, blk, heads: int, rnd=None):
    """Multi-head self-attention of [B, S, D]: scores and probabilities
    materialised, float32."""
    B, S, D = x.shape
    hd = D // heads
    q, k, v = (t.reshape(B, S, heads, hd).transpose(1, 2)
               for t in _lin(x, blk["qkv"], rnd).chunk(3, dim=-1))
    scores = (_r(q, rnd) @ _r(k, rnd).transpose(-1, -2)) / math.sqrt(hd)
    probs = torch.softmax(scores, dim=-1)
    out = (_r(probs, rnd) @ _r(v, rnd)).transpose(1, 2).reshape(B, S, D)
    return _lin(out, blk["proj"], rnd)


def features(params, tower, images_u8: torch.Tensor, rnd=None) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> the patch tokens after the post-LayerNorm,
    [B, grid^2, D].  ``tower``: a mapping with ``patch``, ``heads``,
    ``ln_eps``, ``mean`` and ``std``."""
    P, eps = tower["patch"], tower["ln_eps"]
    x = normalize(images_u8, tower["mean"], tower["std"])
    g = x.shape[-1] // P
    x = x[:, :, :g * P, :g * P]
    # the valid patch convolution as a product over each 14 x 14 x 3 patch
    B = x.shape[0]
    patches = x.reshape(B, 3, g, P, g, P).permute(0, 2, 4, 3, 5, 1).reshape(B, g * g, P * P * 3)
    w = params["patch_embed"]["w"].float().reshape(P * P * 3, -1)     # HWIO -> (h, w, c) rows
    x = _r(patches, rnd) @ _r(w, rnd) + params["patch_embed"]["b"].float()
    x = x + params["pos_embed"].float()
    for blk in params["blocks"]:
        x = x + attention(_ln(x, blk["ln1"], eps), blk, tower["heads"], rnd)
        h = F.gelu(_lin(_ln(x, blk["ln2"], eps), blk["fc1"], rnd), approximate="tanh")
        x = x + _lin(h, blk["fc2"], rnd)
    return _ln(x, params["ln_final"], eps)
