"""The weights of the from-pixels cells' transformer and VGG16 backbones,
made on the device from the seed in one large draw each.

Both the program and the reference read these trees; neither makes weights
of its own.  The trees are the program's: a tower's ``patch_embed`` (HWIO
convolution and bias), ``pos_embed`` ``[S, D]``, ``blocks`` (``ln1``,
``qkv`` ``[D, 3 D]``, ``proj``, ``ln2``, ``fc1``, ``fc2``; linear weights
``[in, out]``) and ``ln_final``; VGG16's ``{"convs": [{"w": HWIO, "b"}]}``.
"""

from __future__ import annotations

from typing import Dict

import torch

import weights

VGG16_CONVS = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)


def tower_shapes(t) -> Dict:
    """A tower's tree of shapes; ``t``: a mapping with ``image_size``,
    ``patch``, ``dim``, ``depth`` and ``mlp_dim``."""
    D, P, F = t["dim"], t["patch"], t["mlp_dim"]
    S = (t["image_size"] // P) ** 2

    def lin(i, o):
        return {"w": (i, o), "b": (o,)}

    def ln():
        return {"scale": (D,), "offset": (D,)}

    return {"patch_embed": {"w": (P, P, 3, D), "b": (D,)}, "pos_embed": (S, D),
            "blocks": [{"ln1": ln(), "qkv": lin(D, 3 * D), "proj": lin(D, D), "ln2": ln(),
                        "fc1": lin(D, F), "fc2": lin(F, D)} for _ in range(t["depth"])],
            "ln_final": ln()}


def tower(t, gen: torch.Generator, dtype: torch.dtype) -> Dict:
    """A tower in ``dtype`` from one normal draw on ``gen``'s device: each
    linear Glorot-normal (std sqrt(2 / (in + out))), the patch embedding
    He-normal (std sqrt(2 / (P * P * 3))), the position embedding std 0.02,
    the LayerNorms' scales 1; every bias and offset 0."""
    shapes = tower_shapes(t)
    flat = torch.randn(weights.numel(shapes), generator=gen, device=gen.device)
    tree = weights._fill(shapes, flat)
    P = t["patch"]
    tree["patch_embed"]["w"].mul_((2.0 / (P * P * 3)) ** 0.5)
    tree["patch_embed"]["b"].zero_()
    tree["pos_embed"].mul_(0.02)
    layers = [tree["ln_final"]] + [b[k] for b in tree["blocks"] for k in ("ln1", "ln2")]
    for ln in layers:
        ln["scale"].fill_(1.0)
        ln["offset"].zero_()
    for blk in tree["blocks"]:
        for k in ("qkv", "proj", "fc1", "fc2"):
            i, o = blk[k]["w"].shape
            blk[k]["w"].mul_((2.0 / (i + o)) ** 0.5)
            blk[k]["b"].zero_()
    if dtype == torch.float32:
        return tree
    flat_cast = flat.to(dtype)
    del flat
    return weights._fill(shapes, flat_cast)


def vgg16_shapes(widths=VGG16_CONVS) -> Dict:
    convs, c_in = [], 3
    for c in widths:
        convs.append({"w": (3, 3, c_in, c), "b": (c,)})
        c_in = c
    return {"convs": convs}


def vgg16(gen: torch.Generator, dtype: torch.dtype, gain: float, widths=VGG16_CONVS) -> Dict:
    """VGG16 through pool5 in ``dtype`` from one normal draw: He-normal
    convolutions (std sqrt(2 / fan_in)) scaled by ``gain`` each, so that
    pool5 stays near unit scale over the 13 of them; biases 0.  ``widths``:
    the 13 convolutions' output channels, VGG16's unless cut."""
    shapes = vgg16_shapes(widths)
    flat = torch.randn(weights.numel(shapes), generator=gen, device=gen.device)
    tree = weights._fill(shapes, flat)
    for conv in tree["convs"]:
        kh, kw, ci, _ = conv["w"].shape
        conv["w"].mul_(gain * (2.0 / (kh * kw * ci)) ** 0.5)
        conv["b"].zero_()
    if dtype == torch.float32:
        return tree
    flat_cast = flat.to(dtype)
    del flat
    return weights._fill(shapes, flat_cast)
