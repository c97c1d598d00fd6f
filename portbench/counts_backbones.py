"""Frozen operation and byte counts of the from-pixels cells' transformer and
VGG16 backbones, and the least time of a tower's attention: the yardstick
of ``pixels.mfu`` in those cells and of ``vit_attention_roofline``.

Written from the published shapes, beside ``counts.py`` and in its terms:
a multiply-add counts as two operations; bytes count each input read once
and each output written once; the card's peaks are ``counts``'.  ``t`` is
a mapping with a tower's ``image_size``, ``patch``, ``dim``, ``depth`` and
``mlp_dim``.
"""

from __future__ import annotations

import counts

VGG16_CONVS = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)
VGG16_STAGES = (2, 2, 3, 3, 3)


def tower_seq(t) -> int:
    """The patch tokens of a valid patch convolution: the floor grid squared."""
    return (t["image_size"] // t["patch"]) ** 2


def tower_flops(t) -> float:
    """A tower's products an image: the patch embedding (a P x P x 3 -> D
    product a patch), then each block's qkv, output projection and MLP
    (8 D^2 + 4 D F a token) and its two attention products (4 S^2 D)."""
    S, D, P, F = tower_seq(t), t["dim"], t["patch"], t["mlp_dim"]
    block = S * (8.0 * D * D + 4.0 * D * F) + 4.0 * S * S * D
    return 2.0 * S * P * P * 3 * D + t["depth"] * block


def attention_flops(t, B: int) -> float:
    """The two attention products of every layer, ``B`` images."""
    S, D = tower_seq(t), t["dim"]
    return t["depth"] * 4.0 * B * S * S * D


def attention_bytes(t, B: int) -> float:
    """Q, K and V read once and O written once, bf16, every layer."""
    S, D = tower_seq(t), t["dim"]
    return t["depth"] * 4.0 * B * S * D * counts.BF16


def attention_bound_s(t, B: int) -> float:
    """Least seconds of a tower's attention over ``B`` images: each layer
    the larger of its products at the bf16 peak and its Q, K, V and O bytes
    at the memory's rate."""
    per_layer = counts.bound_s(attention_bytes(t, B) / t["depth"],
                               attention_flops(t, B) / t["depth"])
    return t["depth"] * per_layer


def vgg16_flops(size: int, widths=VGG16_CONVS) -> float:
    """VGG16's 13 convolutions (3x3, padding 1) an image at ``size`` px,
    through pool5; ``widths``: their output channels."""
    flops, side, c_in, out = 0.0, size, 3, iter(widths)
    for n in VGG16_STAGES:
        for _ in range(n):
            c = next(out)
            flops += 2.0 * 9 * c_in * c * side * side
            c_in = c
        side //= 2
    return flops
