"""ResNet-101's forward in plain PyTorch, float32: the reference of the
from-pixels cell's backbone.

He et al. 2016 (arXiv 1512.03385), bottleneck stages of 3 / 4 / 23 / 3
blocks, widths 64-512 expanded 4x, the stride on each opening block's 3x3,
inference batch norm folded into each convolution's weights and bias (the
tree ``weights.resnet101_folded`` makes: HWIO weights, a bias each).  The
image normalization is the ImageNet mean and deviation the Torch reference
applies (transforms.lua:26-35).  It imports nothing of the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [B, H, W, 3] RGB -> float32 [B, 3, H, W], (x / 255 - mean) / std."""
    x = images_u8.float() / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2)


def conv(x: torch.Tensor, p, stride: int = 1, rnd=None) -> torch.Tensor:
    """NCHW float32 through an HWIO conv with bias, (k - 1) // 2 padding;
    ``rnd`` rounds both operands first (the control's lower precision)."""
    w = p["w"].float().permute(3, 2, 0, 1)
    if rnd is not None:
        x, w = rnd(x), rnd(w)
    k = w.shape[-1]
    return F.conv2d(x, w, p["b"].float(), stride=stride, padding=(k - 1) // 2)


def bottleneck(x, blk, stride: int, rnd=None):
    y = torch.relu(conv(x, blk["conv1"], rnd=rnd))
    y = torch.relu(conv(y, blk["conv2"], stride, rnd))
    y = conv(y, blk["conv3"], rnd=rnd)
    if "down" in blk:
        x = conv(x, blk["down"], stride, rnd)
    return torch.relu(x + y)


def features(params, images_u8: torch.Tensor, rnd=None) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> the last stage's map as [B, (H/32)(W/32), 2048]."""
    x = torch.relu(conv(normalize(images_u8), params["conv1"], 2, rnd))
    x = F.max_pool2d(x, 3, 2, padding=1)
    for stage, blocks in enumerate(params["stages"]):
        for b, blk in enumerate(blocks):
            x = bottleneck(x, blk, 2 if stage > 0 and b == 0 else 1, rnd)
    B, C, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(B, h * w, C)
