"""VGG16 through pool5 in plain PyTorch, float32: the reference of the VGG16
from-pixels cell's backbone.

Simonyan & Zisserman 2015 (arXiv 1409.1556), configuration D: 13 3x3
convolutions with bias, padding 1 and ReLU, in five stages of 2, 2, 3, 3
and 3, each closed by a 2x2/2 max-pool; 448 px images give pool5's 14 x 14
x 512.  The inputs are Caffe-VGG preprocessed as the paper's features were
made (vqa_prepro_loader.lua:1061-1064): RGB to BGR, 0..255, less the BGR
means.  The tree is the one the benchmark makes (``weights_backbones.vgg16``):
``{"convs": [{"w": HWIO, "b"}]}``. It imports nothing of the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

VGG_MEAN_BGR = (103.939, 116.779, 123.68)
STAGES = (2, 2, 3, 3, 3)


def preprocess(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [B, H, W, 3] RGB -> float32 [B, 3, H, W] BGR, 0..255 less the
    means."""
    x = images_u8.float().flip(-1) - torch.tensor(VGG_MEAN_BGR, device=images_u8.device)
    return x.permute(0, 3, 1, 2)


def features(params, images_u8: torch.Tensor, rnd=None) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> pool5 as [B, (H/32)(W/32), 512]; ``rnd``
    rounds each convolution's operands first (the control's precision)."""
    x = preprocess(images_u8)
    convs = iter(params["convs"])
    for n in STAGES:
        for _ in range(n):
            p = next(convs)
            w = p["w"].float().permute(3, 2, 0, 1)
            if rnd is not None:
                x, w = rnd(x), rnd(w)
            x = torch.relu(F.conv2d(x, w, p["b"].float(), padding=1))
        x = F.max_pool2d(x, 2, 2)
    B, C, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(B, h * w, C)
