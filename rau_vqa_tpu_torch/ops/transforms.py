"""Image normalization on the device, [B, H, W, C] float tensors.

Counterpart of the two normalization schemes of
``rau_vqa_tpu/ops/transforms.py`` (:30-71) that the from-pixels path applies
(the loader's, vqa_prepro_loader.lua:55-62, 1061-1067): ImageNet mean/std for
ResNet, BGR * 255 - mean_bgr for VGG.  The other transforms of that module
(resizing, crops, flips, lighting, color jitter) are still to port
(ROADMAP.md, queue 1, item 10).
"""

from __future__ import annotations

import torch

# ImageNet statistics (fb.resnet.torch; vqa_prepro_loader.lua:56-59)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# Caffe-VGG BGR means (vqa_prepro_loader.lua:55)
VGG_MEAN_BGR = (103.939, 116.779, 123.68)


def color_normalize(img: torch.Tensor, mean=IMAGENET_MEAN,
                    std=IMAGENET_STD) -> torch.Tensor:
    """(x - mean) / std per channel (transforms.lua:26-35)."""
    mean = torch.as_tensor(mean, dtype=img.dtype, device=img.device)
    std = torch.as_tensor(std, dtype=img.dtype, device=img.device)
    return (img - mean) / std


def vgg_preprocess(img: torch.Tensor) -> torch.Tensor:
    """RGB [0, 1] -> BGR * 255 - mean_bgr (vqa_prepro_loader.lua:1061-1064)."""
    bgr = img.flip(-1) * 255.0
    return bgr - torch.as_tensor(VGG_MEAN_BGR, dtype=img.dtype, device=img.device)
