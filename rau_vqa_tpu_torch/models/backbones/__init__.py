"""Image backbones of the from-pixels path.  Ported: ResNet-101; VGG16 and
ViT are still to port (ROADMAP.md, queue 1, item 10)."""

from rau_vqa_tpu_torch.models.backbones.resnet import (  # noqa: F401
    fold_batchnorm,
    resnet101_apply,
    resnet101_init,
    resnet_from_torch_state,
)
