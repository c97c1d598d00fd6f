"""Image backbones of the from-pixels path: ResNet-101, VGG16 through pool5
and the ViT, each with its initialiser, forward and converter of a
torchvision or timm state dict."""

from rau_vqa_tpu_torch.models.backbones.resnet import (  # noqa: F401
    fold_batchnorm,
    resnet101_apply,
    resnet101_init,
    resnet_from_torch_state,
)
from rau_vqa_tpu_torch.models.backbones.vgg import (  # noqa: F401
    VGG16_CFG,
    vgg16_from_torch_state,
    vgg16_pool5_apply,
    vgg16_pool5_init,
)
from rau_vqa_tpu_torch.models.backbones.vit import (  # noqa: F401
    VIT_B16,
    VIT_L14,
    ViTConfig,
    vit_apply,
    vit_from_timm_state,
    vit_init,
)
