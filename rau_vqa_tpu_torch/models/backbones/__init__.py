"""Image backbones of the from-pixels path: ResNet-101, VGG16 through pool5
and the ViT towers (ViT-L/14, SigLIP so400m/14), each with its initialiser,
forward and converter of a torchvision, timm or Hugging Face state dict;
ResNet-101 also with its space-to-depth stem and its int8 mode."""

from rau_vqa_tpu_torch.models.backbones.resnet import (  # noqa: F401
    fold_batchnorm,
    quantize_resnet,
    resnet101_apply,
    resnet101_apply_int8,
    resnet101_init,
    resnet_from_torch_state,
    space_to_depth_stem,
)
from rau_vqa_tpu_torch.models.backbones.vgg import (  # noqa: F401
    VGG16_CFG,
    vgg16_from_torch_state,
    vgg16_pool5_apply,
    vgg16_pool5_init,
)
from rau_vqa_tpu_torch.models.backbones.vit import (  # noqa: F401
    SIGLIP_SO400M_14_384,
    VIT_B16,
    VIT_L14,
    ViTConfig,
    vit_apply,
    vit_from_hf_siglip_state,
    vit_from_timm_state,
    vit_init,
)
