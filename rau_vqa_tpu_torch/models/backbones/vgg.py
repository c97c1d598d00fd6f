"""VGG16 feature extractor through pool5 in PyTorch, NHWC at every public
function.

Counterpart of ``rau_vqa_tpu/models/backbones/vgg.py`` (:26-104): 13 3x3
convolutions with bias and ReLU in five pool stages, each closed by a 2x2/2
max-pool; 448x448 images give the 14x14x512 pool5 features of the
``ours_ss`` / ``ours_ms`` / ``ours_full`` heads.  Inputs are Caffe-VGG
preprocessed (BGR, 0..255, mean-subtracted: ``ops.transforms.vgg_preprocess``).
The parameter tree is the JAX package's, ``{"convs": [{"w": HWIO, "b"}]}``,
so ``convert.params_from_jax`` carries a JAX tree over leaf by leaf.

Convolutions are ``F.conv2d`` with the bias fused, on ``channels_last`` views
of the NHWC activations, in the tree's type; the OIHW weights are prepared
once per parameter set.  The JAX package runs these convolutions in XLA,
outside any Pallas kernel, so cuDNN serves them on the card.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from rau_vqa_tpu_torch.convert import MemoRecent
from rau_vqa_tpu_torch.devices import pick_device
from rau_vqa_tpu_torch.models.backbones.resnet import _conv_init, _conv_p, _nchw, _nhwc, _prep_conv
from rau_vqa_tpu_torch.roadmap import still_to_port

# channel plan, 'M' = 2x2/2 max-pool (13 conv layers -> pool5)
VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M"]
# torchvision's vgg16 ``features`` indices of the 13 convolutions
TORCH_CONV_INDICES = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
REMAT = still_to_port("remat=True (checkpointing for backbone fine-tuning)", "fine-tuning")


def vgg16_pool5_init(generator: torch.Generator, dtype=torch.float32,
                     device=None) -> Dict:
    """He-normal conv weights and zero biases, on ``device``: ``cuda`` when
    None, raising without a card.  Draws differ from the JAX package's for
    the same seed (carry a JAX tree over with ``convert.params_from_jax``)."""
    device = pick_device(device, "vgg16_pool5_init")
    convs: List[Dict] = []
    c_in = 3
    for v in VGG16_CFG:
        if v == "M":
            continue
        convs.append({"w": _conv_init(generator, 3, 3, c_in, v, dtype, device),
                      "b": torch.zeros((v,), dtype=dtype, device=device)})
        c_in = v
    return {"convs": convs}


_prepared = MemoRecent(lambda params: [_prep_conv(p) for p in params["convs"]])


def vgg16_pool5_apply(params: Dict, x: torch.Tensor, remat: bool = False) -> torch.Tensor:
    """x [B, H, W, 3] (Caffe-BGR preprocessed) -> pool5 features
    [B, (H/32)*(W/32), 512], in the type of the tree's weights (x is cast to
    it)."""
    if remat:
        raise NotImplementedError(REMAT)
    convs = _prepared(params)
    x = x.to(params["convs"][0]["w"].dtype)
    i = 0
    for v in VGG16_CFG:
        if v == "M":
            x = _nhwc(F.max_pool2d(_nchw(x), 2, 2))
        else:
            x = torch.relu(_conv_p(x, convs[i]))
            i += 1
    B, h, w, c = x.shape
    return x.reshape(B, h * w, c)


def vgg16_from_torch_state(state: Dict) -> Dict:
    """A torchvision vgg16 state dict already in memory (``features.{i}``
    weights OIHW, tensors or numpy arrays) -> the JAX package's tree.
    Nothing is downloaded."""
    return {"convs": [
        {"w": torch.as_tensor(state[f"features.{i}.weight"]).permute(2, 3, 1, 0).contiguous(),
         "b": torch.as_tensor(state[f"features.{i}.bias"])}
        for i in TORCH_CONV_INDICES]}
