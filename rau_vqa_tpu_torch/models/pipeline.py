"""From-pixels VQA: the backbone and the RAU head in one call.

Counterpart of ``rau_vqa_tpu/models/pipeline.py`` (:27-92) for the ResNet-101
backbone: uint8 images -> ``color_normalize`` -> ResNet-101 -> [B, S, 2048]
features -> the RAU head.  ``pixels_forward`` is the plain path (no fused
stages, the float32 ``rau_forward`` head); ``answer_pixels`` is the serving
entry point: on the card it sends every ResNet identity run through the
stage kernel (``ops/fused_resnet.py``) and the head through the question-LSTM
and hop-loop kernels (``eval.predict.predict_fused``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from rau_vqa_tpu_torch.config import ModelConfig
from rau_vqa_tpu_torch.convert import MemoRecent
from rau_vqa_tpu_torch.devices import pick_device
from rau_vqa_tpu_torch.eval.predict import pack_kernel_weights, predict_fused
from rau_vqa_tpu_torch.models.backbones.resnet import resnet101_apply
from rau_vqa_tpu_torch.models.rau import RAUOutput, rau_forward
from rau_vqa_tpu_torch.ops import transforms as T

OTHER_BACKBONES = ("the {} backbone is still to port (ROADMAP.md, queue 1, "
                   "item 10); the port has resnet101")
SERVING_STAGES = (0, 1, 2, 3)

_head_weights = MemoRecent(pack_kernel_weights)


def extract_features(backbone: str, bb_params: Dict, images_u8: torch.Tensor,
                     fused_stages=(), fused_block_b: int = 0,
                     feat_norm: bool = False) -> torch.Tensor:
    """uint8 [B, H, W, 3] RGB -> [B, S, D] features in the backbone's type,
    normalization included.  ``fused_stages`` routes those ResNet stages'
    identity blocks through the stage kernel.  ``feat_norm=True``
    RMS-normalizes each [b, s] cell over D (the fine-tuning interface of the
    JAX package, :62-64)."""
    x = images_u8.float() / 255.0
    if backbone == "resnet101":
        feats = resnet101_apply(bb_params, T.color_normalize(x),
                                fused_stages=tuple(fused_stages),
                                fused_block_b=fused_block_b)
    elif backbone in ("vgg16", "vit"):
        raise NotImplementedError(OTHER_BACKBONES.format(backbone))
    else:
        raise ValueError(f"unknown backbone {backbone!r}")
    if feat_norm:
        ms = feats.square().mean(-1, keepdim=True)
        feats = feats * torch.rsqrt(ms + 1e-6)
    return feats


def pixels_forward(params: Dict, bb_params: Dict, cfg: ModelConfig, backbone: str,
                   images_u8: torch.Tensor, tokens: torch.Tensor,
                   lengths: torch.Tensor) -> RAUOutput:
    """The plain pixels -> answers forward (eval): the backbone without fused
    stages, then the float32 ``rau_forward`` head."""
    feats = extract_features(backbone, bb_params, images_u8)
    return rau_forward(params, cfg, tokens, lengths, feats.float(), train=False)


def answer_pixels(params: Dict, bb_params: Dict, cfg: ModelConfig, backbone: str,
                  images_u8, tokens, lengths, *, device=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The serving entry point: (oe_answer_ids [H+2, B], attention
    [H+2, B, S]) for the per-hop, "uni" and "select" answer sets.

    Runs on ``device``: ``cuda`` when None, raising without a card; only an
    explicit ``device="cpu"`` runs on the CPU, where the kernels' wrappers
    run their plain versions.  ``params`` and ``bb_params`` (a
    ``fold_batchnorm`` tree) must already be there; images, tokens and
    lengths may be numpy arrays or tensors.  The backbone runs with every
    identity run in the stage kernel; its features reach the head as
    float32.  The head's bf16 kernel weights are cast once per parameter
    set."""
    device = pick_device(device, "answer_pixels")
    images_u8 = torch.as_tensor(images_u8, device=device)
    tokens = torch.as_tensor(tokens, device=device)
    lengths = torch.as_tensor(lengths, device=device)
    with torch.no_grad():
        feats = extract_features(backbone, bb_params, images_u8,
                                 fused_stages=SERVING_STAGES).float()
        tab_pred, tab_att = predict_fused(params, _head_weights(params), cfg,
                                          tokens, lengths, feats)
    return tab_pred.argmax(-1), tab_att
