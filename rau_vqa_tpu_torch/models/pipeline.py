"""From-pixels VQA: the backbone and the RAU head in one call.

Counterpart of ``rau_vqa_tpu/models/pipeline.py`` (:27-92): uint8 images ->
the backbone's normalization -> VGG16 pool5, ResNet-101, ViT-L/14 or
SigLIP so400m/14 -> [B, S, D] features -> the RAU head.  ``pixels_forward`` is the plain path
(no fused stages, the float32 ``rau_forward`` head); ``answer_pixels`` is the
serving entry point: on the card it sends every ResNet identity run through
the stage kernel (``ops/fused_resnet.py``) and the head of every backbone
through the question-LSTM and hop-loop kernels (``eval.predict.predict_fused``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from rau_vqa_tpu_torch.config import ModelConfig
from rau_vqa_tpu_torch.convert import MemoRecent
from rau_vqa_tpu_torch.devices import pick_device
from rau_vqa_tpu_torch.eval.predict import pack_kernel_weights, predict_fused
from rau_vqa_tpu_torch.models.backbones.resnet import resnet101_apply
from rau_vqa_tpu_torch.models.backbones.vgg import vgg16_pool5_apply
from rau_vqa_tpu_torch.models.backbones.vit import SIGLIP_SO400M_14_384, VIT_L14, vit_apply
from rau_vqa_tpu_torch.models.rau import RAUOutput, rau_forward
from rau_vqa_tpu_torch.ops import transforms as T
from rau_vqa_tpu_torch.utils.spans import span

BACKBONES = ("vgg16", "resnet101", "vit", "siglip")
# each transformer backbone's tower when no ``vit_cfg`` is given, and its name
TOWERS = {"vit": VIT_L14, "siglip": SIGLIP_SO400M_14_384}
TOWER_NAMES = {"vit": "ViT-L/14", "siglip": "SigLIP so400m/14-384"}
SERVING_STAGES = (0, 1, 2, 3)

_head_weights = MemoRecent(pack_kernel_weights)


def extract_features(backbone: str, bb_params: Dict, images_u8: torch.Tensor,
                     vit_cfg=None, fused_stages=(), fused_block_b: int = 0,
                     remat: bool = False, feat_norm: bool = False) -> torch.Tensor:
    """uint8 [B, H, W, 3] RGB -> [B, S, D] features in the backbone's type,
    normalization included (the two schemes of vqa_prepro_loader.lua:1061-1067;
    a transformer takes its config's ``mean`` / ``std``: ImageNet's for
    ViT-L/14, 0.5 for SigLIP).  ``vit_cfg`` defaults to the backbone's
    ``TOWERS`` entry.
    ``fused_stages`` routes those ResNet stages' identity blocks through the
    stage kernel; the other backbones have no stages to fuse and ignore it,
    as in the JAX package.  ``remat=True`` checkpoints the backbone block by
    block (fine-tuning, where the backward runs through here): the same
    values, less activation memory.  ``feat_norm=True`` RMS-normalizes each
    [b, s] cell over D (the JAX package's fine-tuning interface, :62-64)."""
    x = images_u8.float() / 255.0
    if backbone == "vgg16":
        feats = vgg16_pool5_apply(bb_params, T.vgg_preprocess(x), remat=remat)
    elif backbone == "resnet101":
        feats = resnet101_apply(bb_params, T.color_normalize(x),
                                fused_stages=tuple(fused_stages),
                                fused_block_b=fused_block_b, remat=remat)
    elif backbone in TOWERS:
        vc = vit_cfg or TOWERS[backbone]
        feats = vit_apply(bb_params, vc, T.color_normalize(x, vc.mean, vc.std), remat=remat)
    else:
        raise ValueError(f"unknown backbone {backbone!r}; one of {BACKBONES}")
    if feat_norm:
        ms = feats.square().mean(-1, keepdim=True)
        feats = feats * torch.rsqrt(ms + 1e-6)
    return feats


def pixels_forward(params: Dict, bb_params: Dict, cfg: ModelConfig, backbone: str,
                   images_u8: torch.Tensor, tokens: torch.Tensor,
                   lengths: torch.Tensor, *, vit_cfg=None) -> RAUOutput:
    """The plain pixels -> answers forward (eval): the backbone without fused
    stages, then the float32 ``rau_forward`` head."""
    feats = extract_features(backbone, bb_params, images_u8, vit_cfg)
    return rau_forward(params, cfg, tokens, lengths, feats.float(), train=False)


def pixels_tables(params: Dict, bb_params: Dict, cfg: ModelConfig, backbone: str,
                  images_u8, tokens, lengths, *, vit_cfg=None, device=None,
                  feat_norm: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """``answer_pixels``' tables before the argmax: (tab_pred [H+2, B, A],
    tab_att [H+2, B, S]), as ``eval.predict.predict`` gives them; with
    ``feat_norm`` the features RMS-normalized (a fine-tuned head's
    interface).  Spans: ``pipeline.place`` (the inputs to the device),
    ``pipeline.backbone`` (normalization and the backbone), then
    ``predict_fused``'s."""
    device = pick_device(device, "answer_pixels")
    with span("pipeline.place"):
        images_u8 = torch.as_tensor(images_u8, device=device)
        tokens = torch.as_tensor(tokens, device=device)
        lengths = torch.as_tensor(lengths, device=device)
    with torch.no_grad():
        with span("pipeline.backbone"):
            feats = extract_features(backbone, bb_params, images_u8, vit_cfg,
                                     fused_stages=SERVING_STAGES, feat_norm=feat_norm).float()
        return predict_fused(params, _head_weights(params), cfg, tokens, lengths, feats)


def answer_pixels(params: Dict, bb_params: Dict, cfg: ModelConfig, backbone: str,
                  images_u8, tokens, lengths, *, vit_cfg=None, device=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The serving entry point: (oe_answer_ids [H+2, B], attention
    [H+2, B, S]) for the per-hop, "uni" and "select" answer sets.

    Runs on ``device``: ``cuda`` when None, raising without a card; only an
    explicit ``device="cpu"`` runs on the CPU, where the kernels' wrappers
    run their plain versions.  ``params`` and ``bb_params`` (for ResNet-101
    a ``fold_batchnorm`` tree) must already be there; images, tokens and
    lengths may be numpy arrays or tensors.  A ResNet runs every identity
    run in the stage kernel; the features of every backbone reach the head
    as float32.  The head's bf16 kernel weights are cast once per parameter
    set.  A call is the span ``pipeline.answer_pixels``, the argmax
    included."""
    with span("pipeline.answer_pixels"):
        tab_pred, tab_att = pixels_tables(params, bb_params, cfg, backbone, images_u8,
                                          tokens, lengths, vit_cfg=vit_cfg, device=device)
        return tab_pred.argmax(-1), tab_att
