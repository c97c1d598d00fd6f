"""ResNet-101 feature extractor (pre-avgpool) in PyTorch, NHWC at every
public function.

Counterpart of ``rau_vqa_tpu/models/backbones/resnet.py``: conv1 7x7/2 ->
maxpool 3x3/2 -> bottleneck stages [3, 4, 23, 3] with strides [1, 2, 2, 2],
batch-norm in inference mode.  448x448 images give the 14x14x2048 features
of the ``ours_resnet`` head.  The parameter tree is the JAX package's: nested
dicts and lists, conv weights HWIO, so ``convert.params_from_jax`` carries a
JAX tree over leaf by leaf.

Convolutions are ``F.conv2d`` on ``channels_last`` views of the NHWC
activations (an NHWC tensor permuted to NCHW is ``channels_last``, so no
copy), with the weights permuted to OIHW once per parameter set.  On a
``fold_batchnorm`` tree ``fused_stages`` sends a stage's run of identity
blocks through ``ops.fused_resnet.fused_identity_stage`` (a CUDA kernel on the
card); the stem, the maxpool and each stage's opening downsample block stay
``F.conv2d``, as they stay XLA in the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from rau_vqa_tpu_torch.convert import MemoRecent
from rau_vqa_tpu_torch.devices import pick_device
from rau_vqa_tpu_torch.ops.fused_resnet import (
    fused_identity_stage, pack_stage_weights, stack_identity_blocks)
from rau_vqa_tpu_torch.roadmap import still_to_port

RESNET101_BLOCKS = (3, 4, 23, 3)
STAGE_WIDTH = (64, 128, 256, 512)   # bottleneck inner widths; out = 4x
BN_EPS = 1e-5

S2D_STEM = still_to_port("the space-to-depth stem", "transforms")
INT8 = still_to_port("the int8 serving mode", "transforms")

_CONVS = ("conv1", "conv2", "conv3", "down")


def _conv_init(gen: torch.Generator, kh, kw, c_in, c_out, dtype, device):
    std = (2.0 / (kh * kw * c_in)) ** 0.5
    w = torch.randn((kh, kw, c_in, c_out), generator=gen, device=gen.device)
    return (w * std).to(dtype).to(device)


def _bn_init(c, dtype, device):
    def full(v):
        return torch.full((c,), v, dtype=dtype, device=device)
    return {"scale": full(1.0), "offset": full(0.0), "mean": full(0.0), "var": full(1.0)}


def resnet101_init(generator: torch.Generator, dtype=torch.float32,
                   device=None) -> Dict:
    """He-normal conv weights and identity BN statistics, on ``device``:
    ``cuda`` when None, raising without a card.  Draws come from
    ``generator`` in a fixed order; they differ from the JAX package's for
    the same seed (carry a JAX tree over with ``convert.params_from_jax``)."""
    device = pick_device(device, "resnet101_init")
    g = generator

    def conv(kh, kw, c_in, c_out):
        return {"w": _conv_init(g, kh, kw, c_in, c_out, dtype, device)}

    params: Dict = {"conv1": conv(7, 7, 3, 64), "bn1": _bn_init(64, dtype, device),
                    "stages": []}
    c_in = 64
    for stage, (n_blocks, width) in enumerate(zip(RESNET101_BLOCKS, STAGE_WIDTH)):
        blocks: List[Dict] = []
        c_out = width * 4
        for b in range(n_blocks):
            blk = {"conv1": conv(1, 1, c_in, width), "bn1": _bn_init(width, dtype, device),
                   "conv2": conv(3, 3, width, width), "bn2": _bn_init(width, dtype, device),
                   "conv3": conv(1, 1, width, c_out), "bn3": _bn_init(c_out, dtype, device)}
            if b == 0:
                blk["down"] = conv(1, 1, c_in, c_out)
                blk["down_bn"] = _bn_init(c_out, dtype, device)
            blocks.append(blk)
            c_in = c_out
        params["stages"].append(blocks)
    return params


# ---------------------------------------------------------------------------
# layers: NHWC activations; "prepared" convs hold OIHW channels_last weights
# ---------------------------------------------------------------------------

def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _prep_conv(p: Dict) -> Dict:
    """HWIO ``w`` (and ``b``) -> OIHW ``channels_last`` for F.conv2d."""
    out = {"w": p["w"].permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)}
    if "b" in p:
        out["b"] = p["b"]
    return out


def _prep_block(blk: Dict) -> Dict:
    return {k: _prep_conv(v) if k in _CONVS else v for k, v in blk.items()}


def _conv_p(x: torch.Tensor, p: Dict, stride: int = 1) -> torch.Tensor:
    """x [B, H, W, C] through a prepared conv, its bias (if any) fused.
    Padding (k-1)//2 on each side, as the JAX package pads: torch-style
    symmetric padding, which for odd k is ``padding=k//2``."""
    w = p["w"]
    pad = ((w.shape[2] - 1) // 2, (w.shape[3] - 1) // 2)
    return _nhwc(F.conv2d(_nchw(x), w, p.get("b"), stride=stride, padding=pad))


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x [B, H, W, C], w HWIO: the JAX package's ``_conv``."""
    return _conv_p(x, _prep_conv({"w": w}), stride)


def _conv_b(x: torch.Tensor, p: Dict, stride: int = 1) -> torch.Tensor:
    """Conv plus bias of a folded conv ``{w, b}``."""
    return _conv_p(x, _prep_conv(p), stride)


def _bn(x: torch.Tensor, p: Dict) -> torch.Tensor:
    inv = torch.rsqrt(p["var"] + BN_EPS) * p["scale"]
    return x * inv + (p["offset"] - p["mean"] * inv)


def _maxpool(x: torch.Tensor) -> torch.Tensor:
    """3x3/2 max over a -inf border of 1: JAX's pad(-inf) then VALID
    reduce_window (resnet.py:228-230)."""
    return _nhwc(F.max_pool2d(_nchw(x), 3, 2, padding=1))


def _block(x: torch.Tensor, blk: Dict, stride: int) -> torch.Tensor:
    """One bottleneck over a prepared block, folded (conv biases) or not
    (conv + BN); the stride sits on the 3x3."""
    if "bn1" in blk:
        y = torch.relu(_bn(_conv_p(x, blk["conv1"]), blk["bn1"]))
        y = torch.relu(_bn(_conv_p(y, blk["conv2"], stride), blk["bn2"]))
        y = _bn(_conv_p(y, blk["conv3"]), blk["bn3"])
        if "down" in blk:
            x = _bn(_conv_p(x, blk["down"], stride), blk["down_bn"])
    else:
        y = torch.relu(_conv_p(x, blk["conv1"]))
        y = torch.relu(_conv_p(y, blk["conv2"], stride))
        y = _conv_p(y, blk["conv3"])
        if "down" in blk:
            x = _conv_p(x, blk["down"], stride)
    return torch.relu(x + y)


def _bottleneck(x: torch.Tensor, blk: Dict, stride: int) -> torch.Tensor:
    """One bottleneck over an HWIO block, conv + BN or folded: the JAX
    package's ``_bottleneck`` and ``_bottleneck_folded``."""
    return _block(x, _prep_block(blk), stride)


def remat_block(fn, x: torch.Tensor, *args) -> torch.Tensor:
    """``fn(x, *args)`` under ``torch.utils.checkpoint``: the backward keeps
    only the inputs and recomputes the rest, the weights' preparation inside
    ``fn`` included (the JAX package's ``jax.checkpoint`` of a block)."""
    return checkpoint(fn, x, *args, use_reentrant=False, preserve_rng_state=False)


_bottleneck_folded = _bottleneck


# ---------------------------------------------------------------------------
# batch-norm folding
# ---------------------------------------------------------------------------

def _fold_conv_bn(conv: Dict, bn: Dict) -> Dict:
    """conv{w} + inference BN -> conv{w * g, offset - mean * g} with
    g = scale / sqrt(var + eps), in float32, cast back to the conv's type."""
    f = {k: v.float() for k, v in bn.items()}
    g = f["scale"] / torch.sqrt(f["var"] + BN_EPS)
    dt = conv["w"].dtype
    return {"w": (conv["w"].float() * g).to(dt), "b": (f["offset"] - f["mean"] * g).to(dt)}


def fold_batchnorm(params: Dict) -> Dict:
    """Fold every inference-mode BN into its preceding conv: the serving
    tree.  ``resnet101_apply`` tells a folded tree by the absence of
    ``bn1``."""
    out: Dict = {"conv1": _fold_conv_bn(params["conv1"], params["bn1"]), "stages": []}
    for blocks in params["stages"]:
        fb = []
        for blk in blocks:
            nb = {k: _fold_conv_bn(blk[k], blk["bn" + k[-1]]) for k in _CONVS[:3]}
            if "down" in blk:
                nb["down"] = _fold_conv_bn(blk["down"], blk["down_bn"])
            fb.append(nb)
        out["stages"].append(fb)
    return out


def space_to_depth_stem(params: Dict) -> Dict:
    raise NotImplementedError(S2D_STEM)


def quantize_resnet(folded: Dict) -> Dict:
    raise NotImplementedError(INT8)


def resnet101_apply_int8(params: Dict, x: torch.Tensor) -> torch.Tensor:
    raise NotImplementedError(INT8)


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------

def _prepare(params: Dict) -> Dict:
    """Per parameter set, filled on first use: the OIHW weights of the blocks
    that run through F.conv2d, and the stacked identity runs of the fused
    stages."""
    return {"conv1": _prep_conv(params["conv1"]), "blocks": {}, "stacks": {}}


_prepared = MemoRecent(_prepare)


def _prepared_block(params: Dict, prep: Dict, stage: int, b: int) -> Dict:
    """Block ``b`` of ``stage`` with OIHW weights, built on first use."""
    if (stage, b) not in prep["blocks"]:
        prep["blocks"][stage, b] = _prep_block(params["stages"][stage][b])
    return prep["blocks"][stage, b]


def _stage_stack(params: Dict, prep: Dict, stage: int) -> Dict:
    """The stacked identity run of ``stage``, built on first use; on the card
    in bf16 with the K-major copies the stage kernel reads
    (``pack_stage_weights``) beside the stack's own keys."""
    if stage not in prep["stacks"]:
        stack = stack_identity_blocks(params["stages"][stage][1:])
        if stack["w1"].is_cuda and stack["w1"].dtype == torch.bfloat16:
            stack.update(pack_stage_weights(stack))
        prep["stacks"][stage] = stack
    return prep["stacks"][stage]


def resnet101_apply(params: Dict, x: torch.Tensor,
                    fused_stages: Tuple[int, ...] = (), fused_block_b: int = 0,
                    remat: bool = False) -> torch.Tensor:
    """x [B, H, W, 3] (ImageNet-normalized RGB) -> pre-avgpool features
    [B, (H/32)*(W/32), 2048].  Takes the plain (conv + BN) tree or a
    ``fold_batchnorm`` tree, in the type its weights have (x is cast to it).

    ``fused_stages`` (folded trees only) runs those stages' identity blocks
    through ``fused_identity_stage``.  ``fused_block_b`` is kept only so
    that calls written for the JAX package run: it must divide B, as there,
    and the CUDA kernel tiles the work its own way.  The OIHW weights are
    prepared once per parameter set (``convert.MemoRecent``), for the blocks
    that run through F.conv2d only; a tree being trained prepares them on
    every call.

    ``remat=True`` (fine-tuning) checkpoints each bottleneck block: the
    backward keeps the block inputs and recomputes the rest, the block's
    weight preparation included (``rau_vqa_tpu/models/backbones/resnet.py:
    232-246``)."""
    folded = "bn1" not in params
    if remat and fused_stages:
        raise ValueError("remat and fused_stages are exclusive (the fused "
                         "stage kernel is a serving path)")
    if fused_stages and not folded:
        raise ValueError("fused_stages requires a fold_batchnorm tree")
    if tuple(params["conv1"]["w"].shape[:3]) == (4, 4, 12):
        raise NotImplementedError(S2D_STEM)
    if fused_stages and fused_block_b and x.shape[0] % fused_block_b:
        raise ValueError(f"fused_block_b {fused_block_b} does not divide "
                         f"batch {x.shape[0]} (use 0 for auto)")
    prep = _prepared(params)
    x = x.to(params["conv1"]["w"].dtype)
    x = _conv_p(x, prep["conv1"], stride=2)
    x = torch.relu(x if folded else _bn(x, params["bn1"]))
    x = _maxpool(x)
    for stage, blocks in enumerate(params["stages"]):
        stride = 2 if stage > 0 else 1
        if stage in fused_stages and len(blocks) > 1:
            x = _block(x, _prepared_block(params, prep, stage, 0), stride)
            x = fused_identity_stage(x.contiguous(), _stage_stack(params, prep, stage),
                                     block_b=fused_block_b or 1)
            continue
        for b in range(len(blocks)):
            s = stride if b == 0 else 1
            if remat:
                x = remat_block(_bottleneck, x, blocks[b], s)
            else:
                x = _block(x, _prepared_block(params, prep, stage, b), s)
    B, h, w, c = x.shape
    return x.reshape(B, h * w, c)


# ---------------------------------------------------------------------------
# torchvision state dicts
# ---------------------------------------------------------------------------

def _t(v) -> torch.Tensor:
    return torch.as_tensor(v)


def _bn_from_torch(state, prefix):
    return {"scale": _t(state[f"{prefix}.weight"]), "offset": _t(state[f"{prefix}.bias"]),
            "mean": _t(state[f"{prefix}.running_mean"]),
            "var": _t(state[f"{prefix}.running_var"])}


def _conv_from_torch(state, key):
    return {"w": _t(state[key]).permute(2, 3, 1, 0).contiguous()}   # OIHW -> HWIO


def resnet_from_torch_state(state: Dict, blocks: Tuple[int, ...] = RESNET101_BLOCKS) -> Dict:
    """A torchvision resnet state dict already in memory (tensors or numpy
    arrays) -> the JAX package's tree.  Nothing is downloaded."""
    params: Dict = {"conv1": _conv_from_torch(state, "conv1.weight"),
                    "bn1": _bn_from_torch(state, "bn1"), "stages": []}
    for stage, n_blocks in enumerate(blocks):
        stage_blocks = []
        for b in range(n_blocks):
            p = f"layer{stage + 1}.{b}"
            blk = {}
            for i in (1, 2, 3):
                blk[f"conv{i}"] = _conv_from_torch(state, f"{p}.conv{i}.weight")
                blk[f"bn{i}"] = _bn_from_torch(state, f"{p}.bn{i}")
            if f"{p}.downsample.0.weight" in state:
                blk["down"] = _conv_from_torch(state, f"{p}.downsample.0.weight")
                blk["down_bn"] = _bn_from_torch(state, f"{p}.downsample.1")
            stage_blocks.append(blk)
        params["stages"].append(stage_blocks)
    return params
