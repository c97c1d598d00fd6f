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
``F.conv2d``, as they stay XLA in the JAX package.  ``space_to_depth_stem``
rewrites a folded tree's stem; ``quantize_resnet`` and
``resnet101_apply_int8`` are the int8 mode (s8 x s8 -> s32 products on the
card's ``torch._int_mm``).
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

RESNET101_BLOCKS = (3, 4, 23, 3)
STAGE_WIDTH = (64, 128, 256, 512)   # bottleneck inner widths; out = 4x
BN_EPS = 1e-5

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


# ---------------------------------------------------------------------------
# the space-to-depth stem
# ---------------------------------------------------------------------------

def space_to_depth_stem(params: Dict) -> Dict:
    """A folded tree whose conv1 (7x7/2 on 3 channels) is rewritten as the
    exactly equivalent 4x4/1 conv over a 2x2 space-to-depth input (12
    channels), the standard TPU ResNet stem.  The 7 taps pad to 8 (a zero
    at offset -4, the symmetric pad-3 layout); with ky = 2a + dy - 4,
    out(i) = sum_a w8[2a + dy] x[2(i + a - 2) + dy] is a 4-tap stride-1 conv
    over the s2d grid padded (2, 1).  A pure rearrangement, in float32, cast
    back to conv1's type (bit-exact for bf16).  ``resnet101_apply`` knows the
    stem by conv1's 4x4x12 shape."""
    conv1 = params["conv1"]
    if "b" not in conv1 or "bn1" in params:
        raise ValueError("space_to_depth_stem expects a fold_batchnorm tree")
    if tuple(conv1["w"].shape[:3]) != (7, 7, 3):
        raise ValueError(f"the stem transform expects the 7x7x3 conv1, got "
                         f"{tuple(conv1['w'].shape)}")
    w = conv1["w"].float()
    co = w.shape[3]
    w8 = torch.zeros((8, 8, 3, co), dtype=torch.float32, device=w.device)
    w8[1:, 1:] = w                                    # offset -4 row and column: 0
    # [a, dy, b, dx, c, co] -> [a, b, (dy, dx, c), co]: channel dy*6 + dx*3 + c,
    # as _s2d lays the input out
    ws = w8.reshape(4, 2, 4, 2, 3, co).permute(0, 2, 1, 3, 4, 5).reshape(4, 4, 12, co)
    dt = conv1["w"].dtype
    out = dict(params)
    out["conv1"] = {"w": ws.to(dt), "b": conv1["b"].float().to(dt)}
    return out


def _s2d(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, H/2, W/2, 4C], channel (dy, dx, c)."""
    B, H, W, C = x.shape
    if H % 2 or W % 2:
        raise ValueError(f"the space-to-depth stem needs even H and W, got {H}x{W}")
    x = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H // 2, W // 2, 4 * C)


def _stem(x: torch.Tensor, params: Dict, prep: Dict) -> torch.Tensor:
    """conv1 (+ BN) and ReLU: the 7x7/2 conv, or the s2d stem's 4x4/1 conv
    over ``_s2d(x)`` with the asymmetric (2, 1) padding."""
    if "bn1" in params:
        return torch.relu(_bn(_conv_p(x, prep["conv1"], stride=2), params["bn1"]))
    if tuple(params["conv1"]["w"].shape[:3]) == (4, 4, 12):
        xs = F.pad(_nchw(_s2d(x)), (2, 1, 2, 1))
        return torch.relu(_nhwc(F.conv2d(xs, prep["conv1"]["w"], prep["conv1"]["b"])))
    return torch.relu(_conv_p(x, prep["conv1"], stride=2))


# ---------------------------------------------------------------------------
# the int8 mode: weights per output channel, activations per tensor (the
# whole batch), s8 x s8 -> s32 products, the dequantization in the epilogue;
# the residual adds stay float
# ---------------------------------------------------------------------------

def quantize_resnet(folded: Dict) -> Dict:
    """fold_batchnorm tree -> int8 tree: each conv's weights quantized
    symmetrically per output channel (``wq`` int8, ``wscale`` float32 [co],
    the scale max|w| / 127, 1 where a channel is all zero), its bias kept in
    float32.  Bit-equal to the JAX package's numpy quantization."""
    if "bn1" in folded or "w" not in folded["conv1"] or "b" not in folded["conv1"]:
        raise ValueError("quantize_resnet expects a fold_batchnorm tree")

    def q(conv):
        w = conv["w"].float()
        absmax = w.abs().reshape(-1, w.shape[-1]).amax(0)
        scale = torch.where(absmax > 0, absmax / torch.full_like(absmax, 127.0),
                            torch.ones_like(absmax))
        wq = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
        return {"wq": wq, "wscale": scale, "b": conv["b"].float()}

    out: Dict = {"conv1": q(folded["conv1"]), "stages": []}
    for blocks in folded["stages"]:
        out["stages"].append([{k: q(blk[k]) for k in _CONVS if k in blk} for blk in blocks])
    return out


def _int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] x int8 [K, N] -> exact int32 [M, N] by ``torch._int_mm``
    (cuBLASLt's s8 x s8 -> s32 GEMM on the card; it has no float path and
    raises on what it does not take).  The card wants more than 16 rows and
    K and N in multiples of 8, so each is padded with zeros (the stem's K is
    7 * 7 * 3 = 147 -> 152) and the result cut back."""
    M, K = a.shape
    N = b.shape[1]
    pm, pk, pn = max(0, 17 - M), -K % 8, -N % 8
    if pm or pk:
        a = F.pad(a, (0, pk, 0, pm))
    if pk or pn:
        b = F.pad(b, (0, pn, 0, pk))
    return torch._int_mm(a.contiguous(), b.contiguous())[:M, :N]


def _im2col(x: torch.Tensor, kh: int, kw: int, stride: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, Ho, Wo, kh * kw * C] with (k - 1) // 2 of zero
    padding on each side, patches ordered (ky, kx, c) as
    ``wq.reshape(kh * kw * ci, co)``: strided slices of the padded tensor
    (``F.unfold`` takes no int8).  A 1x1 conv needs none."""
    if kh == kw == 1:
        return x[:, ::stride, ::stride]
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    B, H, W, C = x.shape
    Ho, Wo = (H + 2 * ph - kh) // stride + 1, (W + 2 * pw - kw) // stride + 1
    xp = F.pad(x, (0, 0, pw, pw, ph, ph))
    cols = [xp[:, ky:ky + stride * (Ho - 1) + 1:stride, kx:kx + stride * (Wo - 1) + 1:stride]
            for ky in range(kh) for kx in range(kw)]
    return torch.stack(cols, 3).reshape(B, Ho, Wo, kh * kw * C)


def _conv_int8_acc(xq: torch.Tensor, wq: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """The int32 accumulators [B, Ho, Wo, co] of an int8 conv: int8
    activations ``xq`` [B, H, W, ci] against HWIO ``wq``, torch-style
    symmetric padding, exact (the JAX package's ``conv_general_dilated``
    with ``preferred_element_type=int32``)."""
    kh, kw, ci, co = wq.shape
    cols = _im2col(xq, kh, kw, stride)
    B, Ho, Wo, K = cols.shape
    acc = _int8_mm(cols.reshape(B * Ho * Wo, K), wq.reshape(K, co))
    return acc.reshape(B, Ho, Wo, co)


def _quantize_act(x: torch.Tensor):
    """(xq int8, xscale float32 []): x over max|x| / 127 of the WHOLE
    tensor (so an example's codes depend on the batch around it), rounded
    half to even, clipped to +-127.  Both divisions divide by tensors on
    x's device (CUDA's division by a Python number misses by an ulp)."""
    ax = x.abs().amax()
    xscale = torch.clamp(ax / torch.full_like(ax, 127.0), min=1e-8)
    xq = torch.clamp(torch.round(x / xscale), -127, 127).to(torch.int8)
    return xq, xscale


def _conv_int8(x: torch.Tensor, p: Dict, stride: int = 1) -> torch.Tensor:
    """float32 activations -> per-tensor int8 -> s8 x s8 -> s32 conv ->
    ``acc * (xscale * wscale) + b`` in float32."""
    xq, xscale = _quantize_act(x.float())
    acc = _conv_int8_acc(xq, p["wq"], stride)
    return acc.float() * (xscale * p["wscale"]) + p["b"].float()


def _bottleneck_int8(x: torch.Tensor, blk: Dict, stride: int) -> torch.Tensor:
    y = torch.relu(_conv_int8(x, blk["conv1"]))
    y = torch.relu(_conv_int8(y, blk["conv2"], stride))
    y = _conv_int8(y, blk["conv3"])
    if "down" in blk:
        x = _conv_int8(x, blk["down"], stride)
    return torch.relu(x + y)


def resnet101_apply_int8(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """The int8 twin of ``resnet101_apply`` over a ``quantize_resnet`` tree:
    x [B, H, W, 3] (taken as float32) -> [B, (H/32)*(W/32), 2048] float32."""
    x = torch.relu(_conv_int8(x.float(), params["conv1"], stride=2))
    x = _maxpool(x)
    for stage, blocks in enumerate(params["stages"]):
        for b, blk in enumerate(blocks):
            x = _bottleneck_int8(x, blk, 2 if (stage > 0 and b == 0) else 1)
    B, h, w, c = x.shape
    return x.reshape(B, h * w, c)


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
    ``fold_batchnorm`` tree, in the type its weights have (x is cast to it);
    a ``space_to_depth_stem`` tree runs its stem as the 4x4/1 conv over the
    s2d input (H and W even).

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
    if fused_stages and fused_block_b and x.shape[0] % fused_block_b:
        raise ValueError(f"fused_block_b {fused_block_b} does not divide "
                         f"batch {x.shape[0]} (use 0 for auto)")
    prep = _prepared(params)
    x = _maxpool(_stem(x.to(params["conv1"]["w"].dtype), params, prep))
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
