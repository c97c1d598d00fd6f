"""The weights every cell serves or trains, made on the device from the seed
in a few large draws: one for the RAU head, one for ResNet-101.

Both the program and the reference read these trees; neither makes weights
of its own.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def _lin(d_in: int, d_out: int):
    return {"w": (d_in, d_out), "b": (d_out,)}


def _lstm(d_in: int, R: int, layers: int):
    out = []
    for layer in range(layers):
        out.append({"wi": ((d_in if layer == 0 else R), 4 * R), "bi": (4 * R,),
                    "wh": (R, 4 * R), "bh": (4 * R,)})
    return {"layers": out}


def rau_head_shapes(s) -> Dict:
    """The head's tree of shapes (``s``: the configuration's sizes): groups
    ``embed`` / ``rnn`` / ``mult``, weights ``[in, out]``."""
    M, S = s.multfeat_dim, s.cnn_spat
    return {
        "embed": {"lookup": (s.vocab_size, s.embed_dim)},
        "rnn": _lstm(s.embed_dim, s.rnn_size, s.rnn_layers),
        "mult": {
            "q_proj": _lin(s.rnnout_dim, M),
            "h_proj": _lin(s.att_state_dim, M),
            "i_embed": _lin(s.cnn_dim, M),
            "att_q": _lin(M, s.attfeat_dim),
            "att_i": _lin(M, s.attfeat_dim),
            "att_score": _lin(s.attfeat_dim, 1),
            "att_mem": _lin(s.att_state_dim, S),
            "attprob_proj": _lin(S, M),
            "attlstm": _lstm(M, s.att_rnn_size, s.att_rnn_layers),
            "merge": _lin(s.att_state_dim, M),
            "cls": _lin(M, s.answer_size),
            "do_pred": _lin(M, 1),
        },
    }


def _leaves(tree, path=()) -> List[Tuple[tuple, tuple]]:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k], path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _leaves(v, path + (i,))]
    return [(path, tree)]


def _fill(shapes, flat: torch.Tensor):
    """The tree of ``shapes`` as consecutive views of ``flat``."""
    pos = [0]

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        n = 1
        for d in t:
            n *= d
        v = flat[pos[0]:pos[0] + n].view(t)
        pos[0] += n
        return v

    return walk(shapes)


def numel(shapes) -> int:
    total = 0
    for _, shape in _leaves(shapes):
        n = 1
        for d in shape:
            n *= d
        total += n
    return total


def rau_head(s, gen: torch.Generator, scale: float) -> Dict:
    """Every weight and bias uniform in (-scale, scale), as the Torch
    reference initializes them (:349-355), float32, in one draw on
    ``gen``'s device."""
    shapes = rau_head_shapes(s)
    flat = torch.rand(numel(shapes), generator=gen, device=gen.device)
    return _fill(shapes, flat.mul_(2.0 * scale).sub_(scale))


def resnet101_shapes(blocks=(3, 4, 23, 3), widths=(64, 128, 256, 512)) -> Dict:
    """The folded ResNet-101's tree of shapes: HWIO conv weights and a bias
    each (batch norm folded in)."""
    def conv(k, ci, co):
        return {"w": (k, k, ci, co), "b": (co,)}

    tree = {"conv1": conv(7, 3, 64), "stages": []}
    c_in = 64
    for n, w in zip(blocks, widths):
        stage = []
        for b in range(n):
            blk = {"conv1": conv(1, c_in, w), "conv2": conv(3, w, w), "conv3": conv(1, w, 4 * w)}
            if b == 0:
                blk["down"] = conv(1, c_in, 4 * w)
            stage.append(blk)
            c_in = 4 * w
        tree["stages"].append(stage)
    return tree


def resnet101_folded(gen: torch.Generator, dtype: torch.dtype, residual_gain: float,
                     bias_std: float) -> Dict:
    """A folded ResNet-101 in ``dtype``: one normal draw for every weight and
    bias, then each conv's weights scaled to He-normal (std sqrt(2 / fan_in),
    what a ReLU needs to keep its input's scale), the last conv of every
    residual branch further by ``residual_gain`` and each downsample by
    sqrt(1/2), so that the residual stream keeps the scale of a trained
    network's instead of doubling at each block; biases normal with
    ``bias_std``."""
    shapes = resnet101_shapes()
    flat = torch.randn(numel(shapes), generator=gen, device=gen.device)
    tree = _fill(shapes, flat)

    def scale(conv, gain):
        kh, kw, ci, _ = conv["w"].shape
        conv["w"].mul_(gain * (2.0 / (kh * kw * ci)) ** 0.5)
        conv["b"].mul_(bias_std)

    scale(tree["conv1"], 1.0)
    for stage in tree["stages"]:
        for blk in stage:
            scale(blk["conv1"], 1.0)
            scale(blk["conv2"], 1.0)
            scale(blk["conv3"], residual_gain)
            if "down" in blk:
                scale(blk["down"], 0.5 ** 0.5)
    if dtype == torch.float32:
        return tree
    flat_cast = flat.to(dtype)
    del flat
    return _fill(shapes, flat_cast)
