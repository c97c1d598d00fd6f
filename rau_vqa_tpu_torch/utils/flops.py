"""The analytic operation and byte counts of the port's work, and the card's
published peaks: one count that ``chip_smoke.py``'s bounds and the benches'
``mfu`` share.

Operations count each multiply-add of a product as two (the convention of
``torch.utils.flop_counter``, which ``tests/test_torch_port_flops.py`` holds
these counts to on the plain versions).  Bytes count each input read once and
each output written once.  Where the work depends on the data (the encoder
stops at each question's last token), the caller passes what this batch's
data needs.
"""

from __future__ import annotations

H100_BF16_FLOPS = 989e12      # dense bf16 tensor-core peak, H100 SXM
H100_F32_FLOPS = 67e12        # float32 outside the tensor cores, H100 SXM
H100_BYTES_PER_S = 3.35e12    # HBM3, H100 SXM
H100_INT32_OPS = 33.5e12      # 64 int32 lanes a SM a clock, half the f32 rate


def nbytes(tree) -> int:
    """Bytes of every tensor in a tree of dicts and lists."""
    if isinstance(tree, dict):
        return sum(nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(nbytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def bound(n_bytes: float, n_ops: float, peak_flops: float):
    """(the least ms the card could take, "bytes" or "operations"): the
    larger of the bytes over the memory rate and the operations over
    ``peak_flops``."""
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# the serving step
# ---------------------------------------------------------------------------

def lstm_step_flops(cfg) -> int:
    """One row's one token through the question LSTM: each layer's
    [x; h] @ [wi; wh] into the four gates."""
    E, R, L = cfg.embed_dim, cfg.rnn_size, cfg.rnn_layers
    return 2 * 4 * R * (E + R) + (L - 1) * 2 * 4 * R * (R + R)


def embed_image_flops(cfg, B: int) -> int:
    """``embed_image``: feats @ i_embed, then ifeat @ att_i, a row."""
    S, Dc, M, F = cfg.cnn_spat, cfg.cnn_dim, cfg.multfeat_dim, cfg.attfeat_dim
    return 2 * B * S * (Dc * M + M * F)


def hop_flops(cfg) -> int:
    """One row's one answering unit: h_proj, att_q, the attention score,
    att_mem, the pooling, attprob_proj, the ATTLSTM's two products, merge,
    the classifier and do_pred."""
    S, M, F = cfg.cnn_spat, cfg.multfeat_dim, cfg.attfeat_dim
    R, A = cfg.att_rnn_size, cfg.answer_size
    return 2 * (R * M + M * F + S * F + R * S + S * M + S * M
                + M * 4 * R + R * 4 * R + R * M + M * A + M)


def hops_flops(cfg, B: int) -> int:
    """The hop loop: the hop-invariant question projection, then every hop."""
    return B * (2 * cfg.rnnout_dim * cfg.multfeat_dim + cfg.n_hops * hop_flops(cfg))


def aggregate_flops(cfg, B: int) -> int:
    """``_aggregate``'s two gated sums over the hops: select_pred and
    select_att."""
    return 2 * cfg.n_hops * B * (cfg.answer_size + cfg.cnn_spat)


def serve_step_flops(cfg, B: int, tokens: int) -> int:
    """One serving step of ``B`` questions whose encoder runs ``tokens``
    (row, token) steps in all: the encoder, the image embedding, the hop
    loop and the aggregation."""
    return (tokens * lstm_step_flops(cfg) + embed_image_flops(cfg, B)
            + hops_flops(cfg, B) + aggregate_flops(cfg, B))


def lstm_bound(cfg, enc, lengths, T):
    """Least time for the encoder: inputs (emb, lengths, the kernel's weight
    slabs and biases) read once, output written once; bf16 dots for each
    row's real tokens only."""
    B, E, R, L = lengths.shape[0], cfg.embed_dim, cfg.rnn_size, cfg.rnn_layers
    n_bytes = (B * T * E * 4 + B * 4 + nbytes(enc["slabs"]) + nbytes(enc["bias"])
               + B * 2 * L * R * 4)
    n_ops = lstm_step_flops(cfg) * int(lengths.long().sum())
    return bound(n_bytes, n_ops, H100_BF16_FLOPS)


def hops_bound(cfg, hw, B):
    """Least time for the hop loop: q, ifeat, iatt and the weights read once,
    the three outputs written once; the dots and the pooling in bf16 terms."""
    Q, S, M, F = cfg.rnnout_dim, cfg.cnn_spat, cfg.multfeat_dim, cfg.attfeat_dim
    A, H = cfg.answer_size, cfg.n_hops
    n_bytes = (B * Q * 4 + B * S * (M + F) * 2 + nbytes(hw)
               + H * B * (A + 1 + S) * 4)
    return bound(n_bytes, hops_flops(cfg, B), H100_BF16_FLOPS)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def train_hop_flops(cfg):
    """Multiply-adds x 2 of one training hop's forward for one row (the
    classifier included), and of its backward without the remat."""
    Q, S, Dc, M, F = cfg.rnnout_dim, cfg.cnn_spat, cfg.cnn_dim, cfg.multfeat_dim, cfg.attfeat_dim
    R, A = cfg.att_rnn_size, cfg.answer_size
    fwd = 2 * (Q * M + R * M + S * Dc * M + S * M * F + M * F + S * F + R * S
               + S * M + S * M + M * 4 * R + R * 4 * R + R * M + M * A + M)
    bwd = 2 * (M * R + 4 * R * M + 4 * R * R + M * S + S * M + S * R + S * F
               + F * M + M * R + M * S * F + S * F * M + S * Dc * M)
    return fwd, bwd


def train_step_flops(cfg, B: int, T: int, *, backbone=None, size: int = 0,
                     n_images: int = 0, train_backbone: bool = False,
                     backbone_remat: bool = False, vit_cfg=None) -> int:
    """One train step of ``B`` questions on a token axis of ``T``: the
    products its forward and backward run, as ``make_train_step`` computes
    them (``grad_accum`` splits the rows and changes nothing here).

    The forward: the encoder over all ``T`` tokens of every row, then each
    hop's ``train_hop_flops`` forward, which holds its image embedding (a
    training hop re-embeds the features under its own masks) and the
    classifier; the metrics add the select aggregate over the hops
    (``select_aggregate``'s product, none at one hop).  The backward takes
    twice the forward, less what nothing needs: ``do_pred``'s product (no
    loss term reads it, reference :565-567), and the input gradients of the
    features (they require no grad unless the backbone is trained), of the
    zero states entering the first hop and of the encoder's first token.
    ``cfg.remat_hops`` adds one more hop forward
    a hop; so does the fused hop loop, whose backward rematerializes each
    hop from its carries (the ``"kernel"`` and ``"xla"`` backwards; the
    ``"reference"`` one is plain autograd).

    ``backbone`` with ``n_images`` images at ``size`` px: frozen (the
    ``pixels`` bench) adds their forward; ``train_backbone`` adds forward and
    backward, less the first layer's input gradient (the pixels require no
    grad), and ``backbone_remat`` one more forward of every checkpointed
    block (VGG16's stem is inside its first checkpointed stage, ResNet's and
    the ViT's patch embedding are not) as far as ``torch.utils.checkpoint``
    recomputes it: it stops at the last tensor the backward saved, which in
    a ViT block is the MLP's hidden activation, so its ``fc2`` product runs
    once (a ResNet block ends on a ReLU and a VGG16 stage on a max-pool,
    whose saved tensors are the block's last)."""
    E, R, L = cfg.embed_dim, cfg.rnn_size, cfg.rnn_layers
    S, Dc, M = cfg.cnn_spat, cfg.cnn_dim, cfg.multfeat_dim
    Ra, H = cfg.att_rnn_size, cfg.n_hops
    enc = T * lstm_step_flops(cfg)
    hop = train_hop_flops(cfg)[0]
    fwd = B * (enc + H * hop)
    skipped = B * (L * 2 * 4 * R * R                       # the encoder's h at t = 0
                   + 2 * (Ra * M + Ra * cfg.cnn_spat + Ra * 4 * Ra))   # the first hop's h
    feats_grad = train_backbone and backbone is not None
    if not feats_grad:
        skipped += B * H * 2 * S * Dc * M
    skipped += B * H * 2 * 2 * M                          # do_pred's dX and dW
    total = 3 * fwd - skipped
    if H > 1:
        total += 2 * H * B * cfg.answer_size               # the metrics' select_pred
    if cfg.remat_hops or (cfg.fused_train and cfg.fused_train_bwd != "reference"):
        total += B * H * hop
    if backbone is not None and n_images:
        per = backbone_flops(backbone, size, vit_cfg)
        stem = backbone_stem_flops(backbone, size, vit_cfg)
        if not train_backbone:
            total += n_images * per
        else:
            total += n_images * (3 * per - stem)
            if backbone_remat:
                total += n_images * (per - (0 if backbone == "vgg16" else stem))
                if backbone == "vit":
                    total -= n_images * vit_fc2_flops(vit_cfg)
    return int(total)


# ---------------------------------------------------------------------------
# backbones
# ---------------------------------------------------------------------------

def stage_bound(B, H, W, C, Cw, N):
    """Least time for one identity-stage call: x read once, the output
    written once, the stacked bf16 weights read once; the three products of
    each block in bf16 tensor-core terms."""
    n_bytes = 2 * B * H * W * C * 2 + N * (2 * C * Cw + 9 * Cw * Cw + 2 * Cw + C) * 2
    n_ops = 2 * B * N * H * W * (2 * C * Cw + 9 * Cw * Cw)
    return bound(n_bytes, n_ops, H100_BF16_FLOPS)


def resnet101_flops(size: int, blocks=(3, 4, 23, 3), widths=(64, 128, 256, 512),
                    stem: int = 64) -> float:
    """A ResNet's convolutions an image at ``size`` px: the 7x7/2 stem, then
    each bottleneck's 1x1, 3x3 (the stride on it) and 1x1 expand, and each
    stage's downsample; 2 x kh x kw x C_in x C_out a pixel of each output
    map (folded BN adds no product)."""
    side = -(-size // 2)                       # the stem's output
    flops = 2.0 * 49 * 3 * stem * side * side
    side = -(-side // 2)                       # the max-pool's
    c_in = stem
    for stage, (n, w) in enumerate(zip(blocks, widths)):
        for b in range(n):
            stride = 2 if stage > 0 and b == 0 else 1
            out = -(-side // stride)
            flops += 2.0 * c_in * w * side * side      # 1x1 reduce at the input side
            flops += 2.0 * 9 * w * w * out * out       # 3x3, strided
            flops += 2.0 * w * 4 * w * out * out       # 1x1 expand
            if b == 0:
                flops += 2.0 * c_in * 4 * w * out * out    # downsample
            side, c_in = out, 4 * w
    return flops


def vgg_flops(size: int) -> float:
    """VGG16's 13 convolutions at ``size`` px: 2 x 9 x C_in x C_out a pixel
    of each conv's output map, an image."""
    from rau_vqa_tpu_torch.models.backbones.vgg import VGG16_CFG
    flops, c_in, side = 0.0, 3, size
    for v in VGG16_CFG:
        if v == "M":
            side //= 2
        else:
            flops += 2.0 * 9 * c_in * v * side * side
            c_in = v
    return flops


def vit_flops(cfg) -> float:
    """A ViT's products an image: the patch embedding, then each block's qkv,
    the two attention products, the projection and the two MLP layers."""
    S, D, P = cfg.seq, cfg.dim, cfg.patch
    M = cfg.mlp
    block = 2.0 * S * D * (3 * D + D + 2 * M) + 2 * 2.0 * S * S * D
    return 2.0 * S * P * P * 3 * D + cfg.depth * block


def vit_fc2_flops(cfg=None) -> float:
    """The MLP's second product over every block of a ViT an image (ViT-L/14
    when None): what block remat does not recompute."""
    from rau_vqa_tpu_torch.models.backbones.vit import VIT_L14
    cfg = cfg or VIT_L14
    return cfg.depth * 2.0 * cfg.seq * cfg.mlp * cfg.dim


def backbone_stem_flops(backbone: str, size: int, vit_cfg=None) -> float:
    """The named backbone's first layer an image at ``size`` px (the one whose
    input, the pixels, needs no gradient): VGG16's first 3x3 convolution,
    ResNet's 7x7/2 stem, the ViT's patch embedding."""
    if backbone == "resnet101":
        side = -(-size // 2)
        return 2.0 * 49 * 3 * 64 * side * side
    if backbone == "vgg16":
        from rau_vqa_tpu_torch.models.backbones.vgg import VGG16_CFG
        return 2.0 * 9 * 3 * VGG16_CFG[0] * size * size
    if backbone == "vit":
        from rau_vqa_tpu_torch.models.backbones.vit import VIT_L14
        cfg = vit_cfg or VIT_L14
        return 2.0 * cfg.seq * cfg.patch * cfg.patch * 3 * cfg.dim
    raise ValueError(f"unknown backbone {backbone!r}")


def backbone_flops(backbone: str, size: int, vit_cfg=None) -> float:
    """The named backbone's products an image at ``size`` px."""
    if backbone == "resnet101":
        return resnet101_flops(size)
    if backbone == "vgg16":
        return vgg_flops(size)
    if backbone == "vit":
        from rau_vqa_tpu_torch.models.backbones.vit import VIT_L14
        return vit_flops(vit_cfg or VIT_L14)
    raise ValueError(f"unknown backbone {backbone!r}")
