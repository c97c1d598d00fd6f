"""Frozen operation and byte counts of the work each cell measures, and the
card's published peaks: the yardstick of every roofline and mfu share.

Copied from ``rau_vqa_tpu_torch/utils/flops.py`` so that a change of the
program cannot move it, with one change: the kernels' weight bytes are
counted from the model's shapes (each weight and bias read once in the type
the kernel reads it), not from the program's packed slabs.

Operations count a multiply-add as two.  Bytes count each input read once
and each output written once.  ``cfg`` is any object with the model's sizes
as attributes (``ModelConfig``'s names and derived properties).
"""

from __future__ import annotations

H100_BF16_FLOPS = 989e12      # dense bf16 tensor-core peak, H100 SXM
H100_BYTES_PER_S = 3.35e12    # HBM3, H100 SXM

BF16, F32 = 2, 4


def bound_s(n_bytes: float, n_ops: float, peak_flops: float = H100_BF16_FLOPS) -> float:
    """The least seconds the card could take: the larger of the bytes over
    the memory rate and the operations over ``peak_flops``."""
    return max(n_bytes / H100_BYTES_PER_S, n_ops / peak_flops)


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
    """The two gated sums over the hops: select_pred and select_att."""
    return 2 * cfg.n_hops * B * (cfg.answer_size + cfg.cnn_spat)


def serve_step_flops(cfg, B: int, tokens: int) -> int:
    """One serving step of ``B`` questions whose encoder runs ``tokens``
    (row, token) steps in all: the encoder, the image embedding, the hop
    loop and the aggregation."""
    return (tokens * lstm_step_flops(cfg) + embed_image_flops(cfg, B)
            + hops_flops(cfg, B) + aggregate_flops(cfg, B))


def lstm_weight_bytes(cfg) -> int:
    """The encoder kernel's weights from the shapes: every layer's wi and wh
    in bf16, and one float32 bias of 4R a layer (bi + bh summed)."""
    E, R, L = cfg.embed_dim, cfg.rnn_size, cfg.rnn_layers
    w = sum(((E if layer == 0 else R) + R) * 4 * R for layer in range(L))
    return w * BF16 + L * 4 * R * F32


def lstm_bound_s(cfg, B: int, T: int, tokens: int) -> float:
    """Least seconds for the encoder: the embedded tokens [B, T, E] float32,
    the lengths and the weights read once, the packed state written once;
    bf16 dots for each row's real tokens only (``tokens`` in all)."""
    E, R, L = cfg.embed_dim, cfg.rnn_size, cfg.rnn_layers
    n_bytes = B * T * E * F32 + B * 4 + lstm_weight_bytes(cfg) + B * 2 * L * R * F32
    return bound_s(n_bytes, lstm_step_flops(cfg) * tokens)


def hop_weight_elements(cfg) -> int:
    """Elements of every weight and bias the hop loop reads: q_proj, h_proj,
    att_q, att_score, att_mem, attprob_proj, the ATTLSTM's layers, merge,
    cls and do_pred."""
    Q, S, M, F = cfg.rnnout_dim, cfg.cnn_spat, cfg.multfeat_dim, cfg.attfeat_dim
    Ra, La, A = cfg.att_rnn_size, cfg.att_rnn_layers, cfg.answer_size
    Rs = cfg.att_state_dim

    def lin(i, o):
        return i * o + o

    lstm = sum(lin(M if layer == 0 else Ra, 4 * Ra) + lin(Ra, 4 * Ra) for layer in range(La))
    return (lin(Q, M) + lin(Rs, M) + lin(M, F) + lin(F, 1) + lin(Rs, S) + lin(S, M)
            + lstm + lin(Rs, M) + lin(M, A) + lin(M, 1))


def hops_bound_s(cfg, B: int) -> float:
    """Least seconds for the hop loop: q (float32), ifeat and iatt (bf16) and
    the bf16 weights read once, the scores, do_pred and attention of every
    hop written once (float32); the dots and the pooling in bf16 terms."""
    Q, S, M, F = cfg.rnnout_dim, cfg.cnn_spat, cfg.multfeat_dim, cfg.attfeat_dim
    A, H = cfg.answer_size, cfg.n_hops
    n_bytes = (B * Q * F32 + B * S * (M + F) * BF16 + hop_weight_elements(cfg) * BF16
               + H * B * (A + 1 + S) * F32)
    return bound_s(n_bytes, hops_flops(cfg, B))


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


def train_step_flops(cfg, B: int, T: int) -> int:
    """One train step on precomputed features of ``B`` questions on a token
    axis of ``T``: the encoder over all ``T`` tokens of every row, each
    hop's forward (its image embedding and classifier included), the select
    aggregate of the metrics, and a backward of twice the forward less what
    nothing needs (do_pred's product, the features' gradient, the zero
    states entering the first hop and the encoder's first token); remat or
    the fused hop loop adds one more hop forward a hop."""
    R, L = cfg.rnn_size, cfg.rnn_layers
    S, Dc, M = cfg.cnn_spat, cfg.cnn_dim, cfg.multfeat_dim
    Ra, H = cfg.att_rnn_size, cfg.n_hops
    hop = train_hop_flops(cfg)[0]
    fwd = B * (T * lstm_step_flops(cfg) + H * hop)
    skipped = B * (L * 2 * 4 * R * R + 2 * (Ra * M + Ra * S + Ra * 4 * Ra))
    skipped += B * H * 2 * S * Dc * M + B * H * 2 * 2 * M
    total = 3 * fwd - skipped
    if H > 1:
        total += 2 * H * B * cfg.answer_size
    if cfg.remat_hops or (cfg.fused_train and cfg.fused_train_bwd != "reference"):
        total += B * H * hop
    return int(total)


# ---------------------------------------------------------------------------
# ResNet-101 from pixels
# ---------------------------------------------------------------------------

RESNET101_BLOCKS = (3, 4, 23, 3)
RESNET_WIDTHS = (64, 128, 256, 512)


def resnet101_flops(size: int, blocks=RESNET101_BLOCKS, widths=RESNET_WIDTHS,
                    stem: int = 64) -> float:
    """The convolutions an image at ``size`` px: the 7x7/2 stem, then each
    bottleneck's 1x1, 3x3 (the stride on it) and 1x1 expand, and each
    stage's downsample (folded BN adds no product)."""
    side = -(-size // 2)
    flops = 2.0 * 49 * 3 * stem * side * side
    side = -(-side // 2)
    c_in = stem
    for stage, (n, w) in enumerate(zip(blocks, widths)):
        for b in range(n):
            stride = 2 if stage > 0 and b == 0 else 1
            out = -(-side // stride)
            flops += 2.0 * c_in * w * side * side
            flops += 2.0 * 9 * w * w * out * out
            flops += 2.0 * w * 4 * w * out * out
            if b == 0:
                flops += 2.0 * c_in * 4 * w * out * out
            side, c_in = out, 4 * w
    return flops


def identity_runs(B: int, size: int, blocks=RESNET101_BLOCKS, widths=RESNET_WIDTHS):
    """(B, H, W, C, Cw, N) of each stage's run of identity blocks, the work
    of one ``fused_identity_stage`` call."""
    side = -(-(-(-size // 2)) // 2)
    runs = []
    for stage, (n, w) in enumerate(zip(blocks, widths)):
        if stage > 0:
            side = -(-side // 2)
        runs.append((B, side, side, 4 * w, w, n - 1))
    return runs


def stage_bound_s(B, H, W, C, Cw, N) -> float:
    """Least seconds for one identity-stage call: x read once, the output
    written once, the stacked bf16 weights read once; the three products of
    each block in bf16 tensor-core terms."""
    n_bytes = 2 * B * H * W * C * BF16 + N * (2 * C * Cw + 9 * Cw * Cw + 2 * Cw + C) * BF16
    n_ops = 2 * B * N * H * W * (2 * C * Cw + 9 * Cw * Cw)
    return bound_s(n_bytes, n_ops)
