"""The RAU (Recurrent Answering Units) VQA model in PyTorch.

Counterpart of ``rau_vqa_tpu/models/rau.py``: the same parameter tree
(groups ``embed`` / ``rnn`` / ``mult``, weights ``[in, out]``), the same
layer-1 input hoist in the question encoder, the same vectorized last-token
gather, and the same eval hoists of the image embedding and the question
projection out of the hop loop.  Eval is the plain float32 path; the serving
step runs the question LSTM and the hop loop in CUDA kernels
(``rau_vqa_tpu_torch/ops``).  Training runs the fused configuration
(``fused_train=True``): the encoder in PyTorch under autograd, the hop loop
through ``ops.rau_train_hops.rau_train_hops``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from rau_vqa_tpu_torch.config import ModelConfig
from rau_vqa_tpu_torch.devices import pick_device
from rau_vqa_tpu_torch.models.cells import (
    _uniform,
    att_lstm_cell,
    deep_lstm_cell,
    dropout,
    linear_init,
    lstm_init,
)
from rau_vqa_tpu_torch.ops.rau_train_hops import rau_train_hops

Params = Dict


class RAUOutput(NamedTuple):
    """Per-hop predictions of one forward pass.

    scores [H, B, A], do_pred [H, B], attprob [H, B, S],
    final_c / final_h [B, att_state_dim]."""

    scores: torch.Tensor
    do_pred: torch.Tensor
    attprob: torch.Tensor
    final_c: torch.Tensor
    final_h: torch.Tensor


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Params:
    """uniform(-0.08, 0.08) over every weight and bias (reference :349-355),
    on ``device``: ``cuda`` when None, raising without a card.

    Draws come from ``generator`` in a fixed order; they differ from the JAX
    package's ``init_params`` for the same seed (carry weights over with
    ``convert.params_from_jax`` where the two must agree)."""
    device = pick_device(device, "init_params")
    scale = 0.08
    g = generator
    S, M = cfg.cnn_spat, cfg.multfeat_dim

    def lin(d_in, d_out):
        return linear_init(g, d_in, d_out, scale, device)

    embed = {"lookup": _uniform(g, (cfg.vocab_size, cfg.embed_dim), scale,
                                device)}
    rnn = lstm_init(g, cfg.embed_dim, cfg.rnn_size, cfg.rnn_layers, scale,
                    device)
    mult = {
        "q_proj": lin(cfg.rnnout_dim, M),
        "h_proj": lin(cfg.att_state_dim, M),
        "i_embed": lin(cfg.cnn_dim, M),
        "att_q": lin(M, cfg.attfeat_dim),
        "att_i": lin(M, cfg.attfeat_dim),
        "att_score": lin(cfg.attfeat_dim, 1),
        "att_mem": lin(cfg.att_state_dim, S),
        "attprob_proj": lin(S, M),
        "attlstm": lstm_init(g, M, cfg.att_rnn_size, cfg.att_rnn_layers,
                             scale, device),
        "merge": lin(cfg.att_state_dim, M),
        "cls": lin(M, cfg.answer_size),
        "do_pred": lin(M, 1),
    }
    return {"embed": embed, "rnn": rnn, "mult": mult}


def embed_question(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Word embedding + tanh (reference :203-206): tokens [B, T] -> [B, T, E]."""
    return torch.tanh(params["embed"]["lookup"][tokens.long()])


def encode_question(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                    lengths: torch.Tensor, *, train: bool = False,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """tokens [B, T] (0 = ZEROPAD), lengths [B] in [1, T] -> the packed
    (c, h) LSTM state at each question's last token, [B, rnnout_dim].

    In training, the word embedding is dropped before its tanh with one mask
    per timestep (so a mask does not depend on T), and the LSTM drops the
    input of layers >= 2; masks come from ``generator``."""
    B, T = tokens.shape
    if train and cfg.embed_dropout > 0.0:
        raw = params["embed"]["lookup"][tokens.long()]
        emb = torch.tanh(torch.stack(
            [dropout(raw[:, t], cfg.embed_dropout, generator, True)
             for t in range(T)], dim=1))
    else:
        emb = embed_question(params, tokens)
    l1 = params["rnn"]["layers"][0]
    # layer 1's input projection has no serial dependency: one batched product
    l1_gates = (emb.reshape(B * T, -1) @ l1["wi"] + l1["bi"]).reshape(B, T, -1)
    state = emb.new_zeros(B, cfg.rnnout_dim)
    states = []
    for t in range(T):
        state = deep_lstm_cell(params["rnn"], emb[:, t], state,
                               rnn_size=cfg.rnn_size,
                               dropout_rate=cfg.rnn_dropout, train=train,
                               generator=generator,
                               l1_in_gates=l1_gates[:, t])
        states.append(state)
    states = torch.stack(states)                                # [T, B, D]
    rows = torch.arange(B, device=tokens.device)
    return states[lengths.long() - 1, rows]


def embed_image(mp: Params, feats: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[i_embed] + the image half of [attbycontent] (reference :238-249):
    feats [B, S, Dc] -> (ifeat [B, S, M], iatt [B, S, F])."""
    ifeat = torch.tanh(feats @ mp["i_embed"]["w"] + mp["i_embed"]["b"])
    iatt = ifeat @ mp["att_i"]["w"] + mp["att_i"]["b"]
    return ifeat, iatt


def answering_unit(mp: Params, cfg: ModelConfig, q: torch.Tensor,
                   ifeat: torch.Tensor, iatt: torch.Tensor, c: torch.Tensor,
                   h: torch.Tensor, *,
                   q_proj_pre: Optional[torch.Tensor] = None):
    """One recurrent answering unit (reference :291-307), eval mode.

    Returns (score [B, A], do_pred [B], attprob [B, S], next_c, next_h).
    ``q_proj_pre``: the hop-invariant ``q @ q_proj + b``, hoisted by the
    caller."""
    if q_proj_pre is None:
        q_proj_pre = q @ mp["q_proj"]["w"] + mp["q_proj"]["b"]
    qfeat = torch.tanh(q_proj_pre + h @ mp["h_proj"]["w"] + mp["h_proj"]["b"])

    qatt = qfeat @ mp["att_q"]["w"] + mp["att_q"]["b"]           # [B, F]
    addfeat = torch.tanh(iatt + qatt[:, None, :])                # [B, S, F]
    attscore = (addfeat @ mp["att_score"]["w"])[..., 0] + mp["att_score"]["b"]
    attscore = attscore + h @ mp["att_mem"]["w"] + mp["att_mem"]["b"]
    attprob = torch.softmax(attscore, dim=-1)                    # [B, S]

    attfeat = torch.einsum("bsm,bs->bm", ifeat, attprob)
    join = (qfeat + attfeat
            + attprob @ mp["attprob_proj"]["w"] + mp["attprob_proj"]["b"])
    next_c, next_h = att_lstm_cell(mp["attlstm"], join, c, h,
                                   rnn_size=cfg.att_rnn_size)
    merge = join + next_h @ mp["merge"]["w"] + mp["merge"]["b"]
    score = merge @ mp["cls"]["w"] + mp["cls"]["b"]
    do_pred = torch.sigmoid(merge @ mp["do_pred"]["w"] + mp["do_pred"]["b"])[:, 0]
    return score, do_pred, attprob, next_c, next_h


def rau_forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                lengths: torch.Tensor, feats: torch.Tensor, *,
                train: bool = False,
                generator: Optional[torch.Generator] = None,
                hop_seed=None) -> RAUOutput:
    """End-to-end forward: tokens [B, T], lengths [B], feats [B, S, Dc].

    ``train=True`` needs ``cfg.fused_train``: the hop loop runs through
    ``rau_train_hops`` with counter-hash dropout masks seeded by
    ``hop_seed`` (an int32 in [0, 2^31 - 1); drawn from ``generator`` when
    None).  ``do_pred``, ``attprob`` and the final state carry no gradient
    (the reference zeroes d_do_pred, :565-567)."""
    if train:
        return _train_forward(params, cfg, tokens, lengths, feats,
                              generator, hop_seed)
    B = tokens.shape[0]
    mp = params["mult"]
    q = encode_question(params, cfg, tokens, lengths)
    c = q.new_zeros(B, cfg.att_state_dim)
    h = q.new_zeros(B, cfg.att_state_dim)
    # hop-invariant at eval: the image embedding and the question projection
    ifeat, iatt = embed_image(mp, feats)
    q_pre = q @ mp["q_proj"]["w"] + mp["q_proj"]["b"]
    scores, do_preds, attprobs = [], [], []
    for _ in range(cfg.n_hops):
        s, d, a, c, h = answering_unit(mp, cfg, q, ifeat, iatt, c, h,
                                       q_proj_pre=q_pre)
        scores.append(s)
        do_preds.append(d)
        attprobs.append(a)
    return RAUOutput(torch.stack(scores), torch.stack(do_preds),
                     torch.stack(attprobs), c, h)


UNFUSED_TRAINING = (
    "training runs the fused configuration (fused_train=True); the unfused "
    "path (per-hop random dropout, att_rnn_dropout, remat_hops) is still to "
    "port (ROADMAP.md, queue 1, 'unfused training path')")


def _train_forward(params: Params, cfg: ModelConfig, tokens, lengths, feats,
                   generator: Optional[torch.Generator], hop_seed) -> RAUOutput:
    if not cfg.fused_train:
        raise NotImplementedError(UNFUSED_TRAINING)
    needs_gen = (cfg.embed_dropout > 0.0 or cfg.rnn_dropout > 0.0
                 or (cfg.mult_dropout > 0.0 and hop_seed is None))
    if generator is None and needs_gen:
        raise ValueError("rau_forward(train=True) with dropout enabled "
                         "requires a generator")
    q = encode_question(params, cfg, tokens, lengths, train=True,
                        generator=generator)
    if hop_seed is None:
        hop_seed = (torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                                  device=generator.device, dtype=torch.int32)
                    if generator is not None else 0)
    scores, do_pred, attprob, fc, fh = rau_train_hops(
        params["mult"], cfg, q, feats, hop_seed)
    return RAUOutput(scores, do_pred.detach(), attprob.detach(), fc.detach(),
                     fh.detach())
