"""The RAU (Recurrent Answering Units) VQA model in PyTorch.

Counterpart of ``rau_vqa_tpu/models/rau.py``: the same parameter tree
(groups ``embed`` / ``rnn`` / ``mult``, weights ``[in, out]``), the same
layer-1 input hoist in the question encoder, the same vectorized last-token
gather, and the same eval hoists of the image embedding and the question
projection out of the hop loop.  Eval is the plain path; the serving
step runs the question LSTM and the hop loop in CUDA kernels
(``rau_vqa_tpu_torch/ops``).  Training runs the encoder in PyTorch under
autograd, then the hop loop either fused (``fused_train=True``: through
``ops.rau_train_hops.rau_train_hops``) or unfused (the presets' default: each
hop re-embeds the features and runs the answering unit under fresh dropout
masks, optionally recomputed in the backward with ``remat_hops``).  With
``compute_dtype="bfloat16"`` every param and the features are cast to bf16
on entry, under autograd, as the JAX package casts them.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.utils.checkpoint

from rau_vqa_tpu_torch.config import ModelConfig
from rau_vqa_tpu_torch.convert import map_tree
from rau_vqa_tpu_torch.devices import pick_device
from rau_vqa_tpu_torch.models.cells import (
    _uniform,
    apply_keep,
    att_lstm_cell,
    deep_lstm_cell,
    dropout,
    keep_mask,
    linear_init,
    lstm_init,
)
from rau_vqa_tpu_torch.ops.rau_train_hops import dot_dtype, rau_train_hops

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

    In training, the word embedding is dropped before its tanh and the LSTM
    drops the input of layers >= 2, with masks from ``generator``.  Each
    site's masks are drawn for all ``cfg.seq_len`` positions up front, the
    embedding's first, and cut to T: a timestep's masks, and every draw
    after the encoder's, do not depend on T (as the JAX package keys each
    timestep's masks by its index, rau_vqa_tpu/models/rau.py:123-143), so
    a batch cut to any T >= its longest question trains alike."""
    B, T = tokens.shape
    in_keep = None
    if train:
        if T > cfg.seq_len:
            raise ValueError(f"encode_question: {T} timesteps, at most "
                             f"seq_len {cfg.seq_len} in training")
        dev = tokens.device
        if cfg.embed_dropout > 0.0:
            keep = keep_mask((B, cfg.seq_len, cfg.embed_dim), cfg.embed_dropout,
                             generator, dev)[:, :T]
            raw = params["embed"]["lookup"][tokens.long()]
            emb = torch.tanh(apply_keep(raw, keep, cfg.embed_dropout))
        else:
            emb = embed_question(params, tokens)
        if cfg.rnn_dropout > 0.0 and cfg.rnn_layers > 1:
            in_keep = keep_mask((cfg.seq_len, cfg.rnn_layers - 1, B, cfg.rnn_size),
                                cfg.rnn_dropout, generator, dev)
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
                               dropout_rate=cfg.rnn_dropout,
                               in_keep=None if in_keep is None else in_keep[t],
                               l1_in_gates=l1_gates[:, t])
        states.append(state)
    states = torch.stack(states)                                # [T, B, D]
    rows = torch.arange(B, device=tokens.device)
    return states[lengths.long() - 1, rows]


def embed_image(mp: Params, feats: torch.Tensor, *, dropout_rate: float = 0.0,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[i_embed] + the image half of [attbycontent] (reference :238-249):
    feats [B, S, Dc] -> (ifeat [B, S, M], iatt [B, S, F]).  In training the
    features are dropped first, at ``mult_dropout``
    (rau_vqa_tpu/models/rau.py:171-172)."""
    feats = dropout(feats, dropout_rate, generator, True)
    ifeat = torch.tanh(feats @ mp["i_embed"]["w"] + mp["i_embed"]["b"])
    iatt = ifeat @ mp["att_i"]["w"] + mp["att_i"]["b"]
    return ifeat, iatt


def answering_unit(mp: Params, cfg: ModelConfig, q: torch.Tensor,
                   ifeat: torch.Tensor, iatt: torch.Tensor, c: torch.Tensor,
                   h: torch.Tensor, *, train: bool = False,
                   generator: Optional[torch.Generator] = None,
                   q_proj_pre: Optional[torch.Tensor] = None):
    """One recurrent answering unit (reference :291-307).

    Returns (score [B, A], do_pred [B], attprob [B, S], next_c, next_h).
    ``q_proj_pre``: the hop-invariant ``q @ q_proj + b``, hoisted by the
    caller at eval.  In training, masks from ``generator`` drop the
    question, every ATTLSTM layer's input and the LSTM's output
    (``att_rnn_dropout``) and the merged feature, as the JAX package's
    (rau_vqa_tpu/models/rau.py:199, :219-229; cells.py:150-152)."""
    if q_proj_pre is None:
        q_in = dropout(q, cfg.mult_dropout, generator, train)
        q_proj_pre = q_in @ mp["q_proj"]["w"] + mp["q_proj"]["b"]
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
                                   rnn_size=cfg.att_rnn_size,
                                   dropout_rate=cfg.att_rnn_dropout, train=train,
                                   generator=generator)
    lstmfeat = dropout(next_h, cfg.att_rnn_dropout, generator, train)
    merge = join + lstmfeat @ mp["merge"]["w"] + mp["merge"]["b"]
    merge = dropout(merge, cfg.mult_dropout, generator, train)
    score = merge @ mp["cls"]["w"] + mp["cls"]["b"]
    do_pred = torch.sigmoid(merge @ mp["do_pred"]["w"] + mp["do_pred"]["b"])[:, 0]
    return score, do_pred, attprob, next_c, next_h


def rau_forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                lengths: torch.Tensor, feats: torch.Tensor, *,
                train: bool = False,
                generator: Optional[torch.Generator] = None,
                hop_seed=None) -> RAUOutput:
    """End-to-end forward: tokens [B, T], lengths [B], feats [B, S, Dc].

    The params and ``feats`` are cast to ``cfg.compute_dtype`` first, under
    autograd (JAX :266-270).  ``train=True`` draws every dropout mask from
    ``generator``, which dropout requires.  With ``cfg.fused_train`` the hop
    loop runs fused, its counter-hash masks seeded by ``hop_seed`` (an
    int32 in [0, 2^31 - 1); drawn from ``generator`` when None).
    ``do_pred``, ``attprob`` and the final state of the fused path carry no
    gradient (the reference zeroes d_do_pred, :565-567)."""
    cdt = dot_dtype(cfg)
    if cdt != torch.float32:
        params = map_tree(lambda x: x.to(cdt), params)
    feats = feats.to(cdt)
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


def _train_forward(params: Params, cfg: ModelConfig, tokens, lengths, feats,
                   generator: Optional[torch.Generator], hop_seed) -> RAUOutput:
    needs_gen = max(cfg.embed_dropout, cfg.rnn_dropout, cfg.mult_dropout,
                    cfg.att_rnn_dropout) > 0.0
    if cfg.fused_train:   # the hop loop's masks come from hop_seed
        needs_gen = (cfg.embed_dropout > 0.0 or cfg.rnn_dropout > 0.0
                     or (cfg.mult_dropout > 0.0 and hop_seed is None))
    if generator is None and needs_gen:
        raise ValueError("rau_forward(train=True) with dropout enabled "
                         "requires a generator")
    q = encode_question(params, cfg, tokens, lengths, train=True,
                        generator=generator)
    if not cfg.fused_train:
        return _unfused_hops(params["mult"], cfg, q, feats, generator)
    if hop_seed is None:
        hop_seed = (torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                                  device=generator.device, dtype=torch.int32)
                    if generator is not None else 0)
    scores, do_pred, attprob, fc, fh = rau_train_hops(params["mult"], cfg, q, feats,
                                                      hop_seed)
    return RAUOutput(scores, do_pred.detach(), attprob.detach(), fc.detach(),
                     fh.detach())


def _unfused_hops(mp: Params, cfg: ModelConfig, q, feats,
                  generator: Optional[torch.Generator]) -> RAUOutput:
    """The unfused training hop loop (rau_vqa_tpu/models/rau.py:305-346):
    each hop re-embeds the features and runs the answering unit under its
    own dropout masks, drawn from ``generator``.

    ``torch.utils.checkpoint`` restores only the default generators when it
    recomputes a hop in the backward (``remat_hops``), so a hop that drew
    from ``generator`` itself would draw other masks there.  Under remat a
    hop draws from a copy of ``generator``'s state at the hop's start, the
    same masks in the forward and the recompute, and ``generator`` then
    takes the copy's state, as if the hop had drawn from it: the masks are
    those of the path without remat.  The state is read and set on the host,
    with no device round trip."""
    B = q.shape[0]
    copies = []

    def hop(c, h, state=None):
        g = generator
        if state is not None:
            g = torch.Generator(device=generator.device)
            g.set_state(state)
            copies.append(g)
        ifeat, iatt = embed_image(mp, feats, dropout_rate=cfg.mult_dropout, generator=g)
        return answering_unit(mp, cfg, q, ifeat, iatt, c, h, train=True, generator=g)

    c = q.new_zeros(B, cfg.att_state_dim)
    h = q.new_zeros(B, cfg.att_state_dim)
    scores, do_preds, attprobs = [], [], []
    for _ in range(cfg.n_hops):
        if cfg.remat_hops:
            # recompute the hop in the backward instead of saving its
            # [B, S, M]-sized activations (rau_vqa_tpu/models/rau.py:326-329)
            state = generator.get_state() if generator is not None else None
            out = torch.utils.checkpoint.checkpoint(
                hop, c, h, state, use_reentrant=False, preserve_rng_state=False)
            if generator is not None:
                generator.set_state(copies[-1].get_state())
        else:
            out = hop(c, h)
        score, do_p, attp, c, h = out
        scores.append(score)
        do_preds.append(do_p)
        attprobs.append(attp)
    return RAUOutput(torch.stack(scores), torch.stack(do_preds),
                     torch.stack(attprobs), c, h)
