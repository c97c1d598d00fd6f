"""The RAU head's eval forward in plain PyTorch, float32: the reference that
decides whether a serving cell's answers are correct.

Written from the model's equations (Noh & Han, arXiv 1606.03647; the Torch
reference's DeepLSTM.lua, ATTLSTM.lua and the answering unit of
Ours_SS/LstmAttCtrlGradNoiseDontSelect.lua:203-307, 504-515, 683-697).  It
imports nothing of the program.  The parameter tree is the one the benchmark
makes (``weights.rau_head``): groups ``embed`` / ``rnn`` / ``mult``,
weights ``[in, out]``.

Every product goes through ``dot`` (float32 by default), the image
embedding's through ``embed_dot`` where it is given; the controls hand in
lower-precision ones.  ``rows`` runs the batch in blocks, so that a
full-size batch fits beside whatever else is on the card.
"""

from __future__ import annotations

import torch


def dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x.float(), w.float())


def _lin(x, p, dot):
    return dot(x, p["w"]) + p["b"].float()


def encode_question(params, tokens, lengths, *, rnn_size: int, dot=dot_f32):
    """tokens [B, T], lengths [B] -> the packed (c, h) state of every layer
    at each question's last token, [B, 2 * layers * R].  Gates [i, f, o | g]
    (DeepLSTM.lua:47-54)."""
    R = rnn_size
    emb = torch.tanh(params["embed"]["lookup"].float()[tokens.long()])   # [B, T, E]
    B, T, _ = emb.shape
    layers = params["rnn"]["layers"]
    c = [emb.new_zeros(B, R) for _ in layers]
    h = [emb.new_zeros(B, R) for _ in layers]
    out = emb.new_zeros(B, 2 * len(layers) * R)
    last = lengths.long() - 1
    for t in range(T):
        x = emb[:, t]
        for L, lp in enumerate(layers):
            g = dot(x, lp["wi"]) + lp["bi"].float() + dot(h[L], lp["wh"]) + lp["bh"].float()
            i_g, f_g, o_g = (torch.sigmoid(g[:, k * R:(k + 1) * R]) for k in range(3))
            c[L] = f_g * c[L] + i_g * torch.tanh(g[:, 3 * R:])
            h[L] = o_g * torch.tanh(c[L])
            x = h[L]
        here = (last == t)[:, None]
        state = torch.cat([v for L in range(len(layers)) for v in (c[L], h[L])], 1)
        out = torch.where(here, state, out)
    return out


def hops(mp, q, feats, *, n_hops: int, att_rnn_size: int, dot=dot_f32, embed_dot=None):
    """The image embedding and ``n_hops`` answering units at eval:
    (scores [H, B, A], do_pred [H, B], attprob [H, B, S])."""
    Ra = att_rnn_size
    B = q.shape[0]
    ifeat = torch.tanh(_lin(feats, mp["i_embed"], embed_dot or dot))   # [B, S, M]
    iatt = _lin(ifeat, mp["att_i"], dot)                               # [B, S, F]
    q_pre = _lin(q, mp["q_proj"], dot)
    layers = mp["attlstm"]["layers"]
    c = [q.new_zeros(B, Ra) for _ in layers]
    h = [q.new_zeros(B, Ra) for _ in layers]
    scores, do_preds, attprobs = [], [], []
    for _ in range(n_hops):
        h_all = torch.cat(h, 1)
        qfeat = torch.tanh(q_pre + _lin(h_all, mp["h_proj"], dot))
        qatt = _lin(qfeat, mp["att_q"], dot)
        addfeat = torch.tanh(iatt + qatt[:, None, :])
        score = (dot(addfeat, mp["att_score"]["w"])[..., 0] + mp["att_score"]["b"].float()
                 + _lin(h_all, mp["att_mem"], dot))
        attprob = torch.softmax(score, dim=-1)                         # [B, S]
        attfeat = dot(attprob[:, None, :], ifeat)[:, 0]                # [B, M]
        join = qfeat + attfeat + _lin(attprob, mp["attprob_proj"], dot)
        x = join
        for L, lp in enumerate(layers):                                # [i, g, f, o]
            g = dot(x, lp["wi"]) + lp["bi"].float() + dot(h[L], lp["wh"]) + lp["bh"].float()
            i_g = torch.sigmoid(g[:, :Ra])
            f_g = torch.sigmoid(g[:, 2 * Ra:3 * Ra])
            o_g = torch.sigmoid(g[:, 3 * Ra:])
            c[L] = f_g * c[L] + i_g * torch.tanh(g[:, Ra:2 * Ra])
            h[L] = o_g * torch.tanh(c[L])
            x = h[L]
        merge = join + _lin(torch.cat(h, 1), mp["merge"], dot)
        scores.append(_lin(merge, mp["cls"], dot))
        do_preds.append(torch.sigmoid(_lin(merge, mp["do_pred"], dot))[:, 0])
        attprobs.append(attprob)
    return torch.stack(scores), torch.stack(do_preds), torch.stack(attprobs)


def first_fired(do_pred: torch.Tensor) -> torch.Tensor:
    """[H, B] gates: 1 at the first hop whose do_pred is over 0.5, the last
    hop always firing (reference :683-697)."""
    fired = do_pred > 0.5
    fired[-1] = True
    first = fired.float().argmax(0)
    return torch.nn.functional.one_hot(first, do_pred.shape[0]).T.float()


def tables(params, sizes, tokens, lengths, feats, *, dot=dot_f32, embed_dot=None,
           rows: int = 128):
    """(tab_pred [H+2, B, A], tab_att [H+2, B, S], do_pred [H, B]): every
    hop's answers, their mean ("uni") and the first confident hop's
    ("select"), with the matching attention maps.  ``sizes``: a mapping
    with ``rnn_size``, ``n_hops`` and ``att_rnn_size``."""
    preds, atts, dos = [], [], []
    for r0 in range(0, tokens.shape[0], rows):
        sl = slice(r0, r0 + rows)
        q = encode_question(params, tokens[sl], lengths[sl], rnn_size=sizes["rnn_size"],
                            dot=dot)
        s, d, a = hops(params["mult"], q, feats[sl].float(), n_hops=sizes["n_hops"],
                       att_rnn_size=sizes["att_rnn_size"], dot=dot, embed_dot=embed_dot)
        gates = first_fired(d)
        preds.append(torch.cat([s, s.mean(0)[None], (s * gates[..., None]).sum(0)[None]]))
        atts.append(torch.cat([a, a.mean(0)[None], (a * gates[..., None]).sum(0)[None]]))
        dos.append(d)
    return torch.cat(preds, 1), torch.cat(atts, 1), torch.cat(dos, 1)


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to fp8 (e4m3) after scaling by its largest magnitude,
    and back to float32."""
    t = t.float()
    s = t.abs().amax().clamp(min=1e-30) / 448.0
    return (t / s).to(torch.float8_e4m3fn).float() * s


def dot_bf16(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A product of bf16 operands summed in float32."""
    return torch.matmul(x.bfloat16().float(), w.bfloat16().float())


def dot_tf32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A float32 product on TF32 tensor cores (a card's, where it has them)."""
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return torch.matmul(x.float(), w.float())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


def dot_fp8(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A product of fp8 operands summed in float32: the control's precision,
    one step below the serving kernels' bf16 operands."""
    return torch.matmul(fp8_round(x), fp8_round(w))
