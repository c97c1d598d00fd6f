"""The RAU training step in plain PyTorch, float32: the reference of the
training cell.

One step of the paper's recipe (Ours_SS/LstmAttCtrlGradNoiseDontSelect.lua:
428-631 and the optimizer of optim_updates.lua:59-87): the forward with
inverted dropout on the word embedding, on the input of every question-LSTM
layer past the first and, in every hop, on the features, the question and
the merged feature; the joint loss, each hop's cross-entropy scaled by its
weight; the gradient; Gaussian gradient noise of deviation
sqrt(eta / ((t + 1) gamma)) at the 1-based iteration t; each parameter
group clipped to a global norm; Adam with eps outside the root.  It imports
nothing of the program.

The masks and the noise are the step's derived state, worked out again
here from the run's seed by the rule the training recipe fixes: step k's
generators are seeded ((seed * 1000003 + k) * 16 + stream) mod 2^63, stream
0 for the masks, drawn site by site in the forward's order, and stream
1 + i for the noise of group i, leaf by leaf.
"""

from __future__ import annotations

from typing import Dict, List

import torch

GROUPS = ("embed", "rnn", "mult")


def generator(device, seed: int, step: int, stream: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(((seed * 1_000_003 + step) * 16 + stream) % 2 ** 63)
    return g


def keep(shape, rate: float, gen: torch.Generator) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device) < 1.0 - rate


def drop(x, kept, rate: float):
    return torch.where(kept, x / (1.0 - rate), torch.zeros_like(x))


def leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def rebuild(tree, flat):
    it = iter(flat)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [walk(v) for v in t]
        return next(it)

    return walk(tree)


def _lin(x, p):
    return x @ p["w"] + p["b"]


def forward(p, s, tokens, lengths, feats, gen):
    """Training forward: per-hop scores [H, B, A].  ``s``: the sizes and
    dropout rates (``ModelConfig``'s names)."""
    B, T = tokens.shape
    R, L = s.rnn_size, s.rnn_layers
    e_rate, r_rate, m_rate, a_rate = s.embed_dropout, s.rnn_dropout, s.mult_dropout, s.att_rnn_dropout
    raw = p["embed"]["lookup"][tokens.long()]
    if e_rate > 0:
        raw = drop(raw, keep((B, s.seq_len, s.embed_dim), e_rate, gen)[:, :T], e_rate)
    emb = torch.tanh(raw)
    in_keep = keep((s.seq_len, L - 1, B, R), r_rate, gen) if r_rate > 0 and L > 1 else None
    layers = p["rnn"]["layers"]
    c = [emb.new_zeros(B, R) for _ in layers]
    h = [emb.new_zeros(B, R) for _ in layers]
    states = []
    for t in range(T):
        x = emb[:, t]
        for li, lp in enumerate(layers):
            if li > 0 and in_keep is not None:
                x = drop(x, in_keep[t, li - 1], r_rate)
            g = x @ lp["wi"] + lp["bi"] + h[li] @ lp["wh"] + lp["bh"]
            i_g, f_g, o_g = (torch.sigmoid(g[:, k * R:(k + 1) * R]) for k in range(3))
            c[li] = f_g * c[li] + i_g * torch.tanh(g[:, 3 * R:])
            h[li] = o_g * torch.tanh(c[li])
            x = h[li]
        states.append(torch.cat([v for li in range(L) for v in (c[li], h[li])], 1))
    q = torch.stack(states)[lengths.long() - 1, torch.arange(B, device=tokens.device)]

    mp = p["mult"]
    Ra = s.att_rnn_size
    alayers = mp["attlstm"]["layers"]
    ac = [q.new_zeros(B, Ra) for _ in alayers]
    ah = [q.new_zeros(B, Ra) for _ in alayers]
    scores = []
    for _ in range(s.n_hops):
        f = drop(feats, keep(feats.shape, m_rate, gen), m_rate) if m_rate > 0 else feats
        ifeat = torch.tanh(_lin(f, mp["i_embed"]))
        iatt = _lin(ifeat, mp["att_i"])
        q_in = drop(q, keep(q.shape, m_rate, gen), m_rate) if m_rate > 0 else q
        h_all = torch.cat(ah, 1)
        qfeat = torch.tanh(_lin(q_in, mp["q_proj"]) + _lin(h_all, mp["h_proj"]))
        addfeat = torch.tanh(iatt + _lin(qfeat, mp["att_q"])[:, None, :])
        score = ((addfeat @ mp["att_score"]["w"])[..., 0] + mp["att_score"]["b"]
                 + _lin(h_all, mp["att_mem"]))
        attprob = torch.softmax(score, -1)
        join = qfeat + torch.einsum("bsm,bs->bm", ifeat, attprob) + _lin(attprob, mp["attprob_proj"])
        x = join
        for li, lp in enumerate(alayers):
            if a_rate > 0:
                x = drop(x, keep(x.shape, a_rate, gen), a_rate)
            g = x @ lp["wi"] + lp["bi"] + ah[li] @ lp["wh"] + lp["bh"]
            i_g = torch.sigmoid(g[:, :Ra])
            f_g = torch.sigmoid(g[:, 2 * Ra:3 * Ra])
            o_g = torch.sigmoid(g[:, 3 * Ra:])
            ac[li] = f_g * ac[li] + i_g * torch.tanh(g[:, Ra:2 * Ra])
            ah[li] = o_g * torch.tanh(ac[li])
            x = ah[li]
        lstmfeat = torch.cat(ah, 1)
        if a_rate > 0:
            lstmfeat = drop(lstmfeat, keep(lstmfeat.shape, a_rate, gen), a_rate)
        merge = join + _lin(lstmfeat, mp["merge"])
        if m_rate > 0:
            merge = drop(merge, keep(merge.shape, m_rate, gen), m_rate)
        scores.append(_lin(merge, mp["cls"]))
    return torch.stack(scores)


def loss_and_grads(params, s, tokens, lengths, feats, labels, hop_scale, gen):
    """(the joint loss, its gradient as a tree like ``params``)."""
    with torch.enable_grad():
        p = rebuild(params, [x.detach().requires_grad_() for x in leaves(params)])
        scores = forward(p, s, tokens, lengths, feats, gen)
        logp = torch.log_softmax(scores, -1)
        ce = -logp.gather(-1, labels.long()[None, :, None].expand(scores.shape[0], -1, 1))
        loss = (hop_scale * ce[..., 0].mean(-1)).sum()
        grads = torch.autograd.grad(loss, leaves(p), allow_unused=True, materialize_grads=True)
    return loss.detach(), rebuild(params, list(grads))


def step(params, opt: Dict, s, tc, seed: int, k: int, batch, lr: float, mult_lr: float):
    """Step ``k`` (0-based) from ``params`` and Adam state ``opt`` ({group:
    {"m", "v", "t"}}); ``tc``: the optimizer's knobs (``TrainConfig``'s
    names); ``batch``: (tokens, lengths, feats, labels, hop_scale).
    Returns (loss, raw gradient, the gradient the optimizer got, params,
    opt)."""
    dev = leaves(params)[0].device
    loss, grads = loss_and_grads(params, s, *batch, generator(dev, seed, k, 0))
    lrs = {"embed": lr, "rnn": lr, "mult": mult_lr}
    std = (tc.noisy_eta / ((float(k + 1) + 1.0) * tc.noisy_gamma)) ** 0.5
    new_p, new_o, got = {}, {}, {}
    for i, gname in enumerate(GROUPS):
        gen = generator(dev, seed, k, 1 + i)
        g = [x + std * torch.randn(x.shape, generator=gen, device=dev) for x in leaves(grads[gname])]
        norm = torch.sqrt(sum((x * x).sum() for x in g))
        g = [x * torch.clamp(tc.grad_clip / torch.clamp(norm, min=1e-20), max=1.0) for x in g]
        o = opt[gname]
        t = o["t"] + 1
        m = [tc.adam_beta1 * a + (1 - tc.adam_beta1) * b for a, b in zip(leaves(o["m"]), g)]
        v = [tc.adam_beta2 * a + (1 - tc.adam_beta2) * b * b for a, b in zip(leaves(o["v"]), g)]
        size = lrs[gname] * (1 - tc.adam_beta2 ** t) ** 0.5 / (1 - tc.adam_beta1 ** t)
        x_new = [x - size * a / (torch.sqrt(b) + tc.adam_epsilon)
                 for x, a, b in zip(leaves(params[gname]), m, v)]
        new_p[gname] = rebuild(params[gname], x_new)
        new_o[gname] = {"m": rebuild(params[gname], m), "v": rebuild(params[gname], v), "t": t}
        got[gname] = rebuild(params[gname], g)
    return loss, grads, got, new_p, new_o


def init_opt(params) -> Dict:
    return {g: {"m": rebuild(params[g], [torch.zeros_like(x) for x in leaves(params[g])]),
                "v": rebuild(params[g], [torch.zeros_like(x) for x in leaves(params[g])]),
                "t": 0} for g in GROUPS}
