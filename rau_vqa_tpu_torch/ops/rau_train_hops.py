"""The training hop loop: two CUDA kernels, their plain versions, and the
``torch.autograd.Function`` that joins them.

Counterpart of ``rau_vqa_tpu/ops/rau_train_hops.py``.  In training each hop
re-embeds the image features under its own dropout masks, so the hop loop is
where a train step spends its work.  ``rau_train_hops`` runs it fused:

- forward: ``csrc/rau_train_hops_fwd.cu`` runs each hop as batch-wide
  phases (``fwd_plan``) that one C entry enqueues, and saves only the LSTM
  carries entering each hop, ``c_all`` / ``h_all`` ``[H+1, B, R]``; masks
  come from the counter hash of ``ops/maskgen.py``;
- backward (``fused_train_bwd="kernel"``): ``csrc/rau_train_hops_bwd.cu``
  rematerializes each hop from the carries and the same masks (the
  forward's own phases; in float32 in the same order of sums), runs the
  cotangent chain in reverse, sums the feats-path weight grads over the rows
  and hops and emits the small per-hop cotangents, as batch-wide phases
  (``bwd_plan``) that one C entry enqueues; the remaining weight grads and
  ``dq`` are batched products over ``[H*B, *]`` in PyTorch
  (``_outside_grads``), as the JAX package leaves them to XLA.  Where the
  features require grad (backbone fine-tuning), the backward kernel also
  sums their gradient over the hops (``dfeats``: one more product a hop,
  masked in its epilogue); the JAX package's Pallas backward returns zeros
  there (:649, :664), its plain autodiff on the CPU does not.
  ``fused_train_bwd="xla"`` instead runs autograd through
  ``rau_train_hops_reference``; ``"reference"`` runs the forward there too,
  with no kernel (the training bench's ``maskref``).

CPU tensors run the kernels' plain versions (``train_hops_fwd_reference``,
``train_hops_bwd_reference``); CUDA tensors launch the kernels or raise.
``do_pred``, ``attprob`` and the final state are monitors: only the score
cotangent propagates and ``do_pred``'s weights get exactly zero.

Types follow ``cfg.compute_dtype`` as the JAX package's ``dot_dtype`` does
(:299, :364-365, :478-479).  In float32 everything is float32.  In
bfloat16 every product takes both operands rounded to bf16 and sums in
float32; the elementwise math, the softmax, the attention pooling, the
bias sums, the carries, the scores and the cotangents stay float32 on
unrounded values.  The kernels take ``q``, ``feats`` and the weights in
bf16 (their own instantiations, ``FWD_BF16_KERNEL`` / ``BWD_BF16_KERNEL``)
and emit ``qfeat``, ``join`` and ``merge_d`` in bf16; the forward sums every
product in float32 FMA chains, the backward its bf16 ones on the tensor
cores (``mma.sync``).  The products outside
the kernels (``gmerge``, ``_outside_grads``) are float32 ``matmul``s on
bf16-rounded operands, so their sums are float32 as JAX's are; each grad
is then cast to its param's type and ``dq`` to ``q``'s, as JAX casts them
(:648, :662-664).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from rau_vqa_tpu_torch.config import ModelConfig
from rau_vqa_tpu_torch.ops._build import Kernel
from rau_vqa_tpu_torch.ops.fused_resnet import _sm_count
from rau_vqa_tpu_torch.ops.maskgen import (
    dropout_scale_mask,
    mask_scale,
    mask_threshold,
    site_salt,
)
from rau_vqa_tpu_torch.ops.treeflat import mult_shapes, pluck, rebuild

# weights the loss differentiates (rau_train_hops.py:53-63)
_DIFF_WEIGHTS = [
    ("q_proj", "w"), ("q_proj", "b"), ("h_proj", "w"), ("h_proj", "b"),
    ("i_embed", "w"), ("i_embed", "b"),
    ("att_q", "w"), ("att_q", "b"), ("att_i", "w"), ("att_i", "b"),
    ("att_score", "w"), ("att_score", "b"),
    ("att_mem", "w"), ("att_mem", "b"),
    ("attprob_proj", "w"), ("attprob_proj", "b"),
    ("attlstm", "layers", 0, "wi"), ("attlstm", "layers", 0, "bi"),
    ("attlstm", "layers", 0, "wh"), ("attlstm", "layers", 0, "bh"),
    ("merge", "w"), ("merge", "b"), ("cls", "w"), ("cls", "b"),
]
# do_pred is forward-only (zero gradient: the "DontSelect" rule); this is
# also the kernels' weight-pointer order
_FWD_WEIGHTS = _DIFF_WEIGHTS + [("do_pred", "w"), ("do_pred", "b")]
# grads summed inside the backward kernel: those of the feats path
_INKERNEL_GRADS = [("i_embed", "w"), ("i_embed", "b"),
                   ("att_i", "w"), ("att_i", "b"), ("att_score", "w")]
# per-hop tensors the backward emits for the outside products: (name, width,
# a float32 cotangent, else an activation in the product type; :76-80)
_EMITS = [("dpre_q", "M", True), ("dqatt", "F", True),
          ("dscore_att", "S", True), ("djoin", "M", True),
          ("dgates", "G", True), ("dmerge_pre", "M", True),
          ("qfeat", "M", False), ("join", "M", False), ("merge_d", "M", False)]

# the features' gradient, beside the in-kernel grads where asked for
DFEATS = ("feats",)

_SITE_FEATS, _SITE_Q, _SITE_MERGE = 0, 1, 2

_P = ctypes.c_void_p
_I = ctypes.c_int
_DROPOUT_ARGS = [ctypes.c_uint32, ctypes.c_float, _I, _I, _P]
_FWD_ARGS = ([_P, _P, _P, ctypes.POINTER(_P)] + [_P] * 7 + [_I] * 9 + [ctypes.c_longlong]
             + _DROPOUT_ARGS)
_BWD_ARGS = ([_P] * 6 + [ctypes.POINTER(_P), _P, ctypes.POINTER(_P), ctypes.POINTER(_P), _P,
                          _P] + [_I] * 9 + [ctypes.c_longlong] + _DROPOUT_ARGS)
# one instantiation of each kernel per product type, each counted apart, and
# the backward's calls with the features' gradient counted apart again
FWD_KERNEL = Kernel("rau_train_hops_fwd", "train_hops_fwd_launch", _FWD_ARGS)
BWD_KERNEL = Kernel("rau_train_hops_bwd", "train_hops_bwd_launch", _BWD_ARGS)
FWD_BF16_KERNEL = Kernel("rau_train_hops_fwd", "train_hops_fwd_bf16_launch", _FWD_ARGS)
BWD_BF16_KERNEL = Kernel("rau_train_hops_bwd", "train_hops_bwd_bf16_launch", _BWD_ARGS)
BWD_DFEATS_KERNEL = Kernel("rau_train_hops_bwd", "train_hops_bwd_launch", _BWD_ARGS)
BWD_DFEATS_BF16_KERNEL = Kernel("rau_train_hops_bwd", "train_hops_bwd_bf16_launch", _BWD_ARGS)
_KERNELS = {torch.float32: (FWD_KERNEL, BWD_KERNEL),
            torch.bfloat16: (FWD_BF16_KERNEL, BWD_BF16_KERNEL)}
_DFEATS_KERNELS = {torch.float32: BWD_DFEATS_KERNEL, torch.bfloat16: BWD_DFEATS_BF16_KERNEL}
_DOT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dot_dtype(cfg: ModelConfig) -> torch.dtype:
    """The products' operand type: ``cfg.compute_dtype``."""
    try:
        return _DOT_DTYPES[cfg.compute_dtype]
    except KeyError:
        raise ValueError(f"compute_dtype must be one of {sorted(_DOT_DTYPES)}, "
                         f"got {cfg.compute_dtype!r}") from None


def check_fused_config(cfg: ModelConfig) -> None:
    """The fused path (kernels and plain versions) supports the reference
    configuration: a 1-layer ATTLSTM, no att_rnn_dropout, float32 or
    bfloat16 products."""
    if cfg.att_rnn_layers != 1 or cfg.att_rnn_dropout > 0.0:
        raise NotImplementedError(
            "fused training path supports the reference configuration "
            "(1-layer ATTLSTM, no att_rnn_dropout): use fused_train=False")
    dot_dtype(cfg)
    if cfg.fused_train_bwd not in ("kernel", "xla", "reference"):
        raise ValueError(f"fused_train_bwd must be 'kernel', 'xla' or 'reference', got "
                         f"{cfg.fused_train_bwd!r}")


def _rnd(x, dd):
    """``x`` rounded to the product type ``dd``, as float32."""
    return x.float() if dd == torch.float32 else x.to(dd).float()


class _RoundedDot(torch.autograd.Function):
    """``x @ w`` on bf16-rounded operands, summed in float32: JAX's
    ``dot_general(x.astype(bf16), w.astype(bf16), preferred_element_type=
    f32)``.  The backward is JAX's transpose of it: each operand's
    cotangent is the float32 product of the output's (unrounded) cotangent
    with the other rounded operand, rounded to bf16, the cast operand's
    type, and then carried to the operand's own type."""

    @staticmethod
    def forward(ctx, x, w):
        xb, wb = _rnd(x, torch.bfloat16), _rnd(w, torch.bfloat16)
        ctx.save_for_backward(xb, wb)
        ctx.types = (x.dtype, w.dtype)
        return xb @ wb

    @staticmethod
    def backward(ctx, g):
        xb, wb = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = (g @ wb.T).to(torch.bfloat16).to(ctx.types[0])
        if ctx.needs_input_grad[1]:
            dw = (xb.T @ g).to(torch.bfloat16).to(ctx.types[1])
        return dx, dw


def _dot(x, w, dd):
    """A product of the hop with operand type ``dd``, differentiable."""
    return x @ w if dd == torch.float32 else _RoundedDot.apply(x, w)


def _seed_tensor(seed, device) -> torch.Tensor:
    return torch.as_tensor(seed, dtype=torch.int32, device=device).reshape(1)


def _masks(cfg: ModelConfig, shapes, seed, hop: int, row0: int = 0):
    """The three per-hop dropout scale masks (feats, q, merge) of the call's
    rows, the first of them global row ``row0``; ``None`` without
    dropout."""
    rate = cfg.mult_dropout
    if rate <= 0.0:
        return None, None, None
    (B, S, Dc), (_, Q), (_, M) = shapes
    fm = dropout_scale_mask((B, S, Dc), row0, site_salt(seed, hop, _SITE_FEATS), rate)
    qm = dropout_scale_mask((B, Q), row0, site_salt(seed, hop, _SITE_Q), rate)
    mm = dropout_scale_mask((B, M), row0, site_salt(seed, hop, _SITE_MERGE), rate)
    return fm, qm, mm


def _hop_fwd_core(mp, q, feats, c, hprev, fm, qm, mm, dd) -> Dict:
    """One training hop (``_hop_fwd_core``, :104-167) with explicit masks and
    product type ``dd``."""
    def dot(x, w):
        return _dot(x, w, dd)

    B, S, Dc = feats.shape
    t: Dict = {}
    x = feats.float() * fm if fm is not None else feats.float()
    t["feats_d"] = x
    prei = dot(x.reshape(B * S, Dc), mp["i_embed"]["w"]).reshape(B, S, -1) \
        + mp["i_embed"]["b"].float()
    t["ifeat"] = torch.tanh(prei)                                 # [B, S, M]
    M = t["ifeat"].shape[-1]
    t["iatt"] = (dot(t["ifeat"].reshape(B * S, M), mp["att_i"]["w"]
                     ).reshape(B, S, -1) + mp["att_i"]["b"].float())  # [B, S, F]
    F = t["iatt"].shape[-1]
    t["q_d"] = q.float() * qm if qm is not None else q.float()
    t["qfeat"] = torch.tanh(dot(t["q_d"], mp["q_proj"]["w"]) + mp["q_proj"]["b"].float()
                            + dot(hprev, mp["h_proj"]["w"]) + mp["h_proj"]["b"].float())
    t["qatt"] = dot(t["qfeat"], mp["att_q"]["w"]) + mp["att_q"]["b"].float()  # [B, F]
    t["addfeat"] = torch.tanh(t["iatt"] + t["qatt"][:, None, :])  # [B, S, F]
    score_c = dot(t["addfeat"].reshape(B * S, F), mp["att_score"]["w"]).reshape(B, S)
    attscore = (score_c + mp["att_score"]["b"].float()[0]
                + dot(hprev, mp["att_mem"]["w"]) + mp["att_mem"]["b"].float())
    t["attprob"] = torch.softmax(attscore, dim=-1)                # [B, S]
    t["attfeat"] = torch.sum(t["ifeat"] * t["attprob"][:, :, None], dim=1)
    t["join"] = (t["qfeat"] + t["attfeat"]
                 + dot(t["attprob"], mp["attprob_proj"]["w"])
                 + mp["attprob_proj"]["b"].float())
    lp = mp["attlstm"]["layers"][0]
    R = c.shape[-1]
    gates = (dot(t["join"], lp["wi"]) + lp["bi"].float()
             + dot(hprev, lp["wh"]) + lp["bh"].float())
    # ATTLSTM gate order [i, g, f, o] (ATTLSTM.lua:16-19)
    t["i_g"] = torch.sigmoid(gates[:, :R])
    t["g_t"] = torch.tanh(gates[:, R:2 * R])
    t["f_g"] = torch.sigmoid(gates[:, 2 * R:3 * R])
    t["o_g"] = torch.sigmoid(gates[:, 3 * R:])
    t["c_prev"] = c
    t["c_new"] = t["f_g"] * c + t["i_g"] * t["g_t"]
    t["tanh_c"] = torch.tanh(t["c_new"])
    t["h_new"] = t["o_g"] * t["tanh_c"]
    t["merge_pre"] = (t["join"] + dot(t["h_new"], mp["merge"]["w"])
                      + mp["merge"]["b"].float())
    t["merge_d"] = t["merge_pre"] * mm if mm is not None else t["merge_pre"]
    if "cls" in mp:
        t["score"] = dot(t["merge_d"], mp["cls"]["w"]) + mp["cls"]["b"].float()  # [B, A]
    return t


def _hop_bwd_core(mp, t, dmerge_d, dc_in, dh_in, mm, dd, fm=None, dfeats=False):
    """Backward of one hop (``_hop_bwd_core``, :170-276): the cotangent chain,
    the feats-path weight grads (biases 1-D here) and the emissions, with
    product type ``dd``; with ``dfeats`` also the features' gradient of the
    hop, ``fm`` (dpre_i Wi^T), under ``DFEATS``.  Returns (emissions, grads,
    dc_prev, dh_prev)."""
    def dotT(x, w):
        # x @ w^T (:185-189)
        return _rnd(x, dd) @ _rnd(w, dd).T

    def gradw2(a, b):
        # a^T @ b over [N, in] x [N, out] (:191-195)
        return _rnd(a, dd).T @ _rnd(b, dd)

    B, S, Dc = t["feats_d"].shape
    M = t["join"].shape[-1]
    F = t["qatt"].shape[-1]
    em: Dict[str, torch.Tensor] = {}
    gw: Dict[Tuple, torch.Tensor] = {}

    dmerge_pre = dmerge_d * mm if mm is not None else dmerge_d
    em["dmerge_pre"] = dmerge_pre
    em["merge_d"] = t["merge_d"].to(dd)
    djoin = dmerge_pre
    dh_new = dotT(dmerge_pre, mp["merge"]["w"]) + dh_in
    # ATTLSTM cell backward
    do_g = dh_new * t["tanh_c"]
    dc_new = dh_new * t["o_g"] * (1.0 - t["tanh_c"] ** 2) + dc_in
    df_g = dc_new * t["c_prev"]
    dc_prev = dc_new * t["f_g"]
    di_g = dc_new * t["g_t"]
    dg_t = dc_new * t["i_g"]
    dgates = torch.cat([
        di_g * t["i_g"] * (1.0 - t["i_g"]),
        dg_t * (1.0 - t["g_t"] ** 2),
        df_g * t["f_g"] * (1.0 - t["f_g"]),
        do_g * t["o_g"] * (1.0 - t["o_g"]),
    ], dim=1)                                                     # [B, 4R]
    em["dgates"] = dgates
    em["join"] = t["join"].to(dd)
    lp = mp["attlstm"]["layers"][0]
    djoin = djoin + dotT(dgates, lp["wi"])
    dh_prev = dotT(dgates, lp["wh"])
    # join = qfeat + attfeat + attprob @ Wp + bp
    em["djoin"] = djoin
    dattprob = dotT(djoin, mp["attprob_proj"]["w"])               # [B, S]
    # attfeat = sum_s ifeat * attprob, on unrounded values
    dattprob = dattprob + torch.sum(t["ifeat"] * djoin[:, None, :], dim=2)
    difeat = t["attprob"][:, :, None] * djoin[:, None, :]         # [B, S, M]
    dattscore = t["attprob"] * (
        dattprob - torch.sum(dattprob * t["attprob"], dim=1, keepdim=True))
    em["dscore_att"] = dattscore
    dh_prev = dh_prev + dotT(dattscore, mp["att_mem"]["w"])
    gw[("att_score", "w")] = gradw2(t["addfeat"].reshape(B * S, F),
                                    dattscore.reshape(B * S, 1))  # [F, 1]
    # the float32 value of the weight, unrounded (:251-252)
    daddfeat = dattscore[:, :, None] * mp["att_score"]["w"].float().reshape(1, 1, F)
    # addfeat = tanh(iatt + qatt)
    dpre_add = daddfeat * (1.0 - t["addfeat"] ** 2)               # [B, S, F]
    dqatt = torch.sum(dpre_add, dim=1)                            # [B, F]
    em["dqatt"] = dqatt
    em["qfeat"] = t["qfeat"].to(dd)
    dqfeat = djoin + dotT(dqatt, mp["att_q"]["w"])
    dpre_q = dqfeat * (1.0 - t["qfeat"] ** 2)                     # [B, M]
    em["dpre_q"] = dpre_q
    dh_prev = dh_prev + dotT(dpre_q, mp["h_proj"]["w"])
    # iatt = ifeat @ Wa + ba
    difeat = difeat + dotT(dpre_add.reshape(B * S, F), mp["att_i"]["w"]).reshape(B, S, M)
    gw[("att_i", "w")] = gradw2(t["ifeat"].reshape(B * S, M), dpre_add.reshape(B * S, F))
    gw[("att_i", "b")] = dpre_add.reshape(B * S, F).sum(0)
    # ifeat = tanh(feats_d @ Wi + bi)
    dpre_i = difeat * (1.0 - t["ifeat"] ** 2)                     # [B, S, M]
    gw[("i_embed", "w")] = gradw2(t["feats_d"].reshape(B * S, Dc), dpre_i.reshape(B * S, M))
    gw[("i_embed", "b")] = dpre_i.reshape(B * S, M).sum(0)
    if dfeats:
        # feats_d = feats fm; prei = feats_d Wi + bi
        dx = dotT(dpre_i.reshape(B * S, M), mp["i_embed"]["w"]).reshape(B, S, Dc)
        gw[DFEATS] = dx * fm if fm is not None else dx
    return em, gw, dc_prev, dh_prev


def _shapes(cfg: ModelConfig, q, feats):
    B, S, Dc = feats.shape
    return (B, S, Dc), (B, q.shape[1]), (B, cfg.multfeat_dim)


def train_hops_fwd_reference(mp: Dict, cfg: ModelConfig, q, feats, seed, row0: int = 0):
    """Plain version of the forward kernel: (scores [H, B, A], do_pred
    [H, B], attprob [H, B, S], c_all [H+1, B, R], h_all [H+1, B, R]), all
    float32, with the products in ``cfg.compute_dtype``; the rows are the
    global batch's from ``row0`` on, which keys their masks."""
    dd = dot_dtype(cfg)
    B = q.shape[0]
    c = torch.zeros(B, cfg.att_state_dim, device=q.device)
    h = torch.zeros(B, cfg.att_state_dim, device=q.device)
    scores, dopreds, attprobs, cs, hs = [], [], [], [c], [h]
    for hop in range(cfg.n_hops):
        fm, qm, mm = _masks(cfg, _shapes(cfg, q, feats), seed, hop, row0)
        t = _hop_fwd_core(mp, q, feats, c, h, fm, qm, mm, dd)
        dopreds.append(torch.sigmoid(_dot(t["merge_d"], mp["do_pred"]["w"], dd)[:, 0]
                                     + mp["do_pred"]["b"].float()[0]))
        scores.append(t["score"])
        attprobs.append(t["attprob"])
        c, h = t["c_new"], t["h_new"]
        cs.append(c)
        hs.append(h)
    return (torch.stack(scores), torch.stack(dopreds), torch.stack(attprobs),
            torch.stack(cs), torch.stack(hs))


def rau_train_hops_reference(mp: Dict, cfg: ModelConfig, q, feats, seed, row0: int = 0):
    """The training hop loop with the fused path's exact masks, in plain
    PyTorch and differentiable by autograd: (scores, do_pred, attprob,
    final_c, final_h).  In bfloat16 its gradient is JAX's autodiff of its
    own reference (``_RoundedDot``)."""
    check_fused_config(cfg)
    seed = _seed_tensor(seed, q.device)
    scores, do_pred, attprob, c_all, h_all = train_hops_fwd_reference(
        mp, cfg, q, feats, seed, row0)
    return scores, do_pred, attprob, c_all[-1], h_all[-1]


def train_hops_bwd_reference(mp: Dict, cfg: ModelConfig, q, feats, seed,
                             c_all, h_all, gmerge, dfeats: bool = False, row0: int = 0):
    """Plain version of the backward kernel: the hops in reverse from the
    saved carries.  Returns (emissions {name: [H, B, width]}, the feats-path
    grads {path: tensor}, float32); with ``dfeats`` the grads also hold the
    features' gradient under ``DFEATS``, summed over the hops in the
    kernel's order."""
    dd = dot_dtype(cfg)
    H = cfg.n_hops
    shapes = _shapes(cfg, q, feats)
    dc = torch.zeros_like(c_all[0])
    dh = torch.zeros_like(h_all[0])
    ems = [None] * H
    gw_in: Dict[Tuple, torch.Tensor] = {}
    for hop in reversed(range(H)):
        fm, qm, mm = _masks(cfg, shapes, seed, hop, row0)
        t = _hop_fwd_core(mp, q, feats, c_all[hop], h_all[hop], fm, qm, mm, dd)
        ems[hop], gw, dc, dh = _hop_bwd_core(mp, t, gmerge[hop], dc, dh, mm, dd, fm, dfeats)
        for path, g in gw.items():
            gw_in[path] = gw_in[path] + g if path in gw_in else g
    em = {name: torch.stack([e[name] for e in ems]) for name, _, _ in _EMITS}
    return em, gw_in


def _outside_grads(cfg: ModelConfig, mp, q, seed, h_all, attprob, g_scores, em, row0=0):
    """The weight grads of the non-feats path, and dq, float32, as products
    over the emissions stacked ``[H*B, *]`` (``_outside_grads``, :539-595):
    float32 ``matmul``s on operands rounded to the product type."""
    dd = dot_dtype(cfg)
    H = cfg.n_hops
    B, Q = q.shape
    rate = cfg.mult_dropout

    def gemm(act, cot):
        # act [H, B, in], cot [H, B, out] -> [in, out]
        return (_rnd(act.reshape(-1, act.shape[-1]), dd).T
                @ _rnd(cot.reshape(-1, cot.shape[-1]), dd))

    h_in = h_all[:H]                       # state entering each hop
    h_out = h_all[1:]                      # state leaving each hop
    if rate > 0.0:
        qmask = torch.stack([
            dropout_scale_mask((B, Q), row0, site_salt(seed, h, _SITE_Q), rate)
            for h in range(H)])            # [H, B, Q]
        q_d = q.float()[None] * qmask
    else:
        qmask = None
        q_d = q.float()[None].expand(H, B, Q)

    def rowsum(x):
        return x.sum(dim=(0, 1))

    gw = {}
    gw[("q_proj", "w")] = gemm(q_d, em["dpre_q"])
    gw[("q_proj", "b")] = rowsum(em["dpre_q"])
    gw[("h_proj", "w")] = gemm(h_in, em["dpre_q"])
    gw[("h_proj", "b")] = gw[("q_proj", "b")]
    gw[("att_q", "w")] = gemm(em["qfeat"], em["dqatt"])
    gw[("att_q", "b")] = rowsum(em["dqatt"])
    gw[("att_score", "b")] = em["dscore_att"].sum().reshape(1)
    gw[("att_mem", "w")] = gemm(h_in, em["dscore_att"])
    gw[("att_mem", "b")] = rowsum(em["dscore_att"])
    gw[("attprob_proj", "w")] = gemm(attprob, em["djoin"])
    gw[("attprob_proj", "b")] = rowsum(em["djoin"])
    gw[("attlstm", "layers", 0, "wi")] = gemm(em["join"], em["dgates"])
    gw[("attlstm", "layers", 0, "bi")] = rowsum(em["dgates"])
    gw[("attlstm", "layers", 0, "wh")] = gemm(h_in, em["dgates"])
    gw[("attlstm", "layers", 0, "bh")] = gw[("attlstm", "layers", 0, "bi")]
    gw[("merge", "w")] = gemm(h_out, em["dmerge_pre"])
    gw[("merge", "b")] = rowsum(em["dmerge_pre"])
    gw[("cls", "w")] = gemm(em["merge_d"], g_scores)
    gw[("cls", "b")] = rowsum(g_scores)
    # dq: (dpre_q @ Wq^T) masked per hop, summed over hops
    p = (_rnd(em["dpre_q"].reshape(H * B, -1), dd)
         @ _rnd(mp["q_proj"]["w"], dd).T).reshape(H, B, Q)
    dq = torch.sum(p * qmask, dim=0) if qmask is not None else torch.sum(p, dim=0)
    return gw, dq


# ---------------------------------------------------------------------------
# The kernels' plans
# ---------------------------------------------------------------------------

# the tile GEMM's tiles (BM, BN, BK) by the body (csrc/tile_gemm.cuh): float32
# the FMA body, bfloat16 mma.sync; "big" for the [B*S, *] products and the
# split weight grads, "small" for the [B, *] ones; each a ring of
# GEMM_STAGES k-slices in shared memory, kept in float32 by the FMA body
# (whichever the operands' type) and in bf16 by mma.sync
GEMM_TILES = {torch.float32: {"big": (128, 128, 16), "small": (32, 32, 32)},
              torch.bfloat16: {"big": (128, 128, 32), "small": (32, 64, 64)}}
GEMM_STAGES = 3
KSTEP = 32                   # chunk_rows is a multiple of this (the launcher's KSTEP)
COLSUM_ROWS = 128            # rows a partial of the i_embed b grad (the launcher's)
ROWS_SMEM_LIMIT = 48 * 1024  # the row kernels' dynamic shared memory, no opt-in
EW_THREADS = 256             # threads a CTA of the elementwise and row kernels


def gemm_smem(dtype: torch.dtype, size: str) -> int:
    """The most dynamic shared memory a tile GEMM takes, in bytes: each
    operand's k-slice kept k-contiguous ([rows][BK + V]) or row-contiguous
    ([BK][rows + V]), V the elements of 16 bytes, whichever is larger."""
    e = 4 if dtype == torch.float32 else 2
    v = 16 // e
    bm, bn, bk = GEMM_TILES[dtype][size]
    slice_ = sum(max(r * (bk + v), bk * (r + v)) for r in (bm, bn))
    return GEMM_STAGES * slice_ * e


@dataclass(frozen=True)
class Phase:
    """One launch of a hop of either kernel: a tile GEMM ``out[M, N] =
    sum_K a b`` (``tile`` (BM, BN) set) over ``grid = (n tiles, m tiles, K
    chunks)``, or another kernel (``tile`` None) over ``grid``; ``smem`` its
    shared memory in bytes.  ``split`` marks the backward's weight grads,
    whose K (the B*S rows) is cut into the plan's chunks."""
    name: str
    M: int
    N: int
    K: int
    tile: Optional[Tuple[int, int]]
    grid: Tuple[int, int, int]
    smem: int
    split: bool = False


@dataclass(frozen=True)
class BwdPlan:
    """The backward kernel's launches for one shape: ``phases`` of one hop
    in the order the C entry enqueues them (every hop runs the same ones),
    the split-K chunks of the weight grads (``chunk_rows`` rows of B*S each,
    ``chunks`` of them), and ``work_floats``, the float32 workspace the
    wrapper allocates (ifeat and addfeat, overwritten by their cotangents).
    The scratch buffer is the launcher's to size (``launcher_plan``), which
    also reports the grids and shared memory that the card's checks hold
    these phases to."""
    phases: Tuple[Phase, ...]
    chunk_rows: int
    chunks: int
    work_floats: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class FwdPlan:
    """The forward kernel's launches for one shape: ``phases`` of one hop in
    the order the C entry enqueues them (every hop runs the same ones), and
    ``work_floats``, the float32 workspace the wrapper allocates (ifeat and
    addfeat of every row).  The scratch buffer is the launcher's to size
    (``fwd_launcher_plan``), which also reports the grids and shared memory
    that the card's checks hold these phases to."""
    phases: Tuple[Phase, ...]
    work_floats: int


def _check_dims(name: str, dtype: torch.dtype, dims: Dict[str, int], row_floats: int) -> None:
    """Raise ``ValueError`` for widths the kernel ``name`` cannot run: a
    product type other than float32 or bf16, a width below 1, offsets past
    32 bits, or ``row_floats`` floats a row kernel keeps in shared memory
    beyond ROWS_SMEM_LIMIT."""
    if dtype not in GEMM_TILES:
        raise ValueError(f"{name}: products in float32 or bfloat16, got {dtype}")
    bad = [k for k, v in dims.items() if v < 1]
    if bad:
        raise ValueError(f"{name}: {bad} must be at least 1, got {dims}")
    B, S = dims["B"], dims["S"]
    if (B * S * max(dims["Dc"], dims["M"], dims["F"]) >= 2 ** 31
            or B * max(dims["Q"], 4 * dims["R"]) >= 2 ** 31):
        raise ValueError(f"{name}: batch {B} too large for 32-bit offsets")
    if row_floats * 4 > ROWS_SMEM_LIMIT:
        raise ValueError(f"{name}: the row kernels hold {row_floats} floats "
                         f"in shared memory, at most {ROWS_SMEM_LIMIT // 4}")


def _phase_makers(body: torch.dtype, chunks: int = 1):
    """(gemm, other): the Phase of a tile GEMM ``gemm(name, M, N, K, size,
    split=False)`` on ``body``'s tiles (the GEMM_TILES key) and of another
    kernel ``other(name, grid, shared=0)``."""
    def gemm(name, m, n, k, size, split=False):
        bm, bn, _ = GEMM_TILES[body][size]
        z = chunks if split else 1
        return Phase(name, m, n, k, (bm, bn), (_cdiv(n, bn), _cdiv(m, bm), z),
                     gemm_smem(body, size), split)

    def other(name, grid, shared=0):
        return Phase(name, 0, 0, 0, None, grid, shared)

    return gemm, other


def _hop_forward_phases(B, S, Dc, M, F, R, Q, dtype, gemm, other):
    """One hop's forward phases, prep to merge, as both kernels enqueue them
    (csrc/rau_train_hops_phases.cuh)."""
    P = B * S
    ew = EW_THREADS
    hb = 0 if dtype == torch.float32 else B * R   # h's bf16 copy
    return (
        other("prep", (min(_cdiv(B * Q + P * Dc + hb, ew), 4096), 1, 1)),
        gemm("q_d Wq", B, M, Q, "small"),
        gemm("h Wmem", B, S, R, "small"),
        gemm("qfeat", B, M, R, "small"),
        gemm("qatt", B, F, M, "small"),
        gemm("ifeat", P, M, Dc, "big"),
        gemm("addfeat", P, F, M, "big"),
        other("rows_fwd", (B, 1, 1), S * 4),
        gemm("join", B, M, S, "small"),
        gemm("join Wli", B, 4 * R, M, "small"),
        gemm("gates", B, 4 * R, R, "small"),
        other("cell", (_cdiv(B * R, ew), 1, 1)),
        gemm("merge", B, M, R, "small"),
    )


def fwd_plan(B: int, S: int, Dc: int, M: int, F: int, R: int, Q: int, A: int, n_sm: int,
             dtype: torch.dtype = torch.float32) -> FwdPlan:
    """The phases, tiles and workspace of the forward kernel at these
    widths, for products in ``dtype`` on a card with ``n_sm`` SMs (its
    tiles do not depend on it; the backward's split does): the hop's
    forward phases, then the classifier ([B, A], K = M) and do_pred ([B,
    1], K = M, a sigmoid epilogue), each a small tile GEMM over merge_d.
    Every product takes the FMA body's tiles in both types: each output
    one float32 chain in ascending k, exact products of the rounded
    operands.  On mma.sync the tensor cores' truncated sums put the bf16
    forward beyond its one-hop bars against the plain version (PERF.md).
    Raises ``ValueError`` for shapes the kernel does not take."""
    _check_dims("train_hops_fwd", dtype, dict(B=B, S=S, Dc=Dc, M=M, F=F, R=R, Q=Q, A=A,
                                              n_sm=n_sm), S)
    gemm, other = _phase_makers(torch.float32)
    phases = _hop_forward_phases(B, S, Dc, M, F, R, Q, dtype, gemm, other) + (
        gemm("classifier", B, A, M, "small"),
        gemm("do_pred", B, 1, M, "small"),
    )
    return FwdPlan(phases, B * S * (M + F))


def bwd_plan(B: int, S: int, Dc: int, M: int, F: int, R: int, Q: int, n_sm: int,
             dtype: torch.dtype = torch.float32, dfeats: bool = False) -> BwdPlan:
    """The phases, tiles, split-K chunks and workspace of the backward
    kernel at these widths, for products in ``dtype`` on a card with
    ``n_sm`` SMs; ``dfeats`` adds the features' gradient, one [B*S, Dc]
    product a hop after dpre_i.  The weight grads' B*S rows split into
    chunks such that the i_embed w grad fills about two CTAs a SM.  Raises
    ``ValueError`` for shapes the kernel does not take."""
    _check_dims("train_hops_bwd", dtype, dict(B=B, S=S, Dc=Dc, M=M, F=F, R=R, Q=Q,
                                              n_sm=n_sm), M + S)
    P = B * S
    big_m, big_n, _ = GEMM_TILES[dtype]["big"]
    target = _cdiv(2 * n_sm, _cdiv(Dc, big_m) * _cdiv(M, big_n))
    chunk_rows = _cdiv(_cdiv(P, target), KSTEP) * KSTEP
    chunks = _cdiv(P, chunk_rows)
    if chunks > 65535:
        raise ValueError(f"train_hops_bwd: {chunks} chunks exceed the grid's 65535")
    gemm, other = _phase_makers(dtype, chunks)
    ew = EW_THREADS
    phases = _hop_forward_phases(B, S, Dc, M, F, R, Q, dtype, gemm, other) + (
        gemm("dh_new", B, R, M, "small"),
        other("cell_bwd", (_cdiv(B * R, ew), 1, 1)),
        gemm("djoin", B, M, 4 * R, "small"),
        gemm("dh_prev", B, R, 4 * R, "small"),
        gemm("djoin Wp^T", B, S, M, "small"),
        other("softmax_bwd", (B, 1, 1), (M + S) * 4),
        other("dpre_add", (B, _cdiv(F, 32), 1), 2 * 8 * 32 * 4),
        gemm("dscore Wmem^T", B, R, S, "small"),
        gemm("dpre_q", B, M, F, "small"),
        gemm("dh", B, R, M, "small"),
        gemm("att_i w", M, F, P, "big", split=True),
        gemm("dpre_i", P, M, F, "big"),
    ) + ((gemm("dfeats", P, Dc, M, "big"),) if dfeats else ()) + (
        gemm("i_embed w", Dc, M, P, "big", split=True),
        other("colsum", (_cdiv(M, ew), _cdiv(P, COLSUM_ROWS), 1)),
        other("reduce", (_cdiv(Dc * M + M + M * F + 2 * F, ew), 1, 1)),
    )
    return BwdPlan(phases, chunk_rows, chunks, P * (M + F))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_cuda(name: str, cfg: ModelConfig, mp, q, feats, seed, extra=()):
    """Raise unless every input is what the kernels take: ``q``, ``feats``
    and the weights in the product type; returns the dimensions."""
    dd = dot_dtype(cfg)
    d = dict(B=q.shape[0], Q=cfg.rnnout_dim, S=cfg.cnn_spat, Dc=cfg.cnn_dim,
             M=cfg.multfeat_dim, F=cfg.attfeat_dim, R=cfg.att_state_dim,
             A=cfg.answer_size, H=cfg.n_hops)
    B, Q, S, Dc, M, F = (d[k] for k in ("B", "Q", "S", "Dc", "M", "F"))
    shapes = mult_shapes(cfg)
    checks = [("q", q, dd, (B, Q)),
              ("feats", feats, dd, (B, S, Dc)),
              ("seed", seed, torch.int32, (1,))]
    checks += [("/".join(map(str, p)), pluck(mp, p), dd, shapes[p])
               for p in _FWD_WEIGHTS]
    checks += list(extra)
    for what, t, dtype, shape in checks:
        if (t.dtype != dtype or tuple(t.shape) != tuple(shape)
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"{name}: {what} must be contiguous {dtype} "
                             f"{tuple(shape)} on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if B * S * Dc >= 2 ** 31 or B * S * (M + F) >= 2 ** 31:
        raise ValueError(f"{name}: batch {B} too large for 32-bit offsets")
    return d


def _dropout_args(cfg: ModelConfig, row0: int):
    """(threshold, scale, on, row0) of the kernels' dropout."""
    rate = cfg.mult_dropout
    if rate <= 0.0:
        return (0, 1.0, 0, row0)
    return (mask_threshold(rate), mask_scale(rate), 1, row0)


def _weight_ptrs(mp):
    ws = [pluck(mp, p) for p in _FWD_WEIGHTS]
    return (_P * len(ws))(*[w.data_ptr() for w in ws])


def _on_cuda(name: str, q) -> bool:
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    return True


def train_hops_fwd(mp: Dict, cfg: ModelConfig, q, feats, seed, row0: int = 0):
    """The forward kernel: (scores [H, B, A], do_pred [H, B], attprob
    [H, B, S], c_all [H+1, B, R], h_all [H+1, B, R]), float32.  ``q``,
    ``feats`` and the weights in ``cfg.compute_dtype``; ``seed`` one int32
    on ``q``'s device; ``row0`` the global batch's row of ``q``'s first,
    which keys the masks.  CPU tensors run ``train_hops_fwd_reference``."""
    if not _on_cuda("train_hops_fwd", q):
        return train_hops_fwd_reference(mp, cfg, q, feats, seed, row0)
    dd = dot_dtype(cfg)
    widths = (q.shape[0], cfg.cnn_spat, cfg.cnn_dim, cfg.multfeat_dim, cfg.attfeat_dim,
              cfg.att_state_dim, cfg.rnnout_dim, cfg.answer_size)
    fwd_plan(*widths, _sm_count(q.device.index or 0), dd)
    scratch_floats, _ = fwd_launcher_plan(*widths, dd)
    if scratch_floats < 0:
        raise ValueError(f"train_hops_fwd: the launcher cannot run batch {widths[0]} "
                         f"at these widths")
    return _launch_fwd(mp, cfg, q, feats, seed, scratch_floats, row0)


def _launch_fwd(mp: Dict, cfg: ModelConfig, q, feats, seed, scratch_floats: int,
                row0: int = 0):
    """``train_hops_fwd`` on CUDA tensors with this much scratch; raises
    where the launcher refuses it."""
    d = _check_cuda("train_hops_fwd", cfg, mp, q, feats, seed)
    B, S, M, F, R, A, H = (d[k] for k in "BSMFRAH")
    dev = q.device
    work = torch.empty(B * S * (M + F), device=dev, dtype=torch.float32)
    scratch = torch.empty(max(scratch_floats, 0), device=dev, dtype=torch.float32)
    scores = torch.empty(H, B, A, device=dev, dtype=torch.float32)
    do_pred = torch.empty(H, B, device=dev, dtype=torch.float32)
    attprob = torch.empty(H, B, S, device=dev, dtype=torch.float32)
    c_all = torch.empty(H + 1, B, R, device=dev, dtype=torch.float32)
    h_all = torch.empty(H + 1, B, R, device=dev, dtype=torch.float32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _KERNELS[dot_dtype(cfg)][0].launch(
        q.data_ptr(), feats.data_ptr(), seed.data_ptr(), _weight_ptrs(mp),
        work.data_ptr(), scores.data_ptr(), do_pred.data_ptr(), attprob.data_ptr(),
        c_all.data_ptr(), h_all.data_ptr(), scratch.data_ptr(), B, d["Q"], S, d["Dc"], M,
        F, R, A, H, scratch_floats, *_dropout_args(cfg, row0), stream)
    return scores, do_pred, attprob, c_all, h_all


def train_hops_bwd(mp: Dict, cfg: ModelConfig, q, feats, seed, c_all, h_all, gmerge,
                   dfeats: bool = False, row0: int = 0):
    """The backward kernel: (emissions {name: [H, B, width]}, the feats-path
    grads {path: tensor} summed over the rows and hops, float32); with
    ``dfeats`` the grads also hold the features' gradient [B, S, Dc] under
    ``DFEATS``, float32, and the launch counts in ``BWD_DFEATS_KERNEL`` /
    ``BWD_DFEATS_BF16_KERNEL``.  ``q``, ``feats`` and the weights in
    ``cfg.compute_dtype``; ``gmerge`` is the score cotangent times
    ``cls_w^T``, [H, B, M] float32; ``row0`` as ``train_hops_fwd``'s.
    CPU tensors run ``train_hops_bwd_reference``."""
    if not _on_cuda("train_hops_bwd", q):
        return train_hops_bwd_reference(mp, cfg, q, feats, seed, c_all, h_all,
                                        gmerge, dfeats, row0)
    B, S = feats.shape[:2]
    dd = dot_dtype(cfg)
    plan = bwd_plan(B, S, cfg.cnn_dim, cfg.multfeat_dim, cfg.attfeat_dim, cfg.att_state_dim,
                    cfg.rnnout_dim, _sm_count(q.device.index or 0), dd, dfeats)
    scratch_floats, _ = launcher_plan(B, S, cfg.cnn_dim, cfg.multfeat_dim, cfg.attfeat_dim,
                                      cfg.att_state_dim, cfg.rnnout_dim, dd, plan.chunk_rows,
                                      dfeats)
    if scratch_floats < 0:
        raise ValueError(f"train_hops_bwd: the launcher cannot run batch {B} at these widths")
    return _launch_bwd(mp, cfg, q, feats, seed, c_all, h_all, gmerge, plan.chunk_rows,
                       scratch_floats, dfeats, row0)


def _launch_bwd(mp: Dict, cfg: ModelConfig, q, feats, seed, c_all, h_all, gmerge,
                chunk_rows: int, scratch_floats: int, dfeats: bool = False, row0: int = 0):
    """``train_hops_bwd`` on CUDA tensors with this split of the weight
    grads' rows and this much scratch; raises where the launcher refuses
    them."""
    B, S = feats.shape[:2]
    H, R, M = cfg.n_hops, cfg.att_state_dim, cfg.multfeat_dim
    d = _check_cuda("train_hops_bwd", cfg, mp, q, feats, seed, extra=[
        ("c_all", c_all, torch.float32, (H + 1, B, R)),
        ("h_all", h_all, torch.float32, (H + 1, B, R)),
        ("gmerge", gmerge, torch.float32, (H, B, M))])
    Q, Dc, F = d["Q"], d["Dc"], d["F"]
    dd = dot_dtype(cfg)
    dev = q.device
    widths = {"M": M, "F": F, "S": S, "G": 4 * R}
    em = {name: torch.empty(H, B, widths[w], device=dev,
                            dtype=torch.float32 if cot else dd)
          for name, w, cot in _EMITS}
    shapes = {("i_embed", "w"): (Dc, M), ("i_embed", "b"): (M,),
              ("att_i", "w"): (M, F), ("att_i", "b"): (F,),
              ("att_score", "w"): (F, 1)}
    gw_in = {p: torch.empty(shapes[p], device=dev, dtype=torch.float32)
             for p in _INKERNEL_GRADS}
    df = torch.empty(B, S, Dc, device=dev, dtype=torch.float32) if dfeats else None
    work = torch.empty(B * S * (M + F), device=dev, dtype=torch.float32)
    scratch = torch.empty(max(scratch_floats, 0), device=dev, dtype=torch.float32)
    em_ptrs = (_P * len(_EMITS))(*[em[n].data_ptr() for n, _, _ in _EMITS])
    grad_ptrs = (_P * len(gw_in))(*[gw_in[p].data_ptr() for p in _INKERNEL_GRADS])
    stream = torch.cuda.current_stream(dev).cuda_stream
    kernel = _DFEATS_KERNELS[dd] if dfeats else _KERNELS[dd][1]
    kernel.launch(
        q.data_ptr(), feats.data_ptr(), seed.data_ptr(), c_all.data_ptr(),
        h_all.data_ptr(), gmerge.data_ptr(), _weight_ptrs(mp), work.data_ptr(),
        em_ptrs, grad_ptrs, None if df is None else df.data_ptr(), scratch.data_ptr(),
        B, Q, S, Dc, M, F, R, H, chunk_rows, scratch_floats, *_dropout_args(cfg, row0),
        stream)
    if df is not None:
        gw_in[DFEATS] = df
    return em, gw_in


def _describe(kernel: Kernel, fn: str, ints) -> Tuple[int, Tuple]:
    """A dry run of a C entry (``fn``, its ints, then the launches' buffer):
    (the scratch floats it carves, -1 where it cannot run them; each
    launch's (grid x, y, z, dynamic shared memory bytes), in the order it
    enqueues them)."""
    cap = 64
    out = (_I * (4 * cap))()
    n = _I(0)
    describe = kernel.function(fn, [_I] * len(ints) + [ctypes.POINTER(_I), _I,
                                                       ctypes.POINTER(_I)])
    scratch = describe(*ints, out, cap, ctypes.byref(n))
    return scratch, tuple(tuple(out[4 * i:4 * i + 4]) for i in range(min(n.value, cap)))


def _t_bytes(dtype: torch.dtype) -> int:
    return 4 if dtype == torch.float32 else 2


@functools.lru_cache(maxsize=64)
def fwd_launcher_plan(B: int, S: int, Dc: int, M: int, F: int, R: int, Q: int, A: int,
                      dtype: torch.dtype):
    """The built forward launcher's own account of one hop at these shapes
    (``train_hops_fwd_describe``, a dry run of its entry): (the scratch
    floats it carves, -1 where it cannot run them; each launch's (grid x,
    y, z, dynamic shared memory bytes), in the order it enqueues them)."""
    return _describe(FWD_KERNEL, "train_hops_fwd_describe",
                     (B, Q, S, Dc, M, F, R, A, _t_bytes(dtype)))


@functools.lru_cache(maxsize=64)
def launcher_plan(B: int, S: int, Dc: int, M: int, F: int, R: int, Q: int,
                  dtype: torch.dtype, chunk_rows: int, dfeats: bool = False):
    """The built backward launcher's own account of one hop at these shapes
    (``train_hops_bwd_describe``, a dry run of its entry), with the
    features' gradient or without, as ``fwd_launcher_plan``."""
    return _describe(BWD_KERNEL, "train_hops_bwd_describe",
                     (B, Q, S, Dc, M, F, R, _t_bytes(dtype), chunk_rows, int(dfeats)))


# ---------------------------------------------------------------------------
# The autograd Function
# ---------------------------------------------------------------------------

def _kernel_operands(cfg: ModelConfig, mp, q, feats):
    """``mp``, ``q`` and ``feats`` in the product type, as the kernels take
    them (JAX casts them so before its calls, :365, :404, :479, :530)."""
    dd = dot_dtype(cfg)
    mp_k = rebuild(_FWD_WEIGHTS, [pluck(mp, p).to(dd) for p in _FWD_WEIGHTS])
    return mp_k, q.to(dd), feats.to(dd)


def _bwd_kernel(cfg, mp, q, feats, seed, c_all, h_all, attprob, g_scores, dfeats=False,
                row0=0):
    """The hand-derived backward: the backward kernel (or its plain version)
    plus the outside products.  Returns ({path: grad} for _DIFF_WEIGHTS, dq,
    the features' gradient or None), float32."""
    dd = dot_dtype(cfg)
    H, B = g_scores.shape[:2]
    gmerge = (_rnd(g_scores.reshape(H * B, -1), dd)
              @ _rnd(mp["cls"]["w"], dd).T).reshape(H, B, -1)
    mp_k, q_k, feats_k = _kernel_operands(cfg, mp, q, feats)
    em, gw_in = train_hops_bwd(mp_k, cfg, q_k, feats_k, seed, c_all, h_all,
                               gmerge.contiguous(), dfeats, row0)
    gw_out, dq = _outside_grads(cfg, mp, q, seed, h_all, attprob, g_scores, em, row0)
    return ({p: (gw_in[p] if p in gw_in else gw_out[p]) for p in _DIFF_WEIGHTS}, dq,
            gw_in.get(DFEATS))


def _bwd_autograd(cfg, mp, q, feats, seed, g_scores, dfeats=False, row0=0):
    """The ``"xla"`` backward: autograd through the plain version, which
    regenerates the same masks; the features' gradient too with
    ``dfeats``."""
    with torch.enable_grad():
        leaves = [pluck(mp, p).detach().requires_grad_() for p in _DIFF_WEIGHTS]
        mp_ = rebuild(_DIFF_WEIGHTS, leaves)
        mp_["do_pred"] = mp["do_pred"]
        q_ = q.detach().requires_grad_()
        f_ = feats.detach().requires_grad_(dfeats)
        inputs = leaves + [q_] + ([f_] if dfeats else [])
        scores = rau_train_hops_reference(mp_, cfg, q_, f_, seed, row0)[0]
        grads = torch.autograd.grad(scores, inputs, g_scores)
    n = len(_DIFF_WEIGHTS)
    return dict(zip(_DIFF_WEIGHTS, grads[:n])), grads[n], grads[n + 1] if dfeats else None


class _FusedTrainHops(torch.autograd.Function):
    """(cfg, row0, seed, q, feats, *weights in _FWD_WEIGHTS order) ->
    (scores, do_pred, attprob, final_c, final_h); only ``scores`` is
    differentiable, in the weights, ``q`` and, where they require grad, the
    features.  Each grad comes back in its input's type."""

    @staticmethod
    def forward(ctx, cfg, row0, seed, q, feats, *weights):
        mp_k, q_k, feats_k = _kernel_operands(cfg, rebuild(_FWD_WEIGHTS, weights), q, feats)
        scores, do_pred, attprob, c_all, h_all = train_hops_fwd(
            mp_k, cfg, q_k, feats_k, seed, row0)
        ctx.cfg = cfg
        ctx.row0 = row0
        ctx.save_for_backward(seed, q, feats, c_all, h_all, attprob, *weights)
        fc, fh = c_all[-1].clone(), h_all[-1].clone()
        ctx.mark_non_differentiable(do_pred, attprob, fc, fh)
        return scores, do_pred, attprob, fc, fh

    @staticmethod
    def backward(ctx, g_scores, *unused):
        cfg = ctx.cfg
        seed, q, feats, c_all, h_all, attprob, *weights = ctx.saved_tensors
        mp = rebuild(_FWD_WEIGHTS, weights)
        g_scores = g_scores.contiguous()
        want = ctx.needs_input_grad[4]
        if cfg.fused_train_bwd == "xla":
            grads, dq, df = _bwd_autograd(cfg, mp, q, feats, seed, g_scores, want, ctx.row0)
        else:
            grads, dq, df = _bwd_kernel(cfg, mp, q, feats, seed, c_all, h_all,
                                        attprob, g_scores, want, ctx.row0)
        dw = [grads[p].to(w.dtype) if p in grads else torch.zeros_like(w)
              for p, w in zip(_FWD_WEIGHTS, weights)]
        return (None, None, None, dq.to(q.dtype),
                None if df is None else df.to(feats.dtype), *dw)


def rau_train_hops(mp: Dict, cfg: ModelConfig, q, feats, seed, row0: int = 0):
    """The fused training hop loop: (scores [H, B, A], do_pred [H, B],
    attprob [H, B, S], final_c, final_h), float32.  Differentiable through
    ``scores`` only: in ``mp``, ``q`` and, where they require grad, in
    ``feats`` (backbone fine-tuning), as JAX's autodiff of its plain loop.
    ``seed``: an int or an int32 tensor; the masks of hop h are those of
    ``site_salt(seed, h, site)`` at each element's global index: ``q``'s
    rows are the global batch's from ``row0`` on (a rank's or a
    microbatch's rows of a sharded step).  Products in
    ``cfg.compute_dtype``."""
    check_fused_config(cfg)
    if cfg.fused_train_bwd == "reference":
        return rau_train_hops_reference(mp, cfg, q, feats, seed, row0)
    seed = _seed_tensor(seed, q.device)
    weights = [pluck(mp, p) for p in _FWD_WEIGHTS]
    return _FusedTrainHops.apply(cfg, int(row0), seed, q, feats, *weights)
