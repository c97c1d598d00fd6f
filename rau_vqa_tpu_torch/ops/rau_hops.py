"""The eval hop loop: a CUDA kernel and its plain version.

Counterpart of ``rau_vqa_tpu/ops/rau_hops.py``.  ``rau_hops`` runs all nHop
answering units in one launch of ``csrc/rau_hops.cu`` for CUDA tensors, and
``rau_hops_reference`` (the ``_hop_body`` math in plain PyTorch) for CPU
tensors.  The image embeddings ``ifeat`` / ``iatt`` are computed outside, as
in the JAX package.  The kernel takes its weights in bf16, cast once by
``pack_hop_weights``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch

from rau_vqa_tpu_torch.config import ModelConfig
from rau_vqa_tpu_torch.convert import map_tree
from rau_vqa_tpu_torch.ops._build import Kernel
from rau_vqa_tpu_torch.ops.lstm_encoder import dot
from rau_vqa_tpu_torch.ops.treeflat import mult_shapes, pluck

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = Kernel("rau_hops", "rau_hops_launch",
                [_P, _P, _P, ctypes.POINTER(_P), _P, _P, _P] + [_I] * 8 + [_P])

# the kernel's weight order, as rau_vqa_tpu/ops/rau_hops.py _WEIGHT_ORDER
WEIGHT_ORDER: Sequence[Tuple] = (
    ("q_proj", "w"), ("q_proj", "b"), ("h_proj", "w"), ("h_proj", "b"),
    ("att_q", "w"), ("att_q", "b"), ("att_score", "w"), ("att_score", "b"),
    ("att_mem", "w"), ("att_mem", "b"),
    ("attprob_proj", "w"), ("attprob_proj", "b"),
    ("attlstm", "layers", 0, "wi"), ("attlstm", "layers", 0, "bi"),
    ("attlstm", "layers", 0, "wh"), ("attlstm", "layers", 0, "bh"),
    ("merge", "w"), ("merge", "b"), ("cls", "w"), ("cls", "b"),
    ("do_pred", "w"), ("do_pred", "b"),
)


# the groups of the ``mult`` tree that the hop loop reads
_GROUPS = tuple(dict.fromkeys(path[0] for path in WEIGHT_ORDER))


def pack_hop_weights(mp: Dict) -> Dict:
    """The hop loop's weights in bf16, contiguous, in the ``mult`` tree's
    layout (the Pallas wrapper casts the same tensors per call)."""
    return map_tree(lambda w: w.to(torch.bfloat16).contiguous(),
                    {k: mp[k] for k in _GROUPS})


def _hop_body(mp, q, ifeat, iatt, c, h, dot_dtype):
    """One answering-unit hop (``_hop_body``, rau_hops.py:39-80)."""
    def d(x, w):
        return dot(x, w, dot_dtype)

    qfeat = torch.tanh(d(q, mp["q_proj"]["w"]) + mp["q_proj"]["b"]
                       + d(h, mp["h_proj"]["w"]) + mp["h_proj"]["b"])
    qatt = d(qfeat, mp["att_q"]["w"]) + mp["att_q"]["b"]            # [B, F]
    addfeat = torch.tanh(iatt + qatt[:, None, :])                    # [B, S, F]
    B, S, F = addfeat.shape
    score_c = d(addfeat.reshape(B * S, F), mp["att_score"]["w"]).reshape(B, S)
    attscore = (score_c + mp["att_score"]["b"][0]
                + d(h, mp["att_mem"]["w"]) + mp["att_mem"]["b"])
    attprob = torch.softmax(attscore, dim=-1)                        # [B, S]
    attfeat = torch.sum(ifeat * attprob[:, :, None], dim=1)
    join = (qfeat + attfeat
            + d(attprob, mp["attprob_proj"]["w"]) + mp["attprob_proj"]["b"])
    lp = mp["attlstm"]["layers"][0]
    R = c.shape[-1]
    gates = d(join, lp["wi"]) + lp["bi"] + d(h, lp["wh"]) + lp["bh"]
    i_g = torch.sigmoid(gates[:, :R])
    g_t = torch.tanh(gates[:, R:2 * R])
    f_g = torch.sigmoid(gates[:, 2 * R:3 * R])
    o_g = torch.sigmoid(gates[:, 3 * R:])
    c = f_g * c + i_g * g_t
    h = o_g * torch.tanh(c)
    merge = join + d(h, mp["merge"]["w"]) + mp["merge"]["b"]
    score = d(merge, mp["cls"]["w"]) + mp["cls"]["b"]
    do_pred = torch.sigmoid(d(merge, mp["do_pred"]["w"])[:, 0]
                            + mp["do_pred"]["b"][0])
    return score, do_pred, attprob, c, h


def rau_hops_reference(mp: Dict, cfg: ModelConfig, q: torch.Tensor,
                       ifeat: torch.Tensor, iatt: torch.Tensor, *,
                       dot_dtype: torch.dtype = torch.float32):
    """Plain hop loop on precomputed image embeddings (eval mode):
    q [B, Q], ifeat [B, S, M], iatt [B, S, F] -> (scores [H, B, A],
    do_pred [H, B], attprob [H, B, S]), all float32."""
    mp = map_tree(lambda w: w.float(), {k: mp[k] for k in _GROUPS})
    q, ifeat, iatt = q.float(), ifeat.float(), iatt.float()
    B = q.shape[0]
    c = q.new_zeros(B, cfg.att_state_dim)
    h = q.new_zeros(B, cfg.att_state_dim)
    scores, do_preds, attprobs = [], [], []
    for _ in range(cfg.n_hops):
        s, d, a, c, h = _hop_body(mp, q, ifeat, iatt, c, h, dot_dtype)
        scores.append(s)
        do_preds.append(d)
        attprobs.append(a)
    return torch.stack(scores), torch.stack(do_preds), torch.stack(attprobs)


def rau_hops(hw: Dict, cfg: ModelConfig, q: torch.Tensor, ifeat: torch.Tensor,
             iatt: torch.Tensor):
    """The hop loop.  ``hw`` comes from ``pack_hop_weights``; ``ifeat`` and
    ``iatt`` are bf16, as the Pallas wrapper casts them.

    CUDA tensors launch the kernel (or raise); CPU tensors run
    ``rau_hops_reference`` with bf16 dots, the kernel's arithmetic."""
    if q.device.type == "cpu":
        return rau_hops_reference(hw, cfg, q, ifeat, iatt,
                                  dot_dtype=torch.bfloat16)
    if q.device.type != "cuda":
        raise ValueError(f"rau_hops: unsupported device {q.device}")
    B, Q = q.shape[0], cfg.rnnout_dim
    S, M, F = cfg.cnn_spat, cfg.multfeat_dim, cfg.attfeat_dim
    R, A, H = cfg.att_rnn_size, cfg.answer_size, cfg.n_hops
    if cfg.att_rnn_layers != 1:
        raise ValueError("rau_hops: the kernel runs a 1-layer ATTLSTM, as the "
                         "Pallas kernel does")
    if F % 2:
        raise ValueError(f"rau_hops: attfeat_dim {F} must be even")
    checks = [("q", q, torch.float32, (B, Q)),
              ("ifeat", ifeat, torch.bfloat16, (B, S, M)),
              ("iatt", iatt, torch.bfloat16, (B, S, F))]
    shapes = mult_shapes(cfg)
    weights = [pluck(hw, path) for path in WEIGHT_ORDER]
    checks += [("/".join(map(str, path)), w, torch.bfloat16, shapes[path])
               for path, w in zip(WEIGHT_ORDER, weights)]
    for name, t, dtype, shape in checks:
        if (t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"rau_hops: {name} must be contiguous {dtype} "
                             f"{shape} on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    dev = q.device
    scores = torch.empty(H, B, A, device=dev, dtype=torch.float32)
    do_pred = torch.empty(H, B, device=dev, dtype=torch.float32)
    attprob = torch.empty(H, B, S, device=dev, dtype=torch.float32)
    ptrs = (_P * len(weights))(*[w.data_ptr() for w in weights])
    stream = torch.cuda.current_stream(dev).cuda_stream
    KERNEL.launch(q.data_ptr(), ifeat.data_ptr(), iatt.data_ptr(), ptrs,
                  scores.data_ptr(), do_pred.data_ptr(), attprob.data_ptr(),
                  B, Q, S, M, F, R, A, H, stream)
    return scores, do_pred, attprob
