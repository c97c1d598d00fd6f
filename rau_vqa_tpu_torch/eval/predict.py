"""Test-time prediction: the nHop+2 answer sets, and the serving step.

Counterpart of ``rau_vqa_tpu/eval/predict.py``.  ``predict`` is the plain
float32 path; ``predict_fused`` runs the question LSTM and the hop loop
through ``ops.lstm_encoder.lstm_encode`` and ``ops.rau_hops.rau_hops``,
which launch their CUDA kernels on CUDA tensors.  ``make_predict_step``
builds the serving step; it runs on the card unless asked for the CPU.

Multiple-choice answering keeps the reference's mask-by-multiplication
(Ours_SS/LstmAttCtrlGradNoiseDontSelect.lua:884-895): non-candidates become
exactly 0, which can beat negative candidate logits.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from rau_vqa_tpu_torch.config import ModelConfig
from rau_vqa_tpu_torch.convert import MemoRecent
from rau_vqa_tpu_torch.devices import pick_device
from rau_vqa_tpu_torch.models.aggregate import select_aggregate
from rau_vqa_tpu_torch.models.rau import embed_image, rau_forward
from rau_vqa_tpu_torch.ops.lstm_encoder import (
    encode_question_fused,
    pack_encoder_weights,
)
from rau_vqa_tpu_torch.ops.rau_hops import pack_hop_weights, rau_hops


def _aggregate(scores, do_pred, attprob) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stack the per-hop, "uni" and "select" prediction/attention sets."""
    select_pred, gates = select_aggregate(scores, do_pred, force_final=True)
    select_att = torch.einsum("hbs,hb->bs", attprob, gates)
    tab_pred = torch.cat([scores, scores.mean(0)[None], select_pred[None]])
    tab_att = torch.cat([attprob, attprob.mean(0)[None], select_att[None]])
    return tab_pred, tab_att


def bucket_ladder(seq_len: int, buckets) -> list:
    """Sorted unique buckets < seq_len, with seq_len always appended."""
    ladder = sorted({int(b) for b in buckets if 0 < int(b) < seq_len})
    ladder.append(int(seq_len))
    return ladder


def pick_bucket(ladder, max_len: int) -> int:
    """Smallest ladder entry covering ``max_len`` (exact: steps past the last
    real token are discarded by the last-token gather)."""
    for t in ladder:
        if t >= max_len:
            return t
    raise ValueError(
        f"batch max length {max_len} exceeds the ladder top {ladder[-1]} — "
        f"lengths are inconsistent with this model's seq_len")


def predict(params, cfg: ModelConfig, tokens, lengths, feats
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain float32 path: (tab_pred [H+2, B, A], tab_att [H+2, B, S])."""
    out = rau_forward(params, cfg, tokens, lengths, feats, train=False)
    return _aggregate(out.scores, out.do_pred, out.attprob)


def pack_kernel_weights(params) -> Dict:
    """The two kernels' weights in bf16, cast once per parameter set."""
    return {"rnn": pack_encoder_weights(params["rnn"]),
            "mult": pack_hop_weights(params["mult"])}


def predict_fused(params, kernel_weights: Dict, cfg: ModelConfig, tokens,
                  lengths, feats) -> Tuple[torch.Tensor, torch.Tensor]:
    """Like ``predict``, with the question LSTM and the hop loop in the two
    kernels (bf16 dots, f32 state); ``kernel_weights`` from
    ``pack_kernel_weights``.  The embedding gather and ``embed_image`` stay
    PyTorch operations, as they stay XLA in the JAX package."""
    q = encode_question_fused(params, kernel_weights["rnn"], cfg, tokens,
                              lengths.to(torch.int32))
    ifeat, iatt = embed_image(params["mult"], feats)
    scores, do_pred, attprob = rau_hops(
        kernel_weights["mult"], cfg, q, ifeat.to(torch.bfloat16).contiguous(),
        iatt.to(torch.bfloat16).contiguous())
    return _aggregate(scores, do_pred, attprob)


class PredictStep:
    """The serving step: (params, tokens, lengths, feats) -> (tab_pred,
    tab_att), on ``device``.

    Inputs may be numpy arrays or tensors; they are moved to ``device``.
    With ``buckets``, the token axis is cut to the smallest ladder entry that
    covers the batch's longest question (exact).  The kernels' bf16 weights
    are cast on the first call with a parameter set and reused while the
    same object is passed (parameters are not changed in place at eval)."""

    def __init__(self, cfg: ModelConfig, buckets: Tuple[int, ...],
                 device: torch.device):
        self.cfg = cfg
        self.device = device
        self.ladder = bucket_ladder(cfg.seq_len, buckets) if buckets else None
        self._weights_for = MemoRecent(pack_kernel_weights)

    def __call__(self, params, tokens, lengths, feats):
        lengths_np = np.asarray(lengths.cpu() if torch.is_tensor(lengths)
                                else lengths)
        tokens = torch.as_tensor(tokens, device=self.device)
        lengths = torch.as_tensor(lengths_np, device=self.device)
        feats = torch.as_tensor(feats, device=self.device, dtype=torch.float32)
        if self.ladder is not None:
            T = pick_bucket(self.ladder, int(lengths_np.max()))
            tokens = tokens[:, :T]
        with torch.no_grad():
            return predict_fused(params, self._weights_for(params), self.cfg,
                                 tokens, lengths, feats)


def make_predict_step(cfg: ModelConfig, *, buckets: Tuple[int, ...] = (),
                      device=None) -> PredictStep:
    """The serving step on ``device``: ``cuda`` when None, and then it raises
    without a card.  Only an explicit ``device="cpu"`` runs on the CPU, where
    the kernels' wrappers run their plain versions."""
    return PredictStep(cfg, tuple(buckets), pick_device(device, "make_predict_step"))


def mc_mask(mc_answers: torch.Tensor, answer_size: int) -> torch.Tensor:
    """mc_answers [B, NMC] 0-based, -1 = absent -> 0/1 mask [B, A]."""
    valid = mc_answers >= 0
    idx = torch.where(valid, mc_answers, torch.zeros_like(mc_answers)).long()
    onehot = torch.nn.functional.one_hot(idx, answer_size).float()
    return torch.clamp((onehot * valid[..., None]).sum(1), 0.0, 1.0)


def compute_answers(tab_pred: torch.Tensor, mc_answers=None):
    """OE = argmax over all answers; MC = argmax over mask-multiplied scores
    (reference :893-899).  Returns ([H+2, B] oe, [H+2, B] mc or None)."""
    oe = torch.argmax(tab_pred, dim=-1)
    if mc_answers is None:
        return oe, None
    mask = mc_mask(torch.as_tensor(mc_answers, device=tab_pred.device),
                   tab_pred.shape[-1])
    mc = torch.argmax(tab_pred * mask[None], dim=-1)
    return oe, mc
