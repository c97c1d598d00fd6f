"""Test-time prediction: the nHop+2 answer sets, and the serving step.

Counterpart of ``rau_vqa_tpu/eval/predict.py``.  ``predict`` is the plain
float32 path; ``predict_fused`` runs the question LSTM, the image embedding
and the hop loop through ``ops.lstm_encoder.lstm_encode``,
``ops.embed_image.embed_image`` and ``ops.rau_hops.rau_hops``, which launch
their CUDA kernels on CUDA tensors.  ``make_predict_step``
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
from rau_vqa_tpu_torch.models.rau import rau_forward
from rau_vqa_tpu_torch.ops.embed_image import embed_image, pack_embed_weights
from rau_vqa_tpu_torch.ops.lstm_encoder import (
    encode_question_fused,
    pack_encoder_weights,
)
from rau_vqa_tpu_torch.ops.rau_hops import pack_hop_weights, rau_hops
from rau_vqa_tpu_torch.utils.spans import span


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
    """The kernels' weights, prepared once per parameter set: the encoder's
    and the hop loop's in bf16, the image embedding's (on the card) split
    into the tf32 planes of 3xTF32."""
    return {"rnn": pack_encoder_weights(params["rnn"]),
            "mult": pack_hop_weights(params["mult"]),
            "embed": pack_embed_weights(params["mult"])}


def predict_fused(params, kernel_weights: Dict, cfg: ModelConfig, tokens,
                  lengths, feats, image=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Like ``predict``, with the question LSTM and the hop loop in their
    kernels (bf16 dots, f32 state) and the image embedding in its kernel
    (float32 products in 3xTF32, bf16 outputs); ``kernel_weights`` from
    ``pack_kernel_weights``.  ``image``: the embedding's (ifeat, iatt) of
    ``feats`` where the caller has enqueued it already.  The embedding
    gather stays a PyTorch operation, as it stays XLA in the JAX package.
    Its four parts are the spans ``predict.embed_image`` (with the bf16
    casts), ``predict.encoder``, ``predict.hops`` and ``predict.aggregate``."""
    if image is None:
        with span("predict.embed_image"):
            image = embed_image(params["mult"], kernel_weights["embed"], feats)
    with span("predict.encoder"):
        q = encode_question_fused(params, kernel_weights["rnn"], cfg, tokens,
                                  lengths.to(torch.int32))
    with span("predict.hops"):
        scores, do_pred, attprob = rau_hops(kernel_weights["mult"], cfg, q, *image)
    with span("predict.aggregate"):
        return _aggregate(scores, do_pred, attprob)


def _to_device(x, device: torch.device, dtype=None) -> torch.Tensor:
    """``x`` on ``device``; host data reaches the card through page-locked
    memory without blocking (the copy waits for nothing on the host)."""
    if device.type == "cuda" and not (torch.is_tensor(x) and x.device.type == "cuda"):
        host = torch.as_tensor(x, dtype=dtype)
        return host.pin_memory().to(device, non_blocking=True)
    return torch.as_tensor(x, device=device, dtype=dtype)


class PredictStep:
    """The serving step: (params, tokens, lengths, feats) -> (tab_pred,
    tab_att), on ``device``.

    Inputs may be numpy arrays or tensors; they are moved to ``device``.
    With ``buckets``, the token axis is cut to the smallest ladder entry that
    covers the batch's longest question (exact).  The kernels' weights
    are prepared on the first call with a parameter set and reused while the
    same object is passed (parameters are not changed in place at eval).
    A call is the span ``predict.step``, holding ``predict.place`` (the
    inputs to the device, the lengths' host copy, the bucket pick),
    ``predict.weights`` and ``predict_fused``'s spans.

    The step does not block the host on the card: host inputs are copied
    from page-locked memory without waiting, and the bucket is picked from
    the host's lengths.  Lengths that live on the card are copied back
    without blocking too, and the image embedding, which does not need
    them, is enqueued before the host waits for that copy, so that the card
    works through it while the host enqueues the rest (a second
    ``predict.place`` span holds the wait)."""

    def __init__(self, cfg: ModelConfig, buckets: Tuple[int, ...],
                 device: torch.device):
        self.cfg = cfg
        self.device = device
        self.ladder = bucket_ladder(cfg.seq_len, buckets) if buckets else None
        self._weights_for = MemoRecent(pack_kernel_weights)

    def __call__(self, params, tokens, lengths, feats):
        dev = self.device
        with span("predict.step"), torch.no_grad():
            with span("predict.place"):
                tokens = _to_device(tokens, dev)
                feats = _to_device(feats, dev, torch.float32)
                copied = None
                if torch.is_tensor(lengths) and lengths.device.type == "cuda":
                    if self.ladder is not None:
                        host = torch.empty(lengths.shape, dtype=lengths.dtype,
                                           pin_memory=True)
                        host.copy_(lengths, non_blocking=True)
                        copied = torch.cuda.Event()
                        copied.record()
                    lengths = lengths.to(dev)
                else:
                    host = torch.as_tensor(lengths)
                    lengths = _to_device(host, dev)
            with span("predict.weights"):
                weights = self._weights_for(params)
            with span("predict.embed_image"):
                image = embed_image(params["mult"], weights["embed"], feats)
            if self.ladder is not None:
                with span("predict.place"):
                    if copied is not None:
                        copied.synchronize()
                    tokens = tokens[:, :pick_bucket(self.ladder, int(host.max()))]
            return predict_fused(params, weights, self.cfg, tokens, lengths, feats, image)


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
