"""Joint loss over all answering hops, and the monitored metrics.

Counterpart of ``rau_vqa_tpu/train/losses.py``, with the reference's loss
semantics (Ours_SS/LstmAttCtrlGradNoiseDontSelect.lua:428-631):

- the differentiable loss is ``sum_h scale_h * CE(scores_h, y)`` (:568-577);
  ``scale_h`` is nHop for Ours_SS (:569), 1 for Ours_MS and a per-epoch 0/1
  curriculum for Ours_Full/ResNet (:586-589);
- the "uni" CE over hop-averaged logits (:521-530), the "select" CE over the
  first confident hop (:532-540) and the do_pred BCE (its gradient zeroed,
  :565-567) are monitors and carry no gradient.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from rau_vqa_tpu_torch.models.aggregate import select_aggregate


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over the leading (batch) axis: logits
    [..., B, A], labels [B] -> [...]."""
    logp = torch.log_softmax(logits, dim=-1)
    idx = labels.long().expand(logp.shape[:-1])[..., None]
    return -logp.gather(-1, idx)[..., 0].mean(-1)


def bce(probs: torch.Tensor, targets: torch.Tensor,
        eps: float = 1e-12) -> torch.Tensor:
    """Mean binary cross-entropy on probabilities over the last axis."""
    p = torch.clamp(probs, eps, 1.0 - eps)
    return -torch.mean(targets * torch.log(p) + (1.0 - targets) * torch.log1p(-p),
                       dim=-1)


def hop_grad_scale(n_hops: int, *, scale_by_nhop: bool,
                   stop_timing: Optional[Tuple[int, ...]],
                   epoch: int) -> torch.Tensor:
    """Per-hop gradient scale for the current (1-based) epoch, float32 [H].

    Ours_SS scales every hop by nHop.  Ours_Full/ResNet zero hop h from the
    epoch AFTER ``stop_timing[h] <= epoch`` first holds: the reference flips
    the flag in its end-of-epoch test block (Ours_Full/...lua:1133-1136).
    Hops beyond the table never stop."""
    scale = float(n_hops) if scale_by_nhop else 1.0
    out = []
    for h in range(n_hops):
        stop = (stop_timing[h] if stop_timing is not None
                and h < len(stop_timing) else 10 ** 9)
        out.append(0.0 if epoch > stop else scale)
    return torch.tensor(out, dtype=torch.float32)


def joint_loss_and_metrics(scores: torch.Tensor, do_pred: torch.Tensor,
                           labels: torch.Tensor, hop_scale: torch.Tensor
                           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """scores [H, B, A], do_pred [H, B], labels [B] int, hop_scale [H].

    Returns (differentiable loss, metrics); the metrics are detached and
    mirror the reference's per-iteration bookkeeping (:487-557)."""
    labels = labels.long()
    ce_per_hop = cross_entropy(scores, labels)                     # [H]
    loss = torch.sum(hop_scale.to(scores.device) * ce_per_hop)

    m_scores = scores.detach()
    m_do_pred = do_pred.detach()
    is_correct = (m_scores.argmax(-1) == labels[None]).float()     # [H, B]

    uni_pred = m_scores.mean(0)                                    # :521-524
    select_pred, _ = select_aggregate(m_scores, m_do_pred, force_final=False)
    # do_pred's target is per-hop correctness (:497); rows where no hop was
    # correct do not count in its accuracy (:551-553)
    did_correct = torch.clamp(is_correct.sum(0), 0.0, 1.0)         # [B]
    fired = (m_do_pred > 0.5).float()
    do_pred_match = (fired == is_correct).float()

    metrics = {
        "loss": loss.detach(),
        # share of rows where at least one hop answered right (:543)
        "any_correct_ratio": did_correct.mean(),
        "ce_per_hop": ce_per_hop.detach(),
        "uni_loss": cross_entropy(uni_pred, labels),
        "select_loss": cross_entropy(select_pred, labels),
        "acc_per_hop": is_correct.mean(1),
        "uni_acc": (uni_pred.argmax(-1) == labels).float().mean(),
        "select_acc": (select_pred.argmax(-1) == labels).float().mean(),
        "do_pred_loss": bce(m_do_pred, is_correct),                # [H]
        "do_pred_acc_num": (do_pred_match * did_correct[None]).sum(1),
        "do_pred_acc_den": did_correct.sum(),
    }
    return loss, metrics
