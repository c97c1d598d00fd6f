"""The numbers that decide ``correct``: what the timed path produced against
the plain reference's tables for the same inputs.

Per-hop and "uni" rows are compared directly.  The "select" row is the
answer of the first hop whose do_pred is over 0.5; where a do_pred lies
within rounding of 0.5 the program may rightly pick a neighbouring hop, so
the select row is held to the nearest of the reference's hop rows.
"""

from __future__ import annotations

import random
from typing import Dict, List

import torch


def _scale(ref_pred: torch.Tensor, H: int) -> torch.Tensor:
    return ref_pred[:H + 1].abs().max().clamp(min=1e-30)


def score_tables(pred, att, ref_pred, ref_att, ref_do) -> Dict[str, float]:
    """Served score tables (tab_pred [H+2, B, A], tab_att [H+2, B, S])
    against the reference's.  ``pred_err``: the largest score difference
    over the hop and "uni" rows, as a share of the largest reference score;
    ``att_err``: the largest attention difference there; ``select_err``:
    over rows, the distance of the select row (scores as a share, attention
    as it is, the larger) from its nearest reference hop row."""
    H = ref_do.shape[0]
    pred, att = pred.float(), att.float()
    scale = _scale(ref_pred, H)
    d = torch.maximum((pred[H + 1][None] - ref_pred[:H]).abs().amax(-1) / scale,
                      (att[H + 1][None] - ref_att[:H]).abs().amax(-1))         # [H, B]
    return {
        "pred_err": ((pred[:H + 1] - ref_pred[:H + 1]).abs().max() / scale).item(),
        "att_err": (att[:H + 1] - ref_att[:H + 1]).abs().max().item(),
        "select_err": d.min(0).values.max().item(),
    }


def attention_maps(att, ref_att, ref_do) -> Dict[str, float]:
    """Served attention maps (tab_att [H+2, B, S]) against the reference's:
    ``att_err``, the largest difference over the hop and "uni" rows, and
    the select row's from its nearest reference hop row."""
    H = ref_do.shape[0]
    att = att.float()
    sel = (att[H + 1][None] - ref_att[:H]).abs().amax(-1).min(0).values
    return {"att_err": max((att[:H + 1] - ref_att[:H + 1]).abs().max().item(),
                           sel.max().item())}


def answer_misses(ids, ref_pred, ref_do, margin: float) -> int:
    """Served answer ids (tab_pred's argmax, [H+2, B]) against the
    reference's scores: the per-hop and "uni" answers that are not the
    reference's best where that best leads the runner-up by more than
    ``margin`` of the largest reference score, and the select answers that
    no reference hop row explains (a hop row explains its best, and any
    answer where its lead is under the margin)."""
    H = ref_do.shape[0]
    ids = ids.to(ref_pred.device).long()
    top2 = ref_pred.topk(2, -1).values
    sure = (top2[..., 0] - top2[..., 1]) > margin * _scale(ref_pred, H)     # [H+2, B]
    best = ref_pred.argmax(-1)
    wrong = ((ids[:H + 1] != best[:H + 1]) & sure[:H + 1]).sum()
    explained = ((ids[H + 1][None] == best[:H]) | ~sure[:H]).any(0)
    return int(wrong) + int((~explained).sum())


def worst(readings) -> Dict[str, float]:
    """The largest reading of each number over several compared batches
    (their sum, for a count of misses)."""
    out: Dict[str, float] = {}
    for r in readings:
        for k, v in r.items():
            out[k] = (out.get(k, 0) + v if k.endswith("_miss")
                      else max(out.get(k, float("-inf")), v))
    return out


def with_limits(numbers: Dict[str, float], limits: Dict[str, float]):
    """[(name, value, limit)] in the order of ``limits``; a number with no
    limit is a fault of the cell's file."""
    if set(numbers) != set(limits):
        raise KeyError(f"the numbers {sorted(numbers)} and the cell's limits "
                       f"{sorted(limits)} differ")
    return [(k, numbers[k], float(limits[k])) for k in limits]


class Kept:
    """What the window produced, kept for the comparison: ``k`` of its
    items by reservoir sampling drawn from the seed, and always the last."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.sample: Dict[int, object] = {}
        self.last = None

    def add(self, i: int, item) -> None:
        self.last = (i, item)
        if len(self.sample) < self.k:
            self.sample[i] = item
            return
        j = self.rng.randrange(i + 1)
        if j < self.k:
            del self.sample[sorted(self.sample)[j]]
            self.sample[i] = item

    def items(self) -> List:
        kept = dict(self.sample)
        if self.last is not None:
            kept[self.last[0]] = self.last[1]
        return [kept[i] for i in sorted(kept)]
