"""Evaluation metrics: fast validation against a pre-digested ground-truth
map (the reference's 'comprehend' bundle, Ours_SS/...lua:914-925).

The port's own copy of ``rau_vqa_tpu/eval/metrics.py``.
"""

from __future__ import annotations

from typing import Dict, List


def fast_val_accuracy(rows: List[Dict], gt: Dict[int, str]) -> float:
    """rows = submission rows; gt = qid -> answer string.  Every qid must be
    present (the reference asserts this, :917)."""
    if not rows:
        raise ValueError("fast validation: empty result set")
    correct = 0
    for r in rows:
        qid = int(r["question_id"])
        if qid not in gt:
            raise KeyError(f"fast validation: question id {qid} not in GT map")
        correct += int(gt[qid] == r["answer"])
    return correct / len(rows)
