"""VQA eval-server submission files.

Schema and naming replicate the reference exactly so files can be uploaded
to the VQA v1 server unchanged (Ours_SS/LstmAttCtrlGradNoiseDontSelect.lua:1167-1186):
``results/hop_XX/vqa_<task>_mscoco_<split>_<alg><NN>hop-<epoch>_results.json``
containing ``[{"answer": str, "question_id": int}, ...]``.

The port's own copy of ``rau_vqa_tpu/eval/submission.py``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence


def submission_filename(task: str, split: str, alg_name: str, hop: int,
                        epoch: float) -> str:
    """task in {OpenEnded, MultipleChoice}; hop is 1-based (reference :1171)."""
    return f"vqa_{task}_mscoco_{split}_{alg_name}{hop:02d}hop-{epoch:.2f}_results.json"


def write_results(save_dir: str, task: str, split: str, alg_name: str,
                  epoch: float, rows_per_hop: Sequence[List[Dict]]) -> List[str]:
    """rows_per_hop[h] = list of {'answer', 'question_id'} for hop h (0-based
    index; files are named with the 1-based hop).  Returns written paths."""
    paths = []
    for h, rows in enumerate(rows_per_hop):
        hop_dir = os.path.join(save_dir, "results", f"hop_{h + 1:02d}")
        os.makedirs(hop_dir, exist_ok=True)
        path = os.path.join(
            hop_dir, submission_filename(task, split, alg_name, h + 1, epoch))
        with open(path, "w") as f:
            json.dump(rows, f)
        paths.append(path)
    return paths
