"""Structured metrics logging.

Replaces the reference's ad-hoc observability stack — optim.Logger table rows
(Ours_SS/...lua:708,1111-1147), gnuplot PNG curves (:988-1110) and the
'display' live-plot HTTP server (:743-746) — with JSONL records using the
same per-hop key schema (``trainacc_01``, ``testOEacc_01``, ...), plus an
optional curve renderer (rau_vqa_tpu_torch.utils.plots) over the same files.

The port's own copy of ``rau_vqa_tpu/utils/logging.py``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    """Append-only JSONL metrics stream, one file per run."""

    def __init__(self, log_dir: str, filename: str = "metrics.jsonl"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, filename)

    def log(self, record: Dict, *, kind: str = "train") -> None:
        row = {"kind": kind, "time": time.time()}
        for k, v in record.items():
            row[k] = float(v) if hasattr(v, "__float__") else v
        with open(self.path, "a") as f:
            f.write(json.dumps(row) + "\n")

    def read(self, kind: Optional[str] = None):
        if not os.path.exists(self.path):
            return []
        rows = []
        with open(self.path) as f:
            lines = f.readlines()
        for i, line in enumerate(lines):
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                if i == len(lines) - 1:
                    # a reader (dashboard) racing the writer can see a
                    # torn final line mid-append — skip it; it will be
                    # complete on the next refresh
                    break
                raise
            if kind is None or row.get("kind") == kind:
                rows.append(row)
        return rows


def per_hop_record(prefix_to_values: Dict[str, "object"]) -> Dict:
    """Flatten {'trainacc': [v1..vH]} -> {'trainacc_01': v1, ...} matching the
    reference's test.log column naming (:1114-1118)."""
    out = {}
    for prefix, values in prefix_to_values.items():
        try:
            seq = list(values)
        except TypeError:
            out[prefix] = values
            continue
        for h, v in enumerate(seq):
            out[f"{prefix}_{h + 1:02d}"] = float(v)
    return out
