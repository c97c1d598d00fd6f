"""Training-curve rendering from the JSONL metrics stream.

Replaces the reference's gnuplot PNG block (Ours_SS/...lua:976-1110): one
function renders the same curve set — per-hop train/test accuracy, per-hop
loss, do_pred loss, learning-rate curves — from ``metrics.jsonl`` written by
``MetricsLogger``.  matplotlib is optional; without it rendering is a no-op
returning [].

The port's own copy of ``rau_vqa_tpu/utils/plots.py``.
"""

from __future__ import annotations

import os
from typing import List

from rau_vqa_tpu_torch.utils.logging import MetricsLogger


def _collect(rows, key):
    xs, ys = [], []
    for r in rows:
        if key in r and "epoch" in r:
            xs.append(r["epoch"])
            ys.append(r[key])
    return xs, ys


def render_curves(log_dir: str, out_dir: str, n_hops: int) -> List[str]:
    """Render accuracy/loss/LR curves to PNGs; returns written paths."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return []

    logger = MetricsLogger(log_dir)
    train_rows = logger.read(kind="train")
    test_rows = logger.read(kind="test")
    if not train_rows:
        return []
    os.makedirs(out_dir, exist_ok=True)
    written = []

    def plot(fname, series, title, ylabel):
        fig, ax = plt.subplots(figsize=(6, 4))
        any_data = False
        for label, (xs, ys) in series.items():
            if xs:
                ax.plot(xs, ys, label=label)
                any_data = True
        if not any_data:
            plt.close(fig)
            return
        ax.set_xlabel("epoch")
        ax.set_ylabel(ylabel)
        ax.set_title(title)
        ax.legend(loc="best", fontsize=7)
        path = os.path.join(out_dir, fname)
        fig.savefig(path, dpi=100, bbox_inches="tight")
        plt.close(fig)
        written.append(path)

    for h in range(1, n_hops + 3):  # nHop+2 prediction sets
        hh = f"{h:02d}"
        plot(f"accuracy_curve_hop{hh}.png",
             {"train": _collect(train_rows, f"trainacc_{hh}"),
              "test OE": _collect(test_rows, f"testOEacc_{hh}"),
              "test MC": _collect(test_rows, f"testMCacc_{hh}"),
              # present only under --official-anno (empty series are
              # skipped by plot())
              "test OE official": _collect(test_rows,
                                           f"testOEaccOfficial_{hh}"),
              "test MC official": _collect(test_rows,
                                           f"testMCaccOfficial_{hh}")},
             f"train / test accuracy [hop {hh}]", "accuracy")
        plot(f"loss_curve_hop{hh}.png",
             {"train": _collect(train_rows, f"trainloss_{hh}")},
             f"training loss [hop {hh}]", "loss")
    for h in range(1, n_hops + 1):
        hh = f"{h:02d}"
        plot(f"do_pred_loss_curve_hop{hh}.png",
             {"train": _collect(train_rows, f"do_pred_loss_{hh}")},
             f"do_pred loss [hop {hh}]", "loss")
    plot("learning_rate.png", {"lr": _collect(train_rows, "lr")},
         "learning rate", "lr")
    plot("mult_learning_rate.png",
         {"mult_lr": _collect(train_rows, "mult_lr")},
         "multimodal learning rate", "lr")
    return written
