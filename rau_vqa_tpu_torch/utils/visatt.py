"""Attention-map visualization dumps.

The reference saves one grayscale PNG per question per hop per eval epoch
(Ours_SS/...lua:867-872, 926-932: ``figures/epoch_XXX/hop_XXX/<qid>.png``
from the [w, h]-reshaped attention probabilities).  Same layout here;
maps are min-max normalized and optionally upscaled for visibility.

The port's own copy of ``rau_vqa_tpu/utils/visatt.py``.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np


def save_attention_png(path: str, att: np.ndarray, *, upscale: int = 16) -> None:
    """att [w, h] probabilities -> grayscale PNG."""
    from PIL import Image

    att = np.asarray(att, np.float64)
    lo, hi = att.min(), att.max()
    norm = (att - lo) / (hi - lo) if hi > lo else np.zeros_like(att)
    img = (norm * 255).astype(np.uint8)
    if upscale > 1:
        img = np.kron(img, np.ones((upscale, upscale), np.uint8))
    Image.fromarray(img).save(path)          # 2-D uint8: grayscale ("L")


def tile_batch_images(imgs: np.ndarray, n_cols: int = 0) -> np.ndarray:
    """[B, H, W] or [B, H, W, C] -> one grid collage (the reference's
    utils/tools.lua tileBatchImg:11-47)."""
    B = imgs.shape[0]
    if n_cols <= 0:
        n_cols = int(np.ceil(np.sqrt(B)))
    n_rows = int(np.ceil(B / n_cols))
    pad = n_rows * n_cols - B
    if pad:
        # zeros_like(imgs[:pad]) under-fills when pad > B
        imgs = np.concatenate(
            [imgs, np.zeros((pad,) + imgs.shape[1:], imgs.dtype)])
    rows = [np.concatenate(list(imgs[r * n_cols:(r + 1) * n_cols]), axis=1)
            for r in range(n_rows)]
    return np.concatenate(rows, axis=0)


def dump_attention_maps(figure_dir: str, epoch: float, att: np.ndarray,
                        qids: Sequence[int], cnn_w: int, cnn_h: int) -> int:
    """att [H+2, B, S] for one batch -> one PNG per (hop, question).
    Returns the number of files written."""
    n = 0
    H2, B, S = att.shape
    assert S == cnn_w * cnn_h
    for h in range(H2):
        hop_dir = os.path.join(figure_dir, f"epoch_{int(epoch):03d}",
                               f"hop_{h + 1:03d}")
        os.makedirs(hop_dir, exist_ok=True)
        for b, qid in enumerate(qids):
            save_attention_png(os.path.join(hop_dir, f"{int(qid)}.png"),
                               att[h, b].reshape(cnn_w, cnn_h))
            n += 1
    return n
