"""CNN-feature precomputation on the device: raw images -> a packed shard.

Counterpart of ``rau_vqa_tpu/precompute.py`` (:38-197).  The reference trains
and evaluates from features extracted offline (data/get_vgg16_pool5_448.sh
downloads them; vqa_prepro_loader.lua:874-958 reads one .t7 a image).  This
module makes them: the host decodes the images (the native decoder, else
PIL), the backbone runs batched on the device, and the [S, D] rows stream
into the packed shard that ``PackedFeatureStore`` and ``--feat-dir`` read.

One host thread decodes the next batch while the device runs the current
one; the last batch is padded to the batch size, so every call has one
shape.  The storage type is made on the device: float16 by a cast, int8 by
``quantize_feats_device``, so only the stored bytes cross to the host.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rau_vqa_tpu_torch.convert import map_tree
from rau_vqa_tpu_torch.data.features import PackedFeatureStore, PackedShardWriter, coco_feat_name
from rau_vqa_tpu_torch.data.images import ImageDirSource
from rau_vqa_tpu_torch.devices import pick_device
from rau_vqa_tpu_torch.models.pipeline import extract_features
from rau_vqa_tpu_torch.roadmap import still_to_port

IMAGE_EXTS = (".jpg", ".jpeg", ".png")
MESH = still_to_port("precompute_features over a device mesh", "multi-device")
STORAGE = {"float32": torch.float32, "float16": torch.float16}


def quantize_feats_device(feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``PackedShardWriter.write``'s int8 arithmetic where ``feats`` lies:
    per-image symmetric absmax, divide, round half to even, clip.  The same
    IEEE operations in float32 as the host's (the max is exact), so the bytes
    and scales are the host's bit for bit.  The divisor 127 is a tensor on
    the device: PyTorch's CUDA division by a Python number multiplies by its
    reciprocal, which misses the quotient by an ulp now and then."""
    feats = feats.float()
    absmax = feats.reshape(feats.shape[0], -1).abs().amax(1)
    s = torch.where(absmax > 0, absmax / torch.full_like(absmax, 127.0),
                    torch.ones_like(absmax))
    q = torch.clamp(torch.round(feats / s[:, None, None]), -127, 127).to(torch.int8)
    return q, s


def scan_image_dir(root: str) -> List[str]:
    """All image files under ``root`` as sorted root-relative paths."""
    rel = []
    for dirpath, _dirnames, filenames in os.walk(root):
        for fn in filenames:
            if fn.lower().endswith(IMAGE_EXTS):
                rel.append(os.path.relpath(os.path.join(dirpath, fn), root))
    return sorted(rel)


def unique_by_feat_name(rel_paths: Sequence[str]) -> Tuple[List[str], List[str]]:
    """(feature names, image rel paths), the first occurrence of each name.
    The store is keyed by ``coco_feat_name`` (basename + .t7), the name the
    data contract derives for every question (vqa_prepro_loader.lua:866-871),
    so duplicate basenames across directories are one row."""
    names, paths, seen = [], [], set()
    for p in rel_paths:
        name = coco_feat_name(p)
        if name not in seen:
            seen.add(name)
            names.append(name)
            paths.append(p)
    return names, paths


def precompute_features(image_root: str, rel_paths: Sequence[str], out_dir: str,
                        backbone: str, bb_params: Dict, *, size: int = 448,
                        batch_size: int = 64, dtype: str = "float32",
                        backend: str = "native", compute_dtype: Optional[str] = None,
                        vit_cfg=None, mesh=None, feat_norm: bool = False,
                        progress: Optional[Callable[[int, int], None]] = None,
                        device=None) -> PackedFeatureStore:
    """Run ``backbone`` over every unique image and write a packed shard.

    ``dtype`` is the storage type (float32, float16, or int8 with per-image
    symmetric scales, as ``pack_feature_dir``); ``compute_dtype`` (e.g.
    ``"bfloat16"``) casts the backbone's floating leaves.  Runs on
    ``device``: ``cuda`` when None, raising without a card; ``"cpu"`` runs
    there.  The returned store's ``decoder`` says which host decoders made
    the images (``ImageDirSource.decoders``)."""
    if mesh is not None:
        raise NotImplementedError(MESH)
    if dtype not in ("float32", "float16", "int8"):
        raise ValueError(f"unknown storage dtype {dtype!r}")
    device = pick_device(device, "precompute_features")
    names, paths = unique_by_feat_name(rel_paths)
    if not names:
        raise ValueError("no images to precompute features for")
    src = ImageDirSource(image_root, size=size, backend=backend)
    cdt = getattr(torch, compute_dtype) if compute_dtype is not None else None

    def place(t):
        t = t.to(device)
        return t.to(cdt) if cdt is not None and t.is_floating_point() else t

    bb_params = map_tree(place, bb_params)   # once, not per batch
    quant8 = dtype == "int8"

    def extract(images: np.ndarray):
        with torch.no_grad():
            feats = extract_features(backbone, bb_params, torch.from_numpy(images).to(device),
                                     vit_cfg, feat_norm=feat_norm)
            if quant8:
                q, s = quantize_feats_device(feats)
                return q.cpu().numpy(), s.cpu().numpy()
            return feats.float().to(STORAGE[dtype]).cpu().numpy(), None

    chunks = [paths[i:i + batch_size] for i in range(0, len(paths), batch_size)]

    def load(chunk: List[str]) -> np.ndarray:
        # padded to the batch size: one shape for every call
        return src.get_batch(chunk + [chunk[-1]] * (batch_size - len(chunk)))

    pool = ThreadPoolExecutor(max_workers=1)
    try:
        fut = pool.submit(load, chunks[0])
        writer, row = None, 0
        for ci, chunk in enumerate(chunks):
            images = fut.result()
            if ci + 1 < len(chunks):
                fut = pool.submit(load, chunks[ci + 1])
            feats, scales = extract(images)
            feats = feats[:len(chunk)]
            if writer is None:
                writer = PackedShardWriter(out_dir, len(paths), feats.shape[1],
                                           feats.shape[2], dtype=dtype, feat_norm=feat_norm)
            if quant8:
                writer.write_quantized(row, feats, scales[:len(chunk)])
            else:
                writer.write(row, feats)
            row += len(chunk)
            if progress is not None:
                progress(row, len(paths))
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
    store = writer.finish(names)
    store.decoder = src.decoders()
    return store
