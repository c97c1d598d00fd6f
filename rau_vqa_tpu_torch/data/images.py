"""Host-side image decode for the from-pixels path.

The host decodes and resizes each image to a fixed uint8 canvas (shorter-side
resize and center crop, the reference's Scale+CenterCrop eval transform,
transforms.lua:38-61); every float step (normalization, the backbone) runs
batched on the device (``ops/transforms.py``, ``models/pipeline.py``).

Two decoders, each held to the JAX package's counterpart:
- ``"pil"``: PIL's bicubic resize (``decode_scale_center_crop``).  PIL is
  imported only on this path; a machine without it can still decode through
  the native decoder.
- ``"native"``: ``data/native.py``'s C++ pool (libjpeg, libpng; a
  point-sampled Catmull-Rom resize).  Its pixels differ from PIL's.

The port's own copy of ``rau_vqa_tpu/data/images.py``.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np

BACKENDS = ("pil", "native")


def decode_scale_center_crop(img, size: int) -> np.ndarray:
    """PIL image -> uint8 [size, size, 3]: bicubic shorter-side resize and a
    center crop whose origin rounds up, as the reference's CenterCrop
    (transforms.lua:56-57)."""
    from PIL import Image

    img = img.convert("RGB")
    w, h = img.size
    scale = size / min(w, h)
    img = img.resize((max(size, round(w * scale)),
                      max(size, round(h * scale))),
                     Image.BICUBIC)
    w, h = img.size
    x0, y0 = (w - size + 1) // 2, (h - size + 1) // 2
    img = img.crop((x0, y0, x0 + size, y0 + size))
    return np.asarray(img, np.uint8)


class ImageDirSource:
    """Decodes images under a root directory into a uint8 [B, size, size, 3]
    batch.

    ``backend="native"`` sends the batch through the C++ pool; files it
    cannot read (formats other than JPEG and PNG) go through PIL one by one,
    and where the native library cannot be built the source switches to PIL
    for good.  Where PIL is needed and missing, the error names both
    decoders."""

    def __init__(self, root: str, size: int = 448, *, n_threads: int = 8,
                 backend: str = "pil"):
        if backend not in BACKENDS:
            raise ValueError(f"unknown image backend {backend!r}; one of "
                             f"{BACKENDS}")
        self.root = root
        self.size = size
        self.n_threads = n_threads
        self.backend = backend
        self.native_error: Optional[str] = None
        # images decoded so far by each decoder (a native batch's files it
        # cannot read count under PIL)
        self.decoded = {"native": 0, "pil": 0}
        self.pool = ThreadPoolExecutor(max_workers=n_threads)

    def decoders(self) -> str:
        """Which decoders made the images so far, with their counts, and
        why the native one did not run where it was asked for and did not."""
        ran = ", ".join(f"{k} {n}" for k, n in self.decoded.items() if n) or "none yet"
        if self.native_error:
            lines = self.native_error.splitlines()
            why = next((x for x in lines if "error:" in x), lines[0]).strip()
            ran += f" (the native decoder is unavailable: {why})"
        return ran

    def _load_one(self, rel_path: str) -> np.ndarray:
        try:
            from PIL import Image
        except ImportError as e:
            why = (f"; the native decoder is unavailable: "
                   f"{self.native_error.splitlines()[0]}"
                   if self.native_error else "")
            raise ImportError(f"decoding {rel_path!r} needs PIL, which this "
                              f"Python lacks{why}") from e
        with Image.open(os.path.join(self.root, rel_path)) as img:
            return decode_scale_center_crop(img, self.size)

    def get_batch(self, rel_paths: Sequence[str]) -> np.ndarray:
        # VQA batches repeat each image for its ~3 questions: each distinct
        # path is decoded once (a file's pixels never depend on its
        # batch-mates)
        uniq, inv = np.unique(np.asarray(rel_paths, dtype=object),
                              return_inverse=True)
        if uniq.size < len(rel_paths):
            return self.get_batch(list(uniq))[inv]
        if self.backend == "native":
            from rau_vqa_tpu_torch.data.native import (
                NativeUnavailable,
                decode_image_batch_status,
            )
            full = [os.path.join(self.root, p) for p in rel_paths]
            try:
                out, ok = decode_image_batch_status(
                    full, self.size, n_threads=self.n_threads)
            except NativeUnavailable as e:
                # no toolchain or headers here: PIL from now on (the
                # binding remembers the failure and never compiles again)
                self.native_error = str(e)
                self.backend = "pil"
            else:
                bad = np.flatnonzero(~ok)
                for i in bad:
                    out[i] = self._load_one(rel_paths[i])
                self.decoded["native"] += len(rel_paths) - len(bad)
                self.decoded["pil"] += len(bad)
                return out
        out = np.stack(list(self.pool.map(self._load_one, rel_paths)))
        self.decoded["pil"] += len(rel_paths)
        return out
