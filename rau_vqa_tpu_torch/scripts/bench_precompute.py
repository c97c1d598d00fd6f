"""Feature precomputation bench of the port: images/s of
``precompute_features`` end to end on one CUDA card (the host decode, the
backbone on the card, the storage type made there, the packed shard's
write).

Counterpart of ``scripts/bench_precompute.py``.  Synthetic 640x480 JPEGs
from ``RandomState(0)`` at PIL quality 85, 2 x ``--n`` of them: a warm sweep
over the first half, then the timed sweep over the other (distinct inputs).
The backbone is the port's init from seed 0 (values do not change the
work): ResNet-101 (its init, BN unfolded, as the JAX script's), VGG16 or
ViT-L/14 (224 px).

    python3 -m rau_vqa_tpu_torch.scripts.bench_precompute [--backbone resnet101|vgg16|vit]
        [--n 512] [--size 448] [--batch 64] [--dtype float32|float16|int8] [--f32]
        [--device cpu]

bf16 backbone compute by default (``--f32`` keeps float32, TF32 off).
Prints one JSON line: ``metric`` precompute_images_per_sec and the JAX
script's keys (``backbone``, ``size``, ``batch``, ``storage_dtype``,
``n_images``, ``sweep_sec``), with ``decoder`` (the host decoders that ran),
``launches``, ``device``, ``power_limit_w`` and the canary; no
``vs_baseline``.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from typing import Dict

import torch

from rau_vqa_tpu_torch.scripts._common import (
    add_device_arg,
    canary_keys,
    launch_counts,
    launches_since,
    log,
    run_script,
)

METRIC = "precompute_images_per_sec"
UNIT = "images/sec"


def make_images(root: str, n: int, *, w: int = 640, h: int = 480) -> None:
    """``n`` JPEGs ``img_%05d.jpg`` of uniform noise from ``RandomState(0)``,
    PIL quality 85: the JAX script's bytes."""
    import numpy as np
    from PIL import Image

    rs = np.random.RandomState(0)
    for i in range(n):
        arr = rs.randint(0, 256, (h, w, 3), dtype=np.uint8)
        Image.fromarray(arr).save(os.path.join(root, f"img_{i:05d}.jpg"), quality=85)


def init_backbone(backbone: str, device: torch.device):
    """(the backbone's tree from seed 0, the ViT's config or None)."""
    from rau_vqa_tpu_torch.models.backbones import resnet, vgg, vit

    gen = torch.Generator().manual_seed(0)
    if backbone == "resnet101":
        return resnet.resnet101_init(gen, device=device), None
    if backbone == "vgg16":
        return vgg.vgg16_pool5_init(gen, device=device), None
    return vit.vit_init(gen, vit.VIT_L14, device=device), vit.VIT_L14


def sweep(img_root: str, rel, out_dir: str, backbone: str, bb, args, device,
          vit_cfg=None):
    """One ``precompute_features`` sweep at the script's options; (seconds,
    the store)."""
    from rau_vqa_tpu_torch.precompute import precompute_features

    t0 = time.perf_counter()
    store = precompute_features(img_root, rel, out_dir, backbone, bb, size=args.size,
                                batch_size=args.batch, dtype=args.dtype,
                                compute_dtype=None if args.f32 else "bfloat16",
                                vit_cfg=vit_cfg, device=device)
    return time.perf_counter() - t0, store


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--backbone", default="resnet101", choices=["resnet101", "vgg16", "vit"])
    ap.add_argument("--n", type=int, default=512, help="synthetic images (one shard row each)")
    ap.add_argument("--size", type=int, default=None,
                    help="image side (448; the ViT's own 224 for vit)")
    ap.add_argument("--batch", type=int, default=64, help="device batch")
    ap.add_argument("--dtype", default="float32", choices=["float32", "float16", "int8"],
                    help="shard storage type")
    ap.add_argument("--f32", action="store_true",
                    help="float32 backbone compute, TF32 off (default bf16)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    if args.size is None:
        args.size = 224 if args.backbone == "vit" else 448
    if args.backbone == "vit" and args.size != 224:
        raise SystemExit("--backbone vit runs ViT-L/14 at its own 224 px (a fixed patch grid)")
    device = torch.device(args.device)

    def body() -> Dict:
        from rau_vqa_tpu_torch.precompute import scan_image_dir

        if args.f32:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        before = launch_counts()
        with tempfile.TemporaryDirectory(prefix="bench_precompute_") as td:
            img_root = os.path.join(td, "imgs")
            out_dir = os.path.join(td, "shard")
            os.makedirs(img_root)
            # the warm sweep and the timed one read distinct images
            log(f"bench_precompute: writing {2 * args.n} synthetic JPEGs")
            make_images(img_root, 2 * args.n)
            rel_all = scan_image_dir(img_root)
            rel_warm, rel = rel_all[:args.n], rel_all[args.n:]
            bb, vit_cfg = init_backbone(args.backbone, device)
            log("bench_precompute: warm sweep")
            warm, _ = sweep(img_root, rel_warm, out_dir + "_warm", args.backbone, bb, args,
                            device, vit_cfg)
            log(f"bench_precompute: warm sweep {warm:.1f}s; timed sweep")
            dt, store = sweep(img_root, rel, out_dir, args.backbone, bb, args, device,
                              vit_cfg)
            n_rows = len(store.index)
            decoder = store.decoder
        img_ps = n_rows / dt
        log(f"bench_precompute: {n_rows} images in {dt:.2f}s = {img_ps:.1f} images/s "
            f"(decoded by {decoder})")
        return {"metric": METRIC, "value": round(img_ps, 1), "unit": UNIT,
                "backbone": args.backbone, "size": args.size, "batch": args.batch,
                "storage_dtype": args.dtype,
                "compute_dtype": "float32" if args.f32 else "bfloat16",
                "n_images": n_rows, "sweep_sec": round(dt, 3), "warm_sec": round(warm, 3),
                "decoder": decoder,
                "launches": {n: c for n, c in launches_since(before).items() if c},
                **canary_keys(device)}

    return run_script(METRIC, UNIT, device, body)


if __name__ == "__main__":
    sys.exit(main())
