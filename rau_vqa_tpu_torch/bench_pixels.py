"""From-pixels serving bench of the port: images + questions -> answers, on
one card.

The port's counterpart of the root ``bench_pixels.py``: uint8 images and
``--qpi`` questions an image through the backbone's normalization, the
backbone, the features repeated per question and the 8-hop head, K steps
chained by a data dependence (``eval/chain.py``: the images and the tokens
salted by the previous step's first answer), enqueued eagerly, each round
timed with CUDA events and synchronised once.  The defaults are the serving
path of ``ours_resnet``: a folded ResNet-101 in bf16 from seed 1 at 448 px,
every identity run in the stage kernel (``--fused-stages``, as
``answer_pixels``), the head in its two kernels, B=120 images, 3 questions an
image, chains of 10, 5 rounds.  ``--backbone vgg16`` (``ours_ms``) and
``vit`` (``ours_vit``, ViT-L/14 at 224 px) run their backbones in cuDNN and
cuBLAS.  ``--s2d`` runs the folded ResNet-101 with the space-to-depth stem
and ``--int8`` its int8 mode (s8 x s8 -> s32 products, ``eval/chain.py``'s
``apply_override``); neither takes the stage kernel, as in the JAX bench.

    python3 bench_torch_pixels.py [--backbone resnet101|vgg16|vit] [--batch 120]
                                  [--qpi 3] [--chain 10] [--rounds 5] [--artifact [DIR]]
                                  [--s2d | --int8]

Prints one JSON line: ``metric`` (``pixels_questions_per_sec_per_chip``),
``value`` (questions/s), ``images_per_sec``, ``mfu`` (the step's analytic
FLOPs, backbone and head, over its time against the 989 TFLOP/s dense bf16
peak, the count and the peak of the bf16 path whatever the variant, as
the JAX bench's; the backbone is ~99% of them), the canary, ``device`` and
``power_limit_w``, as ``bench_torch.py``, and the variant's ``s2d`` and
``int8`` flags.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from typing import Dict

import numpy as np
import torch

from rau_vqa_tpu_torch.bench import (
    build_kernels,
    chain_rounds,
    log,
    result_line,
    run_bench,
    upload,
)
from rau_vqa_tpu_torch.ops import _build

METRIC = "pixels_questions_per_sec_per_chip"
PRESETS = {"resnet101": "ours_resnet", "vgg16": "ours_ms", "vit": "ours_vit"}


def _stages(raw, backbone: str, folded: bool, variant: bool = False):
    """The stages whose identity runs go through the stage kernel: all four
    for a folded ResNet-101 unless given ('none' for none); none for the
    s2d or int8 variant, which refuses them."""
    if raw is None:
        return (0, 1, 2, 3) if backbone == "resnet101" and folded and not variant else ()
    if raw.strip().lower() in ("", "none"):
        return ()
    try:
        stages = tuple(int(s) for s in raw.split(",") if s.strip())
    except ValueError:
        raise SystemExit(f"--fused-stages wants comma-separated ints, got {raw!r}")
    if not set(stages) <= {0, 1, 2, 3}:
        raise SystemExit("--fused-stages indices must be in 0..3")
    if stages and not (backbone == "resnet101" and folded):
        raise SystemExit("--fused-stages needs the folded resnet101 tree (no --no-fold-bn)")
    if stages and variant:
        raise SystemExit("--fused-stages needs the plain folded resnet101 tree "
                         "(no --int8/--s2d)")
    return stages


def _refuse(args) -> None:
    """The JAX bench's refusals of the variants (the root bench_pixels.py:89-117),
    checked before any device is touched."""
    if args.s2d and (args.no_fold_bn or args.int8):
        raise SystemExit("--s2d needs the folded f32/bf16 tree: it cannot combine with "
                         "--no-fold-bn or --int8")
    if args.int8 and args.no_fold_bn:
        raise SystemExit("--int8 quantizes the folded tree: it cannot combine with "
                         "--no-fold-bn")
    if args.backbone != "resnet101" and (args.int8 or args.s2d):
        raise SystemExit(f"--int8/--s2d are resnet101 variants; the JSON line would "
                         f"mislabel a plain {args.backbone} run as the variant")
    if args.artifact is not None and args.int8:
        raise SystemExit("--artifact does not take --int8 (another apply function, not a "
                         "variant of the tree: an artifact could pin the wrong program)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--backbone", default="resnet101", choices=sorted(PRESETS))
    ap.add_argument("--batch", type=int, default=120, help="images a step")
    ap.add_argument("--qpi", type=int, default=3, help="questions an image")
    ap.add_argument("--chain", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--size", type=int, default=448,
                    help="image side (the ViT's is its config's, 224)")
    ap.add_argument("--f32", action="store_true",
                    help="float32 backbone weights (default: bf16)")
    ap.add_argument("--no-fold-bn", action="store_true",
                    help="keep the ResNet's separate BN (default: folded into the convs)")
    ap.add_argument("--s2d", action="store_true",
                    help="the folded ResNet-101 with the space-to-depth stem (4x4/1 conv "
                         "on the 2x2-s2d input)")
    ap.add_argument("--int8", action="store_true",
                    help="the int8 ResNet-101 (per-channel weights, per-batch activations, "
                         "s8 x s8 -> s32 products)")
    ap.add_argument("--fused-stages", default=None,
                    help="comma list of ResNet stages (0-3) whose identity runs go through "
                         "the stage kernel; default all four, 'none' for cuDNN alone")
    ap.add_argument("--artifact", metavar="DIR", nargs="?", const="", default=None,
                    help="time the chain from its torch.export artifact (built in DIR if "
                         "missing or stale; default rau_vqa_tpu_torch/_build/artifacts/"
                         "pixels_chain_<variant>)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; exit 3 without a card) or cpu (a smoke)")
    args = ap.parse_args(argv)

    _refuse(args)
    if min(args.batch, args.qpi, args.chain, args.rounds) < 1:
        raise SystemExit("--batch, --qpi, --chain and --rounds must be >= 1")
    if args.no_fold_bn and args.backbone != "resnet101":
        raise SystemExit("--no-fold-bn is a resnet101 variant")
    stages = _stages(args.fused_stages, args.backbone, not args.no_fold_bn,
                     args.s2d or args.int8)
    device = torch.device(args.device)
    B, Q, K = args.batch, args.qpi, args.chain

    def body() -> Dict:
        from rau_vqa_tpu_torch.config import get_preset
        from rau_vqa_tpu_torch.convert import map_tree
        from rau_vqa_tpu_torch.eval.chain import make_pixels_chain
        from rau_vqa_tpu_torch.models.backbones import resnet
        from rau_vqa_tpu_torch.models.backbones.vit import VIT_L14
        from rau_vqa_tpu_torch.models.rau import init_params
        from rau_vqa_tpu_torch.utils.benchparams import random_backbone
        from rau_vqa_tpu_torch.utils.flops import backbone_flops, serve_step_flops
        from rau_vqa_tpu_torch.utils.rigcheck import matmul_canary

        compile_s = build_kernels(device, ("lstm_encoder", "rau_hops", "fused_resnet"))
        size = VIT_L14.image_size if args.backbone == "vit" else args.size
        grid = VIT_L14.grid if args.backbone == "vit" else size // 32
        cfg = dataclasses.replace(get_preset(PRESETS[args.backbone]), cnn_w=grid, cnn_h=grid)
        params = init_params(cfg, torch.Generator().manual_seed(0), device)
        wdtype = torch.float32 if args.f32 else torch.bfloat16
        bb, _ = random_backbone(args.backbone, 1, wdtype, fold_bn=not args.no_fold_bn)
        apply_override = None
        if args.s2d:
            bb = resnet.space_to_depth_stem(bb)
        elif args.int8:
            bb, apply_override = resnet.quantize_resnet(bb), resnet.resnet101_apply_int8
        rs = np.random.RandomState(0)
        h_images = rs.randint(0, 256, (B, size, size, 3)).astype(np.uint8)
        h_tokens = rs.randint(1, cfg.vocab_size, (B * Q, cfg.seq_len)).astype(np.int32)
        h_lengths = rs.randint(1, cfg.seq_len + 1, B * Q).astype(np.int32)
        t0 = time.perf_counter()
        bb = map_tree(lambda x: x.to(device), bb)
        (images, tokens, lengths), _ = upload(device, h_images, h_tokens, h_lengths)
        t_up = time.perf_counter() - t0        # the weights' copy and the inputs'
        n_acc = min(4, B * Q)
        vit_cfg = VIT_L14 if args.backbone == "vit" else None
        extra = {}
        if args.artifact is not None:
            from rau_vqa_tpu_torch.eval.export import (
                export_pixels_chain,
                load_or_build_chain_artifact,
            )
            variant = (args.backbone + str(size) + ("_s2d" if args.s2d else "")
                       + ("_nofold" if args.no_fold_bn else "")
                       + ("_f32" if args.f32 else "")
                       + ("_stages" + "".join(map(str, stages)) if stages else ""))
            art_dir = args.artifact or os.path.join(
                _build.BUILD_DIR, "artifacts", f"pixels_chain_{variant}")
            t0 = time.perf_counter()
            chain = load_or_build_chain_artifact(
                art_dir,
                lambda: export_pixels_chain(
                    bb, params, cfg, args.backbone, art_dir, batch=B, chain=K, qpi=Q,
                    image_size=size, n_acc=n_acc, vit_cfg=vit_cfg, fused_stages=stages,
                    device=device, extra_meta={"variant": variant}),
                {"kind": "pixels_chain", "batch": B, "chain": K, "qpi": Q,
                 "image_size": size, "variant": variant, "fused": True,
                 "fused_stages": list(stages), "device": device.type,
                 "model_config": dataclasses.asdict(cfg)}, log=log)
            chain.program()
            extra = {"artifact": True, "artifact_s": round(time.perf_counter() - t0, 3)}
            log(f"bench_pixels: artifact ready in {extra['artifact_s']}s (built or loaded)")
        else:
            chain = make_pixels_chain(cfg, args.backbone, K, Q, n_acc, vit_cfg=vit_cfg,
                                      fused_stages=stages, apply_override=apply_override)
        log(f"bench_pixels: {args.backbone} B={B} qpi={Q} "
            f"{'int8' if args.int8 else 'f32' if args.f32 else 'bf16'}"
            f"{' s2d' if args.s2d else ''}, fused stages {list(stages)}")
        t_first, times, (_, acc) = chain_rounds(
            lambda s: chain(bb, params, images, tokens, lengths, s), args.rounds, device)
        if tuple(acc.shape) != (cfg.n_hops + 2, n_acc):
            raise RuntimeError(f"bench_pixels: the chain's acc has shape {tuple(acc.shape)}")
        canary = matmul_canary(device=device)
        flops = (B * backbone_flops(args.backbone, size, vit_cfg)
                 + serve_step_flops(cfg, B * Q, int(h_lengths.sum())))
        line = result_line(METRIC, K * B * Q, times, K, flops, device, canary,
                           questions_per_image=Q, backbone=args.backbone,
                           fused_stages=list(stages), s2d=args.s2d, int8=args.int8,
                           batch=B, chain=K, rounds=args.rounds,
                           compile_s=None if compile_s is None else round(compile_s, 3),
                           compile_first_s=round(t_first, 3),
                           operand_upload_s=round(t_up, 3), **extra)
        # images/s from the line's own q/s: rounded apart, the two would
        # disagree by a few percent at the CPU's few questions a second
        line["images_per_sec"] = round(line["value"] / Q, 4)
        log(f"bench_pixels: {line['step_ms']} ms a step of {B} images (median of "
            f"{args.rounds}, spread {line['spread'] * 100:.1f}%); mfu {line['mfu']}")
        return line

    return run_bench(METRIC, device, body)


if __name__ == "__main__":
    sys.exit(main())
