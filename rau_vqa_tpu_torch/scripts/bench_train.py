"""Training-step bench of the port on one CUDA card: ms a step of the whole
train step (forward with dropout, the joint loss, backward, gradient noise,
clip, per-group Adam) of a preset, ``ours_ms`` by default.

Counterpart of ``scripts/bench_train.py``.  K steps of ``make_train_step``
are chained through the ``TrainState`` (step k's params and Adam moments
are step k+1's input), each step's tokens salted as ``where(tokens > 0,
(tokens + salt + k) % vocab, 0)`` and, from pixels, its images XORed with
``salt + k``, so no two steps are the same.  The steps are enqueued eagerly;
each round of K is timed with CUDA events and synchronised once, after one
warm round on another salt.  No CUDA graph: the window holds the device's
idle time, which is part of a step.  Each step draws its own dropout masks
and noise (the state's step count seeds them).

Variants (``--variants``, comma-separated):
  plain       — the preset's unfused hop loop under autograd;
  remat       — the same with ``remat_hops``;
  fused[N]    — the fused hop loop: the two training kernels (N, the JAX
                package's Pallas ``block_b``, is accepted and unused: the
                port has no such tile);
  maskref     — the fused hop loop's plain version, forward and backward,
                under autograd, on the card (``fused_train_bwd="reference"``):
                the fused path's masks without its kernels;
  truncN      — plain with the token axis cut to N (the Trainer's buckets);
  accumN      — plain with ``grad_accum`` N (4 without N);
  pixels      — from uint8 pixels through a frozen folded backbone
                (``ours_resnet``: ResNet-101, ``ours_vit``: ViT-L/14, else
                VGG16) featurizing inline as the ``Trainer`` does, each
                image's features repeated to ``--qpi`` questions;
  finetune    — backbone fine-tuning (``train_backbone``, blockwise remat
                unless ``--ft-no-remat``), one image a question;
  finetunegrp — the same on B / qpi unique images (``img_repeat``).

    python3 -m rau_vqa_tpu_torch.scripts.bench_train [--batch 512] [--variants plain,remat]
        [--steps 10] [--rounds 2] [--f32] [--preset ours_ms] [--qpi 3]
        [--ft-no-remat] [--pixels-size 0] [--device cpu]

bf16 compute by default; ``--f32`` for float32 with TF32 off.  Prints one
JSON line: ``metric`` train_ms_per_step, ``value`` the first variant's ms a
step (the median round), ``results`` every variant's, and keyed alike
``questions_per_sec`` (B over the step), ``spread``, ``flops_per_step``
(``utils/flops.py`` ``train_step_flops``) and ``mfu`` (those FLOPs over the
step against the 989 TFLOP/s dense bf16 peak; null on the CPU);
``launches``, each kernel's launches over the run, and
``launches_by_variant``; ``device``, ``power_limit_w`` and the canary.
"""

from __future__ import annotations

import argparse
import dataclasses
import re
import sys
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from rau_vqa_tpu_torch.scripts._common import (
    add_device_arg,
    canary_keys,
    launch_counts,
    launches_since,
    log,
    run_script,
    spread,
    sync,
    time_call,
)

METRIC = "train_ms_per_step"
UNIT = "ms"
VARIANT_RE = re.compile(r"^(plain|remat|fused\d*|maskref|trunc\d+|accum\d*|pixels|finetune|"
                        r"finetunegrp)$")
LR, MULT_LR = 3e-3, 3e-4


class Variant(NamedTuple):
    """One variant's configurations and inputs' shape."""

    name: str
    mcfg: object
    tcfg: object
    trunc: Optional[int]       # the token axis cut to this
    kind: str                  # "features", "pixels" (frozen) or "finetune"
    grouped: bool              # finetune on B / qpi unique images
    backbone: Optional[str]


def backbone_of(preset: str) -> str:
    """The frozen or fine-tuned backbone a preset's pixels variants run."""
    if preset.startswith("ours_resnet"):
        return "resnet101"
    return "vit" if preset == "ours_vit" else "vgg16"


def variant(name: str, mcfg, tcfg, *, f32: bool, preset: str = "ours_ms",
            pixels_size: int = 0, ft_no_remat: bool = False) -> Variant:
    """The configurations ``name`` runs, from the preset's pair: the compute
    type, then the variant's switch (``scripts/bench_train.py:110-147``)."""
    if not VARIANT_RE.match(name):
        raise ValueError(f"unknown variant {name!r}: one of plain, remat, fused[N], maskref, "
                         f"truncN, accum[N], pixels, finetune, finetunegrp")
    mcfg = dataclasses.replace(mcfg, compute_dtype="float32" if f32 else "bfloat16",
                               remat_hops=name == "remat", fused_train=False)
    if name == "maskref":
        mcfg = dataclasses.replace(mcfg, fused_train=True, fused_train_bwd="reference")
    elif name.startswith("fused"):
        mcfg = dataclasses.replace(mcfg, fused_train=True, fused_train_bwd="kernel")
    trunc = int(name[5:]) if name.startswith("trunc") else None
    if name.startswith("accum"):
        tcfg = dataclasses.replace(tcfg, grad_accum=int(name[5:] or 4))
    kind = {"pixels": "pixels", "finetune": "finetune",
            "finetunegrp": "finetune"}.get(name, "features")
    backbone = None
    if kind != "features":
        backbone = backbone_of(preset)
        if pixels_size:
            g = pixels_size // 32
            mcfg = dataclasses.replace(mcfg, cnn_w=g, cnn_h=g)
    if kind == "finetune":
        tcfg = dataclasses.replace(tcfg, train_backbone=True, backbone_remat=not ft_no_remat)
    return Variant(name, mcfg, tcfg, trunc, kind, name == "finetunegrp", backbone)


def make_inputs(v: Variant, B: int, qpi: int, device: torch.device, *,
                pixels_size: int = 0, image_size: int = 0) -> Dict:
    """The variant's batch from ``RandomState(0)``, drawn in the JAX script's
    order (tokens, lengths, the images or features, labels), on ``device``;
    ``image_size``: the backbone's input side (``random_backbone``), for the
    pixels variants unless ``pixels_size`` sets it."""
    mcfg = v.mcfg
    rs = np.random.RandomState(0)
    tokens = rs.randint(1, mcfg.vocab_size, (B, mcfg.seq_len)).astype(np.int32)
    lengths = rs.randint(1, mcfg.seq_len + 1, B).astype(np.int32)
    if v.trunc is not None:
        tokens = tokens[:, :v.trunc]
        lengths = np.minimum(lengths, v.trunc)
    out = {}
    if v.kind == "features":
        out["feats"] = rs.randn(B, mcfg.cnn_spat, mcfg.cnn_dim).astype(np.float32)
    else:
        side = pixels_size or image_size
        n_img = B if (v.kind == "finetune" and not v.grouped) else B // qpi
        out["images"] = rs.randint(0, 256, (n_img, side, side, 3)).astype(np.uint8)
        out["side"] = side
    labels = rs.randint(0, mcfg.answer_size, B).astype(np.int32)
    out.update(tokens=tokens, lengths=lengths, labels=labels)
    return {k: (torch.as_tensor(a, device=device) if isinstance(a, np.ndarray) else a)
            for k, a in out.items()}


def make_chain(step: Callable, v: Variant, inp: Dict, K: int, *, qpi: int = 1,
               featurize: Optional[Callable] = None) -> Callable:
    """``chain(state, salt0) -> state``: K steps of ``step``, each on the
    previous one's state, step k's tokens salted by ``salt0 + k`` and, from
    pixels, its images XORed with it (mod 256).  ``featurize(images)``: the
    pixels variant's frozen backbone."""
    from rau_vqa_tpu_torch.ops.rau_train_hops import dot_dtype
    from rau_vqa_tpu_torch.train.losses import hop_grad_scale

    mcfg, tcfg = v.mcfg, v.tcfg
    hop_scale = hop_grad_scale(mcfg.n_hops, scale_by_nhop=tcfg.hop_grad_scale_nhop,
                               stop_timing=tcfg.hop_stop_timing, epoch=1)
    tokens, V = inp["tokens"], mcfg.vocab_size
    feat_dt = dot_dtype(mcfg)

    def chain(state, salt0: int):
        for k in range(K):
            s = salt0 + k
            toks = torch.where(tokens > 0, (tokens + s) % V, 0)
            if v.kind == "features":
                fx = inp["feats"]
            else:
                fx = torch.bitwise_xor(inp["images"], s % 256)
                if v.kind == "pixels":
                    # the Trainer's featurize: features on the card, in the
                    # step's type, each image's repeated to its questions
                    with torch.no_grad():
                        fx = featurize(fx).to(feat_dt).repeat_interleave(qpi, 0)
            state, _ = step(state, toks, inp["lengths"], fx, inp["labels"], hop_scale,
                            LR, MULT_LR)
        return state

    return chain


def run_variant(name: str, B: int, args, device: torch.device) -> Dict:
    """One variant at batch B: its ms a step (the median round), the rounds,
    its FLOPs and its kernels' launches."""
    from rau_vqa_tpu_torch.config import get_train_preset
    from rau_vqa_tpu_torch.models.pipeline import extract_features
    from rau_vqa_tpu_torch.train.trainer import init_train_state, make_train_step
    from rau_vqa_tpu_torch.utils.benchparams import random_backbone
    from rau_vqa_tpu_torch.utils.flops import train_step_flops

    mcfg0, tcfg0 = get_train_preset(args.preset)
    v = variant(name, mcfg0, tcfg0, f32=args.f32, preset=args.preset,
                pixels_size=args.pixels_size, ft_no_remat=args.ft_no_remat)
    bb_host, image_size, featurize = None, 0, None
    if v.kind != "features":
        wdtype = torch.float32 if args.f32 else torch.bfloat16
        bb_host, image_size = random_backbone(v.backbone, 1, wdtype,
                                              fold_bn=v.kind == "pixels")
    inp = make_inputs(v, B, args.qpi, device, pixels_size=args.pixels_size,
                      image_size=image_size)
    if v.kind == "pixels":
        from rau_vqa_tpu_torch.convert import map_tree
        bb = map_tree(lambda t: t.to(device), bb_host)
        feat_norm = v.tcfg.backbone_feat_norm

        def featurize(images):
            return extract_features(v.backbone, bb, images, feat_norm=feat_norm)
    state = init_train_state(v.mcfg, 0, device=device,
                             bb_params=bb_host if v.kind == "finetune" else None)
    step = make_train_step(v.mcfg, v.tcfg, device=device,
                           backbone=v.backbone if v.kind == "finetune" else None,
                           img_repeat=args.qpi if v.grouped else 1)
    K = args.steps
    chain = make_chain(step, v, inp, K, qpi=args.qpi, featurize=featurize)
    before = launch_counts()
    t_warm, _ = time_call(lambda: chain(state, 7), device)
    log(f"[{name} B={B}] warm round {t_warm:.2f}s")
    times, out = [], None
    for r in range(args.rounds):
        dt, out = time_call(lambda: chain(state, 100 + r), device)
        times.append(dt)
    sync(device)
    launches = {n: c for n, c in launches_since(before).items() if c}
    cls_b = out.params["mult"]["cls"]["b"]
    if not torch.isfinite(cls_b).all():
        raise RuntimeError(f"bench_train: {name} B={B}: non-finite parameters after the chain")
    ms = float(np.median(times)) / K * 1e3
    T = inp["tokens"].shape[1]
    n_img = inp["images"].shape[0] if "images" in inp else 0
    flops = train_step_flops(v.mcfg, B, T, backbone=v.backbone, size=inp.get("side", 0),
                             n_images=n_img, train_backbone=v.kind == "finetune",
                             backbone_remat=v.tcfg.backbone_remat)
    qps = B / (ms / 1e3)
    log(f"[{name} B={B}] {ms:.3f} ms/step ({qps:,.1f} questions/s; rounds "
        + ", ".join(f"{t / K * 1e3:.3f}" for t in times) + f" ms); launches {launches}")
    if v.kind == "pixels":
        log(f"[{name} B={B}] from-pixels training: {qps / args.qpi:,.1f} images/s "
            f"({B // args.qpi} images a step, qpi={args.qpi})")
    elif v.kind == "finetune":
        log(f"[{name} B={B}] backbone fine-tuning: {qps / args.qpi:,.1f} unique images/s "
            f"({n_img} backbone images a step, qpi={args.qpi}"
            f"{' grouped' if v.grouped else ' duplicates'})")
    return {"ms": round(ms, 4), "qps": round(qps, 2), "spread": spread(times),
            "flops": flops, "launches": launches, "steps": (1 + args.rounds) * K}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[512])
    ap.add_argument("--variants", type=str, default="plain,remat")
    ap.add_argument("--steps", type=int, default=10, help="train steps chained a round")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--f32", action="store_true",
                    help="float32 compute with TF32 off instead of bf16 compute")
    ap.add_argument("--preset", default="ours_ms",
                    help="training preset (ours_ms, ours_resnet, ours_vit, ...)")
    ap.add_argument("--qpi", type=int, default=3,
                    help="questions an image for the pixels and finetune variants")
    ap.add_argument("--ft-no-remat", action="store_true",
                    help="finetune variants: no blockwise backbone remat")
    ap.add_argument("--pixels-size", type=int, default=0,
                    help="the pixels variants' image side (0: the backbone's own; "
                         "a multiple of 32, conv backbones only)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    names = args.variants.split(",")
    for name in names:
        if not VARIANT_RE.match(name):
            raise SystemExit(f"unknown variant {name!r}")
        if name in ("pixels", "finetune", "finetunegrp"):
            for B in args.batch:
                if B % args.qpi:
                    raise SystemExit(f"{name} variant: --batch {B} (questions) must divide "
                                     f"by --qpi {args.qpi} (images are repeated qpi times)")
            if args.pixels_size and args.pixels_size % 32:
                raise SystemExit("--pixels-size must be a multiple of 32 (the conv "
                                 "backbones' total stride)")
            if args.pixels_size and args.preset == "ours_vit":
                raise SystemExit("--pixels-size cannot shrink ViT (fixed patch grid); use a "
                                 "conv preset")
    if min(args.steps, args.rounds) < 1:
        raise SystemExit("--steps and --rounds must be >= 1")
    device = torch.device(args.device)

    def body() -> Dict:
        from rau_vqa_tpu_torch.utils.flops import H100_BF16_FLOPS

        if args.f32:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        on_card = device.type == "cuda"
        if on_card:
            from rau_vqa_tpu_torch.bench import build_kernels
            secs = build_kernels(device, ("rau_train_hops_fwd", "rau_train_hops_bwd"))
            log(f"bench_train: training kernels built in {secs:.1f}s")
        before = launch_counts()
        res = {}
        for B in args.batch:
            for name in names:
                res[f"{name}_b{B}"] = run_variant(name, B, args, device)
        keys = canary_keys(device)
        head = next(iter(res.values()))
        notes = [f"{k}: the port has no block_b (the JAX package's Pallas tile); the "
                 f"fused hop loop runs the same kernels at any N"
                 for k in res if re.match(r"fused\d+_", k)]
        return {"metric": METRIC, "value": head["ms"], "unit": UNIT,
                "results": {k: r["ms"] for k, r in res.items()},
                "questions_per_sec": {k: r["qps"] for k, r in res.items()},
                "spread": {k: r["spread"] for k, r in res.items()},
                "flops_per_step": {k: r["flops"] for k, r in res.items()},
                "mfu": {k: (round(r["flops"] / (r["ms"] / 1e3) / H100_BF16_FLOPS, 5)
                            if on_card else None) for k, r in res.items()},
                "launches": {n: c for n, c in launches_since(before).items() if c},
                "launches_by_variant": {k: r["launches"] for k, r in res.items()},
                "steps_by_variant": {k: r["steps"] for k, r in res.items()},
                "compute_dtype": "float32" if args.f32 else "bfloat16",
                "preset": args.preset, "steps": args.steps, "rounds": args.rounds,
                "notes": notes, **keys}

    return run_script(METRIC, UNIT, device, body)


if __name__ == "__main__":
    sys.exit(main())
