"""Fine-tuning accuracy A/B on one CUDA card: a frozen backbone against a
trained one, on the same budget.

Counterpart of ``scripts/ft_accuracy_ab.py``.  The image fixture's
``texture`` mode encodes each image's class as stripe orientation x period
with the first-order statistics equal across classes (``mixed`` adds a weak
gray cue that keeps the image pathway alive), so a frozen random backbone's
features carry the class only by accident and the head-only arm stays near
the question prior; the fine-tuned arm must learn its filters to pass it.
Both arms share the rest: the same random VGG16 (He init x0.72 a
convolution, the CLI's fixture rule) or a tiny ViT, the head's widths, the
LRs, the data order and the epochs.  The only difference is
``train_backbone``.  ``--head-warmup N`` first trains the head alone for N
epochs and starts both arms from its snapshot.

    python3 -m rau_vqa_tpu_torch.scripts.ft_accuracy_ab [--root DIR] [--epochs 30]
        [--batch-size 16] [--arms frozen,finetune] [--backbone vgg16|vit]
        [--image-mode mixed|texture] [--head-warmup 0] [--f32] [--device cpu]

Prints one JSON line: ``metric`` ft_ab_gap (the fine-tuned arm's best
held-out best-hop accuracy less the frozen arm's), the JAX script's keys
(``frozen_best_test_acc``, ``finetune_best_test_acc``, ``chance``, ``arms``
with each epoch's history, ...), ``launches``, ``device``, ``power_limit_w``
and the canary; and writes it to ``<root>/result.json``.  Each arm also
carries ``head_start_sha1``, a digest of the head's parameters as the arm
starts (equal in both arms after a warm start), and ``backbone_max_change``,
the largest change of a backbone weight over the arm (0 when frozen).
"""

from __future__ import annotations

import argparse
import dataclasses as dc
import hashlib
import json
import os
import shutil
import sys
import time
from typing import Dict, Optional

import torch

from rau_vqa_tpu_torch.scripts._common import (
    add_device_arg,
    canary_keys,
    launch_counts,
    launches_since,
    log,
    run_script,
)

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_trainer(root: str, workdir: str, *, train_backbone: bool, args, device):
    """One arm's ``Trainer``: the tiny head over the fixture's 64 px images."""
    from rau_vqa_tpu_torch.config import get_experiment
    from rau_vqa_tpu_torch.convert import map_tree
    from rau_vqa_tpu_torch.data.images import ImageDirSource
    from rau_vqa_tpu_torch.data.loader import load_gt_annotations, load_vqa_data
    from rau_vqa_tpu_torch.train.trainer import Trainer

    vqa_dir = os.path.join(root, "vqa_prepro")
    vit_cfg = None
    if args.backbone == "vit":
        # a 16-dim feature interface and 2 blocks between the loss and the
        # pixels: the patch embedding is linear, so a trained one can learn
        # the stripes that a frozen random one mostly collapses
        from rau_vqa_tpu_torch.models.backbones.vit import ViTConfig
        vit_cfg = ViTConfig(image_size=64, patch=16, dim=16, depth=2, heads=4)
    cdims = (dict(cnn_dim=16, cnn_w=4, cnn_h=4) if args.backbone == "vit"
             else dict(cnn_dim=512, cnn_w=2, cnn_h=2))
    exp = get_experiment("ours_ms")
    exp = exp.replace(
        model=dc.replace(exp.model, n_hops=2, **cdims, embed_dim=16, rnn_size=16,
                         multfeat_dim=16, attfeat_dim=8, att_rnn_size=16, embed_dropout=0.0,
                         rnn_dropout=0.0, mult_dropout=0.1,
                         compute_dtype="bfloat16" if args.bf16 else "float32"),
        # the head (mult) at lr/10, the reference's ratio
        train=dc.replace(exp.train, batch_size=args.batch_size, learning_rate=args.lr,
                         mult_learning_rate=args.lr / 10, lr_decay=1.0, mult_lr_decay=1.0,
                         noisy_eta=0.0, grad_clip=10.0, length_buckets=(),
                         train_backbone=train_backbone,
                         backbone_lr_scale=args.backbone_lr_scale,
                         backbone_feat_norm=args.feat_norm),
        data=dc.replace(exp.data, split="val2014"),
        # the eval sweep through the plain float32 predict, as the JAX
        # package's sweep runs: the encoder kernel needs rnn_size in
        # multiples of 32, and this head's is 16
        fused_eval=False)
    data = load_vqa_data(vqa_dir, args.batch_size, split="val2014", test_batch_size=32)
    src = ImageDirSource(os.path.join(root, "images"), size=64)
    gt = load_gt_annotations(os.path.join(vqa_dir, "gt_annotations.json"))
    gen = torch.Generator().manual_seed(0)
    if args.backbone == "vit":
        from rau_vqa_tpu_torch.models.backbones.vit import vit_init
        bb = vit_init(gen, vit_cfg, device="cpu")
    else:
        # the same init in both arms, scaled x0.72 a convolution
        from rau_vqa_tpu_torch.models.backbones.vgg import vgg16_pool5_init
        bb = map_tree(lambda x: x * 0.72 if x.ndim == 4 else x,
                      vgg16_pool5_init(gen, device="cpu"))
    return Trainer(exp, data, src, workdir, gt_anno=gt, device=device,
                   backbone=args.backbone, bb_params=bb, vit_cfg=vit_cfg)


def run_arm(name: str, root: str, workdir: str, *, train_backbone: bool, args, device,
            warm_start: Optional[str] = None, save_final: bool = False) -> Dict:
    trainer = build_trainer(root, workdir, train_backbone=train_backbone, args=args,
                            device=device)
    if warm_start:
        # the two-phase recipe: the head's three groups from the head-only
        # snapshot, the backbone from its init
        trainer.restore(warm_start)
    from rau_vqa_tpu_torch.convert import tree_leaves
    from rau_vqa_tpu_torch.train.trainer import head_params

    digest = hashlib.sha1()
    for x in tree_leaves(head_params(trainer.state.params)):
        digest.update(x.detach().float().cpu().numpy().tobytes())
    bb_start = [x.detach().float().cpu().clone() for x in tree_leaves(trainer._bb_tree())]
    hist, best, t0 = [], 0.0, time.time()
    for _ in range(args.epochs):
        rec = trainer.train_epoch()
        if rec.get("aborted"):
            log(f"[{name}] epoch aborted by the guard; continuing")
            continue
        ev = trainer.evaluate(write_submissions=False)
        te = max(ev["testOEacc"])
        best = max(best, te)
        hist.append({"epoch": trainer.epoch, "test_acc": round(te, 4),
                     "train_acc": round(max((v for k, v in rec.items()
                                             if k.startswith("trainacc_")), default=0.0), 4),
                     "loss": round(float(rec.get("loss", float("nan"))), 4),
                     "grad_norm_backbone": round(float(rec.get("grad_norm_backbone", 0.0)),
                                                 6)})
        log(f"[{name}] epoch {trainer.epoch}: held-out {te:.4f} (best {best:.4f}) loss "
            f"{rec.get('loss', float('nan')):.3f}"
            + (f" gB {rec.get('grad_norm_backbone', 0):.4f}" if train_backbone else ""))
    bb_change = max((float((x.detach().float().cpu() - x0).abs().max())
                     for x, x0 in zip(tree_leaves(trainer._bb_tree()), bb_start)), default=0.0)
    out = {"name": name, "best_test_acc": round(best, 4), "wall_s": round(time.time() - t0, 1),
           "head_start_sha1": digest.hexdigest(), "backbone_max_change": bb_change,
           "history": hist}
    if save_final:
        out["snapshot"] = trainer.save()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.join(_REPO, ".scratch", "ft_ab"))
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--backbone-lr-scale", type=float, default=1.0)
    ap.add_argument("--n-classes", type=int, default=4)
    ap.add_argument("--n-train", type=int, default=320)
    ap.add_argument("--n-test", type=int, default=64)
    ap.add_argument("--bf16", action="store_true", default=True)
    ap.add_argument("--f32", dest="bf16", action="store_false")
    ap.add_argument("--arms", default="frozen,finetune", help="comma list: frozen,finetune")
    ap.add_argument("--backbone", default="vgg16", choices=("vgg16", "vit"))
    ap.add_argument("--image-mode", default="mixed", choices=("texture", "mixed"),
                    help="texture alone gives a deep random conv stack no pixel-gradient "
                         "foothold; mixed adds a weak gray cue")
    ap.add_argument("--head-warmup", type=int, default=0,
                    help="head-only epochs that both arms start from")
    ap.add_argument("--feat-norm", action="store_true",
                    help="the RMS feature interface (off: it deletes the gray cue)")
    ap.add_argument("--budget-s", type=float, default=5400.0)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    def body() -> Dict:
        from rau_vqa_tpu_torch.data.fixtures import FixtureSpec, generate_fixture

        if not args.bf16:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        before = launch_counts()
        spec = FixtureSpec(n_train=args.n_train, n_test=args.n_test, n_images=40,
                           n_answers=args.n_classes, n_img_classes=args.n_classes, seed=13)
        # the dataset is a function of (spec, image mode): rebuilt on any change
        want = {"spec": dc.asdict(spec), "image_mode": args.image_mode}
        pin = os.path.join(args.root, "abspec.json")
        have = None
        if os.path.exists(pin):
            with open(pin) as f:
                have = json.load(f)
        if have != json.loads(json.dumps(want)):
            if os.path.isdir(args.root):
                shutil.rmtree(args.root)
            generate_fixture(args.root, spec, images=True, image_size=64,
                             uniform_img_assign=True, image_mode=args.image_mode)
            with open(pin, "w") as f:
                json.dump(want, f)
            log(f"{args.image_mode} fixture generated under {args.root}")
        keys = canary_keys(device)
        wd = args.workdir or os.path.join(args.root, "runs")
        arms, warm = {}, None
        if args.head_warmup > 0:
            wu = argparse.Namespace(**{**vars(args), "epochs": args.head_warmup})
            arms["head_warmup"] = run_arm("head_warmup", args.root,
                                          os.path.join(wd, "head_warmup"),
                                          train_backbone=False, args=wu, device=device,
                                          save_final=True)
            warm = arms["head_warmup"]["snapshot"]
        for arm in args.arms.split(","):
            arms[arm] = run_arm(arm, args.root, os.path.join(wd, arm),
                                train_backbone=arm == "finetune", args=args, device=device,
                                warm_start=warm)
        frozen = arms.get("frozen", {}).get("best_test_acc")
        tuned = arms.get("finetune", {}).get("best_test_acc")
        result = {"metric": "ft_ab_gap",
                  "value": (round(tuned - frozen, 4)
                            if frozen is not None and tuned is not None else None),
                  "unit": "accuracy", "frozen_best_test_acc": frozen,
                  "finetune_best_test_acc": tuned, "chance": round(1.0 / args.n_classes, 4),
                  "epochs": args.epochs, "image_mode": args.image_mode,
                  "backbone": args.backbone, "lr": args.lr,
                  "backbone_lr_scale": args.backbone_lr_scale,
                  "compute_dtype": "bfloat16" if args.bf16 else "float32", "arms": arms,
                  "launches": {n: c for n, c in launches_since(before).items() if c},
                  **keys}
        with open(os.path.join(args.root, "result.json"), "w") as f:
            json.dump(result, f, indent=1)
        return result

    return run_script("ft_ab_gap", "accuracy", device, body, timeout_s=args.budget_s)


if __name__ == "__main__":
    sys.exit(main())
