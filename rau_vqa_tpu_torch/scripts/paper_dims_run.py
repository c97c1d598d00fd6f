"""Learnability at the paper's dims, and the host pipeline at scale, on one
CUDA card.

Counterpart of ``scripts/paper_dims_run.py``.  A synthetic dataset at the
flagship's widths (vocab 12,605, rnn 512, 8 hops, 14x14x512 features,
reference Ours_SS/...lua:202-228) whose answer is a function of (the first
question token, the image's class), so that training must reach a criterion
fixed before the run, or the full-width numerics (bf16, gradient noise,
clip, 3-group Adam, LR decay) are broken.  Subcommands:

  generate — the dataset (``data/fixtures.py`` at the paper-dims spec) and
             its features packed into an int8 shard;
  train    — ``Trainer`` at the ``ours_ms`` recipe (bf16, the guard, length
             buckets, a sweep an epoch) until the criterion (best-hop train
             accuracy >= 0.90 and held-out >= 0.80) or ``--epochs``; exit 1
             when it is not met.  ``--fused-train`` runs the hop loop through
             the training kernels (the JAX CLI's switch), else the preset's
             unfused hops;
  timebox  — the production loop (prefetch, the int8 shard, background
             checkpoints, the guard) for a bounded segment, beside a
             host-only pass over the same loader.

    python3 -m rau_vqa_tpu_torch.scripts.paper_dims_run generate [--root DIR] [--n-train 12800]
    python3 -m rau_vqa_tpu_torch.scripts.paper_dims_run train [--root DIR] [--epochs 20]
        [--fused-train] [--device cpu]
    python3 -m rau_vqa_tpu_torch.scripts.paper_dims_run timebox [--root DIR] [--minutes 35]

``train`` and ``timebox`` print one JSON line (``paper_dims_best_testOEacc``,
``host_pipeline_examples_per_sec``; the JAX script's keys with ``device``,
``power_limit_w`` and the canary; ``train``'s also ``fused_train`` and each
epoch's ``history``) and write it, with the run's ``metrics.jsonl``, under
``<root>/results/``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
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

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the criterion, fixed before any run: > 90% train, > 80% held-out best-hop
# accuracy on the 200-answer task (scripts/paper_dims_run.py:47-48)
CRIT_TRAIN = 0.90
CRIT_TEST = 0.80


def spec_of(args):
    """The paper-dims fixture spec (``scripts/paper_dims_run.py:55-63``)."""
    from rau_vqa_tpu_torch.data.fixtures import FixtureSpec

    return FixtureSpec(n_train=args.n_train, n_test=args.n_test, n_images=args.n_images,
                       n_words=12604, n_answers=args.n_answers, seq_len=26, feat_dim=512,
                       feat_w=14, feat_h=14, n_mc=4, seed=11,
                       n_img_classes=args.n_img_classes, class_code=args.class_code,
                       feat_noise=args.feat_noise)


def cmd_generate(args) -> int:
    from rau_vqa_tpu_torch.data.features import pack_feature_dir
    from rau_vqa_tpu_torch.data.fixtures import generate_fixture

    spec = spec_of(args)
    t0 = time.time()
    log(f"generating {spec.n_train} train / {spec.n_test} test questions, {spec.n_images} "
        f"images x [512, 14, 14] t7 features under {args.root}")
    vqa_dir = generate_fixture(args.root, spec)
    log(f"fixture written in {time.time() - t0:.1f}s; packing the int8 shard")
    with open(os.path.join(vqa_dir, "data_prepro.json")) as f:
        info = json.load(f)
    t0 = time.time()
    shard_dir = os.path.join(args.root, "shard_int8")
    # one shard for both splits: the fixture's train and test sources are
    # the same directory
    imgs = info["unique_img_train"] + info["unique_img_test"]
    pack_feature_dir([os.path.join(args.root, "feat")], imgs, [1] * len(imgs), shard_dir,
                     512, 14, 14, dtype="int8")
    log(f"int8 shard packed in {time.time() - t0:.1f}s "
        f"({os.path.getsize(os.path.join(shard_dir, 'features.npy')) / 1e6:.0f} MB)")
    if not args.keep_t7:
        shutil.rmtree(os.path.join(args.root, "feat"))
        log("t7 directory removed (--keep-t7 keeps it)")
    with open(os.path.join(args.root, "spec.json"), "w") as f:
        json.dump(dataclasses.asdict(spec), f)
    return 0


def build_trainer(args, device):
    """The ``ours_ms`` recipe in bf16 on the generated dataset and shard."""
    from rau_vqa_tpu_torch.config import get_experiment
    from rau_vqa_tpu_torch.data.features import PackedFeatureStore
    from rau_vqa_tpu_torch.data.loader import load_gt_annotations, load_vqa_data
    from rau_vqa_tpu_torch.train.trainer import Trainer

    vqa_dir = os.path.join(args.root, "vqa_prepro")
    exp = get_experiment("ours_ms")
    lr = getattr(args, "lr", None)
    lr_decay = getattr(args, "lr_decay", None)
    exp = exp.replace(
        model=dataclasses.replace(exp.model, compute_dtype="bfloat16",
                                  fused_train=getattr(args, "fused_train", False)),
        train=dataclasses.replace(
            exp.train, batch_size=args.batch_size, max_epochs=args.epochs,
            test_interval=1, checkpoint_interval=args.ckpt_interval,
            **({"learning_rate": lr, "mult_learning_rate": lr / 10.0} if lr else {}),
            **({"lr_decay": lr_decay, "mult_lr_decay": lr_decay}
               if lr_decay is not None else {})),
        data=dataclasses.replace(exp.data, split="val2014", vqa_dir=vqa_dir,
                                 test_batch_size=512,
                                 gt_anno=os.path.join(vqa_dir, "gt_annotations.json")))
    data = load_vqa_data(vqa_dir, args.batch_size, split="val2014", test_batch_size=512)
    src = PackedFeatureStore(os.path.join(args.root, "shard_int8"), raw_int8=True)
    gt = load_gt_annotations(os.path.join(vqa_dir, "gt_annotations.json"))
    workdir = args.workdir or os.path.join(args.root, "run")
    return Trainer(exp, data, src, workdir, gt_anno=gt, device=device), workdir


def _results_dir(args) -> str:
    out = os.path.join(args.root, "results")
    os.makedirs(out, exist_ok=True)
    return out


def cmd_train(args) -> int:
    device = torch.device(args.device)
    met = [False]

    def body() -> Dict:
        before = launch_counts()
        trainer, workdir = build_trainer(args, device)
        keys = canary_keys(device)
        best = {"train": 0.0, "test": 0.0, "epoch": 0}
        history = []
        t0 = time.time()
        for _ in range(args.epochs):
            rec = trainer.train_epoch()
            if rec.get("aborted"):
                history.append({"epoch": trainer.epoch + 1, "aborted": True,
                                "steps": rec["steps"], "exploded": rec["exploded"],
                                "sec": round(rec["sec"], 3)})
                log("epoch aborted by the explosion guard (restored); continuing")
                continue
            tr_acc = max((v for k, v in rec.items() if k.startswith("trainacc_")),
                         default=0.0)
            ev = trainer.evaluate(write_submissions=False)
            te_acc = max(ev["testOEacc"])
            history.append({"epoch": trainer.epoch, "train_acc": round(float(tr_acc), 4),
                            "test_acc": round(float(te_acc), 4),
                            "loss": round(float(rec.get("loss", float("nan"))), 4),
                            "examples_per_sec": round(rec.get("examples_per_sec", 0.0), 1),
                            "steps": rec["steps"], "sec": round(rec["sec"], 3),
                            "aborted": False})
            log(f"epoch {trainer.epoch}: best-hop train {tr_acc:.4f} test {te_acc:.4f} loss "
                f"{rec.get('loss', float('nan')):.4f} "
                f"({rec.get('examples_per_sec', 0):.0f} ex/s)")
            best["train"] = max(best["train"], tr_acc)
            if te_acc > best["test"]:
                best.update(test=te_acc, epoch=trainer.epoch)
            if tr_acc >= args.train_acc and te_acc >= args.test_acc:
                met[0] = True
                log(f"criterion met at epoch {trainer.epoch}")
                break
        wall = time.time() - t0
        out = _results_dir(args)
        ml = os.path.join(workdir, "training_log", "metrics.jsonl")
        if os.path.exists(ml):
            shutil.copy2(ml, os.path.join(out, "train_metrics.jsonl"))
        m = trainer.mcfg
        result = {"metric": "paper_dims_best_testOEacc", "value": round(best["test"], 4),
                  "unit": "accuracy",
                  "criterion": {"train": args.train_acc, "test": args.test_acc,
                                "met": met[0]},
                  "best_train_acc": round(best["train"], 4), "best_epoch": best["epoch"],
                  "epochs_run": trainer.epoch, "wall_s": round(wall, 1),
                  "dims": {"vocab": m.vocab_size, "answers": m.answer_size,
                           "rnn": m.rnn_size, "hops": m.n_hops,
                           "feat": [m.cnn_spat, m.cnn_dim]},
                  "batch_size": args.batch_size, "compute_dtype": m.compute_dtype,
                  "fused_train": m.fused_train,
                  "aborted_epochs": sum(1 for h in history if h["aborted"]),
                  "history": history,
                  "launches": {n: c for n, c in launches_since(before).items() if c},
                  **keys}
        with open(os.path.join(out, "learnability.json"), "w") as f:
            json.dump(result, f, indent=1)
        return result

    run_script("paper_dims_best_testOEacc", "accuracy", device, body, timeout_s=args.budget_s)
    return 0 if met[0] else 1


def cmd_timebox(args) -> int:
    """The production train loop for a bounded segment, and where its wall
    clock goes (the host's assembly against the copy and the card)."""
    from rau_vqa_tpu_torch.utils.checkpoint import flush_checkpoint_writes

    device = torch.device(args.device)

    def body() -> Dict:
        before = launch_counts()
        trainer, _ = build_trainer(args, device)
        # the host alone: the same loader and shard fetches, no device work
        t0 = time.time()
        n = 0
        for batch in trainer.data.train_data.batches(trainer.source):
            n += batch.tokens.shape[0]
            if n >= args.host_pass_examples:
                break
        host_dt = time.time() - t0
        host_eps = n / host_dt
        log(f"host-only pass: {n} examples in {host_dt:.1f}s = {host_eps:.0f} ex/s "
            f"(the loader and the int8 shard's fetches, no device)")
        # the pass left its generator mid-epoch: rewind the order stream
        trainer.data.train_data.reorder_count = trainer.epoch
        trainer.data.train_data.reorder()
        keys = canary_keys(device)
        t0 = time.time()
        epochs = []
        while time.time() - t0 < args.minutes * 60 and len(epochs) < args.epochs:
            rec = trainer.train_epoch()
            if rec.get("aborted"):
                log("epoch aborted; continuing")
                continue
            epochs.append({"epoch": trainer.epoch, "examples_per_sec": rec["examples_per_sec"],
                           "steps": rec["steps"], "sec": rec["sec"], "loss": rec.get("loss")})
            log(f"epoch {trainer.epoch}: {rec['examples_per_sec']:.0f} ex/s ({rec['steps']} "
                f"steps in {rec['sec']:.1f}s)")
        flush_checkpoint_writes()
        eps = epochs[-1]["examples_per_sec"] if epochs else 0.0
        feats_mb = args.batch_size * 196 * 512 / 1e6      # int8 bytes a batch
        result = {"metric": "host_pipeline_examples_per_sec", "value": round(eps, 1),
                  "unit": "ex/s", "epochs": epochs,
                  "host_only_examples_per_sec": round(host_eps, 1),
                  "int8_feats_mb_per_batch": round(feats_mb, 1),
                  "implied_transfer_mb_per_sec": round(eps / args.batch_size * feats_mb, 1),
                  "batch_size": args.batch_size,
                  "n_train": int(trainer.data.train_data.num_examples),
                  "launches": {n: c for n, c in launches_since(before).items() if c},
                  **keys}
        with open(os.path.join(_results_dir(args), "host_pipeline.json"), "w") as f:
            json.dump(result, f, indent=1)
        return result

    return run_script("host_pipeline_examples_per_sec", "ex/s", device, body,
                      timeout_s=args.budget_s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate")
    g.add_argument("--root", default=os.path.join(_REPO, ".scratch", "paper_dims"))
    g.add_argument("--n-train", type=int, default=12800)
    g.add_argument("--n-test", type=int, default=2048)
    g.add_argument("--n-images", type=int, default=800)
    g.add_argument("--n-answers", type=int, default=200)
    g.add_argument("--n-img-classes", type=int, default=8)
    g.add_argument("--class-code", default="channel", choices=("channel", "dense"))
    g.add_argument("--feat-noise", type=float, default=0.15)
    g.add_argument("--keep-t7", action="store_true")
    g.set_defaults(fn=cmd_generate)

    t = sub.add_parser("train")
    t.add_argument("--root", default=os.path.join(_REPO, ".scratch", "paper_dims"))
    t.add_argument("--workdir", default=None)
    t.add_argument("--epochs", type=int, default=20)
    t.add_argument("--batch-size", type=int, default=512)
    t.add_argument("--train-acc", type=float, default=CRIT_TRAIN)
    t.add_argument("--test-acc", type=float, default=CRIT_TEST)
    t.add_argument("--lr", type=float, default=None,
                   help="the preset's lr overridden (mult lr follows at /10)")
    t.add_argument("--lr-decay", type=float, default=None,
                   help="the preset's 0.9 an epoch overridden (1.0 = flat)")
    t.add_argument("--ckpt-interval", type=int, default=5)
    t.add_argument("--fused-train", action="store_true",
                   help="the hop loop through the training kernels (the preset's is unfused)")
    t.add_argument("--budget-s", type=float, default=5400.0)
    add_device_arg(t)
    t.set_defaults(fn=cmd_train)

    b = sub.add_parser("timebox")
    b.add_argument("--root", default=os.path.join(_REPO, ".scratch", "paper_dims_full"))
    b.add_argument("--workdir", default=None)
    b.add_argument("--minutes", type=float, default=35.0)
    b.add_argument("--epochs", type=int, default=3)
    b.add_argument("--batch-size", type=int, default=512)
    b.add_argument("--host-pass-examples", type=int, default=25600)
    b.add_argument("--ckpt-interval", type=int, default=1)
    b.add_argument("--budget-s", type=float, default=3600.0)
    add_device_arg(b)
    b.set_defaults(fn=cmd_timebox)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
