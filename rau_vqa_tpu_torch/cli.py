"""Command-line interface of the port (counterpart of ``rau_vqa_tpu/cli.py``):

    python -m rau_vqa_tpu_torch.cli train --preset ours_ms --fixture --epochs 2
    python -m rau_vqa_tpu_torch.cli train --preset ours_ms --vqa-dir ... --feat-dir ...
    python -m rau_vqa_tpu_torch.cli eval --checkpoint snapshot_....pt ...
    python -m rau_vqa_tpu_torch.cli ask --checkpoint ... --question ... --feat-name ...
    python -m rau_vqa_tpu_torch.cli fixture --out /tmp/fixture
    python -m rau_vqa_tpu_torch.cli serve --checkpoint ... --fixture --port 8080
    python -m rau_vqa_tpu_torch.cli pack-features --vqa-dir ... --feat-dir ... --out ...
    python -m rau_vqa_tpu_torch.cli precompute-features --image-root ... --out ... --backbone vgg16 --backbone-state vgg16.pth
    python -m rau_vqa_tpu_torch.cli train --preset ours_ms --fixture --backbone vgg16
    python -m rau_vqa_tpu_torch.cli convert-snapshot --input snap.t7 --output snap.pt --vocab-size ...

Every command that runs the model runs on ``--device`` (``cuda`` by default;
it raises without a card, ``--device cpu`` runs the kernels' plain
versions).  ``eval``, ``ask`` and ``serve`` read the port's ``.pt``
snapshots and the JAX package's ``.msgpack`` ones, and adopt the snapshot's
model config.  ``--fixture`` builds the fixture in memory (no ``h5py``);
``fixture`` and ``--vqa-dir`` read or write ``data_prepro.h5`` and need
``h5py``.  ``train`` and ``eval`` read raw images with ``--image-root``
through a frozen ``--backbone`` (vgg16, resnet101 or vit) loaded from
``--backbone-state``; with ``--fixture`` and no ``--image-root``,
``--backbone vgg16|resnet101`` writes the fixture's images at 64 px and
runs a random backbone from a seed.  ``train --train-backbone`` (or
``--preset ours_resnet_ft``) fine-tunes the backbone instead, as a 4th
parameter group; ``--backbone-state`` also takes a fine-tuned snapshot
(``.pt`` or ``.msgpack``), whose backbone group it reads:

    python -m rau_vqa_tpu_torch.cli train --preset ours_ms --fixture --train-backbone
    python -m rau_vqa_tpu_torch.cli train --preset ours_resnet_ft --image-root ... --backbone resnet101 --backbone-state resnet101.pth
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys


def _add_common_data_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--vqa-dir", default=None,
                   help="directory with data_prepro.{json,h5}")
    p.add_argument("--feat-dir", default=None, action="append",
                   help="feature dir (.t7 files) or packed shard dir; "
                        "repeat for multi-datatype splits")
    p.add_argument("--split", default=None,
                   choices=["train2014", "val2014", "test2015",
                            "test-dev2015"])
    p.add_argument("--gt-anno", default=None,
                   help="comprehend GT json for fast validation")
    p.add_argument("--official-anno", default=None,
                   help="official VQA annotations JSON: eval sweeps also "
                        "report the official 10-rater consensus accuracy")
    p.add_argument("--batch-order", default=None,
                   choices=["shuffle", "inorder", "sort", "randsort",
                            "imggroup"])
    p.add_argument("--test-batch-size", type=int, default=None)
    p.add_argument("--ship-int8", action="store_true",
                   help="with an int8 packed shard: ship int8 features to "
                        "the device and dequantize there")
    p.add_argument("--valid-ratio", type=float, default=None)


def _add_train_flags(p: argparse.ArgumentParser) -> None:
    from rau_vqa_tpu_torch.config import TRAIN_PRESETS
    p.add_argument("--preset", default="ours_ss", choices=sorted(TRAIN_PRESETS))
    p.add_argument("--fixture", action="store_true",
                   help="generate and use the deterministic tiny fixture")
    p.add_argument("--save-dir", default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--learning-rate", type=float, default=None)
    p.add_argument("--mult-learning-rate", type=float, default=None)
    p.add_argument("--lr-decay", type=float, default=None)
    p.add_argument("--grad-clip", type=float, default=None)
    p.add_argument("--noisy-eta", type=float, default=None)
    p.add_argument("--noisy-gamma", type=float, default=None)
    p.add_argument("--grad-accum", type=int, default=None)
    p.add_argument("--nhop", type=int, default=None)
    p.add_argument("--cnnout-dim", type=int, default=None)
    p.add_argument("--cnnout-w", type=int, default=None)
    p.add_argument("--cnnout-h", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--test-interval", type=int, default=None)
    p.add_argument("--init-from", default=None,
                   help="snapshot to resume from (.pt, or the JAX "
                        "package's .msgpack)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (params and features cast on entry)")
    p.add_argument("--eval-buckets", default=None,
                   help="comma-separated question-length buckets for the "
                        "eval sweep, e.g. 8,16")
    p.add_argument("--train-buckets", default=None,
                   help="comma-separated question-length buckets for the "
                        "train step's token axis; default 8,16, 'none' "
                        "disables")
    p.add_argument("--fused-train", action="store_true",
                   help="run the training hop loop through the fused "
                        "kernel pair")
    p.add_argument("--plain-eval", action="store_true",
                   help="eval sweeps through the plain float32 predict "
                        "instead of the serving kernels")
    p.add_argument("--backbone-feat-norm", action="store_true",
                   help="RMS-normalize each feature cell of a backbone's "
                        "output over D (recorded in the snapshot; adopted "
                        "from a fine-tuned --backbone-state's sidecar)")
    p.add_argument("--train-backbone", action="store_true",
                   help="fine-tune the backbone: it joins the train state as "
                        "a 4th parameter group and the step differentiates "
                        "through the pixels (needs --image-root, or --fixture)")
    p.add_argument("--backbone-lr-scale", type=float, default=None,
                   help="backbone LR = learning rate x this (default 0.1)")
    p.add_argument("--backbone-trust-ratio", type=float, default=None,
                   help="per-leaf backbone update cap: ||update|| <= "
                        "tau (||w|| + 1e-3) a step (default 2e-4; 0 disables)")
    p.add_argument("--no-backbone-remat", action="store_true",
                   help="no block-by-block checkpointing in the fine-tuned "
                        "backbone (more memory, no recompute)")


def _add_backbone_flags(p: argparse.ArgumentParser, images: bool) -> None:
    p.add_argument("--backbone", default=None,
                   choices=["vgg16", "resnet101", "vit"],
                   help="frozen visual backbone on the device (with "
                        "--image-root, or for serve's image_b64 requests)")
    p.add_argument("--backbone-state", default=None,
                   help="the backbone's weights: a torchvision vgg16 or "
                        "resnet101 state_dict, or a timm ViT-L/14 one (.pth), "
                        "or a fine-tuned snapshot (.pt or .msgpack)")
    if images:
        p.add_argument("--image-root", default=None,
                       help="train/eval from raw images under this root (paths "
                            "from the json's unique_img lists) through "
                            "--backbone instead of precomputed features")
        p.add_argument("--image-size", type=int, default=448)


def _add_device_flag(p: argparse.ArgumentParser, default) -> None:
    p.add_argument("--device", default=default,
                   help="cuda (the default; raises without a card) or cpu "
                        "(the kernels' plain versions)")


def _parse_buckets(raw):
    """None = not given; ''/'none'/'off' = disabled; else an int tuple."""
    if raw is None:
        return None
    s = raw.strip().lower()
    if s in ("", "none", "off"):
        return ()
    return tuple(int(x) for x in raw.split(",") if x.strip())


def _apply_overrides(exp, args):
    m, t, d = {}, {}, {}
    for flag, name in (("nhop", "n_hops"), ("cnnout_dim", "cnn_dim"),
                       ("cnnout_w", "cnn_w"), ("cnnout_h", "cnn_h")):
        if getattr(args, flag) is not None:
            m[name] = getattr(args, flag)
    if args.bf16:
        m["compute_dtype"] = "bfloat16"
    if args.fused_train:
        m["fused_train"] = True
    if args.plain_eval:
        exp = exp.replace(fused_eval=False)
    if args.backbone_feat_norm:
        # whether or not the backbone trains: the interface a backbone makes
        t["backbone_feat_norm"] = True
    # fine-tuning comes from the flag or from a preset (ours_resnet_ft)
    wants_ft = exp.train.train_backbone or args.train_backbone
    if args.train_backbone:
        if not getattr(args, "image_root", None) and not args.fixture:
            raise SystemExit("--train-backbone fine-tunes through the pixels: it "
                             "needs --image-root (+ --backbone/--backbone-state), or "
                             "--fixture for a zero-asset run")
        t["train_backbone"] = True
    if wants_ft:
        if args.backbone_lr_scale is not None:
            t["backbone_lr_scale"] = args.backbone_lr_scale
        if args.no_backbone_remat:
            t["backbone_remat"] = False
        if args.backbone_trust_ratio is not None:
            t["backbone_trust_ratio"] = args.backbone_trust_ratio
    else:
        for flag, name in (("backbone_lr_scale", "--backbone-lr-scale"),
                           ("backbone_trust_ratio", "--backbone-trust-ratio")):
            if getattr(args, flag) is not None:
                raise SystemExit(f"{name} needs --train-backbone")
        if args.no_backbone_remat:
            raise SystemExit("--no-backbone-remat needs --train-backbone")
    eb = _parse_buckets(args.eval_buckets)
    if eb is not None:
        exp = exp.replace(eval_buckets=eb)
    tb = _parse_buckets(args.train_buckets)
    if tb is not None:
        t["length_buckets"] = tb
    for flag, name in [("epochs", "max_epochs"), ("batch_size", "batch_size"),
                       ("learning_rate", "learning_rate"),
                       ("mult_learning_rate", "mult_learning_rate"),
                       ("lr_decay", "lr_decay"), ("grad_clip", "grad_clip"),
                       ("noisy_eta", "noisy_eta"),
                       ("noisy_gamma", "noisy_gamma"),
                       ("grad_accum", "grad_accum"), ("seed", "seed"),
                       ("test_interval", "test_interval")]:
        if getattr(args, flag) is not None:
            t[name] = getattr(args, flag)
    for flag in ("vqa_dir", "split", "gt_anno", "official_anno",
                 "batch_order", "test_batch_size", "valid_ratio"):
        if getattr(args, flag) is not None:
            d[flag] = getattr(args, flag)
    if args.feat_dir:
        # several dirs = per-datatype sources (vqa_prepro_loader.lua:876),
        # stored comma-separated
        d["feat_dir"] = ",".join(args.feat_dir)
    exp = exp.replace(
        model=dataclasses.replace(exp.model, **m),
        train=dataclasses.replace(exp.train, **t),
        data=dataclasses.replace(exp.data, **d))
    if args.save_dir:
        exp = exp.replace(save_dir=args.save_dir)
    return exp


def _make_feature_source(feat_dir: str, mcfg, *, ship_int8: bool = False):
    from rau_vqa_tpu_torch.data.features import (
        PackedFeatureStore,
        T7DirFeatureSource,
    )
    feat_dirs = feat_dir.split(",")
    if os.path.exists(os.path.join(feat_dirs[0], "index.json")):
        return PackedFeatureStore(feat_dirs[0], raw_int8=ship_int8)
    return T7DirFeatureSource(feat_dirs, mcfg.cnn_dim, mcfg.cnn_w, mcfg.cnn_h)


FIXTURE_IMAGE_SIZE = 64   # the fixture's images: a 2x2 grid at stride 32


def _fixture_setup(exp, workdir, images_backbone=None):
    """The tiny fixture in memory (its .t7 features under
    ``workdir/fixture/feat``), and the experiment shrunk onto it as the JAX
    CLI shrinks it.  ``images_backbone`` (a conv backbone's name) also
    writes its images at 64 px under ``workdir/fixture/images`` (the same
    questions and answers) and sizes the model for that backbone's 2x2
    grid (``rau_vqa_tpu/cli.py:458-497``).
    Returns (exp, bundle)."""
    from rau_vqa_tpu_torch.data.fixtures import FixtureSpec, fixture_bundle
    spec = FixtureSpec()
    # the same questions per image, so that the 'imggroup' order of the
    # fine-tuning run works on the fixture too
    bundle = fixture_bundle(os.path.join(workdir, "fixture"), spec,
                            images=bool(images_backbone),
                            image_size=FIXTURE_IMAGE_SIZE,
                            uniform_img_assign=bool(images_backbone))
    if images_backbone:
        cnn = dict(cnn_dim={"vgg16": 512, "resnet101": 2048}[images_backbone],
                   cnn_w=2, cnn_h=2)
    else:
        cnn = dict(cnn_dim=spec.feat_dim, cnn_w=spec.feat_w, cnn_h=spec.feat_h)
    exp = exp.replace(
        model=dataclasses.replace(
            exp.model, **cnn, embed_dim=16, rnn_size=16, multfeat_dim=16,
            attfeat_dim=8, att_rnn_size=16, embed_dropout=0.0,
            rnn_dropout=0.0, mult_dropout=0.1),
        train=dataclasses.replace(
            exp.train, batch_size=16, learning_rate=1e-2,
            mult_learning_rate=1e-2, lr_decay=1.0, mult_lr_decay=1.0,
            noisy_eta=0.0, grad_clip=10.0, max_epochs=40, length_buckets=()),
        data=dataclasses.replace(
            exp.data, split="val2014", vqa_dir="", feat_dir=bundle.feat_dir,
            test_batch_size=8, gt_anno=""))
    return exp, bundle


def _load_data(exp, args, workdir, *, batch_size=None, test_batch_size=None,
               images_backbone=None):
    """(exp, VQAData, feature source, GT map or None): the fixture in
    memory with ``--fixture`` (with its images for ``images_backbone``),
    else the files ``exp.data`` names."""
    from rau_vqa_tpu_torch.data.loader import (
        build_vqa_data,
        load_gt_annotations,
        load_vqa_data,
    )
    bs = batch_size or exp.train.batch_size
    if args.fixture:
        exp, bundle = _fixture_setup(exp, workdir, images_backbone)
        if batch_size is None:
            bs = exp.train.batch_size
        data = build_vqa_data(
            bundle.info, bundle.arrays, bs, split=exp.data.split,
            test_batch_size=test_batch_size or 8,
            valid_ratio=exp.data.valid_ratio, seed=exp.train.seed)
        gt = {int(k): v for k, v in bundle.gt.items()}
    else:
        data = load_vqa_data(
            exp.data.vqa_dir, bs, split=exp.data.split,
            test_batch_size=(test_batch_size
                             or exp.data.resolved_test_batch_size()),
            valid_ratio=exp.data.valid_ratio, seed=exp.train.seed)
        gt = None
        if exp.data.gt_anno and os.path.exists(exp.data.gt_anno):
            gt = load_gt_annotations(exp.data.gt_anno)
    source = _make_feature_source(exp.data.feat_dir, exp.model,
                                  ship_int8=bool(args.ship_int8))
    return exp, data, source, gt


def _checked_official_anno(exp):
    """Fail fast on a bad --official-anno path (the trainer reads it at
    the first eval sweep, an epoch later)."""
    p = exp.data.official_anno
    if p and not os.path.exists(p):
        raise SystemExit(f"--official-anno: {p} does not exist")
    return p or None


def _adopt_snapshot(exp, checkpoint: str):
    """The experiment with the snapshot's own model config and alg_name
    (the reference's Eval.lua adopts the snapshot's opt table, :116-118)."""
    from rau_vqa_tpu_torch.utils.checkpoint import (
        JAX_SUFFIX,
        checkpoint_meta,
        model_config_from_meta,
    )
    meta = checkpoint_meta(checkpoint)
    if "model_config" in meta:
        exp = exp.replace(model=model_config_from_meta(
            meta["model_config"], from_jax=checkpoint.endswith(JAX_SUFFIX)))
    elif "n_hops" in meta:
        exp = exp.replace(
            model=dataclasses.replace(exp.model, n_hops=meta["n_hops"]))
    if "alg_name" in meta:
        exp = exp.replace(alg_name=meta["alg_name"])
    if meta.get("backbone_feat_norm"):
        # the head learned on RMS-normalized features: eval and serve
        # featurize images the same way
        exp = exp.replace(train=dataclasses.replace(exp.train, backbone_feat_norm=True))
    return exp


def cmd_train(args) -> int:
    from rau_vqa_tpu_torch.config import get_experiment
    from rau_vqa_tpu_torch.train.trainer import Trainer

    exp = _apply_overrides(get_experiment(args.preset), args)
    workdir = args.save_dir or f"{exp.save_dir}_{exp.data.split}"
    os.makedirs(workdir, exist_ok=True)
    # train_backbone from the flag or the preset (ours_resnet_ft)
    wants_ft = exp.train.train_backbone
    if wants_ft and not args.fixture and not args.image_root:
        raise SystemExit(f"preset {exp.name!r} fine-tunes the backbone: pass "
                         f"--image-root + --backbone resnet101 + --backbone-state "
                         f"(or --fixture for the zero-asset run)")
    if wants_ft and args.fixture and not args.image_root:
        # the zero-asset fine-tune: the fixture's images and a random conv
        # backbone (VGG16 unless named)
        args.backbone = args.backbone or "vgg16"
    images_backbone = _fixture_images(args)
    exp, data, source, gt = _load_data(exp, args, workdir,
                                       images_backbone=images_backbone)
    if wants_ft and images_backbone:
        # a random backbone: the raw interface saturates the tanh head, the
        # RMS-normalized one lets the run learn the images
        exp = exp.replace(train=dataclasses.replace(exp.train, backbone_feat_norm=True))
    source, backbone, bb_params, exp = _make_source_and_backbone(
        args, exp, source, workdir, adopt_feat_norm=not args.backbone_feat_norm)
    trainer = Trainer(exp, data, source, workdir, gt_anno=gt,
                      official_anno=_checked_official_anno(exp),
                      device=args.device, backbone=backbone,
                      bb_params=bb_params, vit_cfg=_vit_cfg(backbone))
    if args.init_from:
        trainer.restore(args.init_from)
        print(f"resumed from {args.init_from} at epoch {trainer.epoch}")
    with open(os.path.join(workdir, "config.json"), "w") as f:
        # the resolved model config (vocab/answer/seq_len from the data)
        cfg_out = dataclasses.asdict(exp)
        cfg_out["model"] = dataclasses.asdict(trainer.mcfg)
        json.dump(cfg_out, f, indent=2, default=str)
    epochs = args.epochs or exp.train.max_epochs
    print(f"training {exp.name} ({trainer.mcfg.n_hops} hops) for {epochs} "
          f"epochs, {data.train_data.iter_per_epoch} iters/epoch on "
          f"{trainer.device}")
    result = trainer.fit(epochs=epochs)
    if "testOEacc" in result:
        accs = ", ".join(f"{a * 100:.2f}" for a in result["testOEacc"])
        print(f"final testOE accuracy per hop: {accs}")
    _print_decoders(source)
    print(f"done; artifacts in {workdir}")
    return 0


def cmd_eval(args) -> int:
    """Standalone evaluation (the reference's Eval.lua:113-680): load a
    snapshot, adopt its configuration, run a test sweep, write the result
    files."""
    from rau_vqa_tpu_torch.config import get_experiment
    from rau_vqa_tpu_torch.train.trainer import Trainer
    from rau_vqa_tpu_torch.utils.checkpoint import checkpoint_meta

    # the snapshot's config first, then the runtime flags
    exp = _apply_overrides(_adopt_snapshot(get_experiment(args.preset),
                                           args.checkpoint), args)
    if exp.train.train_backbone:
        # evaluation trains nothing: a fine-tuning preset evaluates from
        # features or a frozen backbone, and its training order goes too
        exp = exp.replace(
            train=dataclasses.replace(exp.train, train_backbone=False),
            data=dataclasses.replace(exp.data, batch_order="shuffle"
                                     if exp.data.batch_order == "imggroup"
                                     else exp.data.batch_order))
    meta = checkpoint_meta(args.checkpoint)
    if (args.image_root and not args.backbone_state and meta.get("train_backbone")
            and meta.get("backbone")):
        # a fine-tuned snapshot carries its trained backbone: from pixels,
        # it is the backbone (as the service adopts it)
        args.backbone = args.backbone or meta["backbone"]
        args.backbone_state = args.checkpoint
        print(f"adopting the fine-tuned {args.backbone} backbone from {args.checkpoint}")
    workdir = args.save_dir or f"save_result_eval_{exp.data.split}"
    os.makedirs(workdir, exist_ok=True)
    # only the data of the fixture: the model config stays the snapshot's
    model = exp.model
    exp, data, source, gt = _load_data(exp, args, workdir,
                                       images_backbone=_fixture_images(args))
    exp = exp.replace(model=model)
    source, backbone, bb_params, exp = _make_source_and_backbone(
        args, exp, source, workdir, adopt_feat_norm=False)
    trainer = Trainer(exp, data, source, workdir, gt_anno=gt,
                      official_anno=_checked_official_anno(exp),
                      device=args.device, backbone=backbone,
                      bb_params=bb_params, vit_cfg=_vit_cfg(backbone))
    trainer.restore(args.checkpoint)
    print(f"evaluating snapshot at epoch {trainer.epoch} "
          f"({trainer.mcfg.n_hops} hops) on {exp.data.split}")
    result = trainer.evaluate()
    if "testOEacc" in result:
        for h, a in enumerate(result["testOEacc"]):
            print(f"hop {h + 1:02d}: OE {a * 100:.2f}"
                  + (f", MC {result['testMCacc'][h] * 100:.2f}"
                     if "testMCacc" in result else ""))
    _print_decoders(source)
    print(f"result files in {workdir}/results/")
    return 0


def cmd_ask(args) -> int:
    """Answer one question about one image's features from a snapshot:
    question string -> tokens via the dataset vocab, features via the .t7
    or packed store, top-k answers of the "select" set."""
    import numpy as np

    from rau_vqa_tpu_torch.config import get_experiment
    from rau_vqa_tpu_torch.convert import map_tree
    from rau_vqa_tpu_torch.devices import pick_device
    from rau_vqa_tpu_torch.eval.predict import make_predict_step
    from rau_vqa_tpu_torch.train.trainer import init_train_state
    from rau_vqa_tpu_torch.utils.checkpoint import load_checkpoint

    device = pick_device(args.device, "ask")
    exp = _apply_overrides(_adopt_snapshot(get_experiment(args.preset),
                                           args.checkpoint), args)
    workdir = args.save_dir or "save_result_ask"
    model = exp.model
    exp, data, source, _ = _load_data(exp, args, workdir, batch_size=1,
                                      test_batch_size=1)
    mcfg = dataclasses.replace(model, vocab_size=data.vocab_size,
                               answer_size=data.answer_size,
                               seq_len=data.seq_len)
    template = init_train_state(mcfg, 0, device="cpu")._asdict()
    tree, _ = load_checkpoint(args.checkpoint, template)
    params = map_tree(lambda x: x.to(device), tree["params"])

    tokens, length = data.question_to_tokens(args.question, normalize=True)
    feats = source.get_batch([args.feat_name], [1])
    predict = make_predict_step(mcfg, device=device)
    tab_pred, _ = predict(params, tokens[None],
                          np.asarray([length], np.int32), feats)
    final = tab_pred[-1, 0].float().cpu().numpy()   # the "select" set
    top = np.argsort(final)[::-1][:args.topk]
    print(f"Q: {args.question}")
    for rank, idx in enumerate(top):
        print(f"  {rank + 1}. {data.answers[int(idx)]}  "
              f"(score {final[idx]:.3f})")
    return 0


def cmd_serve(args) -> int:
    """The HTTP inference service (``serve.py``) on ``--port``."""
    from rau_vqa_tpu_torch.config import get_experiment
    from rau_vqa_tpu_torch.data.loader import build_vqa_data
    from rau_vqa_tpu_torch.devices import pick_device
    from rau_vqa_tpu_torch.serve import RAUService, serve
    from rau_vqa_tpu_torch.utils.checkpoint import has_backbone_group

    device = pick_device(args.device, "serve")
    bb_params = None
    # a fine-tuned snapshot serves its own backbone unless one is given
    if args.backbone and (args.backbone_state or not args.checkpoint
                          or not has_backbone_group(args.checkpoint)):
        bb_params = _load_backbone_state(args.backbone, args.backbone_state,
                                         device)
    data, feat_dirs = None, list(args.feat_dir or [])
    if args.fixture:
        workdir = args.save_dir or "save_result_serve"
        _, bundle = _fixture_setup(get_experiment(args.preset), workdir)
        data = build_vqa_data(bundle.info, bundle.arrays, 1, split="val2014",
                              test_batch_size=1)
        feat_dirs = feat_dirs or [bundle.feat_dir]
    svc = RAUService(args.checkpoint, args.vqa_dir, feat_dirs,
                     preset=args.preset, artifact=args.artifact,
                     fused=not args.plain_eval, backbone=args.backbone,
                     bb_params=bb_params, vit_cfg=_vit_cfg(args.backbone),
                     buckets=_parse_buckets(args.eval_buckets),
                     max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
                     feat_cache_size=args.feat_cache,
                     request_timeout_s=args.request_timeout, data=data,
                     device=device)
    server = serve(svc, args.port)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        svc.close()
    return 0


def _load_backbone_state(backbone: str, state_path: str, device, dtype=None):
    """The backbone's tree on ``device`` in ``dtype`` (bf16 when None, the
    serving type) from a local file: a fine-tuned snapshot, the port's
    ``.pt`` or the JAX package's ``.msgpack``, whose backbone group it takes
    (a ResNet folded, ``load_backbone_group``), or else a state dict (.pth)
    of torchvision's vgg16 or resnet101 (BN folded) or timm's ViT-L/14."""
    import torch

    from rau_vqa_tpu_torch.convert import map_tree
    from rau_vqa_tpu_torch.models.backbones import resnet, vgg
    from rau_vqa_tpu_torch.models.backbones import vit as vit_mod
    from rau_vqa_tpu_torch.utils.checkpoint import JAX_SUFFIX, SUFFIX, load_backbone_group
    if not state_path:
        raise SystemExit("--backbone requires --backbone-state (a torchvision "
                         "vgg16/resnet101 or timm ViT state_dict .pth, or a "
                         "fine-tuned snapshot .pt or .msgpack)")
    dtype = dtype or torch.bfloat16
    if state_path.endswith((SUFFIX, JAX_SUFFIX)):
        tree = load_backbone_group(state_path, backbone)
        return map_tree(lambda t: t.to(device, dtype), tree)
    state = torch.load(state_path, map_location="cpu", weights_only=True)
    if backbone == "resnet101":
        tree = resnet.fold_batchnorm(resnet.resnet_from_torch_state(state))
    elif backbone == "vit":
        tree = vit_mod.vit_from_timm_state(state, vit_mod.VIT_L14)
    elif backbone == "vgg16":
        tree = vgg.vgg16_from_torch_state(state)
    else:
        raise ValueError(f"unknown backbone {backbone!r}")
    return map_tree(lambda t: t.to(device, dtype), tree)


def _vit_cfg(backbone):
    """The CLI's ViT: ViT-L/14, read when called."""
    from rau_vqa_tpu_torch.models.backbones import vit as vit_mod
    return vit_mod.VIT_L14 if backbone == "vit" else None


def _validate_backbone_image_size(backbone, size, flag):
    """The ViT's position embeddings fix its input side; the stride-32 conv
    backbones take any multiple of 32 (checked against the model's grid in
    ``_make_source_and_backbone``)."""
    if backbone == "vit":
        need = _vit_cfg("vit").image_size
        if size != need:
            raise SystemExit(f"--backbone vit uses the ViT-L/14 config, whose position "
                             f"embeddings fix the input at {need}px: pass {flag} {need}")


def _fixture_images(args):
    """The backbone whose fixture images ``--fixture --backbone`` writes
    (no ``--image-root``), else None."""
    if not (args.fixture and getattr(args, "backbone", None)
            and not getattr(args, "image_root", None)):
        return None
    if args.backbone == "vit":
        raise SystemExit("--fixture --backbone supports the conv backbones (ViT-L/14's "
                         "position embedding pins 224 px): pass --image-root and "
                         "--backbone-state")
    return args.backbone


def _make_source_and_backbone(args, exp, source, workdir, *, adopt_feat_norm=False):
    """(source, backbone, bb_params, exp): ``source`` and no backbone
    without ``--image-root``, else the images under it and the backbone on
    ``--device`` (float32; bf16 with ``--bf16`` unless it is fine-tuned,
    whose masters are float32).  With ``--fixture`` and no
    ``--backbone-state`` the backbone is random from seed 0, VGG16's He init
    scaled by 0.72 a convolution so that pool5 stays near unit scale
    (``rau_vqa_tpu/cli.py:347-445``).  A fine-tuned ``--backbone-state``
    records the feature interface it trained on: with ``adopt_feat_norm``
    the run takes it, else a mismatch is reported."""
    import torch

    from rau_vqa_tpu_torch.convert import map_tree
    from rau_vqa_tpu_torch.data.images import ImageDirSource
    from rau_vqa_tpu_torch.devices import pick_device
    from rau_vqa_tpu_torch.utils.checkpoint import checkpoint_meta
    if _fixture_images(args):
        args.image_root = os.path.join(workdir, "fixture", "images")
        args.image_size = FIXTURE_IMAGE_SIZE
    if not getattr(args, "image_root", None):
        return source, None, None, exp
    if not args.backbone:
        raise SystemExit("--image-root needs --backbone (+ --backbone-state)")
    _validate_backbone_image_size(args.backbone, args.image_size, "--image-size")
    # the backbone's grid must be the model's attention grid
    mcfg = exp.model
    if args.backbone == "vit":
        seq = _vit_cfg("vit").seq
        if seq != mcfg.cnn_spat:
            raise SystemExit(f"ViT-L/14 yields {seq} tokens but the model config "
                             f"expects cnn_spat={mcfg.cnn_spat} ({mcfg.cnn_w}x{mcfg.cnn_h})")
    else:
        # an exact multiple: the strided convs would make a larger grid
        # for any other size (479 px -> 15x15)
        if args.image_size % 32:
            raise SystemExit(f"--image-size {args.image_size} is not a multiple of 32 "
                             f"(the conv backbones are stride-32): use --image-size "
                             f"{mcfg.cnn_w * 32}")
        grid = args.image_size // 32
        if grid * grid != mcfg.cnn_spat:
            raise SystemExit(f"--image-size {args.image_size} gives a {grid}x{grid}="
                             f"{grid * grid} feature grid but the model config expects "
                             f"cnn_spat={mcfg.cnn_spat} ({mcfg.cnn_w}x{mcfg.cnn_h}): use "
                             f"--image-size {mcfg.cnn_w * 32}")
    source = ImageDirSource(args.image_root, size=args.image_size, backend="native")
    dtype = (torch.bfloat16 if args.bf16 and not exp.train.train_backbone
             else torch.float32)
    device = pick_device(args.device, "the backbone")
    if args.backbone_state or not args.fixture:
        bb = _load_backbone_state(args.backbone, args.backbone_state, device, dtype)
        meta = checkpoint_meta(args.backbone_state)
        if "backbone_feat_norm" in meta:
            # a fine-tuned snapshot: the interface its backbone trained on
            sn = bool(meta["backbone_feat_norm"])
            if sn != exp.train.backbone_feat_norm:
                if adopt_feat_norm:
                    print(f"adopting backbone_feat_norm={sn} from {args.backbone_state} "
                          f"(pass --backbone-feat-norm to override)")
                    exp = exp.replace(train=dataclasses.replace(
                        exp.train, backbone_feat_norm=sn))
                else:
                    print(f"WARNING: {args.backbone_state} was fine-tuned with "
                          f"backbone_feat_norm={sn} but this run uses "
                          f"{exp.train.backbone_feat_norm}: the feature interface "
                          f"will not match the backbone's training")
        return source, args.backbone, bb, exp
    if args.backbone == "vit":
        raise SystemExit("--fixture's random backbones are the conv backbones; "
                         "--backbone vit needs --backbone-state")
    from rau_vqa_tpu_torch.models.backbones import resnet, vgg
    print(f"fixture: random-init {args.backbone} backbone (no --backbone-state)")
    gen = torch.Generator().manual_seed(0)
    if args.backbone == "resnet101":
        return source, args.backbone, resnet.resnet101_init(gen, dtype, device), exp
    bb = vgg.vgg16_pool5_init(gen, dtype, device)
    # He init scaled by 0.72 a convolution (13 of them: pool5 std ~57 ->
    # ~0.8), else the stacked-tanh head saturates on the features
    return (source, args.backbone,
            map_tree(lambda t: t * 0.72 if t.ndim == 4 else t, bb), exp)


def _print_decoders(source) -> None:
    if hasattr(source, "decoders"):
        print(f"images decoded by: {source.decoders()}")


def cmd_pack_features(args) -> int:
    """Pack per-image .t7 features into one mmap shard.

    Source directories follow the ``datatype_train`` contract: the reference
    indexes its feature paths by each question's datatype
    (vqa_prepro_loader.lua:876), so a mixed train2014+val2014 split reads
    images from different directories.  Test images use datatype 1
    (vqa_prepro_loader.lua:1378).  Without ``data_prepro.h5``, or without
    ``h5py`` to read it, every image takes datatype 1, which only one
    feature directory can serve."""
    import numpy as np

    from rau_vqa_tpu_torch.data.features import pack_feature_dir

    with open(os.path.join(args.vqa_dir, "data_prepro.json")) as f:
        info = json.load(f)
    imgs = list(info.get("unique_img_train", []))
    dts = np.ones(len(imgs), np.int32)
    h5_path = os.path.join(args.vqa_dir, "data_prepro.h5")
    if imgs and os.path.exists(h5_path):
        try:
            import h5py
        except ImportError:
            if len(args.feat_dir) > 1:
                raise SystemExit(
                    f"{h5_path} holds each image's datatype, which needs "
                    f"h5py to read; with one --feat-dir every image is "
                    f"datatype 1") from None
        else:
            with h5py.File(h5_path, "r") as h5:
                if "datatype_train" in h5:
                    # per-question datatype -> per image (img_pos 1-based)
                    pos = np.asarray(h5["img_pos_train"], np.int64)
                    dts[pos - 1] = np.asarray(h5["datatype_train"], np.int32)
    dts = dts.tolist()
    for p in info.get("unique_img_test", []):
        imgs.append(p)
        dts.append(1)
    store = pack_feature_dir(args.feat_dir, imgs, dts, args.out,
                             args.cnnout_dim, args.cnnout_w, args.cnnout_h,
                             dtype=args.dtype)
    print(f"packed {len(store.index)} images -> {args.out}")
    return 0


def cmd_precompute_features(args) -> int:
    """Run a backbone over raw images on the device and write a packed
    feature shard, usable as ``--feat-dir`` (the reference's offline
    extraction, data/get_vgg16_pool5_448.sh; ``rau_vqa_tpu/cli.py:788-850``).
    Prints the host decoders that made the images."""
    import time

    import torch

    from rau_vqa_tpu_torch.devices import pick_device
    from rau_vqa_tpu_torch.precompute import MESH, precompute_features, scan_image_dir
    from rau_vqa_tpu_torch.utils.rigcheck import StallWatchdog

    if args.mesh_data:
        raise NotImplementedError(MESH)
    if args.vqa_dir:
        with open(os.path.join(args.vqa_dir, "data_prepro.json")) as f:
            info = json.load(f)
        rel = (list(info.get("unique_img_train", []))
               + list(info.get("unique_img_test", [])))
    else:
        rel = scan_image_dir(args.image_root)
    if not rel:
        raise SystemExit("no images found (empty --image-root scan or empty "
                         "unique_img lists)")
    _validate_backbone_image_size(args.backbone, args.size, "--size")
    device = pick_device(args.device, "precompute-features")
    bb_params = _load_backbone_state(args.backbone, args.backbone_state, device,
                                     torch.float32)
    # a device call that never returns raises nothing: end the run instead
    watchdog = StallWatchdog("precompute-features", args.stall_timeout)
    t0 = time.time()
    last = [0.0]

    def progress(done, total):
        watchdog.poke()
        now = time.time()
        if now - last[0] >= 10 or done == total:
            last[0] = now
            print(f"  {done}/{total} images ({done / max(now - t0, 1e-9):.1f} img/s)",
                  flush=True)

    try:
        store = precompute_features(
            args.image_root, rel, args.out, args.backbone, bb_params,
            size=args.size, batch_size=args.batch, dtype=args.dtype,
            backend=args.backend, compute_dtype="bfloat16" if args.bf16 else None,
            vit_cfg=_vit_cfg(args.backbone), progress=progress, device=device)
    finally:
        watchdog.cancel()
    print(f"precomputed {len(store.index)} images -> {args.out} "
          f"[S={store.spat}, D={store.dim}] dtype={args.dtype}")
    print(f"images decoded by: {store.decoder}")
    return 0


def cmd_convert_snapshot(args) -> int:
    """A reference Torch7 snapshot (.t7) -> the port's .pt snapshot, written
    at ``--output`` itself (with its .json sidecar); or with ``--to-torch``
    a .pt or .msgpack snapshot -> .t7."""
    import shutil
    import tempfile

    from rau_vqa_tpu_torch.config import get_experiment
    from rau_vqa_tpu_torch.convert import map_tree
    from rau_vqa_tpu_torch.train.trainer import init_train_state
    from rau_vqa_tpu_torch.utils import torch_convert as tc
    from rau_vqa_tpu_torch.utils.checkpoint import (
        JAX_SUFFIX,
        SUFFIX,
        checkpoint_meta,
        load_checkpoint,
        model_config_from_meta,
        save_checkpoint,
    )

    exp = _apply_overrides(get_experiment(args.preset), args)
    mcfg = dataclasses.replace(exp.model, vocab_size=args.vocab_size,
                               answer_size=args.answer_size,
                               seq_len=args.seq_len)
    if args.config_json:
        with open(args.config_json) as f:
            cfg_dict = json.load(f)
        mcfg = model_config_from_meta(cfg_dict.get("model", cfg_dict),
                                      from_jax=True)
    if args.to_torch:
        # the snapshot's own model config
        saved = checkpoint_meta(args.input)
        if "model_config" in saved:
            mcfg = model_config_from_meta(
                saved["model_config"], from_jax=args.input.endswith(JAX_SUFFIX))
        template = init_train_state(mcfg, 0, device="cpu")._asdict()
        tree, meta = load_checkpoint(args.input, template)
        tc.export_snapshot(args.output, tree["params"], mcfg,
                           it=meta.get("step", 0),
                           epoch=meta.get("epoch", 0.0))
        print(f"wrote Torch snapshot {args.output}")
        return 0
    params = tc.convert_snapshot(args.input, mcfg)
    state = init_train_state(mcfg, 0, device="cpu")
    state = state._replace(params=map_tree(lambda t, s: s.to(t.dtype),
                                           state.params, params))
    # --output literally: save_checkpoint names its files by step and
    # epoch, so it writes into a temporary directory and the pair moves
    out_dir = os.path.dirname(os.path.abspath(args.output))
    os.makedirs(out_dir, exist_ok=True)
    base = (args.output[:-len(SUFFIX)] if args.output.endswith(SUFFIX)
            else args.output)
    with tempfile.TemporaryDirectory(dir=out_dir) as td:
        path = save_checkpoint(td, 0, 0.0, state._asdict(),
                               extra={"model_config": dataclasses.asdict(mcfg),
                                      "converted_from": args.input})
        shutil.move(path, base + SUFFIX)
        shutil.move(path[:-len(SUFFIX)] + ".json", base + ".json")
    print(f"converted {args.input} -> {base}{SUFFIX}")
    return 0


def cmd_fixture(args) -> int:
    from rau_vqa_tpu_torch.data.fixtures import generate_fixture

    vqa_dir = generate_fixture(args.out)
    print(f"fixture written under {args.out} (vqa_dir: {vqa_dir})")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="rau-vqa-torch",
        description="Recurrent Answering Units VQA on PyTorch and CUDA")
    _add_device_flag(parser, "cuda")
    sub = parser.add_subparsers(dest="command", required=True)

    p_train = sub.add_parser("train", help="train a preset experiment")
    p_eval = sub.add_parser("eval", help="standalone snapshot evaluation")
    p_eval.add_argument("--checkpoint", required=True)
    p_ask = sub.add_parser("ask", help="answer one question from a snapshot")
    p_ask.add_argument("--checkpoint", required=True)
    p_ask.add_argument("--question", required=True)
    p_ask.add_argument("--feat-name", required=True,
                       help="feature file name, e.g. "
                            "COCO_val2014_000000000042.t7")
    p_ask.add_argument("--topk", type=int, default=5)
    p_serve = sub.add_parser("serve", help="HTTP inference service")
    p_serve.add_argument("--checkpoint",
                         help="snapshot (.pt, or the JAX package's .msgpack)")
    p_serve.add_argument("--artifact",
                         help="an exported artifact (not ported: refused)")
    p_serve.add_argument("--port", type=int, default=8080)
    p_serve.add_argument("--max-batch", type=int, default=16,
                         help="micro-batching group cap")
    p_serve.add_argument("--max-wait-ms", type=float, default=5.0,
                         help="longest a request waits for others to share "
                              "its dispatch; 0 disables lingering")
    p_serve.add_argument("--feat-cache", type=int, default=256,
                         help="entries of each feature LRU (host image "
                              "features, device features)")
    p_serve.add_argument("--request-timeout", type=float, default=2600.0,
                         help="seconds a request waits for its dispatch; "
                              "/healthz reports 'wedged' past it; 0 "
                              "disables")
    for p, images in ((p_train, True), (p_eval, True), (p_serve, False)):
        _add_backbone_flags(p, images)
    for p in (p_train, p_eval, p_ask, p_serve):
        _add_train_flags(p)
        _add_common_data_flags(p)
        # also after the command; the top-level value stands when absent
        _add_device_flag(p, argparse.SUPPRESS)
    p_fix = sub.add_parser("fixture", help="write the tiny test fixture "
                                           "(needs h5py)")
    p_fix.add_argument("--out", required=True)

    p_pack = sub.add_parser("pack-features",
                            help="pack per-image .t7 features into an mmap "
                                 "shard")
    p_pack.add_argument("--feat-dir", action="append", required=True)
    p_pack.add_argument("--vqa-dir", required=True)
    p_pack.add_argument("--out", required=True)
    p_pack.add_argument("--cnnout-dim", type=int, default=512)
    p_pack.add_argument("--cnnout-w", type=int, default=14)
    p_pack.add_argument("--cnnout-h", type=int, default=14)
    p_pack.add_argument("--dtype", default="float32",
                        choices=["float32", "float16", "int8"])

    p_pre = sub.add_parser(
        "precompute-features",
        help="run a backbone over raw images on the device and write a packed "
             "feature shard")
    p_pre.add_argument("--image-root", required=True,
                       help="COCO-style image directory")
    p_pre.add_argument("--out", required=True,
                       help="output shard dir (usable as --feat-dir)")
    p_pre.add_argument("--backbone", required=True,
                       choices=["vgg16", "resnet101", "vit"])
    p_pre.add_argument("--backbone-state",
                       help="the backbone's state_dict .pth (torchvision "
                            "vgg16/resnet101, timm ViT-L/14)")
    p_pre.add_argument("--vqa-dir",
                       help="enumerate images from the prepro json's "
                            "unique_img lists; default: scan --image-root")
    p_pre.add_argument("--size", type=int, default=448,
                       help="input resolution (conv backbones: 448 -> 14x14 "
                            "grid, 224 -> 7x7; vit: its config's, 224)")
    p_pre.add_argument("--stall-timeout", type=float, default=900,
                       help="end the run if no batch completes within this "
                            "many seconds; 0 disables")
    p_pre.add_argument("--batch", type=int, default=64, help="device batch")
    p_pre.add_argument("--dtype", default="float32",
                       choices=["float32", "float16", "int8"],
                       help="storage type of the shard")
    p_pre.add_argument("--bf16", action="store_true",
                       help="bfloat16 backbone compute; storage stays --dtype")
    p_pre.add_argument("--backend", default="native", choices=["native", "pil"],
                       help="host image decoder (native: libjpeg/libpng, "
                            "PIL where it cannot be built)")
    p_pre.add_argument("--mesh-data", type=int, default=0,
                       help="a device mesh (refused: still to port)")
    _add_device_flag(p_pre, argparse.SUPPRESS)

    p_conv = sub.add_parser("convert-snapshot",
                            help="Torch7 snapshot (.t7) <-> the port's .pt")
    p_conv.add_argument("--input", required=True)
    p_conv.add_argument("--output", required=True)
    p_conv.add_argument("--to-torch", action="store_true",
                        help=".pt or .msgpack -> .t7")
    p_conv.add_argument("--vocab-size", type=int, required=True)
    p_conv.add_argument("--answer-size", type=int, default=1000)
    p_conv.add_argument("--seq-len", type=int, default=26)
    p_conv.add_argument("--config-json", default=None,
                        help="model config json (e.g. a run's config.json) "
                             "in place of the preset's dims")
    _add_train_flags(p_conv)
    _add_common_data_flags(p_conv)

    args = parser.parse_args(argv)
    return {"train": cmd_train, "eval": cmd_eval, "ask": cmd_ask,
            "fixture": cmd_fixture, "serve": cmd_serve,
            "pack-features": cmd_pack_features,
            "precompute-features": cmd_precompute_features,
            "convert-snapshot": cmd_convert_snapshot}[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
