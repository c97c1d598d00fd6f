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
    python -m rau_vqa_tpu_torch.cli prepro --train train2014 q.json a.json --test val2014 vq.json --out bundle/
    python -m rau_vqa_tpu_torch.cli vqa-accuracy --results OE.json --annotations val_annotations.json
    python -m rau_vqa_tpu_torch.cli diagnose-snapshot --input snap.t7 --vocab-size ... --ref-checkpoint snap.pt
    python -m rau_vqa_tpu_torch.cli verify-released --tarball released.tar.gz --vqa-dir ... --feat-dir ...
    python -m rau_vqa_tpu_torch.cli export --checkpoint snap.pt --out art/ [--backbone resnet101 --backbone-state x.pth]
    python -m rau_vqa_tpu_torch.cli serve --artifact art/ --vqa-dir ... --feat-dir ...
    python -m rau_vqa_tpu_torch.cli bench [--batch 512] [--artifact [DIR]]
    python -m rau_vqa_tpu_torch.cli bench-pixels [--backbone resnet101] [--batch 120] [--artifact [DIR]]
    python -m rau_vqa_tpu_torch.cli profile --preset ours_ms --out trace_dir [--steps 10] [--fused-train]
    python -m rau_vqa_tpu_torch.cli doctor [--canary] [--watch]
    python -m rau_vqa_tpu_torch.cli dashboard --workdir <run dir> [--port 8000]

Every command that runs the model runs on ``--device`` (``cuda`` by default;
it raises without a card, ``--device cpu`` runs the kernels' plain
versions).  ``eval``, ``ask`` and ``serve`` read the port's ``.pt``
snapshots and the JAX package's ``.msgpack`` ones, and adopt the snapshot's
model config.  ``--fixture`` builds the fixture in memory; ``fixture``,
``prepro`` and ``--vqa-dir`` write or read ``data_prepro.h5`` through the
port's own reader and writer, ``data/hdf5.py`` (no ``h5py``).  ``train
--visatt`` dumps attention-map PNGs of the eval sweeps.  ``train`` and
``eval`` read raw images with ``--image-root``
through a frozen ``--backbone`` (vgg16, resnet101, vit or siglip) loaded from
``--backbone-state``; with ``--fixture`` and no ``--image-root``,
``--backbone vgg16|resnet101`` writes the fixture's images at 64 px and
runs a random backbone from a seed.  ``train --train-backbone`` (or
``--preset ours_resnet_ft``) fine-tunes the backbone instead, as a 4th
parameter group; ``--backbone-state`` also takes a fine-tuned snapshot
(``.pt`` or ``.msgpack``), whose backbone group it reads:

    python -m rau_vqa_tpu_torch.cli train --preset ours_ms --fixture --train-backbone
    python -m rau_vqa_tpu_torch.cli train --preset ours_resnet_ft --image-root ... --backbone resnet101 --backbone-state resnet101.pth

``export`` writes a snapshot's serving program as ``torch.export`` programs
(``eval/export.py``) that ``serve --artifact`` serves; ``bench`` and
``bench-pixels`` pass their flags to ``rau_vqa_tpu_torch/bench.py`` and
``bench_pixels.py``; ``profile`` traces train steps with ``torch.profiler``;
``doctor`` probes the rig; ``dashboard`` serves a run directory's metrics.

``train --mesh-data/--mesh-model/--tp`` and ``precompute-features
--mesh-data`` run over a device mesh (``parallel/mesh.py``), one process a
device, under ``torch.distributed.run``; rank 0 writes the run's files:

    python -m torch.distributed.run --nproc-per-node 2 -m rau_vqa_tpu_torch.cli train --preset ours_ms --fixture --mesh-data 2
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

# the backbones a flag names
BACKBONE_CHOICES = ["vgg16", "resnet101", "vit", "siglip"]


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
    p.add_argument("--mesh-data", type=int, default=None,
                   help="size of the 'data' (DP) mesh axis; -1 = the world "
                        "size / --mesh-model (one process a device, under "
                        "python -m torch.distributed.run)")
    p.add_argument("--mesh-model", type=int, default=None,
                   help="size of the 'model' (TP) mesh axis")
    p.add_argument("--tp", action="store_true",
                   help="shard the classifier + LSTM gate projections over "
                        "the 'model' axis (implies --mesh-model 2 unless set)")
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
    p.add_argument("--visatt", action="store_true",
                   help="dump attention-map PNGs during eval sweeps")
    p.add_argument("--visatt-batches", type=int, default=None,
                   help="eval batches to dump per epoch; -1 = every test "
                        "question (reference semantics)")
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
    p.add_argument("--backbone", default=None, choices=BACKBONE_CHOICES,
                   help="frozen visual backbone on the device (with "
                        "--image-root, or for serve's image_b64 requests)")
    p.add_argument("--backbone-state", default=None,
                   help="the backbone's weights: a torchvision vgg16 or "
                        "resnet101 state_dict, a timm ViT-L/14 one or a Hugging "
                        "Face SigLIP vision one (.pth), or a fine-tuned snapshot "
                        "(.pt or .msgpack)")
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
    if args.visatt:
        exp = exp.replace(visatt=True)
    if args.visatt_batches is not None:
        exp = exp.replace(visatt=True, visatt_batches=args.visatt_batches)
    me = {}
    if args.mesh_data is not None:
        me["data_axis"] = args.mesh_data
    if args.mesh_model is not None:
        me["model_axis"] = args.mesh_model
    if args.tp:
        me["shard_params_tp"] = True
        me.setdefault("model_axis", max(exp.mesh.model_axis, 2))
    if me:
        me["enabled"] = True
        exp = exp.replace(mesh=dataclasses.replace(exp.mesh, **me))
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


def _world_size() -> int:
    return int(os.environ.get("WORLD_SIZE", "1"))


def _train_mesh(exp, device):
    """The mesh of ``train``: joins the world and lays it out when a mesh
    is asked for or the command runs under ``torch.distributed.run``
    (WORLD_SIZE > 1); None otherwise."""
    if not (exp.mesh.enabled or _world_size() > 1):
        return None
    from rau_vqa_tpu_torch.parallel.mesh import init_distributed, mesh_from_config
    init_distributed(device=device)
    mesh = mesh_from_config(exp.mesh)
    print(f"mesh: {dict(mesh.shape)}"
          + (" (TP weight sharding)" if exp.mesh.shard_params_tp else ""))
    return mesh


def _in_turn(mesh, fn):
    """``fn()`` on each rank of the mesh in turn (``--fixture``: each rank
    writes the fixture's files alike, never while another reads them)."""
    if mesh is None:
        return fn()
    from rau_vqa_tpu_torch.parallel.mesh import barrier
    out = None
    for r in range(mesh.devices.size):
        if r == mesh.rank:
            out = fn()
        barrier(mesh)
    return out


def cmd_train(args) -> int:
    from rau_vqa_tpu_torch.config import get_experiment
    from rau_vqa_tpu_torch.train.trainer import Trainer

    exp = _apply_overrides(get_experiment(args.preset), args)
    workdir = args.save_dir or f"{exp.save_dir}_{exp.data.split}"
    os.makedirs(workdir, exist_ok=True)
    mesh = _train_mesh(exp, args.device)
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
    exp, data, source, gt = _in_turn(mesh if args.fixture else None, lambda: _load_data(
        exp, args, workdir, images_backbone=images_backbone))
    if wants_ft and images_backbone:
        # a random backbone: the raw interface saturates the tanh head, the
        # RMS-normalized one lets the run learn the images
        exp = exp.replace(train=dataclasses.replace(exp.train, backbone_feat_norm=True))
    source, backbone, bb_params, exp = _make_source_and_backbone(
        args, exp, source, workdir, adopt_feat_norm=not args.backbone_feat_norm)
    trainer = Trainer(exp, data, source, workdir, gt_anno=gt,
                      official_anno=_checked_official_anno(exp),
                      device=args.device if mesh is None else None, mesh=mesh,
                      backbone=backbone, bb_params=bb_params, vit_cfg=_vit_cfg(backbone))
    if args.init_from:
        trainer.restore(args.init_from)
        print(f"resumed from {args.init_from} at epoch {trainer.epoch}")
    if trainer.writer:
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


def cmd_export(args) -> int:
    """Export a snapshot's serving program to an artifact directory
    (``eval/export.py``): the parameters baked in, a symbolic batch, one
    program per token-length bucket, on ``--device``.  The default program is
    the service's (``predict_fused``, the serving kernels as custom ops);
    ``--no-fused-eval`` the plain float32 ``predict``; ``--backbone`` the
    whole from-pixels program with its backbone baked in."""
    from rau_vqa_tpu_torch.config import get_experiment
    from rau_vqa_tpu_torch.devices import pick_device
    from rau_vqa_tpu_torch.eval.export import export_pixels_predict, export_predict
    from rau_vqa_tpu_torch.train.trainer import init_train_state
    from rau_vqa_tpu_torch.utils.checkpoint import checkpoint_meta, load_checkpoint

    device = pick_device(args.device, "export")
    mcfg = _adopt_snapshot(get_experiment(args.preset), args.checkpoint).model
    if args.bf16:
        mcfg = dataclasses.replace(mcfg, compute_dtype="bfloat16")
    meta = checkpoint_meta(args.checkpoint)
    # a snapshot whose shapes differ from the config (a metadata-less one
    # under another --preset) is refused here, not baked in
    tree, _ = load_checkpoint(args.checkpoint,
                              init_train_state(mcfg, 0, device="cpu")._asdict())
    params = {g: tree["params"][g] for g in ("embed", "rnn", "mult")}
    if args.eval_buckets is None:
        # each from-pixels bucket's program bakes the whole backbone in
        args.eval_buckets = "none" if args.backbone else "8,16"
    buckets = _parse_buckets(args.eval_buckets) or ()
    fused = not args.no_fused_eval
    feat_norm = bool(meta.get("backbone_feat_norm", False))
    extra = {"source_checkpoint": os.path.abspath(args.checkpoint), "preset": args.preset,
             "step": meta.get("step"), "epoch": meta.get("epoch"),
             # a features-only artifact beside a separate backbone needs it too
             "backbone_feat_norm": feat_norm}
    if args.backbone:
        import torch
        if _vit_cfg(args.backbone) is not None:
            vcfg = _vit_cfg(args.backbone)
            args.image_size = args.image_size or vcfg.image_size
            _validate_backbone_image_size(args.backbone, args.image_size, "--image-size")
            if vcfg.seq != mcfg.cnn_spat:
                raise SystemExit(f"{_tower_name(args.backbone)} yields {vcfg.grid}x{vcfg.grid}="
                                 f"{vcfg.seq} tokens but the snapshot was trained on "
                                 f"cnn_spat={mcfg.cnn_spat} "
                                 f"({mcfg.cnn_w}x{mcfg.cnn_h})")
        else:
            # the conv backbones are stride 32: the feature grid sets the side
            args.image_size = args.image_size or mcfg.cnn_w * 32
            if args.image_size % 32:
                raise SystemExit(f"--image-size {args.image_size} is not a multiple of 32 "
                                 f"(the conv backbones are stride-32): use --image-size "
                                 f"{mcfg.cnn_w * 32}")
            grid = args.image_size // 32
            if grid * grid != mcfg.cnn_spat:
                raise SystemExit(f"--image-size {args.image_size} gives a {grid}x{grid}="
                                 f"{grid * grid} feature grid but the snapshot was trained on "
                                 f"cnn_spat={mcfg.cnn_spat} ({mcfg.cnn_w}x{mcfg.cnn_h}): use "
                                 f"--image-size {mcfg.cnn_w * 32}")
        # bf16 for the service's program (the stage kernel's type) and --bf16
        bb_dtype = torch.bfloat16 if fused or args.bf16 else torch.float32
        bb_params = _load_backbone_state(args.backbone, args.backbone_state, device, bb_dtype)
        if feat_norm:
            print("snapshot uses the RMS-normalized feature interface "
                  "(backbone_feat_norm): baked into the artifact")
        paths = export_pixels_predict(params, mcfg, args.backbone, bb_params, args.out,
                                      image_size=args.image_size, buckets=buckets,
                                      fused=fused, vit_cfg=_vit_cfg(args.backbone),
                                      feat_norm=feat_norm, device=device, extra_meta=extra)
    else:
        paths = export_predict(params, mcfg, args.out, buckets=buckets, fused=fused,
                               device=device, extra_meta=extra)
    for T, p in sorted(paths.items()):
        print(f"T={T:02d}: {p} ({os.path.getsize(p) / 1e6:.1f} MB)")
    print(f"exported {len(paths)} program(s) to {args.out} "
          f"({'the serving kernels' if fused else 'the plain predict'}, on {device.type})")
    return 0


def cmd_profile(args) -> int:
    """``torch.profiler`` over ``--steps`` train steps of the preset on
    random inputs (the first step runs outside the trace): a Chrome trace
    under ``--out``, the ops by time, and a JSON line with the step's time
    untraced and traced (each ``--steps`` steps and a synchronise) and each
    span's ``utils/spans.py`` ``read_spans`` reading a step.
    ``--fused-train`` traces the training kernels."""
    import time

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rau_vqa_tpu_torch.config import get_experiment
    from rau_vqa_tpu_torch.devices import pick_device
    from rau_vqa_tpu_torch.train.trainer import init_train_state, make_train_step
    from rau_vqa_tpu_torch.utils.spans import read_spans

    device = pick_device(args.device, "profile")
    exp = _apply_overrides(get_experiment(args.preset), args)
    mcfg, tcfg = exp.model, exp.train
    state = init_train_state(mcfg, tcfg.seed, device=device)
    step = make_train_step(mcfg, tcfg, device=device)
    rs = np.random.RandomState(0)
    B = tcfg.batch_size
    batch = [torch.as_tensor(a, device=device) for a in (
        rs.randint(1, mcfg.vocab_size, (B, mcfg.seq_len)).astype(np.int32),
        rs.randint(1, mcfg.seq_len + 1, B).astype(np.int32),
        rs.randn(B, mcfg.cnn_spat, mcfg.cnn_dim).astype(np.float32),
        rs.randint(0, mcfg.answer_size, B).astype(np.int32))]
    hop_scale = torch.ones(mcfg.n_hops, device=device)
    lr, mult_lr = tcfg.learning_rate, tcfg.mult_learning_rate

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def steps_ms(state):
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, m = step(state, *batch, hop_scale, lr, mult_lr)
        sync()
        return state, m, (time.perf_counter() - t0) * 1e3 / args.steps

    state, m = step(state, *batch, hop_scale, lr, mult_lr)    # outside the trace
    sync()
    state, m, untraced_ms = steps_ms(state)
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=activities) as prof:
        state, m, traced_ms = steps_ms(state)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "trace.json")
    prof.export_chrome_trace(path)
    averages = prof.key_averages()
    device_ms = sum(e.self_device_time_total for e in averages
                    if e.device_type == DeviceType.CUDA) / 1e3
    print(averages.table(sort_by="self_device_time_total" if device.type == "cuda"
                         else "self_cpu_time_total", row_limit=15))
    print(f"traced {args.steps} steps (loss {float(m['loss']):.4f}) -> {path}; "
          + (f"device time {device_ms:.3f} ms" if device_ms > 0
             else "no device time recorded"))
    per_step = {name: {k: (v / args.steps if v is not None else None) for k, v in r.items()}
                for name, r in read_spans(path).items()}
    print(json.dumps({"steps": args.steps, "untraced_step_ms": untraced_ms,
                      "traced_step_ms": traced_ms, "spans_a_step": per_step}))
    return 0


def cmd_doctor(args) -> int:
    """Rig health: the card, the CPU path, nvcc and a kernel's build, the
    native libraries, optionally the data directory and the bf16 canary;
    each probe in a subprocess with a timeout.  ``--watch`` polls until
    healthy."""
    import time

    from rau_vqa_tpu_torch.utils import doctor

    deadline = (time.monotonic() + args.watch_timeout
                if args.watch and args.watch_timeout > 0 else None)
    while True:
        report = doctor.run_doctor(vqa_dir=args.vqa_dir, canary=args.canary,
                                   device_timeout_s=args.device_timeout)
        if not args.watch or report["healthy"]:
            print(doctor.format_report(report), file=sys.stderr)
            print(json.dumps(report))
            return 0 if report["healthy"] else 1
        failing = ", ".join(f"{k}={c.get('status')}" for k, c in report.items()
                            if isinstance(c, dict) and c.get("status") not in (None, "ok"))
        print(f"doctor --watch: unhealthy ({failing or 'see report'}); next poll in "
              f"{args.watch_interval:.0f}s", file=sys.stderr)
        if deadline is not None and time.monotonic() >= deadline:
            print("doctor --watch: timeout, giving up", file=sys.stderr)
            print(json.dumps(report))
            return 1
        time.sleep(args.watch_interval)


def cmd_dashboard(args) -> int:
    from rau_vqa_tpu_torch.utils.dashboard import serve_dashboard

    serve_dashboard(args.workdir, args.port, args.nhop)
    return 0


def _load_backbone_state(backbone: str, state_path: str, device, dtype=None):
    """The backbone's tree on ``device`` in ``dtype`` (bf16 when None, the
    serving type) from a local file: a fine-tuned snapshot, the port's
    ``.pt`` or the JAX package's ``.msgpack``, whose backbone group it takes
    (a ResNet folded, ``load_backbone_group``), or else a state dict (.pth)
    of torchvision's vgg16 or resnet101 (BN folded), timm's ViT-L/14 or
    Hugging Face's SigLIP vision tower."""
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
    elif backbone == "siglip":
        tree = vit_mod.vit_from_hf_siglip_state(state, vit_mod.SIGLIP_SO400M_14_384)
    elif backbone == "vgg16":
        tree = vgg.vgg16_from_torch_state(state)
    else:
        raise ValueError(f"unknown backbone {backbone!r}")
    return map_tree(lambda t: t.to(device, dtype), tree)


def _vit_cfg(backbone):
    """A transformer backbone's tower (one of ``pipeline.TOWERS``), read from
    its module when called, so that a tower replaced there is the one run;
    None for the conv backbones."""
    from rau_vqa_tpu_torch.models.backbones import vit as vit_mod
    return {"vit": vit_mod.VIT_L14, "siglip": vit_mod.SIGLIP_SO400M_14_384}.get(backbone)


def _tower_name(backbone):
    from rau_vqa_tpu_torch.models import pipeline
    return pipeline.TOWER_NAMES[backbone]


def _validate_backbone_image_size(backbone, size, flag):
    """A tower's position embeddings fix its input side; the stride-32 conv
    backbones take any multiple of 32 (checked against the model's grid in
    ``_make_source_and_backbone``)."""
    vcfg = _vit_cfg(backbone)
    if vcfg is not None:
        need = vcfg.image_size
        if size != need:
            raise SystemExit(f"--backbone {backbone} uses the {_tower_name(backbone)} config, "
                             f"whose position embeddings fix the input at {need}px: pass "
                             f"{flag} {need}")


def _fixture_images(args):
    """The backbone whose fixture images ``--fixture --backbone`` writes
    (no ``--image-root``), else None."""
    if not (args.fixture and getattr(args, "backbone", None)
            and not getattr(args, "image_root", None)):
        return None
    if _vit_cfg(args.backbone) is not None:
        raise SystemExit("--fixture --backbone supports the conv backbones (a tower's "
                         "position embedding pins its side): pass --image-root and "
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
    vcfg = _vit_cfg(args.backbone)
    if vcfg is not None:
        seq = vcfg.seq
        if seq != mcfg.cnn_spat:
            raise SystemExit(f"{_tower_name(args.backbone)} yields {seq} tokens but the model "
                             f"config expects cnn_spat={mcfg.cnn_spat} ({mcfg.cnn_w}x{mcfg.cnn_h})")
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
    if _vit_cfg(args.backbone) is not None:
        raise SystemExit("--fixture's random backbones are the conv backbones; "
                         f"--backbone {args.backbone} needs --backbone-state")
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
    (vqa_prepro_loader.lua:1378).  Without ``data_prepro.h5`` every image
    takes datatype 1, which only one feature directory can serve."""
    import numpy as np

    from rau_vqa_tpu_torch.data.features import pack_feature_dir
    from rau_vqa_tpu_torch.data.hdf5 import h5_names, read_h5

    with open(os.path.join(args.vqa_dir, "data_prepro.json")) as f:
        info = json.load(f)
    imgs = list(info.get("unique_img_train", []))
    dts = np.ones(len(imgs), np.int32)
    h5_path = os.path.join(args.vqa_dir, "data_prepro.h5")
    if imgs and os.path.exists(h5_path) and "datatype_train" in h5_names(h5_path):
        # per-question datatype -> per image (img_pos 1-based)
        h5 = read_h5(h5_path, ["img_pos_train", "datatype_train"])
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
    from rau_vqa_tpu_torch.precompute import precompute_features, scan_image_dir
    from rau_vqa_tpu_torch.utils.rigcheck import StallWatchdog

    mesh = None
    if args.mesh_data or _world_size() > 1:
        # the extraction batch sharded over a 'data' mesh of the world
        from rau_vqa_tpu_torch.parallel.mesh import init_distributed, make_mesh
        init_distributed(device=args.device)
        mesh = make_mesh(n_data=args.mesh_data or -1, n_model=1)
        print(f"mesh: {dict(mesh.shape)}")
        args.device = str(mesh.device)
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
    if args.size is None:
        vcfg = _vit_cfg(args.backbone)
        args.size = vcfg.image_size if vcfg is not None else 448
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
            vit_cfg=_vit_cfg(args.backbone), progress=progress, device=device, mesh=mesh)
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


def cmd_vqa_accuracy(args) -> int:
    """Score an OE submission with the official VQA metric locally, the
    evaluation the reference leaves to the VQA server (it only writes the
    result JSONs, Ours_SS/...lua:1171-1186)."""
    from rau_vqa_tpu_torch.eval.vqa_accuracy import evaluate_files

    rep = evaluate_files(args.results, args.annotations,
                         precision=args.precision)
    print(f"overall: {rep['overall']:.{args.precision}f}  "
          f"(n={rep['n']}, unannotated result rows: {rep['missing']})")
    for section in ("per_answer_type", "per_question_type"):
        rows = rep[section]
        if section == "per_question_type" and not args.question_types:
            continue
        print(section + ":")
        for k, v in rows.items():
            print(f"  {k}: {v:.{args.precision}f}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rep, f, indent=1)
        print(f"report -> {args.out}")
    return 0


def cmd_prepro(args) -> int:
    """Build data_prepro.{json,h5} from the official VQA v1 release JSONs,
    the preprocessing the reference only downloads (data/get_vqa_prepro.sh);
    the h5 is written by ``data/hdf5.py``."""
    from rau_vqa_tpu_torch.data.prepro import PreproConfig, build_prepro, join_split

    train_sources = []
    for split, qjson, ajson in args.train:
        train_sources.append((split, join_split(qjson, ajson, split)))
    test_split, test_q = args.test
    test_entries = join_split(test_q, args.test_annotations, test_split)
    if args.test_mc:
        # overlay multiple_choices from the MC-task questions file
        mc_entries = {e.question_id: e.multiple_choices
                      for e in join_split(args.test_mc, None, test_split)}
        for e in test_entries:
            e.multiple_choices = mc_entries.get(e.question_id,
                                                e.multiple_choices)
    cfg = PreproConfig(num_answers=args.num_answers,
                       max_length=args.max_length,
                       word_threshold=args.word_threshold)
    summary = build_prepro(train_sources, test_entries, args.out, cfg)
    print(f"prepro -> {args.out}: {summary['n_train']} train questions "
          f"({summary['n_dropped']} dropped outside the top-"
          f"{summary['n_answers']} answers), {summary['n_test']} test, "
          f"vocab {summary['vocab_size']}"
          + (f", gt map {summary['gt_annotations']}"
             if summary["gt_annotations"] else ""))
    return 0


def cmd_diagnose_snapshot(args) -> int:
    """Diagnose a reference Torch snapshot's flat-vector layout against the
    reconstructed order (``utils/layout_diag.py``): size segmentation,
    ambiguity classes, and, given a trusted snapshot (``--ref-checkpoint``,
    the port's .pt or the JAX package's .msgpack), the order recovered by
    content with a repair diff."""
    from rau_vqa_tpu_torch.config import get_experiment
    from rau_vqa_tpu_torch.train.trainer import init_train_state
    from rau_vqa_tpu_torch.utils import layout_diag as ld
    from rau_vqa_tpu_torch.utils import torch_convert as tc
    from rau_vqa_tpu_torch.utils.checkpoint import load_checkpoint

    exp = _apply_overrides(get_experiment(args.preset), args)
    mcfg = dataclasses.replace(exp.model, vocab_size=args.vocab_size,
                               answer_size=args.answer_size,
                               seq_len=args.seq_len)
    flats = tc.snapshot_flats(args.input)
    print(ld.layout_report(mcfg))
    ok = True
    for group, flat in zip(("embed", "rnn", "mult"), flats):
        want = tc.group_size(mcfg, group)
        status = "OK" if flat.size == want else "MISMATCH"
        ok = ok and flat.size == want
        print(f"{group}: snapshot {flat.size} vs config {want} elements "
              f"[{status}]")
    if not ok:
        print("size mismatch: fix model dims before diagnosing order")
        return 1
    if args.ref_checkpoint:
        template = init_train_state(mcfg, 0, device="cpu")._asdict()
        tree, _ = load_checkpoint(args.ref_checkpoint, template)
        params = tree["params"]
        for group, flat in zip(("embed", "rnn", "mult"), flats):
            rec = ld.align_flat_by_content(flat, mcfg, group, params[group])
            diff = ld.layout_diff(mcfg, group, rec)
            if diff:
                print(f"{group}: ORDER MISMATCH —")
                for d in diff:
                    print(f"  {d}")
            else:
                print(f"{group}: order matches GROUP_LAYOUTS")
    return 0


def cmd_verify_released(args) -> int:
    """Released-snapshot parity in one command (``eval/released.py``):
    extract the reference tarball, convert its snapshot, run the eval sweep
    on ``--device``, diff against the result JSONs the tarball ships.
    Exits 1 when a compared hop agrees below ``--min-agree``."""
    from rau_vqa_tpu_torch.config import get_experiment
    from rau_vqa_tpu_torch.data import t7
    from rau_vqa_tpu_torch.data.loader import load_gt_annotations, load_vqa_data
    from rau_vqa_tpu_torch.eval.released import (
        adopt_snapshot_opt,
        extract_tarball,
        pick_snapshot,
        verify_released,
    )
    from rau_vqa_tpu_torch.utils.checkpoint import model_config_from_meta

    exp = _apply_overrides(get_experiment(args.preset), args)
    if args.model_json:
        with open(args.model_json) as f:
            cfg_dict = json.load(f)
        exp = exp.replace(model=model_config_from_meta(
            cfg_dict.get("model", cfg_dict), from_jax=True))
    workdir = args.save_dir or f"save_result_verify_{exp.data.split}"
    os.makedirs(workdir, exist_ok=True)

    if args.tarball:
        root = extract_tarball(args.tarball, os.path.join(workdir, "released"))
    else:
        root = args.extracted
    # the snapshot's own dims before the feature source is built (a ResNet
    # tarball sets cnn_dim 2048 here)
    snap_epoch, snap_path = pick_snapshot(root, args.epoch)
    snap = t7.load_t7(snap_path)     # parsed once; handed to the harness
    if isinstance(snap, dict) and "opt" in snap:
        exp = adopt_snapshot_opt(exp, snap["opt"])
    data = load_vqa_data(
        exp.data.vqa_dir, exp.train.batch_size, split=exp.data.split,
        test_batch_size=exp.data.resolved_test_batch_size(),
        valid_ratio=exp.data.valid_ratio, seed=exp.train.seed)
    source = _make_feature_source(exp.data.feat_dir, exp.model,
                                  ship_int8=bool(args.ship_int8))
    gt = None
    if exp.data.gt_anno and os.path.exists(exp.data.gt_anno):
        gt = load_gt_annotations(exp.data.gt_anno)

    report = verify_released(root, exp, data, source, workdir,
                             epoch=args.epoch, gt_anno=gt,
                             official_anno=_checked_official_anno(exp),
                             snapshot=(snap_epoch, snap_path, snap),
                             device=args.device)
    out_path = os.path.join(workdir, "verify_released_report.json")
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)
    if report.get("error") == "layout":
        print("LAYOUT MISMATCH — flat-vector sizes disagree with the "
              "config:")
        for g, sz in report["sizes"].items():
            print(f"  {g}: snapshot {sz['snapshot']} vs config {sz['config']}")
        print(f"full segmentation report in {out_path}; run "
              f"`diagnose-snapshot` for order recovery")
        return 1
    if report.get("error") == "no_result_jsons":
        print(f"snapshot evaluated (epoch {report['epoch']}) but the "
              f"tarball ships no result JSONs to diff against")
        return 1
    for h, hr in sorted(report["hops"].items(), key=lambda kv: int(kv[0])):
        line = f"hop {int(h):02d}:"
        for task in ("oe", "mc"):
            if task in hr:
                d = hr[task]
                line += (f"  {task.upper()} agree "
                         f"{d['agree'] * 100:.3f}% ({d['n_common']} qs"
                         + (", QID SET MISMATCH" if d["qid_mismatch"]
                            else "") + ")")
                if "official_ours" in d:
                    line += (f" official {d['official_ours'] * 100:.2f}"
                             f" vs released "
                             f"{d['official_released'] * 100:.2f}")
        print(line)
    print(f"min agreement {report['min_agree'] * 100:.3f}% "
          f"(threshold {args.min_agree * 100:.1f}%); report: {out_path}")
    return 0 if report["min_agree"] >= args.min_agree else 1


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
                         help="an artifact directory from `export`, in place of "
                              "--checkpoint (its model config, ladder and program)")
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
    p_fix = sub.add_parser("fixture", help="write the tiny test fixture (its "
                                           "h5 by data/hdf5.py)")
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
                       choices=BACKBONE_CHOICES)
    p_pre.add_argument("--backbone-state",
                       help="the backbone's state_dict .pth (torchvision "
                            "vgg16/resnet101, timm ViT-L/14, Hugging Face "
                            "SigLIP so400m/14-384)")
    p_pre.add_argument("--vqa-dir",
                       help="enumerate images from the prepro json's "
                            "unique_img lists; default: scan --image-root")
    p_pre.add_argument("--size", type=int, default=None,
                       help="input resolution (conv backbones: 448, the default, "
                            "-> 14x14 grid, 224 -> 7x7; vit and siglip: their "
                            "config's, 224 and 384, the default)")
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
                       help="shard the extraction batch over a 'data' mesh of "
                            "this many ranks (the world, under python -m "
                            "torch.distributed.run); --batch must divide by it")
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

    p_pp = sub.add_parser(
        "prepro",
        help="build data_prepro.{json,h5} from the official VQA v1 release "
             "JSONs (the preprocessing the reference only downloads)")
    p_pp.add_argument("--train", nargs=3, action="append", required=True,
                      metavar=("SPLIT", "QUESTIONS", "ANNOTATIONS"),
                      help="a train source; repeat for mixed layouts "
                           "(order defines the 1-based datatype index), "
                           "e.g. --train train2014 q.json a.json "
                           "--train val2014 q2.json a2.json")
    p_pp.add_argument("--test", nargs=2, required=True,
                      metavar=("SPLIT", "QUESTIONS"),
                      help="the eval split, e.g. --test val2014 q.json")
    p_pp.add_argument("--test-annotations", default=None,
                      help="annotations for an annotated eval split; also "
                           "emits the comprehend-format gt_annotations.json")
    p_pp.add_argument("--test-mc", default=None,
                      help="MultipleChoice questions json for the eval "
                           "split (fills MC_ans_test)")
    p_pp.add_argument("--out", required=True)
    p_pp.add_argument("--num-answers", type=int, default=1000,
                      help="top-N answer vocabulary (train rows outside it "
                           "are dropped, like the published prepro)")
    p_pp.add_argument("--max-length", type=int, default=26)
    p_pp.add_argument("--word-threshold", type=int, default=0,
                      help="words with count <= threshold become UNK")

    p_acc = sub.add_parser(
        "vqa-accuracy",
        help="score an OE submission with the official VQA metric "
             "(10-rater consensus + official normalization) locally")
    p_acc.add_argument("--results", required=True,
                       help="OE result JSON (what train/eval write: "
                            "[{question_id, answer}, ...])")
    p_acc.add_argument("--annotations", required=True,
                       help="official VQA v1 annotations JSON for the "
                            "evaluated split")
    p_acc.add_argument("--out", default=None,
                       help="also write the full report JSON here")
    p_acc.add_argument("--precision", type=int, default=2)
    p_acc.add_argument("--question-types", action="store_true",
                       help="print the (long) per-question-type table")

    p_diag = sub.add_parser("diagnose-snapshot",
                            help="diagnose a Torch snapshot's flat-vector "
                                 "layout (sizes, ambiguity classes, order)")
    p_diag.add_argument("--input", required=True, help="snapshot .t7")
    p_diag.add_argument("--ref-checkpoint", default=None,
                        help="trusted snapshot (.pt, or the JAX package's "
                             ".msgpack) for content-based order recovery")
    p_diag.add_argument("--vocab-size", type=int, required=True)
    p_diag.add_argument("--answer-size", type=int, default=1000)
    p_diag.add_argument("--seq-len", type=int, default=26)
    _add_train_flags(p_diag)
    _add_common_data_flags(p_diag)

    p_ver = sub.add_parser("verify-released",
                           help="released-snapshot parity: convert a "
                                "reference tarball's snapshot, evaluate it, "
                                "diff against its own result JSONs")
    group = p_ver.add_mutually_exclusive_group(required=True)
    group.add_argument("--tarball", help="released .tar.gz (a local file)")
    group.add_argument("--extracted", help="already-extracted tarball root")
    p_ver.add_argument("--epoch", type=float, default=None,
                       help="snapshot epoch to verify (default: highest)")
    p_ver.add_argument("--min-agree", type=float, default=0.999,
                       help="per-hop answer agreement threshold for exit 0")
    p_ver.add_argument("--model-json", default=None,
                       help="model-config json overriding preset dims "
                            "(dims the snapshot opt table doesn't carry)")
    _add_train_flags(p_ver)
    _add_common_data_flags(p_ver)
    _add_device_flag(p_ver, argparse.SUPPRESS)

    p_exp = sub.add_parser("export", help="export a snapshot's serving program as "
                                          "torch.export programs (.pt2)")
    p_exp.add_argument("--checkpoint", required=True,
                       help="snapshot (.pt, or the JAX package's .msgpack)")
    p_exp.add_argument("--out", required=True, help="artifact directory")
    p_exp.add_argument("--preset", default="ours_ms",
                       help="the config where the snapshot records none")
    p_exp.add_argument("--eval-buckets", default=None,
                       help="token-length bucket ladder ('none' = seq_len only); default "
                            "8,16, and none with --backbone (every bucket's program bakes "
                            "the whole backbone in)")
    p_exp.add_argument("--bf16", action="store_true",
                       help="compute_dtype bfloat16 in the plain program (--no-fused-eval) "
                            "and a bf16 backbone; the fused program's kernels are bf16 "
                            "already")
    p_exp.add_argument("--no-fused-eval", action="store_true",
                       help="export the plain float32 predict (the JAX artifact's program) "
                            "instead of the serving kernels")
    p_exp.add_argument("--backbone", default=None, choices=BACKBONE_CHOICES,
                       help="export the from-pixels program (uint8 images + tokens -> "
                            "answers, the backbone baked in)")
    p_exp.add_argument("--backbone-state", default=None,
                       help="the backbone's weights (.pth state dict, or a fine-tuned "
                            "snapshot .pt / .msgpack)")
    p_exp.add_argument("--image-size", type=int, default=None,
                       help="input side of a --backbone artifact (default: the snapshot's "
                            "grid, cnn_w * 32; the ViT's 224)")
    _add_device_flag(p_exp, argparse.SUPPRESS)

    sub.add_parser("bench", add_help=False,
                   help="serving throughput bench (one JSON line); flags pass through "
                        "to rau_vqa_tpu_torch/bench.py")
    sub.add_parser("bench-pixels", add_help=False,
                   help="from-pixels bench (one JSON line); flags pass through to "
                        "rau_vqa_tpu_torch/bench_pixels.py")

    p_prof = sub.add_parser("profile", help="trace N train steps with torch.profiler")
    p_prof.add_argument("--out", required=True, help="trace output directory")
    p_prof.add_argument("--steps", type=int, default=10)
    _add_train_flags(p_prof)
    _add_common_data_flags(p_prof)
    _add_device_flag(p_prof, argparse.SUPPRESS)

    p_doc = sub.add_parser("doctor", help="rig health: the card, nvcc, the native "
                                          "libraries, each probe with a timeout")
    p_doc.add_argument("--vqa-dir", default=None, help="also check the data bundle's files")
    p_doc.add_argument("--canary", action="store_true",
                       help="run the chained bf16 matmul canary on the card")
    p_doc.add_argument("--device-timeout", type=float, default=180.0,
                       help="seconds before a device probe is declared hung")
    p_doc.add_argument("--watch", action="store_true",
                       help="poll until healthy, then exit 0")
    p_doc.add_argument("--watch-interval", type=float, default=120.0,
                       help="seconds between --watch polls")
    p_doc.add_argument("--watch-timeout", type=float, default=0.0,
                       help="give up (exit 1) after this many seconds; 0 = wait forever")

    p_dash = sub.add_parser("dashboard", help="live HTTP dashboard over a run directory")
    p_dash.add_argument("--workdir", required=True)
    p_dash.add_argument("--port", type=int, default=8000)
    p_dash.add_argument("--nhop", type=int, default=8)

    raw = list(sys.argv[1:] if argv is None else argv)
    # the benches own their flags: pass everything after the command through,
    # with a leading --device
    lead = raw[:2] if raw[:1] == ["--device"] else raw[:1] if raw[:1] and \
        raw[0].startswith("--device=") else []
    rest = raw[len(lead):]
    if rest[:1] == ["bench"]:
        from rau_vqa_tpu_torch.bench import main as bench_main
        return bench_main(lead + rest[1:])
    if rest[:1] == ["bench-pixels"]:
        from rau_vqa_tpu_torch.bench_pixels import main as bench_pixels_main
        return bench_pixels_main(lead + rest[1:])

    args = parser.parse_args(raw)
    return {"train": cmd_train, "eval": cmd_eval, "ask": cmd_ask,
            "fixture": cmd_fixture, "serve": cmd_serve,
            "pack-features": cmd_pack_features,
            "precompute-features": cmd_precompute_features,
            "convert-snapshot": cmd_convert_snapshot,
            "prepro": cmd_prepro, "vqa-accuracy": cmd_vqa_accuracy,
            "diagnose-snapshot": cmd_diagnose_snapshot,
            "verify-released": cmd_verify_released, "export": cmd_export,
            "profile": cmd_profile, "doctor": cmd_doctor,
            "dashboard": cmd_dashboard}[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
