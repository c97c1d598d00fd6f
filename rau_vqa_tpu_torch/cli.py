"""Command-line interface of the port (counterpart of ``rau_vqa_tpu/cli.py``):

    python -m rau_vqa_tpu_torch.cli train --preset ours_ms --fixture --epochs 2
    python -m rau_vqa_tpu_torch.cli train --preset ours_ms --vqa-dir ... --feat-dir ...
    python -m rau_vqa_tpu_torch.cli eval --checkpoint snapshot_....pt ...
    python -m rau_vqa_tpu_torch.cli ask --checkpoint ... --question ... --feat-name ...
    python -m rau_vqa_tpu_torch.cli fixture --out /tmp/fixture

Every command runs on ``--device`` (``cuda`` by default; it raises without a
card, ``--device cpu`` runs the kernels' plain versions).  ``eval`` and
``ask`` read the port's ``.pt`` snapshots and the JAX package's
``.msgpack`` ones, and adopt the snapshot's model config.  ``train
--fixture`` builds the fixture in memory (no ``h5py``); ``fixture`` and
``--vqa-dir`` read or write ``data_prepro.h5`` and need ``h5py``.
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


def _fixture_setup(exp, workdir):
    """The tiny fixture in memory (its .t7 features under
    ``workdir/fixture/feat``), and the experiment shrunk onto it as the JAX
    CLI shrinks it.  Returns (exp, bundle)."""
    from rau_vqa_tpu_torch.data.fixtures import FixtureSpec, fixture_bundle
    spec = FixtureSpec()
    bundle = fixture_bundle(os.path.join(workdir, "fixture"), spec)
    exp = exp.replace(
        model=dataclasses.replace(
            exp.model, cnn_dim=spec.feat_dim, cnn_w=spec.feat_w,
            cnn_h=spec.feat_h, embed_dim=16, rnn_size=16, multfeat_dim=16,
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


def _load_data(exp, args, workdir, *, batch_size=None, test_batch_size=None):
    """(exp, VQAData, feature source, GT map or None): the fixture in
    memory with ``--fixture``, else the files ``exp.data`` names."""
    from rau_vqa_tpu_torch.data.loader import (
        build_vqa_data,
        load_gt_annotations,
        load_vqa_data,
    )
    bs = batch_size or exp.train.batch_size
    if args.fixture:
        exp, bundle = _fixture_setup(exp, workdir)
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
    return exp


def cmd_train(args) -> int:
    from rau_vqa_tpu_torch.config import get_experiment
    from rau_vqa_tpu_torch.train.trainer import Trainer

    exp = _apply_overrides(get_experiment(args.preset), args)
    workdir = args.save_dir or f"{exp.save_dir}_{exp.data.split}"
    os.makedirs(workdir, exist_ok=True)
    exp, data, source, gt = _load_data(exp, args, workdir)
    trainer = Trainer(exp, data, source, workdir, gt_anno=gt,
                      official_anno=_checked_official_anno(exp),
                      device=args.device)
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
    print(f"done; artifacts in {workdir}")
    return 0


def cmd_eval(args) -> int:
    """Standalone evaluation (the reference's Eval.lua:113-680): load a
    snapshot, adopt its configuration, run a test sweep, write the result
    files."""
    from rau_vqa_tpu_torch.config import get_experiment
    from rau_vqa_tpu_torch.train.trainer import Trainer

    # the snapshot's config first, then the runtime flags
    exp = _apply_overrides(_adopt_snapshot(get_experiment(args.preset),
                                           args.checkpoint), args)
    workdir = args.save_dir or f"save_result_eval_{exp.data.split}"
    os.makedirs(workdir, exist_ok=True)
    # only the data of the fixture: the model config stays the snapshot's
    model = exp.model
    exp, data, source, gt = _load_data(exp, args, workdir)
    exp = exp.replace(model=model)
    trainer = Trainer(exp, data, source, workdir, gt_anno=gt,
                      official_anno=_checked_official_anno(exp),
                      device=args.device)
    trainer.restore(args.checkpoint)
    print(f"evaluating snapshot at epoch {trainer.epoch} "
          f"({trainer.mcfg.n_hops} hops) on {exp.data.split}")
    result = trainer.evaluate()
    if "testOEacc" in result:
        for h, a in enumerate(result["testOEacc"]):
            print(f"hop {h + 1:02d}: OE {a * 100:.2f}"
                  + (f", MC {result['testMCacc'][h] * 100:.2f}"
                     if "testMCacc" in result else ""))
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
    for p in (p_train, p_eval, p_ask):
        _add_train_flags(p)
        _add_common_data_flags(p)
        # also after the command; the top-level value stands when absent
        _add_device_flag(p, argparse.SUPPRESS)
    p_fix = sub.add_parser("fixture", help="write the tiny test fixture "
                                           "(needs h5py)")
    p_fix.add_argument("--out", required=True)

    args = parser.parse_args(argv)
    return {"train": cmd_train, "eval": cmd_eval, "ask": cmd_ask,
            "fixture": cmd_fixture}[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
