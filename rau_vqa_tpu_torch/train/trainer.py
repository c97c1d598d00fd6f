"""The train step: forward, joint loss, backward, gradient noise, per-group
clip and per-group Adam with two learning rates.

Counterpart of ``TrainState``, ``init_train_state`` and ``make_train_step``
in ``rau_vqa_tpu/train/trainer.py`` (reference
Ours_SS/LstmAttCtrlGradNoiseDontSelect.lua:478-629).  The step runs either
training configuration of ``models/rau.py``: unfused (the presets'), or
fused (``ModelConfig.fused_train``), whose hop loop forward and backward are
the CUDA kernels of ``ops/rau_train_hops.py`` on the card and their plain
versions on the CPU; in float32 or, with ``compute_dtype="bfloat16"``, on
bf16 casts of the params, whose grads reach the float32 params through the
cast.

With ``TrainConfig.train_backbone`` (backbone fine-tuning) the backbone is
a 4th parameter group, ``"backbone"``, with float32 masters and Adam
moments: the step takes uint8 images and runs preprocess, the backbone, the
head, the joint loss and the backward through all of them, and the group
gets its own LR, the trust-ratio cap and the zero-signal freeze
(``rau_vqa_tpu/train/trainer.py:60-233``).  Under ``compute_dtype=
"bfloat16"`` the backbone computes on a bf16 cast of its masters made in
the step, as the head does; in float32 it runs float32.  The step leaves
the process's TF32 switches as they are.

Random draws come from ``torch.Generator``s that the step derives from the
state's seed and step count, so a step is a function of its state and its
inputs: the forward's dropout from stream 0, group g's gradient noise from
stream 1 + g (the backbone's, with ``backbone_grad_noise``, from 1 + 3).

``Trainer`` is the host loop around the step (``rau_vqa_tpu/train/
trainer.py:236-1156``): epochs over the loader, LR decay (reference
:1211-1220), the loss-explosion guard, the eval sweep that writes the
per-hop submission files, checkpoints, restore and resume.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
import warnings
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from rau_vqa_tpu_torch.config import ExperimentConfig, ModelConfig, TrainConfig
from rau_vqa_tpu_torch.convert import map_tree, tree_leaves
from rau_vqa_tpu_torch.data.features import (
    FeatureSource,
    QuantFeats,
    check_feat_interface,
)
from rau_vqa_tpu_torch.data.loader import VQAData
from rau_vqa_tpu_torch.devices import pick_device
from rau_vqa_tpu_torch.models.pipeline import extract_features
from rau_vqa_tpu_torch.eval.predict import (
    bucket_ladder,
    compute_answers,
    make_predict_step,
    pick_bucket,
    predict,
)
from rau_vqa_tpu_torch.eval.submission import write_results
from rau_vqa_tpu_torch.models.rau import init_params, rau_forward
from rau_vqa_tpu_torch.ops.rau_train_hops import check_fused_config, dot_dtype
from rau_vqa_tpu_torch.train.losses import hop_grad_scale, joint_loss_and_metrics
from rau_vqa_tpu_torch.train.optim import (
    adam_init,
    adam_update,
    add_gradient_noise,
    clip_by_global_norm,
    leaf_norms,
    tree_norm,
    trust_ratio_cap,
)
from rau_vqa_tpu_torch.utils.checkpoint import (
    flush_checkpoint_writes,
    has_backbone_group,
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
    to_host,
)
from rau_vqa_tpu_torch.utils.logging import MetricsLogger, per_hop_record

PARAM_GROUPS = ("embed", "rnn", "mult")

# Metric keys that are sums over the batch (the rest are batch means): under
# gradient accumulation sums add across microbatches and means average.
_SUM_METRICS = ("do_pred_acc_num", "do_pred_acc_den")


class TrainState(NamedTuple):
    params: Dict
    opt: Dict      # one Adam state per group (reference :769-775)
    step: int      # completed iterations
    seed: int      # step k's generators derive from (seed, k)


def _generator(device: torch.device, seed: int, step: int,
               stream: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(((seed * 1_000_003 + step) * 16 + stream) % 2 ** 63)
    return g


def init_train_state(mcfg: ModelConfig, seed: int, *, device=None,
                     bb_params=None) -> TrainState:
    """Fresh parameters from ``seed`` and zero Adam moments, on ``device``
    (``cuda`` when None, as ``make_train_step``).  With ``bb_params`` the
    backbone joins as a 4th group, ``"backbone"``: every leaf of the tree
    given is trained (a plain ResNet's BN statistics too, as the JAX
    package's ``value_and_grad`` over the whole tree), its masters and Adam
    moments float32 (``rau_vqa_tpu/train/trainer.py:60-74``)."""
    device = pick_device(device, "init_train_state")
    params = init_params(mcfg, torch.Generator().manual_seed(seed), device)
    groups = PARAM_GROUPS
    if bb_params is not None:
        params["backbone"] = map_tree(
            lambda t: torch.as_tensor(t).to(device, torch.float32), bb_params)
        groups += ("backbone",)
    return TrainState(params=params, opt={g: adam_init(params[g]) for g in groups},
                      step=0, seed=seed)


def head_params(params: Dict) -> Dict:
    """The head's three groups of a train state's params (``rau_forward``
    and the predict steps take these; under fine-tuning the state also
    holds ``"backbone"``): ``params`` itself where it holds just those, as
    the predict step keeps its weight packs per params object."""
    return {g: params[g] for g in PARAM_GROUPS} if "backbone" in params else params


def loss_and_grads(mcfg: ModelConfig, params: Dict, tokens, lengths, feats,
                   labels, hop_scale, *,
                   generator: Optional[torch.Generator] = None,
                   hop_seed=None, featurize=None, rows=None) -> Tuple[Dict, Dict]:
    """The joint loss's gradient with respect to every parameter, as a tree
    like ``params``, and the metrics of ``joint_loss_and_metrics``.  With
    ``featurize`` (fine-tuning), ``feats`` are images and
    ``featurize(params["backbone"], feats)`` makes the features inside the
    differentiated function.  ``rows``: the batch's place in a larger one
    (``rau_forward``)."""
    with torch.enable_grad():
        p = map_tree(lambda x: x.detach().requires_grad_(), params)
        if featurize is not None:
            feats = featurize(p["backbone"], feats)
        out = rau_forward(head_params(p), mcfg, tokens, lengths, feats, train=True,
                          generator=generator, hop_seed=hop_seed, rows=rows)
        loss, metrics = joint_loss_and_metrics(out.scores, out.do_pred,
                                               labels, hop_scale)
        flat = iter(torch.autograd.grad(loss, tree_leaves(p), allow_unused=True,
                                        materialize_grads=True))
    return map_tree(lambda _: next(flat), params), metrics


def trained_backbone(mcfg: ModelConfig, bb: Dict) -> Dict:
    """The tree a trained backbone group computes on, in the fine-tuning
    step, the eval sweep and the service alike: its float32 masters under
    float32, a bf16 cast of them under bf16 (differentiable, so the step's
    grads reach the masters)."""
    dt = dot_dtype(mcfg)
    return bb if dt == torch.float32 else map_tree(lambda t: t.to(dt), bb)


def featurizer(mcfg: ModelConfig, tcfg: TrainConfig, backbone: str, vit_cfg=None,
               img_repeat: int = 1):
    """The fine-tuning step's ``featurize(bb, images)`` (``loss_and_grads``):
    the backbone in the compute type (``trained_backbone``), with
    ``tcfg.backbone_remat`` and ``tcfg.backbone_feat_norm``, each image's
    features repeated to its ``img_repeat`` consecutive questions."""

    def featurize(bb, images):
        feats = extract_features(backbone, trained_backbone(mcfg, bb), images, vit_cfg,
                                 remat=tcfg.backbone_remat,
                                 feat_norm=tcfg.backbone_feat_norm)
        # grouped batches: question row i belongs to unique image i // g
        return feats.repeat_interleave(img_repeat, 0) if img_repeat > 1 else feats

    return featurize


class StepReductions:
    """What a train step reduces over its devices, and how: this class is
    the single-process step's, one device holding every row and every leaf
    whole.  ``parallel/mesh.py``'s ``ShardedReductions`` runs the same step
    over a mesh: its rows are part ``rank`` of ``n`` of each (micro)batch,
    and it gathers, reduces and cuts what spans the devices."""

    rank, n = 0, 1

    def full_params(self, params):
        """The whole parameters the forward computes on."""
        return params

    def reduce(self, grads, metrics):
        """The batch's gradients (cut to the state's leaves) and metrics."""
        return grads, metrics

    def noise(self, group: str, grads, generator, step, eta, gamma):
        return add_gradient_noise(grads, generator, step, eta, gamma)

    def norm(self, group: str, tree) -> torch.Tensor:
        """The L2 norm of a group's tree."""
        return tree_norm(tree)

    def leaf_norms(self, group: str, tree):
        """Each leaf's L2 norm, as a tree."""
        return leaf_norms(tree)


def make_train_step(mcfg: ModelConfig, tcfg: TrainConfig, *, device=None,
                    backbone: Optional[str] = None, vit_cfg=None, img_repeat: int = 1,
                    reductions: Optional[StepReductions] = None):
    """The train step on ``device``: ``cuda`` when None, and then it raises
    without a card; only an explicit ``device="cpu"`` runs the plain
    versions.

    ``step(state, tokens, lengths, feats, labels, hop_scale, lr, mult_lr)
    -> (state, metrics)``.  Inputs may be numpy arrays or tensors.  With
    ``tcfg.grad_accum = k > 1`` the step runs k sequential microbatch
    backward passes (microbatch i = rows [i*B/k, (i+1)*B/k) of each input,
    split by its own length) and one update on the averaged gradients:
    exact, since every loss term is a batch mean.

    With ``tcfg.train_backbone`` (``backbone`` needed: ``"vgg16"``,
    ``"resnet101"`` or ``"vit"`` with ``vit_cfg``) ``feats`` is a uint8
    image batch [B / img_repeat, H, W, 3] and the state carries the
    ``"backbone"`` group.  ``img_repeat = g > 1`` runs the backbone once on
    each of the B / g unique images and repeats each image's features to its
    g consecutive questions (the ``imggroup`` order): exact, the backbone's
    gradient summing its questions' (``rau_vqa_tpu/train/trainer.py:83-233``).

    ``reductions`` (``StepReductions``): ``parallel/mesh.py`` passes its
    own to run the step over a mesh (``make_sharded_train_step``).
    """
    device = pick_device(device, "make_train_step")
    red = reductions or StepReductions()
    train_bb = bool(tcfg.train_backbone)
    if train_bb and not backbone:
        raise ValueError("train_backbone needs backbone= (the step's feats "
                         "argument becomes a uint8 image batch)")
    img_repeat = int(img_repeat or 1)
    if img_repeat > 1 and not train_bb:
        raise ValueError("img_repeat (grouped unique-image batches) is a "
                         "fine-tuning mode — set tcfg.train_backbone")
    if mcfg.fused_train:
        check_fused_config(mcfg)
    accum = int(tcfg.grad_accum or 1)
    groups = PARAM_GROUPS + ("backbone",) if train_bb else PARAM_GROUPS
    fz = featurizer(mcfg, tcfg, backbone, vit_cfg, img_repeat) if train_bb else None

    def rows(b: int):
        """A (micro)batch's place in the global one: part red.rank of
        red.n, each of b rows."""
        return None if red.n == 1 else (red.rank * b, red.n * b)

    def grads_and_metrics(params, tokens, lengths, feats, labels, hop_scale,
                          generator):
        if accum == 1:
            return loss_and_grads(mcfg, params, tokens, lengths, feats,
                                  labels, hop_scale, generator=generator, featurize=fz,
                                  rows=rows(tokens.shape[0]))
        B = tokens.shape[0]
        if B % accum:
            raise ValueError(f"batch_size {B} must divide by grad_accum {accum}")
        mb = B // accum
        if img_repeat > 1 and mb % img_repeat:
            raise ValueError(f"microbatch size {mb} must divide by img_repeat "
                             f"{img_repeat} (microbatches must split at "
                             f"image-group boundaries)")
        # feats may hold the unique images alone: each input splits by its
        # own length
        fb = feats.shape[0] // accum
        grads = metrics = None
        for i in range(accum):
            rows_i = slice(i * mb, (i + 1) * mb)
            g, m = loss_and_grads(mcfg, params, tokens[rows_i], lengths[rows_i],
                                  feats[i * fb:(i + 1) * fb], labels[rows_i], hop_scale,
                                  generator=generator, featurize=fz, rows=rows(mb))
            grads = g if grads is None else map_tree(torch.add, grads, g)
            metrics = m if metrics is None else {
                k: metrics[k] + m[k] for k in metrics}
        grads = map_tree(lambda x: x / accum, grads)
        metrics = {k: (v if k in _SUM_METRICS else v / accum)
                   for k, v in metrics.items()}
        return grads, metrics

    def step_fn(state: TrainState, tokens, lengths, feats, labels, hop_scale,
                lr, mult_lr):
        tokens = torch.as_tensor(tokens, device=device)
        lengths = torch.as_tensor(lengths, device=device)
        feats = torch.as_tensor(feats, device=device)   # rau_forward casts it
        labels = torch.as_tensor(labels, device=device)
        hop_scale = torch.as_tensor(hop_scale, device=device,
                                    dtype=torch.float32)
        grads, metrics = grads_and_metrics(
            red.full_params(state.params), tokens, lengths, feats, labels, hop_scale,
            _generator(device, state.seed, state.step, 0))
        grads, metrics = red.reduce(grads, metrics)
        lrs = {"embed": lr, "rnn": lr, "mult": mult_lr,
               "backbone": lr * float(tcfg.backbone_lr_scale)}
        new_params, new_opt = {}, {}
        for i, g in enumerate(groups):
            gg = grads[g]
            if g == "backbone":
                # the zero-signal test on the gradient before its noise: the
                # noise alone would keep a dead backbone's norm above 0
                alive = (red.norm(g, gg) > 0).float()
            if g != "backbone" or tcfg.backbone_grad_noise:
                # state.step counts completed steps; the noise schedule takes
                # the 1-based iteration (the reference's `it`, :598)
                gg = red.noise(
                    g, gg, _generator(device, state.seed, state.step, 1 + i),
                    state.step + 1, tcfg.noisy_eta, tcfg.noisy_gamma)
            gg, norm = clip_by_global_norm(gg, tcfg.grad_clip, norm=red.norm(g, gg))
            new_params[g], new_opt[g] = adam_update(
                state.params[g], gg, lrs[g], state.opt[g],
                beta1=tcfg.adam_beta1, beta2=tcfg.adam_beta2,
                epsilon=tcfg.adam_epsilon)
            if g == "backbone":
                if tcfg.backbone_trust_ratio > 0:
                    new_params[g] = trust_ratio_cap(
                        new_params[g], state.params[g], tcfg.backbone_trust_ratio,
                        norms=lambda t, g=g: red.leaf_norms(g, t))
                # the zero-signal freeze: an exactly-zero backbone gradient
                # (a saturated head) moves nothing, stale momentum included
                new_params[g] = map_tree(lambda n, o: o + (n - o) * alive.to(n.dtype),
                                         new_params[g], state.params[g])
            metrics[f"grad_norm_{g}"] = norm
        return TrainState(new_params, new_opt, state.step + 1,
                          state.seed), metrics

    return step_fn


def _perturbed_seed(seed: int, streak: int) -> int:
    """The seed of a retry after the guard's ``streak``-th trip in a row: a
    function of both, as JAX folds the streak into its key."""
    return (seed * 1_000_003 + 7_919 * streak + 1) % 2 ** 62


def _is_images(feats) -> bool:
    """Whether a batch's ``feats`` are uint8 images [B, H, W, 3] for the
    frozen backbone, not features."""
    return (not isinstance(feats, QuantFeats) and feats.ndim == 4
            and feats.dtype in (np.uint8, torch.uint8))


def _pinned(a, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``a`` in fresh page-locked host memory (cast to ``dtype``).  The
    caching host allocator hands a freed pinned block out again only once
    the copies that read it have finished, so a batch is never overwritten
    while its copy to the card is in flight."""
    src = torch.from_numpy(np.ascontiguousarray(a))
    dst = torch.empty(src.shape, dtype=dtype or src.dtype, pin_memory=True)
    return dst.copy_(src)


class Trainer:
    """End-to-end training and periodic evaluation for one experiment, on
    ``device`` (``cuda`` when None, raising without a card; ``"cpu"`` runs
    the kernels' plain versions).

    With ``backbone`` (``"vgg16"``, ``"resnet101"`` or ``"vit"``, with
    ``vit_cfg``) and ``bb_params``, a source of uint8 images (an
    ``ImageDirSource``) works too: the frozen backbone, placed on the device
    once, makes each batch's features there (``extract_features`` with
    ``tcfg.backbone_feat_norm``), for the train steps and the eval sweep
    (``rau_vqa_tpu/train/trainer.py:361-382``, ``:485-514``).  With
    ``tcfg.train_backbone`` the backbone is fine-tuned instead: it joins the
    state as the ``"backbone"`` group, the train step takes the raw uint8
    batches, and the eval sweep featurizes with the trained group; under the
    ``imggroup`` order each batch carries its unique images alone and the
    step repeats their features (``img_repeat``, the order's group size).

    With ``mesh`` (``parallel/mesh.py``; every rank of the world builds its
    Trainer alike) the state is placed on the mesh (TP leaves as this rank's
    slice with ``exp.mesh.shard_params_tp``), each batch's rows of this rank
    alone go to its device, the step is ``make_sharded_train_step`` and the
    eval sweep ``make_sharded_predict_fn`` (its batches padded to the data
    axis); rank 0 alone writes the logs, the submissions, the attention PNGs
    and the checkpoints, which hold whole leaves
    (``rau_vqa_tpu/train/trainer.py:243-350, 474-536, 685-1005``)."""

    def __init__(self, exp: ExperimentConfig, data: VQAData,
                 source: FeatureSource, workdir: str, *,
                 gt_anno: Optional[Dict[int, str]] = None,
                 official_anno: Optional[str] = None, device=None,
                 mesh=None, backbone: Optional[str] = None, bb_params=None,
                 vit_cfg=None):
        if mesh is not None:
            from rau_vqa_tpu_torch.parallel.mesh import Mesh
            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh must be a parallel.mesh.Mesh (make_mesh), got "
                                f"{type(mesh).__name__}")
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"Trainer: device {device} is not the mesh's {mesh.device}")
            device = mesh.device
        self.mesh = mesh
        self.tp = bool(mesh is not None and exp.mesh.shard_params_tp)
        self.writer = mesh is None or mesh.writer
        self.train_backbone = bool(exp.train.train_backbone)
        if self.train_backbone and (backbone is None or bb_params is None):
            raise ValueError(
                "train_backbone needs an image data source plus "
                "Trainer(backbone=..., bb_params=...) — fine-tuning "
                "differentiates through the pixels (--image-root)")
        if (backbone is None) != (bb_params is None):
            raise ValueError("pass backbone and bb_params together")
        self.device = pick_device(device, "Trainer")
        # model dims come from the dataset (reference :204, :222)
        self.mcfg = dataclasses.replace(
            exp.model, vocab_size=data.vocab_size,
            answer_size=data.answer_size, seq_len=data.seq_len)
        self.tcfg = exp.train
        if self.tcfg.grad_accum > 1 \
                and self.tcfg.batch_size % self.tcfg.grad_accum:
            raise ValueError(
                f"batch_size {self.tcfg.batch_size} must divide by "
                f"grad_accum {self.tcfg.grad_accum}")
        self.exp = exp
        self.data = data
        self.source = source
        if source is not None:
            # a packed shard's rows must be of the head's feature interface
            check_feat_interface(source, self.tcfg.backbone_feat_norm, "Trainer")
        self.backbone = backbone
        self.vit_cfg = vit_cfg
        # the frozen backbone on the device; fine-tuned, it lives in the state
        self.bb_params = (None if bb_params is None or self.train_backbone else
                          map_tree(lambda t: t.to(self.device), bb_params))
        self._feat_dtype = (torch.bfloat16 if self.mcfg.compute_dtype
                            == "bfloat16" else torch.float32)
        self.workdir = workdir
        self.gt_anno = gt_anno
        self.official_anno = official_anno
        self._official_scorer = None
        self._warned_partial_official = False
        self.ckpt_dir = os.path.join(workdir, "snapshot")
        self.logger = MetricsLogger(os.path.join(workdir, "training_log"))

        self.state = init_train_state(
            self.mcfg, self.tcfg.seed, device=self.device,
            bb_params=bb_params if self.train_backbone else None)
        # grouped fine-tuning: under the 'imggroup' order each image's
        # questions are consecutive, so the step runs the backbone once an
        # image and repeats its features
        self.img_repeat = 1
        if self.train_backbone and exp.data.batch_order == "imggroup":
            g = data.train_data.uniform_image_group_size()
            if self.tcfg.batch_size % g:
                raise ValueError(
                    f"imggroup fine-tuning: batch_size {self.tcfg.batch_size} "
                    f"must divide by the questions-per-image group size {g} "
                    f"(batches must start on image-group boundaries)")
            if mesh is not None:
                n_data = mesh.n_data
                per_shard = self.tcfg.batch_size // n_data
                if self.tcfg.batch_size % n_data or per_shard % g:
                    raise ValueError(
                        f"imggroup fine-tuning on a mesh: the per-shard "
                        f"batch ({self.tcfg.batch_size}/{n_data}) must be "
                        f"a multiple of the group size {g} so feature "
                        f"repeats never cross shard boundaries")
            self.img_repeat = g
        # host copy of the initial state (the backbone group too): the guard
        # falls back to it when a loss explodes before the first checkpoint
        self._fallback_state = TrainState(
            map_tree(to_host, self.state.params),
            map_tree(to_host, self.state.opt),
            self.state.step, self.state.seed)
        step_kw = dict(backbone=backbone if self.train_backbone else None,
                       vit_cfg=vit_cfg, img_repeat=self.img_repeat)
        if mesh is not None:
            # DP (+ TP) over the mesh: the state's whole leaves decide the
            # specs, then the state is cut to this rank's
            from rau_vqa_tpu_torch.parallel import mesh as pm
            self._shardings = pm.state_shardings(mesh, self.state, tp=self.tp)
            self.train_step = pm.make_sharded_train_step(
                self.mcfg, self.tcfg, mesh, self.state, tp=self.tp, **step_kw)
            self.predict_step = pm.make_sharded_predict_fn(
                self.mcfg, mesh, head_params(self.state.params), tp=self.tp,
                fused=exp.fused_eval)
            self.state = pm.place_state(mesh, self.state, tp=self.tp)
        else:
            self.train_step = make_train_step(self.mcfg, self.tcfg, device=self.device,
                                              **step_kw)
            # buckets=(): the trainer dispatches its own buckets, as in JAX
            self.predict_step = (make_predict_step(self.mcfg, device=self.device)
                                 if exp.fused_eval else self._plain_predict)
        # smallest bucket covering a batch's longest question wins; the full
        # seq_len is always the top rung
        self._eval_ladder = bucket_ladder(self.mcfg.seq_len,
                                          exp.eval_buckets or ())
        self._train_ladder = bucket_ladder(self.mcfg.seq_len,
                                           self.tcfg.length_buckets or ())
        self.lr = self.tcfg.learning_rate
        self.mult_lr = self.tcfg.mult_learning_rate
        self.epoch = 0                  # completed epochs
        self._abort_streak = 0          # consecutive explosion-guard trips
        self.loss_ema: Optional[float] = None
        data.train_data.set_batch_order_option(exp.data.batch_order)
        data.train_data.reorder()

    # ------------------------------------------------------------------
    def _bb_tree(self):
        """The live backbone: the trained group under fine-tuning, else the
        frozen one."""
        return self.state.params["backbone"] if self.train_backbone else self.bb_params

    def _plain_predict(self, params, tokens, lengths, feats):
        """The plain float32 path (``fused_eval=False``), on the device."""
        with torch.no_grad():
            return predict(params, self.mcfg, tokens,
                           torch.as_tensor(lengths, device=self.device),
                           feats.float())

    @staticmethod
    def _bucket_t(ladder, lengths) -> int:
        """Smallest ladder rung covering this batch's longest question,
        from the host's lengths (no device sync)."""
        return pick_bucket(ladder, int(np.max(np.asarray(lengths))))

    def _hop_scale(self, epoch_1based: int) -> torch.Tensor:
        return hop_grad_scale(
            self.mcfg.n_hops, scale_by_nhop=self.tcfg.hop_grad_scale_nhop,
            stop_timing=self.tcfg.hop_stop_timing, epoch=epoch_1based)

    def _pinning(self, ladder):
        """The loader's ``finish`` on the card, None on the CPU: each batch
        in page-locked host memory, made in the loader's prefetch thread
        while the card runs the step, so that the loop only starts its
        copies.  Features in the step's type (``QuantFeats`` stay int8 with
        float32 scales, images uint8: the backbone reads them on the card);
        tokens cut to the batch's rung of ``ladder``."""
        if self.device.type != "cuda":
            return None

        def pin(batch):
            feats = batch.feats
            if isinstance(feats, QuantFeats):
                feats = QuantFeats(values=_pinned(feats.values),
                                   scales=_pinned(feats.scales, torch.float32))
            elif _is_images(feats):
                feats = _pinned(feats)
            else:
                feats = _pinned(feats, self._feat_dtype)
            tokens = batch.tokens[:, :self._bucket_t(ladder, batch.lengths)]
            return dataclasses.replace(
                batch, feats=feats, tokens=_pinned(tokens),
                lengths=_pinned(batch.lengths),
                labels=None if batch.labels is None else _pinned(batch.labels),
                mc_answers=(None if batch.mc_answers is None
                            else _pinned(batch.mc_answers)))
        return pin

    def _put(self, a, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """A host array or tensor on the device, with ``non_blocking=True``
        on the card: asynchronous from the pinned batches of ``_pinning``."""
        t = a if torch.is_tensor(a) else torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            t = t.to(self.device, non_blocking=True)
        return t if dtype is None else t.to(dtype)

    def _put_batch(self, batch, max_t: Optional[int] = None,
                   featurize: bool = True) -> Dict:
        """The batch on the device: features in ``compute_dtype``
        (``QuantFeats`` cross as int8 and are dequantized there; uint8 images
        cross as they are and the backbone makes their features there, or,
        with ``featurize=False``, stay images for the fine-tuning step), the
        token axis cut to ``max_t`` (exact: steps past every question's last
        token carry no gradient; the reference runs to torch.max(x_len),
        Ours_SS/...lua:448-450)."""
        dt = self._feat_dtype
        if isinstance(batch.feats, QuantFeats):
            v = self._put(batch.feats.values, dt)
            feats = v * self._put(batch.feats.scales, dt)[:, None, None]
        elif _is_images(batch.feats):
            feats = self._put(batch.feats)
            if featurize:
                feats = self._featurize(feats).to(dt)
        else:
            feats = self._put(batch.feats, dt)
        tokens = batch.tokens
        if max_t is not None and max_t < tokens.shape[1]:
            tokens = tokens[:, :max_t]
        out = {"tokens": self._put(tokens), "lengths": self._put(batch.lengths),
               "feats": feats}
        if batch.labels is not None:
            out["labels"] = self._put(batch.labels)
        return out

    def _featurize(self, images: torch.Tensor) -> torch.Tensor:
        """uint8 images on the device -> the live backbone's features (the
        trained group under fine-tuning, in the type the step computes it
        in: the sweep sees the model that was trained)."""
        if self.backbone is None:
            raise ValueError("image batches need a visual backbone: pass "
                             "Trainer(backbone=..., bb_params=...)")
        bb = (trained_backbone(self.mcfg, self._bb_tree()) if self.train_backbone
              else self.bb_params)
        with torch.no_grad():
            return extract_features(self.backbone, bb, images, self.vit_cfg,
                                    feat_norm=self.tcfg.backbone_feat_norm)

    def _pad_batch_to(self, batch, target_b: int):
        """Pad a batch's leading dim to target_b by repeating the last
        example (exact: callers slice the padded answers away)."""
        pad = target_b - len(batch.qids)
        if pad <= 0:
            return batch

        def p(a):
            if a is None:
                return None
            if torch.is_tensor(a):
                return torch.cat([a, a[-1:].expand(pad, *a.shape[1:])])
            return np.concatenate([a, np.repeat(a[-1:], pad, axis=0)], axis=0)

        feats = batch.feats
        if isinstance(feats, QuantFeats):
            feats = QuantFeats(values=p(feats.values), scales=p(feats.scales))
        else:
            feats = p(feats)
        return dataclasses.replace(
            batch, feats=feats, tokens=p(batch.tokens),
            lengths=p(batch.lengths), labels=p(batch.labels),
            mc_answers=p(batch.mc_answers), qids=p(batch.qids))

    def _pad_batch_for_mesh(self, batch):
        """An eval batch padded to the mesh's 'data' axis multiple (the
        reference's test batch sizes, 83 and 57, do not divide meshes)."""
        if self.mesh is None:
            return batch
        b = len(batch.qids)
        return self._pad_batch_to(batch, b + (-b) % self.mesh.n_data)

    def _shard(self, batch, accum: int = 1):
        """This rank's rows of a batch (``parallel.mesh.take_rows``, which
        raises where they do not split evenly over 'data' and ``accum``),
        each array cut by its own length (grouped fine-tuning carries the
        unique images alone); the batch itself without a mesh."""
        if self.mesh is None:
            return batch
        from rau_vqa_tpu_torch.parallel.mesh import take_rows

        def rows(a):
            return None if a is None else take_rows(self.mesh, a, accum)

        feats = batch.feats
        if isinstance(feats, QuantFeats):
            feats = QuantFeats(values=rows(feats.values), scales=rows(feats.scales))
        else:
            feats = rows(feats)
        return dataclasses.replace(
            batch, feats=feats, tokens=rows(batch.tokens), lengths=rows(batch.lengths),
            labels=rows(batch.labels), mc_answers=rows(batch.mc_answers),
            qids=rows(batch.qids))

    # ------------------------------------------------------------------
    def train_epoch(self) -> Dict[str, Any]:
        """One epoch over the train split; returns averaged metrics.

        Each step's metrics go to the host in one copy, started right after
        the step and waited for one step later, while the next step is
        already queued: the host never waits for more than the earlier
        step, and the card is never left without work by the read.  A loss explosion aborts the epoch: the guard restored an
        epoch-boundary state whose data order restore() fast-forwarded, so
        the caller's next train_epoch() runs a clean epoch from it."""
        epoch_1based = self.epoch + 1
        hop_scale = self._hop_scale(epoch_1based)
        hop_scale_dev = self._put(hop_scale)
        sums: Dict[str, Any] = {}
        n_steps = 0
        exploded = 0
        aborted = False
        layout = None                   # [(metric, size, shape)]
        step_base = self.state.step     # a host int: no sync
        t0 = time.time()

        def start_copy(flat: torch.Tensor):
            """Start the copy of a step's metrics to the host now, behind
            that step's work alone; ``consume`` waits for it a step later."""
            if self.device.type != "cuda":
                return flat, None
            host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
            host.copy_(flat, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            return host, done

        def consume(step_id: int, copied) -> None:
            """Host bookkeeping for a finished step (guard, prints, sums)."""
            nonlocal n_steps, exploded, aborted
            host, done = copied
            if done is not None:
                done.synchronize()         # the step's one synchronisation
            values = host.numpy().astype(np.float64)
            metrics, i = {}, 0
            for k, n, shape in layout:
                metrics[k] = values[i:i + n].reshape(shape)
                i += n
            loss = float(metrics["loss"])
            if not self._guard(loss):
                exploded += 1
                aborted = True
                return
            n_steps += 1
            if (self.tcfg.print_interval
                    and n_steps % self.tcfg.print_interval == 0):
                print(f"it {step_id} (epoch {epoch_1based}) "
                      f"loss={loss:.5f} lr={self.lr:.2e} "
                      f"mult_lr={self.mult_lr:.2e} "
                      f"[grad] E:{float(metrics['grad_norm_embed']):.4f} "
                      f"R:{float(metrics['grad_norm_rnn']):.4f} "
                      f"M:{float(metrics['grad_norm_mult']):.4f}"
                      + (f" B:{float(metrics['grad_norm_backbone']):.4f}"
                         if "grad_norm_backbone" in metrics else ""), flush=True)
            for k in _SCALAR_METRICS:
                if k in metrics:
                    sums[k] = sums.get(k, 0.0) + float(metrics[k])
            for k in _VECTOR_METRICS:
                v = np.asarray(metrics[k])
                sums[k] = sums.get(k, np.zeros_like(v, np.float64)) + v

        pending = None
        dispatched = 0
        # grouped fine-tuning: the loader fetches each batch's unique images
        # alone (the step repeats their features)
        for batch in self.data.train_data.batches(
                self.source, finish=self._pinning(self._train_ladder),
                image_stride=self.img_repeat):
            dev = self._put_batch(
                self._shard(batch, self.tcfg.grad_accum),
                max_t=self._bucket_t(self._train_ladder, batch.lengths),
                featurize=not self.train_backbone)
            self.state, metrics = self.train_step(
                self.state, dev["tokens"], dev["lengths"], dev["feats"],
                dev["labels"], hop_scale_dev, self.lr, self.mult_lr)
            if layout is None:
                layout = [(k, v.numel(), tuple(v.shape))
                          for k, v in metrics.items()]
            # all of the step's metrics in one copy, read one step later
            copied = start_copy(torch.cat([v.detach().reshape(-1).float()
                                           for v in metrics.values()]))
            dispatched += 1
            if pending is not None:
                consume(step_base + dispatched - 1, pending)
                if aborted:
                    # the in-flight step's input state was discarded
                    pending = None
                    break
            pending = copied
        if pending is not None and not aborted:
            consume(step_base + dispatched, pending)
        dt = time.time() - t0
        if aborted:
            # re-apply the order fast-forward after the generator closed:
            # breaking out of batches() ran its rewind, which restored the
            # pre-abort mid-epoch order over the one restore() set up
            td = self.data.train_data
            td.reorder_count = self.epoch
            td.reorder()
            record = {"epoch": self.epoch, "steps": n_steps,
                      "exploded": exploded, "aborted": True, "sec": dt}
            if self.writer:
                self.logger.log(record, kind="train")
            return record
        self.epoch += 1
        self._abort_streak = 0          # a completed epoch clears the guard
        out = {k: v / max(n_steps, 1) for k, v in sums.items()}
        record = {"epoch": self.epoch, "lr": self.lr, "mult_lr": self.mult_lr,
                  "steps": n_steps, "exploded": exploded, "sec": dt,
                  "examples_per_sec":
                      n_steps * self.tcfg.batch_size / max(dt, 1e-9)}
        record.update(per_hop_record({
            "trainloss": out.get("ce_per_hop", []),
            "trainacc": out.get("acc_per_hop", []),
            "do_pred_loss": out.get("do_pred_loss", []),
            # gated do_pred accuracy (Ours_SS/...lua:551-557)
            "do_pred_acc": (sums.get("do_pred_acc_num", np.zeros(1))
                            / max(float(sums.get("do_pred_acc_den", 0.0)),
                                  1e-9)),
            # which hops carried gradient this epoch (the reference's
            # cmploss_XX columns, Ours_Full/...lua:1137-1143)
            "cmploss": (hop_scale.numpy() > 0).astype(np.float64),
        }))
        for k in _SCALAR_METRICS:
            if k in out:
                record[k] = out[k]
        if self.writer:   # one writer on a mesh
            self.logger.log(record, kind="train")

        # exponential LR decay per epoch (reference :1211-1220)
        if (self.tcfg.lr_decay < 1.0
                and self.epoch % self.tcfg.lr_decay_interval == 0):
            self.lr *= self.tcfg.lr_decay
            self.mult_lr *= self.tcfg.mult_lr_decay
        return record

    # ------------------------------------------------------------------
    def _guard(self, loss: float) -> bool:
        """Loss-explosion guard: reject the step (restore the last
        checkpoint, or the initial state before the first one) when the
        loss is non-finite or > threshold x its EMA.  Read one step behind
        the dispatch, so the restore also discards the step in flight."""
        thresh = self.tcfg.loss_explode_threshold
        bad = not math.isfinite(loss) or (
            self.loss_ema is not None and thresh > 0
            and loss > thresh * max(self.loss_ema, 1e-6))
        if not bad:
            self.loss_ema = loss if self.loss_ema is None else (
                0.9 * self.loss_ema + 0.1 * loss)
            return True
        path = latest_checkpoint(self.ckpt_dir)
        if self.mesh is not None:
            # the restore decision must be uniform across ranks: one that
            # restores while another does not would leave replicated params
            # differing from rank to rank
            from rau_vqa_tpu_torch.parallel.mesh import world_sum
            have = world_sum(self.mesh, [path is not None])[0]
            if 0 < have < self.mesh.devices.size:
                raise RuntimeError(
                    "loss-explosion restore needs the checkpoint dir "
                    "on a SHARED filesystem: some processes see "
                    f"{self.ckpt_dir!r}, others don't")
        if path is not None:
            self.restore(path)
        else:
            # no checkpoint yet: fall back to the initial state, so the
            # poisoned update is never kept
            fb = self._fallback_state
            to_dev = lambda x: x.to(self.device, copy=True)   # noqa: E731
            self.state = TrainState(map_tree(to_dev, fb.params),
                                    map_tree(to_dev, fb.opt), fb.step, fb.seed)
            if self.mesh is not None:
                from rau_vqa_tpu_torch.parallel.mesh import place_state
                self.state = place_state(self.mesh, self.state, tp=self.tp)
            # the EMA tracked the poisoned run's losses; the initial params
            # give init-scale losses again, which a stale EMA would reject
            self.loss_ema = None
            # epoch and LR rewind with the params (a decayed LR or a
            # mid-curriculum hop scale must not carry over)
            self.epoch = 0
            self.lr = self.tcfg.learning_rate
            self.mult_lr = self.tcfg.mult_learning_rate
        # a deterministic divergence would replay bit-identically from the
        # restored state: perturb the retry's dropout and noise draws (the
        # data order stays exact), and fail loudly once retries stop helping
        self._abort_streak += 1
        if self._abort_streak >= 3:
            raise RuntimeError(
                f"loss exploded {self._abort_streak} consecutive epochs even "
                f"after checkpoint restore + seed perturbation (last loss "
                f"{loss:g}, ema {self.loss_ema}) — the divergence is "
                f"deterministic (learning rate / data), not transient")
        self.state = self.state._replace(
            seed=_perturbed_seed(self.state.seed, self._abort_streak))
        return False

    # ------------------------------------------------------------------
    def evaluate(self, *, write_submissions: bool = True,
                 return_rows: bool = False) -> Dict[str, Any]:
        """Full test sweep producing the nHop+2 answer sets; writes the OE
        and MC submission files and computes fast-val accuracy when ground
        truth is given (reference :851-1207).  The tail batch is padded to
        the test batch size and its padding sliced away."""
        test = self.data.test_data
        test.inorder()
        H2 = self.mcfg.n_hops + 2
        oe_chunks, mc_chunks, qid_chunks = [], [], []
        params = head_params(self.state.params)
        n_eval_batches = (test.iter_per_epoch
                          + (1 if test.num_examples % test.batch_size else 0))
        visatt_left = (self.exp.visatt_batches if self.exp.visatt_batches >= 0
                       else n_eval_batches)
        for batch in test.batches(self.source, include_tail=True,
                                  finish=self._pinning(self._eval_ladder)):
            orig_b = len(batch.qids)
            padded = self._pad_batch_for_mesh(self._pad_batch_to(batch, test.batch_size))
            local = self._shard(padded)
            # the bucket of the whole batch's lengths: every rank alike
            dev = self._put_batch(
                local, max_t=self._bucket_t(self._eval_ladder, padded.lengths))
            # host lengths: the step reads them without a device sync; on a
            # mesh the outputs are the whole batch's, gathered in row order
            tab_pred, tab_att = self.predict_step(params, dev["tokens"],
                                                  np.asarray(local.lengths),
                                                  dev["feats"])
            if self.exp.visatt and visatt_left > 0:
                # attention PNG dumps of the first visatt_batches batches
                # (the reference dumps every test question, :926-932): the
                # batch's attention, its padded tail dropped, copied to the
                # host once, by the one writer
                if self.writer:
                    from rau_vqa_tpu_torch.utils.visatt import dump_attention_maps
                    dump_attention_maps(
                        os.path.join(self.workdir, "figures"), float(self.epoch),
                        tab_att[:, :orig_b].float().cpu().numpy(), batch.qids.tolist(),
                        self.mcfg.cnn_w, self.mcfg.cnn_h)
                visatt_left -= 1
            mc = (None if batch.mc_answers is None
                  else self._put(batch.mc_answers))
            oe_ans, mc_ans = compute_answers(tab_pred[:, :orig_b], mc)
            oe_chunks.append(oe_ans)                      # [H2, B] ids
            if mc_ans is not None:
                mc_chunks.append(mc_ans)
            qid_chunks.append(batch.qids)
        # one host copy after the sweep
        qids = np.concatenate(qid_chunks)
        answer_arr = np.asarray(self.data.answers, dtype=object)
        oe_strs = answer_arr[torch.cat(oe_chunks, 1).cpu().numpy()]  # [H2, N]
        mc_strs = (answer_arr[torch.cat(mc_chunks, 1).cpu().numpy()]
                   if mc_chunks else None)

        def make_rows(strs_h):
            return [{"answer": a, "question_id": int(q)}
                    for a, q in zip(strs_h, qids)]

        epoch_f = float(self.epoch)
        result: Dict[str, Any] = {"epoch": epoch_f}
        rows_oe = [make_rows(oe_strs[h]) for h in range(H2)]
        rows_mc = ([make_rows(mc_strs[h]) for h in range(H2)]
                   if mc_strs is not None else [[]] * H2)
        if write_submissions and self.writer:
            write_results(self.workdir, "OpenEnded", self.exp.data.split,
                          self.exp.alg_name, epoch_f, rows_oe)
            if rows_mc[0]:
                write_results(self.workdir, "MultipleChoice",
                              self.exp.data.split, self.exp.alg_name,
                              epoch_f, rows_mc)
        if self.gt_anno is not None:
            # fast validation (reference :914-925)
            missing = [q for q in qids if int(q) not in self.gt_anno]
            if missing:
                raise KeyError(
                    f"fast validation: {len(missing)} question ids not in "
                    f"GT map (first: {missing[0]})")
            gt = np.asarray([self.gt_anno[int(q)] for q in qids], dtype=object)
            result["testOEacc"] = [float((oe_strs[h] == gt).mean())
                                   for h in range(H2)]
            if mc_strs is not None:
                result["testMCacc"] = [float((mc_strs[h] == gt).mean())
                                       for h in range(H2)]
        if self.official_anno:
            # the official 10-rater consensus metric, per hop; annotations
            # digested once
            if self._official_scorer is None:
                from rau_vqa_tpu_torch.eval.vqa_accuracy import (
                    VQAAccuracyScorer,
                )
                with open(self.official_anno) as f:
                    self._official_scorer = VQAAccuracyScorer(
                        json.load(f), precision=6)
            sc = self._official_scorer
            oe_reps = [sc.score(rows_oe[h]) for h in range(H2)]
            result["testOEaccOfficial"] = [r["overall"] / 100.0
                                           for r in oe_reps]
            if oe_reps[0]["missing"] and not self._warned_partial_official:
                self._warned_partial_official = True
                warnings.warn(
                    f"official annotations cover only {oe_reps[0]['n']} of "
                    f"{oe_reps[0]['n'] + oe_reps[0]['missing']} evaluated "
                    f"questions — testOEaccOfficial averages that subset, "
                    f"not the split testOEacc covers", stacklevel=2)
            if mc_strs is not None:
                result["testMCaccOfficial"] = [
                    sc.score(rows_mc[h])["overall"] / 100.0
                    for h in range(H2)]
        if len(result) > 1 and self.writer:
            self.logger.log(
                {"epoch": epoch_f,
                 **per_hop_record({k: v for k, v in result.items()
                                   if k != "epoch"})},
                kind="test")
        if return_rows:
            result["rows_oe"] = rows_oe
            result["rows_mc"] = rows_mc if mc_strs is not None else None
        return result

    # ------------------------------------------------------------------
    def save(self, *, background: bool = False) -> str:
        """Write a snapshot; ``background=True`` copies the state to the
        host here and leaves serialization and disk IO to the writer
        thread.  The guard and the end of ``fit`` flush pending writes.

        On a mesh every rank calls it: TP leaves are gathered collectively,
        rank 0 writes the whole state (a single-process run loads it) and
        returns its path, the others "", and no rank leaves before the file
        is written (the guard's restore decision reads the directory)."""
        state = self.state
        if self.mesh is not None:
            from rau_vqa_tpu_torch.parallel.mesh import barrier, gather_state
            state = gather_state(state, self._shardings)
            path = self._write(state, background=False) if self.writer else ""
            barrier(self.mesh)
            return path
        return self._write(state, background=background)

    def _write(self, state: TrainState, *, background: bool) -> str:
        return save_checkpoint(
            self.ckpt_dir, state.step, float(self.epoch),
            state._asdict(), background=background,
            keep_last=self.tcfg.keep_last_checkpoints or None,
            extra={"lr": self.lr, "mult_lr": self.mult_lr,
                   "loss_ema": self.loss_ema,
                   "preset": self.exp.name, "alg_name": self.exp.alg_name,
                   "n_hops": self.mcfg.n_hops,
                   # a fine-tuned snapshot carries the 4th group; its kind
                   # tells serve and eval what it is
                   "train_backbone": self.train_backbone,
                   "backbone": self.backbone if self.train_backbone else None,
                   # the interface the head trained on, whichever backbone
                   "backbone_feat_norm": self.tcfg.backbone_feat_norm,
                   # self-describing snapshot: standalone eval adopts this
                   # (the reference's Eval.lua:116-118)
                   "model_config": dataclasses.asdict(self.mcfg)})

    def restore(self, path: str) -> None:
        """Load a snapshot, the port's ``.pt`` or the JAX package's
        ``.msgpack``, into the train state, with its LRs, loss EMA and
        epoch; the data order is fast-forwarded to that epoch.

        Under fine-tuning a head-only snapshot (of a run on precomputed
        features or a frozen backbone) is a warm start: its three head
        groups are restored, and the current backbone group, fresh Adam
        moments, step, seed, LRs and epoch are kept (``rau_vqa_tpu/train/
        trainer.py:935-989``).  On a mesh every rank calls it, and the whole
        leaves are cut to each rank's again."""
        state = self.state
        if self.mesh is not None:
            from rau_vqa_tpu_torch.parallel.mesh import gather_state
            state = gather_state(state, self._shardings)
        template = state._asdict()
        if self.train_backbone and not has_backbone_group(path):
            head = {**template, "params": head_params(template["params"]),
                    "opt": {g: template["opt"][g] for g in PARAM_GROUPS}}
            tree, _ = load_checkpoint(path, head)
            tree = {"params": {**tree["params"],
                               "backbone": template["params"]["backbone"]},
                    "opt": {**tree["opt"], "backbone": template["opt"]["backbone"]},
                    "step": template["step"], "seed": template["seed"]}
            meta = {}
        else:
            tree, meta = load_checkpoint(path, template)
        to_dev = lambda x: x.to(self.device)   # noqa: E731
        self.state = TrainState(params=map_tree(to_dev, tree["params"]),
                                opt=map_tree(to_dev, tree["opt"]),
                                step=int(tree["step"]), seed=int(tree["seed"]))
        if self.mesh is not None:
            from rau_vqa_tpu_torch.parallel.mesh import place_state
            self.state = place_state(self.mesh, self.state, tp=self.tp)
        if "lr" in meta:
            self.lr = meta["lr"]
            self.mult_lr = meta["mult_lr"]
        if meta.get("loss_ema") is not None:
            self.loss_ema = meta["loss_ema"]
        if "epoch" in meta:
            self.epoch = int(meta["epoch"])
            # the epoch order is a pure function of (seed, reorder_count):
            # the resumed run sees an uninterrupted run's batch order
            td = self.data.train_data
            td.reorder_count = self.epoch
            td.reorder()

    # ------------------------------------------------------------------
    def _profiled_epoch(self) -> Dict[str, Any]:
        """``train_epoch`` under torch.profiler, its trace written to
        ``profile_dir``."""
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            record = self.train_epoch()
        if not self.writer:
            return record
        os.makedirs(self.exp.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            self.exp.profile_dir, f"epoch{self.epoch:03d}_trace.json"))
        return record

    def fit(self, epochs: Optional[int] = None, *,
            eval_each: Optional[bool] = None) -> Dict[str, Any]:
        epochs = epochs or self.tcfg.max_epochs
        eval_each = (self.tcfg.test_interval > 0
                     if eval_each is None else eval_each)
        last_eval: Dict[str, Any] = {}
        raised = False
        try:
            for i in range(epochs):
                if i == 0 and self.exp.profile_dir:
                    record = self._profiled_epoch()
                else:
                    record = self.train_epoch()
                if record.get("aborted"):
                    # rewound to a state already evaluated and checkpointed
                    continue
                if (eval_each and self.tcfg.test_interval > 0
                        and self.epoch % self.tcfg.test_interval == 0):
                    last_eval = self.evaluate()
                if (self.tcfg.checkpoint_interval > 0
                        and self.epoch % self.tcfg.checkpoint_interval == 0):
                    self.save(background=True)
                if (self.exp.graph_interval > 0 and self.writer
                        and self.epoch % self.exp.graph_interval == 0):
                    from rau_vqa_tpu_torch.utils.plots import render_curves
                    render_curves(
                        os.path.join(self.workdir, "training_log"),
                        os.path.join(self.workdir, "graphs"),
                        self.mcfg.n_hops)
        except BaseException:
            raised = True
            raise
        finally:
            # periodic snapshots are durable (and write errors surfaced)
            # even when an epoch raises, but a flush error must not replace
            # the training exception; an explicit flag, not sys.exc_info(),
            # which also sees exceptions handled up the caller's stack
            if not raised:
                flush_checkpoint_writes()
            else:
                try:
                    flush_checkpoint_writes()
                except Exception as e:
                    warnings.warn(
                        f"background checkpoint write also failed while "
                        f"unwinding a training error: {e!r}")
        return last_eval


# the step's metrics that the epoch record averages: scalars, and per-hop
# vectors and sums
_SCALAR_METRICS = ("loss", "uni_loss", "select_loss", "uni_acc", "select_acc",
                   "any_correct_ratio", "grad_norm_embed", "grad_norm_rnn",
                   "grad_norm_mult", "grad_norm_backbone")
_VECTOR_METRICS = ("ce_per_hop", "acc_per_hop", "do_pred_loss",
                   "do_pred_acc_num", "do_pred_acc_den")
