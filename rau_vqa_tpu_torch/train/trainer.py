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

Random draws come from ``torch.Generator``s that the step derives from the
state's seed and step count, so a step is a function of its state and its
inputs: the forward's dropout from stream 0, group g's gradient noise from
stream 1 + g.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from rau_vqa_tpu_torch.config import ModelConfig, TrainConfig
from rau_vqa_tpu_torch.convert import map_tree, tree_leaves
from rau_vqa_tpu_torch.devices import pick_device
from rau_vqa_tpu_torch.models.rau import init_params, rau_forward
from rau_vqa_tpu_torch.ops.rau_train_hops import check_fused_config
from rau_vqa_tpu_torch.train.losses import joint_loss_and_metrics
from rau_vqa_tpu_torch.train.optim import (
    adam_init,
    adam_update,
    add_gradient_noise,
    clip_by_global_norm,
)

PARAM_GROUPS = ("embed", "rnn", "mult")

# Metric keys that are sums over the batch (the rest are batch means): under
# gradient accumulation sums add across microbatches and means average.
_SUM_METRICS = ("do_pred_acc_num", "do_pred_acc_den")

_FROM_PIXELS = ("belongs to the from-pixels slice of the port (ROADMAP.md, "
                "queue 1): backbone fine-tuning is not ported")


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
    (``cuda`` when None, as ``make_train_step``)."""
    if bb_params is not None:
        raise NotImplementedError(f"a backbone parameter group {_FROM_PIXELS}")
    device = pick_device(device, "init_train_state")
    params = init_params(mcfg, torch.Generator().manual_seed(seed), device)
    return TrainState(params=params,
                      opt={g: adam_init(params[g]) for g in PARAM_GROUPS},
                      step=0, seed=seed)


def loss_and_grads(mcfg: ModelConfig, params: Dict, tokens, lengths, feats,
                   labels, hop_scale, *,
                   generator: Optional[torch.Generator] = None,
                   hop_seed=None) -> Tuple[Dict, Dict]:
    """The joint loss's gradient with respect to every parameter, as a tree
    like ``params``, and the metrics of ``joint_loss_and_metrics``."""
    with torch.enable_grad():
        p = map_tree(lambda x: x.detach().requires_grad_(), params)
        out = rau_forward(p, mcfg, tokens, lengths, feats, train=True,
                          generator=generator, hop_seed=hop_seed)
        loss, metrics = joint_loss_and_metrics(out.scores, out.do_pred,
                                               labels, hop_scale)
        flat = iter(torch.autograd.grad(loss, tree_leaves(p), allow_unused=True,
                                        materialize_grads=True))
    return map_tree(lambda _: next(flat), params), metrics


def make_train_step(mcfg: ModelConfig, tcfg: TrainConfig, *, device=None,
                    backbone: Optional[str] = None, img_repeat: int = 1):
    """The train step on ``device``: ``cuda`` when None, and then it raises
    without a card; only an explicit ``device="cpu"`` runs the plain
    versions.

    ``step(state, tokens, lengths, feats, labels, hop_scale, lr, mult_lr)
    -> (state, metrics)``.  Inputs may be numpy arrays or tensors.  With
    ``tcfg.grad_accum = k > 1`` the step runs k sequential microbatch
    backward passes (microbatch i = rows [i*B/k, (i+1)*B/k)) and one update
    on the averaged gradients: exact, since every loss term is a batch mean.
    """
    device = pick_device(device, "make_train_step")
    if tcfg.train_backbone or backbone is not None or img_repeat != 1:
        raise NotImplementedError(f"train_backbone / img_repeat {_FROM_PIXELS}")
    if mcfg.fused_train:
        check_fused_config(mcfg)
    accum = int(tcfg.grad_accum or 1)

    def grads_and_metrics(params, tokens, lengths, feats, labels, hop_scale,
                          generator):
        if accum == 1:
            return loss_and_grads(mcfg, params, tokens, lengths, feats,
                                  labels, hop_scale, generator=generator)
        B = tokens.shape[0]
        if B % accum:
            raise ValueError(f"batch_size {B} must divide by grad_accum {accum}")
        mb = B // accum
        grads = metrics = None
        for i in range(accum):
            rows = slice(i * mb, (i + 1) * mb)
            g, m = loss_and_grads(mcfg, params, tokens[rows], lengths[rows],
                                  feats[rows], labels[rows], hop_scale,
                                  generator=generator)
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
            state.params, tokens, lengths, feats, labels, hop_scale,
            _generator(device, state.seed, state.step, 0))
        lrs = {"embed": lr, "rnn": lr, "mult": mult_lr}
        new_params, new_opt = {}, {}
        for i, g in enumerate(PARAM_GROUPS):
            # state.step counts completed steps; the noise schedule takes the
            # 1-based iteration (the reference's `it`, :598)
            gg = add_gradient_noise(
                grads[g], _generator(device, state.seed, state.step, 1 + i),
                state.step + 1, tcfg.noisy_eta, tcfg.noisy_gamma)
            gg, norm = clip_by_global_norm(gg, tcfg.grad_clip)
            new_params[g], new_opt[g] = adam_update(
                state.params[g], gg, lrs[g], state.opt[g],
                beta1=tcfg.adam_beta1, beta2=tcfg.adam_beta2,
                epsilon=tcfg.adam_epsilon)
            metrics[f"grad_norm_{g}"] = norm
        return TrainState(new_params, new_opt, state.step + 1,
                          state.seed), metrics

    return step_fn
