"""The training step on precomputed features: ``make_train_step`` of the
preset as shipped (unfused hop loop, float32, dropout and gradient noise on,
length buckets), each step on the previous step's state.

Batches of B questions come from a device-resident pool of distinct batches
(features float32, tokens cut to the batch's length bucket, answer labels
from a Zipf law), the window cycling through it; the pool's first batches
hold one of each length bucket it uses.  Set-up builds the one step object
and state, and drives them from the seed through the first steps on
distinct batches, at least ``check_steps`` and at least one a bucket; the
window goes on from there.  The window ends in a synchronise.

The step is functional (it returns a new state), so the window keeps the
states before and after ``window_checks`` of its steps, drawn from the seed,
and its last, by reference alone.  After the window the reference follows
the first ``check_steps`` steps from the weights, and each kept window step
from the program's own state before it.

Cell parameters (``traffic``): ``batch``, ``pool_batches``, ``check_steps``,
``window_checks``, ``zipf_exponent``.
"""

from __future__ import annotations

import gc
from types import SimpleNamespace

import numpy as np
import torch
from torch.profiler import record_function

import compare
import counts
import harness
import traffic
import weights
from reference import train as ref_train


def make_inputs(ctx) -> SimpleNamespace:
    t, s = ctx.cell["traffic"], ctx.sizes
    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(ctx.seed)
    params = weights.rau_head(s, gen, ctx.config["init_scale"])
    P, B = t["pool_batches"], t["batch"]
    rng = np.random.default_rng(ctx.seed)
    lengths = traffic.batch_lengths(ctx.config["assumed"]["question_length_probs"], P, B, rng)
    tokens = traffic.question_tokens(lengths, s.seq_len, s.vocab_size, rng)
    labels = traffic.zipf_labels(P * B, s.answer_size, t["zipf_exponent"], rng).reshape(P, B)
    feats = torch.randn((P, B, s.cnn_spat, s.cnn_dim), generator=gen,
                        device=ctx.device).clamp_(min=0.0)
    dev = ctx.device
    return SimpleNamespace(params=params, lengths_np=lengths,
                           lengths=torch.as_tensor(lengths, device=dev),
                           tokens=torch.as_tensor(tokens, device=dev),
                           labels=torch.as_tensor(labels, device=dev), feats=feats,
                           hop_scale=torch.ones(s.n_hops, device=dev), P=P, B=B)


def buckets_first(T):
    """A pool order with the first batch of each length bucket in front, in
    the order the buckets first appear, and the others after them."""
    firsts = [T.index(t) for t in dict.fromkeys(T)]
    return firsts + [p for p in range(len(T)) if p not in firsts]


def make_program(ctx, inp):
    """The step object, its state on the benchmark's weights, and each pool
    batch's length bucket, as the trainer cuts them; the pool reordered by
    ``buckets_first``."""
    from rau_vqa_tpu_torch.config import TrainConfig
    from rau_vqa_tpu_torch.eval.predict import bucket_ladder, pick_bucket
    from rau_vqa_tpu_torch.train.optim import adam_init
    from rau_vqa_tpu_torch.train.trainer import TrainState, make_train_step
    cfg = harness.model_config(ctx.config)
    tcfg = TrainConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in ctx.config["train"].items()})
    program = make_train_step(cfg, tcfg, device=ctx.device)
    state = TrainState(params=inp.params, opt={g: adam_init(inp.params[g]) for g in inp.params},
                       step=0, seed=ctx.seed)
    ladder = bucket_ladder(cfg.seq_len, tcfg.length_buckets)
    T = [pick_bucket(ladder, int(inp.lengths_np[p].max())) for p in range(inp.P)]
    order = buckets_first(T)
    idx = torch.as_tensor(order, device=ctx.device)
    inp.lengths_np = inp.lengths_np[order]
    inp.lengths, inp.tokens, inp.labels = inp.lengths[idx], inp.tokens[idx], inp.labels[idx]
    return program, state, tcfg, [T[p] for p in order]


def _call(st, state, p):
    inp = st.inp
    with record_function("train.entry"):
        return st.program(state, inp.tokens[p, :, :st.T[p]], inp.lengths[p], inp.feats[p],
                          inp.labels[p], inp.hop_scale, st.tcfg.learning_rate,
                          st.tcfg.mult_learning_rate)


def first_steps(st, n: int):
    """Steps 0..n-1 on pool batches 0..n-1: (the state after them, each
    step's loss, the first step's Adam state, the params after each)."""
    state, losses, params = st.state, [], []
    for k in range(n):
        state, m = _call(st, state, k)
        losses.append(m["loss"])
        params.append(state.params)
        if k == 0:
            opt1 = state.opt
    return state, losses, opt1, params


def setup(ctx):
    t = ctx.cell["traffic"]
    inp = make_inputs(ctx)
    program, state, tcfg, T = make_program(ctx, inp)
    st = SimpleNamespace(ctx=ctx, inp=inp, program=program, state=state, tcfg=tcfg, T=T,
                         kept=compare.Kept(t["window_checks"], ctx.seed))
    n = max(t["check_steps"], len(set(T)))
    st.state, st.losses, st.opt1, st.params_after = first_steps(st, n)
    st.first = n
    drain(st)
    return st


def step(st, i):
    before = st.state
    st.state, m = _call(st, before, (st.first + i) % st.inp.P)
    st.kept.add(i, (before, st.state, m["loss"]))


def drain(st):
    if st.ctx.device.type == "cuda":
        torch.cuda.synchronize(st.ctx.device)


def metrics(st, steps, window_s):
    return {"train_qps": steps * st.inp.B / window_s}


def work(st, i):
    p = (st.first + i) % st.inp.P
    return {"step_flops": counts.train_step_flops(st.ctx.sizes, st.inp.B, st.T[p])}


def _norms(tree):
    return [x.float().norm().item() for x in ref_train.leaves(tree)]


def _worst_gap(got, want, keep=None):
    """Over leaves, |got - want| / max(want, the median leaf's want)."""
    med = float(np.median(want))
    gaps = [abs(g - w) / max(w, med, 1e-30) for g, w in zip(got, want)]
    if keep is not None:
        gaps = [x for x, k in zip(gaps, keep) if k]
    return max(gaps)


def _tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def _moved(raw):
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's: the others (a bias under softmax) move by round-off."""
    raw_norms = _norms(raw)
    return [r >= 1e-3 * float(np.median(raw_norms)) for r in raw_norms]


def _as_ref_opt(opt):
    return {g: {"m": opt[g]["m"], "v": opt[g]["v"], "t": int(opt[g]["t"])}
            for g in ref_train.GROUPS}


def first_numbers(ctx, inp, tcfg, losses, opt1, params_n, n: int):
    """Each of the first ``n`` steps' loss, the first gradient as the
    optimizer got it (from its first moment), and the parameters' change
    over the ``n`` steps, against the reference's from the weights."""
    s = ctx.sizes
    params, opt = inp.params, ref_train.init_opt(inp.params)
    ref_losses, got1, raw1 = [], None, None
    for k in range(n):
        batch = (inp.tokens[k], inp.lengths[k], inp.feats[k], inp.labels[k], inp.hop_scale)
        loss, raw, got, params, opt = ref_train.step(
            params, opt, s, tcfg, ctx.seed, k, batch, tcfg.learning_rate,
            tcfg.mult_learning_rate)
        ref_losses.append(loss.item())
        if k == 0:
            got1, raw1 = got, raw
    loss_gap = max(abs(a.item() - b) / abs(b) for a, b in zip(losses, ref_losses))
    prog_g1 = {g: [x / (1 - tcfg.adam_beta1) for x in ref_train.leaves(opt1[g]["m"])]
               for g in ref_train.GROUPS}
    grad_gap = _worst_gap(_norms(prog_g1), _norms(got1))
    moved = _moved(raw1)
    delta_p = [a - b for a, b in zip(ref_train.leaves(params_n), ref_train.leaves(inp.params))]
    delta_r = [a - b for a, b in zip(ref_train.leaves(params), ref_train.leaves(inp.params))]
    change_gap = _worst_gap(_norms(delta_p), _norms(delta_r), moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}


def window_numbers(ctx, inp, tcfg, kept):
    """For each kept window step, (state before, state after, loss), the
    reference's step from the program's state before it: the loss's gap,
    the gradient as the optimizer got it (worked out from its first moment
    before and after, in float64) and the step's change of the parameters,
    each the worst over the kept steps."""
    s, b1 = ctx.sizes, tcfg.adam_beta1
    loss_gap = grad_gap = change_gap = 0.0
    for before, after, loss in kept:
        k = before.step
        p = k % inp.P
        batch = (inp.tokens[p], inp.lengths[p], inp.feats[p], inp.labels[p], inp.hop_scale)
        ref_loss, raw, got, params, _ = ref_train.step(
            before.params, _as_ref_opt(before.opt), s, tcfg, ctx.seed, k, batch,
            tcfg.learning_rate, tcfg.mult_learning_rate)
        loss_gap = max(loss_gap, abs(loss.item() - ref_loss.item()) / abs(ref_loss.item()))
        prog_g = {g: [(a.double() - b1 * b.double()) / (1 - b1) for a, b in
                      zip(ref_train.leaves(after.opt[g]["m"]), ref_train.leaves(before.opt[g]["m"]))]
                  for g in ref_train.GROUPS}
        grad_gap = max(grad_gap, _worst_gap(_norms(prog_g), _norms(got)))
        old = ref_train.leaves(before.params)
        delta_p = [a.double() - b.double() for a, b in zip(ref_train.leaves(after.params), old)]
        delta_r = [a.double() - b.double() for a, b in zip(ref_train.leaves(params), old)]
        change_gap = max(change_gap, _worst_gap(_norms(delta_p), _norms(delta_r), _moved(raw)))
    return {"window_loss_gap": loss_gap, "window_grad_gap": grad_gap,
            "window_change_gap": change_gap}


def judge(st):
    """Every number of the cell, the program's state freed first."""
    kept = st.kept.items()
    st.program, st.state, st.kept = None, None, None
    gc.collect()
    if st.ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    _tf32(False)
    n = st.ctx.cell["traffic"]["check_steps"]
    numbers = first_numbers(st.ctx, st.inp, st.tcfg, st.losses[:n], st.opt1,
                            st.params_after[n - 1], n)
    numbers.update(window_numbers(st.ctx, st.inp, st.tcfg, kept))
    return numbers


def check(st):
    return compare.with_limits(judge(st), st.ctx.cell["limits"])


def control(ctx, steps: int = 16):
    """The control's numbers on this seed: the program with TF32 switched on
    for its float32 products, through set-up and ``steps`` window steps."""
    _tf32(True)
    st = setup(ctx)
    for i in range(steps):
        step(st, i)
    drain(st)
    return judge(st)
