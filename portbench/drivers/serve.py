"""Bulk evaluation on precomputed features: ``make_predict_step`` over
batches of B questions, as ``Trainer.evaluate`` drives it.

Each batch's tokens are copied without blocking from page-locked host memory
and handed over as a device tensor; its lengths are a host array; its
features are float32 and resident on the card, in a pool of distinct
batches that the window cycles through.  Closed loop: the next batch is
enqueued as soon as the entry returns; the answers stay on the card.  The
window ends when the last batch's answers are there.

Cell parameters (``traffic``): ``batch``, ``pool_batches``, ``buckets``
(the predict step's token ladder), ``check_batches`` (batches of the
window kept for the comparison, drawn from the seed, beside the last).
"""

from __future__ import annotations

import gc
from types import SimpleNamespace

import numpy as np
import torch
from torch.profiler import record_function

import compare
import harness
import counts
import traffic
import weights
from reference import rau as ref_rau


def feature_pool(ctx, gen, n_batches: int, batch: int) -> torch.Tensor:
    """float32 [n, B, S, Dc] features, ReLU of a normal draw (the sign
    pattern of a post-ReLU conv map), on the card, one draw."""
    s = ctx.sizes
    shape = (n_batches, batch, s.cnn_spat, s.cnn_dim)
    return torch.randn(shape, generator=gen, device=gen.device).clamp_(min=0.0)


def make_inputs(ctx) -> SimpleNamespace:
    """The weights, tokens, lengths and feature pool of one seed."""
    t, s = ctx.cell["traffic"], ctx.sizes
    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(ctx.seed)
    params = weights.rau_head(s, gen, ctx.config["init_scale"])
    P, B = t["pool_batches"], t["batch"]
    rng = np.random.default_rng(ctx.seed)
    lengths = traffic.batch_lengths(ctx.config["assumed"]["question_length_probs"], P, B, rng)
    tokens = torch.from_numpy(traffic.question_tokens(lengths, s.seq_len, s.vocab_size, rng))
    if ctx.device.type == "cuda":
        tokens = tokens.pin_memory()
    feats = feature_pool(ctx, gen, P, B)
    return SimpleNamespace(params=params, lengths=lengths, tokens=tokens, feats=feats,
                           P=P, B=B)


def setup(ctx):
    from rau_vqa_tpu_torch.eval.predict import bucket_ladder, make_predict_step, pick_bucket
    if ctx.device.type == "cuda":
        from rau_vqa_tpu_torch.ops import _build
        _build.build_all(["lstm_encoder", "rau_hops"])
    inp = make_inputs(ctx)
    t = ctx.cell["traffic"]
    cfg = harness.model_config(ctx.config)
    program = make_predict_step(cfg, buckets=tuple(t["buckets"]), device=ctx.device)
    ladder = bucket_ladder(cfg.seq_len, t["buckets"])
    T = [pick_bucket(ladder, int(inp.lengths[p].max())) for p in range(inp.P)]
    st = SimpleNamespace(ctx=ctx, inp=inp, program=program, cfg=cfg, T=T,
                         kept=compare.Kept(t["check_batches"], ctx.seed))
    warmed = set()
    for p in range(inp.P):          # every token bucket the pool uses, once
        if T[p] not in warmed:
            _call(st, p)
            warmed.add(T[p])
    drain(st)
    return st


def _call(st, p):
    inp = st.inp
    with record_function("serve.place_tokens"):
        tokens = inp.tokens[p].to(st.ctx.device, non_blocking=True)
    with record_function("serve.entry"):
        return st.program(inp.params, tokens, inp.lengths[p], inp.feats[p])


def step(st, i):
    p = i % st.inp.P
    st.kept.add(i, (p, _call(st, p)))


def drain(st):
    if st.ctx.device.type == "cuda":
        torch.cuda.synchronize(st.ctx.device)


def metrics(st, steps, window_s):
    return {"serve_qps": steps * st.inp.B / window_s}


def work(st, i):
    p = i % st.inp.P
    s, B = st.ctx.sizes, st.inp.B
    tokens = int(st.inp.lengths[p].sum())
    return {"step_flops": counts.serve_step_flops(s, B, tokens),
            "hops_bound_s": counts.hops_bound_s(s, B),
            "lstm_bound_s": counts.lstm_bound_s(s, B, st.T[p], tokens)}


def reference_tables(ctx, inp, p, dot=ref_rau.dot_f32, embed_dot=None):
    s = ctx.sizes
    sizes = {"rnn_size": s.rnn_size, "n_hops": s.n_hops, "att_rnn_size": s.att_rnn_size}
    tokens = inp.tokens[p].to(ctx.device)
    lengths = torch.as_tensor(inp.lengths[p], device=ctx.device)
    return ref_rau.tables(inp.params, sizes, tokens, lengths, inp.feats[p], dot=dot,
                          embed_dot=embed_dot)


def judge(ctx, inp, outputs):
    """The numbers and their limits for served (pool batch, (tab_pred,
    tab_att)) pairs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    readings = []
    with torch.no_grad():
        for p, (pred, att) in outputs:
            ref_pred, ref_att, ref_do = reference_tables(ctx, inp, p)
            readings.append(compare.score_tables(pred, att, ref_pred, ref_att, ref_do))
    return compare.with_limits(compare.worst(readings), ctx.cell["limits"])


def check(st):
    outputs = st.kept.items()
    st.program, st.kept = None, None
    gc.collect()
    if st.ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return judge(st.ctx, st.inp, outputs)


# the reference put in the program's place: (every product's precision, the
# image embedding's where it differs)
CONTROLS = {"fp8": (ref_rau.dot_fp8, None),
            "embed_bf16": (ref_rau.dot_f32, ref_rau.dot_bf16),
            "embed_tf32": (ref_rau.dot_f32, ref_rau.dot_tf32)}


def control(ctx, variant: str = "fp8"):
    """The control's numbers on this seed's inputs, on the batches a run
    checks: the reference put in the program's place with every product in
    fp8 (``fp8``, the control), or float32 but for the image embedding's
    product in bf16 or TF32 (``embed_bf16``, ``embed_tf32``: one step below
    the float32 that the configuration states for it)."""
    inp = make_inputs(ctx)
    torch.backends.cuda.matmul.allow_tf32 = False
    dot, embed_dot = CONTROLS[variant]
    readings = []
    with torch.no_grad():
        for p in range(min(inp.P, ctx.cell["traffic"]["check_batches"] + 1)):
            pred, att, _ = reference_tables(ctx, inp, p, dot, embed_dot)
            readings.append(compare.score_tables(pred, att, *reference_tables(ctx, inp, p)))
    return compare.worst(readings)
