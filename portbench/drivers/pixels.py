"""From-pixels answering: ``answer_pixels`` on a ResNet-101 tree, one
request in flight (closed loop).

Each request is B uint8 images from a pool of distinct batches in
page-locked host memory, with one question an image; the images go to the
entry as a host tensor and the entry places them on the card itself.  A
request runs from the call until its answer ids are on the host.

Cell parameters (``traffic``): ``batch``, ``pool_batches``,
``check_requests`` (requests of the window kept for the comparison, drawn
from the seed, beside the last), ``reference_rows`` (images the reference
backbone takes at once); (``compare``) ``answer_margin``: the reference's
lead of its best answer over the runner-up, as a share of its largest
score, past which a served answer id has to be the reference's.
"""

from __future__ import annotations

import gc
import time
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
from reference import resnet as ref_resnet


def make_inputs(ctx) -> SimpleNamespace:
    """The head's and the backbone's weights, the image pool, tokens and
    lengths of one seed."""
    t, s, a = ctx.cell["traffic"], ctx.sizes, ctx.config["assumed"]
    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(ctx.seed)
    params = weights.rau_head(s, gen, ctx.config["init_scale"])
    bb = weights.resnet101_folded(gen, getattr(torch, ctx.config["backbone"]["dtype"]),
                                  a["residual_gain"], a["bias_std"])
    P, B, px = t["pool_batches"], t["batch"], s.image_size
    images = torch.randint(0, 256, (P, B, px, px, 3), generator=gen, device=ctx.device,
                           dtype=torch.uint8)
    if ctx.device.type == "cuda":
        host = torch.empty(images.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(images)
        images = host
    rng = np.random.default_rng(ctx.seed)
    lengths = traffic.batch_lengths(a["question_length_probs"], P, B, rng)
    tokens = traffic.question_tokens(lengths, s.seq_len, s.vocab_size, rng)
    return SimpleNamespace(params=params, bb=bb, images=images, tokens=tokens,
                           lengths=lengths, P=P, B=B)


def setup(ctx):
    if ctx.device.type == "cuda":
        from rau_vqa_tpu_torch.ops import _build
        _build.build_all(["lstm_encoder", "rau_hops", "fused_resnet"])
    from rau_vqa_tpu_torch.models.pipeline import answer_pixels
    inp = make_inputs(ctx)
    st = SimpleNamespace(ctx=ctx, inp=inp, cfg=harness.model_config(ctx.config), entry=answer_pixels,
                         kept=compare.Kept(ctx.cell["traffic"]["check_requests"], ctx.seed),
                         latencies=[])
    for p in range(min(2, inp.P)):
        _call(st, p)
    drain(st)
    return st


def _call(st, p):
    inp = st.inp
    with record_function("pixels.entry"):
        ids, att = st.entry(inp.params, inp.bb, st.cfg, "resnet101", inp.images[p],
                            inp.tokens[p], inp.lengths[p], device=st.ctx.device)
    with record_function("pixels.fetch_answers"):
        return ids.cpu(), att


def step(st, i):
    p = i % st.inp.P
    t0 = time.perf_counter()
    out = _call(st, p)
    st.latencies.append(time.perf_counter() - t0)
    st.kept.add(i, (p, out))


def drain(st):
    if st.ctx.device.type == "cuda":
        torch.cuda.synchronize(st.ctx.device)


def metrics(st, steps, window_s):
    lat = np.asarray(st.latencies)
    return {"pixels_images_per_s": steps * st.inp.B / window_s,
            "pixels_p95_ms": float(np.percentile(lat, 95)) * 1e3}


def work(st, i):
    p = i % st.inp.P
    s, B = st.ctx.sizes, st.inp.B
    tokens = int(st.inp.lengths[p].sum())
    runs = counts.identity_runs(B, s.image_size)
    return {"step_flops": B * counts.resnet101_flops(s.image_size)
            + counts.serve_step_flops(s, B, tokens),
            "stage_bound_s": sum(counts.stage_bound_s(*r) for r in runs),
            "hops_bound_s": counts.hops_bound_s(s, B),
            "lstm_bound_s": counts.lstm_bound_s(s, B, s.seq_len, tokens)}


def reference_tables(ctx, inp, p, dot=ref_rau.dot_f32, rnd=None):
    """The reference's tables for pool batch ``p``: ResNet-101 in blocks of
    ``reference_rows`` images, then the head; ``dot`` and ``rnd`` set the
    precision of the head's and the backbone's products."""
    s = ctx.sizes
    rows = ctx.cell["traffic"]["reference_rows"]
    images = inp.images[p].to(ctx.device)
    feats = torch.cat([ref_resnet.features(inp.bb, images[r:r + rows], rnd)
                       for r in range(0, images.shape[0], rows)])
    sizes = {"rnn_size": s.rnn_size, "n_hops": s.n_hops, "att_rnn_size": s.att_rnn_size}
    tokens = torch.as_tensor(inp.tokens[p], device=ctx.device)
    lengths = torch.as_tensor(inp.lengths[p], device=ctx.device)
    return ref_rau.tables(inp.params, sizes, tokens, lengths, feats, dot=dot)


def numbers(ctx, ids, att, ref_pred, ref_att, ref_do):
    out = compare.attention_maps(att, ref_att, ref_do)
    out["answer_miss"] = compare.answer_misses(ids, ref_pred, ref_do,
                                               ctx.cell["compare"]["answer_margin"])
    return out


def judge(ctx, inp, outputs):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    readings = []
    with torch.no_grad():
        for p, (ids, att) in outputs:
            readings.append(numbers(ctx, ids, att, *reference_tables(ctx, inp, p)))
    return compare.with_limits(compare.worst(readings), ctx.cell["limits"])


def check(st):
    outputs = st.kept.items()
    st.entry, st.kept = None, None
    gc.collect()
    if st.ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return judge(st.ctx, st.inp, outputs)


def control(ctx):
    """The control's numbers on this seed's inputs: the reference with every
    product of the backbone and the head in fp8 put in the program's place,
    on the requests a run checks."""
    inp = make_inputs(ctx)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    readings = []
    with torch.no_grad():
        for p in range(min(inp.P, ctx.cell["traffic"]["check_requests"] + 1)):
            pred, att, _ = reference_tables(ctx, inp, p, ref_rau.dot_fp8, ref_rau.fp8_round)
            readings.append(numbers(ctx, pred.argmax(-1), att, *reference_tables(ctx, inp, p)))
    return compare.worst(readings)
