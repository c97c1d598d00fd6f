"""From-pixels answering through a backbone other than ResNet-101:
``answer_pixels`` with the SigLIP tower or VGG16, one request in flight
(closed loop).

The backbone is the cell's ``backbone`` entry laid over the configuration's
(``name``: ``siglip`` or ``vgg16``; ``dtype``; for SigLIP the tower's
shape, for VGG16 ``image_size`` and the weights' ``conv_gain``).  On the
card its grid and width have to be the head's ``cnn_w``, ``cnn_h`` and
``cnn_dim``; on another device it is cut to them (``cut_to_head``).  A
request is B uint8 images from a pool of distinct batches in page-locked
host memory, with one question an image; the images go to the entry as a
host tensor and the entry places them on the card itself.  A request runs
from the call until its answer ids are on the host.

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
import counts
import counts_backbones
import harness
import traffic
import weights
import weights_backbones
from reference import rau as ref_rau
from reference import vgg as ref_vgg
from reference import vit as ref_vit

# the ResNet-101 driver's reading of the answers, rates and drain, shared
_pixels = harness.load_module("drivers", "pixels")
drain, metrics, numbers = _pixels.drain, _pixels.metrics, _pixels.numbers

TOWERS = ("siglip",)
# the program's ``ViTConfig`` fields that a tower's entry sets
TOWER_FIELDS = ("image_size", "patch", "dim", "depth", "heads", "mlp_dim", "ln_eps", "gelu",
                "mean", "std", "valid_patches")


def backbone_spec(ctx) -> dict:
    """The configuration's ``backbone`` with the cell's laid over it."""
    spec = dict(ctx.config.get("backbone") or {})
    spec.update(ctx.cell.get("backbone") or {})
    spec.setdefault("image_size", ctx.sizes.image_size)
    return cut_to_head(ctx, spec)


def grid_and_width(spec) -> tuple:
    if spec["name"] in TOWERS:
        return spec["image_size"] // spec["patch"], spec["dim"]
    return spec["image_size"] // 32, spec.get("widths", weights_backbones.VGG16_CONVS)[-1]


def cut_to_head(ctx, spec) -> dict:
    """The backbone as run: on the card the entry as it is; on another device
    (the benchmark's CPU tests, which cut a configuration's head to a tiny
    size and leave its ``backbone`` entry whole) cut to the head's input
    where it is not that already.  The grid becomes the head's, with the
    side's remainder past the last patch kept; a tower keeps one block at
    the head's width (its heads where they divide it, else one), VGG16 its
    13 convolutions, each at the head's width."""
    s = ctx.sizes
    g, d = grid_and_width(spec)
    if ctx.device.type == "cuda" or (g, g, d) == (s.cnn_w, s.cnn_h, s.cnn_dim):
        return spec
    if spec["name"] in TOWERS:
        heads = spec["heads"] if s.cnn_dim % spec["heads"] == 0 else 1
        return {**spec, "image_size": s.cnn_w * spec["patch"] + spec["image_size"] % spec["patch"],
                "dim": s.cnn_dim, "heads": heads, "depth": 1}
    return {**spec, "image_size": 32 * s.cnn_w,
            "widths": [s.cnn_dim] * len(weights_backbones.VGG16_CONVS)}


def check_program(ctx, spec):
    """Raises at once where the program cannot run this backbone, or where
    the backbone's output is not the head's input."""
    from rau_vqa_tpu_torch.models import pipeline
    if spec["name"] not in pipeline.BACKBONES:
        raise RuntimeError(f"the program has no {spec['name']!r} backbone "
                           f"(it has {pipeline.BACKBONES})")
    s = ctx.sizes
    g, d = grid_and_width(spec)
    if (g, g, d) != (s.cnn_w, s.cnn_h, s.cnn_dim):
        raise ValueError(f"{spec['name']} at {spec['image_size']} px gives {g}x{g}x{d} "
                         f"features, the head takes {s.cnn_w}x{s.cnn_h}x{s.cnn_dim}")


def vit_cfg(spec):
    """The program's tower config for a tower's entry; None for VGG16."""
    if spec["name"] not in TOWERS:
        return None
    from rau_vqa_tpu_torch.models.backbones.vit import ViTConfig
    kw = {k: spec[k] for k in TOWER_FIELDS if k in spec}
    for k in ("mean", "std"):
        if k in kw:
            kw[k] = tuple(kw[k])
    return ViTConfig(**kw)


def make_inputs(ctx) -> SimpleNamespace:
    """The head's and the backbone's weights, the image pool, tokens and
    lengths of one seed."""
    t, s, a = ctx.cell["traffic"], ctx.sizes, ctx.config["assumed"]
    spec = backbone_spec(ctx)
    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(ctx.seed)
    params = weights.rau_head(s, gen, ctx.config["init_scale"])
    dtype = getattr(torch, spec["dtype"])
    if spec["name"] in TOWERS:
        bb = weights_backbones.tower(spec, gen, dtype)
    else:
        bb = weights_backbones.vgg16(gen, dtype, spec["conv_gain"],
                                     spec.get("widths", weights_backbones.VGG16_CONVS))
    P, B, px = t["pool_batches"], t["batch"], spec["image_size"]
    images = torch.randint(0, 256, (P, B, px, px, 3), generator=gen, device=ctx.device,
                           dtype=torch.uint8)
    if ctx.device.type == "cuda":
        host = torch.empty(images.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(images)
        images = host
    rng = np.random.default_rng(ctx.seed)
    lengths = traffic.batch_lengths(a["question_length_probs"], P, B, rng)
    tokens = traffic.question_tokens(lengths, s.seq_len, s.vocab_size, rng)
    return SimpleNamespace(spec=spec, params=params, bb=bb, images=images, tokens=tokens,
                           lengths=lengths, P=P, B=B)


def setup(ctx):
    spec = backbone_spec(ctx)
    check_program(ctx, spec)
    vc = vit_cfg(spec)
    if ctx.device.type == "cuda":
        from rau_vqa_tpu_torch.ops import _build
        _build.build_all(["lstm_encoder", "rau_hops", "embed_image"])
    from rau_vqa_tpu_torch.models.pipeline import answer_pixels
    inp = make_inputs(ctx)
    st = SimpleNamespace(ctx=ctx, inp=inp, cfg=harness.model_config(ctx.config), vit_cfg=vc,
                         entry=answer_pixels,
                         kept=compare.Kept(ctx.cell["traffic"]["check_requests"], ctx.seed),
                         latencies=[])
    for p in range(min(2, inp.P)):
        _call(st, p)
    drain(st)
    return st


def _call(st, p):
    inp = st.inp
    with record_function("pixels.entry"):
        ids, att = st.entry(inp.params, inp.bb, st.cfg, inp.spec["name"], inp.images[p],
                            inp.tokens[p], inp.lengths[p], vit_cfg=st.vit_cfg,
                            device=st.ctx.device)
    with record_function("pixels.fetch_answers"):
        return ids.cpu(), att


def step(st, i):
    p = i % st.inp.P
    t0 = time.perf_counter()
    out = _call(st, p)
    st.latencies.append(time.perf_counter() - t0)
    st.kept.add(i, (p, out))


def work(st, i):
    p = i % st.inp.P
    s, B, spec = st.ctx.sizes, st.inp.B, st.inp.spec
    tokens = int(st.inp.lengths[p].sum())
    tower = spec["name"] in TOWERS
    per_image = (counts_backbones.tower_flops(spec) if tower
                 else counts_backbones.vgg16_flops(
                     spec["image_size"], spec.get("widths", weights_backbones.VGG16_CONVS)))
    out = {"step_flops": B * per_image + counts.serve_step_flops(s, B, tokens),
           "hops_bound_s": counts.hops_bound_s(s, B),
           "lstm_bound_s": counts.lstm_bound_s(s, B, s.seq_len, tokens)}
    if tower:
        out["vit_attention_bound_s"] = counts_backbones.attention_bound_s(spec, B)
    return out


def reference_features(spec, bb, images, rnd=None):
    if spec["name"] in TOWERS:
        return ref_vit.features(bb, spec, images, rnd)
    return ref_vgg.features(bb, images, rnd)


def reference_tables(ctx, inp, p, dot=ref_rau.dot_f32, rnd=None):
    """The reference's tables for pool batch ``p``: the backbone in blocks of
    ``reference_rows`` images, then the head; ``dot`` and ``rnd`` set the
    precision of the head's and the backbone's products."""
    s = ctx.sizes
    rows = ctx.cell["traffic"]["reference_rows"]
    images = inp.images[p].to(ctx.device)
    feats = torch.cat([reference_features(inp.spec, inp.bb, images[r:r + rows], rnd)
                       for r in range(0, images.shape[0], rows)])
    sizes = {"rnn_size": s.rnn_size, "n_hops": s.n_hops, "att_rnn_size": s.att_rnn_size}
    tokens = torch.as_tensor(inp.tokens[p], device=ctx.device)
    lengths = torch.as_tensor(inp.lengths[p], device=ctx.device)
    return ref_rau.tables(inp.params, sizes, tokens, lengths, feats, dot=dot)


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
