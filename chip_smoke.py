"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure exits non-zero:

1. device   — a Hopper card (capability 9.0); its name and power limit;
2. build    — every CUDA source of rau_vqa_tpu_torch/csrc that a path runs
              (not the stage kernel's probe build, fused_resnet_probe.cu)
              with nvcc for sm_90a, one nvcc each, all at once, with the
              ptxas register / shared-memory / spill report (the encoder's
              and the stage kernel's per instantiation, the training
              forward's and backward's per phase kernel), the encoder's
              grid plan (CTAs, units a CTA, shared memory) at each batch
              size the run uses, and the training kernels' ``fwd_plan`` and
              ``bwd_plan`` (kernels a hop, K chunks, scratch, shared
              memory), their grids held to the launches of a dry run of
              each built C entry at B in {1, 19, 37, 100}, in both types,
              and the hop kernel's ``hops_plan`` held likewise to its C
              entry's dry run at B in {1, 4, 16, 19, 37, 83, 512};
3. kernels  — each kernel against its plain version at ``ours_ms`` widths:
              the encoder at B in {1, 19, 83, 512} (rows of length 0 and T + 1
              give zeros; a second call gives the same bits) and the hop
              kernel at B in {1, 19, 83, 512}, at the bars of
              tests/test_pallas_rau.py (each reading logged beside its bar;
              a second call gives the same bits); the device mask hash bit
              for bit; the
              training hop loop's forward (rtol / atol 1e-4) and backward
              (grads norm-relative 1e-3 per leaf), each twice on the same
              inputs for the same bits, at B in {19, 100}, the bf16
              forward's and backward's two calls at B=100 likewise; the same
              kernels' bf16 instantiations against their bf16 plain versions
              on bf16 weights, each output and grad leaf norm-relative: at
              one hop, B in {19, 100}, within ``TRAIN_BF16_BARS``, each bar
              under half the plain bf16-vs-float32 distance (logged); at
              eight hops, B in {19, 100}, within twice the plain version's
              own drift when it runs on the host CPU (bf16 rounding flips
              compound over the hops) and under 3/4 of the float32
              distance, which a kernel that skips the rounding reaches; the
              ResNet identity-stage kernel at the four 448-px stage shapes
              (real N, B=2, bf16; each plan's shared memory as the built
              launcher reckons it), in float32 at stage 3's, and at B=3 on
              tiles cut by the image's edge (bars
              scale-normalised, as in tests/test_fused_resnet.py, set from
              readings), where with biases around +1 a relu(b1) halo or a
              dropped bias must land beyond twice the bar; a host watchdog
              ends the run with a message if the stage checks hang, and the
              kernel's own mbarrier watchdog traps a wait that never ends;
4. serving  — ``make_predict_step`` on cuda answers batches of 1, 4, 16, 83
              and 512 with length buckets 8, 16 and 26 each hit; outputs are
              finite and agree with the plain float32 path; both serving
              kernels' launch counts rose during this phase;
5. training — ``make_train_step`` on cuda, ``ours_ms``, B=100, T=26, 10 steps
              on one batch with all dropout and gradient noise on, losses and
              grad norms finite and the last loss below the first, in three
              configurations: fused_train in float32 (each float32 training
              kernel launched exactly 10 times; one step with the backward
              kernel and one with autograd through the plain version agree on
              every grad norm); the preset as shipped (unfused, no training
              kernel launched; one step with remat_hops and one without give
              the same grad norms); fused_train with compute_dtype bfloat16
              (each bf16 kernel launched exactly 10 times, the float32 ones
              never; the first loss within 5% of the float32 fused step's);
              the preset unfused with compute_dtype bfloat16 (no training
              kernel; the first loss within 5% of the unfused float32
              step's);
6. pixels   — ``answer_pixels`` on cuda: the ``ours_resnet`` head, a folded
              bf16 ResNet-101 from the seed, 448x448 uint8 images, B in
              {1, 7, 120} (32, 5 and 1 calls); against ``pixels_forward``
              (the unfused cuDNN backbone on the same tree, the plain float32
              head), with bf16's own effect measured as ``pixels_forward`` on
              the bf16 tree against the float32 tree: answers agree > 0.95
              counting bf16 ties, and with the float32 tree no less than
              ``pixels_forward`` does; attention within twice bf16's own
              change; the kernels' head agrees with the float32 head on the
              same features at the serving bars; the fused backbone is no
              farther from the float32 features than cuDNN's bf16 one; the
              stage kernel ran 4 times a call, the encoder and hop kernels
              once; and the stage kernel agrees with its plain version at
              the B=120 call's own stage inputs;
7. timing   — CUDA-event times of each kernel and its plain version; the
              encoder at B in {1, 16, 83, 512}, T=26, beside torch.nn.LSTM
              in float32 (TF32 off; the ``library_ms`` yardstick) and, logged
              only, in bf16; the predict step at B in {1, 4, 16, 83, 512},
              the train step and its parts at B=100 (fused float32, fused
              bf16, the unfused preset and it in bf16, each with its idle
              share; the bf16
              kernels beside their plain versions), the hop kernel at B in
              {1, 4, 16, 83, 512} with the host's enqueue time of a call and
              its device kernels a call (the profiler's count, held to its
              plan's 2 + 11 a hop), and ``answer_pixels``
              at B=120 with its parts: each stage kernel beside its plain
              version, the unfused cuDNN stage and its bound, with its plan
              (tile, ring, shared memory, registers) and the weight bytes its
              CTAs read from L2; the stage kernel's levers one at a time (the
              old 4x14 tile at stage 2, the ring's depth at stage 1); the
              device time by kernel with the
              op that launched it; the mask hash beside its plain version;
              each training kernel's device kernels a call, from the
              profiler's records, held to its plan's phases times the hops,
              in both types; the forward's peak device memory a call.

Prints each number beside the card's name and power limit, a ``kernels``
JSON line (the hop kernel's and the training kernels' entries also give
their device kernels a call, as recorded), and as the last line
``{"ok": true, "device": {...}}``.  Weights
are random, from the seed.  Imports nothing of JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch

H100_BF16_FLOPS = 989e12      # dense bf16 tensor-core peak, H100 SXM
H100_F32_FLOPS = 67e12        # float32 outside the tensor cores, H100 SXM
H100_BYTES_PER_S = 3.35e12    # HBM3, H100 SXM
H100_INT32_OPS = 33.5e12      # 64 int32 lanes a SM a clock, half the f32 rate


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn, iters: int = 3):
    """Per call of ``fn`` under torch.profiler: (the sum of the device's
    kernel times in ms, [(kernel name, ms)] largest first, {kernel name: the
    op that launched most of its time, with two of its callers}, the number
    of device kernels and copies a call ran, [(host op, its own host ms,
    calls)] largest first).  The sum is 0 where the profiler records no
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name, n_kernels, host = {}, 0, []
    for e in prof.key_averages():
        # the device's own rows (kernels, copies); CPU-op rows repeat them
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            by_name[e.key] = by_name.get(e.key, 0.0) + e.self_device_time_total / 1e3 / iters
            n_kernels += e.count
        elif e.device_type == DeviceType.CPU:
            host.append((e.key, e.self_cpu_time_total / 1e3 / iters, e.count / iters))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    # each CPU op lists the device kernels it launched
    launched = {}
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        chain, up = [e.name], e.cpu_parent
        while up is not None and len(chain) < 3:
            chain.append(up.name)
            up = up.cpu_parent
        for k in e.kernels:
            per_op = launched.setdefault(k.name, {})
            per_op[" < ".join(chain)] = per_op.get(" < ".join(chain), 0.0) + k.duration
    ops = {k: max(v, key=v.get) for k, v in launched.items()}
    return sum(by_name.values()), top, ops, n_kernels / iters, sorted(host, key=lambda r: -r[1])


def device_kernels(fn) -> int:
    """The device kernels one call of ``fn`` ran, from torch.profiler's
    kernel records (memsets and copies not counted)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.name.startswith(("Memset", "Memcpy")))


def fwd_bit_equal(rth, got, *args) -> bool:
    """Whether a second call of the training forward on the same inputs
    gives the bits of ``got`` in every output."""
    again = rth.train_hops_fwd(*args)
    torch.cuda.synchronize()
    return all(torch.equal(g, a) for g, a in zip(got, again))


def bwd_bit_equal(rth, *args) -> bool:
    """Whether two calls of the training backward on the same inputs give
    the same bits in every emission and feats-path grad."""
    em, gw = rth.train_hops_bwd(*args)
    em2, gw2 = rth.train_hops_bwd(*args)
    torch.cuda.synchronize()
    return (all(torch.equal(em[k], em2[k]) for k in em)
            and all(torch.equal(gw[k], gw2[k]) for k in gw))


@contextlib.contextmanager
def watchdog(seconds: float, what: str):
    """Ends the process with a message if the block takes longer than
    ``seconds``: a kernel that hangs must fail the run, never stall it."""
    def fire():
        print(f"chip_smoke: watchdog: {what} did not finish in {seconds:.0f} s", flush=True)
        print(f"chip_smoke: watchdog: {what} did not finish in {seconds:.0f} s",
              file=sys.stderr, flush=True)
        os._exit(3)
    timer = threading.Timer(seconds, fire)
    timer.daemon = True
    timer.start()
    try:
        yield
    finally:
        timer.cancel()


def make_batch(cfg, B, max_len, rs, dev):
    lengths = rs.randint(1, max_len + 1, B).astype(np.int32)
    lengths[0] = max_len
    tokens = np.zeros((B, cfg.seq_len), np.int64)
    for k in range(B):
        tokens[k, :lengths[k]] = rs.randint(1, cfg.vocab_size, lengths[k])
    feats = np.abs(rs.randn(B, cfg.cnn_spat, cfg.cnn_dim)).astype(np.float32)
    return (torch.as_tensor(tokens, device=dev), torch.as_tensor(lengths, device=dev),
            torch.as_tensor(feats, device=dev))


def nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(nbytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(nbytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def bound(n_bytes: float, n_ops: float, peak_flops: float):
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def lstm_bound(cfg, enc, lengths, T):
    """Least time for the encoder: inputs (emb, lengths, the kernel's weight
    slabs and biases) read once, output written once; bf16 dots for each
    row's real tokens only."""
    B, E, R, L = lengths.shape[0], cfg.embed_dim, cfg.rnn_size, cfg.rnn_layers
    n_bytes = (B * T * E * 4 + B * 4 + nbytes(enc["slabs"]) + nbytes(enc["bias"])
               + B * 2 * L * R * 4)
    per_step = 2 * 4 * R * (E + R) + (L - 1) * 2 * 4 * R * (R + R)
    n_ops = per_step * int(lengths.long().sum())
    return bound(n_bytes, n_ops, H100_BF16_FLOPS)


def hops_bound(cfg, hw, B):
    """Least time for the hop loop: q, ifeat, iatt and the weights read once,
    the three outputs written once; the dots and the pooling in bf16 terms."""
    Q, S, M, F = cfg.rnnout_dim, cfg.cnn_spat, cfg.multfeat_dim, cfg.attfeat_dim
    R, A, H = cfg.att_rnn_size, cfg.answer_size, cfg.n_hops
    n_bytes = (B * Q * 4 + B * S * (M + F) * 2 + nbytes(hw)
               + H * B * (A + 1 + S) * 4)
    per_hop = 2 * (R * M + M * F + S * F + R * S + S * M + S * M
                   + M * 4 * R + R * 4 * R + R * M + M * A + M)
    n_ops = B * (2 * Q * M + H * per_hop)
    return bound(n_bytes, n_ops, H100_BF16_FLOPS)


def train_hop_flops(cfg):
    """Multiply-adds x 2 of one training hop's forward for one row (the
    classifier included), and of its backward without the remat."""
    Q, S, Dc, M, F = cfg.rnnout_dim, cfg.cnn_spat, cfg.cnn_dim, cfg.multfeat_dim, cfg.attfeat_dim
    R, A = cfg.att_rnn_size, cfg.answer_size
    fwd = 2 * (Q * M + R * M + S * Dc * M + S * M * F + M * F + S * F + R * S
               + S * M + S * M + M * 4 * R + R * 4 * R + R * M + M * A + M)
    bwd = 2 * (M * R + 4 * R * M + 4 * R * R + M * S + S * M + S * R + S * F
               + F * M + M * R + M * S * F + S * F * M + S * Dc * M)
    return fwd, bwd


def _operand_size_and_peak(dtype):
    """Bytes an operand of the training kernels takes, and the peak rate of
    their products: float32 FMA, or bf16 on the tensor cores."""
    if dtype == torch.bfloat16:
        return 2, H100_BF16_FLOPS
    return 4, H100_F32_FLOPS


def train_fwd_bound(cfg, mp, B, dtype=torch.float32):
    """Least time for the training hop loop's forward: q, feats (in the
    products' type ``dtype``) and the weights ``mp`` read once, the five
    float32 outputs written once; the products at ``dtype``'s peak."""
    Q, S, Dc, R, A, H = (cfg.rnnout_dim, cfg.cnn_spat, cfg.cnn_dim,
                         cfg.att_state_dim, cfg.answer_size, cfg.n_hops)
    e, peak = _operand_size_and_peak(dtype)
    n_bytes = ((B * Q + B * S * Dc) * e + (H * B * (A + 1 + S) + 2 * (H + 1) * B * R) * 4
               + nbytes(mp))
    return bound(n_bytes, B * H * train_hop_flops(cfg)[0], peak)


def train_bwd_bound(cfg, mp, B, dtype=torch.float32):
    """Least time for the backward kernel's work: q, feats (in ``dtype``),
    the carries, gmerge and the weights read once; its emissions (float32
    cotangents, qfeat / join / merge_d in ``dtype``) and the summed
    feats-path grads written once; the hop's remat (without the classifier)
    plus its backward at ``dtype``'s peak."""
    Q, S, Dc, M, F, R, A, H = (cfg.rnnout_dim, cfg.cnn_spat, cfg.cnn_dim, cfg.multfeat_dim,
                               cfg.attfeat_dim, cfg.att_state_dim, cfg.answer_size, cfg.n_hops)
    e, peak = _operand_size_and_peak(dtype)
    cotangents = 3 * M + F + S + 4 * R
    n_bytes = ((B * Q + B * S * Dc) * e + H * B * 3 * M * e
               + (2 * (H + 1) * B * R + H * B * M + H * B * cotangents
                  + Dc * M + M + M * F + 2 * F) * 4 + nbytes(mp))
    fwd, bwd = train_hop_flops(cfg)
    n_ops = B * H * (fwd - 2 * (M * A + M) + bwd)
    return bound(n_bytes, n_ops, peak)


def phase_kernel_label(line: str) -> str:
    """A short name for a phase kernel of the training forward or backward,
    or of the serving hop loop, from the mangled name in ptxas's "Compiling
    entry" line: the tile GEMM's body, tile (BM x BN x BK, ring depth) and
    operand layouts (k: k-contiguous, r: row-contiguous), or the other
    kernel and its type."""
    m = re.search(r"gemm_(fma|mma)INS_\d+(?:Fma|Mma)CfgILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E"
                  r".*?ELb([01])ELb([01])E", line)
    if m:
        body, bm, bn, bk, st, a, b = m.groups()
        operands = " bf16 operands" if body == "fma" and "nv_bfloat16" in line else ""
        return (f"gemm_{body} {bm}x{bn}x{bk} ring {st} A {'k' if a == '1' else 'r'} "
                f"B {'k' if b == '1' else 'r'}{operands}")
    k = re.search(r"(prep|rows_fwd|rows_eval|softmax_bwd|dpre_add|cell_bwd|cell|colsum|reduce)"
                  r"_kernel", line)
    kind = " bf16" if "nv_bfloat16" in line else (" float32" if "IfE" in line else "")
    return (k.group(1) if k else "kernel") + kind


def norm_rel(got, want) -> float:
    """|got - want| / |want|; where want is all zeros, 0 if got is too and
    inf if not."""
    diff, ref = (got.float() - want.float()).norm().item(), want.float().norm().item()
    if ref == 0.0:
        return 0.0 if diff == 0.0 else float("inf")
    return diff / ref


# The bf16 training kernels' bars at one hop, norm-relative against their
# bf16 plain versions on the same inputs (train_bf16_readings): 2-3x the
# largest reading of the sound kernels at B in {19, 100} (PERF.md, §6),
# each under half the float32 plain version's distance (4.7e-4 for
# do_pred, 1.7e-3 for the scores, 1.9e-3 to 4.5e-3 for the grads).  Both
# sides round the same operands to bf16 and differ in the order of their
# float32 sums, which now and then flips a rounding; each flip moves what
# follows it, so the readings grow with the depth.  Backward: by leaf, then
# the weights' grads and dq, then the biases'.
TRAIN_BF16_BARS = {
    "fwd": {"scores": 7.5e-4, "do_pred": 2e-4, "attprob": 2.5e-4, "c_all": 2.5e-4,
            "h_all": 2.5e-4},
    "bwd": {"i_embed/w": 2.5e-4, "weights": 9e-4, "biases": 2.5e-4},
}


def train_bf16_bar(kind: str, name: str) -> float:
    bars = TRAIN_BF16_BARS[kind]
    if name in bars:
        return bars[name]
    return bars["biases" if name.rsplit("/", 1)[-1] in ("b", "bi", "bh") else "weights"]


def train_bf16_deep_bar(r) -> float:
    """The bf16 training kernels' bar at eight hops for one output or grad
    leaf's readings ``r`` (train_bf16_readings with ``host``): twice the
    plain version's own drift on the host CPU, and under 3/4 of the float32
    plain version's distance, where a kernel that skips the rounding lands."""
    return min(2 * r["host"], 0.75 * r["float32"])


def train_bf16_readings(rth, cfg, mp, B, rs, dev, host=False):
    """The bf16 training kernels against their bf16 plain versions on one
    batch of B rows (``cfg``: fused, bf16): {"fwd": {output: r}, "bwd":
    {grad leaf: r}}, where r holds the norm-relative distance from the bf16
    plain version (on the card) of the kernel, of the float32 plain version
    on the same bf16-valued inputs and, with ``host``, of the bf16 plain
    version run on the host CPU (the same arithmetic summed in another
    order).  The backward's leaves are its feats-path grads and the outside
    products over its emissions, on the kernel forward's carries, with the
    cotangent of a per-hop cross-entropy; att_score b's grad, zero in exact
    arithmetic, is held to an absolute 1e-5 here instead."""
    from rau_vqa_tpu_torch.convert import map_tree
    bf16 = torch.bfloat16
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    H, A, Q = cfg.n_hops, cfg.answer_size, cfg.rnnout_dim
    mp16 = map_tree(lambda w: w.to(bf16), mp)
    mp32 = map_tree(lambda w: w.float(), mp16)
    feats = make_batch(cfg, B, cfg.seq_len, rs, dev)[2].to(bf16)
    q = torch.as_tensor(0.5 * rs.randn(B, Q).astype(np.float32), device=dev).to(bf16)
    seed = torch.tensor([rs.randint(0, 2 ** 31 - 1)], dtype=torch.int32, device=dev)
    labels = torch.as_tensor(rs.randint(0, A, B), device=dev)
    hop_w = torch.tensor([1.0 + 0.5 * h for h in range(H)], device=dev)
    cpu = torch.device("cpu")

    def on(device, *xs):
        return [map_tree(lambda t: t.to(device), x) if isinstance(x, dict) else x.to(device)
                for x in xs]

    fwd_runs = {"kernel": (rth.train_hops_fwd, cfg, dev, mp16, q, feats),
                "plain": (rth.train_hops_fwd_reference, cfg, dev, mp16, q, feats),
                "float32": (rth.train_hops_fwd_reference, cfg32, dev, mp32, q.float(),
                            feats.float())}
    if host:
        fwd_runs["host"] = (rth.train_hops_fwd_reference, cfg, cpu, mp16, q, feats)
    outs = {}
    for k, (fn, c, d, mp_, q_, feats_) in fwd_runs.items():
        mp_, q_, feats_, seed_ = on(d, mp_, q_, feats_, seed)
        outs[k] = on(dev, *fn(mp_, c, q_, feats_, seed_))
    names = ("scores", "do_pred", "attprob", "c_all", "h_all")
    fwd = {n: {k: norm_rel(v[i], outs["plain"][i]) for k, v in outs.items() if k != "plain"}
           for i, n in enumerate(names)}

    _, _, attprob, c_all, h_all = outs["kernel"]
    s_ = outs["kernel"][0].detach().requires_grad_()
    ce = torch.nn.functional.cross_entropy(
        s_.reshape(-1, A), labels.repeat(H), reduction="none").reshape(H, B).mean(1)
    g_scores, = torch.autograd.grad((hop_w * ce).sum(), s_)

    def hand_grads(bwd, c, d, mp_, q_, feats_):
        mp_, q_, feats_, seed_, c_, h_, p_, g_ = on(d, mp_, q_, feats_, seed, c_all, h_all,
                                                    attprob, g_scores)
        dd = rth.dot_dtype(c)
        gmerge = (rth._rnd(g_.reshape(H * B, -1), dd)
                  @ rth._rnd(mp_["cls"]["w"], dd).T).reshape(H, B, -1)
        em, gw_in = bwd(mp_, c, q_, feats_, seed_, c_, h_, gmerge.contiguous())
        gw_out, dq = rth._outside_grads(c, mp_, q_, seed_, h_, p_, g_, em)
        grads = {p: (gw_in[p] if p in gw_in else gw_out[p]) for p in rth._DIFF_WEIGHTS}
        return {**on(dev, grads)[0], "dq": dq.to(dev)}

    grads = {"kernel": hand_grads(rth.train_hops_bwd, cfg, dev, mp16, q, feats),
             "plain": hand_grads(rth.train_hops_bwd_reference, cfg, dev, mp16, q, feats),
             "float32": hand_grads(rth.train_hops_bwd_reference, cfg32, dev, mp32,
                                   q.float(), feats.float())}
    if host:
        grads["host"] = hand_grads(rth.train_hops_bwd_reference, cfg, cpu, mp16, q, feats)
    torch.cuda.synchronize()
    bwd = {}
    for path in grads["plain"]:
        name = path if isinstance(path, str) else "/".join(map(str, path))
        if path == ("att_score", "b"):
            noise = max(v[path].abs().max().item() for v in grads.values())
            if noise > 1e-5:
                raise SystemExit(f"train_hops_bwd_bf16: att_score b grad {noise:.3e} > 1e-5")
            continue
        bwd[name] = {k: norm_rel(v[path], grads["plain"][path])
                     for k, v in grads.items() if k != "plain"}
    return {"fwd": fwd, "bwd": bwd}


def stage_bound(B, H, W, C, Cw, N):
    """Least time for one identity-stage call: x read once, the output
    written once, the stacked bf16 weights read once; the three products of
    each block in bf16 tensor-core terms."""
    n_bytes = 2 * B * H * W * C * 2 + N * (2 * C * Cw + 9 * Cw * Cw + 2 * Cw + C) * 2
    n_ops = 2 * B * N * H * W * (2 * C * Cw + 9 * Cw * Cw)
    return bound(n_bytes, n_ops, H100_BF16_FLOPS)


def old_stage_weight_bytes(B, H, W, C, Cw, N):
    """L2 weight bytes a call of the mma.sync stage kernel read: each CTA of
    its 8x8 tiling (4x14 where that divides W and 8x8 does not) read every
    weight of a block."""
    th, tw = (4, 14) if W % 8 and W % 14 == 0 else (8, 8)
    return -(-H // th) * -(-W // tw) * B * N * 2 * (2 * C * Cw + 9 * Cw * Cw)


def mask_bound(shape):
    """Least time for one mask: the float32 mask written once; ~16 integer
    operations an element (the index, the multiply-xor and fmix32, the
    compare and select)."""
    n = int(np.prod(shape))
    t_bytes = n * 4 / H100_BYTES_PER_S * 1e3
    t_ops = 16 * n / H100_INT32_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def stage_stack(N, C, Cw, dtype, gen, dev, bias_mean=0.0):
    """A random stacked identity run: He-normal weights, biases of std 0.1
    around ``bias_mean``."""
    def r(*shape, std, mean=0.0):
        return (torch.randn(*shape, generator=gen, device=dev) * std + mean).to(dtype)
    return {"w1": r(N, C, Cw, std=(2 / C) ** .5), "b1": r(N, 1, Cw, std=.1, mean=bias_mean),
            "w2": r(N, 9, Cw, Cw, std=(2 / (9 * Cw)) ** .5),
            "b2": r(N, 1, Cw, std=.1, mean=bias_mean),
            "w3": r(N, Cw, C, std=(2 / Cw) ** .5), "b3": r(N, 1, C, std=.1, mean=bias_mean)}


def stage_faults(plain, x, stack):
    """The plain stage with the classic faults of a stage kernel: the 3x3's
    border taken as relu(b1) instead of 0 (each block run over x padded with
    a zero pixel, whose y1 is relu(b1), then cropped), b2 dropped, b3
    dropped."""
    halo = x
    for n in range(stack["w1"].shape[0]):
        one = {k: v[n:n + 1] for k, v in stack.items()}
        halo = plain(torch.nn.functional.pad(halo, (0, 0, 1, 1, 1, 1)), one)[:, 1:-1, 1:-1]
    return {"relu(b1) halo": halo,
            "b2 dropped": plain(x, {**stack, "b2": torch.zeros_like(stack["b2"])}),
            "b3 dropped": plain(x, {**stack, "b3": torch.zeros_like(stack["b3"])})}


def scaled_err(got, want) -> float:
    """max |got - want| over max |want|: the stage's activations grow across
    its residual blocks at random init, so errors are held to their scale."""
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def stage_bar(N: int) -> float:
    """The bf16 stage kernel's bar on ``scaled_err``: ~3x the largest reading
    of the sound kernel against its plain version (PERF.md, PR 3: 4.1-5.4e-3
    over runs of 2-3 blocks, 1.6e-2 over stage 2's 22, where bf16 rounding
    flips compound).  The JAX package's 0.1 (tests/test_fused_resnet.py:70-72)
    is ~20x the readings and passes a wrong kernel."""
    return 5e-2 if N > 3 else 2e-2


def torch_lstm_from(cfg, rnn, dev):
    """torch.nn.LSTM holding the encoder's weights, gates permuted from the
    DeepLSTM's [i, f, o | g] to PyTorch's [i, f, g, o]; a yardstick only."""
    R = cfg.rnn_size
    lstm = torch.nn.LSTM(cfg.embed_dim, R, cfg.rnn_layers, batch_first=True).to(dev)

    def perm(x):   # last axis [i, f, o, g] -> [i, f, g, o]
        return torch.cat([x[..., :2 * R], x[..., 3 * R:], x[..., 2 * R:3 * R]], -1)

    with torch.no_grad():
        for L, lp in enumerate(rnn["layers"]):
            getattr(lstm, f"weight_ih_l{L}").copy_(perm(lp["wi"]).T)
            getattr(lstm, f"weight_hh_l{L}").copy_(perm(lp["wh"]).T)
            getattr(lstm, f"bias_ih_l{L}").copy_(perm(lp["bi"]))
            getattr(lstm, f"bias_hh_l{L}").copy_(perm(lp["bh"]))
    return lstm


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2

    from rau_vqa_tpu_torch.config import get_preset, get_train_preset
    from rau_vqa_tpu_torch.convert import map_tree
    from rau_vqa_tpu_torch.eval.predict import (
        _aggregate, compute_answers, make_predict_step, pick_bucket, predict, predict_fused)
    from rau_vqa_tpu_torch.models import pipeline
    from rau_vqa_tpu_torch.models.backbones import resnet
    from rau_vqa_tpu_torch.models.rau import (
        embed_image, embed_question, encode_question, init_params)
    from rau_vqa_tpu_torch.ops import _build, fused_resnet, lstm_encoder, maskgen, rau_hops
    from rau_vqa_tpu_torch.ops.transforms import color_normalize
    from rau_vqa_tpu_torch.ops import rau_train_hops as rth
    from rau_vqa_tpu_torch.ops.treeflat import pluck
    from rau_vqa_tpu_torch.train.losses import hop_grad_scale
    from rau_vqa_tpu_torch.train.optim import (
        adam_update, add_gradient_noise, clip_by_global_norm)
    from rau_vqa_tpu_torch.train.trainer import (
        PARAM_GROUPS, init_train_state, make_train_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    bf16 = torch.bfloat16

    # 1. device
    cap = torch.cuda.get_device_capability()
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs a Hopper card (9, 0), found {cap}")
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    reports = _build.build_all(["lstm_encoder", "rau_hops", "maskgen",
                                "rau_train_hops_fwd", "rau_train_hops_bwd",
                                "fused_resnet"], force=True)
    log(f"build_s={time.perf_counter() - t0:.3f} [{card}]")
    stage_regs = {}   # (TH, TW, NB, ring) -> registers a thread
    for name, rep in reports.items():
        what, inst = "", None
        for line in rep.splitlines():
            if name == "lstm_encoder" and "Compiling entry" in line:
                # the encoder's one instantiation per units a CTA
                what = " U=" + line.split("lstm_encode_kernelILi")[1].split("E")[0]
            if name == "fused_resnet" and "Compiling entry" in line:
                # the stage kernel's instantiations: Cfg<TH, TW, NB, S>
                m = re.search(r"CfgILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E", line)
                inst = tuple(int(v) for v in m.groups()) if m else None
                what = (f" tile {inst[0]}x{inst[1]} nb {inst[2]} ring {inst[3]}" if m
                        else " float32")
            if name.startswith(("rau_train_hops", "rau_hops")) and "Compiling entry" in line:
                what = " " + phase_kernel_label(line)
            if name == "fused_resnet" and inst and "registers" in line:
                stage_regs[inst] = int(re.search(r"Used (\d+) registers", line).group(1))
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"ptxas {name}{what}: {line.strip()}")

    cfg = get_preset("ours_ms")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for B in (1, 4, 16, 19, 83, 512):
        plan = lstm_encoder.lstm_plan(B, cfg.embed_dim, cfg.rnn_size, cfg.rnn_layers, n_sm)
        log(f"lstm_encode plan B={B}: grid {plan.ctas} CTAs on {n_sm} SMs, {plan.units} units "
            f"a CTA, {plan.row_groups} row group(s) of {plan.rows} rows, {plan.splits} K "
            f"split(s), {plan.passes} pass(es), {plan.smem} bytes of shared memory a CTA")
    # the training kernels' plans against the launches their built C entries
    # make (a dry run of each): the same grids, shared memory within the plan's
    bwd_widths = (cfg.cnn_spat, cfg.cnn_dim, cfg.multfeat_dim, cfg.attfeat_dim,
                  cfg.att_state_dim, cfg.rnnout_dim)
    fwd_widths = bwd_widths + (cfg.answer_size,)
    for dt in (torch.float32, bf16):
        for B in (1, 19, 37, 100):
            plan = rth.fwd_plan(B, *fwd_widths, n_sm, dt)
            scratch, launches = rth.fwd_launcher_plan(B, *fwd_widths, dt)
            grids = [ph.grid for ph in plan.phases]
            if scratch <= 0 or [x[:3] for x in launches] != grids or any(
                    x[3] > ph.smem for x, ph in zip(launches, plan.phases)):
                raise SystemExit(f"fwd_plan B={B} {dt}: the launcher runs {launches} with "
                                 f"{scratch} scratch floats, the plan {grids}")
        log(f"train_hops_fwd plan B=100 {dt}: {len(plan.phases)} kernels a hop "
            f"({sum(1 for p in plan.phases if p.tile)} tile GEMMs), scratch "
            f"{scratch * 4 / 1e6:.1f} MB beside the {plan.work_floats * 4 / 1e6:.1f} MB "
            f"workspace; the launcher's dry run makes the plan's grids at B in 1, 19, 37, "
            f"100, with shared memory up to {max(x[3] for x in launches)} B")
        for B in (1, 19, 37, 100):
            plan = rth.bwd_plan(B, *bwd_widths, n_sm, dt)
            scratch, launches = rth.launcher_plan(B, *bwd_widths, dt, plan.chunk_rows)
            grids = [ph.grid for ph in plan.phases]
            if scratch <= 0 or [x[:3] for x in launches] != grids or any(
                    x[3] > ph.smem for x, ph in zip(launches, plan.phases)):
                raise SystemExit(f"bwd_plan B={B} {dt}: the launcher runs {launches} with "
                                 f"{scratch} scratch floats, the plan {grids}")
        gemms = [p for p in plan.phases if p.tile]
        log(f"train_hops_bwd plan B=100 {dt}: {len(plan.phases)} kernels a hop "
            f"({len(gemms)} tile GEMMs), {plan.chunks} K chunks of {plan.chunk_rows} rows, "
            f"scratch {scratch * 4 / 1e6:.1f} MB; the launcher's dry run makes the plan's "
            f"grids at B in 1, 19, 37, 100, with shared memory up to "
            f"{max(x[3] for x in launches)} B")
    # the hop kernel's plan against its built C entry's dry run of a one-hop call
    hops_widths = (cfg.rnnout_dim, cfg.cnn_spat, cfg.multfeat_dim, cfg.attfeat_dim,
                   cfg.att_rnn_size, cfg.answer_size)
    for B in (1, 4, 16, 19, 37, 83, 512):
        plan = rau_hops.hops_plan(B, cfg)
        scratch, launches = rau_hops.hops_launcher_plan(B, *hops_widths)
        grids = [ph.grid for ph in plan.phases]
        if scratch <= 0 or [x[:3] for x in launches] != grids or any(
                x[3] > ph.smem for x, ph in zip(launches, plan.phases)):
            raise SystemExit(f"hops_plan B={B}: the launcher runs {launches} with "
                             f"{scratch} scratch floats, the plan {grids}")
        log(f"rau_hops plan B={B}: {plan.kernels(cfg.n_hops)} kernels a call ({len(plan.setup)} "
            f"+ {len(plan.hop)} a hop, {sum(1 for p in plan.phases if p.tile)} tile GEMMs in "
            f"a one-hop call), scratch {scratch * 4 / 1e6:.2f} MB, shared memory up to "
            f"{max(x[3] for x in launches)} B; the launcher's dry run makes the plan's grids")
    params = init_params(cfg, torch.Generator().manual_seed(args.seed), dev)
    enc = lstm_encoder.pack_encoder_weights(params["rnn"])
    hw = rau_hops.pack_hop_weights(params["mult"])
    rs = np.random.RandomState(args.seed)

    # 3. kernels against their plain versions
    err = {"lstm_encode": 0.0, "rau_hops": 0.0}
    for B in (1, 19, 83, 512):
        tokens, lengths, feats = make_batch(cfg, B, cfg.seq_len, rs, dev)
        if B > 1:   # lengths outside [1, T] give zero rows
            lengths[1], lengths[2] = 0, cfg.seq_len + 1
        emb = embed_question(params, tokens).contiguous()
        got = lstm_encoder.lstm_encode(enc, cfg, emb, lengths)
        again = lstm_encoder.lstm_encode(enc, cfg, emb, lengths)
        want = lstm_encoder.lstm_encode_reference(enc, cfg, emb, lengths, dot_dtype=bf16)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=0.05, atol=5e-3)
        if not torch.equal(got, again):
            raise SystemExit(f"lstm_encode B={B}: two calls on the same inputs differ")
        if B > 1 and not bool((got[1:3] == 0).all()):
            raise SystemExit(f"lstm_encode B={B}: rows of length 0 and T + 1 are not zero")
        e = (got - want).abs().max().item()
        err["lstm_encode"] = max(err["lstm_encode"], e)
        log(f"lstm_encode B={B} max_abs_err={e:.3e} (bar rtol 0.05 atol 5e-3), "
            f"two calls bit-equal{', lengths 0 and T+1 zero' if B > 1 else ''}")

        q = want
        ifeat, iatt = embed_image(params["mult"], feats)
        ifeat = ifeat.to(bf16).contiguous()
        iatt = iatt.to(bf16).contiguous()
        s, d, a = rau_hops.rau_hops(hw, cfg, q, ifeat, iatt)
        again = rau_hops.rau_hops(hw, cfg, q, ifeat, iatt)
        s_r, d_r, a_r = rau_hops.rau_hops_reference(hw, cfg, q, ifeat, iatt,
                                                    dot_dtype=bf16)
        torch.cuda.synchronize()
        es = [(x - y).abs().max().item() for x, y in ((s, s_r), (d, d_r), (a, a_r))]
        # the scores' reading as a share of its bar (atol 0.01 + rtol 0.05 |want|)
        share = ((s - s_r).abs() / (0.01 + 0.05 * s_r.abs())).max().item()
        agree = (s.argmax(-1) == s_r.argmax(-1)).float().mean().item()
        log(f"rau_hops B={B} max_abs_err scores={es[0]:.3e} ({share:.3f} of the bar atol 0.01 "
            f"rtol 0.05) argmax_agree={agree:.4f} (bar > 0.97) do_pred={es[1]:.3e} (atol "
            f"5e-3) attprob={es[2]:.3e} (atol 5e-4)")
        torch.testing.assert_close(s, s_r, rtol=0.05, atol=0.01)
        if agree <= 0.97:
            raise SystemExit(f"rau_hops argmax agreement {agree} <= 0.97")
        torch.testing.assert_close(a, a_r, rtol=0.05, atol=5e-4)
        torch.testing.assert_close(d, d_r, rtol=0.05, atol=5e-3)
        if not all(torch.equal(x, y) for x, y in zip((s, d, a), again)):
            raise SystemExit(f"rau_hops B={B}: two calls on the same inputs differ")
        err["rau_hops"] = max(err["rau_hops"], *es)

    # the training kernels, float32, at mult_dropout 0.5 (the preset's)
    tcfg_m = dataclasses.replace(cfg, fused_train=True)
    mp = params["mult"]
    Q, S, Dc, M = cfg.rnnout_dim, cfg.cnn_spat, cfg.cnn_dim, cfg.multfeat_dim
    H, A = cfg.n_hops, cfg.answer_size
    maskgen.KERNEL.launches = 0
    for seed in (0, 12345, 2 ** 31 - 2):
        seed_t = torch.tensor([seed], dtype=torch.int32, device=dev)
        for hop in (0, 7):
            for site, rest in ((0, (S, Dc)), (1, (Q,)), (2, (M,))):
                shape = (19,) + rest
                got = maskgen.dropout_mask(seed_t, hop, site, shape, 81, 0.5)
                want = maskgen.dropout_scale_mask(
                    shape, 81, maskgen.site_salt(seed_t, hop, site), 0.5)
                if not torch.equal(got, want):
                    raise SystemExit(f"maskgen: device hash differs from the plain "
                                     f"version at seed {seed} hop {hop} site {site}")
    mask_launches = maskgen.KERNEL.launches
    log(f"maskgen: device hash equals the plain version bit for bit "
        f"(seeds 0, 12345, 2^31-2; hops 0, 7; 3 sites; row_offset 81; "
        f"{mask_launches} launches)")
    err["train_hops_fwd"] = err["train_hops_bwd"] = 0.0
    hop_w = torch.tensor([1.0 + 0.5 * h for h in range(H)], device=dev)
    for B in (19, 100):
        feats = make_batch(cfg, B, cfg.seq_len, rs, dev)[2]
        q = torch.as_tensor(0.5 * rs.randn(B, Q).astype(np.float32), device=dev)
        seed_t = torch.tensor([rs.randint(0, 2 ** 31 - 1)], dtype=torch.int32, device=dev)
        got = rth.train_hops_fwd(mp, tcfg_m, q, feats, seed_t)
        want = rth.train_hops_fwd_reference(mp, tcfg_m, q, feats, seed_t)
        torch.cuda.synchronize()
        es = []
        for name, g, w in zip(("scores", "do_pred", "attprob", "c_all", "h_all"), got, want):
            # 8 recurrent hops of float32 sums in another order than cuBLAS's
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4, msg=name)
            es.append((g - w).abs().max().item())
        err["train_hops_fwd"] = max(err["train_hops_fwd"], *es)
        if not fwd_bit_equal(rth, got, mp, tcfg_m, q, feats, seed_t):
            raise SystemExit(f"train_hops_fwd B={B}: two calls on the same inputs differ")
        log(f"train_hops_fwd B={B} max_abs_err {max(es):.3e} (bar rtol 1e-4 atol 1e-4), "
            f"two calls bit-equal")
        gmerge = 1e-3 * torch.randn(H, B, M, device=dev,
                                    generator=torch.Generator(dev).manual_seed(B))
        if not bwd_bit_equal(rth, mp, tcfg_m, q, feats, seed_t, got[3], got[4], gmerge):
            raise SystemExit(f"train_hops_bwd B={B}: two calls on the same inputs differ")
        log(f"train_hops_bwd B={B}: two calls bit-equal (9 emissions, 5 grads)")

        labels = torch.as_tensor(rs.randint(0, A, B), device=dev)

        def grads(bwd):
            c = dataclasses.replace(tcfg_m, fused_train_bwd=bwd)
            mp_ = map_tree(lambda w: w.detach().clone().requires_grad_(), mp)
            q_ = q.clone().requires_grad_()
            s = rth.rau_train_hops(mp_, c, q_, feats, seed_t)[0]
            ce = torch.nn.functional.cross_entropy(
                s.reshape(-1, A), labels.repeat(H), reduction="none").reshape(H, B).mean(1)
            (hop_w * ce).sum().backward()
            return mp_, q_.grad

        g_k, dq_k = grads("kernel")
        g_x, dq_x = grads("xla")
        torch.cuda.synchronize()
        rel = {"dq": ((dq_k - dq_x).norm() / dq_x.norm()).item()}
        for path in rth._DIFF_WEIGHTS:
            g, w = pluck(g_k, path).grad, pluck(g_x, path).grad
            if path == ("att_score", "b"):
                # zero in exact arithmetic (the softmax is shift-invariant):
                # both values are rounding noise, held to an absolute bar
                noise = max(g.abs().max().item(), w.abs().max().item())
                if noise > 1e-5:
                    raise SystemExit(f"train_hops_bwd: att_score b grad {noise:.3e} > 1e-5")
                continue
            rel["/".join(map(str, path))] = ((g - w).norm() / w.norm()).item()
        worst = max(rel, key=rel.get)
        if rel[worst] > 1e-3:
            raise SystemExit(f"train_hops_bwd B={B}: {worst} norm-relative error "
                             f"{rel[worst]:.3e} > 1e-3")
        if (g_k["do_pred"]["w"].grad.abs().max().item() != 0.0
                or g_k["do_pred"]["b"].grad.abs().max().item() != 0.0):
            raise SystemExit("train_hops_bwd: do_pred grads are not exactly 0")
        err["train_hops_bwd"] = max(err["train_hops_bwd"], rel[worst])
        log(f"train_hops_bwd B={B} worst norm-relative grad error {rel[worst]:.3e} "
            f"({worst}; bar 1e-3 per leaf), do_pred grads exactly 0")

    # the training kernels' bf16 instantiations (compute_dtype "bfloat16",
    # the --bf16 path) against their bf16 plain versions at mult_dropout 0.5
    # on bf16-cast weights (train_bf16_readings).  One hop at B in {19, 100}:
    # each output and grad leaf within TRAIN_BF16_BARS, each bar under half
    # the distance from the float32 plain version.  Eight hops at B in {19,
    # 100} (the main path's depth, and its batch), where two right
    # implementations that sum in another order drift apart to near half of
    # bf16's own effect: each within twice the plain version's own drift,
    # the same plain version run on the host CPU, and under 3/4 of the
    # float32 plain version's distance, where a kernel that leaves its
    # products unrounded lands (the forward's readings: 0.33-0.48 of it).
    err["train_hops_fwd_bf16"] = err["train_hops_bwd_bf16"] = 0.0
    failed = []
    for H_b, B in ((1, 19), (1, 100), (8, 19), (8, 100)):
        cfg_b = dataclasses.replace(tcfg_m, compute_dtype="bfloat16", n_hops=H_b)
        floor = H_b > 1
        readings = train_bf16_readings(rth, cfg_b, mp, B, rs, dev, host=floor)
        for kind, per in readings.items():
            # a leaf that no bf16 product reaches (cls b) must come out the
            # same; the others within the bar
            bars = {k: (train_bf16_deep_bar(r) if floor else
                        train_bf16_bar(kind, k) if r["float32"] > 0 else 0.0)
                    for k, r in per.items()}
            log(f"train_hops_{kind}_bf16 H={H_b} B={B}, norm-relative from the bf16 plain "
                f"version: kernel / float32 plain" + (" / bf16 plain on the host" if floor
                                                      else "") + " (bar): " + ", ".join(
                f"{k} {r['kernel']:.3e} / {r['float32']:.3e}"
                + (f" / {r['host']:.3e}" if floor else "") + f" ({bars[k]:.3e})"
                for k, r in per.items()))
            for k, r in per.items():
                if not r["kernel"] <= bars[k]:
                    failed.append(f"train_hops_{kind}_bf16 H={H_b} B={B}: {k} {r['kernel']:.3e} "
                                  f"> {bars[k]:.3e}")
                if not floor and r["float32"] > 0 and not bars[k] < 0.5 * r["float32"]:
                    failed.append(f"train_hops_{kind}_bf16 H={H_b} B={B}: {k}'s bar {bars[k]} "
                                  f"is not under half the float32 distance {r['float32']:.3e}")
            if not floor:
                err[f"train_hops_{kind}_bf16"] = max(err[f"train_hops_{kind}_bf16"],
                                                     *(r["kernel"] for r in per.values()))
    if failed:
        raise SystemExit("kernels: " + "; ".join(failed))
    cfg_b = dataclasses.replace(tcfg_m, compute_dtype="bfloat16")
    # the bf16 backward twice on the same inputs at B=100, eight hops
    mp16 = map_tree(lambda w: w.to(bf16), mp)
    feats_b = make_batch(cfg, 100, cfg.seq_len, rs, dev)[2].to(bf16)
    q_b = torch.as_tensor(0.5 * rs.randn(100, Q).astype(np.float32), device=dev).to(bf16)
    seed_t = torch.tensor([rs.randint(0, 2 ** 31 - 1)], dtype=torch.int32, device=dev)
    out16 = rth.train_hops_fwd(mp16, cfg_b, q_b, feats_b, seed_t)
    if not fwd_bit_equal(rth, out16, mp16, cfg_b, q_b, feats_b, seed_t):
        raise SystemExit("train_hops_fwd_bf16 B=100: two calls on the same inputs differ")
    log("train_hops_fwd_bf16 B=100 H=8: two calls bit-equal (5 outputs)")
    _, _, _, c16, h16 = out16
    gmerge = 1e-3 * torch.randn(H, 100, M, device=dev,
                                generator=torch.Generator(dev).manual_seed(7))
    if not bwd_bit_equal(rth, mp16, cfg_b, q_b, feats_b, seed_t, c16, h16, gmerge):
        raise SystemExit("train_hops_bwd_bf16 B=100: two calls on the same inputs differ")
    log("train_hops_bwd_bf16 B=100 H=8: two calls bit-equal (9 emissions, 5 grads)")
    # through the autograd Function: grads in the weights' type, do_pred's 0
    mp_r = map_tree(lambda w: w.detach().to(bf16).requires_grad_(), mp)
    feats_b = make_batch(cfg, 19, cfg.seq_len, rs, dev)[2].to(bf16)
    q_b = torch.as_tensor(0.5 * rs.randn(19, Q).astype(np.float32), device=dev).to(bf16)
    s_r = rth.rau_train_hops(mp_r, cfg_b, q_b, feats_b, 7)[0]
    torch.nn.functional.cross_entropy(s_r.reshape(-1, A), torch.zeros(
        H * 19, dtype=torch.long, device=dev)).backward()
    if (mp_r["do_pred"]["w"].grad.abs().max().item() != 0.0
            or mp_r["do_pred"]["b"].grad.abs().max().item() != 0.0):
        raise SystemExit("train_hops_bwd_bf16: do_pred grads are not exactly 0")
    if mp_r["i_embed"]["w"].grad.dtype != bf16:
        raise SystemExit("train_hops_bwd_bf16: the grads are not in the weights' type")
    log("train_hops_bwd_bf16: do_pred grads exactly 0, grads in bf16")

    # the identity-stage kernel at the 448-px stage shapes (H, C, Cw, N), and
    # at B=3 on tiles cut by the image's edge, against its plain version on
    # scale-normalised errors (tests/test_fused_resnet.py:100-102): bf16 at
    # stage_bar, float32 at 2e-5 (:54-55).  On edge-cut tiles with biases
    # around +1, the classic faults (stage_faults) must land beyond twice the
    # bar, so that the bar can see them; they are logged around 0 as well,
    # where biases of std 0.1 move the output far less.
    stages = [(448 // 4 >> s, 4 * w, w, n - 1) for s, (n, w) in
              enumerate(zip(resnet.RESNET101_BLOCKS, resnet.STAGE_WIDTH))]
    gen_s = torch.Generator(dev).manual_seed(args.seed)
    plain_stage = fused_resnet.fused_identity_stage_reference
    failed = []
    checks = ([(2, Hs, Hs, C, Cw, N, bf16, stage_bar(N), 0.0) for Hs, C, Cw, N in stages]
              + [(2, 14, 14, 2048, 512, 2, torch.float32, 2e-5, 0.0)]
              # each tile cut at the image's edge (4x28 with 128- and 64-column
              # chunks, 4x14), biases around 0 and +1
              + [(3, 13, Ws, C, Cw, 2, bf16, stage_bar(2), mean) for mean in (0.0, 1.0)
                 for Ws, C, Cw in ((21, 512, 128), (28, 256, 64), (14, 512, 512))])
    with watchdog(300, "the stage kernel's checks"):
        for B, Hs, Ws, C, Cw, N, dt, bar, mean in checks:
            stack = stage_stack(N, C, Cw, dt, gen_s, dev, bias_mean=mean)
            x = torch.randn(B, Hs, Ws, C, generator=gen_s, device=dev).abs().to(dt)
            what = f"fused_identity_stage B={B} H={Hs} W={Ws} C={C} Cw={Cw} N={N} {dt}"
            if dt == bf16:
                p = fused_resnet.stage_plan(B, Hs, Ws, C, Cw, n_sm)
                what += f" (tile {p.th}x{p.tw} ring {p.ring})"
                # the plan's shared memory is what the launcher will ask for
                smem = fused_resnet.launcher_smem(p.th, p.tw, p.nb, p.ring, C, Cw)
                if smem != p.smem:
                    failed.append(f"{what}: stage_plan reckons {p.smem} B of shared memory, "
                                  f"the launcher {smem}")
            if mean:
                what += f" biases around {mean}"
            try:
                got = fused_resnet.fused_identity_stage(x, stack, block_b=1)
                want = plain_stage(x, stack)
                torch.cuda.synchronize()
            except RuntimeError as err:
                # a fault or a trap of the kernel's mbarrier watchdog (a wait
                # that never completes) leaves the context unusable
                raise SystemExit(f"kernels: {what}: the stage kernel failed: {err}")
            e = scaled_err(got, want)
            if not e <= bar:
                failed.append(f"{what}: scale-normalised error {e:.3e} > {bar}")
            log(f"{what}: max_abs_err/max|want| {e:.3e} (bar {bar}), max_abs_err "
                f"{(got.float() - want.float()).abs().max().item():.3e}, "
                f"max|want| {want.float().abs().max().item():.3e}")
            if B == 3:   # the edge-cut cases
                for fault, wrong in stage_faults(plain_stage, x, stack).items():
                    fe = scaled_err(wrong, want)
                    log(f"  the plain stage with a {fault}: {fe:.3e} from the right one")
                    if mean and not fe > 2 * bar:
                        failed.append(f"{what}: a {fault} lands {fe:.3e} from the plain "
                                      f"stage, within twice the bar {bar}")
    if failed:
        raise SystemExit("kernels: " + "; ".join(failed))
    log("phase kernels: ok")

    # 4. serving through the user's entry point
    step = make_predict_step(cfg, buckets=(8, 16))
    serve_batches = [(1, 8), (4, 16), (16, 26), (83, 12), (512, 26)]
    data = [make_batch(cfg, B, max_len, rs, dev) for B, max_len in serve_batches]
    lstm_encoder.KERNEL.launches = 0
    rau_hops.KERNEL.launches = 0
    outs = [step(params, *batch) for batch in data]
    torch.cuda.synchronize()
    launches = {"lstm_encode": lstm_encoder.KERNEL.launches,
                "rau_hops": rau_hops.KERNEL.launches}
    log(f"serving launches: {launches}")
    if min(launches.values()) < 1:
        raise SystemExit(f"a kernel of the serving path never launched: {launches}")
    hit = sorted({pick_bucket(step.ladder, int(b[1].max())) for b in data})
    if hit != [8, 16, 26]:
        raise SystemExit(f"buckets hit {hit}, expected [8, 16, 26]")
    H, A, S = cfg.n_hops, cfg.answer_size, cfg.cnn_spat
    for (B, _), (tokens, lengths, feats), (tab_pred, tab_att) in zip(serve_batches, data, outs):
        if tab_pred.shape != (H + 2, B, A) or tab_att.shape != (H + 2, B, S):
            raise SystemExit(f"B={B}: shapes {tuple(tab_pred.shape)} {tuple(tab_att.shape)}")
        if not (torch.isfinite(tab_pred).all() and torch.isfinite(tab_att).all()):
            raise SystemExit(f"B={B}: non-finite outputs")
        with torch.no_grad():
            ref_pred, _ = predict(params, cfg, tokens, lengths, feats)
        torch.testing.assert_close(tab_pred, ref_pred, rtol=0.05, atol=0.02)
        oe, _ = compute_answers(tab_pred)
        oe_ref, _ = compute_answers(ref_pred)
        agree = (oe == oe_ref).float().mean().item()
        if agree <= 0.95:
            raise SystemExit(f"B={B}: answer agreement {agree} <= 0.95")
        log(f"serving B={B}: ok, answer agreement with f32 path {agree:.4f}, "
            f"max_abs_err {(tab_pred - ref_pred).abs().max().item():.3e}")
    log("phase serving: ok")

    # 5. training through the user's entry point
    mcfg_t, tcfg_t = get_train_preset("ours_ms")
    mcfg_t = dataclasses.replace(mcfg_t, fused_train=True)
    B = tcfg_t.batch_size
    train_step = make_train_step(mcfg_t, tcfg_t)
    state0 = init_train_state(mcfg_t, args.seed)
    tokens, lengths, feats = make_batch(mcfg_t, B, mcfg_t.seq_len, rs, dev)
    # VQA's answers are skewed: labels from ten answers, Zipf-weighted
    zipf = 1.0 / np.arange(1, 11)
    labels = torch.as_tensor(rs.choice(10, B, p=zipf / zipf.sum()), device=dev)
    hop_scale = hop_grad_scale(H, scale_by_nhop=tcfg_t.hop_grad_scale_nhop,
                               stop_timing=tcfg_t.hop_stop_timing, epoch=1)
    lr, mult_lr = tcfg_t.learning_rate, tcfg_t.mult_learning_rate
    for k in (lstm_encoder.KERNEL, rau_hops.KERNEL, maskgen.KERNEL,
              rth.FWD_KERNEL, rth.BWD_KERNEL):
        k.launches = 0
    state, history = state0, []
    for _ in range(10):
        state, metrics = train_step(state, tokens, lengths, feats, labels, hop_scale,
                                    lr, mult_lr)
        history.append(metrics)
    torch.cuda.synchronize()
    train_launches = {"train_hops_fwd": rth.FWD_KERNEL.launches,
                      "train_hops_bwd": rth.BWD_KERNEL.launches}
    log(f"training launches in 10 steps: {train_launches}")
    if set(train_launches.values()) != {10}:
        raise SystemExit(f"training kernels did not launch once per step: {train_launches}")
    for i, m in enumerate(history):
        bad = [k for k, v in m.items() if not torch.isfinite(v).all()]
        if bad:
            raise SystemExit(f"train step {i}: non-finite {bad}")
    losses = [m["loss"].item() for m in history]
    log("train losses: " + " ".join(f"{x:.4f}" for x in losses))
    log("train grad norms (embed rnn mult), first and last step: " + " | ".join(
        " ".join(f"{m[f'grad_norm_{g}'].item():.4f}" for g in PARAM_GROUPS)
        for m in (history[0], history[-1])))
    if not losses[-1] < losses[0]:
        raise SystemExit(f"joint loss did not fall over 10 steps: {losses}")
    # the backward kernel against autograd through the plain version, one
    # step each from one state and seed; noise off, so the norms are the
    # gradient's and not the noise's
    quiet = dataclasses.replace(tcfg_t, noisy_eta=0.0)
    norms = {}
    for bwd in ("kernel", "xla"):
        step_b = make_train_step(dataclasses.replace(mcfg_t, fused_train_bwd=bwd), quiet)
        _, m = step_b(state0, tokens, lengths, feats, labels, hop_scale, lr, mult_lr)
        norms[bwd] = {g: m[f"grad_norm_{g}"].item() for g in PARAM_GROUPS}
    log(f"grad norms, backward kernel {norms['kernel']} vs autograd {norms['xla']}")
    for g in PARAM_GROUPS:
        if abs(norms["kernel"][g] - norms["xla"][g]) > 1e-3 * abs(norms["xla"][g]):
            raise SystemExit(f"grad_norm_{g}: kernel {norms['kernel'][g]} vs "
                             f"autograd {norms['xla'][g]} beyond rtol 1e-3")
    # (a) the ours_ms preset as shipped: the unfused path, float32; no
    # training kernel runs
    mcfg_u, tcfg_u = get_train_preset("ours_ms")
    step_u = make_train_step(mcfg_u, tcfg_u)
    train_kernels = (rth.FWD_KERNEL, rth.BWD_KERNEL, rth.FWD_BF16_KERNEL, rth.BWD_BF16_KERNEL)
    for k in train_kernels:
        k.launches = 0
    state, hist_u = state0, []
    for _ in range(10):
        state, metrics = step_u(state, tokens, lengths, feats, labels, hop_scale, lr, mult_lr)
        hist_u.append(metrics)
    torch.cuda.synchronize()
    if any(k.launches for k in train_kernels):
        raise SystemExit("the unfused step launched a fused training kernel")
    for i, m in enumerate(hist_u):
        bad = [k for k, v in m.items() if not torch.isfinite(v).all()]
        if bad:
            raise SystemExit(f"unfused train step {i}: non-finite {bad}")
    losses_u = [m["loss"].item() for m in hist_u]
    log("unfused (ours_ms as shipped) train losses: " + " ".join(f"{x:.4f}" for x in losses_u))
    if not losses_u[-1] < losses_u[0]:
        raise SystemExit(f"unfused: joint loss did not fall over 10 steps: {losses_u}")
    # remat_hops recomputes each hop under the masks it drew: the same grads
    norms_u = {}
    for remat in (False, True):
        step_r = make_train_step(dataclasses.replace(mcfg_u, remat_hops=remat), quiet)
        _, m = step_r(state0, tokens, lengths, feats, labels, hop_scale, lr, mult_lr)
        norms_u[remat] = {g: m[f"grad_norm_{g}"].item() for g in PARAM_GROUPS}
    log(f"unfused grad norms, remat_hops off {norms_u[False]} vs on {norms_u[True]}")
    for g in PARAM_GROUPS:
        if abs(norms_u[True][g] - norms_u[False][g]) > 1e-4 * abs(norms_u[False][g]):
            raise SystemExit(f"grad_norm_{g}: remat_hops {norms_u[True][g]} vs "
                             f"{norms_u[False][g]} beyond rtol 1e-4")
    # (b) fused, compute_dtype bfloat16 (the --bf16 --fused-train path):
    # the bf16 kernels once a step, the float32 ones never
    mcfg_b = dataclasses.replace(mcfg_t, compute_dtype="bfloat16")
    step_b16 = make_train_step(mcfg_b, tcfg_t)
    for k in train_kernels:
        k.launches = 0
    state, hist_b = state0, []
    for _ in range(10):
        state, metrics = step_b16(state, tokens, lengths, feats, labels, hop_scale, lr, mult_lr)
        hist_b.append(metrics)
    torch.cuda.synchronize()
    bf16_launches = {"train_hops_fwd_bf16": rth.FWD_BF16_KERNEL.launches,
                     "train_hops_bwd_bf16": rth.BWD_BF16_KERNEL.launches,
                     "train_hops_fwd": rth.FWD_KERNEL.launches,
                     "train_hops_bwd": rth.BWD_KERNEL.launches}
    log(f"bf16 training launches in 10 steps: {bf16_launches}")
    if list(bf16_launches.values()) != [10, 10, 0, 0]:
        raise SystemExit(f"bf16 training: expected 10 launches of each bf16 kernel and none "
                         f"of the float32 ones, got {bf16_launches}")
    for i, m in enumerate(hist_b):
        bad = [k for k, v in m.items() if not torch.isfinite(v).all()]
        if bad:
            raise SystemExit(f"bf16 train step {i}: non-finite {bad}")
    losses_b = [m["loss"].item() for m in hist_b]
    log("bf16 fused train losses: " + " ".join(f"{x:.4f}" for x in losses_b))
    if not losses_b[-1] < losses_b[0]:
        raise SystemExit(f"bf16: joint loss did not fall over 10 steps: {losses_b}")
    # the same state, batch and masks as the float32 fused run's first step
    # (tests/test_pallas_train.py:227-242: within 5%)
    gap = abs(losses_b[0] - losses[0]) / abs(losses[0])
    log(f"first-step loss: bf16 {losses_b[0]:.6f}, float32 {losses[0]:.6f}, "
        f"relative gap {gap:.3e} (bar 0.05)")
    if gap > 0.05:
        raise SystemExit(f"bf16 first-step loss {losses_b[0]} is {gap:.3e} from the "
                         f"float32 step's {losses[0]}")
    # (c) the preset unfused with compute_dtype bfloat16 (the --bf16 path
    # without --fused-train): every hop in PyTorch on bf16 casts
    mcfg_ub = dataclasses.replace(mcfg_u, compute_dtype="bfloat16")
    step_ub = make_train_step(mcfg_ub, tcfg_u)
    for k in train_kernels:
        k.launches = 0
    state, hist_ub = state0, []
    for _ in range(10):
        state, metrics = step_ub(state, tokens, lengths, feats, labels, hop_scale, lr, mult_lr)
        hist_ub.append(metrics)
    torch.cuda.synchronize()
    if any(k.launches for k in train_kernels):
        raise SystemExit("the unfused bf16 step launched a fused training kernel")
    for i, m in enumerate(hist_ub):
        bad = [k for k, v in m.items() if not torch.isfinite(v).all()]
        if bad:
            raise SystemExit(f"unfused bf16 train step {i}: non-finite {bad}")
    losses_ub = [m["loss"].item() for m in hist_ub]
    log("unfused bf16 train losses: " + " ".join(f"{x:.4f}" for x in losses_ub))
    if not losses_ub[-1] < losses_ub[0]:
        raise SystemExit(f"unfused bf16: joint loss did not fall over 10 steps: {losses_ub}")
    # the same state, batch and generator as the unfused float32 run's first step
    gap_u = abs(losses_ub[0] - losses_u[0]) / abs(losses_u[0])
    log(f"first-step loss: unfused bf16 {losses_ub[0]:.6f}, float32 {losses_u[0]:.6f}, "
        f"relative gap {gap_u:.3e} (bar 0.05)")
    if gap_u > 0.05:
        raise SystemExit(f"unfused bf16 first-step loss {losses_ub[0]} is {gap_u:.3e} from "
                         f"the float32 step's {losses_u[0]}")
    log("phase training: ok")

    # 6. from pixels through the user's entry point: answer_pixels
    cfg_r = get_preset("ours_resnet")
    params_r = init_params(cfg_r, torch.Generator().manual_seed(args.seed), dev)
    bb = resnet.fold_batchnorm(resnet.resnet101_init(
        torch.Generator().manual_seed(args.seed + 1), bf16, dev))
    bb_f32 = map_tree(lambda t: t.float(), bb)
    # calls per batch size: one B=1 call gives only 10 answer ids, too few to
    # resolve a 0.95 bar, so B=1 and B=7 run on several batches (>= 300 ids)
    pix_calls = {1: 32, 7: 5, 120: 1}
    pix_data = {}
    for B, n in pix_calls.items():
        for _ in range(n):
            tokens, lengths, _ = make_batch(cfg_r, B, cfg_r.seq_len, rs, dev)
            images = torch.as_tensor(rs.randint(0, 256, (B, 448, 448, 3), dtype=np.uint8),
                                     device=dev)
            pix_data.setdefault(B, []).append((images, tokens, lengths))
    for k in (fused_resnet.KERNEL, lstm_encoder.KERNEL, rau_hops.KERNEL):
        k.launches = 0
    pix_out = {B: [pipeline.answer_pixels(params_r, bb, cfg_r, "resnet101", *d)
                   for d in batches] for B, batches in pix_data.items()}
    torch.cuda.synchronize()
    pix_launches = {"fused_identity_stage": fused_resnet.KERNEL.launches,
                    "lstm_encode": lstm_encoder.KERNEL.launches,
                    "rau_hops": rau_hops.KERNEL.launches}
    n_calls = sum(pix_calls.values())
    log(f"pixels launches in {n_calls} calls: {pix_launches}")
    if pix_launches != {"fused_identity_stage": 4 * n_calls, "lstm_encode": n_calls,
                        "rau_hops": n_calls}:
        raise SystemExit(f"answer_pixels: expected 4 stage-kernel launches and one of each "
                         f"head kernel a call, got {pix_launches}")
    S, Hr, Ar = cfg_r.cnn_spat, cfg_r.n_hops, cfg_r.answer_size
    head_w = pipeline._head_weights(params_r)
    gen_r = torch.Generator(dev).manual_seed(args.seed)
    # Random weights leave many near-ties among the answers, and two bf16
    # backbones differ by ~2% of the features' scale (activations ~1e7, the
    # head's tanh saturated), so exact agreement with pixels_forward sits at
    # 0.95-0.96 whatever the kernel (PERF.md).  The gates are set against
    # bf16's own effect, measured on each call as pixels_forward on the bf16
    # tree against the same tree in float32:
    # - answers > 0.95 at each B, an answer agreeing when pixels_forward
    #   scores it within twice the largest change that bf16 rounding makes to
    #   that row's scores (random answers must stay below 0.2 there, or the
    #   slack would pass anything);
    # - over all calls, answer_pixels agrees with the float32 tree no less
    #   than pixels_forward does, less 0.03 (sampling over ~1,900 ids);
    # - attention within twice bf16's own change to it, plus 5e-4;
    # - the kernels' head against the float32 head on the same features: the
    #   serving bars (0.95; attention atol 5e-4, tests/test_pallas_rau.py);
    # - the fused backbone no farther from the float32 features than cuDNN's
    #   bf16 one (1.5x, plus 1e-3 for the sampling).
    # A kernel fault that these cannot see is caught at the main path's own
    # stage inputs below.
    failed, pooled = [], {"ids": 0, "fused_f32": 0, "cudnn_f32": 0}
    for B, batches in pix_data.items():
        hits = dict.fromkeys(("same", "head", "backbone", "near", "near_random",
                              "fused_f32", "cudnn_f32"), 0)
        total = 0
        att_err = att_bf16 = att_head = att_bb = 0.0
        feat_err = feat_max = err_fused = err_cudnn = 0.0
        for (ids, att), d in zip(pix_out[B], batches):
            if ids.shape != (Hr + 2, B) or att.shape != (Hr + 2, B, S):
                raise SystemExit(f"pixels B={B}: shapes {tuple(ids.shape)} {tuple(att.shape)}")
            if not torch.isfinite(att).all():
                raise SystemExit(f"pixels B={B}: non-finite attention")
            images, tokens, lengths = d
            with torch.no_grad():
                out = pipeline.pixels_forward(params_r, bb, cfg_r, "resnet101", *d)
                ref_pred, ref_att = _aggregate(out.scores, out.do_pred, out.attprob)
                # where the answers part: the kernels' head on the unfused
                # backbone's features, and the float32 head on the fused ones;
                # and the same tree's weights in float32, free of bf16 rounding
                f_ref = pipeline.extract_features("resnet101", bb, images).float()
                f_fused = pipeline.extract_features(
                    "resnet101", bb, images, fused_stages=pipeline.SERVING_STAGES).float()
                f32 = pipeline.extract_features("resnet101", bb_f32, images)
                head_pred, head_att = predict_fused(params_r, head_w, cfg_r, tokens,
                                                    lengths, f_ref)
                bb_pred, bb_att = predict(params_r, cfg_r, tokens, lengths, f_fused)
                f32_pred, f32_att = predict(params_r, cfg_r, tokens, lengths, f32)
            ref_ids, f32_ids = ref_pred.argmax(-1), f32_pred.argmax(-1)
            slack = 2 * (ref_pred - f32_pred).abs().amax(-1)
            best = ref_pred.amax(-1)

            def near(i):
                return (best - ref_pred.gather(-1, i[..., None])[..., 0] <= slack).sum().item()

            hits["near"] += near(ids)
            hits["near_random"] += near(torch.randint(0, Ar, ids.shape, device=dev,
                                                      generator=gen_r))
            hits["same"] += (ids == ref_ids).sum().item()
            hits["head"] += (head_pred.argmax(-1) == ref_ids).sum().item()
            hits["backbone"] += (bb_pred.argmax(-1) == ref_ids).sum().item()
            hits["fused_f32"] += (ids == f32_ids).sum().item()
            hits["cudnn_f32"] += (ref_ids == f32_ids).sum().item()
            total += ids.numel()
            att_err = max(att_err, (att - ref_att).abs().max().item())
            att_bf16 = max(att_bf16, (ref_att - f32_att).abs().max().item())
            att_head = max(att_head, (head_att - ref_att).abs().max().item())
            att_bb = max(att_bb, (bb_att - ref_att).abs().max().item())
            feat_max = max(feat_max, f_ref.abs().max().item())
            feat_err = max(feat_err, scaled_err(f_fused, f_ref))
            err_fused = max(err_fused, scaled_err(f_fused, f32))
            err_cudnn = max(err_cudnn, scaled_err(f_ref, f32))
        r = {k: v / total for k, v in hits.items()}
        pooled["ids"] += total
        pooled["fused_f32"] += hits["fused_f32"]
        pooled["cudnn_f32"] += hits["cudnn_f32"]
        log(f"pixels B={B} x {len(batches)} calls, {total} ids: answers agree with "
            f"pixels_forward {r['same']:.4f} (kernels' head alone {r['head']:.4f}, fused "
            f"backbone alone {r['backbone']:.4f}), within bf16's tie slack {r['near']:.4f} "
            f"(random answers {r['near_random']:.4f}); with the float32 tree: answer_pixels "
            f"{r['fused_f32']:.4f}, pixels_forward {r['cudnn_f32']:.4f}; attention "
            f"max_abs_err {att_err:.3e}, bf16's own {att_bf16:.3e} (head alone "
            f"{att_head:.3e}, backbone alone {att_bb:.3e}); features fused vs unfused "
            f"max_abs_err/max {feat_err:.3e}, max|features| {feat_max:.3e}; against "
            f"float32 features: fused {err_fused:.3e}, unfused {err_cudnn:.3e}")
        if r["near"] <= 0.95 or r["near_random"] >= 0.2:
            failed.append(f"B={B}: answers within bf16's tie slack {r['near']:.4f} "
                          f"(bar > 0.95), random answers {r['near_random']:.4f} (bar < 0.2)")
        if att_err > 2 * att_bf16 + 5e-4:
            failed.append(f"B={B}: attention max_abs_err {att_err:.3e}, bf16's own "
                          f"{att_bf16:.3e}")
        if r["head"] <= 0.95 or att_head > 5e-4:
            failed.append(f"B={B}: kernels' head vs float32 head: agreement "
                          f"{r['head']:.4f}, attention {att_head:.3e} (bars 0.95, 5e-4)")
        if err_fused > 1.5 * err_cudnn + 1e-3:
            failed.append(f"B={B}: fused backbone {err_fused:.3e} from float32, unfused "
                          f"{err_cudnn:.3e}")
    fused_f32, cudnn_f32 = (pooled[k] / pooled["ids"] for k in ("fused_f32", "cudnn_f32"))
    log(f"pixels, all {pooled['ids']} ids: agreement with the float32 tree, answer_pixels "
        f"{fused_f32:.4f}, pixels_forward {cudnn_f32:.4f} (bar: no less, less 0.03)")
    if fused_f32 < cudnn_f32 - 0.03:
        failed.append(f"answer_pixels agrees {fused_f32:.4f} with the float32 tree, "
                      f"pixels_forward {cudnn_f32:.4f}")

    # the stage kernel against its plain version at the main path's own stage
    # inputs (B=120, 448 px), walking the backbone as answer_pixels does; the
    # walk's intermediates are the timing phase's inputs
    B = 120
    images, tokens, lengths = pix_data[B][0]
    prep = resnet._prepared(bb)
    walk, stage_err = [], {}
    with torch.no_grad():
        x0 = color_normalize(images.float() / 255.0).to(bf16)
        x = resnet._maxpool(torch.relu(resnet._conv_p(x0, prep["conv1"], 2)))
        for st in range(4):
            down = resnet._prepared_block(bb, prep, st, 0)
            x_down = x
            x = resnet._block(x, down, 2 if st else 1).contiguous()
            stack = resnet._stage_stack(bb, prep, st)
            got = fused_resnet.fused_identity_stage(x, stack)
            want = plain_stage(x, stack)
            e = scaled_err(got, want)
            stage_err[st] = (e, (got.float() - want.float()).abs().max().item())
            bar = stage_bar(stack["w1"].shape[0])
            log(f"fused_identity_stage at the main path's stage {st} input "
                f"{tuple(x.shape)}: max_abs_err/max|want| {e:.3e} (bar {bar}), max_abs_err "
                f"{stage_err[st][1]:.3e}, max|want| {want.float().abs().max().item():.3e}")
            if not e <= bar:
                failed.append(f"stage {st} at B={B}: scale-normalised error {e:.3e} > {bar}")
            walk.append((st, x_down, down, x, stack))
            x = got
            del want
    if failed:
        raise SystemExit("pixels: " + "; ".join(failed))
    log("phase pixels: ok")

    # 7. timing: serving at B=512, T=26
    B = 512
    tokens, lengths, feats = make_batch(cfg, B, cfg.seq_len, rs, dev)
    with torch.no_grad():
        emb = embed_question(params, tokens).contiguous()
        q = lstm_encoder.lstm_encode(enc, cfg, emb, lengths)
        ifeat, iatt = embed_image(params["mult"], feats)
        ifeat = ifeat.to(bf16).contiguous()
        iatt = iatt.to(bf16).contiguous()
        lstm = torch_lstm_from(cfg, params["rnn"], dev)
        packed = torch.nn.utils.rnn.pack_padded_sequence(
            emb, lengths.cpu().long(), batch_first=True, enforce_sorted=False)
        _, (h_n, c_n) = lstm(packed)
        lib_state = torch.cat([x for L in range(cfg.rnn_layers)
                               for x in (c_n[L], h_n[L])], dim=1)
        f32_state = lstm_encoder.lstm_encode_reference(params["rnn"], cfg, emb, lengths)
        lib_err = (lib_state - f32_state).abs().max().item()
        log(f"torch.nn.LSTM yardstick vs plain f32 encoder: max_abs_err {lib_err:.3e}")
        if lib_err > 1e-3:
            raise SystemExit("torch.nn.LSTM yardstick does not compute the encoder")

        ms = {
            "lstm_encode": time_ms(lambda: lstm_encoder.lstm_encode(enc, cfg, emb, lengths)),
            "lstm_plain": time_ms(lambda: lstm_encoder.lstm_encode_reference(
                enc, cfg, emb, lengths, dot_dtype=bf16)),
            "lstm_library": time_ms(lambda: lstm(packed)),
            "rau_hops": time_ms(lambda: rau_hops.rau_hops(hw, cfg, q, ifeat, iatt)),
            "hops_plain": time_ms(lambda: rau_hops.rau_hops_reference(
                hw, cfg, q, ifeat, iatt, dot_dtype=bf16)),
        }
        # the rest of the predict step, for its breakdown
        ms["embed_image"] = time_ms(lambda: embed_image(params["mult"], feats))
        ms["embed_question"] = time_ms(lambda: embed_question(params, tokens))
        s_k, d_k, a_k = rau_hops.rau_hops(hw, cfg, q, ifeat, iatt)
        ms["aggregate"] = time_ms(lambda: _aggregate(s_k, d_k, a_k))
        step_ms = time_ms(lambda: step(params, tokens, lengths, feats), iters=10)
    for k, v in ms.items():
        log(f"{k}_ms={v:.4f} B=512 T=26 [{card}]")
    log(f"predict_step_ms={step_ms:.4f} B=512 [{card}]")
    for (B_s, _), batch in zip(serve_batches[:-1], data[:-1]):
        with torch.no_grad():
            t_s = time_ms(lambda: step(params, *batch), iters=10)
        log(f"predict_step_ms={t_s:.4f} B={B_s} T={int(batch[1].max())} [{card}]")
    # the hop kernel at the service's batch sizes: device time (CUDA events),
    # the host's enqueue time of one call (its C entry enqueues 2 + 11 H
    # launches), beside its bound and the floor of reading the features
    # once a hop, which do not fit in L2 at B=512
    hops_kernels = {}
    for (B_s, _), (tok_s, len_s, feats_s) in zip(serve_batches, data):
        with torch.no_grad():
            q_s = lstm_encoder.lstm_encode(enc, cfg, embed_question(params, tok_s).contiguous(),
                                           len_s)
            if_s, ia_s = (x.to(bf16).contiguous() for x in embed_image(params["mult"], feats_s))
            h_ms = time_ms(lambda: rau_hops.rau_hops(hw, cfg, q_s, if_s, ia_s), iters=50)
            host_s = 0.0
            for _ in range(20):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rau_hops.rau_hops(hw, cfg, q_s, if_s, ia_s)
                host_s += time.perf_counter() - t0
            hops_kernels[B_s] = device_kernels(lambda: rau_hops.rau_hops(
                hw, cfg, q_s, if_s, ia_s))
        want_k = rau_hops.hops_plan(B_s, cfg).kernels(cfg.n_hops)
        hb_s, hb_s_by = hops_bound(cfg, hw, B_s)
        floor_s = (cfg.n_hops * B_s * cfg.cnn_spat * (cfg.multfeat_dim + cfg.attfeat_dim) * 2
                   / H100_BYTES_PER_S * 1e3)
        log(f"rau_hops_ms={h_ms:.4f} host_enqueue_ms={host_s / 20 * 1e3:.4f} bound_ms="
            f"{hb_s:.4f} by {hb_s_by}, features read each hop {floor_s:.4f} ms; "
            f"{hops_kernels[B_s]} device kernels a call (the plan's {want_k}) B={B_s} [{card}]")
        if hops_kernels[B_s] != want_k:
            raise SystemExit(f"rau_hops B={B_s}: {hops_kernels[B_s]} device kernels a call, "
                             f"not the plan's {want_k}")
    log(f"predict_step_questions_per_s={B / step_ms * 1e3:.1f} B=512 [{card}]")

    # the encoder at the service's batch sizes, T=26, beside torch.nn.LSTM in
    # float32 (the yardstick) and, logged only, in bf16: the same precision
    # as the kernel's operands.  Neither library call is on the port's path.
    lstm_bf16 = torch_lstm_from(cfg, params["rnn"], dev).to(bf16)
    lstm_bf16.flatten_parameters()
    for B_e in (1, 16, 83, 512):
        tok_e, len_e, _ = make_batch(cfg, B_e, cfg.seq_len, rs, dev)
        with torch.no_grad():
            emb_e = embed_question(params, tok_e).contiguous()
            pk, pk16 = (torch.nn.utils.rnn.pack_padded_sequence(
                x, len_e.cpu().long(), batch_first=True, enforce_sorted=False)
                for x in (emb_e, emb_e.to(bf16)))
            k_ms = time_ms(lambda: lstm_encoder.lstm_encode(enc, cfg, emb_e, len_e), iters=50)
            f_ms = time_ms(lambda: lstm(pk))
            try:
                b_ms = f"{time_ms(lambda: lstm_bf16(pk16)):.4f}"
            except RuntimeError as e:
                b_ms = f"not measured ({str(e).splitlines()[0][:80]})"
        log(f"lstm_encode_ms={k_ms:.4f} torch_lstm_f32_ms={f_ms:.4f} "
            f"torch_lstm_bf16_ms={b_ms} B={B_e} T=26 [{card}]")
        if B_e > 1:   # the plan's row-group choice (ROW_GROUP_MIN_B), both ways
            rg_ms = {}
            for rg in (1, 2):
                plan = lstm_encoder.lstm_plan(B_e, cfg.embed_dim, cfg.rnn_size, cfg.rnn_layers,
                                              n_sm, row_groups=rg)
                with torch.no_grad():
                    rg_ms[rg] = time_ms(lambda: lstm_encoder.lstm_encode(
                        enc, cfg, emb_e, len_e, plan=plan), iters=50)
            log(f"lstm_encode_ms by row groups: 1: {rg_ms[1]:.4f} 2: {rg_ms[2]:.4f} "
                f"B={B_e} T=26 [{card}]")

    lb_ms, lb_by = lstm_bound(cfg, enc, lengths, cfg.seq_len)
    hb_ms, hb_by = hops_bound(cfg, hw, B)

    # training at B=100, T=26: the two kernels, their plain versions, and the
    # train step with its parts
    B = tcfg_t.batch_size
    tokens, lengths, feats = make_batch(mcfg_t, B, mcfg_t.seq_len, rs, dev)
    p0 = state0.params
    mp = p0["mult"]
    seed_t = torch.tensor([rs.randint(0, 2 ** 31 - 1)], dtype=torch.int32, device=dev)
    gen = torch.Generator(dev).manual_seed(args.seed)
    with torch.no_grad():
        q = encode_question(p0, mcfg_t, tokens, lengths)
        fwd_out = rth.train_hops_fwd(mp, mcfg_t, q, feats, seed_t)
        _, _, attprob, c_all, h_all = fwd_out
        g_scores = 1e-3 * torch.randn(H, B, A, device=dev, generator=gen)
        gmerge = (g_scores @ mp["cls"]["w"].T).contiguous()
        em, _ = rth.train_hops_bwd(mp, mcfg_t, q, feats, seed_t, c_all, h_all, gmerge)
        tms = {
            "train_hops_fwd": time_ms(lambda: rth.train_hops_fwd(mp, mcfg_t, q, feats, seed_t),
                                      iters=10),
            "train_fwd_plain": time_ms(lambda: rth.train_hops_fwd_reference(
                mp, mcfg_t, q, feats, seed_t), iters=5),
            "train_hops_bwd": time_ms(lambda: rth.train_hops_bwd(
                mp, mcfg_t, q, feats, seed_t, c_all, h_all, gmerge), iters=10),
            "train_bwd_plain": time_ms(lambda: rth.train_hops_bwd_reference(
                mp, mcfg_t, q, feats, seed_t, c_all, h_all, gmerge), iters=5),
            "train_outside_grads": time_ms(lambda: rth._outside_grads(
                mcfg_t, mp, q, seed_t, h_all, attprob, g_scores, em)),
        }

        def optimizer():
            for i, g in enumerate(PARAM_GROUPS):
                gg = add_gradient_noise(p0[g], gen, 1, tcfg_t.noisy_eta, tcfg_t.noisy_gamma)
                gg, _ = clip_by_global_norm(gg, tcfg_t.grad_clip)
                adam_update(p0[g], gg, lr, state0.opt[g])

        tms["train_optimizer"] = time_ms(optimizer)

    def encoder_fwd_bwd():
        p = {g: map_tree(lambda x: x.detach().requires_grad_(), p0[g])
             for g in ("embed", "rnn")}
        encode_question(p, mcfg_t, tokens, lengths, train=True, generator=gen).sum().backward()

    tms["train_encoder_fwd_bwd"] = time_ms(encoder_fwd_bwd)
    train_ms = time_ms(lambda: train_step(state0, tokens, lengths, feats, labels,
                                          hop_scale, lr, mult_lr), iters=10)
    for k, v in tms.items():
        log(f"{k}_ms={v:.4f} B={B} [{card}]")
    log(f"train_step_ms={train_ms:.4f} B={B} T={mcfg_t.seq_len} [{card}]")
    log(f"train_step_other_ms={train_ms - sum(v for k, v in tms.items() if 'plain' not in k):.4f} "
        f"(loss, gmerge, autograd glue) B={B} [{card}]")
    log(f"train_step_questions_per_s={B / train_ms * 1e3:.1f} B={B} [{card}]")
    busy_ms, top, _, n_k, host = device_profile(lambda: train_step(
        state0, tokens, lengths, feats, labels, hop_scale, lr, mult_lr))
    if busy_ms > 0:
        log(f"train_step_device_busy_ms={busy_ms:.4f} of {train_ms:.4f} "
            f"(idle share {1 - busy_ms / train_ms:.3f}; {n_k:.0f} device kernels a step) "
            f"B={B} [{card}]")
        for name, t in top[:8]:
            log(f"train_step_device_ms={t:.4f} {name[:70]}")
        for name, t, n in host[:6]:
            log(f"train_step_host_ms={t:.4f} {name[:50]} ({n:.0f} calls)")
    else:
        log("train_step_device_busy_ms: not measured (the profiler recorded no device time)")
    fb_ms, fb_by = train_fwd_bound(mcfg_t, mp, B)
    bb_ms, bb_by = train_bwd_bound(mcfg_t, mp, B)
    # each training kernel's device kernels a call, as the profiler records
    # them: its plan's phases, every hop; and the forward's peak memory
    fwd_kernels, bwd_kernels, fwd_peak = {}, {}, {}

    def peak_mb(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        del out
        return (torch.cuda.max_memory_allocated() - base) / 1e6

    with torch.no_grad():
        fwd_kernels[torch.float32] = device_kernels(lambda: rth.train_hops_fwd(
            mp, mcfg_t, q, feats, seed_t))
        fwd_peak[torch.float32] = peak_mb(lambda: rth.train_hops_fwd(
            mp, mcfg_t, q, feats, seed_t))
        bwd_kernels[torch.float32] = device_kernels(lambda: rth.train_hops_bwd(
            mp, mcfg_t, q, feats, seed_t, c_all, h_all, gmerge))

    # the bf16 kernels and their plain versions at B=100 on the step's own
    # bf16 casts, then the bf16 fused and the unfused steps, each with its
    # idle share
    mp16 = map_tree(lambda w: w.to(bf16), mp)
    with torch.no_grad():
        q16, feats16 = q.to(bf16), feats.to(bf16)
        _, _, attprob16, c16, h16 = rth.train_hops_fwd(mp16, mcfg_b, q16, feats16, seed_t)
        tms16 = {
            "train_hops_fwd_bf16": time_ms(lambda: rth.train_hops_fwd(
                mp16, mcfg_b, q16, feats16, seed_t), iters=10),
            "train_fwd_bf16_plain": time_ms(lambda: rth.train_hops_fwd_reference(
                mp16, mcfg_b, q16, feats16, seed_t), iters=5),
            "train_hops_bwd_bf16": time_ms(lambda: rth.train_hops_bwd(
                mp16, mcfg_b, q16, feats16, seed_t, c16, h16, gmerge), iters=10),
            "train_bwd_bf16_plain": time_ms(lambda: rth.train_hops_bwd_reference(
                mp16, mcfg_b, q16, feats16, seed_t, c16, h16, gmerge), iters=5),
        }
        bwd_kernels[bf16] = device_kernels(lambda: rth.train_hops_bwd(
            mp16, mcfg_b, q16, feats16, seed_t, c16, h16, gmerge))
        fwd_kernels[bf16] = device_kernels(lambda: rth.train_hops_fwd(
            mp16, mcfg_b, q16, feats16, seed_t))
        fwd_peak[bf16] = peak_mb(lambda: rth.train_hops_fwd(mp16, mcfg_b, q16, feats16, seed_t))
    for k, v in tms16.items():
        log(f"{k}_ms={v:.4f} B={B} [{card}]")
    for kind, counts, plan_of in (
            ("fwd", fwd_kernels, lambda dt: rth.fwd_plan(B, *fwd_widths, n_sm, dt)),
            ("bwd", bwd_kernels, lambda dt: rth.bwd_plan(B, *bwd_widths, n_sm, dt))):
        for dt, n in counts.items():
            want = H * len(plan_of(dt).phases)
            log(f"train_hops_{kind} {dt} device kernels a call: {n} recorded by the "
                f"profiler, {want} in the plan (its phases x {H} hops) B={B} [{card}]")
            if n != want:
                raise SystemExit(f"train_hops_{kind} {dt}: {n} device kernels a call, "
                                 f"not {want}")
    for dt, mb in fwd_peak.items():
        log(f"train_hops_fwd {dt} peak device memory a call: {mb:.1f} MB above its inputs "
            f"(outputs, workspace, scratch) B={B} [{card}]")
    fb16_ms, fb16_by = train_fwd_bound(mcfg_b, mp16, B, bf16)
    bb16_ms, bb16_by = train_bwd_bound(mcfg_b, mp16, B, bf16)
    log(f"train_hops_fwd_bound_ms={fb_ms:.4f} by {fb_by}, bf16 {fb16_ms:.4f} by {fb16_by}; "
        f"train_hops_bwd_bound_ms={bb_ms:.4f} by {bb_by}, bf16 {bb16_ms:.4f} by {bb16_by}")
    for name, step_fn in (("bf16_fused", step_b16), ("unfused", step_u),
                          ("unfused_bf16", step_ub)):
        st_ms = time_ms(lambda: step_fn(state0, tokens, lengths, feats, labels, hop_scale,
                                        lr, mult_lr), iters=10)
        log(f"train_step_{name}_ms={st_ms:.4f} B={B} T={mcfg_t.seq_len} [{card}]")
        log(f"train_step_{name}_questions_per_s={B / st_ms * 1e3:.1f} B={B} [{card}]")
        busy_ms, top, _, n_k, host = device_profile(lambda: step_fn(
            state0, tokens, lengths, feats, labels, hop_scale, lr, mult_lr))
        if busy_ms > 0:
            log(f"train_step_{name}_device_busy_ms={busy_ms:.4f} of {st_ms:.4f} "
                f"(idle share {1 - busy_ms / st_ms:.3f}; {n_k:.0f} device kernels a step) "
                f"B={B} [{card}]")
            for kname, t in top[:6]:
                log(f"train_step_{name}_device_ms={t:.4f} {kname[:70]}")
            for hname, t, n in host[:6]:
                log(f"train_step_{name}_host_ms={t:.4f} {hname[:50]} ({n:.0f} calls)")
        else:
            log(f"train_step_{name}_device_busy_ms: not measured (no device time recorded)")
    log(f"lstm_encode_bound_ms={lb_ms:.4f} by {lb_by}; "
        f"rau_hops_bound_ms={hb_ms:.4f} by {hb_by}")

    # the mask hash's check entry at the largest shape of its check
    shape = (19, cfg.cnn_spat, cfg.cnn_dim)
    seed_t = torch.tensor([12345], dtype=torch.int32, device=dev)
    mask_ms = time_ms(lambda: maskgen.dropout_mask(seed_t, 0, 0, shape, 81, 0.5))
    mask_plain_ms = time_ms(lambda: maskgen.dropout_scale_mask(
        shape, 81, maskgen.site_salt(seed_t, 0, 0), 0.5))
    mb_ms, mb_by = mask_bound(shape)
    log(f"maskgen_ms={mask_ms:.4f} plain_ms={mask_plain_ms:.4f} bound_ms={mb_ms:.5f} "
        f"by {mb_by} shape={shape} [{card}]")

    # from pixels at B=120, 448 px: answer_pixels and its parts, taken in the
    # order the call runs them, on the pixels phase's walk
    B = 120
    images, tokens, lengths = pix_data[B][0]
    pms, stage_ms = {}, []

    def unfused(x, st, n_blocks):
        for b in range(1, n_blocks):
            x = resnet._block(x, resnet._prepared_block(bb, prep, st, b), 1)
        return x

    with torch.no_grad():
        def normalize():
            return color_normalize(images.float() / 255.0).to(bf16)

        pms["normalize"] = time_ms(normalize, iters=5)
        pms["stem_maxpool"] = time_ms(lambda: resnet._maxpool(
            torch.relu(resnet._conv_p(x0, prep["conv1"], 2))), iters=5)
        for st, x_down, down, x, stack in walk:
            pms[f"down_block{st}"] = time_ms(
                lambda: resnet._block(x_down, down, 2 if st else 1), iters=5)
            Bs, Hs, Ws, C = x.shape
            N, _, Cw = stack["w1"].shape
            row = {"stage": st, "shape": (Bs, Hs, Ws, C, Cw, N),
                   "ms": time_ms(lambda: fused_resnet.fused_identity_stage(x, stack), iters=5),
                   "plain_ms": time_ms(lambda: plain_stage(x, stack), iters=2, warmup=1),
                   "library_ms": time_ms(lambda: unfused(x, st, N + 1), iters=5)}
            row["bound_ms"], row["bound_by"] = stage_bound(Bs, Hs, Ws, C, Cw, N)
            row["plan"] = fused_resnet.stage_plan(Bs, Hs, Ws, C, Cw, n_sm)
            row["weight_gb"] = row["plan"].weight_bytes * N / 1e9
            row["old_weight_gb"] = old_stage_weight_bytes(Bs, Hs, Ws, C, Cw, N) / 1e9
            stage_ms.append(row)
            pms[f"stage_kernel{st}"] = row["ms"]
        # the stage kernel's levers one at a time, on the call's own inputs:
        # the old 4x14 tile at stage 2, the ring's depth at stage 1 (stage 3
        # has no other choice)
        variants = []
        for st, _, _, x, stack in walk[1:3]:
            Bs, Hs, Ws, C = x.shape
            N, _, Cw = stack["w1"].shape
            shape = (Bs, Hs, Ws, C, Cw, n_sm)
            alt = [("the plan", fused_resnet.stage_plan(*shape))]
            if st == 1:
                alt.append(("a 3-deep ring", fused_resnet.stage_plan(*shape, ring=3)))
            if st == 2:
                alt.append(("the old 4x14 tile", fused_resnet.stage_plan(*shape, tile=(4, 14))))
            for name, p in alt:
                v_ms = time_ms(lambda: fused_resnet.fused_identity_stage(x, stack, plan=p),
                               iters=5)
                variants.append((st, name, p, v_ms, p.weight_bytes * N / 1e9))
        x = fused_resnet.fused_identity_stage(walk[-1][3], walk[-1][4])
        feats = x.reshape(B, -1, x.shape[-1]).float()
        pms["head"] = time_ms(lambda: predict_fused(params_r, head_w, cfg_r, tokens, lengths,
                                                    feats), iters=5)
        ans_ms = time_ms(lambda: pipeline.answer_pixels(params_r, bb, cfg_r, "resnet101",
                                                        images, tokens, lengths), iters=5)
    for k, v in pms.items():
        log(f"pixels_{k}_ms={v:.4f} B={B} 448px [{card}]")
    log(f"pixels_rest_ms={ans_ms - sum(pms.values()):.4f} (feature casts, host) B={B}")
    for row in stage_ms:
        p = row["plan"]
        log(f"stage{row['stage']} {row['shape']} (B, H, W, C, Cw, N): kernel_ms={row['ms']:.4f} "
            f"plain_ms={row['plain_ms']:.4f} unfused_cudnn_ms={row['library_ms']:.4f} "
            f"bound_ms={row['bound_ms']:.4f} by {row['bound_by']}; plan: tile {p.th}x{p.tw}, "
            f"ring {p.ring}, {p.smem} B shared memory, "
            f"{stage_regs.get((p.th, p.tw, p.nb, p.ring), 'unknown')} registers, {p.ctas} CTAs; "
            f"L2 weight reads {row['weight_gb']:.3f} GB a call "
            f"(the mma.sync kernel's 8x8/4x14 tiling: {row['old_weight_gb']:.3f}) [{card}]")
    for st, name, p, v_ms, gb in variants:
        log(f"stage{st} variant {name}: tile {p.th}x{p.tw} ring {p.ring}: "
            f"kernel_ms={v_ms:.4f}, L2 weight reads {gb:.3f} GB [{card}]")
    log(f"answer_pixels_ms={ans_ms:.4f} B={B} 448px; images_per_s={B / ans_ms * 1e3:.1f}; "
        f"questions_per_s={B / ans_ms * 1e3:.1f} (one question an image) [{card}]")
    busy_ms, top, ops, _, _ = device_profile(lambda: pipeline.answer_pixels(
        params_r, bb, cfg_r, "resnet101", images, tokens, lengths))
    if busy_ms > 0:
        log(f"answer_pixels_device_busy_ms={busy_ms:.4f} of {ans_ms:.4f} "
            f"(idle share {1 - busy_ms / ans_ms:.3f}) B={B} [{card}]")
        for name, t in top[:10]:
            log(f"answer_pixels_device_ms={t:.4f} {name[:70]} <- {ops.get(name, 'no op')[:110]}")
    else:
        log("answer_pixels_device_busy_ms: not measured (the profiler recorded no device time)")
    s2 = stage_ms[2]
    kernels = [
        {"name": "lstm_encode", "route": "cuda",
         "source": "rau_vqa_tpu_torch/csrc/lstm_encoder.cu",
         "replaces": "rau_vqa_tpu/ops/lstm_encoder.py:81",
         "launches": launches["lstm_encode"], "max_abs_err": err["lstm_encode"],
         "ms": ms["lstm_encode"], "plain_ms": ms["lstm_plain"],
         "bound_ms": lb_ms, "bound_by": lb_by, "library_ms": ms["lstm_library"]},
        {"name": "rau_hops", "route": "cuda",
         "source": "rau_vqa_tpu_torch/csrc/rau_hops.cu",
         "replaces": "rau_vqa_tpu/ops/rau_hops.py:152",
         "launches": launches["rau_hops"], "max_abs_err": err["rau_hops"],
         "ms": ms["rau_hops"], "plain_ms": ms["hops_plain"],
         "bound_ms": hb_ms, "bound_by": hb_by, "library_ms": None,
         "device_kernels_a_call": hops_kernels[512]},
        {"name": "train_hops_fwd", "route": "cuda",
         "source": "rau_vqa_tpu_torch/csrc/rau_train_hops_fwd.cu",
         "replaces": "rau_vqa_tpu/ops/rau_train_hops.py:358",
         "launches": train_launches["train_hops_fwd"],
         "max_abs_err": err["train_hops_fwd"],
         "ms": tms["train_hops_fwd"], "plain_ms": tms["train_fwd_plain"],
         "bound_ms": fb_ms, "bound_by": fb_by, "library_ms": None,
         "device_kernels_a_call": fwd_kernels[torch.float32]},
        # max_abs_err here: the worst norm-relative grad error over the leaves
        {"name": "train_hops_bwd", "route": "cuda",
         "source": "rau_vqa_tpu_torch/csrc/rau_train_hops_bwd.cu",
         "replaces": "rau_vqa_tpu/ops/rau_train_hops.py:471",
         "launches": train_launches["train_hops_bwd"],
         "max_abs_err": err["train_hops_bwd"],
         "ms": tms["train_hops_bwd"], "plain_ms": tms["train_bwd_plain"],
         "bound_ms": bb_ms, "bound_by": bb_by, "library_ms": None,
         "device_kernels_a_call": bwd_kernels[torch.float32]},
        # the bf16 instantiations (compute_dtype "bfloat16"); launches: the
        # bf16 fused step's 10; max_abs_err: the worst norm-relative error
        # against the bf16 plain version, the forward's over its outputs,
        # the backward's over the grad leaves
        {"name": "train_hops_fwd_bf16", "route": "cuda",
         "source": "rau_vqa_tpu_torch/csrc/rau_train_hops_fwd.cu",
         "replaces": "rau_vqa_tpu/ops/rau_train_hops.py:358",
         "launches": bf16_launches["train_hops_fwd_bf16"],
         "max_abs_err": err["train_hops_fwd_bf16"],
         "ms": tms16["train_hops_fwd_bf16"], "plain_ms": tms16["train_fwd_bf16_plain"],
         "bound_ms": fb16_ms, "bound_by": fb16_by, "library_ms": None,
         "device_kernels_a_call": fwd_kernels[bf16]},
        {"name": "train_hops_bwd_bf16", "route": "cuda",
         "source": "rau_vqa_tpu_torch/csrc/rau_train_hops_bwd.cu",
         "replaces": "rau_vqa_tpu/ops/rau_train_hops.py:471",
         "launches": bf16_launches["train_hops_bwd_bf16"],
         "max_abs_err": err["train_hops_bwd_bf16"],
         "ms": tms16["train_hops_bwd_bf16"], "plain_ms": tms16["train_bwd_bf16_plain"],
         "bound_ms": bb16_ms, "bound_by": bb16_by, "library_ms": None,
         "device_kernels_a_call": bwd_kernels[bf16]},
        # the check entry of the device hash; launches: its check's
        {"name": "maskgen", "route": "cuda",
         "source": "rau_vqa_tpu_torch/csrc/maskgen.cu",
         "replaces": "rau_vqa_tpu/ops/maskgen.py:34",
         "launches": mask_launches, "max_abs_err": 0.0,
         "ms": mask_ms, "plain_ms": mask_plain_ms,
         "bound_ms": mb_ms, "bound_by": mb_by, "library_ms": None},
        # at stage 2 of the main path (B=120, 448 px), the other stages in
        # the lines above: max_abs_err absolute, scaled_err over max|want|
        # (activations reach ~1e5 there); library_ms: the unfused stage
        # (three F.conv2d a block, bf16 channels_last through cuDNN)
        {"name": "fused_identity_stage", "route": "cuda",
         "source": "rau_vqa_tpu_torch/csrc/fused_resnet.cu",
         "replaces": "rau_vqa_tpu/ops/fused_resnet.py:129",
         "launches": pix_launches["fused_identity_stage"],
         "max_abs_err": stage_err[2][1], "scaled_err": stage_err[2][0],
         "ms": s2["ms"], "plain_ms": s2["plain_ms"],
         "bound_ms": s2["bound_ms"], "bound_by": s2["bound_by"],
         "library_ms": s2["library_ms"]},
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
