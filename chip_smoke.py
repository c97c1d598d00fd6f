"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure exits non-zero:

1. device   — a Hopper card (capability 9.0); its name and power limit;
2. build    — every CUDA source of rau_vqa_tpu_torch/csrc with nvcc for
              sm_90a, one nvcc each, all at once, with the ptxas register /
              shared-memory report;
3. kernels  — each kernel against its plain version at ``ours_ms`` widths:
              the serving kernels at B in {19, 512} at the bars of
              tests/test_pallas_rau.py; the device mask hash bit for bit; the
              training hop loop's forward (rtol / atol 1e-4) and backward
              (grads norm-relative 1e-3 per leaf) at B in {19, 100};
4. serving  — ``make_predict_step`` on cuda answers batches of 1, 4, 16, 83
              and 512 with length buckets 8, 16 and 26 each hit; outputs are
              finite and agree with the plain float32 path; both serving
              kernels' launch counts rose during this phase;
5. training — ``make_train_step`` on cuda, ``ours_ms`` with fused_train, B=100,
              T=26: 10 steps on one batch with all dropout and gradient noise
              on; losses and grad norms finite, the last loss below the
              first, each training kernel launched exactly 10 times; one
              step with the backward kernel and one with autograd through
              the plain version agree on every grad norm;
6. timing   — CUDA-event times of each kernel and its plain version (for
              the encoder also torch.nn.LSTM), the predict step at B=512,
              and the train step and its parts at B=100.

Prints each number beside the card's name and power limit, a ``kernels``
JSON line, and as the last line ``{"ok": true, "device": {...}}``.  Weights
are random, from the seed.  Imports nothing of JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

H100_BF16_FLOPS = 989e12      # dense bf16 tensor-core peak, H100 SXM
H100_F32_FLOPS = 67e12        # float32 outside the tensor cores, H100 SXM
H100_BYTES_PER_S = 3.35e12    # HBM3, H100 SXM


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
    kernel times in ms, [(kernel name, ms)] largest first).  The sum is 0
    where the profiler records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.key_averages():
        # the device's own rows (kernels, copies); CPU-op rows repeat them
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            by_name[e.key] = by_name.get(e.key, 0.0) + e.self_device_time_total / 1e3 / iters
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    return sum(by_name.values()), top


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
    """Least time for the encoder: inputs read once, output written once;
    bf16 dots for each row's real tokens only."""
    B, E, R, L = lengths.shape[0], cfg.embed_dim, cfg.rnn_size, cfg.rnn_layers
    n_bytes = B * T * E * 4 + B * 4 + nbytes(enc) + B * 2 * L * R * 4
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


def train_fwd_bound(cfg, mp, B):
    """Least time for the training hop loop's forward: q, feats and the
    weights read once, the five outputs written once; float32 operations."""
    Q, S, Dc, R, A, H = (cfg.rnnout_dim, cfg.cnn_spat, cfg.cnn_dim,
                         cfg.att_state_dim, cfg.answer_size, cfg.n_hops)
    n_bytes = (B * Q + B * S * Dc + H * B * (A + 1 + S) + 2 * (H + 1) * B * R) * 4 + nbytes(mp)
    return bound(n_bytes, B * H * train_hop_flops(cfg)[0], H100_F32_FLOPS)


def train_bwd_bound(cfg, mp, B):
    """Least time for the backward kernel's work: q, feats, the carries,
    gmerge and the weights read once; its emissions and the summed
    feats-path grads written once; the hop's remat (without the
    classifier) plus its backward in float32 operations."""
    Q, S, Dc, M, F, R, A, H = (cfg.rnnout_dim, cfg.cnn_spat, cfg.cnn_dim, cfg.multfeat_dim,
                               cfg.attfeat_dim, cfg.att_state_dim, cfg.answer_size, cfg.n_hops)
    emits = 7 * M + F + S + 4 * R
    n_bytes = ((B * Q + B * S * Dc + 2 * (H + 1) * B * R + H * B * M + H * B * emits
                + Dc * M + M + M * F + 2 * F) * 4 + nbytes(mp))
    fwd, bwd = train_hop_flops(cfg)
    n_ops = B * H * (fwd - 2 * (M * A + M) + bwd)
    return bound(n_bytes, n_ops, H100_F32_FLOPS)


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
        _aggregate, compute_answers, make_predict_step, pick_bucket, predict)
    from rau_vqa_tpu_torch.models.rau import (
        embed_image, embed_question, encode_question, init_params)
    from rau_vqa_tpu_torch.ops import _build, lstm_encoder, maskgen, rau_hops
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
                                "rau_train_hops_fwd", "rau_train_hops_bwd"],
                               force=True)
    log(f"build_s={time.perf_counter() - t0:.3f} [{card}]")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"ptxas {name}: {line.strip()}")

    cfg = get_preset("ours_ms")
    params = init_params(cfg, torch.Generator().manual_seed(args.seed), dev)
    enc = lstm_encoder.pack_encoder_weights(params["rnn"])
    hw = rau_hops.pack_hop_weights(params["mult"])
    rs = np.random.RandomState(args.seed)

    # 3. kernels against their plain versions
    err = {"lstm_encode": 0.0, "rau_hops": 0.0}
    for B in (19, 512):
        tokens, lengths, feats = make_batch(cfg, B, cfg.seq_len, rs, dev)
        emb = embed_question(params, tokens).contiguous()
        got = lstm_encoder.lstm_encode(enc, cfg, emb, lengths)
        want = lstm_encoder.lstm_encode_reference(enc, cfg, emb, lengths, dot_dtype=bf16)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=0.05, atol=5e-3)
        e = (got - want).abs().max().item()
        err["lstm_encode"] = max(err["lstm_encode"], e)
        log(f"lstm_encode B={B} max_abs_err={e:.3e} (bar rtol 0.05 atol 5e-3)")

        q = want
        ifeat, iatt = embed_image(params["mult"], feats)
        ifeat = ifeat.to(bf16).contiguous()
        iatt = iatt.to(bf16).contiguous()
        s, d, a = rau_hops.rau_hops(hw, cfg, q, ifeat, iatt)
        s_r, d_r, a_r = rau_hops.rau_hops_reference(hw, cfg, q, ifeat, iatt,
                                                    dot_dtype=bf16)
        torch.cuda.synchronize()
        torch.testing.assert_close(s, s_r, rtol=0.05, atol=0.01)
        agree = (s.argmax(-1) == s_r.argmax(-1)).float().mean().item()
        if agree <= 0.97:
            raise SystemExit(f"rau_hops argmax agreement {agree} <= 0.97")
        torch.testing.assert_close(a, a_r, rtol=0.05, atol=5e-4)
        torch.testing.assert_close(d, d_r, rtol=0.05, atol=5e-3)
        es = [(x - y).abs().max().item() for x, y in ((s, s_r), (d, d_r), (a, a_r))]
        err["rau_hops"] = max(err["rau_hops"], *es)
        log(f"rau_hops B={B} max_abs_err scores={es[0]:.3e} do_pred={es[1]:.3e} "
            f"attprob={es[2]:.3e} argmax_agree={agree:.4f}")

    # the training kernels, float32, at mult_dropout 0.5 (the preset's)
    tcfg_m = dataclasses.replace(cfg, fused_train=True)
    mp = params["mult"]
    Q, S, Dc, M = cfg.rnnout_dim, cfg.cnn_spat, cfg.cnn_dim, cfg.multfeat_dim
    H, A = cfg.n_hops, cfg.answer_size
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
    log("maskgen: device hash equals the plain version bit for bit "
        "(seeds 0, 12345, 2^31-2; hops 0, 7; 3 sites; row_offset 81)")
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
        log(f"train_hops_fwd B={B} max_abs_err {max(es):.3e} (bar rtol 1e-4 atol 1e-4)")

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
    log("phase kernels: ok")

    # 4. serving through the user's entry point
    step = make_predict_step(cfg, buckets=(8, 16))
    batches = [(1, 8), (4, 16), (16, 26), (83, 12), (512, 26)]
    data = [make_batch(cfg, B, max_len, rs, dev) for B, max_len in batches]
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
    for (B, _), (tokens, lengths, feats), (tab_pred, tab_att) in zip(batches, data, outs):
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
    log("phase training: ok")

    # 6. timing: serving at B=512, T=26
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
    for (B_s, _), batch in zip(batches[:-1], data[:-1]):
        with torch.no_grad():
            t_s = time_ms(lambda: step(params, *batch), iters=10)
        log(f"predict_step_ms={t_s:.4f} B={B_s} T={int(batch[1].max())} [{card}]")
    log(f"predict_step_questions_per_s={B / step_ms * 1e3:.1f} B=512 [{card}]")

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
    busy_ms, top = device_profile(lambda: train_step(state0, tokens, lengths, feats, labels,
                                                     hop_scale, lr, mult_lr))
    if busy_ms > 0:
        log(f"train_step_device_busy_ms={busy_ms:.4f} of {train_ms:.4f} "
            f"(idle share {1 - busy_ms / train_ms:.3f}) B={B} [{card}]")
        for name, t in top[:8]:
            log(f"train_step_device_ms={t:.4f} {name[:70]}")
    else:
        log("train_step_device_busy_ms: not measured (the profiler recorded no device time)")
    fb_ms, fb_by = train_fwd_bound(mcfg_t, mp, B)
    bb_ms, bb_by = train_bwd_bound(mcfg_t, mp, B)
    log(f"lstm_encode_bound_ms={lb_ms:.4f} by {lb_by}; "
        f"rau_hops_bound_ms={hb_ms:.4f} by {hb_by}")
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
         "bound_ms": hb_ms, "bound_by": hb_by, "library_ms": None},
        {"name": "train_hops_fwd", "route": "cuda",
         "source": "rau_vqa_tpu_torch/csrc/rau_train_hops_fwd.cu",
         "replaces": "rau_vqa_tpu/ops/rau_train_hops.py:358",
         "launches": train_launches["train_hops_fwd"],
         "max_abs_err": err["train_hops_fwd"],
         "ms": tms["train_hops_fwd"], "plain_ms": tms["train_fwd_plain"],
         "bound_ms": fb_ms, "bound_by": fb_by, "library_ms": None},
        # max_abs_err here: the worst norm-relative grad error over the leaves
        {"name": "train_hops_bwd", "route": "cuda",
         "source": "rau_vqa_tpu_torch/csrc/rau_train_hops_bwd.cu",
         "replaces": "rau_vqa_tpu/ops/rau_train_hops.py:471",
         "launches": train_launches["train_hops_bwd"],
         "max_abs_err": err["train_hops_bwd"],
         "ms": tms["train_hops_bwd"], "plain_ms": tms["train_bwd_plain"],
         "bound_ms": bb_ms, "bound_by": bb_by, "library_ms": None},
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
