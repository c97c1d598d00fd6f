"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure exits non-zero:

1. device  — a Hopper card (capability 9.0); its name and power limit;
2. build   — both CUDA kernels from rau_vqa_tpu_torch/csrc with nvcc for
             sm_90a, with the ptxas register / shared-memory report;
3. kernels — each kernel against its plain version at ``ours_ms`` widths,
             B in {19, 512}, at the bars of tests/test_pallas_rau.py;
4. serving — ``make_predict_step`` on cuda answers batches of 1, 4, 16, 83
             and 512 with length buckets 8, 16 and 26 each hit; outputs are
             finite and agree with the plain float32 path; both kernels'
             launch counts rose during this phase;
5. timing  — CUDA-event times at B=512, T=26 of each kernel, its plain
             version and (for the encoder) torch.nn.LSTM, and of the whole
             predict step.

Prints each number beside the card's name and power limit, a ``kernels``
JSON line, and as the last line ``{"ok": true, "device": {...}}``.  Weights
are random, from the seed.  Imports nothing of JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

H100_BF16_FLOPS = 989e12      # dense bf16 tensor-core peak, H100 SXM
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


def bound(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_ops / H100_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def lstm_bound(cfg, enc, lengths, T):
    """Least time for the encoder: inputs read once, output written once;
    bf16 dots for each row's real tokens only."""
    B, E, R, L = lengths.shape[0], cfg.embed_dim, cfg.rnn_size, cfg.rnn_layers
    n_bytes = B * T * E * 4 + B * 4 + nbytes(enc) + B * 2 * L * R * 4
    per_step = 2 * 4 * R * (E + R) + (L - 1) * 2 * 4 * R * (R + R)
    n_ops = per_step * int(lengths.long().sum())
    return bound(n_bytes, n_ops)


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
    return bound(n_bytes, n_ops)


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

    from rau_vqa_tpu_torch.config import get_preset
    from rau_vqa_tpu_torch.eval.predict import (
        _aggregate, compute_answers, make_predict_step, pick_bucket, predict)
    from rau_vqa_tpu_torch.models.rau import embed_image, embed_question, init_params
    from rau_vqa_tpu_torch.ops import _build, lstm_encoder, rau_hops

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
    reports = _build.build_all(["lstm_encoder", "rau_hops"], force=True)
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

    # 5. timing at B=512, T=26
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
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
