"""Serving latency of the PyTorch port on one CUDA card, for A/B runs.

    python3 bench_torch_serving.py [--root DIR] [--seed N] [--label NAME] [--hops]

Times, with CUDA events, ``make_predict_step`` (``ours_ms``, buckets 8 and
16) at B = 1, 4, 16, 83 and 512 on the batches chip_smoke.py's serving phase
makes (longest questions 8, 16, 26, 12 and 26 tokens), the question
encoder ``lstm_encode`` alone at B = 1, 16, 83 and 512 with T = 26, and the
hop loop ``rau_hops`` alone at B = 1, 4, 16, 83 and 512.  The
package is imported from ``--root`` (default: this file's directory), so
that one call on one card can time two checkouts in turns: parent, change,
change, parent.  Uses only entry points that every version of the port has.
Prints one line per number with the card's name and power limit, and a JSON
line.  Needs a card; weights are random, from the seed.

With ``--hops``, instead prints the hop kernel (``rau_hops``) at B = 512 and
B = 1: its CUDA-event time and the device time of each of its phases
(``hops_plan``) summed over the 8 hops, from torch.profiler's kernel
records of 3 calls taken in stream order, beside the phase's own bound: its
operands read once and its outputs written once over 3.35 TB/s, or its
products over the 989 TFLOP/s bf16 tensor-core peak, the larger.  The sum
of the phases leaves out the gaps between kernels.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch


def hops_phase_bound(ph, B, cfg):
    """(ms, "bytes" | "operations") of one phase of ``hops_plan`` at one hop
    (the setup phases: once a call)."""
    from chip_smoke import H100_BF16_FLOPS, H100_BYTES_PER_S
    Q, S, M, F = cfg.rnnout_dim, cfg.cnn_spat, cfg.multfeat_dim, cfg.attfeat_dim
    R = cfg.att_rnn_size

    def b(n_bytes, n_ops=0.0):
        t_b, t_o = n_bytes / H100_BYTES_PER_S * 1e3, n_ops / H100_BF16_FLOPS * 1e3
        return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")

    if ph.tile is not None:   # bf16 operands, a float32 output
        return b((ph.M * ph.K + ph.K * ph.N) * 2 + ph.M * ph.N * 4, 2.0 * ph.M * ph.N * ph.K)
    sizes = {"prep": B * Q * (4 + 2) + B * R * (4 + 4 + 2),
             # ifeat, iatt, qatt, msc and w_score in; attprob, its bf16 copy, pool out
             "rows_eval": B * S * (M + F) * 2 + B * (F + S) * 4 + B * S * 6 + B * M * 4,
             # c and the gates in; c', h', h' in bf16 and the activations out
             "cell": B * R * 4 + B * 4 * R * 4 + B * R * 10 + B * 4 * R * 4}
    return b(sizes[ph.name])


def hops_phases(rau_hops, cfg, hw, q, ifeat, iatt, calls=3):
    """The device ms of each phase of one call, the setup's once and each
    hop phase's summed over the hops, averaged over ``calls`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    plan = rau_hops.hops_plan(q.shape[0], cfg)
    rau_hops.rau_hops(hw, cfg, q, ifeat, iatt)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            rau_hops.rau_hops(hw, cfg, q, ifeat, iatt)
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                      and not e.name.startswith(("Memset", "Memcpy"))),
                     key=lambda e: e.time_range.start)
    n = plan.kernels(cfg.n_hops)
    if len(kernels) != calls * n:
        raise SystemExit(f"the profiler recorded {len(kernels)} kernels, not {calls * n}")
    ms = np.asarray([e.time_range.elapsed_us() / 1e3 for e in kernels]).reshape(calls, n)
    k = len(plan.setup)
    hop = ms[:, k:].reshape(calls, cfg.n_hops, len(plan.hop)).sum(1)
    return plan, np.concatenate([ms[:, :k], hop], axis=1).mean(0)


def hops_main(args, card, dev, cfg, params, rs) -> int:
    from chip_smoke import hops_bound, make_batch, time_ms
    from rau_vqa_tpu_torch.models.rau import embed_image, embed_question
    from rau_vqa_tpu_torch.ops import lstm_encoder, rau_hops

    enc = lstm_encoder.pack_encoder_weights(params["rnn"])
    hw = rau_hops.pack_hop_weights(params["mult"])
    H = cfg.n_hops
    res = {"label": args.label, "root": args.root, "card": card}
    for B in (512, 1):
        tokens, lengths, feats = make_batch(cfg, B, cfg.seq_len, rs, dev)
        with torch.no_grad():
            q = lstm_encoder.lstm_encode(enc, cfg, embed_question(params, tokens).contiguous(),
                                         lengths)
            ifeat, iatt = (x.to(torch.bfloat16).contiguous()
                           for x in embed_image(params["mult"], feats))
            k_ms = time_ms(lambda: rau_hops.rau_hops(hw, cfg, q, ifeat, iatt), iters=50)
            plan, ph_ms = hops_phases(rau_hops, cfg, hw, q, ifeat, iatt)
        b_ms, b_by = hops_bound(cfg, hw, B)
        res[f"rau_hops_ms_B{B}"] = k_ms
        print(f"{args.label} rau_hops B={B}: kernel_ms={k_ms:.4f} bound_ms={b_ms:.4f} by {b_by}; "
              f"{plan.kernels(H)} kernels a call, their device time {ph_ms.sum():.4f} ms "
              f"[{card}]", flush=True)
        n_setup = len(plan.setup)
        for i, (ph, t) in sorted(enumerate(zip(plan.phases, ph_ms)), key=lambda r: -r[1][1]):
            times = 1 if i < n_setup else H
            pb, by = hops_phase_bound(ph, B, cfg)
            shape = (f" [{ph.M} x {ph.N}, K {ph.K}, tile {ph.tile[0]}x{ph.tile[1]}, grid "
                     f"{ph.grid}]" if ph.tile else f" [grid {ph.grid}]")
            over = "once" if times == 1 else f"over {H} hops"
            res[f"phase_ms_B{B}_{ph.name}"] = float(t)
            print(f"  phase {ph.name:<10} {t:8.4f} ms {over} ({t / ph_ms.sum():5.1%}), bound "
                  f"{pb * times:.4f} ms by {by}{shape} [{card}]", flush=True)
    print(json.dumps(res), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--label", default="")
    ap.add_argument("--hops", action="store_true",
                    help="the hop kernel's time and per-phase split at B=512 and B=1")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_torch_serving: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from chip_smoke import card_line, make_batch, time_ms
    from rau_vqa_tpu_torch.config import get_preset
    from rau_vqa_tpu_torch.eval.predict import make_predict_step
    from rau_vqa_tpu_torch.models.rau import embed_image, embed_question, init_params
    from rau_vqa_tpu_torch.ops import lstm_encoder, rau_hops

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    dev = torch.device("cuda")
    cfg = get_preset("ours_ms")
    params = init_params(cfg, torch.Generator().manual_seed(args.seed), dev)
    enc = lstm_encoder.pack_encoder_weights(params["rnn"])
    rs = np.random.RandomState(args.seed)
    if args.hops:
        return hops_main(args, card, dev, cfg, params, rs)
    step = make_predict_step(cfg, buckets=(8, 16))
    res = {"label": args.label, "root": args.root, "card": card}
    with torch.no_grad():
        for B, max_len in ((1, 8), (4, 16), (16, 26), (83, 12), (512, 26)):
            batch = make_batch(cfg, B, max_len, rs, dev)
            ms = time_ms(lambda: step(params, *batch), iters=20)
            res[f"predict_step_ms_B{B}"] = ms
            print(f"{args.label} predict_step_ms={ms:.4f} B={B} T={max_len} [{card}]", flush=True)
        for B in (1, 16, 83, 512):
            tokens, lengths, _ = make_batch(cfg, B, cfg.seq_len, rs, dev)
            emb = embed_question(params, tokens).contiguous()
            ms = time_ms(lambda: lstm_encoder.lstm_encode(enc, cfg, emb, lengths), iters=20)
            res[f"lstm_encode_ms_B{B}"] = ms
            print(f"{args.label} lstm_encode_ms={ms:.4f} B={B} T=26 [{card}]", flush=True)
        hw = rau_hops.pack_hop_weights(params["mult"])
        for B in (1, 4, 16, 83, 512):
            tokens, lengths, feats = make_batch(cfg, B, cfg.seq_len, rs, dev)
            q = lstm_encoder.lstm_encode(enc, cfg, embed_question(params, tokens).contiguous(),
                                         lengths)
            ifeat, iatt = (x.to(torch.bfloat16).contiguous()
                           for x in embed_image(params["mult"], feats))
            ms = time_ms(lambda: rau_hops.rau_hops(hw, cfg, q, ifeat, iatt), iters=50)
            res[f"rau_hops_ms_B{B}"] = ms
            print(f"{args.label} rau_hops_ms={ms:.4f} B={B} [{card}]", flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
