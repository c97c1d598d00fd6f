"""Batch-size sweep of the port's serving step on one CUDA card: where the
per-question cost stops falling as the batch grows.

Counterpart of ``scripts/probe_serving_batch.py``.  Each batch size runs
``bench_torch.py``'s program (``eval/chain.py`` ``make_serve_chain``:
``--chain`` serving steps of ``ours_ms`` through the question-LSTM and hop
kernels, chained by a data dependence), on random weights from seed 0 and
inputs from ``RandomState(B)``; after a first and a warm call each, the
timed rounds go round-robin over the batch sizes, so that the card's drift
hits every size alike.  Each round is timed with CUDA events and
synchronised once.

    python3 -m rau_vqa_tpu_torch.scripts.probe_serving_batch [--batches 1024,2048,4096,8192]
        [--rounds 5] [--chain 30] [--canary auto|n,iters,rounds] [--device cpu]

Prints one JSON line: ``metric`` serving_batch_sweep, ``value`` the best
q/s, ``sweep`` (each batch's ``ms_per_batch``, ``qps``, ``spread``, ``mfu``
and ``flops_per_step``), ``chain``, ``rounds``, ``launches``, ``device``,
``power_limit_w`` and the canary.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict

import numpy as np
import torch

from rau_vqa_tpu_torch.scripts._common import (
    add_device_arg,
    card_keys,
    launch_counts,
    launches_since,
    log,
    run_script,
    spread,
    sync,
    time_call,
)

METRIC = "serving_batch_sweep"
UNIT = "questions/sec"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=str, default="1024,2048,4096,8192")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--chain", type=int, default=30)
    ap.add_argument("--canary", type=str, default="auto",
                    help="matmul_canary n,iters,rounds; 'auto': its defaults (full size "
                         "on the card, tiny on the CPU)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    batches = [int(b) for b in args.batches.split(",")]
    canary_args = ({} if args.canary == "auto" else
                   dict(zip(("n", "iters", "rounds"), (int(v) for v in args.canary.split(",")))))
    if min(batches + [args.rounds, args.chain]) < 1:
        raise SystemExit("batches, --rounds and --chain must be >= 1")
    device = torch.device(args.device)
    K = args.chain

    def body() -> Dict:
        from rau_vqa_tpu_torch.bench import SERVING_KERNELS, build_kernels
        from rau_vqa_tpu_torch.config import get_preset
        from rau_vqa_tpu_torch.eval.chain import make_serve_chain
        from rau_vqa_tpu_torch.models.rau import init_params
        from rau_vqa_tpu_torch.utils.flops import H100_BF16_FLOPS, serve_step_flops
        from rau_vqa_tpu_torch.utils.rigcheck import matmul_canary

        build_kernels(device, SERVING_KERNELS)
        cfg = get_preset("ours_ms")
        params = init_params(cfg, torch.Generator().manual_seed(0), device)
        chain = make_serve_chain(cfg, K)
        before = launch_counts()
        variants, flops = {}, {}
        for B in batches:
            rs = np.random.RandomState(B)       # distinct data a batch size
            tokens = torch.as_tensor(rs.randint(1, cfg.vocab_size, (B, cfg.seq_len))
                                     .astype(np.int32), device=device)
            h_len = rs.randint(1, cfg.seq_len + 1, B).astype(np.int32)
            lengths = torch.as_tensor(h_len, device=device)
            feats = torch.as_tensor(rs.randn(B, cfg.cnn_spat, cfg.cnn_dim)
                                    .astype(np.float32), device=device)
            flops[B] = serve_step_flops(cfg, B, int(h_len.sum()))

            def run(salt, tokens=tokens, lengths=lengths, feats=feats):
                return chain(params, tokens, lengths, feats,
                             torch.tensor(salt, dtype=torch.int32, device=device))

            variants[B] = run
            with torch.no_grad():
                t_first, _ = time_call(lambda: run(0), device)
                run(5)
            sync(device)
            log(f"B={B}: first chain {t_first:.2f}s")
        times = {B: [] for B in batches}
        with torch.no_grad():
            for r in range(args.rounds):
                for B in batches:       # interleaved: drift hits every B alike
                    dt, _ = time_call(lambda: variants[B](100 + r), device)
                    times[B].append(dt)
                    log(f"round {r} B={B}: {dt / K * 1e3:.3f} ms a batch")
        canary = matmul_canary(device=device, **canary_args)
        on_card = device.type == "cuda"
        sweep = []
        for B in batches:
            dt = float(np.median(times[B]))
            sweep.append({"batch": B, "ms_per_batch": round(dt / K * 1e3, 4),
                          "qps": round(K * B / dt, 1), "spread": spread(times[B]),
                          "flops_per_step": flops[B],
                          "mfu": (round(flops[B] / (dt / K) / H100_BF16_FLOPS, 5)
                                  if on_card else None)})
        log("sweep: " + ", ".join(f"B={s['batch']} {s['qps']:,.0f} q/s" for s in sweep))
        return {"metric": METRIC, "value": max(s["qps"] for s in sweep), "unit": UNIT,
                "chain": K, "rounds": args.rounds, "sweep": sweep,
                "launches": {n: c for n, c in launches_since(before).items() if c},
                **card_keys(device, canary)}

    return run_script(METRIC, UNIT, device, body, timeout_s=3600.0)


if __name__ == "__main__":
    sys.exit(main())
