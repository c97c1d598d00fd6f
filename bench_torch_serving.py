"""Serving latency of the PyTorch port on one CUDA card, for A/B runs.

    python3 bench_torch_serving.py [--root DIR] [--seed N] [--label NAME]

Times, with CUDA events, ``make_predict_step`` (``ours_ms``, buckets 8 and
16) at B = 1, 4, 16, 83 and 512 on the batches chip_smoke.py's serving phase
makes (longest questions 8, 16, 26, 12 and 26 tokens), and the question
encoder ``lstm_encode`` alone at B = 1, 16, 83 and 512 with T = 26.  The
package is imported from ``--root`` (default: this file's directory), so
that one call on one card can time two checkouts in turns: parent, change,
change, parent.  Uses only entry points that every version of the port has.
Prints one line per number with the card's name and power limit, and a JSON
line.  Needs a card; weights are random, from the seed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_torch_serving: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from chip_smoke import card_line, make_batch, time_ms
    from rau_vqa_tpu_torch.config import get_preset
    from rau_vqa_tpu_torch.eval.predict import make_predict_step
    from rau_vqa_tpu_torch.models.rau import embed_question, init_params
    from rau_vqa_tpu_torch.ops import lstm_encoder

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    dev = torch.device("cuda")
    cfg = get_preset("ours_ms")
    params = init_params(cfg, torch.Generator().manual_seed(args.seed), dev)
    enc = lstm_encoder.pack_encoder_weights(params["rnn"])
    rs = np.random.RandomState(args.seed)
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
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
