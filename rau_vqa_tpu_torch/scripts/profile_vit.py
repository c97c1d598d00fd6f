"""Component times of the ViT-L/14 from-pixels serving step on one CUDA
card: where the backbone's time goes, beside the head's.

Counterpart of ``scripts/profile_vit.py``.  Each component runs ``--chain``
times with a data dependence (iteration k's input moved by a scalar of
iteration k-1's output), each round timed with CUDA events and synchronised
once, after one untimed call:

  vit_full : normalized images -> ``vit_apply`` tokens          [B, S, D]
  patch    : the 14x14/14 patch-embedding convolution and the position add
  blocks   : the 24 transformer blocks and the final LayerNorm on ready tokens
  mhsa     : the attention sublayer alone, x24
  mlp      : the MLP sublayer alone, x24
  head     : the RAU answer path on ready tokens, ``--qpi`` questions an
             image, as the port serves it (``predict_fused``: the
             question-LSTM and hop kernels, ``ours_vit`` widths)

patch + blocks ~ vit_full and mhsa + mlp ~ blocks; what does not add is the
passes between the library calls.

    python3 -m rau_vqa_tpu_torch.scripts.profile_vit [--batch 64] [--qpi 3] [--chain 5]
        [--rounds 3] [--f32] [--device cpu]

Weights are random, made on the device from seed 1 (values do not change the
work); bf16 unless ``--f32`` (TF32 off).  Prints one JSON line: ``metric``
vit_profile_ms, ``value`` vit_full's ms, ``components_ms``, ``batch``,
``spread`` (each component's rounds), ``chain``, ``launches``, ``device``,
``power_limit_w`` and the canary.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from rau_vqa_tpu_torch.scripts._common import (
    add_device_arg,
    canary_keys,
    launch_counts,
    launches_since,
    log,
    run_script,
    spread,
    sync,
    time_call,
)

METRIC = "vit_profile_ms"
UNIT = "ms"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--qpi", type=int, default=3)
    ap.add_argument("--chain", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--f32", action="store_true")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    if min(args.batch, args.qpi, args.chain, args.rounds) < 1:
        raise SystemExit("--batch, --qpi, --chain and --rounds must be >= 1")
    device = torch.device(args.device)

    def body() -> Dict:
        from rau_vqa_tpu_torch.bench import SERVING_KERNELS, build_kernels
        from rau_vqa_tpu_torch.config import get_preset
        from rau_vqa_tpu_torch.eval.predict import pack_kernel_weights, predict_fused
        from rau_vqa_tpu_torch.models.backbones.resnet import _nchw
        from rau_vqa_tpu_torch.models.backbones.vit import (
            VIT_L14,
            _linear,
            _ln,
            _mhsa,
            vit_apply,
            vit_init,
        )
        from rau_vqa_tpu_torch.models.rau import init_params

        if args.f32:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        build_kernels(device, SERVING_KERNELS)
        wdt = torch.float32 if args.f32 else torch.bfloat16
        cfg = dataclasses.replace(get_preset("ours_vit"),
                                  compute_dtype="float32" if args.f32 else "bfloat16")
        vc = VIT_L14
        B, Q, K = args.batch, args.qpi, args.chain
        bb = vit_init(torch.Generator(device).manual_seed(1), vc, wdt, device)
        params = init_params(cfg, torch.Generator().manual_seed(0), device)
        kw = pack_kernel_weights(params)
        rs = np.random.RandomState(1)
        imgs = torch.as_tensor(rs.rand(B, vc.image_size, vc.image_size, 3)
                               .astype(np.float32), device=device)
        toks = torch.as_tensor(rs.randint(1, cfg.vocab_size, (B * Q, cfg.seq_len))
                               .astype(np.int32), device=device)
        lens = torch.as_tensor(rs.randint(1, cfg.seq_len + 1, (B * Q,)).astype(np.int32),
                               device=device)
        tokens0 = torch.as_tensor(0.02 * rs.standard_normal((B, vc.seq, vc.dim)),
                                  device=device).to(wdt)

        def patch_only(p, x):
            pe = p["patch_embed"]
            x = F.conv2d(_nchw(x.to(pe["w"].dtype)), pe["w"].permute(3, 2, 0, 1),
                         stride=vc.patch)
            return x.flatten(2).transpose(1, 2) + pe["b"] + p["pos_embed"]

        def mlp(x, blk):
            h = F.gelu(_linear(_ln(x, blk["ln2"], vc.ln_eps), blk["fc1"]), approximate="none")
            return _linear(h, blk["fc2"])

        def blocks_only(p, x):
            for blk in p["blocks"]:
                x = x + _mhsa(_ln(x, blk["ln1"], vc.ln_eps), blk, vc.heads)
                x = x + mlp(x, blk)
            return _ln(x, p["ln_final"], vc.ln_eps)

        def mhsa_only(p, x):
            for blk in p["blocks"]:
                x = x + _mhsa(_ln(x, blk["ln1"], vc.ln_eps), blk, vc.heads)
            return x

        def mlp_only(p, x):
            for blk in p["blocks"]:
                x = x + mlp(x, blk)
            return x

        def head_only(p, feats):
            featsq = feats.float().repeat_interleave(Q, dim=0)
            return predict_fused(p, kw, cfg, toks, lens, featsq)[0]

        cases = {"vit_full": (lambda p, x: vit_apply(p, vc, x), bb, imgs),
                 "patch": (patch_only, bb, imgs),
                 "blocks": (blocks_only, bb, tokens0),
                 "mhsa": (mhsa_only, bb, tokens0),
                 "mlp": (mlp_only, bb, tokens0),
                 "head": (head_only, params, tokens0)}

        def chained(f, p, x0, salt: float):
            """K iterations of f, each input moved by the last output's mean."""
            s = torch.tensor(salt, dtype=x0.dtype, device=device)
            acc = torch.zeros((), dtype=torch.float32, device=device)
            for _ in range(K):
                out = f(p, x0 + s * 1e-6)
                s = out[0].float().mean().to(x0.dtype)
                acc = out.float().mean()
            return acc

        before = launch_counts()
        comp, spreads = {}, {}
        with torch.no_grad():
            for name, (f, p, x0) in cases.items():
                t_first, _ = time_call(lambda: chained(f, p, x0, 0.0), device)
                times = []
                for r in range(args.rounds):
                    dt, acc = time_call(lambda: chained(f, p, x0, 100.0 + r), device)
                    if not torch.isfinite(acc):
                        raise RuntimeError(f"profile_vit: {name} gave a non-finite output")
                    times.append(dt / K)
                comp[name] = round(float(np.median(times)) * 1e3, 4)
                spreads[name] = spread(times)
                log(f"profile_vit: {name} {comp[name]} ms an iteration (first chain "
                    f"{t_first:.2f}s)")
        sync(device)
        return {"metric": METRIC, "value": comp["vit_full"], "unit": UNIT, "batch": B,
                "qpi": Q, "chain": K, "rounds": args.rounds, "components_ms": comp,
                "spread": spreads,
                "compute_dtype": "float32" if args.f32 else "bfloat16",
                "launches": {n: c for n, c in launches_since(before).items() if c},
                **canary_keys(device)}

    return run_script(METRIC, UNIT, device, body, timeout_s=4200.0)


if __name__ == "__main__":
    sys.exit(main())
