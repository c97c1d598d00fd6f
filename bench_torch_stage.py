"""Probe of the identity-stage kernel on one CUDA card (an H100).

    python3 bench_torch_stage.py [--seed N] [--batch 120]

At ResNet-101's four 448-px stage shapes (random He-normal stacks from the
seed, random activations), builds ``csrc/fused_resnet.cu`` and its probe
build ``csrc/fused_resnet_probe.cu`` and prints, beside the card's name and
power limit:

- the library's kernel, CUDA-event mean of 5 calls;
- the kernel without loads (``fused_identity_stage_no_loads``): the
  producer issues no TMA, so the products run on stale shared memory; what
  is left is the time of the products and their synchronisation alone (the
  output is garbage);
- one call of block 0 through ``fused_identity_stage_cycles`` and
  ``fused_identity_stage_cycles_no_loads``, whose first and middle CTA print
  the cycles of the reduce, the 3x3 and the expand and the cycles their
  consumers waited on full slots (with loads, then without).

The probe library goes to ``rau_vqa_tpu_torch/_build/`` beside the
library's.  Exits 2 without a card.  Imports nothing of JAX or the JAX
package.
"""

from __future__ import annotations

import argparse
import ctypes
import sys

import torch

from chip_smoke import card_line, stage_bound, stage_stack, time_ms

STAGES = [(112, 256, 64, 2), (56, 512, 128, 3), (28, 1024, 256, 22), (14, 2048, 512, 2)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=120)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_torch_stage: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    from rau_vqa_tpu_torch.ops import _build, fused_resnet as fr

    card = card_line()
    _build.build_all(["fused_resnet", "fused_resnet_probe"], force=True)
    probes = {tag: _build.Kernel("fused_resnet_probe", f"fused_identity_stage_{tag}",
                                 fr.KERNEL.argtypes)
              for tag in ("no_loads", "cycles", "cycles_no_loads")}
    kernels = {"kernel": fr.KERNEL, "no_loads": probes["no_loads"]}
    libc = ctypes.CDLL(None)
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(args.seed)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    B = args.batch
    for H, C, Cw, N in STAGES:
        stack = stage_stack(N, C, Cw, torch.bfloat16, gen, dev)
        stack.update(fr.pack_stage_weights(stack))
        x = torch.randn(B, H, H, C, generator=gen, device=dev).abs().to(torch.bfloat16)
        plan = fr.stage_plan(B, H, H, C, Cw, n_sm)
        ms = {}
        for tag in ("kernel", "no_loads", "kernel", "no_loads"):
            ms.setdefault(tag, []).append(time_ms(lambda: fr.fused_identity_stage(
                x, stack, plan=plan, kernel=kernels[tag]), iters=5))
        bound_ms, by = stage_bound(B, H, H, C, Cw, N)
        print(f"stage (B, H, C, Cw, N) = {(B, H, C, Cw, N)}, tile {plan.th}x{plan.tw} ring "
              f"{plan.ring}: kernel_ms={' / '.join(f'{v:.4f}' for v in ms['kernel'])}, "
              f"without loads {' / '.join(f'{v:.4f}' for v in ms['no_loads'])}; bound "
              f"{bound_ms:.4f} ms by {by} [{card}]", flush=True)
        one = {k: v[:1].contiguous() for k, v in stack.items()}
        for tag in ("cycles", "cycles_no_loads"):
            print(f"  {tag} (block 0):", flush=True)
            fr.fused_identity_stage(x, one, plan=plan, kernel=probes[tag])
            torch.cuda.synchronize()
            libc.fflush(None)   # the device's printf goes through C's stdout
    return 0


if __name__ == "__main__":
    sys.exit(main())
