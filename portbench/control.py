#!/usr/bin/env python3
"""The control of a cell's comparison: what the check reads when the timed
path is replaced by the control (the driver's ``control``: the reference one
precision step below the configuration's, or the program's own path at that
precision), at the cell's own size, on each seed given.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 [--variant <name>]

(``--variant``: another of the driver's ``CONTROLS``, read beside the
control) prints one JSON line a seed: each number beside the cell's limit, and
whether the control fails (some number over its limit), as it has to.  The
benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variant", default=None)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(1, ROOT)
    import harness
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    cell = harness.load_json(harness.BENCH, "cells", args.workload + ".json")
    config = harness.load_json(harness.BENCH, "configs", cell["config"] + ".json")
    driver = harness.load_module("drivers", cell["driver"])
    failed_all = True
    for seed in args.seeds:
        ctx = harness.Context(args.workload, seed, 0.0, False, cell, config,
                              harness.Sizes(config), torch.device("cuda"))
        numbers = driver.control(ctx, **({"variant": args.variant} if args.variant else {}))
        fails = {k: v > cell["limits"][k] for k, v in numbers.items()}
        failed_all &= any(fails.values())
        print(json.dumps({"workload": args.workload, "seed": seed, "variant": args.variant,
                          "control_fails": any(fails.values()),
                          "numbers": {k: {"value": v, "limit": cell["limits"][k]}
                                      for k, v in numbers.items()}}), flush=True)
        torch.cuda.empty_cache()
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
