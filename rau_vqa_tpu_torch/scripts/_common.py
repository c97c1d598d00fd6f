"""What the measurement scripts share: the kernels' launch counters, timing
on the card, the card's keys of a result line, and the harness around a
script's body (the watchdog, the device preflight, one JSON line last on
stdout, a record of each line measured on the card).

A script runs on ``--device cuda`` (the default) or ``cpu``.  Without a card
the preflight prints the error line and exits with code 3: a script never
falls back to the CPU.  On the CPU (a smoke of the code) the card's keys are
null.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Dict, Optional

import torch


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def add_device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; exit 3 without a card) or cpu (a smoke)")


def kernel_counters() -> Dict:
    """Each hand-written kernel's ``_build.Kernel``, under its name in
    ``chip_smoke.py``'s ``kernels`` line."""
    from rau_vqa_tpu_torch.ops import fused_resnet, lstm_encoder, maskgen, rau_hops
    from rau_vqa_tpu_torch.ops import rau_train_hops as rth

    return {"lstm_encode": lstm_encoder.KERNEL, "rau_hops": rau_hops.KERNEL,
            "train_hops_fwd": rth.FWD_KERNEL, "train_hops_bwd": rth.BWD_KERNEL,
            "train_hops_fwd_bf16": rth.FWD_BF16_KERNEL,
            "train_hops_bwd_bf16": rth.BWD_BF16_KERNEL,
            "train_hops_bwd_dfeats": rth.BWD_DFEATS_KERNEL,
            "train_hops_bwd_dfeats_bf16": rth.BWD_DFEATS_BF16_KERNEL,
            "maskgen": maskgen.KERNEL, "fused_identity_stage": fused_resnet.KERNEL}


def launch_counts() -> Dict[str, int]:
    """Every kernel's launches so far in this process."""
    return {name: k.launches for name, k in kernel_counters().items()}


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    """Every kernel's launches since ``before`` (a ``launch_counts()``)."""
    return {name: n - before[name] for name, n in launch_counts().items()}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_call(call: Callable[[], object], device: torch.device):
    """(seconds, result) of one ``call()``: CUDA events around it on the card,
    which it leaves synchronised once; the host's clock on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = call()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3, out
    t0 = time.perf_counter()
    out = call()
    return time.perf_counter() - t0, out


def spread(times) -> float:
    """(max - min) over the median of a list of round times."""
    import numpy as np
    med = float(np.median(times))
    return round((max(times) - min(times)) / med, 4) if med > 0 else 0.0


def card_keys(device: torch.device, canary: Optional[Dict] = None) -> Dict:
    """``device`` and ``power_limit_w`` (the card's name and limit from
    ``nvidia-smi``; "cpu" and null on the CPU) and the bf16 canary's
    ``rig_canary_tflops`` and ``rig_canary_frac_peak`` (null on the CPU)."""
    from rau_vqa_tpu_torch.utils.rigcheck import card_info

    if device.type != "cuda":
        return {"device": "cpu", "power_limit_w": None, "rig_canary_tflops": None,
                "rig_canary_frac_peak": None}
    name, limit = card_info()
    return {"device": name or torch.cuda.get_device_name(device), "power_limit_w": limit,
            "rig_canary_tflops": None if canary is None else canary["tflops"],
            "rig_canary_frac_peak": None if canary is None else canary["frac_of_peak"]}


def canary_keys(device: torch.device) -> Dict:
    """``card_keys`` with the canary run now, in this process (a tiny one on
    the CPU, whose numbers the line does not carry)."""
    from rau_vqa_tpu_torch.utils.rigcheck import matmul_canary

    canary = matmul_canary(device=device)
    log(f"rig canary {canary['tflops']:.1f} TFLOP/s on {canary['device']}")
    return card_keys(device, canary)


def run_script(metric: str, unit: str, device: torch.device, body: Callable[[], Dict],
               timeout_s: float = 2400.0) -> int:
    """Arm the watchdog, probe the card, run ``body`` and print its line, with
    the seconds of the probe (``preflight_s``) and of the body (``body_s``),
    kept as a record where it was measured on the card; exit code 3 with the
    error line when the card is absent or hung."""
    from rau_vqa_tpu_torch.utils.rigcheck import bench_preflight, bench_watchdog, record

    watchdog = bench_watchdog(metric, unit, timeout_s)
    try:
        t0 = time.perf_counter()
        bench_preflight(metric, unit, device)
        t1 = time.perf_counter()
        line = body()
        line.update(preflight_s=round(t1 - t0, 3), body_s=round(time.perf_counter() - t1, 3))
    finally:
        watchdog.cancel()
    print(json.dumps(line), flush=True)
    if device.type == "cuda" and line.get("metric"):
        record(line)
    return 0
