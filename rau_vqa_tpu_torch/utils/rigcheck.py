"""Rig health for the benches: a bf16 canary, a deadline, a device preflight.

Counterpart of ``rau_vqa_tpu/utils/rigcheck.py`` (:27-334).  A bench number is
only as good as the card it was taken on: ``matmul_canary`` times a chained
bf16 4096 x 4096 product in the same process and reports its TFLOP/s against
the H100's published 989 TFLOP/s dense bf16 peak, beside the card's name and
power limit (a card set below 700 W runs slower under load).
``bench_watchdog`` ends a bench that never finishes with one parseable
error line; ``bench_preflight`` probes the card in a subprocess with a
timeout before the bench touches it.  In place of the JAX package's
persistent compile cache, the benches build every kernel
(``ops/_build.build_all``) before the timed window and report its seconds
as ``compile_s``.  ``StallWatchdog`` is the progress deadline of long device
jobs.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from typing import Dict, Optional, Tuple

import torch

from rau_vqa_tpu_torch.utils.flops import H100_BF16_FLOPS

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the benches' own lines on the card, newest last (kept beside the built kernels)
RECORDS = os.path.join(_PKG, "_build", "bench_records.jsonl")


def card_info() -> Tuple[Optional[str], Optional[float]]:
    """(the card's name, its power limit in W) from ``nvidia-smi``, or
    (None, None) where there is no card or no ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60, check=True).stdout
        name, limit = out.strip().splitlines()[0].rsplit(",", 1)
        return name.strip(), float(limit)
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None, None


def matmul_canary(n: Optional[int] = None, iters: Optional[int] = None,
                  rounds: int = 3, device=None) -> Dict:
    """Time ``iters`` chained bf16 [n, n] @ [n, n] products, each one's
    operand the previous one's product; the best of ``rounds`` (contention
    only slows the card down).  On the card: 4096 and 400 by default (about
    55 TFLOP, ~60 ms at the peak), timed with CUDA events; on the CPU 512
    and 4, a smoke of the code only.

    Returns {"tflops", "frac_of_peak", "ms_per_matmul", "device",
    "power_limit_w"}; ``frac_of_peak`` is against the 989 TFLOP/s dense
    bf16 peak on the card and None on the CPU."""
    device = torch.device(device or ("cuda" if torch.cuda.is_available() else "cpu"))
    on_card = device.type == "cuda"
    n = n or (4096 if on_card else 512)
    iters = iters or (400 if on_card else 4)
    gen = torch.Generator(device).manual_seed(0)
    a0 = torch.randn(n, n, generator=gen, device=device).to(torch.bfloat16)
    # entries of variance 1/n: a product keeps its operand's scale in
    # expectation, so the chain needs no rescaling pass between products
    b = (torch.randn(n, n, generator=gen, device=device) / n ** 0.5).to(torch.bfloat16)

    def chain(salt: float):
        a = a0 + salt
        for _ in range(iters):
            a = a @ b
        return a

    chain(0.0)
    best = float("inf")
    for r in range(rounds):
        if on_card:
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            chain(1e-3 * (r + 1))
            end.record()
            end.synchronize()
            secs = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            chain(1e-3 * (r + 1))
            secs = time.perf_counter() - t0
        best = min(best, secs)
    sec_per_mm = best / iters
    tflops = 2.0 * n ** 3 / sec_per_mm / 1e12
    name, limit = card_info() if on_card else ("cpu", None)
    return {"tflops": tflops,
            "frac_of_peak": tflops * 1e12 / H100_BF16_FLOPS if on_card else None,
            "ms_per_matmul": sec_per_mm * 1e3,
            "device": name or str(device), "power_limit_w": limit}


def record(line: Dict) -> None:
    """Keep a bench's result line measured on the card, for
    ``_last_recorded``."""
    os.makedirs(os.path.dirname(RECORDS), exist_ok=True)
    with open(RECORDS, "a") as f:
        f.write(json.dumps(line) + "\n")


def _last_recorded(metric: str, path: Optional[str] = None):
    """The newest result of ``metric`` that a bench of the port measured on
    the card and kept (``record``), as {"value", "device",
    "power_limit_w"}, or None.  Never the JAX package's TPU records
    (``benchmarks/*.json``): they say nothing about the card.  Never raises:
    it only decorates a failure line."""
    last = None
    try:
        with open(path or RECORDS) as f:
            for raw in f:
                try:
                    m = json.loads(raw)
                except ValueError:
                    continue
                if m.get("metric") == metric and "error" not in m and m.get("power_limit_w"):
                    last = {k: m.get(k) for k in ("value", "device", "power_limit_w")}
    except OSError:
        return None
    return last


def _emit_error_line(metric: str, unit: str, error: str, note: str) -> None:
    """The bench's failure line, one schema for the watchdog and the
    preflight: ``value`` 0.0 (nothing was measured) and, where the port has
    measured the metric on the card before, ``last_measured``."""
    line = {"metric": metric, "value": 0.0, "unit": unit, "error": error}
    last = _last_recorded(metric)
    if last is not None:
        line["last_measured"] = last
    print(json.dumps(line), flush=True)
    sys.stderr.write(note + "\n")
    sys.stderr.flush()


def bench_watchdog(metric: str, unit: str, timeout_s: float = 2400.0):
    """Arm a deadline: a bench without a result within ``timeout_s`` prints
    its error line and ends with exit code 3.  A daemon timer and
    ``os._exit``: a device call that never returns blocks in native code,
    where no exception reaches it.  Returns the timer; ``.cancel()`` it once
    the result is out."""
    def _fire():
        _emit_error_line(metric, unit,
                         f"watchdog: no result within {timeout_s:.0f}s: the device is "
                         f"hung or unreachable (diagnose with `python -m "
                         f"rau_vqa_tpu_torch.cli doctor`)",
                         "bench: watchdog fired, aborting")
        os._exit(3)

    t = threading.Timer(timeout_s, _fire)
    t.daemon = True
    t.start()
    return t


def bench_preflight(metric: str, unit: str, device="cuda",
                    timeout_s: float = 240.0) -> Dict:
    """Probe the card before the bench touches it: ``torch.cuda.is_available()``
    and one dispatch, in a subprocess with a timeout (``doctor._probe``).  A
    card that is absent, hung or failing gives the error line and exit code
    3.  A process asked for the CPU (``device="cpu"``) is not probed; a
    process that has already run work on the card has its answer."""
    if torch.device(device).type == "cpu":
        return {"status": "ok", "platform": "cpu"}
    if torch.cuda.is_initialized():
        return {"status": "ok", "platform": "cuda", "n": torch.cuda.device_count(),
                "kind": torch.cuda.get_device_name(0), "exec": "in process"}
    from rau_vqa_tpu_torch.utils.doctor import _DEVICE_PROBE, _probe

    r = _probe(_DEVICE_PROBE.format(device="cuda"), timeout_s)
    if r["status"] == "ok" and r.get("platform") != "cuda":
        r = {"status": "error", "detail": f"the probe ran on {r.get('platform')!r}, not a card"}
    if r["status"] != "ok":
        _emit_error_line(metric, unit,
                         f"preflight: device probe {r['status']} ({r.get('detail', '')}); "
                         f"diagnose with `python -m rau_vqa_tpu_torch.cli doctor`",
                         "bench: device preflight failed, aborting")
        raise SystemExit(3)
    return r


class StallWatchdog:
    """If ``poke()`` is not called within ``timeout_s``, print a diagnosis
    and end the process with exit code 3: a device call that never returns
    blocks inside native code, where no exception can reach it, so a daemon
    timer and ``os._exit`` are the only sure way out.  Re-armed on every unit
    of progress, so a job may run as long as it keeps moving.
    ``timeout_s <= 0`` disables it."""

    def __init__(self, what: str, timeout_s: float = 900.0):
        self.what = what
        self.timeout_s = float(timeout_s)
        self._timer = None
        self.poke()

    def _fire(self):
        sys.stderr.write(f"{self.what}: no progress within {self.timeout_s:.0f}s; "
                         f"the device or the image decode is stuck\n")
        sys.stderr.flush()
        os._exit(3)

    def poke(self) -> None:
        if self.timeout_s <= 0:
            return
        if self._timer is not None:
            self._timer.cancel()
        self._timer = threading.Timer(self.timeout_s, self._fire)
        self._timer.daemon = True
        self._timer.start()

    def cancel(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
