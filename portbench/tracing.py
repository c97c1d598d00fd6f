"""The traced run's window: ``torch.profiler`` over a steady stretch of the
measured window, and what its trace says.

The stretch starts once a share of the window has passed, after the card has
drained, and lasts ``trace_seconds`` of steps; the steps are the same calls
as in an untraced run.  The harness marks its own calls with
``record_function`` ranges (``<driver>.<what>``), which label the device's
idle gaps.  The trace is read from its Chrome JSON export, in the run's own
temporary directory.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Tuple

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def short_name(name: str, limit: int = 120) -> str:
    """A kernel's name without ``void `` and cut to ``limit`` characters."""
    name = name[5:] if name.startswith("void ") else name
    return name if len(name) <= limit else name[:limit - 3] + "..."


@dataclass
class TraceView:
    """What a per-layer reader reads: the traced stretch's steps, its length,
    the device's busy seconds in it, seconds by kernel name, the idle gaps by
    host label, and the work the driver says the traced steps asked for."""

    steps: int
    window_s: float
    busy_s: float
    kernels: Dict[str, float]
    kernel_counts: Dict[str, int]
    gaps: Dict[str, float]
    work: Dict[str, float] = field(default_factory=dict)

    def kernel_s(self, patterns: Iterable[str]) -> float:
        """Seconds of the kernels whose name matches any of ``patterns``."""
        rx = re.compile("|".join(patterns))
        return sum(s for n, s in self.kernels.items() if rx.search(n))

    def all_kernels_s(self) -> float:
        return sum(self.kernels.values())

    def idle_share(self):
        """The share of the stretch in which nothing ran on the device; None
        where the trace saw no device work."""
        if self.busy_s <= 0 or self.window_s <= 0:
            return None
        return 1.0 - self.busy_s / self.window_s

    def breakdown(self) -> Dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[short_name(n), s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


def read_trace(path: str, steps: int, work: Dict[str, float]) -> TraceView:
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    wins = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not wins:
        raise RuntimeError("the trace holds no window range")
    w0 = float(wins[0]["ts"])
    w1 = w0 + float(wins[0]["dur"])
    dev = []
    kernels: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        dev.append((a, b))
        if e["cat"] == "kernel":
            kernels[e["name"]] = kernels.get(e["name"], 0.0) + (b - a) * 1e-6
            counts[e["name"]] = counts.get(e["name"], 0) + 1
    busy = _union(dev)
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
            if e.get("cat") == "user_annotation" and e.get("name") != WINDOW]
    gaps: Dict[str, float] = {}
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        around = [(h1 - h0, name) for h0, h1, name in host if h0 <= mid <= h1]
        label = min(around)[1] if around else "host.outside_harness_calls"
        gaps[label] = gaps.get(label, 0.0) + (b - a) * 1e-6
    return TraceView(steps=steps, window_s=(w1 - w0) * 1e-6,
                     busy_s=sum(b - a for a, b in busy) * 1e-6, kernels=kernels,
                     kernel_counts=counts, gaps=gaps, work=work)


class Window:
    """The profiler over a stretch of the measured window."""

    def __init__(self, device, trace_seconds: float, seconds: float, start_share: float = 0.3):
        self.device = device
        self.trace_seconds = trace_seconds
        self.start_at = start_share * seconds
        self.prof = None
        self.range = None
        self.done = False
        self.t_start = 0.0
        self.traced_steps: List[int] = []

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    @property
    def began(self) -> bool:
        """Whether the traced stretch has begun: a window whose steps are
        too long for it to begin in time runs on until it has."""
        return self.prof is not None

    def warm(self) -> None:
        """Start and stop the profiler once in set-up, so that the stretch
        does not pay for its first start."""
        import torch
        prof = self._profile()
        prof.start()
        torch.ones(1, device=self.device).add_(1)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()

    def before(self, i: int, elapsed: float, drain) -> None:
        if self.done:
            return
        if self.prof is None:
            if elapsed < self.start_at:
                return
            import torch
            drain()
            self.prof = self._profile()
            self.prof.start()
            self.range = torch.profiler.record_function(WINDOW)
            self.range.__enter__()
            self.t_start = time.perf_counter()
        self.traced_steps.append(i)

    def after(self, drain) -> None:
        if (self.prof is not None and not self.done
                and time.perf_counter() - self.t_start >= self.trace_seconds):
            self._stop(drain)

    def _stop(self, drain) -> None:
        drain()
        self.range.__exit__(None, None, None)
        self.prof.stop()
        self.done = True

    def close(self, drain) -> None:
        if self.prof is None:
            raise RuntimeError("the window ended before the traced stretch began")
        if not self.done:
            self._stop(drain)

    def view(self, work: Dict[str, float]) -> TraceView:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            return read_trace(path, len(self.traced_steps), work)
