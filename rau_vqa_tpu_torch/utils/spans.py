"""Named spans at the port's layer boundaries, recorded only under a profiler.

``span(name)`` is ``torch.profiler.record_function(name)`` while a profiler
records (``torch.profiler.profile``: ``cli profile``, the ``Trainer``'s
``profile_dir`` epoch, a benchmark's traced stretch) and a shared
``contextlib.nullcontext()`` otherwise.  The check is a module flag that
PyTorch sets when a profiler starts (about 0.05-0.1 us); entering
``record_function`` costs about 8 us even with no profiler running, so it
is never entered then.

The spans are the profiler's own ``user_annotation`` events, on the same
clock as the device's kernels and the CUDA runtime calls in its trace, kept
in the profiler's memory until it exports.  Nesting gives each span its
parent; an entry point's top-level span (``predict.step``,
``pipeline.answer_pixels``, ``trainer.step``) marks one call.  Nothing is
recorded by a span that a profiler would not record, and a span changes no
value it encloses.  ``read_spans`` reads them back from the trace: by span
name, the host's time, the device's idle time and the host-blocking CUDA
calls in it (``cli profile`` prints it a step).
"""

from __future__ import annotations

import bisect
import contextlib
import json
from typing import Dict, List, Tuple

import torch

_OFF = contextlib.nullcontext()
_profiler = torch.autograd.profiler

if hasattr(_profiler, "_is_profiler_enabled"):
    def profiling() -> bool:
        """Whether a profiler is recording in this process."""
        return _profiler._is_profiler_enabled
else:                                   # a PyTorch without the Python flag
    def profiling() -> bool:
        """Whether a profiler is recording in this process."""
        return torch._C._autograd._profiler_enabled()


def span(name: str):
    """A context manager that records ``name`` as a range while a profiler
    records, and does nothing otherwise."""
    if profiling():
        return torch.profiler.record_function(name)
    return _OFF


# what a profiler's Chrome trace calls the device's work, and the CUDA
# runtime and driver calls that hold the host until the card has caught up
# (a pageable copy shows as ``cudaMemcpyAsync`` then ``cudaStreamSynchronize``)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
BLOCKING_CATS = ("cuda_runtime", "cuda_driver")
BLOCKING_CALLS = frozenset((
    "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
    "cudaMemcpy", "cudaMemcpy2D", "cudaMemcpyToSymbol", "cudaMemcpyFromSymbol",
    "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize",
    "cuMemcpy", "cuMemcpyDtoH", "cuMemcpyDtoH_v2", "cuMemcpyHtoD", "cuMemcpyHtoD_v2",
    "cuMemcpyDtoD", "cuMemcpyDtoD_v2", "cuMemcpy2D", "cuMemcpy2D_v2"))


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _overlap(xs: List[Tuple[float, float]], ys: List[Tuple[float, float]]) -> float:
    """The length of the overlap of two sorted lists of disjoint intervals."""
    total, j = 0.0, 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k = j
        while k < len(ys) and ys[k][0] < b:
            total += min(b, ys[k][1]) - max(a, ys[k][0])
            k += 1
    return total


def read_spans(path: str) -> Dict[str, Dict]:
    """Each span name in a profiler's Chrome trace (``export_chrome_trace``):
    ``calls``, its ranges; ``host_ms``, the time they cover; ``idle_ms``,
    the part of it in which no kernel, copy or set ran on the device (None
    where the trace holds no device work, as on the CPU); ``blocking``, the
    host-blocking CUDA calls (``BLOCKING_CALLS``) that start in it.  A name
    nested in itself, or repeated, counts its time once."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]

    def interval(e):
        return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))

    busy = _union([interval(e) for e in events if e.get("cat") in DEVICE_CATS])
    starts = sorted(float(e["ts"]) for e in events
                    if e.get("cat") in BLOCKING_CATS and e.get("name") in BLOCKING_CALLS)
    ranges: Dict[str, List[Tuple[float, float]]] = {}
    for e in events:
        if e.get("cat") == "user_annotation":
            ranges.setdefault(e["name"], []).append(interval(e))
    out = {}
    for name, iv in ranges.items():
        merged = _union(iv)
        host = sum(b - a for a, b in merged)
        out[name] = {
            "calls": len(iv), "host_ms": host * 1e-3,
            "idle_ms": (host - _overlap(merged, busy)) * 1e-3 if busy else None,
            "blocking": sum(bisect.bisect_left(starts, b) - bisect.bisect_left(starts, a)
                            for a, b in merged)}
    return out
