"""The harness: one run of one cell, found by name from data.

``run`` reads ``BENCHMARK.json`` at the checkout's root for the metrics a
cell reports, ``cells/<cell>.json`` for its configuration, driver, traffic
and limits, ``configs/<config>.json`` for the model's sizes, imports
``drivers/<driver>.py`` for the traffic and ``metrics/<metric>.py`` for each
per-layer metric.  A new cell, configuration, kind of traffic or per-layer
metric is a new file and a new entry in ``BENCHMARK.json``.

A driver module defines:

- ``setup(ctx) -> state``: build the program's objects, make the weights and
  inputs from the seed, warm up every shape the cell uses;
- ``step(state, i)``: the window's i-th unit of work (a batch, a request, a
  training step);
- ``drain(state)``: wait until every step enqueued has finished on the card;
- ``metrics(state, steps, window_s) -> {end-to-end metric: value}``;
- ``work(state, i) -> {quantity: value}``: what step i asks of the card
  (operations, least seconds of a kernel), summed over the traced steps for
  the per-layer readers;
- ``check(state) -> [(name, value, limit)]``: the comparison of what the
  window produced with the plain reference, after the window.

A metric module defines ``read(view) -> float or None`` over a
``tracing.TraceView``; None leaves the metric out of the result.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import tracing

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "rau_vqa_tpu")


def process_start() -> float:
    """The wall-clock time this process started, from /proc (0.01 s ticks);
    now, where /proc does not say."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


def load_json(*parts) -> Dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark's folder, imported by path."""
    path = os.path.join(BENCH, kind, name + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or the
    JAX package's, compared whole (the port's name begins with the JAX
    package's)."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


class Sizes:
    """A configuration's sizes as attributes, with the model's derived ones
    (the names of the program's ``ModelConfig``)."""

    def __init__(self, config: Dict):
        self.__dict__.update({k: v for k, v in config.items() if not isinstance(v, dict)})

    @property
    def rnnout_dim(self) -> int:
        return 2 * self.rnn_size * self.rnn_layers

    @property
    def att_state_dim(self) -> int:
        return self.att_rnn_size * self.att_rnn_layers

    @property
    def cnn_spat(self) -> int:
        return self.cnn_w * self.cnn_h


def model_config(config: Dict):
    """The program's ``ModelConfig`` with every field the configuration's
    file sets (imported here, so that the harness loads the program only in
    a run)."""
    import dataclasses

    from rau_vqa_tpu_torch.config import ModelConfig
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in config.items() if k in names})


@dataclass
class Context:
    """What a driver's ``setup`` is given."""

    workload: str
    seed: int
    seconds: float
    trace: bool
    cell: Dict
    config: Dict
    sizes: Sizes
    device: object


def cell_metrics(spec: Dict, workload: str):
    """(end-to-end metrics, per-layer metrics) that ``BENCHMARK.json`` asks
    of this cell: those whose ``workloads`` list it, or that have none."""
    def mine(m):
        return "workloads" not in m or workload in m["workloads"]
    return ([m for m in spec["end_to_end"] if mine(m)],
            [m for m in spec["per_layer"] if mine(m)])


def _finite(v) -> bool:
    return isinstance(v, (int, float)) and math.isfinite(v)


def run(workload: str, seed: int, seconds: float, trace: bool, *, out=None, err=None,
        device: Optional[str] = None, started: Optional[float] = None) -> int:
    """One run of ``workload``; prints its result line; returns the exit
    code.  ``device`` other than None skips the look for a card (the CPU
    tests' way to drive the rest of a run)."""
    out = out or sys.stdout
    err = err or sys.stderr
    started = process_start() if started is None else started

    def log(msg):
        print(msg, file=err, flush=True)

    spec = load_json(ROOT, "BENCHMARK.json")
    cell = load_json(BENCH, "cells", workload + ".json")
    config = load_json(BENCH, "configs", cell["config"] + ".json")
    e2e_specs, layer_specs = cell_metrics(spec, workload)

    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            log(f"portbench: {workload} needs {cell['chips']} CUDA device(s), found {have}; "
                f"no result")
            return 3
        dev = torch.device("cuda")
    else:
        dev = torch.device(device)

    ctx = Context(workload, seed, seconds, trace, cell, config, Sizes(config), dev)
    driver = load_module("drivers", cell["driver"])
    readers = {m["name"]: load_module("metrics", m["name"]) for m in layer_specs} if trace else {}
    state = driver.setup(ctx)
    window = tracing.Window(dev, cell.get("trace_seconds", 2.0), seconds) if trace else None
    if window is not None:
        window.warm()
    setup_s = time.time() - started

    steps, t0 = 0, time.perf_counter()
    while True:
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds and (window is None or window.began):
            break
        if window is not None:
            window.before(steps, elapsed, lambda: driver.drain(state))
        driver.step(state, steps)
        steps += 1
        if window is not None:
            window.after(lambda: driver.drain(state))
    driver.drain(state)
    window_s = time.perf_counter() - t0
    if window is not None:
        window.close(lambda: driver.drain(state))

    memory_peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0)
    e2e = driver.metrics(state, steps, window_s)
    e2e["setup_s"] = setup_s
    view = None
    if window is not None:
        work: Dict[str, float] = {}
        for i in window.traced_steps:
            for k, v in driver.work(state, i).items():
                work[k] = work.get(k, 0.0) + v
        view = window.view(work)
    checks = driver.check(state)
    del state
    gc.collect()

    found = forbidden_modules()
    if found:
        log(f"portbench: the run loaded {', '.join(found)}, which nothing it runs may "
            f"import; no result")
        return 4

    metrics: Dict[str, Dict] = {}
    if trace:
        for m in layer_specs:
            v = readers[m["name"]].read(view)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in e2e_specs:
            if m["name"] not in e2e:
                log(f"portbench: the {cell['driver']} driver gives no {m['name']}; no result")
                return 5
            metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}

    correct = all(_finite(v) and v <= limit for _, v, limit in checks) and bool(checks)
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": cell["chips"], "memory_peak_bytes": int(memory_peak)}
    result = {"correct": correct, "attempted": steps, "failed": 0, "metrics": metrics,
              "device": device_info}
    if view is not None:
        device_info["busy_s"] = view.busy_s
        device_info["window_s"] = view.window_s
        result["breakdown"] = view.breakdown()
    result["checks"] = {name: {"value": v, "limit": limit} for name, v, limit in checks}
    for name, v, limit in checks:
        log(f"check {name} {v!r} limit {limit!r} {'ok' if _finite(v) and v <= limit else 'FAIL'}")
    print(json.dumps(result), file=out, flush=True)
    return 0
