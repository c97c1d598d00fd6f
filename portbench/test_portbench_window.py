"""The end-to-end metrics are all the work over all the window's time and
the tail of every request: a stall that a median of chunks would hide
shows in them."""

from __future__ import annotations

import statistics
from types import SimpleNamespace

import numpy as np

import harness

STALL_DRIVER = '''
import time
from types import SimpleNamespace


def setup(ctx):
    return SimpleNamespace(times=[])


def step(st, i):
    t0 = time.perf_counter()
    time.sleep(0.4 if i == 20 else 0.004)
    st.times.append(time.perf_counter() - t0)


def drain(st):
    pass


def metrics(st, steps, window_s):
    return {"stall_steps_per_s": steps / window_s}


def work(st, i):
    return {}


def check(st):
    return [("nothing", 0.0, 0.0)]
'''


def test_rate_is_all_steps_over_the_whole_window_with_its_stall(tiny_bench):
    with open(tiny_bench.path("drivers", "stall.py"), "w") as f:
        f.write(STALL_DRIVER)
    tiny_bench.save({"name": "stall_cfg"}, "configs", "stall_cfg.json")
    tiny_bench.save({"name": "stall_cfg.one", "config": "stall_cfg", "driver": "stall", "chips": 1,
                     "traffic": {}, "limits": {"nothing": 0.0}}, "cells", "stall_cfg.one.json")
    spec = tiny_bench.spec()
    spec["end_to_end"].append({"name": "stall_steps_per_s", "unit": "steps/s", "better": "higher",
                               "bound": 0.05, "source": "host_clock",
                               "workloads": ["stall_cfg.one"]})
    tiny_bench.save_spec(spec)
    rc, line, _ = tiny_bench.run("stall_cfg.one", seconds=1.0)
    assert rc == 0
    rate = line["metrics"]["stall_steps_per_s"]["value"]
    steps = line["attempted"]
    # all the steps over at least the whole window, the stall included
    assert rate <= steps / 1.0 + 1e-9
    # a median of the per-step rates, or of chunks of steps, would not see it
    median_rate = 1.0 / 0.0045
    assert rate < 0.8 * median_rate


def test_pixels_p95_is_over_every_request(tiny_bench):
    driver = harness.load_module("drivers", "pixels")
    lat = [0.010] * 94 + [0.500] * 6                      # six stalled requests of 100
    st = SimpleNamespace(latencies=lat, inp=SimpleNamespace(B=120))
    m = driver.metrics(st, len(lat), sum(lat))
    assert m["pixels_p95_ms"] == np.percentile(np.asarray(lat), 95) * 1e3
    assert m["pixels_p95_ms"] > 100.0
    chunks = [statistics.median(lat[i:i + 10]) for i in range(0, 100, 10)]
    assert statistics.median(chunks) * 1e3 < 11.0       # what a median of chunks reads
    assert m["pixels_images_per_s"] == 100 * 120 / sum(lat)
