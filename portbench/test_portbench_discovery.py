"""A new configuration, cell, driver and per-layer metric are found by name
from new files and new entries in BENCHMARK.json, with no existing file of
the benchmark edited."""

from __future__ import annotations

import hashlib
import os

ECHO_DRIVER = '''
from types import SimpleNamespace


def setup(ctx):
    return SimpleNamespace(n=ctx.cell["traffic"]["terms"], total=0)


def step(st, i):
    st.total += sum(range(st.n))


def drain(st):
    pass


def metrics(st, steps, window_s):
    return {"echo_sums_per_s": steps / window_s}


def work(st, i):
    return {"terms": float(st.n)}


def check(st):
    return [("echo_total_wrong", 0.0 if st.total % (st.n * (st.n - 1) // 2) == 0 else 1.0, 0.0)]
'''

ECHO_METRIC = '''
def read(view):
    return view.work["terms"] / view.steps if view.steps else None
'''


def _digests(folder):
    out = {}
    for base, _, files in os.walk(folder):
        for f in files:
            p = os.path.join(base, f)
            with open(p, "rb") as fh:
                out[p] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_new_config_cell_driver_and_metric_need_only_new_files(tiny_bench):
    before = _digests(tiny_bench.bench)
    with open(tiny_bench.path("drivers", "echo.py"), "w") as f:
        f.write(ECHO_DRIVER)
    with open(tiny_bench.path("metrics", "echo.terms_per_step.py"), "w") as f:
        f.write(ECHO_METRIC)
    tiny_bench.save({"name": "echo_cfg"}, "configs", "echo_cfg.json")
    tiny_bench.save({"name": "echo_cfg.sums", "config": "echo_cfg", "driver": "echo", "chips": 1,
                     "why": "a test cell", "traffic": {"terms": 50}, "limits": {}},
                    "cells", "echo_cfg.sums.json")
    spec = tiny_bench.spec()
    spec["configs"].append({"name": "echo_cfg", "source": "https://example.org/echo",
                            "file": "portbench/configs/echo_cfg.json", "reduced": [],
                            "why": "a test configuration"})
    spec["workloads"].append({"name": "echo_cfg.sums", "config": "echo_cfg", "traffic": "sums",
                              "chips": 1, "why": "a test cell"})
    spec["end_to_end"].append({"name": "echo_sums_per_s", "unit": "sums/s", "better": "higher",
                               "bound": 0.05, "source": "host_clock",
                               "workloads": ["echo_cfg.sums"]})
    spec["per_layer"].append({"name": "echo.terms_per_step", "unit": "terms", "better": "higher",
                              "source": "program_counter", "layer": "echo",
                              "moves": "echo_sums_per_s", "workloads": ["echo_cfg.sums"]})
    tiny_bench.save_spec(spec)

    rc, line, _ = tiny_bench.run("echo_cfg.sums", seconds=0.3)
    assert rc == 0 and line["correct"] is True
    assert set(line["metrics"]) == {"echo_sums_per_s", "setup_s"}
    assert line["metrics"]["echo_sums_per_s"]["unit"] == "sums/s"
    rc, line, _ = tiny_bench.run("echo_cfg.sums", seconds=0.3, trace=True)
    assert rc == 0
    assert line["metrics"] == {"echo.terms_per_step": {"value": 50.0, "unit": "terms"}}

    after = _digests(tiny_bench.bench)
    assert {p: d for p, d in after.items() if p in before} == before
