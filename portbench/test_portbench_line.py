"""The result line's schema, checked on tiny runs of every cell on the CPU,
and BENCHMARK.json against the rules a benchmark file keeps."""

from __future__ import annotations

import json
import os
import re

import pytest

import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _spec():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


CELLS = [w["name"] for w in _spec()["workloads"]]


@pytest.mark.parametrize("trace", [False, True], ids=["timed", "traced"])
@pytest.mark.parametrize("workload", CELLS)
def test_last_line_schema(tiny_bench, workload, trace):
    rc, line, err = tiny_bench.run(workload, seconds=1.0, trace=trace)
    assert rc == 0
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert isinstance(line["correct"], bool) and line["attempted"] > 0 and line["failed"] == 0
    e2e, layer = harness.cell_metrics(tiny_bench.spec(), workload)
    units = {m["name"]: m["unit"] for m in e2e + layer}
    if trace:
        assert set(line["metrics"]) <= {m["name"] for m in layer}
        assert {"busy_s", "window_s"} <= set(line["device"])
        bd = line["breakdown"]
        assert set(bd) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in bd.values())
    else:
        assert set(line["metrics"]) == {m["name"] for m in e2e}
    for name, m in line["metrics"].items():
        assert m["unit"] == units[name] and isinstance(m["value"], float)
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    # every number compared, beside its limit, ends stderr and the line
    tail = err.strip().splitlines()[-len(line["checks"]):]
    for (name, c), text in zip(line["checks"].items(), tail):
        assert text.startswith(f"check {name} {c['value']!r} limit {c['limit']!r}")


def test_benchmark_json_keeps_the_rules():
    spec = _spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["paths"] == ["portbench"] and spec["command"][1].startswith("portbench/")
    assert 1 <= spec["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in spec[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    configs = {c["name"] for c in spec["configs"]}
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and os.path.exists(
            os.path.join(harness.ROOT, c["file"]))
    used = set()
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    pairs = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
        cell = harness.load_json(harness.BENCH, "cells", w["name"] + ".json")
        assert cell["config"] == w["config"] and cell["chips"] == w["chips"]
        mine_e2e, mine_layer = harness.cell_metrics(spec, w["name"])
        assert "setup_s" in {m["name"] for m in mine_e2e} and len(mine_e2e) >= 2 and mine_layer
        for m in mine_layer:
            assert m["moves"] in {x["name"] for x in mine_e2e}
            assert os.path.exists(os.path.join(harness.BENCH, "metrics", m["name"] + ".py"))
    assert used == configs
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
