"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's folder
with its configurations cut to a tiny size, which the harness runs on the
CPU through the program's plain versions (the look for a card skipped).

    python -m pytest portbench -q

Tests marked ``cuda`` run only where a card is present (they decide inside
a fixture) and skip here.
"""

from __future__ import annotations

import io
import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

import harness  # noqa: E402

TINY = dict(vocab_size=50, embed_dim=8, rnn_size=16, multfeat_dim=16, attfeat_dim=8,
            att_rnn_size=16, answer_size=10, n_hops=3, seq_len=6)
TINY_LENGTHS = {"1": 0.2, "3": 0.5, "6": 0.3}


class TinyBench:
    """A tiny copy of the benchmark; ``run`` drives one cell through
    ``harness.run`` on the CPU and returns (exit code, the parsed last line
    of stdout or None, stderr)."""

    def __init__(self, root: str):
        self.root = root
        self.bench = os.path.join(root, "portbench")

    def path(self, *parts) -> str:
        return os.path.join(self.bench, *parts)

    def load(self, *parts) -> dict:
        with open(self.path(*parts)) as f:
            return json.load(f)

    def save(self, obj, *parts) -> None:
        with open(self.path(*parts), "w") as f:
            json.dump(obj, f, indent=1)

    def spec(self) -> dict:
        with open(os.path.join(self.root, "BENCHMARK.json")) as f:
            return json.load(f)

    def save_spec(self, spec) -> None:
        with open(os.path.join(self.root, "BENCHMARK.json"), "w") as f:
            json.dump(spec, f, indent=1)

    def run(self, workload: str, seed: int = 2 ** 31 + 11, seconds: float = 0.5,
            trace: bool = False):
        out, err = io.StringIO(), io.StringIO()
        rc = harness.run(workload, seed, seconds, trace, out=out, err=err, device="cpu")
        lines = out.getvalue().strip().splitlines()
        line = json.loads(lines[-1]) if lines else None
        return rc, line, err.getvalue()


@pytest.fixture
def tiny_bench(tmp_path, monkeypatch):
    root = str(tmp_path)
    shutil.copytree(BENCH, os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "test_*.py", "conftest.py"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    tb = TinyBench(root)
    for name in os.listdir(tb.path("configs")):
        c = tb.load("configs", name)
        c.update(TINY)
        c["assumed"]["question_length_probs"] = TINY_LENGTHS
        if "backbone" in c:
            c.update(image_size=64, cnn_w=2, cnn_h=2)
        else:
            c.update(cnn_w=3, cnn_h=3, cnn_dim=8)
        tb.save(c, "configs", name)
    for name in os.listdir(tb.path("cells")):
        c = tb.load("cells", name)
        c["traffic"].update(batch=4, pool_batches=4)
        tb.save(c, "cells", name)
    monkeypatch.setattr(harness, "BENCH", tb.bench)
    monkeypatch.setattr(harness, "ROOT", root)
    return tb


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    return torch.device("cuda")
