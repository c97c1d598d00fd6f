"""Without the cards a cell asks for, a run prints no result and exits
non-zero; it never falls back to the CPU."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


def _run(cwd):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", "ours_ms.serve_b512",
                           "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


@pytest.fixture
def no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")


def test_a_run_without_a_card_exits_nonzero_with_no_result(no_card):
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_a_run_without_the_program_exits_nonzero(no_card, tmp_path):
    shutil.copytree(BENCH, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
