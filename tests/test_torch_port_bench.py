"""CPU smokes of the port's benches (bench_torch.py, bench_torch_pixels.py,
rau_vqa_tpu_torch/bench{,_pixels}.py) and of ``profile``.

Each bench prints one JSON line: the metric, its value and unit, the spread,
the compile and upload seconds, the canary, ``mfu``, ``device`` and
``power_limit_w``; no ``vs_baseline`` (the JAX package's TPU north star says
nothing about the card).  On the CPU the device metrics are null.
``--artifact`` runs twice: the first builds the chain artifact, the second
reuses it.  The root scripts run in a subprocess, as a user runs them; the
other runs call ``main`` in this process at tiny batches.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from rau_vqa_tpu_torch import bench, bench_pixels
from rau_vqa_tpu_torch import cli as tcli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {"metric", "value", "unit", "spread", "compile_s", "compile_first_s",
        "operand_upload_s", "rig_canary_tflops", "rig_canary_frac_peak", "mfu",
        "device", "power_limit_w", "step_ms", "flops_per_step", "batch", "chain", "rounds"}
SMALL = {"RAU_BENCH_B": "4", "RAU_BENCH_K": "2", "RAU_BENCH_ROUNDS": "2"}
ONE_THREAD = {**os.environ, "OMP_NUM_THREADS": "1"}   # beside the other test workers
PIXELS = ["--batch", "1", "--qpi", "2", "--chain", "2", "--rounds", "1", "--size", "64"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread a test process (restored after), so that the
    parallel test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def last_json(text: str):
    return json.loads(text.strip().splitlines()[-1])


def check_line(line, metric, **want):
    assert KEYS <= set(line), KEYS - set(line)
    assert "vs_baseline" not in line and "error" not in line
    assert line["metric"] == metric and line["unit"] == "questions/sec"
    assert line["value"] > 0 and line["spread"] >= 0 and line["flops_per_step"] > 0
    # measured on the host: no device metric
    assert line["device"] == "cpu" and line["power_limit_w"] is None
    assert line["mfu"] is None and line["rig_canary_tflops"] is None
    for k, v in want.items():
        assert line[k] == v, k


def test_bench_torch_root_script_cpu_smoke():
    proc = subprocess.run([sys.executable, "bench_torch.py", "--device", "cpu"], cwd=REPO,
                          env={**ONE_THREAD, **SMALL}, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    check_line(last_json(proc.stdout), "vqa_questions_per_sec_per_chip",
               batch=4, chain=2, rounds=2)


def test_bench_pixels_root_script_cpu_smoke():
    proc = subprocess.run([sys.executable, "bench_torch_pixels.py", "--device", "cpu",
                           *PIXELS], cwd=REPO, env=ONE_THREAD, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = last_json(proc.stdout)
    check_line(line, "pixels_questions_per_sec_per_chip", batch=1, chain=2,
               backbone="resnet101", fused_stages=[0, 1, 2, 3], questions_per_image=2)
    assert line["images_per_sec"] == pytest.approx(line["value"] / 2, rel=0.01)


def test_bench_artifact_built_once_then_reused(tmp_path, monkeypatch, capsys):
    for k, v in SMALL.items():
        monkeypatch.setenv(k, v)
    art = str(tmp_path / "chain")
    for built in (True, False):
        assert tcli.main(["--device", "cpu", "bench", "--artifact", art]) == 0
        out = capsys.readouterr()
        check_line(last_json(out.out), bench.METRIC, artifact=True, batch=4)
        assert ("building chain artifact" in out.err) == built
    with open(os.path.join(art, "meta.json")) as f:
        meta = json.load(f)
    assert (meta["kind"], meta["batch"], meta["chain"], meta["fused"]) == (
        "serve_chain", 4, 2, True)


def test_bench_pixels_artifact_built_once_then_reused(tmp_path, capsys):
    art = str(tmp_path / "pchain")
    for built in (True, False):
        assert bench_pixels.main(["--device", "cpu", "--backbone", "vgg16", *PIXELS,
                                  "--artifact", art]) == 0
        out = capsys.readouterr()
        check_line(last_json(out.out), bench_pixels.METRIC, artifact=True,
                   backbone="vgg16", fused_stages=[])
        assert ("building chain artifact" in out.err) == built


@pytest.mark.parametrize("argv,match", [
    (["--s2d", "--no-fold-bn"], "--s2d needs the folded"),
    (["--s2d", "--int8"], "--s2d needs the folded"),
    (["--int8", "--no-fold-bn"], "--int8 quantizes the folded tree"),
    (["--int8", "--backbone", "vgg16"], "resnet101 variants"),
    (["--s2d", "--backbone", "vit"], "resnet101 variants"),
    (["--int8", "--artifact"], "--artifact does not take --int8"),
    (["--int8", "--fused-stages", "0"], "no --int8/--s2d"),
    (["--s2d", "--fused-stages", "1,2"], "no --int8/--s2d"),
    (["--fused-stages", "1,7"], "indices must be in 0..3"),
    (["--no-fold-bn", "--fused-stages", "2"], "needs the folded resnet101"),
    (["--backbone", "vgg16", "--no-fold-bn"], "resnet101 variant"),
])
def test_bench_pixels_refusals(argv, match):
    with pytest.raises(SystemExit, match=match):
        bench_pixels.main(["--device", "cpu", *argv])


@pytest.mark.parametrize("variant", ["--s2d", "--int8"])
def test_bench_pixels_variants_cpu_smoke(variant, capsys):
    """The s2d stem and the int8 backbone each print a well-formed line,
    without the stage kernel, flagged as the variant."""
    assert bench_pixels.main(["--device", "cpu", variant, *PIXELS]) == 0
    line = last_json(capsys.readouterr().out)
    check_line(line, bench_pixels.METRIC, backbone="resnet101", fused_stages=[], batch=1,
               s2d=variant == "--s2d", int8=variant == "--int8")


def test_bench_without_a_card_exits_3_with_the_error_line(monkeypatch, capsys):
    """The card by default: without one the preflight's probe fails and the
    bench prints its error line (no vs_baseline) and exits 3."""
    from rau_vqa_tpu_torch.utils import doctor
    monkeypatch.setattr(doctor, "_probe", lambda code, t: {
        "status": "error", "detail": "RuntimeError: torch.cuda.is_available() is False"})
    with pytest.raises(SystemExit) as ex:
        bench.main(["--batch", "2"])
    assert ex.value.code == 3
    line = last_json(capsys.readouterr().out)
    assert line["value"] == 0.0 and "is_available" in line["error"]
    assert "vs_baseline" not in line


def test_profile_cpu_writes_a_trace(tmp_path, capsys):
    out = str(tmp_path / "trace")
    assert tcli.main(["--device", "cpu", "profile", "--preset", "ours_ms", "--out", out,
                      "--steps", "2", "--batch-size", "4", "--nhop", "2", "--cnnout-w", "2",
                      "--cnnout-h", "2", "--cnnout-dim", "16"]) == 0
    with open(os.path.join(out, "trace.json")) as f:
        trace = json.load(f)
    assert trace["traceEvents"]
    printed = capsys.readouterr().out
    assert "traced 2 steps" in printed
    # the last line: the step's time untraced and traced, each span a step
    line = json.loads(printed.strip().splitlines()[-1])
    assert line["steps"] == 2 and line["untraced_step_ms"] > 0 and line["traced_step_ms"] > 0
    assert line["spans_a_step"]["trainer.step"]["calls"] == 1.0
    assert line["spans_a_step"]["trainer.adam"]["calls"] == 3.0
