"""The port's rig tools (rau_vqa_tpu_torch/utils/{dashboard,file_utils,
rigcheck,doctor}.py and the ``doctor`` / ``dashboard`` commands) against the
JAX package's, on the CPU.

The counterparts of tests/test_observability.py:116-380: the dashboard's
page (byte for byte the JAX page for the same run directory, sparklines and
the attention browser included), its file routes and their escape refusal;
``file_utils``' bytes equal to JAX's; the canary; the watchdog's and the
preflight's error line (no ``vs_baseline``; ``last_measured`` only from the
port's own records on the card, never the TPU records under benchmarks/);
the doctor's probe outcomes, report and ``--watch``; and ``native_images``
reported but not counted against ``healthy``.  The JAX compile-cache case
(:380-) has no counterpart: the port builds its kernels before a bench's
timed window instead (``compile_s``).
"""

import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from http.server import HTTPServer

import numpy as np
import pytest

from rau_vqa_tpu.utils import dashboard as jdash
from rau_vqa_tpu.utils import file_utils as jfu
from rau_vqa_tpu.utils.logging import MetricsLogger as JLogger
from rau_vqa_tpu_torch import cli as tcli
from rau_vqa_tpu_torch.utils import dashboard as tdash
from rau_vqa_tpu_torch.utils import doctor, rigcheck
from rau_vqa_tpu_torch.utils import file_utils as tfu
from rau_vqa_tpu_torch.utils.logging import MetricsLogger, per_hop_record
from rau_vqa_tpu_torch.utils.visatt import dump_attention_maps
from tests.test_torch_port_trainer import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_dir(root):
    """A run directory with train/test records and visatt dumps."""
    wd = str(root)
    log = MetricsLogger(os.path.join(wd, "training_log"))
    for e in range(5):
        log.log({"epoch": e + 1, "loss": 3.0 - 0.3 * e, "uni_acc": 0.2 * e,
                 "select_acc": 0.1 * e, "examples_per_sec": 100.0 + e,
                 **per_hop_record({"trainacc": [0.5 + 0.01 * e]})}, kind="train")
        log.log({"epoch": e + 1, "testOEacc_01": 0.1 * e}, kind="test")
    att = np.random.RandomState(0).rand(3, 2, 6).astype(np.float32)
    dump_attention_maps(os.path.join(wd, "figures"), 1.0, att, [7, 9], 3, 2)
    return wd


def test_dashboard_page_is_the_jax_page(tmp_path):
    wd = run_dir(tmp_path)
    page = tdash._page(wd, 1)
    assert page == jdash._page(wd, 1)
    assert "<svg" in page and "polyline" in page and "matplotlib" not in page
    assert tdash._attention_browser(wd) == jdash._attention_browser(wd)
    assert "epoch_001/hop_001/7.png" in tdash._attention_browser(wd)
    for series in ([], [1.0, float("nan"), 2.0, 3.0], [2, 1, 5]):
        assert tdash._sparkline(series) == jdash._sparkline(series)
    assert tdash._sparkline([]) == "<i>n/a</i>"
    assert JLogger(os.path.join(wd, "training_log")).read() == \
        MetricsLogger(os.path.join(wd, "training_log")).read()


def test_dashboard_serves(tmp_path):
    wd = run_dir(tmp_path)
    server = HTTPServer(("127.0.0.1", 0), tdash.make_handler(wd, 1))
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{port}"
    try:
        page = urllib.request.urlopen(base + "/", timeout=10).read().decode()
        assert "latest train record" in page and "trainacc_01" in page
        raw = urllib.request.urlopen(base + "/metrics.jsonl", timeout=10).read()
        assert b"trainacc_01" in raw
        png = urllib.request.urlopen(base + "/figures/epoch_001/hop_001/7.png",
                                     timeout=10).read()
        assert png[:4] == b"\x89PNG"
        for bad in ("/figures/%2e%2e/training_log/metrics.jsonl", "/figures/none.png"):
            with pytest.raises(urllib.error.HTTPError):
                urllib.request.urlopen(base + bad, timeout=10)
    finally:
        server.shutdown()
        server.server_close()
        t.join(10)
    assert not t.is_alive()


def test_cli_dashboard_serves_the_workdir(tmp_path, monkeypatch):
    seen = []
    monkeypatch.setattr(tdash, "serve_dashboard", lambda *a: seen.append(a))
    assert tcli.main(["dashboard", "--workdir", str(tmp_path), "--port", "0",
                      "--nhop", "3"]) == 0
    assert seen == [(str(tmp_path), 0, 3)]


def test_file_utils_bytes_are_jax(tmp_path):
    lines = ["alpha", "beta", "", "γ"]
    tfu.write_text(str(tmp_path / "t.txt"), lines)
    jfu.write_text(str(tmp_path / "j.txt"), lines)
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    assert tfu.text_read(str(tmp_path / "t.txt")) == jfu.text_read(str(tmp_path / "j.txt"))
    assert tfu.text_read(str(tmp_path / "t.txt")) == lines


def test_rig_canary_smoke():
    """The canary runs the chained bf16 products (tiny here); its share of
    the card's peak is only given on the card."""
    out = rigcheck.matmul_canary(n=256, iters=4, rounds=2, device="cpu")
    assert set(out) == {"tflops", "frac_of_peak", "ms_per_matmul", "device",
                        "power_limit_w"}
    assert out["tflops"] > 0 and out["ms_per_matmul"] > 0
    assert out["device"] == "cpu" and out["frac_of_peak"] is None
    assert out["power_limit_w"] is None


def test_bench_watchdog_fire_and_cancel():
    """The watchdog prints one parseable error line and hard-exits 3 past
    its deadline; a cancelled one never fires."""
    rigcheck.bench_watchdog("m", "u", timeout_s=60).cancel()
    proc = subprocess.run(
        [sys.executable, "-c",
         "import time, torch\n"
         "from rau_vqa_tpu_torch.utils.rigcheck import bench_watchdog\n"
         "bench_watchdog('vqa_questions_per_sec_per_chip', 'questions/sec', timeout_s=0.3)\n"
         "time.sleep(30)\n"],
        capture_output=True, text=True, timeout=60, cwd=REPO)
    assert proc.returncode == 3
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["metric"] == "vqa_questions_per_sec_per_chip"
    assert line["value"] == 0.0 and "watchdog" in line["error"]
    assert "vs_baseline" not in line


def test_bench_preflight(monkeypatch, capsys):
    """A hung or failing probe, or one that ran on the CPU, exits 3 with the
    error line; a healthy card's passes; a process asked for the CPU is not
    probed."""
    for r in ({"status": "hung", "detail": "x"},
              {"status": "ok", "n": 1, "platform": "cpu", "kind": "cpu"}):
        monkeypatch.setattr(doctor, "_probe", lambda code, t, r=r: r)
        with pytest.raises(SystemExit) as ex:
            rigcheck.bench_preflight("m", "u", "cuda", timeout_s=1.0)
        assert ex.value.code == 3
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert line["metric"] == "m" and "preflight" in line["error"]
        assert "vs_baseline" not in line
    monkeypatch.setattr(doctor, "_probe", lambda code, t: {
        "status": "ok", "n": 1, "platform": "cuda", "kind": "NVIDIA H100 80GB HBM3"})
    assert rigcheck.bench_preflight("m", "u", "cuda")["n"] == 1
    monkeypatch.setattr(doctor, "_probe", lambda code, t: (_ for _ in ()).throw(
        AssertionError("the probe must not run")))
    assert rigcheck.bench_preflight("m", "u", "cpu")["platform"] == "cpu"


def test_error_line_carries_only_the_ports_own_card_records(tmp_path, monkeypatch, capsys):
    """last_measured comes from the port's records on the card and never
    from the JAX package's TPU records (which hold this metric)."""
    monkeypatch.setattr(rigcheck, "RECORDS", str(tmp_path / "records.jsonl"))
    metric = "vqa_questions_per_sec_per_chip"
    assert rigcheck._last_recorded(metric, rigcheck.RECORDS) is None
    rigcheck._emit_error_line(metric, "questions/sec", "boom", "note")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"metric": metric, "value": 0.0, "unit": "questions/sec",
                    "error": "boom"}
    for value, limit in ((95000.0, 700.0), (0.0, None), (99000.0, 650.0)):
        rigcheck.record({"metric": metric, "value": value, "device": "NVIDIA H100",
                         "power_limit_w": limit})
    rigcheck.record({"metric": metric, "value": 0.0, "error": "x"})
    want = {"value": 99000.0, "device": "NVIDIA H100", "power_limit_w": 650.0}
    assert rigcheck._last_recorded(metric, rigcheck.RECORDS) == want
    rigcheck._emit_error_line(metric, "questions/sec", "boom", "note")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["last_measured"] == want and line["value"] == 0.0


def test_doctor_probe_outcomes_and_report(monkeypatch, capsys):
    ok = doctor._probe("import json; print(json.dumps({'n': 1}))", 30)
    assert ok["status"] == "ok" and ok["n"] == 1
    assert doctor._probe("import time; time.sleep(20)", 1.0)["status"] == "hung"
    err = doctor._probe("raise RuntimeError('boom')", 30)
    assert err["status"] == "error" and "boom" in err["detail"]
    # the device probe runs one dispatch; here on the CPU, and on a host
    # without a card its CUDA form errors
    dev = doctor._probe(doctor._DEVICE_PROBE.format(device="cpu"), 120)
    assert dev["status"] == "ok" and dev["exec"] == "ok" and dev["platform"] == "cpu"
    fake = {"versions": {"torch": "0.0"}, "device": {"status": "hung", "detail": "x"},
            "cpu": {"status": "ok", "n": 1, "platform": "cpu", "kind": "cpu"},
            "build": {"status": "error", "detail": "nvcc not found"},
            "native_features": {"status": "ok"},
            "native_images": {"status": "error", "detail": "jpeglib.h",
                              "note": doctor.NATIVE_IMAGES_NOTE},
            "healthy": False}
    text = doctor.format_report(fake)
    assert "HUNG" in text and "UNHEALTHY" in text and "1x cpu" in text
    assert "--device cpu" in text and "not counted" in text
    monkeypatch.setattr(doctor, "run_doctor", lambda **kw: fake)
    assert tcli.main(["doctor"]) == 1
    out = capsys.readouterr()
    assert json.loads(out.out.strip().splitlines()[-1])["healthy"] is False
    assert "UNHEALTHY" in out.err


def test_native_images_is_reported_but_not_counted(monkeypatch, tmp_path):
    """The port decodes with PIL: a native decoder that cannot build is
    reported with its reason and leaves the rig healthy; any other failed
    probe, a requested canary that fails, or a missing data file does not."""
    def probe(code, t):
        if "load_image_library" in code:
            return {"status": "error", "detail": "fatal error: jpeglib.h"}
        if "matmul_canary" in code:
            return {"status": "ok", "tflops": 700.0, "frac_of_peak": 0.708,
                    "ms_per_matmul": 0.196, "device": "NVIDIA H100 80GB HBM3",
                    "power_limit_w": 700.0}
        if "_build" in code:
            return {"status": "ok", "nvcc": "V12.8", "kernel": "maskgen", "build_s": 2.0}
        platform = "cuda" if '"cuda"' in code else "cpu"
        return {"status": "ok", "n": 1, "platform": platform, "kind": platform,
                "exec": "ok"}
    monkeypatch.setattr(doctor, "_probe", probe)
    report = doctor.run_doctor(canary=True)
    assert report["healthy"] and report["native_images"]["status"] == "error"
    assert "PIL" in report["native_images"]["note"]
    text = doctor.format_report(report)
    assert "70.8% of the H100's 989 TFLOP/s" in text and "700.0 W" in text
    assert "healthy" in text.splitlines()[-1]
    assert not doctor.run_doctor(vqa_dir=str(tmp_path))["healthy"]
    monkeypatch.setattr(doctor, "_probe", lambda code, t: (
        {"status": "error", "detail": "x"} if "matmul_canary" in code else probe(code, t)))
    assert not doctor.run_doctor(canary=True)["healthy"]


def test_doctor_watch_polls_until_healthy(monkeypatch, capsys):
    sick = {"versions": {}, "device": {"status": "hung", "detail": "x"},
            "cpu": {"status": "ok", "n": 1, "platform": "cpu", "kind": "cpu"},
            "healthy": False}
    well = dict(sick, device={"status": "ok", "n": 1, "platform": "cuda", "kind": "h100"},
                healthy=True)
    seq = iter([sick, sick, well])
    monkeypatch.setattr(doctor, "run_doctor", lambda **kw: next(seq))
    assert tcli.main(["doctor", "--watch", "--watch-interval", "0.01"]) == 0
    out = capsys.readouterr()
    assert json.loads(out.out.strip().splitlines()[-1])["healthy"]
    assert out.err.count("next poll") == 2
    monkeypatch.setattr(doctor, "run_doctor", lambda **kw: dict(sick))
    assert tcli.main(["doctor", "--watch", "--watch-interval", "0.01",
                      "--watch-timeout", "0.02"]) == 1
    assert "giving up" in capsys.readouterr().err
