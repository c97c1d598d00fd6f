"""Rig health checks: ``python -m rau_vqa_tpu_torch.cli doctor``.

Counterpart of ``rau_vqa_tpu/utils/doctor.py`` (:1-180).  Each probe runs in
a subprocess with a timeout, since a hung device call inside this process
could never be cancelled, and the probes run side by side.  The report
covers the library versions (torch, numpy, PIL), the CUDA card (one
dispatch, its name and its power limit from ``nvidia-smi``), the CPU path,
``nvcc`` and one kernel's build (``csrc/maskgen.cu``), the native feature
loader and image decoder, optionally a data directory and the bf16 canary
(``--canary``); the CLI prints one human block and one JSON line.

``healthy`` counts every probe but ``native_images``: the native decoder
links libjpeg and libpng, whose headers the card's machine lacks, and the
port decodes with PIL by default (``data/images.py``), so a missing decoder
is reported with its reason and does not make the rig unhealthy.  The JAX
package counts it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_DEVICE_PROBE = """
import json, torch
dev = torch.device("{device}")
if dev.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError("torch.cuda.is_available() is False")
# one dispatch and its result back, not just the device's presence
y = (torch.arange(4.0, device=dev) + 1.0).cpu()
assert float(y[3]) == 4.0
out = {{"n": torch.cuda.device_count() if dev.type == "cuda" else 1,
        "platform": dev.type, "exec": "ok",
        "kind": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"}}
if dev.type == "cuda":
    from rau_vqa_tpu_torch.utils.rigcheck import card_info
    out["power_limit_w"] = card_info()[1]
print(json.dumps(out))
"""

_BUILD_PROBE = """
import json, os, subprocess, tempfile, time
from rau_vqa_tpu_torch.ops import _build
nvcc = _build._nvcc()
version = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[-1]
with tempfile.TemporaryDirectory() as d:
    t0 = time.perf_counter()
    r = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-o", os.path.join(d, "libmaskgen.so"),
                        _build.source_path("maskgen")], capture_output=True, text=True,
                       timeout=600)
    if r.returncode:
        raise RuntimeError("nvcc failed on maskgen.cu: " + (r.stdout + r.stderr)[-400:])
print(json.dumps({"nvcc": version, "kernel": "maskgen",
                  "build_s": round(time.perf_counter() - t0, 2)}))
"""

_CANARY_PROBE = """
import json
from rau_vqa_tpu_torch.utils.rigcheck import matmul_canary
print(json.dumps(matmul_canary(device="cuda")))
"""

_NATIVE_PROBE = """
import json
from rau_vqa_tpu_torch.data import native
native.{loader}()
print(json.dumps({{}}))
"""

NATIVE_IMAGES_NOTE = ("not counted: the card's machine lacks jpeglib.h and png.h, and the "
                      "port decodes with PIL (data/images.py)")


def _probe(code: str, timeout_s: float) -> Dict[str, Any]:
    """Run a snippet in a fresh interpreter with a hard timeout: ok (with
    the JSON of its last line), hung or error.  A hung device never
    raises, so the timeout is the detection."""
    try:
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                              timeout=timeout_s, cwd=_REPO)
    except subprocess.TimeoutExpired:
        return {"status": "hung",
                "detail": f"no response within {timeout_s:.0f}s: the device's init or "
                          f"a one-op dispatch never returned"}
    if proc.returncode != 0:
        err = proc.stderr.strip()
        return {"status": "error",
                "detail": err.splitlines()[-1] if err else f"rc={proc.returncode}"}
    try:
        out = json.loads(proc.stdout.strip().splitlines()[-1])
    except (ValueError, IndexError):
        return {"status": "error", "detail": f"unparseable: {proc.stdout!r}"}
    return {"status": "ok", **out}


def _versions() -> Dict[str, str]:
    versions = {}
    for mod in ("torch", "numpy", "PIL"):
        try:
            versions[mod] = getattr(__import__(mod), "__version__", "?")
        except ImportError as e:
            versions[mod] = f"IMPORT FAILED: {e}"
    return versions


def run_doctor(*, vqa_dir: str | None = None, canary: bool = False,
               device_timeout_s: float = 180.0, build_timeout_s: float = 600.0,
               canary_timeout_s: float = 600.0) -> Dict[str, Any]:
    """Run every check; returns the report (the CLI prints it)."""
    report: Dict[str, Any] = {"versions": _versions()}
    probes = {"device": (_DEVICE_PROBE.format(device="cuda"), device_timeout_s),
              "cpu": (_DEVICE_PROBE.format(device="cpu"), device_timeout_s),
              "build": (_BUILD_PROBE, build_timeout_s),
              "native_features": (_NATIVE_PROBE.format(loader="load_library"), 180.0),
              "native_images": (_NATIVE_PROBE.format(loader="load_image_library"), 180.0)}
    with ThreadPoolExecutor(len(probes)) as pool:
        futures = {k: pool.submit(_probe, *v) for k, v in probes.items()}
        for k, fut in futures.items():
            report[k] = fut.result()
    for k in ("native_features", "native_images"):
        if report[k]["status"] == "ok":
            report[k] = {"status": "ok"}
    if report["native_images"]["status"] != "ok":
        report["native_images"]["note"] = NATIVE_IMAGES_NOTE
    if vqa_dir is not None:
        missing = [f for f in ("data_prepro.json", "data_prepro.h5")
                   if not os.path.exists(os.path.join(vqa_dir, f))]
        report["vqa_dir"] = ({"status": "ok"} if not missing else
                             {"status": "error", "detail": f"missing {missing} in {vqa_dir}"})
    if canary and report["device"]["status"] == "ok":
        report["canary"] = _probe(_CANARY_PROBE, canary_timeout_s)
    elif canary:
        report["canary"] = {"status": "skipped", "detail": "device probe not ok"}
    core = [report[k] for k in ("device", "cpu", "build", "native_features", "vqa_dir", "canary")
            if k in report]
    report["healthy"] = all(c["status"] in ("ok", "skipped") for c in core)
    return report


def format_report(report: Dict[str, Any]) -> str:
    lines = ["versions: " + "  ".join(f"{k}={v}" for k, v in report["versions"].items())]
    for key in ("device", "cpu", "build", "native_features", "native_images", "vqa_dir",
                "canary"):
        if key not in report:
            continue
        c = report[key]
        if c["status"] == "ok":
            extra = ""
            if "platform" in c:
                extra = f" — {c['n']}x {c['platform']} ({c['kind']})"
                if c.get("power_limit_w"):
                    extra += f" at {c['power_limit_w']} W"
            if "nvcc" in c:
                extra = f" — {c['nvcc']}; {c['kernel']}.cu built in {c['build_s']} s"
            if "tflops" in c:
                extra = (f" — {c['tflops']} TFLOP/s bf16 ({c['frac_of_peak'] * 100:.1f}% of "
                         f"the H100's 989 TFLOP/s dense bf16 peak) on {c['device']} at "
                         f"{c['power_limit_w']} W")
            lines.append(f"  ok    {key}{extra}")
        else:
            note = f" ({c['note']})" if "note" in c else ""
            lines.append(f"  {c['status'].upper():5s} {key} — {c.get('detail', '')}{note}")
    if report["healthy"]:
        lines.append("healthy")
    else:
        lines.append("UNHEALTHY — see failed checks above")
        if (report.get("device", {}).get("status") != "ok"
                and report.get("cpu", {}).get("status") == "ok"):
            lines.append("  hint: every command still runs the plain versions on the host "
                         "with 'python -m rau_vqa_tpu_torch.cli --device cpu <command> ...'")
    return "\n".join(lines)
