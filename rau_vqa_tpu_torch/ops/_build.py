"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface under ``rau_vqa_tpu_torch/_build/``,
and loads with ``ctypes``.  Nothing builds or loads at import time: the CPU
tests import every module here.  A library is rebuilt when its source is
newer.  ``build_all`` starts one ``nvcc`` per source at once.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from typing import Dict, Iterable, List, Optional, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def source_path(name: str) -> str:
    return os.path.join(CSRC, name + ".cu")


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def report_path(name: str) -> str:
    """Where nvcc's ``-Xptxas -v`` report (registers, shared memory, spills)
    of the last build of ``name`` is kept."""
    return os.path.join(BUILD_DIR, f"{name}.ptxas.txt")


def _stale(name: str) -> bool:
    """The library is missing, or older than its source or any shared
    header in ``csrc/``."""
    lib = library_path(name)
    if not os.path.exists(lib):
        return True
    headers = [os.path.join(CSRC, f) for f in os.listdir(CSRC)
               if f.endswith(".cuh")]
    newest = max(os.path.getmtime(p) for p in [source_path(name)] + headers)
    return os.path.getmtime(lib) < newest


def build_all(names: Iterable[str], force: bool = False) -> Dict[str, str]:
    """Compile the named sources in parallel; returns name -> ptxas report.
    Raises with nvcc's output if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        if not force and not _stale(name):
            continue
        tmp = library_path(name) + f".{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, source_path(name)]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failures: List[str] = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {source_path(name)} "
                            f"(rc {proc.returncode}):\n{out}")
            continue
        with open(report_path(name), "w") as f:
            f.write(out)
        os.replace(tmp, library_path(name))
    if failures:
        raise RuntimeError("\n".join(failures))
    reports = {}
    for name in names:
        path = report_path(name)
        if os.path.exists(path):
            with open(path) as f:
                reports[name] = f.read()
        else:
            reports[name] = ""
    return reports


class Kernel:
    """One CUDA kernel behind a plain C launcher ``int fn(...)`` that returns
    ``cudaGetLastError()``.  ``launches`` counts successful launches and is
    changed nowhere else."""

    def __init__(self, name: str, fn: str, argtypes: Sequence):
        self.name = name
        self.fn = fn
        self.argtypes = list(argtypes)
        self.launches = 0
        self._lib: Optional[ctypes.CDLL] = None
        self._cfn: Optional[ctypes._CFuncPtr] = None

    def _library(self) -> ctypes.CDLL:
        if self._lib is None:
            build_all([self.name])
            self._lib = ctypes.CDLL(library_path(self.name))
        return self._lib

    def _load(self):
        if self._cfn is None:
            cfn = getattr(self._library(), self.fn)
            cfn.argtypes = self.argtypes
            cfn.restype = ctypes.c_int
            self._cfn = cfn
        return self._cfn

    def function(self, fn: str, argtypes: Sequence):
        """The library's ``int fn(...)`` with these argument types: for a
        question about the launcher (no launch, so nothing is counted)."""
        cfn = getattr(self._library(), fn)
        cfn.argtypes = list(argtypes)
        cfn.restype = ctypes.c_int
        return cfn

    def query(self, fn: str, *args: int) -> int:
        """The value of the library's ``int fn(int, ...)``."""
        return self.function(fn, [ctypes.c_int] * len(args))(*args)

    def launch(self, *args) -> None:
        err = self._load()(*args)
        if err != 0:
            raise RuntimeError(
                f"{self.fn} failed to launch: cudaError {err}")
        self.launches += 1
