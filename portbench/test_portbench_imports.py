"""Nothing the harness runs imports JAX, jaxlib, flax or the JAX package,
compared by whole top-level name (the port's name begins with the JAX
package's), and the reference imports nothing of the program."""

from __future__ import annotations

import ast
import glob
import os
import subprocess
import sys

import harness

BENCH = os.path.dirname(os.path.abspath(__file__))


def test_forbidden_names_are_compared_whole():
    mods = ["rau_vqa_tpu_torch", "rau_vqa_tpu_torch.ops", "jaxtyping", "flaxen", "numpy",
            "rau_vqa_tpu.ops.x", "jax", "jaxlib.xla_client", "flax.linen"]
    assert harness.forbidden_modules(mods) == ["flax.linen", "jax", "jaxlib.xla_client",
                                               "rau_vqa_tpu.ops.x"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_sources_import_no_jax_and_the_reference_nothing_of_the_program():
    for path in glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & set(harness.FORBIDDEN), path
        if os.sep + "reference" + os.sep in path:
            assert "rau_vqa_tpu_torch" not in tops, path


def test_a_run_loads_no_jax(tmp_path):
    """A whole tiny run of every cell on the CPU in a fresh interpreter, then
    a look at sys.modules."""
    code = f"""
import sys
sys.path[:0] = [{BENCH!r}, {os.path.dirname(BENCH)!r}]
import conftest, harness, pytest
mp = pytest.MonkeyPatch()
tb = conftest.tiny_bench.__wrapped__(__import__("pathlib").Path({str(tmp_path)!r}), mp)
import glob, os
for name in sorted(os.listdir(tb.path("cells"))):
    rc, line, err = tb.run(name[:-5], seconds=0.3)
    assert rc == 0, err
for kind in ("drivers", "metrics"):
    for p in glob.glob(os.path.join(tb.bench, kind, "*.py")):
        harness.load_module(kind, os.path.basename(p)[:-3])
import reference.rau, reference.resnet, compare, counts, traffic, weights, tracing
print("FOUND", harness.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUND []" in out.stdout
