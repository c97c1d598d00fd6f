"""The port stands alone: no module of rau_vqa_tpu_torch, and neither
chip_smoke.py, bench_torch_serving.py nor bench_torch_stage.py, imports JAX, Flax or anything of the JAX package (checked on
the source, so lazy imports inside functions count too)."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
SOURCES = sorted((ROOT / "rau_vqa_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "bench_torch_serving.py", ROOT / "bench_torch_stage.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "rau_vqa_tpu")


def imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_sources_found():
    names = {p.name for p in SOURCES}
    assert {"predict.py", "lstm_encoder.py", "rau_hops.py", "chip_smoke.py",
            "maskgen.py", "rau_train_hops.py", "treeflat.py", "losses.py",
            "optim.py", "trainer.py", "fused_resnet.py", "transforms.py",
            "resnet.py", "pipeline.py", "devices.py", "bench_torch_serving.py",
            "bench_torch_stage.py"} <= names
    assert (ROOT / "rau_vqa_tpu_torch" / "models" / "backbones" / "__init__.py") in SOURCES


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    for mod in imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"
