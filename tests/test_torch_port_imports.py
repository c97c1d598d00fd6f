"""The port stands alone: no module of rau_vqa_tpu_torch, and neither
chip_smoke.py nor a root bench_torch*.py script, imports JAX, Flax, anything of the JAX package or
the JAX side's scripts/ (checked on
the source, so lazy imports inside functions count too), nor torchvision or
timm: their state dicts are read as dicts from local files.  The packages the
card's machine lacks are imported only inside the functions that need them."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
SOURCES = sorted((ROOT / "rau_vqa_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", *sorted(ROOT.glob("bench_torch*.py"))]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "rau_vqa_tpu", "torchvision", "timm",
             "scripts")


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
            "bench_torch_stage.py", "loader.py", "checkpoint.py",
            "msgpack_flax.py", "cli.py", "serve.py", "native.py",
            "images.py", "torch_convert.py", "vgg.py", "vit.py", "precompute.py",
            "rigcheck.py", "hdf5.py", "prepro.py", "released.py",
            "layout_diag.py", "visatt.py", "export.py", "chain.py", "benchparams.py",
            "doctor.py", "dashboard.py", "file_utils.py", "flops.py", "bench.py",
            "bench_pixels.py", "bench_torch.py", "bench_torch_pixels.py",
            "bench_torch_train_hops.py", "mesh.py", "bench_torch_train.py",
            "bench_train.py", "bench_serve.py", "bench_precompute.py",
            "probe_serving_batch.py", "profile_vit.py", "paper_dims_run.py",
            "ft_accuracy_ab.py", "_common.py"} <= names
    assert (ROOT / "rau_vqa_tpu_torch" / "scripts" / "__init__.py") in SOURCES
    assert (ROOT / "rau_vqa_tpu_torch" / "models" / "backbones" / "__init__.py") in SOURCES
    assert (ROOT / "rau_vqa_tpu_torch" / "parallel" / "__init__.py") in SOURCES


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    for mod in imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"


# packages the card's machine lacks: (file, function) where each may appear
# (h5py: nowhere; data/hdf5.py reads and writes the bundle, and only the
# tests use h5py, as the yardstick)
OPTIONAL = {"h5py": set(),
            "PIL": {("fixtures.py", "fixture_bundle"),
                    ("visatt.py", "save_attention_png"),
                    ("images.py", "decode_scale_center_crop"),
                    ("images.py", "_load_one"),
                    ("serve.py", "_decode_image"),
                    ("bench_precompute.py", "make_images"),
                    ("chip_smoke.py", "serve_phase")},
            "matplotlib": {("plots.py", "render_curves")},
            "msgpack": set()}


def optional_imports(path):
    """(top-level package, enclosing function or None) of each import."""
    tree = ast.parse(path.read_text(), filename=str(path))

    def walk(node, func):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from walk(child, child.name)
                continue
            if isinstance(child, ast.Import):
                for a in child.names:
                    yield a.name.split(".")[0], func
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                yield (child.module or "").split(".")[0], func
            yield from walk(child, func)

    return list(walk(tree, None))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_optional_packages_only_where_needed(path):
    for top, func in optional_imports(path):
        if top in OPTIONAL:
            assert (path.name, func) in OPTIONAL[top], \
                f"{path.name} imports {top} in {func or 'the module body'}"
