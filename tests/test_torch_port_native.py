"""The port's native bindings (rau_vqa_tpu_torch/data/native.py), its image
decode (data/images.py) and ``pack_feature_dir`` against the JAX package's,
on the CPU, bit for bit.

Both bindings compile the repo's own ``native/*.cpp`` with the flags of
``native/Makefile``: the port's into ``rau_vqa_tpu_torch/_build/native/``, the
JAX package's into ``native/``.  This machine has g++, libjpeg, libpng and
PIL, so the builds are required: nothing here skips.  Each port backend is
held to the same JAX backend (the native decoder's point-sampled Catmull-Rom
and PIL's bicubic resize differ from each other)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from rau_vqa_tpu.data import features as jfeat
from rau_vqa_tpu.data import images as jimages
from rau_vqa_tpu.data import native as jnative
from rau_vqa_tpu_torch.data import features as tfeat
from rau_vqa_tpu_torch.data import images as timages
from rau_vqa_tpu_torch.data import native as tnative
from tests.test_torch_port_trainer import SPEC, jfix

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port_native"))
    vqa_dir = jfix.generate_fixture(root, SPEC)
    with open(os.path.join(vqa_dir, "data_prepro.json")) as f:
        info = json.load(f)
    imgs = info["unique_img_train"] + info["unique_img_test"]
    return root, imgs


def pack_both(root, imgs, dtype):
    out = {}
    for name, mod in (("jax", jfeat), ("port", tfeat)):
        d = os.path.join(root, f"packed_{name}_{dtype}")
        mod.pack_feature_dir([os.path.join(root, "feat")], imgs,
                             [1] * len(imgs), d, SPEC.feat_dim, SPEC.feat_w,
                             SPEC.feat_h, dtype=dtype)
        out[name] = d
    return out


@pytest.mark.parametrize("dtype", ["float32", "float16", "int8"])
def test_pack_feature_dir_writes_the_jax_shard(fixture, dtype):
    root, imgs = fixture
    dirs = pack_both(root, imgs, dtype)
    files = sorted(os.listdir(dirs["jax"]))
    assert files == sorted(os.listdir(dirs["port"]))
    assert ("scales.npy" in files) == (dtype == "int8")
    for f in files:
        with open(os.path.join(dirs["jax"], f), "rb") as a, \
                open(os.path.join(dirs["port"], f), "rb") as b:
            assert a.read() == b.read(), f


def test_native_store_matches_jax_and_the_python_store(fixture):
    root, imgs = fixture
    shard = pack_both(root, imgs, "int8")["port"]
    names = list(tfeat.PackedFeatureStore(shard).index)
    port = tnative.NativePackedFeatureStore(shard, n_threads=3)
    jax_store = jnative.NativePackedFeatureStore(shard, n_threads=2)
    python = tfeat.PackedFeatureStore(shard)
    assert port.feat_norm is False and port.shard_dir == shard
    rs = np.random.RandomState(0)
    try:
        # more batches than ring slots, and two batch sizes
        for trial in range(10):
            pick = [names[i] for i in rs.randint(0, len(names), 5 + trial % 2)]
            got = port.get_batch(pick, [1] * len(pick))
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, jax_store.get_batch(pick, [1] * len(pick)))
            np.testing.assert_array_equal(got, python.get_batch(pick, [1] * len(pick)))
    finally:
        port.close()
        jax_store.close()


def test_libraries_build_under_the_ports_build_dir():
    lib = tnative.load_library()
    img = tnative.load_image_library()
    build = os.path.join(ROOT, "rau_vqa_tpu_torch", "_build", "native")
    assert tnative.BUILD_DIR == build
    assert lib._name == os.path.join(build, "libfeature_loader.so")
    assert img._name == os.path.join(build, "libimage_decode.so")
    assert tnative.NATIVE_SRC == os.path.join(ROOT, "native")


def save_images(tmp_path, fmt, shapes, seed=0):
    rs = np.random.RandomState(seed)
    paths = []
    for i, (h, w) in enumerate(shapes):
        p = str(tmp_path / f"im{i}.{fmt}")
        kw = {"quality": 90} if fmt == "jpg" else {}
        Image.fromarray(rs.randint(0, 256, (h, w, 3), dtype=np.uint8)).save(p, **kw)
        paths.append(p)
    return paths


@pytest.mark.parametrize("fmt", ["jpg", "png"])
def test_native_decode_matches_jax(tmp_path, fmt):
    paths = save_images(tmp_path, fmt, [(64, 64), (96, 130), (131, 57), (40, 48)])
    bad = str(tmp_path / f"bad.{fmt}")
    with open(bad, "wb") as f:
        f.write(b"\xff\xd8 not an image")
    for size in (48, 64):
        got, ok = tnative.decode_image_batch_status(paths + [bad], size, n_threads=3)
        want, jok = jnative.decode_image_batch_status(paths + [bad], size, n_threads=2)
        assert ok.tolist() == jok.tolist() == [True] * 4 + [False]
        np.testing.assert_array_equal(got[:4], want[:4])
        np.testing.assert_array_equal(
            tnative.decode_image_batch(paths, size), got[:4])
    with pytest.raises(OSError, match="native decode failed"):
        tnative.decode_image_batch([paths[0], bad], 32)
    with open(paths[1], "rb") as f:
        one, ok = tnative.decode_image_bytes(f.read(), 64)
    assert ok and np.array_equal(one[0], tnative.decode_image_batch(paths[1:2], 64)[0])


@pytest.mark.parametrize("size", [32, 57, 96])
def test_decode_scale_center_crop_matches_jax(tmp_path, size):
    for i, p in enumerate(save_images(tmp_path, "png", [(70, 90), (121, 64), (96, 96)],
                                      seed=size)):
        with Image.open(p) as a, Image.open(p) as b:
            got = timages.decode_scale_center_crop(a, size)
            want = jimages.decode_scale_center_crop(b, size)
        assert got.dtype == np.uint8 and got.shape == (size, size, 3)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("backend", ["pil", "native"])
def test_image_dir_source_matches_jax(tmp_path, backend):
    """A batch with a repeated path and, for the native backend, a BMP it
    cannot read (PIL takes that one file)."""
    paths = save_images(tmp_path, "jpg", [(80, 80), (50, 90)], seed=4)
    Image.fromarray(np.full((60, 70, 3), 77, np.uint8)).save(str(tmp_path / "c.bmp"))
    rel = [os.path.basename(p) for p in paths] + ["c.bmp", os.path.basename(paths[0])]
    got = timages.ImageDirSource(str(tmp_path), size=48, backend=backend).get_batch(rel)
    want = jimages.ImageDirSource(str(tmp_path), size=48, backend=backend).get_batch(rel)
    assert got.shape == (4, 48, 48, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], got[3])
    with pytest.raises(ValueError, match="unknown image backend"):
        timages.ImageDirSource(str(tmp_path), backend="cv2")


def test_build_failure_is_remembered(tmp_path, monkeypatch):
    """A source that does not compile raises NativeUnavailable with the
    compiler's output, once; later calls raise without compiling again."""
    src = tmp_path / "broken.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "NATIVE_SRC", str(tmp_path))
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setitem(tnative.LIBRARIES, "broken", ("broken.cpp", []))
    monkeypatch.setattr(tnative, "_errors", {})
    runs = []
    real_run = subprocess.run
    monkeypatch.setattr(tnative.subprocess, "run",
                        lambda *a, **k: runs.append(a) or real_run(*a, **k))
    for _ in range(3):
        with pytest.raises(tnative.NativeUnavailable, match="compiler output"):
            tnative._load("broken", lambda lib: None)
    assert len(runs) == 1
    assert not [f for f in os.listdir(tmp_path / "build") if f.endswith(".so")]


def test_two_processes_build_one_library(tmp_path):
    """Two processes that build at once (test workers do) both load a
    whole library: the second waits on the first's lock, finds the library
    fresh and does not compile again."""
    build = str(tmp_path / "build")
    code = ("import sys; from rau_vqa_tpu_torch.data import native as n; "
            f"n.BUILD_DIR = {build!r}; "
            "lib = n.load_library(); print(lib._name)")
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert {o.strip() for o, _ in outs} == {os.path.join(build, "libfeature_loader.so")}
    assert sorted(os.listdir(build)) == ["libfeature_loader.so",
                                         "libfeature_loader.so.lock"]


def test_cli_pack_features_writes_the_jax_shard(fixture, tmp_path, monkeypatch):
    """``pack-features`` of each CLI gives the same files; without h5py the
    port's reads each image's datatype from the bundle all the same
    (data/hdf5.py), with one --feat-dir or two (it once refused two)."""
    from rau_vqa_tpu import cli as jcli
    from rau_vqa_tpu_torch import cli as tcli

    root, _ = fixture
    args = ["pack-features", "--vqa-dir", os.path.join(root, "vqa_prepro"),
            "--feat-dir", os.path.join(root, "feat"), "--cnnout-dim",
            str(SPEC.feat_dim), "--cnnout-w", str(SPEC.feat_w), "--cnnout-h",
            str(SPEC.feat_h), "--dtype", "int8"]
    assert jcli.main(args + ["--out", str(tmp_path / "jax")]) == 0
    assert tcli.main(args + ["--out", str(tmp_path / "port")]) == 0
    monkeypatch.setitem(sys.modules, "h5py", None)    # import h5py fails
    assert tcli.main(args + ["--out", str(tmp_path / "no_h5py")]) == 0
    for d in ("port", "no_h5py"):
        for f in sorted(os.listdir(tmp_path / "jax")):
            assert (tmp_path / d / f).read_bytes() == \
                (tmp_path / "jax" / f).read_bytes(), (d, f)
    two = args + ["--feat-dir", os.path.join(root, "feat")]
    monkeypatch.delitem(sys.modules, "h5py")
    assert jcli.main(two + ["--out", str(tmp_path / "jax_two")]) == 0
    monkeypatch.setitem(sys.modules, "h5py", None)
    assert tcli.main(two + ["--out", str(tmp_path / "two")]) == 0
    for f in sorted(os.listdir(tmp_path / "jax_two")):
        assert (tmp_path / "two" / f).read_bytes() == \
            (tmp_path / "jax_two" / f).read_bytes(), f
