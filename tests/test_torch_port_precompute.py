"""The port's feature precomputation (rau_vqa_tpu_torch/precompute.py) and
its ``precompute-features`` command against the JAX package's, on the CPU.

Both packages run the same VGG16 (JAX's init, carried over) over the same
PIL-decoded images.  Float32 rows agree at the backbone's bar, 3e-5 of the
features' scale (tests/test_torch_port_pipeline.py; a batch of 2 against a
batch of 5 reassociates the convolutions' sums); the port's int8 shard equals, bit for bit, ``PackedShardWriter.write``'s
host quantization of the port's own float32 rows (the JAX pin,
tests/test_precompute.py:377-402), and JAX's int8 shard within one step."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rau_vqa_tpu import cli as jcli
from rau_vqa_tpu import precompute as JPC
from rau_vqa_tpu.models.backbones import vit as JVT
from rau_vqa_tpu.models.pipeline import extract_features as jax_extract
from rau_vqa_tpu_torch import cli as tcli
from rau_vqa_tpu_torch import precompute as TPC
from rau_vqa_tpu_torch.convert import params_from_jax
from rau_vqa_tpu_torch.data.features import PackedFeatureStore, PackedShardWriter, coco_feat_name
from rau_vqa_tpu_torch.data.images import ImageDirSource
from rau_vqa_tpu_torch.models.backbones import vit as TVT
from tests.test_precompute import _make_images
from tests.test_torch_port_backbone import assert_scaled_close
from tests.test_torch_port_vgg_vit import JTINY, TTINY, _timm_state, jax_vgg


def close(got, want):
    assert_scaled_close(got, want, 3e-5)


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port_precompute"))
    return root, _make_images(os.path.join(root, "imgs"), n=5)


def run_both(root, rel, tmp_path, bb, **kw):
    """(JAX store, port store) of the same images, backbone and options."""
    common = dict(size=32, batch_size=2, backend="pil", **kw)
    want = JPC.precompute_features(os.path.join(root, "imgs"), rel,
                                   str(tmp_path / "jax"), "vgg16", bb, **common)
    got = TPC.precompute_features(os.path.join(root, "imgs"), rel,
                                  str(tmp_path / "port"), "vgg16", params_from_jax(bb),
                                  device="cpu", **common)
    return want, got


def rows(store, rel):
    names = [coco_feat_name(p) for p in rel]
    return store.get_batch(names, [1] * len(names))


def test_scan_and_unique_match_jax(tmp_path):
    """A basename in two directories is one feature row, the first found."""
    from PIL import Image
    rel = _make_images(str(tmp_path), n=3)
    (tmp_path / "train2014").mkdir()
    Image.new("RGB", (50, 50)).save(str(tmp_path / "train2014" / os.path.basename(rel[0])))
    (tmp_path / "notes.txt").write_text("not an image")
    found = TPC.scan_image_dir(str(tmp_path))
    assert found == JPC.scan_image_dir(str(tmp_path)) and len(found) == 4
    assert TPC.unique_by_feat_name(found) == JPC.unique_by_feat_name(found)
    names, paths = TPC.unique_by_feat_name(found)
    assert len(names) == len(set(names)) == 3 and paths[0].startswith("train2014/")


def test_float32_shard_matches_jax(images, tmp_path):
    """5 images at batch 2: the last batch padded; rows by feature name."""
    root, rel = images
    bb = jax_vgg(0)
    calls = []
    want, got = run_both(root, rel, tmp_path, bb)
    assert (got.spat, got.dim, got.feat_norm) == (want.spat, want.dim, want.feat_norm) \
        == (1, 512, False)
    assert got.index == want.index
    close(rows(got, rel), rows(want, rel))
    # and the backbone's direct output on the same decoded batch
    imgs = ImageDirSource(os.path.join(root, "imgs"), size=32).get_batch(rel)
    direct = np.asarray(jax_extract("vgg16", bb, jnp.asarray(imgs)))
    close(rows(got, rel), direct)
    # 3 batches of 2; the last one's padding repeats a path, decoded once
    assert got.decoder == "pil 5"
    TPC.precompute_features(os.path.join(root, "imgs"), rel, str(tmp_path / "p2"), "vgg16",
                            params_from_jax(bb), size=32, batch_size=2, backend="pil",
                            device="cpu", progress=lambda d, t: calls.append((d, t)))
    assert calls == [(2, 5), (4, 5), (5, 5)]


def test_float16_shard_and_bf16_compute(images, tmp_path):
    root, rel = images
    bb = jax_vgg(1)
    want, got = run_both(root, rel, tmp_path, bb, dtype="float16")
    assert got.mmap.dtype == np.float16
    np.testing.assert_allclose(rows(got, rel), rows(want, rel), rtol=2e-3, atol=2e-4)
    b16 = TPC.precompute_features(os.path.join(root, "imgs"), rel, str(tmp_path / "b16"),
                                  "vgg16", params_from_jax(bb), size=32, batch_size=2,
                                  backend="pil", compute_dtype="bfloat16", device="cpu")
    # bf16 compute: float32 storage, within bf16's reach of the float32 rows
    assert b16.mmap.dtype == np.float32
    f32, r16 = rows(want, rel), rows(b16, rel)
    assert np.abs(r16 - f32).max() <= 0.05 * np.abs(f32).max()


def test_int8_shard_is_the_host_quantization_bit_for_bit(images, tmp_path):
    root, rel = images
    bb = jax_vgg(2)
    want, got = run_both(root, rel, tmp_path, bb, dtype="int8")
    f32 = TPC.precompute_features(os.path.join(root, "imgs"), rel, str(tmp_path / "f32"),
                                  "vgg16", params_from_jax(bb), size=32, batch_size=2,
                                  backend="pil", device="cpu")
    host = PackedShardWriter(str(tmp_path / "host"), len(rel), 1, 512, dtype="int8")
    host.write(0, np.asarray(f32.mmap))
    np.testing.assert_array_equal(np.asarray(got.mmap), np.asarray(host.arr))
    np.testing.assert_array_equal(got.scales, host.scales)
    assert got.mmap.dtype == np.int8 and os.path.exists(os.path.join(got.shard_dir,
                                                                     "scales.npy"))
    # JAX's int8 shard of its own float rows: the same scales to float32
    # rounding, values within one step
    np.testing.assert_allclose(got.scales, want.scales, rtol=1e-5)
    assert np.abs(np.asarray(got.mmap, np.int32) - np.asarray(want.mmap, np.int32)).max() <= 1


def test_device_quantization_equals_writer_and_jax(tmp_path):
    """quantize_feats_device against the host writer and JAX's own, on the
    JAX pin's inputs: a zero image and round-half-even ties at the clip edge."""
    rs = np.random.RandomState(7)
    feats = (rs.randn(6, 9, 16) * rs.uniform(0.05, 40.0, (6, 1, 1))).astype(np.float32)
    feats[3] = 0.0
    feats[4, 0, 0] = np.float32(127.5)
    feats[4, 0, 1] = -np.float32(126.5)
    host = PackedShardWriter(str(tmp_path / "host"), 6, 9, 16, dtype="int8")
    host.write(0, feats)
    q, s = TPC.quantize_feats_device(torch.as_tensor(feats))
    jq, js = JPC.quantize_feats_device(jnp.asarray(feats))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    for want_q, want_s in ((np.asarray(host.arr), host.scales), (np.asarray(jq), np.asarray(js))):
        np.testing.assert_array_equal(q.numpy(), want_q)
        np.testing.assert_array_equal(s.numpy(), want_s)


def test_feat_norm_marker_and_rows(images, tmp_path):
    root, rel = images
    want, got = run_both(root, rel, tmp_path, jax_vgg(3), feat_norm=True)
    with open(os.path.join(got.shard_dir, "index.json")) as f:
        assert json.load(f)["feat_norm"] is True
    assert got.feat_norm is True and PackedFeatureStore(got.shard_dir).feat_norm is True
    close(rows(got, rel), rows(want, rel))
    np.testing.assert_allclose(np.square(rows(got, rel)).mean(-1), 1.0, rtol=1e-4)


def test_dir_reuse_clears_stale_scales(images, tmp_path):
    root, rel = images
    bb = params_from_jax(jax_vgg(4))
    out = str(tmp_path / "shard")
    kw = dict(size=32, batch_size=2, backend="pil", device="cpu")
    TPC.precompute_features(os.path.join(root, "imgs"), rel, out, "vgg16", bb,
                            dtype="int8", **kw)
    assert os.path.exists(os.path.join(out, "scales.npy"))
    store = TPC.precompute_features(os.path.join(root, "imgs"), rel, out, "vgg16", bb, **kw)
    assert not os.path.exists(os.path.join(out, "scales.npy")) and store.scales is None


def test_refusals_and_the_device_rule(images, tmp_path, monkeypatch):
    root, rel = images
    bb = params_from_jax(jax_vgg(0))
    args = (os.path.join(root, "imgs"), rel, str(tmp_path / "s"), "vgg16", bb)
    with pytest.raises(NotImplementedError, match="queue 1, item 7, multi-device"):
        TPC.precompute_features(*args, size=32, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="no images"):
        TPC.precompute_features(args[0], [], *args[2:], size=32, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TPC.precompute_features(*args, size=32)


def test_stall_watchdog_lifecycle():
    from rau_vqa_tpu_torch.utils.rigcheck import StallWatchdog
    w = StallWatchdog("test", timeout_s=60)
    assert w._timer is not None and w._timer.daemon
    w.poke()
    w.cancel()
    assert w._timer is None
    off = StallWatchdog("test", timeout_s=0)
    off.poke()
    assert off._timer is None
    off.cancel()


def test_cli_precompute_features_vgg16(images, tmp_path, monkeypatch, capsys):
    """The command as the JAX CLI's: a scan of --image-root, or the json's
    unique_img lists with --vqa-dir; it prints the decoder that ran."""
    root, rel = images
    bb = jax_vgg(5)
    monkeypatch.setattr(jcli, "_load_backbone_state", lambda b, s: bb)
    monkeypatch.setattr(tcli, "_load_backbone_state",
                        lambda b, s, device, dtype=None: params_from_jax(bb))
    flags = ["--image-root", os.path.join(root, "imgs"), "--backbone", "vgg16",
             "--size", "32", "--batch", "2", "--backend", "pil"]
    assert jcli.main(["precompute-features", "--out", str(tmp_path / "j"), *flags]) == 0
    assert tcli.main(["--device", "cpu", "precompute-features",
                      "--out", str(tmp_path / "t"), *flags]) == 0
    assert "images decoded by: pil 5" in capsys.readouterr().out
    want, got = PackedFeatureStore(str(tmp_path / "j")), PackedFeatureStore(str(tmp_path / "t"))
    assert got.index == want.index and len(got.index) == 5
    close(rows(got, rel), rows(want, rel))
    vqa = tmp_path / "vqa"
    vqa.mkdir()
    (vqa / "data_prepro.json").write_text(json.dumps({"unique_img_train": rel[:2],
                                                      "unique_img_test": rel[4:]}))
    assert tcli.main(["--device", "cpu", "precompute-features", "--out",
                      str(tmp_path / "t2"), "--vqa-dir", str(vqa), *flags]) == 0
    assert len(PackedFeatureStore(str(tmp_path / "t2")).index) == 3
    with pytest.raises(NotImplementedError, match="multi-device"):
        tcli.main(["--device", "cpu", "precompute-features", "--out",
                   str(tmp_path / "t3"), "--mesh-data", "2", *flags])


def test_cli_precompute_features_vit_from_a_timm_state(images, tmp_path, monkeypatch):
    """``--backbone vit`` reads a timm state dict (.pth) into the ViT-L/14
    config (a tiny one here, in both packages) and writes JAX's rows; a size
    other than the config's is refused."""
    root, rel = images
    state = {k: torch.as_tensor(v) for k, v in
             _timm_state(np.random.RandomState(8), JTINY).items()}
    pth = str(tmp_path / "vit.pth")
    torch.save(state, pth)
    monkeypatch.setattr(JVT, "VIT_L14", JTINY)
    monkeypatch.setattr(TVT, "VIT_L14", TTINY)
    flags = ["--image-root", os.path.join(root, "imgs"), "--backbone", "vit",
             "--backbone-state", pth, "--batch", "2", "--backend", "pil"]
    assert jcli.main(["precompute-features", "--out", str(tmp_path / "j"),
                      "--size", "28", *flags]) == 0
    assert tcli.main(["--device", "cpu", "precompute-features", "--out", str(tmp_path / "t"),
                      "--size", "28", *flags]) == 0
    want, got = PackedFeatureStore(str(tmp_path / "j")), PackedFeatureStore(str(tmp_path / "t"))
    assert (got.spat, got.dim) == (TTINY.seq, TTINY.dim)
    np.testing.assert_allclose(rows(got, rel), rows(want, rel), rtol=1e-5, atol=1e-5)
    with pytest.raises(SystemExit):
        tcli.main(["--device", "cpu", "precompute-features", "--out", str(tmp_path / "bad"),
                   "--size", "448", *flags])
    with pytest.raises(NotImplementedError, match="fine-tuning"):
        tcli.main(["--device", "cpu", "precompute-features", "--out", str(tmp_path / "ft"),
                   "--size", "28", *flags[:-6], "--backbone-state", "ft.msgpack"])


def test_the_decoder_that_ran_is_reported(images, tmp_path, monkeypatch):
    """Where the native decoder cannot be built the source decodes with PIL,
    and says so with the compiler's error line; the shard's rows are PIL's."""
    from rau_vqa_tpu_torch.data import native
    root, rel = images

    def unavailable(*a, **k):
        raise native.NativeUnavailable(
            "libimage_decode.so: Command 'g++' returned non-zero exit status 1.\n"
            "native/image_decode.cpp:32:10: fatal error: jpeglib.h: No such file or directory")
    monkeypatch.setattr(native, "decode_image_batch_status", unavailable)
    bb = params_from_jax(jax_vgg(6))
    store = TPC.precompute_features(os.path.join(root, "imgs"), rel, str(tmp_path / "s"),
                                    "vgg16", bb, size=32, batch_size=2, device="cpu")
    assert store.decoder == ("pil 5 (the native decoder is unavailable: native/image_decode"
                             ".cpp:32:10: fatal error: jpeglib.h: No such file or directory)")
    want = TPC.precompute_features(os.path.join(root, "imgs"), rel, str(tmp_path / "p"),
                                   "vgg16", bb, size=32, batch_size=2, backend="pil",
                                   device="cpu")
    np.testing.assert_array_equal(rows(store, rel), rows(want, rel))
