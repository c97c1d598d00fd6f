"""The port's data layer (rau_vqa_tpu_torch/data) against the JAX package's
(rau_vqa_tpu/data), on the same seeded fixture.

Bars: exact everywhere — the same files byte for byte, the same arrays, the
same batches in the same order (both loaders are numpy on the host)."""

import dataclasses
import json
import os
import sys
import threading

import numpy as np
import pytest

from rau_vqa_tpu.data import features as jfeat
from rau_vqa_tpu.data import fixtures as jfix
from rau_vqa_tpu.data import loader as jload
from rau_vqa_tpu.data import t7 as jt7
from rau_vqa_tpu_torch.data import features as tfeat
from rau_vqa_tpu_torch.data import fixtures as tfix
from rau_vqa_tpu_torch.data import loader as tload
from rau_vqa_tpu_torch.data import t7 as tt7

SPEC = jfix.FixtureSpec()
SPECS = {
    "default": (SPEC, {}),
    "dense_uniform": (jfix.FixtureSpec(n_train=120, n_test=20, n_images=30,
                                       n_answers=7, n_img_classes=3,
                                       class_code="dense", seed=11),
                      {"uniform_img_assign": True}),
}


def port_spec(spec):
    return tfix.FixtureSpec(**{k: getattr(spec, k)
                               for k in spec.__dataclass_fields__})


@pytest.fixture(scope="module")
def jax_fixture(tmp_path_factory):
    """JAX's fixture with uniform questions-per-image ('imggroup' needs it)."""
    root = str(tmp_path_factory.mktemp("jax_fixture"))
    jfix.generate_fixture(root, SPEC, uniform_img_assign=True)
    return root


def t7_source(mod, root, spec=SPEC):
    return mod.T7DirFeatureSource([os.path.join(root, "feat")], spec.feat_dim,
                                  spec.feat_w, spec.feat_h)


def assert_batches_equal(a, b):
    for name in ("tokens", "lengths", "labels", "mc_answers", "qids", "feats"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=name)
            assert np.asarray(x).dtype == np.asarray(y).dtype, name


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", sorted(SPECS))
def test_generate_fixture_writes_the_jax_files(tmp_path, which):
    import h5py
    spec, kw = SPECS[which]
    jdir = jfix.generate_fixture(str(tmp_path / "j"), spec, **kw)
    tdir = tfix.generate_fixture(str(tmp_path / "t"), port_spec(spec), **kw)
    for name in ("data_prepro.json", "gt_annotations.json"):
        with open(os.path.join(jdir, name)) as f1, \
                open(os.path.join(tdir, name)) as f2:
            assert json.load(f1) == json.load(f2), name
    with h5py.File(os.path.join(jdir, "data_prepro.h5")) as hj, \
            h5py.File(os.path.join(tdir, "data_prepro.h5")) as ht:
        assert sorted(hj) == sorted(ht)
        for k in hj:
            np.testing.assert_array_equal(hj[k][()], ht[k][()], err_msg=k)
            assert hj[k].dtype == ht[k].dtype, k
    jfeat_dir, tfeat_dir = tmp_path / "j" / "feat", tmp_path / "t" / "feat"
    names = sorted(os.listdir(jfeat_dir))
    assert names == sorted(os.listdir(tfeat_dir)) and names
    for n in names:
        assert (jfeat_dir / n).read_bytes() == (tfeat_dir / n).read_bytes(), n


def test_fixture_bundle_is_the_files_in_memory(tmp_path):
    """The in-memory bundle is what read_prepro reads back from the files
    generate_fixture wrote, and it builds the same VQAData."""
    vqa_dir = tfix.generate_fixture(str(tmp_path / "files"), SPEC)
    bundle = tfix.fixture_bundle(str(tmp_path / "mem"), SPEC)
    info, arrays = tload.read_prepro(vqa_dir)
    assert bundle.info == info
    assert sorted(bundle.arrays) == sorted(arrays)
    for k in arrays:
        np.testing.assert_array_equal(bundle.arrays[k], arrays[k], err_msg=k)
    with open(os.path.join(vqa_dir, "gt_annotations.json")) as f:
        assert bundle.gt == json.load(f)
    assert sorted(os.listdir(bundle.feat_dir)) == sorted(
        os.listdir(tmp_path / "files" / "feat"))
    a = tload.build_vqa_data(bundle.info, bundle.arrays, 16, test_batch_size=8)
    b = tload.load_vqa_data(vqa_dir, 16, test_batch_size=8)
    assert a.vocab == b.vocab and a.answers == b.answers
    np.testing.assert_array_equal(a.train_data.questions, b.train_data.questions)


def test_fixture_images_need_pil(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="PIL"):
        tfix.fixture_bundle(str(tmp_path), SPEC, images=True)


# ---------------------------------------------------------------------------
# the loader
# ---------------------------------------------------------------------------

def test_read_prepro_names_h5py_when_it_is_missing(jax_fixture, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py") as e:
        tload.load_vqa_data(os.path.join(jax_fixture, "vqa_prepro"), 16)
    assert "data_prepro.h5" in str(e.value)


def test_vocab_answers_and_tokens_match_jax(jax_fixture):
    vqa_dir = os.path.join(jax_fixture, "vqa_prepro")
    j = jload.load_vqa_data(vqa_dir, 16, split="val2014", test_batch_size=8)
    t = tload.load_vqa_data(vqa_dir, 16, split="val2014", test_batch_size=8)
    assert t.vocab == j.vocab and t.vocab_map == j.vocab_map
    assert t.answers == j.answers and t.answer_map == j.answer_map
    assert (t.seq_len, t.vocab_size, t.answer_size) == \
        (j.seq_len, j.vocab_size, j.answer_size)
    for q in ("w01 w02 w03", "What color, is W04?", "unknown words here",
              " ".join(["w05"] * 40)):
        for normalize in (False, True):
            jt, jl = j.question_to_tokens(q, normalize=normalize)
            tt, tl = t.question_to_tokens(q, normalize=normalize)
            np.testing.assert_array_equal(tt, jt)
            assert tl == jl
    assert t.tokens_to_question(t.test_data.questions[0], 3) == \
        j.tokens_to_question(j.test_data.questions[0], 3)
    gt = os.path.join(vqa_dir, "gt_annotations.json")
    assert tload.load_gt_annotations(gt) == jload.load_gt_annotations(gt)


@pytest.mark.parametrize("order", ["shuffle", "inorder", "sort", "randsort",
                                   "imggroup"])
def test_three_epochs_of_batches_match_jax(jax_fixture, order):
    vqa_dir = os.path.join(jax_fixture, "vqa_prepro")
    j = jload.load_vqa_data(vqa_dir, 16, split="val2014", seed=5)
    t = tload.load_vqa_data(vqa_dir, 16, split="val2014", seed=5)
    js, ts = t7_source(jfeat, jax_fixture), t7_source(tfeat, jax_fixture)
    for split in (j.train_data, t.train_data):
        split.set_batch_order_option(order)
        split.reorder()
    n = 0
    for _ in range(3):
        for a, b in zip(j.train_data.batches(js), t.train_data.batches(ts)):
            assert_batches_equal(a, b)
            n += 1
        assert t.train_data.reorder_count == j.train_data.reorder_count
    assert n == 3 * j.train_data.iter_per_epoch
    # an abandoned generator rewinds the order alike (the trainer's abort)
    for split, src in ((j.train_data, js), (t.train_data, ts)):
        it = split.batches(src)
        next(it)
        it.close()
    assert t.train_data.batch_index == j.train_data.batch_index
    np.testing.assert_array_equal(t.train_data.batch_order,
                                  j.train_data.batch_order)


@pytest.mark.parametrize("test_batch_size", [7, 8, 40])
def test_test_split_with_tail_matches_jax(jax_fixture, test_batch_size):
    vqa_dir = os.path.join(jax_fixture, "vqa_prepro")
    j = jload.load_vqa_data(vqa_dir, 16, test_batch_size=test_batch_size)
    t = tload.load_vqa_data(vqa_dir, 16, test_batch_size=test_batch_size)
    js, ts = t7_source(jfeat, jax_fixture), t7_source(tfeat, jax_fixture)
    j.test_data.inorder()
    t.test_data.inorder()
    jb = list(j.test_data.batches(js, include_tail=True))
    tb = list(t.test_data.batches(ts, include_tail=True))
    assert len(jb) == len(tb)
    for a, b in zip(jb, tb):
        assert_batches_equal(a, b)
    assert sum(len(b.qids) for b in tb) == SPEC.n_test


@pytest.mark.parametrize("prefetch", [True, False])
def test_finish_maps_each_batch(jax_fixture, prefetch):
    """``batches(finish=)`` yields what ``finish`` made of each batch, the
    tail included; with prefetch ``finish`` runs in the worker.  The
    batches, the order and an abandoned generator's rewind are JAX's."""
    vqa_dir = os.path.join(jax_fixture, "vqa_prepro")
    j = jload.load_vqa_data(vqa_dir, 16, test_batch_size=7, seed=5)
    t = tload.load_vqa_data(vqa_dir, 16, test_batch_size=7, seed=5)
    js, ts = t7_source(jfeat, jax_fixture), t7_source(tfeat, jax_fixture)
    made, threads = [], set()

    def finish(batch):
        threads.add(threading.get_ident())
        made.append(dataclasses.replace(batch))
        return made[-1]

    for sj, st, kw in ((j.train_data, t.train_data, {}),
                       (j.test_data, t.test_data, {"include_tail": True})):
        a = list(sj.batches(js, prefetch=prefetch, **kw))
        b = list(st.batches(ts, prefetch=prefetch, finish=finish, **kw))
        assert len(a) == len(b) and all(x is y for x, y in zip(b, made[-len(b):]))
        for x, y in zip(a, b):
            assert_batches_equal(x, y)
    assert len(made) == t.train_data.iter_per_epoch + -(-SPEC.n_test // 7)
    assert (threading.get_ident() in threads) != prefetch
    for split, src, kw in ((j.train_data, js, {}),
                           (t.train_data, ts, {"finish": finish})):
        it = split.batches(src, prefetch=prefetch, **kw)
        next(it)
        it.close()
    assert t.train_data.batch_index == j.train_data.batch_index
    np.testing.assert_array_equal(t.train_data.batch_order,
                                  j.train_data.batch_order)


def test_valid_ratio_split_matches_jax(jax_fixture):
    vqa_dir = os.path.join(jax_fixture, "vqa_prepro")
    j = jload.load_vqa_data(vqa_dir, 8, valid_ratio=0.25, seed=3)
    t = tload.load_vqa_data(vqa_dir, 8, valid_ratio=0.25, seed=3)
    for name in ("train_data", "val_data", "test_data"):
        a, b = getattr(j, name), getattr(t, name)
        assert (a.name, a.num_examples, a.seed) == (b.name, b.num_examples, b.seed)
        for k in ("questions", "lengths", "qids", "datatypes"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
        assert a.img_names == b.img_names and a.img_paths == b.img_paths
    with pytest.raises(ValueError, match="valid_ratio"):
        tload.load_vqa_data(vqa_dir, 8, valid_ratio=1.5)


# ---------------------------------------------------------------------------
# feature stores and the t7 codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_packed_store_reads_the_jax_shard(jax_fixture, tmp_path, dtype):
    with open(os.path.join(jax_fixture, "vqa_prepro", "data_prepro.json")) as f:
        info = json.load(f)
    imgs = sorted(set(info["unique_img_train"] + info["unique_img_test"]))
    out = str(tmp_path / "packed")
    jfeat.pack_feature_dir([os.path.join(jax_fixture, "feat")], imgs,
                           [1] * len(imgs), out, SPEC.feat_dim, SPEC.feat_w,
                           SPEC.feat_h, dtype=dtype)
    names = [jfeat.coco_feat_name(p) for p in imgs[::3]]
    assert names == [tfeat.coco_feat_name(p) for p in imgs[::3]]
    for raw in (False, True):
        js = jfeat.PackedFeatureStore(out, raw_int8=raw)
        ts = tfeat.PackedFeatureStore(out, raw_int8=raw)
        assert (ts.dim, ts.spat, ts.feat_norm, ts.raw_int8) == \
            (js.dim, js.spat, js.feat_norm, js.raw_int8)
        a, b = js.get_batch(names, [1] * len(names)), \
            ts.get_batch(names, [1] * len(names))
        if ts.raw_int8:
            assert isinstance(b, tfeat.QuantFeats)
            np.testing.assert_array_equal(b.values, a.values)
            np.testing.assert_array_equal(b.scales, a.scales)
            np.testing.assert_array_equal(b.dequantize(), a.dequantize())
        else:
            np.testing.assert_array_equal(b, a)
            assert b.dtype == a.dtype


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_port_shard_writer_is_read_by_jax(tmp_path, dtype):
    rs = np.random.RandomState(0)
    block = rs.randn(6, 4, 5).astype(np.float32)
    names = [f"img{i}.t7" for i in range(6)]
    w = tfeat.PackedShardWriter(str(tmp_path / "s"), 6, 4, 5, dtype=dtype)
    w.write(0, block[:4])
    w.write(4, block[4:])
    w.finish(names)
    js = jfeat.PackedFeatureStore(str(tmp_path / "s"))
    jw = jfeat.PackedShardWriter(str(tmp_path / "j"), 6, 4, 5, dtype=dtype)
    jw.write(0, block)
    jw.finish(names)
    for p in ("features.npy", "index.json") + (("scales.npy",)
                                               if dtype == "int8" else ()):
        assert (tmp_path / "s" / p).read_bytes() == (tmp_path / "j" / p).read_bytes()
    np.testing.assert_array_equal(js.get_batch(names, [1] * 6),
                                  jfeat.PackedFeatureStore(
                                      str(tmp_path / "j")).get_batch(names, [1] * 6))


def test_feat_interface_check_matches_jax(tmp_path):
    w = tfeat.PackedShardWriter(str(tmp_path / "s"), 1, 2, 3, feat_norm=True)
    w.write(0, np.ones((1, 2, 3), np.float32))
    w.finish(["a.t7"])
    store = tfeat.PackedFeatureStore(str(tmp_path / "s"))
    tfeat.check_feat_interface(store, True, "test")
    with pytest.raises(ValueError, match="feat_norm=True"):
        tfeat.check_feat_interface(store, False, "test")
    with pytest.raises(ValueError, match="feat_norm=True"):
        jfeat.check_feat_interface(jfeat.PackedFeatureStore(str(tmp_path / "s")),
                                   False, "test")


def test_t7_reader_and_writer_match_jax(tmp_path):
    rs = np.random.RandomState(1)
    objs = {
        "f32": rs.randn(3, 4, 5).astype(np.float32),
        "f64": rs.randn(7),
        "i64": rs.randint(-9, 9, (2, 3)).astype(np.int64),
        "i32": rs.randint(-9, 9, (4,)).astype(np.int32),
        "u8": rs.randint(0, 255, (3, 3)).astype(np.uint8),
        "table": {"it": 12.0, "opt": {"name": "x", "flag": True},
                  "params": [rs.randn(4).astype(np.float32), None, "s"]},
        "strided": rs.randn(6, 4).astype(np.float32).T,
    }
    for k, obj in objs.items():
        jp, tp = tmp_path / f"{k}.j.t7", tmp_path / f"{k}.t.t7"
        jt7.save_t7(str(jp), obj)
        tt7.save_t7(str(tp), obj)
        assert jp.read_bytes() == tp.read_bytes(), k
        a, b = jt7.load_t7(str(jp)), tt7.load_t7(str(jp))

        def same(x, y):
            if isinstance(x, np.ndarray):
                np.testing.assert_array_equal(x, y)
                assert x.dtype == y.dtype
            elif isinstance(x, dict):
                assert sorted(x, key=str) == sorted(y, key=str)
                for kk in x:
                    same(x[kk], y[kk])
            elif isinstance(x, list):
                assert len(x) == len(y)
                for xx, yy in zip(x, y):
                    same(xx, yy)
            else:
                assert x == y
        same(a, b)
    # the fixture's own feature files
    feat = rs.randn(SPEC.feat_dim, SPEC.feat_w, SPEC.feat_h).astype(np.float32)
    jt7.save_t7(str(tmp_path / "COCO_x.t7"), feat)
    js = jfeat.T7DirFeatureSource([str(tmp_path)], SPEC.feat_dim, SPEC.feat_w,
                                  SPEC.feat_h)
    ts = tfeat.T7DirFeatureSource([str(tmp_path)], SPEC.feat_dim, SPEC.feat_w,
                                  SPEC.feat_h)
    np.testing.assert_array_equal(ts.get_batch(["COCO_x.t7"], [1]),
                                  js.get_batch(["COCO_x.t7"], [1]))
    with pytest.raises(ValueError, match="1-based"):
        ts.get_batch(["COCO_x.t7"], [0])

