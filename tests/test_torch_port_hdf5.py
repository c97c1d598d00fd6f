"""The port's HDF5 reader and writer (rau_vqa_tpu_torch/data/hdf5.py) held
to h5py in both directions: what the port writes h5py reads bit for bit
(and can append to), what h5py writes with its defaults the port reads bit
for bit, each layout outside the subset is refused by name, and a bundle
the port writes loads through both packages' ``load_vqa_data`` to the same
arrays.  Exact equality throughout: integers carry no tolerance."""

import os

import h5py
import numpy as np
import pytest

from rau_vqa_tpu_torch.data.hdf5 import UnsupportedHDF5, h5_names, read_h5, write_h5

DTYPES = ("i1", "i2", "i4", "i8", "u1", "u2", "u4", "u8")


def random_arrays(rs, n):
    """``n`` arrays over every integer type, ranks 1-3, some with no element,
    each type's full range."""
    out = {}
    for i in range(n):
        dt = np.dtype(DTYPES[i % len(DTYPES)] if i < len(DTYPES)
                      else rs.choice(DTYPES))
        rank = 1 + i % 3
        shape = tuple(int(x) for x in rs.integers(0 if i % 5 == 4 else 1, 5, size=rank))
        info = np.iinfo(dt)
        a = (rs.integers(info.min, info.max, size=shape, dtype=dt, endpoint=True)
             if int(np.prod(shape)) else np.zeros(shape, dt))
        out[f"ds_{i:03d}_{dt.str[1:]}"] = a
    return out


def assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert np.array_equal(got[k], v), k


# 1 dataset (one leaf), 8 (one full leaf), 9 and 40 (two and five leaves
# under one node), 300 (38 leaves: a second B-tree level)
@pytest.mark.parametrize("n", [1, 8, 9, 40, 300])
def test_port_writes_h5py_reads(tmp_path, n):
    arrays = random_arrays(np.random.default_rng(n), n)
    path = str(tmp_path / "port.h5")
    write_h5(path, arrays)
    with h5py.File(path, "r") as f:
        assert_same({k: f[k][()] for k in f.keys()}, arrays)
    assert_same(read_h5(path), arrays)
    assert h5_names(path) == sorted(arrays)
    # the library can insert into the port's B-tree and heap
    with h5py.File(path, "a") as f:
        f["zz_added"] = np.arange(5, dtype=np.int16)
        f["aa_added"] = np.arange(3, dtype=np.uint64)
    got = read_h5(path)
    assert_same({k: got[k] for k in arrays}, arrays)
    assert np.array_equal(got["zz_added"], np.arange(5, dtype=np.int16))
    assert got["aa_added"].dtype == np.uint64


@pytest.mark.parametrize("n", [1, 8, 9, 40, 300])
def test_h5py_writes_port_reads(tmp_path, n):
    arrays = random_arrays(np.random.default_rng(100 + n), n)
    path = str(tmp_path / "h5py.h5")
    with h5py.File(path, "w") as f:
        for k, v in arrays.items():
            f[k] = v
    assert_same(read_h5(path), arrays)
    assert h5_names(path) == sorted(arrays)
    with h5py.File(path, "r") as f:
        empty = [k for k, v in arrays.items() if v.size == 0]
        # a dataset of no element has no storage address (it reads as such)
        assert all(f[k].id.get_offset() is None for k in empty)


def test_zero_element_datasets_and_an_empty_group(tmp_path):
    path = str(tmp_path / "e.h5")
    arrays = {"ques_test": np.zeros((0, 26), np.int32),
              "question_id_test": np.zeros((0,), np.int64)}
    write_h5(path, arrays)
    with h5py.File(path, "r") as f:
        assert f["ques_test"].shape == (0, 26)
        assert f["ques_test"].id.get_offset() is None
    assert_same(read_h5(path), arrays)
    write_h5(path, {})
    with h5py.File(path, "r") as f:
        assert list(f.keys()) == []
    assert read_h5(path) == {}


def test_refuses_a_dataset_never_written(tmp_path):
    """A dataset created without data has elements but no storage: refused
    by name (a bundle's datasets are all written)."""
    path = str(tmp_path / "u.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("x", shape=(3, 2), dtype="i4")
    with pytest.raises(UnsupportedHDF5, match="6 elements but no storage"):
        read_h5(path)


def _refused(tmp_path):
    """(name, writer, the words the refusal must carry) for each layout
    outside the subset."""
    def chunked(f):
        f.create_dataset("x", data=np.arange(10), chunks=(5,))

    def gzip(f):
        f.create_dataset("x", data=np.arange(10), compression="gzip")

    def compact(f):
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        h5py.h5d.create(f.id, b"x", h5py.h5t.STD_I32LE,
                        h5py.h5s.create_simple((4,)), dcpl=dcpl)

    return [
        ("chunked", chunked, {}, "chunked layout"),
        ("gzip", gzip, {}, "filter pipeline (deflate (gzip))"),
        ("compact", compact, {}, "compact layout"),
        ("latest", lambda f: f.__setitem__("x", np.arange(3)), {"libver": "latest"},
         "superblock version 3"),
        ("big-endian", lambda f: f.__setitem__("x", np.arange(3).astype(">i4")), {},
         "big-endian"),
        ("float", lambda f: f.__setitem__("x", np.arange(3.0)), {}, "is a float"),
        ("string", lambda f: f.__setitem__("x", np.array([b"abc"])), {}, "is a string"),
        ("vlen-string", lambda f: f.__setitem__(
            "x", np.array(["abc"], dtype=h5py.string_dtype())), {}, "variable-length"),
        ("group", lambda f: f.create_group("g").__setitem__("x", np.arange(2)), {},
         "nested group"),
    ]


@pytest.mark.parametrize("case", range(9), ids=[c[0] for c in _refused(None)])
def test_refuses_each_layout_outside_the_subset_by_name(tmp_path, case):
    name, write, kw, words = _refused(tmp_path)[case]
    path = str(tmp_path / f"{name}.h5")
    with h5py.File(path, "w", **kw) as f:
        write(f)
    with pytest.raises(UnsupportedHDF5) as e:
        read_h5(path)
    assert words in str(e.value)
    # each refusal's message is its own
    others = [w for i, (_, _, _, w) in enumerate(_refused(tmp_path)) if i != case]
    assert not any(w in str(e.value) for w in others if w not in words)
    if name == "latest":
        assert "OHDR" in str(e.value) and "libver 'latest'" in str(e.value)


def test_writer_refuses_what_it_cannot_write(tmp_path):
    path = str(tmp_path / "w.h5")
    for bad, words in (({"x": np.arange(3.0)}, "only 1, 2, 4 and 8-byte integers"),
                       ({"x": np.array(["a"])}, "only 1, 2, 4 and 8-byte integers"),
                       ({"a/b": np.arange(3)}, "a plain name"),
                       ({"x": np.int32(3)}, "a scalar")):
        with pytest.raises(ValueError, match=words):
            write_h5(path, bad)
    # a big-endian array is written little-endian, values unchanged
    write_h5(path, {"x": np.arange(5).astype(">i2")})
    with h5py.File(path, "r") as f:
        assert f["x"].dtype == np.dtype("<i2")
        assert np.array_equal(f["x"][()], np.arange(5))


def test_port_bundle_loads_through_both_packages(tmp_path):
    """The fixture's bundle written by the port (generate_fixture, through
    data/hdf5.py) loads through the JAX package's load_vqa_data (h5py) and
    the port's to the same VQAData arrays; the h5 arrays equal the JAX
    fixture's, written by h5py from the same seed."""
    from rau_vqa_tpu.data.fixtures import FixtureSpec as JSpec
    from rau_vqa_tpu.data.fixtures import generate_fixture as jgen
    from rau_vqa_tpu.data.loader import load_vqa_data as jload
    from rau_vqa_tpu_torch.data.fixtures import FixtureSpec, generate_fixture
    from rau_vqa_tpu_torch.data.loader import load_vqa_data

    vqa_t = generate_fixture(str(tmp_path / "port"), FixtureSpec())
    vqa_j = jgen(str(tmp_path / "jax"), JSpec())
    with h5py.File(os.path.join(vqa_j, "data_prepro.h5"), "r") as f:
        assert_same(read_h5(os.path.join(vqa_t, "data_prepro.h5")),
                    {k: f[k][()] for k in f.keys()})
    for split in ("val2014", "test2015"):
        jd = jload(vqa_t, 16, split=split, test_batch_size=8)
        td = load_vqa_data(vqa_t, 16, split=split, test_batch_size=8)
        assert (jd.vocab, jd.answers) == (td.vocab, td.answers)
        for a, b in ((jd.train_data, td.train_data), (jd.test_data, td.test_data)):
            for attr in ("questions", "lengths", "qids", "datatypes", "answers",
                         "mc_answers"):
                x, y = getattr(a, attr, None), getattr(b, attr, None)
                assert (x is None) == (y is None), attr
                if x is not None:
                    assert np.array_equal(np.asarray(x), np.asarray(y)), attr
            assert a.img_names == b.img_names and a.img_paths == b.img_paths


def test_read_prepro_keeps_unsigned_types(tmp_path):
    """A bundle from other preprocessing may store unsigned ints: read as
    stored, the splits built from the values unchanged."""
    from rau_vqa_tpu_torch.data.fixtures import FixtureSpec, fixture_bundle
    from rau_vqa_tpu_torch.data.loader import build_vqa_data, load_vqa_data, read_prepro
    import json

    b = fixture_bundle(str(tmp_path / "fx"), FixtureSpec())
    vqa = tmp_path / "u"
    vqa.mkdir()
    arrays = {k: v.astype(np.uint32) for k, v in b.arrays.items()}
    write_h5(str(vqa / "data_prepro.h5"), arrays)
    (vqa / "data_prepro.json").write_text(json.dumps(b.info))
    _, got = read_prepro(str(vqa))
    assert all(got[k].dtype == np.uint32 for k in got)
    d1 = load_vqa_data(str(vqa), 16, test_batch_size=8)
    d2 = build_vqa_data(b.info, b.arrays, 16, test_batch_size=8)
    assert np.array_equal(d1.train_data.questions, d2.train_data.questions)
    assert np.array_equal(d1.train_data.answers, d2.train_data.answers)
