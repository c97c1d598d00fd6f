"""The rest of the paper's workflow on the port, against the JAX package on
the same inputs: the ``vqa-accuracy`` command (tests/test_vqa_accuracy.py
:132, its printed report and ``--out`` JSON), the attention dumps
(tests/test_observability.py:101 on the port, and ``Trainer.evaluate``'s
dumps on the same weights: the same file names, PNG pixels within 1 of
255), ``train --visatt`` through the CLI, and ``pack-features`` routing each
image by the datatype that data/hdf5.py reads from the bundle."""

import glob
import json
import os

import jax
import numpy as np
import pytest
from PIL import Image

from rau_vqa_tpu.utils import visatt as jvis
from rau_vqa_tpu_torch.convert import params_from_jax
from rau_vqa_tpu_torch.utils import visatt as tvis
from tests.test_torch_port_trainer import (  # noqa: F401 (an autouse fixture)
    SPEC,
    fixture_root,
    jax_trainer,
    one_torch_thread,
    port_trainer,
)
from tests.test_vqa_accuracy import _ann


def test_cli_vqa_accuracy(tmp_path, capsys):
    """Both CLIs on the same results and annotations: the same printed
    report (the per-question-type table too) and the same --out JSON."""
    from rau_vqa_tpu.cli import main as jmain
    from rau_vqa_tpu_torch.cli import main as tmain

    res_p, ann_p = tmp_path / "results.json", tmp_path / "ann.json"
    res_p.write_text(json.dumps([{"question_id": 1, "answer": "yes"},
                                 {"question_id": 2, "answer": "Two"},
                                 {"question_id": 3, "answer": "red"}]))
    ann_p.write_text(json.dumps({"annotations": [
        _ann(1, ["yes"] * 10, atype="yes/no"),
        _ann(2, ["2"] * 4 + ["3"] * 6, atype="number", qtype="how many"),
        _ann(4, ["blue"] * 10)]}))
    outs, reports = [], []
    for name, main in (("jax", jmain), ("port", tmain)):
        rep_p = tmp_path / f"report_{name}.json"
        assert main(["vqa-accuracy", "--results", str(res_p), "--annotations",
                     str(ann_p), "--out", str(rep_p), "--question-types",
                     "--precision", "3"]) == 0
        outs.append(capsys.readouterr().out.replace(str(rep_p), "REPORT"))
        reports.append(json.loads(rep_p.read_text()))
    assert outs[0] == outs[1]
    assert reports[0] == reports[1]
    assert "overall: " in outs[1] and "per_question_type:" in outs[1]
    # the case of tests/test_vqa_accuracy.py:132
    res_p.write_text(json.dumps([{"question_id": 1, "answer": "yes"}]))
    ann_p.write_text(json.dumps({"annotations": [_ann(1, ["yes"] * 10, atype="yes/no")]}))
    assert tmain(["vqa-accuracy", "--results", str(res_p), "--annotations", str(ann_p),
                  "--out", str(tmp_path / "r.json")]) == 0
    assert "overall: 100.00" in capsys.readouterr().out
    assert json.loads((tmp_path / "r.json").read_text())["overall"] == 100.0


def _pngs(root):
    out = {}
    for p in sorted(glob.glob(os.path.join(str(root), "**", "*.png"), recursive=True)):
        out[os.path.relpath(p, str(root))] = np.asarray(Image.open(p))
    return out


def test_attention_dumps(tmp_path):
    """tests/test_observability.py:101 on the port, and the same files as
    the JAX package's on the same maps, pixel for pixel."""
    rs = np.random.RandomState(0)
    att = rs.rand(4, 3, 6).astype(np.float32)    # [H+2, B, S], a 3x2 grid
    n = tvis.dump_attention_maps(str(tmp_path / "port" / "figures"), 2.0, att,
                                 [101, 102, 103], 3, 2)
    assert n == 12
    files = glob.glob(str(tmp_path / "port" / "figures" / "epoch_002" / "hop_001" / "*.png"))
    assert len(files) == 3
    assert jvis.dump_attention_maps(str(tmp_path / "jax" / "figures"), 2.0, att,
                                    [101, 102, 103], 3, 2) == n
    got, want = _pngs(tmp_path / "port"), _pngs(tmp_path / "jax")
    assert sorted(got) == sorted(want) and len(got) == 12
    for k in want:
        assert got[k].shape == (48, 32) and got[k].dtype == np.uint8
        assert np.array_equal(got[k], want[k]), k
    tvis.save_attention_png(str(tmp_path / "flat.png"), np.full((3, 2), 0.5, np.float32))
    assert os.path.getsize(str(tmp_path / "flat.png")) > 0
    assert not np.asarray(Image.open(str(tmp_path / "flat.png"))).any()
    for B, cols in ((2, 5), (5, 0), (4, 2)):
        imgs = rs.rand(B, 4, 3).astype(np.float32)
        assert np.array_equal(tvis.tile_batch_images(imgs, cols),
                              jvis.tile_batch_images(imgs, cols))


@pytest.mark.parametrize("fused_eval", [False, True])
def test_trainer_dumps_match_jax(fixture_root, tmp_path, fused_eval):
    """Trainer.evaluate with visatt on the same weights (the JAX init through
    convert.py) and fixture: the port writes the file names the JAX package
    writes, for the first visatt_batches test batches (the tail batch of 2
    questions too, its padding dropped), and the pixels of each map within
    1 of 255 (fused_eval: the kernels' plain versions with bf16 products;
    else the plain float32 path)."""
    jt = jax_trainer(fixture_root, tmp_path / "jax", test_batch_size=6)
    jt.exp = jt.exp.replace(visatt=True, visatt_batches=-1)
    tt = port_trainer(fixture_root, tmp_path / "port", test_batch_size=6,
                      visatt=True, visatt_batches=-1, fused_eval=fused_eval)
    tt.state = tt.state._replace(
        params=params_from_jax(jax.tree.map(np.asarray, jt.state.params)))
    jt.evaluate(write_submissions=False)
    tt.evaluate(write_submissions=False)
    got, want = _pngs(tmp_path / "port"), _pngs(tmp_path / "jax")
    H2 = tt.mcfg.n_hops + 2
    assert sorted(got) == sorted(want) and len(got) == H2 * SPEC.n_test
    assert all(k.startswith(os.path.join("figures", "epoch_000", "hop_00")) for k in got)
    worst = max(int(np.abs(got[k].astype(int) - want[k].astype(int)).max()) for k in want)
    assert worst <= 1, worst
    # visatt_batches bounds the files: one batch of 6 questions a hop
    tt.exp = tt.exp.replace(visatt_batches=1)
    tt.workdir = str(tmp_path / "port1")
    tt.evaluate(write_submissions=False)
    assert len(_pngs(tmp_path / "port1")) == H2 * 6


def test_cli_train_visatt(tmp_path, capsys):
    """train --visatt --visatt-batches 1 on the fixture: (nHop+2) x the test
    batch of PNGs an eval epoch, under figures/epoch_%03d/hop_%03d."""
    from rau_vqa_tpu_torch.cli import main
    work = str(tmp_path / "run")
    assert main(["--device", "cpu", "train", "--preset", "ours_ms", "--fixture",
                 "--epochs", "1", "--save-dir", work, "--visatt",
                 "--visatt-batches", "1", "--nhop", "2"]) == 0
    files = _pngs(os.path.join(work, "figures"))
    assert len(files) == 4 * 8
    assert {os.path.dirname(k) for k in files} == {
        os.path.join("epoch_001", f"hop_{h:03d}") for h in range(1, 5)}
    assert all(v.shape == (SPEC.feat_w * 16, SPEC.feat_h * 16) for v in files.values())


def test_pack_features_routes_by_the_bundles_datatype(tmp_path, capsys):
    """A two-source bundle (prepro of train2014 + val2014): pack-features
    reads each image's datatype from data_prepro.h5 through data/hdf5.py
    and takes its features from that source's directory, as the JAX
    command does (its shard index equal)."""
    from rau_vqa_tpu.cli import main as jmain
    from rau_vqa_tpu_torch.cli import main as tmain
    from rau_vqa_tpu_torch.data import t7
    from rau_vqa_tpu_torch.data.features import PackedFeatureStore, coco_feat_name
    from tests.test_prepro import _write_vqa_v1

    rs = np.random.RandomState(5)
    t1q, t1a = _write_vqa_v1(str(tmp_path), "train2014", 10, rs=rs)
    t2q, t2a = _write_vqa_v1(str(tmp_path), "val2014", 8, rs=rs)
    sq, _ = _write_vqa_v1(str(tmp_path), "test2015", 6, rs=rs, annotated=False)
    out = str(tmp_path / "bundle")
    assert tmain(["prepro", "--train", "train2014", t1q, t1a, "--train", "val2014",
                  t2q, t2a, "--test", "test2015", sq, "--out", out]) == 0
    with open(os.path.join(out, "data_prepro.json")) as f:
        info = json.load(f)
    dirs = [str(tmp_path / "f1"), str(tmp_path / "f2")]
    want = {}
    for i, d in enumerate(dirs):
        os.makedirs(d)
        for rel in info["unique_img_train"] + info["unique_img_test"]:
            a = (rs.randn(8, 2, 2) + 10 * i).astype(np.float32)
            t7.save_t7(os.path.join(d, coco_feat_name(rel)), a)
            want[(i, rel)] = a
    for name, main in (("jax", jmain), ("port", tmain)):
        assert main(["pack-features", "--vqa-dir", out, "--feat-dir", dirs[0],
                     "--feat-dir", dirs[1], "--out", str(tmp_path / name),
                     "--cnnout-dim", "8", "--cnnout-w", "2", "--cnnout-h", "2"]) == 0
    with open(tmp_path / "jax" / "index.json") as f1, \
            open(tmp_path / "port" / "index.json") as f2:
        assert json.load(f1) == json.load(f2)
    store = PackedFeatureStore(str(tmp_path / "port"))
    names = [coco_feat_name(r) for r in info["unique_img_train"]]
    got = store.get_batch(names, [1] * len(names))
    for k, rel in enumerate(info["unique_img_train"]):
        src = 0 if rel.startswith("train2014/") else 1
        # [D, W, H] on disk -> [S, D] rows
        assert np.allclose(np.asarray(got[k]), want[(src, rel)].reshape(8, -1).T), rel
