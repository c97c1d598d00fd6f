"""The port's released-snapshot tools (rau_vqa_tpu_torch/eval/released.py,
``verify-released`` and ``diagnose-snapshot``) on a released-format tarball
that the JAX package fabricates as tests/test_released.py does: its
Trainer's sweep rows and ``export_snapshot`` of its weights.  The 5 cases of
tests/test_released.py on the port: the port's ``verify-released`` carries
the JAX weights through Torch7 and agrees with the JAX sweep's answers on
at least 0.999 of every hop's questions (the port's sweep on the CPU runs
the kernels' plain versions, with bf16 products, against JAX's float32
path), detects wrong weights (below 1.0) and a size mismatch; and
``diagnose-snapshot`` finds the order matching against the port's ``.pt``
and the JAX package's ``.msgpack``, and names a swapped attention pair."""

import dataclasses
import json
import os
import shutil
import tarfile

import jax
import numpy as np
import pytest

from rau_vqa_tpu.config import get_preset as jax_get_preset
from rau_vqa_tpu.data import T7DirFeatureSource as JT7
from rau_vqa_tpu.data.fixtures import FixtureSpec, generate_fixture
from rau_vqa_tpu.data.loader import load_vqa_data as jload
from rau_vqa_tpu.eval.submission import write_results as jwrite_results
from rau_vqa_tpu.train.trainer import Trainer as JTrainer
from rau_vqa_tpu.utils import torch_convert as jtc
from rau_vqa_tpu_torch.config import get_experiment
from rau_vqa_tpu_torch.data import t7
from rau_vqa_tpu_torch.data.features import T7DirFeatureSource
from rau_vqa_tpu_torch.data.loader import load_gt_annotations, load_vqa_data
from rau_vqa_tpu_torch.eval.released import (
    adopt_snapshot_opt,
    find_snapshots,
    pick_snapshot,
    verify_released,
)
from rau_vqa_tpu_torch.utils import torch_convert as tc
from tests.test_torch_port_trainer import one_torch_thread  # noqa: F401 (autouse)

SPEC = FixtureSpec()
EPOCH = 40.0
SMALL = dict(n_hops=2, cnn_dim=SPEC.feat_dim, cnn_w=SPEC.feat_w, cnn_h=SPEC.feat_h,
             embed_dim=16, rnn_size=16, multfeat_dim=16, attfeat_dim=8,
             att_rnn_size=16, embed_dropout=0.0, rnn_dropout=0.0, mult_dropout=0.1)
MIN_AGREE = 0.999


def jax_exp():
    exp = jax_get_preset("ours_ms")
    return exp.replace(
        model=dataclasses.replace(exp.model, **SMALL),
        train=dataclasses.replace(exp.train, batch_size=16),
        data=dataclasses.replace(exp.data, split="val2014"))


def port_exp():
    exp = get_experiment("ours_ms")
    return exp.replace(
        model=dataclasses.replace(exp.model, **SMALL),
        train=dataclasses.replace(exp.train, batch_size=16),
        data=dataclasses.replace(exp.data, split="val2014"))


@pytest.fixture(scope="module")
def released(tmp_path_factory):
    """The released artifact, fabricated by the JAX package: its fixture, a
    'trained' snapshot in Torch format with the opt table, and the result
    JSONs its eval sweep writes (tests/test_released.py:44-88); plus the
    JAX trainer's .msgpack of the same weights."""
    root = tmp_path_factory.mktemp("released")
    fix_root = str(root / "fix")
    generate_fixture(fix_root, SPEC)
    vqa_dir = os.path.join(fix_root, "vqa_prepro")
    exp = jax_exp()
    data = jload(vqa_dir, batch_size=16, split="val2014", test_batch_size=8)
    src = JT7([os.path.join(fix_root, "feat")], SPEC.feat_dim, SPEC.feat_w, SPEC.feat_h)
    trainer = JTrainer(exp, data, src, str(root / "fab_run"))
    trainer.epoch = int(EPOCH)
    result = trainer.evaluate(write_submissions=False, return_rows=True)
    msgpack = trainer.save()

    rel_dir = str(root / "save_result_vqa_val2014")
    os.makedirs(os.path.join(rel_dir, "snapshot"))
    params_np = jax.tree.map(np.asarray, trainer.state.params)
    snap = os.path.join(rel_dir, "snapshot", f"snapshot_iter000240_epoch{EPOCH:.2f}.t7")
    jtc.export_snapshot(
        snap, params_np, trainer.mcfg, it=240, epoch=EPOCH,
        opt={"nhop": float(trainer.mcfg.n_hops), "alg_name": exp.alg_name,
             "cnnout_dim": float(SPEC.feat_dim), "cnnout_w": float(SPEC.feat_w),
             "cnnout_h": float(SPEC.feat_h)})
    jwrite_results(rel_dir, "OpenEnded", "val2014", exp.alg_name, EPOCH, result["rows_oe"])
    jwrite_results(rel_dir, "MultipleChoice", "val2014", exp.alg_name, EPOCH,
                   result["rows_mc"])
    tarball = str(root / "save_result_vqa_val2014.tar.gz")
    with tarfile.open(tarball, "w:gz") as tf:
        tf.add(rel_dir, arcname="save_result_vqa_val2014")
    return {"tarball": tarball, "rel_dir": rel_dir, "vqa_dir": vqa_dir, "snap": snap,
            "feat_dir": os.path.join(fix_root, "feat"), "params": params_np,
            "mcfg": trainer.mcfg, "msgpack": msgpack, "root": str(root)}


def test_snapshot_discovery(released):
    snaps = find_snapshots(released["rel_dir"])
    assert [e for e, _, _ in snaps] == [EPOCH]
    e, p = pick_snapshot(released["rel_dir"])
    assert e == EPOCH and p.endswith(".t7")
    with pytest.raises(FileNotFoundError):
        pick_snapshot(released["rel_dir"], epoch=39.0)


def test_adopts_snapshot_opt(released):
    from rau_vqa_tpu.eval.released import adopt_snapshot_opt as jadopt
    _, p = pick_snapshot(released["rel_dir"])
    snap = t7.load_t7(p)
    exp = adopt_snapshot_opt(get_experiment("ours_ms"), snap["opt"])
    jexp = jadopt(jax_get_preset("ours_ms"), snap["opt"])
    assert exp.model.n_hops == jexp.model.n_hops == 2
    assert exp.model.cnn_dim == jexp.model.cnn_dim == SPEC.feat_dim
    assert exp.alg_name == jexp.alg_name == port_exp().alg_name


def _official(released, tmp_path):
    gt = load_gt_annotations(os.path.join(released["vqa_dir"], "gt_annotations.json"))
    path = str(tmp_path / "official.json")
    with open(path, "w") as f:
        json.dump({"annotations": [
            {"question_id": qid, "question_type": "what", "answer_type": "other",
             "multiple_choice_answer": ans,
             "answers": [{"answer": ans, "answer_confidence": "yes", "answer_id": i + 1}
                         for i in range(10)]}
            for qid, ans in gt.items()]}, f)
    return path


def _cli(released, tmp_path, tarball, name):
    from rau_vqa_tpu_torch.cli import main
    model_json = str(tmp_path / "model.json")
    with open(model_json, "w") as f:
        json.dump(dataclasses.asdict(jax_exp().model), f)   # the JAX package's
    workdir = str(tmp_path / name)
    rc = main(["--device", "cpu", "verify-released", "--tarball", tarball,
               "--preset", "ours_ms", "--vqa-dir", released["vqa_dir"],
               "--feat-dir", released["feat_dir"], "--split", "val2014",
               "--test-batch-size", "8", "--save-dir", workdir,
               "--model-json", model_json,
               "--official-anno", _official(released, tmp_path)])
    with open(os.path.join(workdir, "verify_released_report.json")) as f:
        return rc, json.load(f)


def test_verify_released_cli_end_to_end(released, tmp_path):
    """The one command on the JAX package's tarball: exit 0, every hop set
    compared, the official accuracies of both answer sets side by side."""
    rc, report = _cli(released, tmp_path, released["tarball"], "verify")
    assert rc == 0
    assert report["min_agree"] >= MIN_AGREE
    assert report["epoch"] == EPOCH
    assert len(report["hops"]) == 4
    assert all("oe" in h and "mc" in h for h in report["hops"].values())
    assert not any(h["oe"]["qid_mismatch"] for h in report["hops"].values())
    for h in report["hops"].values():
        for task in ("oe", "mc"):
            assert abs(h[task]["official_ours"] - h[task]["official_released"]) \
                <= 1 - MIN_AGREE + 1e-12
    # the results are named by the snapshot's fractional epoch
    hop1 = os.listdir(os.path.join(str(tmp_path / "verify"), "results", "hop_01"))
    assert any(f"-{EPOCH:.2f}_results.json" in f for f in hop1)


def _verify_with(released, rel_dir, workdir, exp):
    data = load_vqa_data(released["vqa_dir"], batch_size=16, split="val2014",
                         test_batch_size=8)
    src = T7DirFeatureSource([released["feat_dir"]], SPEC.feat_dim, SPEC.feat_w,
                             SPEC.feat_h)
    gt = load_gt_annotations(os.path.join(released["vqa_dir"], "gt_annotations.json"))
    return verify_released(rel_dir, exp, data, src, workdir, gt_anno=gt, device="cpu")


def test_verify_released_detects_wrong_weights(released, tmp_path):
    """A corrupted snapshot (the classifier group perturbed) does not reach
    1.0 against the pristine result JSONs."""
    bad_root = str(tmp_path / "bad")
    shutil.copytree(released["rel_dir"], bad_root)
    _, p = pick_snapshot(bad_root)
    snap = t7.load_t7(p)
    flats = tc.flats_from_snapshot(snap)
    rs = np.random.RandomState(0)
    flats[2] = flats[2] + rs.randn(flats[2].size).astype(np.float32) * 0.5
    t7.save_t7(p, {"it": snap["it"], "epoch": snap["epoch"], "params": flats,
                   "opt": snap["opt"]})
    report = _verify_with(released, bad_root, str(tmp_path / "w"), port_exp())
    assert report["min_agree"] < 1.0
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        verify_released(bad_root, port_exp(), None, None, str(tmp_path / "m"),
                        device="cpu", mesh=object())


def test_verify_released_layout_mismatch_reports(released, tmp_path):
    exp = port_exp()
    exp = exp.replace(model=dataclasses.replace(exp.model, multfeat_dim=32))
    report = _verify_with(released, released["rel_dir"], str(tmp_path / "w2"), exp)
    assert report["error"] == "layout"
    assert report["sizes"]["mult"]["snapshot"] != report["sizes"]["mult"]["config"]
    assert "AMBIGUOUS" in report["report"]


def _swapped_snapshot(released, path):
    """The released snapshot with mult's two (F, M) attention projections
    (att_q, att_i) swapped in the flat vector: sizes cannot tell them apart."""
    mcfg = released["mcfg"]
    layout = list(jtc.GROUP_LAYOUTS["mult"](mcfg))
    pos = {e[0]: i for i, e in enumerate(layout)}
    for leaf in ("w", "b"):
        i, j = pos[("mult", "att_q", leaf)], pos[("mult", "att_i", leaf)]
        layout[i], layout[j] = layout[j], layout[i]
    snap = t7.load_t7(released["snap"])
    flats = tc.flats_from_snapshot(snap)
    flats[2] = jtc.group_to_flat(released["params"]["mult"], mcfg, "mult", layout=layout)
    t7.save_t7(path, {"it": snap["it"], "epoch": snap["epoch"], "params": flats,
                      "opt": snap["opt"]})


def test_diagnose_snapshot_cli(released, tmp_path, capsys, monkeypatch):
    """diagnose-snapshot against the port's .pt (convert-snapshot of the
    same .t7) and the JAX package's .msgpack: every group's order matches;
    on the swapped snapshot the mult group names the pair."""
    import rau_vqa_tpu_torch.config as tconf
    from rau_vqa_tpu_torch.cli import main

    mcfg = released["mcfg"]
    dims = ["--vocab-size", str(mcfg.vocab_size), "--answer-size", str(mcfg.answer_size),
            "--seq-len", str(mcfg.seq_len)]
    pt = str(tmp_path / "ref.pt")
    cfg_json = str(tmp_path / "model.json")
    with open(cfg_json, "w") as f:
        json.dump(dataclasses.asdict(mcfg), f)
    assert main(["convert-snapshot", "--input", released["snap"], "--output", pt,
                 "--config-json", cfg_json] + dims) == 0
    swapped = str(tmp_path / "swapped.t7")
    _swapped_snapshot(released, swapped)
    # the command takes its widths from the preset (no flag sets them): the
    # preset here is ours_ms at the fixture's small widths
    monkeypatch.setattr(tconf, "get_experiment", lambda name: port_exp())
    capsys.readouterr()
    for snap, ref in ((released["snap"], pt), (released["snap"], released["msgpack"]),
                      (swapped, pt)):
        assert main(["diagnose-snapshot", "--input", snap, "--ref-checkpoint", ref,
                     "--preset", "ours_ms"] + dims) == 0
        out = capsys.readouterr().out
        assert "[mult]" in out and "AMBIGUOUS" in out
        if snap == swapped:
            assert "embed: order matches GROUP_LAYOUTS" in out
            assert "rnn: order matches GROUP_LAYOUTS" in out
            assert "mult: ORDER MISMATCH" in out
            assert "ours mult/att_q/w vs snapshot mult/att_i/w" in out
            assert "ours mult/att_i/b vs snapshot mult/att_q/b" in out
        else:
            for g in ("embed", "rnn", "mult"):
                assert f"{g}: order matches GROUP_LAYOUTS" in out
    # a size mismatch ends before the order
    monkeypatch.setattr(tconf, "get_experiment", lambda name: get_experiment("ours_ms"))
    assert main(["diagnose-snapshot", "--input", swapped, "--preset", "ours_ms"] + dims) == 1
    assert "size mismatch" in capsys.readouterr().out
