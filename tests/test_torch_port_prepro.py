"""The port's ``prepro`` (rau_vqa_tpu_torch/data/prepro.py and the
``prepro`` command) against the JAX package's, the 7 cases of
tests/test_prepro.py each run through both packages on the same fabricated
official-format JSONs: the two ``data_prepro.json`` files equal byte for
byte, the h5 arrays bit for bit (the JAX bundle read by h5py, the port's by
data/hdf5.py), ``gt_annotations.json`` byte for byte.  The self-sufficiency
case goes prepro -> the port's Trainer on .t7 features written by the port.
No tolerance: the bundle is integers and strings."""

import dataclasses
import json
import os

import h5py
import numpy as np
import pytest

from rau_vqa_tpu.data import prepro as jprepro
from rau_vqa_tpu_torch.data import prepro as tprepro
from rau_vqa_tpu_torch.data.hdf5 import read_h5
from rau_vqa_tpu_torch.data.loader import load_gt_annotations, load_vqa_data
from tests.test_prepro import _write_vqa_v1


def bundle_files(out):
    """(json bytes, {name: array} read by the port, gt bytes or None)."""
    with open(os.path.join(out, "data_prepro.json"), "rb") as f:
        js = f.read()
    gt_path = os.path.join(out, "gt_annotations.json")
    gt = open(gt_path, "rb").read() if os.path.exists(gt_path) else None
    return js, read_h5(os.path.join(out, "data_prepro.h5")), gt


def assert_same_bundle(jax_out, port_out):
    """The JAX bundle (its h5 read by h5py) and the port's (read by
    data/hdf5.py, and by h5py too) are the same files' contents."""
    jjs, _, jgt = bundle_files(jax_out)
    tjs, tarr, tgt = bundle_files(port_out)
    assert jjs == tjs
    assert jgt == tgt
    with h5py.File(os.path.join(jax_out, "data_prepro.h5"), "r") as f:
        jarr = {k: f[k][()] for k in f.keys()}
    with h5py.File(os.path.join(port_out, "data_prepro.h5"), "r") as f:
        tarr_h5py = {k: f[k][()] for k in f.keys()}
    for got in (tarr, tarr_h5py):
        assert sorted(got) == sorted(jarr)
        for k, v in jarr.items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            assert np.array_equal(got[k], v), k


def build_both(tmp_path, train, test, cfg=None, **kw):
    """build_prepro of both packages on the same entries (each package's
    own join_split / Entry); returns (jax_out, port_out, summaries)."""
    outs, sums = [], []
    for name, mod in (("jax", jprepro), ("port", tprepro)):
        out = str(tmp_path / f"bundle_{name}")
        args = [] if cfg is None else [mod.PreproConfig(**dataclasses.asdict(cfg))]
        summary = mod.build_prepro(train(mod), test(mod), out, *args, **kw)
        if summary["gt_annotations"]:
            # the path differs by the directory alone
            summary["gt_annotations"] = os.path.relpath(summary["gt_annotations"], out)
        sums.append(summary)
        outs.append(out)
    return outs[0], outs[1], sums


def test_tokenize_punctuation():
    for s in ("What is, the dog's color?", "a+b=c [x] (y) 50% $5 #1 ~@!",
              "Straße naïve 日本 🤔\ttab\nnewline", ""):
        assert tprepro.tokenize(s) == jprepro.tokenize(s)
    assert tprepro.tokenize("What is, the dog's color?") == \
        ["what", "is", ",", "the", "dog", "'", "s", "color", "?"]
    # the port's prepro shares data/loader.py's tokenizer
    from rau_vqa_tpu_torch.data import loader
    assert tprepro.tokenize is loader.tokenize


def test_prepro_bundle_contract(tmp_path):
    rs = np.random.RandomState(0)
    tq, ta = _write_vqa_v1(str(tmp_path), "train2014", 36, rs=rs)
    vq, va = _write_vqa_v1(str(tmp_path), "val2014", 12, rs=rs, mc=True,
                           extra_word="zebra")
    jout, tout, (js, ts) = build_both(
        tmp_path, lambda m: [("train2014", m.join_split(tq, ta, "train2014"))],
        lambda m: m.join_split(vq, va, "val2014"),
        jprepro.PreproConfig(num_answers=5))
    assert_same_bundle(jout, tout)
    assert js == ts
    assert ts["n_answers"] == 5 and ts["n_dropped"] == 6 and ts["n_train"] == 30

    data = load_vqa_data(tout, batch_size=5, split="val2014", test_batch_size=4)
    assert data.vocab[0] == "ZEROPAD" and "UNK" in data.vocab_map
    assert data.train_data.num_examples == 30 and data.test_data.num_examples == 12
    with open(tq) as f:
        q_by_id = {q["question_id"]: q["question"] for q in json.load(f)["questions"]}
    sd = data.train_data
    for i in range(5):
        toks = sd.questions[i][:sd.lengths[i]]
        assert data.tokens_to_question(toks) == \
            " ".join(tprepro.tokenize(q_by_id[int(sd.qids[i])]))
    zebra_row = int(np.flatnonzero(data.test_data.qids == 2000)[0])
    assert data.vocab[int(data.test_data.questions[zebra_row, 0])] == "UNK"
    assert sd.img_paths[0].startswith("train2014/COCO_train2014_")
    mc = data.test_data.mc_answers
    assert mc.shape == (12, 18)
    assert (mc[:, 0] == data.answer_map["yes"]).all()
    assert (mc[:, 2] == -1).all() and (mc[:, 4:] == -1).all()
    gt = load_gt_annotations(os.path.join(tout, "gt_annotations.json"))
    assert len(gt) == 12


def test_prepro_multi_source_datatypes(tmp_path):
    rs = np.random.RandomState(1)
    t1q, t1a = _write_vqa_v1(str(tmp_path), "train2014", 10, rs=rs)
    t2q, t2a = _write_vqa_v1(str(tmp_path), "val2014", 8, rs=rs)
    sq, _ = _write_vqa_v1(str(tmp_path), "test2015", 6, rs=rs, annotated=False)
    jout, tout, _ = build_both(
        tmp_path, lambda m: [("train2014", m.join_split(t1q, t1a, "train2014")),
                             ("val2014", m.join_split(t2q, t2a, "val2014"))],
        lambda m: m.join_split(sq, None, "test2015"), jprepro.PreproConfig(num_answers=6))
    assert_same_bundle(jout, tout)
    dt = read_h5(os.path.join(tout, "data_prepro.h5"), ["datatype_train"])["datatype_train"]
    assert (dt[:10] == 1).all() and (dt[10:] == 2).all()
    assert not os.path.exists(os.path.join(tout, "gt_annotations.json"))
    data = load_vqa_data(tout, batch_size=4, split="test2015")
    assert data.test_data.num_examples == 6
    assert data.test_data.img_paths[0].startswith("test2015/COCO_test2015_")


def test_prepro_testdev_images_live_in_test2015(tmp_path):
    rs = np.random.RandomState(3)
    tq, ta = _write_vqa_v1(str(tmp_path), "train2014", 12, rs=rs)
    dq_path = str(tmp_path / "q_testdev.json")
    with open(dq_path, "w") as f:
        json.dump({"questions": [
            {"question_id": 4000 + i, "image_id": 17 + i,
             "question": "what is the dog?"} for i in range(3)]}, f)
    jout, tout, _ = build_both(
        tmp_path, lambda m: [("train2014", m.join_split(tq, ta, "train2014"))],
        lambda m: m.join_split(dq_path, None, "test-dev2015"))
    assert_same_bundle(jout, tout)
    with open(os.path.join(tout, "data_prepro.json")) as f:
        assert json.load(f)["unique_img_test"] == [
            f"test2015/COCO_test2015_{17 + i:012d}.jpg" for i in range(3)]


def test_cli_prepro(tmp_path, capsys):
    """Both CLIs on the same flags: the same summary line (but the output
    directory) and the same bundle."""
    from rau_vqa_tpu.cli import main as jmain
    from rau_vqa_tpu_torch.cli import main as tmain

    rs = np.random.RandomState(2)
    tq, ta = _write_vqa_v1(str(tmp_path), "train2014", 12, rs=rs)
    vq, va = _write_vqa_v1(str(tmp_path), "val2014", 8, rs=rs)
    with open(vq) as f:
        mc_qs = json.load(f)["questions"]
    for q in mc_qs:
        q["multiple_choices"] = ["yes", "no", "maybe", "42"]
    with open(str(tmp_path / "mc.json"), "w") as f:
        json.dump({"questions": mc_qs}, f)
    lines = []
    for name, main in (("jax", jmain), ("port", tmain)):
        out = str(tmp_path / name)
        assert main(["prepro", "--train", "train2014", tq, ta, "--test", "val2014", vq,
                     "--test-annotations", va, "--test-mc", str(tmp_path / "mc.json"),
                     "--out", out, "--num-answers", "6"]) == 0
        lines.append(capsys.readouterr().out.replace(out, "OUT"))
    assert lines[0] == lines[1] and "vocab" in lines[1]
    assert_same_bundle(str(tmp_path / "jax"), str(tmp_path / "port"))
    data = load_vqa_data(str(tmp_path / "port"), batch_size=4, split="val2014")
    assert (data.test_data.mc_answers[:, 0] >= 0).any()


def test_prepro_to_training_self_sufficient(tmp_path):
    """The zero-downloads loop on the port: official-format JSONs -> prepro
    -> .t7 features of the bundle's images (the port's writer) -> the port's
    Trainer, one epoch and a sweep at the small widths of
    tests/test_prepro.py, on the CPU."""
    from rau_vqa_tpu_torch.config import get_experiment
    from rau_vqa_tpu_torch.data import t7
    from rau_vqa_tpu_torch.data.features import T7DirFeatureSource, coco_feat_name
    from rau_vqa_tpu_torch.train.trainer import Trainer

    rs = np.random.RandomState(3)
    tq, ta = _write_vqa_v1(str(tmp_path), "train2014", 48, rs=rs)
    vq, va = _write_vqa_v1(str(tmp_path), "val2014", 16, rs=rs)
    jout, out, _ = build_both(
        tmp_path, lambda m: [("train2014", m.join_split(tq, ta, "train2014"))],
        lambda m: m.join_split(vq, va, "val2014"))
    assert_same_bundle(jout, out)
    with open(os.path.join(out, "data_prepro.json")) as f:
        info = json.load(f)
    feat = tmp_path / "feat"
    feat.mkdir()
    for rel in info["unique_img_train"] + info["unique_img_test"]:
        # the reference's per-image layout: [D, W, H] float32
        t7.save_t7(str(feat / coco_feat_name(rel)),
                   rs.randn(512, 2, 2).astype(np.float32))
    exp = get_experiment("ours_ms")
    exp = exp.replace(
        model=dataclasses.replace(
            exp.model, n_hops=2, cnn_dim=512, cnn_w=2, cnn_h=2, embed_dim=16,
            rnn_size=16, multfeat_dim=16, attfeat_dim=8, att_rnn_size=16,
            embed_dropout=0.0, rnn_dropout=0.0, mult_dropout=0.1),
        train=dataclasses.replace(exp.train, batch_size=16, noisy_eta=0.0,
                                  grad_clip=10.0, length_buckets=()),
        data=dataclasses.replace(exp.data, split="val2014"))
    data = load_vqa_data(out, batch_size=16, split="val2014", test_batch_size=8)
    gt = load_gt_annotations(os.path.join(out, "gt_annotations.json"))
    src = T7DirFeatureSource([str(feat)], 512, 2, 2)
    trainer = Trainer(exp, data, src, str(tmp_path / "run"), gt_anno=gt, device="cpu")
    rec = trainer.train_epoch()
    assert np.isfinite(rec["loss"])
    res = trainer.evaluate(write_submissions=False)
    assert len(res["testOEacc"]) == 4 and all(np.isfinite(a) for a in res["testOEacc"])


def test_prepro_fuzz_adversarial_questions(tmp_path):
    """The fuzz of tests/test_prepro.py through both packages: unicode,
    regex specials, punctuation runs, empty and over-long questions give
    the same bundle, which keeps the loader's invariants."""
    rs = np.random.RandomState(11)
    pieces = ["what", "is", "Straße", "naïve", "日本", "🤔", "a+b", "50%",
              "[x]", "(y)", "\\d+", "c:\\\\path", "end.", "--", "''",
              '"quoted"', "semi;colon", "a\nb", "tab\tsep", "?", "!!!",
              "<tag>", "x^2", "#1", "$5", "&amp", "*star*", "=eq="]
    answers = ["yes", "no", "maybe", "2", "répondre"]

    def rand_question(i):
        if i % 17 == 0:
            return ""
        n = 40 if i % 13 == 0 else rs.randint(1, 9)
        return " ".join(rs.choice(pieces, n))

    questions = {split: [rand_question(i) for i in range(n)]
                 for split, n in (("train2014", 120), ("val2014", 40))}

    def entries(mod, split, base):
        return [mod.Entry(question_id=base + i, split=split, image_id=i % 3,
                          question=q, answer=answers[i % len(answers)])
                for i, q in enumerate(questions[split])]

    cfg = jprepro.PreproConfig(num_answers=4, max_length=26, word_threshold=0)
    jout, tout, (js, ts) = build_both(
        tmp_path, lambda m: [("train2014", entries(m, "train2014", 1000))],
        lambda m: entries(m, "val2014", 2000), cfg)
    assert js == ts and ts["n_train"] > 0 and ts["vocab_size"] > 1
    assert_same_bundle(jout, tout)
    data = load_vqa_data(tout, batch_size=8, split="val2014")
    for sd in (data.train_data, data.test_data):
        toks, lens = np.asarray(sd.questions), np.asarray(sd.lengths)
        assert toks.min() >= 0 and toks.max() < data.vocab_size
        assert lens.min() >= 1 and lens.max() <= cfg.max_length
        cols = np.arange(toks.shape[1])[None, :]
        assert (toks[cols >= lens[:, None]] == 0).all()
    for qs in questions.values():
        for q in qs:
            assert tprepro.tokenize(q) == jprepro.tokenize(q)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prepro_ties_keep_the_jax_order(tmp_path, seed):
    """Answer counts full of ties at the top-N cut and words in many orders:
    Counter.most_common's first-appearance tie-break and the vocabulary's
    insertion order give both packages the same answers, word ids and
    bytes; an empty annotated test split writes zero-element datasets."""
    rs = np.random.RandomState(seed)
    words = [f"w{i}" for i in range(30)]
    answers = [f"a{i}" for i in range(12)]

    def entries(mod, split, base, n):
        return [mod.Entry(question_id=base + i, split=split,
                          image_id=int(rs_ids[i % len(rs_ids)]),
                          question=" ".join(words[j] for j in qidx[i]),
                          answer=answers[aidx[i]])
                for i in range(n)]

    n = 60
    qidx = [rs.randint(0, 30, rs.randint(1, 6)) for _ in range(n)]
    aidx = rs.randint(0, 12, n)
    rs_ids = rs.randint(0, 20, 15)
    cfg = jprepro.PreproConfig(num_answers=5, word_threshold=1)
    jout, tout, (js, ts) = build_both(
        tmp_path, lambda m: [("train2014", entries(m, "train2014", 1000, n))],
        lambda m: [], cfg)
    assert js == ts
    assert_same_bundle(jout, tout)
    arr = read_h5(os.path.join(tout, "data_prepro.h5"))
    assert arr["ques_test"].shape == (0, 26) and arr["MC_ans_test"].shape == (0, 18)
