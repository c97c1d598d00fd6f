"""The port's ``Trainer`` (rau_vqa_tpu_torch/train/trainer.py) against the
JAX package's, on the CPU, on the same seeded fixture.

Parity with JAX starts both trainers from the same parameters (the port's
``init_params`` draws from ``torch.Generator``, JAX's from ``PRNGKey``), with
dropout off and ``noisy_eta=0`` so that both steps are deterministic.  Bars:
per-step losses and epoch records at the train step's bar (rtol 2e-3, atol
1e-6: tests/test_torch_port_train.py), the parameters after each epoch at
2e-3 per leaf by norm (``assert_params_close``); the LRs, the hop
curriculum, the data order and the sweep's rows exactly.  The port-only
checks run with dropout on: resume is exact on the CPU, bucketed and
unbucketed epochs agree at rtol 1e-5 (tests/test_train.py:270)."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from rau_vqa_tpu.config import get_preset as jax_get_preset
from rau_vqa_tpu.data import features as jfeat
from rau_vqa_tpu.data import fixtures as jfix
from rau_vqa_tpu.data import loader as jload
from rau_vqa_tpu.eval.metrics import fast_val_accuracy as jax_fast_val
from rau_vqa_tpu.eval.vqa_accuracy import VQAAccuracyScorer as JaxScorer
from rau_vqa_tpu.models.backbones import vit as jvit
from rau_vqa_tpu.train import trainer as jtrainer
from rau_vqa_tpu_torch.config import get_experiment
from rau_vqa_tpu_torch.convert import params_from_jax, tree_leaves
from rau_vqa_tpu_torch.data import features as tfeat
from rau_vqa_tpu_torch.data import loader as tload
from rau_vqa_tpu_torch.eval.metrics import fast_val_accuracy
from rau_vqa_tpu_torch.eval.vqa_accuracy import VQAAccuracyScorer
from rau_vqa_tpu_torch.train import trainer as ttrainer

SPEC = jfix.FixtureSpec()
# the tiny regime of tests/test_train.py make_trainer
MODEL = dict(n_hops=2, cnn_dim=SPEC.feat_dim, cnn_w=SPEC.feat_w,
             cnn_h=SPEC.feat_h, embed_dim=16, rnn_size=16, multfeat_dim=16,
             attfeat_dim=8, att_rnn_size=16, embed_dropout=0.0,
             rnn_dropout=0.0, mult_dropout=0.1)
TRAIN = dict(batch_size=16, learning_rate=1e-2, mult_learning_rate=1e-2,
             lr_decay=1.0, mult_lr_decay=1.0, noisy_eta=0.0, grad_clip=10.0,
             length_buckets=())


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny tensors: one intra-op thread a test process (restored after),
    so that parallel test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port_trainer_fixture"))
    jfix.generate_fixture(root, SPEC)
    return root


def tiny(exp, model=None, train=None, **kw):
    """``exp`` (either package's ExperimentConfig) in the tiny regime."""
    return exp.replace(
        model=dataclasses.replace(exp.model, **{**MODEL, **(model or {})}),
        train=dataclasses.replace(exp.train, **{**TRAIN, **(train or {})}),
        data=dataclasses.replace(exp.data, split="val2014"), **kw)


def _inputs(mods, root, exp, test_batch_size):
    load, feat = mods
    vqa_dir = os.path.join(root, "vqa_prepro")
    data = load.load_vqa_data(vqa_dir, exp.train.batch_size, split="val2014",
                              test_batch_size=test_batch_size)
    src = feat.T7DirFeatureSource([os.path.join(root, "feat")], SPEC.feat_dim,
                                  SPEC.feat_w, SPEC.feat_h)
    gt = load.load_gt_annotations(os.path.join(vqa_dir, "gt_annotations.json"))
    return data, src, gt


def port_trainer(root, workdir, model=None, train=None, test_batch_size=8,
                 **kw):
    exp = tiny(get_experiment("ours_ms"), model, train, **kw)
    data, src, gt = _inputs((tload, tfeat), root, exp, test_batch_size)
    return ttrainer.Trainer(exp, data, src, str(workdir), gt_anno=gt,
                            device="cpu")


def jax_trainer(root, workdir, model=None, train=None, test_batch_size=8):
    exp = tiny(jax_get_preset("ours_ms"), model, train)
    data, src, gt = _inputs((jload, jfeat), root, exp, test_batch_size)
    return jtrainer.Trainer(exp, data, src, str(workdir), gt_anno=gt)


def record_steps(trainer, losses, qids=None):
    """Collect each step's loss (and each train batch's qids) as it runs."""
    step, put = trainer.train_step, trainer._put_batch

    def spy_step(*a):
        state, m = step(*a)
        losses.append(m["loss"])
        return state, m

    def spy_put(batch, **kw):
        if qids is not None and batch.labels is not None:
            qids.append(np.asarray(batch.qids).copy())
        return put(batch, **kw)

    trainer.train_step = spy_step
    trainer._put_batch = spy_put


def close(got, want, rtol=2e-3, atol=1e-6, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


# the attention score's bias shifts every logit of a softmax alike: its
# gradient is zero in exact arithmetic, so Adam turns each framework's
# rounding noise into steps of ~lr and the two values part at random
# (3.7e-2 norm-relative after 20 steps, measured).  noise_only_leaves finds
# such leaves from their gradients; the tests hold its answer to this one.
NOISE_ONLY = {"['mult']['att_score']['b']"}


def noise_only_leaves(trainer):
    """The leaves whose gradient is float32 rounding alone: on the trainer's
    first train batch at its params, the gradient computed with bf16
    products moves by over 100x its float32 norm (rounding grows with the
    type's epsilon, 65,536x; a real gradient moves by at most 2.5x on the
    fixture, measured, and the attention score's bias by 1.1e3-8.0e3x).
    Stateless: the data order is not advanced."""
    td = trainer.data.train_data
    idx = np.arange(td.batch_size)
    b = trainer._put_batch(td._assemble(idx, td._fetch_source(trainer.source, idx)))

    def grads(compute_dtype):
        mcfg = dataclasses.replace(trainer.mcfg, compute_dtype=compute_dtype)
        g, _ = ttrainer.loss_and_grads(
            mcfg, trainer.state.params, b["tokens"], b["lengths"], b["feats"],
            b["labels"], trainer._hop_scale(1),
            generator=torch.Generator().manual_seed(0))
        return {jax.tree_util.keystr(p): x.float()
                for p, x in jax.tree_util.tree_leaves_with_path(g)}

    f32, b16 = grads("float32"), grads("bfloat16")
    return {k for k, g in f32.items()
            if torch.linalg.norm(b16[k] - g) > 100 * torch.linalg.norm(g)}


def assert_params_close(port, jax_tree, skip, rtol=2e-3, atol=1e-6):
    """Each leaf but those in ``skip`` within ``rtol`` of JAX's,
    norm-relative.  Elementwise, 20 Adam steps part the two by up to 5.3e-5
    on 0.06-sized biases (1.3% relative, measured); the largest leaf
    distance norm-relative is 7.0e-4 (``att_q.b``), so each leaf is held at
    the train step's 2e-3 by norm."""
    for path, w in jax.tree_util.tree_leaves_with_path(jax_tree):
        key = jax.tree_util.keystr(path)
        if key in skip:
            continue
        g = port
        for k in path:
            g = g[k.key if hasattr(k, "key") else k.idx]
        g, w = g.detach().numpy(), np.asarray(w)
        dist = np.linalg.norm(g - w)
        assert dist <= rtol * np.linalg.norm(w) + atol * np.sqrt(w.size), \
            (key, dist / max(np.linalg.norm(w), 1e-30))


def assert_same_state(a, b):
    assert a.step == b.step and a.seed == b.seed
    for x, y in zip(tree_leaves((a.params, a.opt)), tree_leaves((b.params, b.opt))):
        assert torch.equal(x, y)


def result_files(workdir):
    root = os.path.join(str(workdir), "results")
    out = {}
    for hop in sorted(os.listdir(root)):
        for name in sorted(os.listdir(os.path.join(root, hop))):
            with open(os.path.join(root, hop, name), "rb") as f:
                out[f"{hop}/{name}"] = f.read()
    return out


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

def test_epochs_and_sweeps_match_jax(fixture_root, tmp_path):
    """Two epochs from the same params with LR decay and the ours_full-style
    hop curriculum (hop 2 stops after epoch 1): per-step losses, epoch
    records and end params at the train step's bar; LRs, curriculum and
    data order exactly.  The sweep at the init params and at JAX's trained
    ones, with a tail batch (test_batch_size 7): identical rows, files and
    accuracies (the plain float32 path on both sides)."""
    model = {"mult_dropout": 0.0}
    train = {"lr_decay": 0.9, "mult_lr_decay": 0.8, "hop_stop_timing": (1000, 1)}
    jt = jax_trainer(fixture_root, tmp_path / "jax", model, train,
                     test_batch_size=7)
    tt = port_trainer(fixture_root, tmp_path / "port", model, train,
                      test_batch_size=7, fused_eval=False)
    host = jax.tree.map(np.asarray, jt.state.params)
    tt.state = tt.state._replace(params=params_from_jax(host))
    noise = noise_only_leaves(tt)
    assert noise == NOISE_ONLY
    for e in (1, 2, 3):
        np.testing.assert_array_equal(tt._hop_scale(e).numpy(),
                                      np.asarray(jt._hop_scale(e)))

    def sweeps_equal():
        a = jt.evaluate(return_rows=True)
        b = tt.evaluate(return_rows=True)
        assert b["rows_oe"] == a["rows_oe"] and b["rows_mc"] == a["rows_mc"]
        assert len(b["rows_oe"]) == MODEL["n_hops"] + 2
        assert len(b["rows_oe"][0]) == SPEC.n_test
        for k in ("epoch", "testOEacc", "testMCacc"):
            assert b[k] == a[k], k
        assert result_files(tmp_path / "port") == result_files(tmp_path / "jax")

    sweeps_equal()
    jl, tl, jq, tq = [], [], [], []
    record_steps(jt, jl, jq)
    record_steps(tt, tl, tq)
    for _ in range(2):
        ja, ta = jt.train_epoch(), tt.train_epoch()
        assert_params_close(tt.state.params, jt.state.params, noise)
        assert set(ta) == set(ja)
        for k in ja:
            if k in ("sec", "examples_per_sec"):
                continue
            if k in ("epoch", "steps", "exploded", "lr", "mult_lr") \
                    or k.startswith("cmploss"):
                assert ta[k] == ja[k], k
            else:
                close(ta[k], ja[k], msg=k)
        assert (tt.lr, tt.mult_lr, tt.epoch) == (jt.lr, jt.mult_lr, jt.epoch)
    assert [r["cmploss_02"] for r in tt.logger.read("train")] == [1.0, 0.0]
    assert len(tl) == len(jl) == 2 * 10
    close(torch.stack(tl).numpy(), np.asarray(jl), msg="per-step losses")
    for a, b in zip(tq, jq):
        np.testing.assert_array_equal(a, b)
    assert tt.state.step == int(jt.state.step)
    assert_params_close(tt.state.params, jt.state.params, noise)
    for g in ("embed", "rnn", "mult"):
        assert int(tt.state.opt[g]["t"]) == int(jt.state.opt[g]["t"]) == 20
    tt.state = tt.state._replace(
        params=params_from_jax(jax.tree.map(np.asarray, jt.state.params)))
    sweeps_equal()


def test_official_scorer_matches_jax(fixture_root, tmp_path):
    """The copied 10-rater scorer scores the sweep's rows as JAX's does on
    annotations with disagreeing raters; with unanimous raters the
    official metric degenerates to exact match (tests/test_train.py:310)."""
    tr = port_trainer(fixture_root, tmp_path / "run")
    gt = tr.gt_anno
    words = [f"ans{i}" for i in range(SPEC.n_answers)]
    rs = np.random.RandomState(0)
    mixed = {"annotations": [
        {"question_id": qid, "question_type": "what is", "answer_type":
         "number" if qid % 2 else "other", "multiple_choice_answer": ans,
         "answers": [{"answer": ans if i < 3 + qid % 5 else
                      words[rs.randint(len(words))] + (" ." if i % 4 else ""),
                      "answer_confidence": "yes", "answer_id": i + 1}
                     for i in range(10)]}
        for qid, ans in gt.items()]}
    swept = tr.evaluate(write_submissions=False, return_rows=True)
    rows = swept["rows_oe"]
    for h in range(len(rows)):
        got = VQAAccuracyScorer(mixed, precision=6).score(rows[h])
        assert got == JaxScorer(mixed, precision=6).score(rows[h])
        # the per-row fast validation agrees with the sweep's vectorized one
        assert fast_val_accuracy(rows[h], gt) == jax_fast_val(rows[h], gt) \
            == pytest.approx(swept["testOEacc"][h])
    unanimous = {"annotations": [
        {"question_id": qid, "question_type": "what", "answer_type": "other",
         "multiple_choice_answer": ans,
         "answers": [{"answer": ans, "answer_confidence": "yes",
                      "answer_id": i + 1} for i in range(10)]}
        for qid, ans in gt.items()]}
    path = tmp_path / "official.json"
    path.write_text(json.dumps(unanimous))
    tr.official_anno = str(path)
    result = tr.evaluate(write_submissions=False)
    assert result["testOEaccOfficial"] == pytest.approx(result["testOEacc"])
    assert result["testMCaccOfficial"] == pytest.approx(result["testMCacc"])
    assert any("testOEaccOfficial_01" in r for r in tr.logger.read("test"))


# ---------------------------------------------------------------------------
# the port's own checks, dropout on
# ---------------------------------------------------------------------------

DROPOUT = {"embed_dropout": 0.5, "rnn_dropout": 0.5, "mult_dropout": 0.5}


@pytest.mark.parametrize("fused", [False, True])
def test_resume_equals_a_straight_run(fixture_root, tmp_path, fused):
    """4 epochs straight == 2 + save + restore + 2, bit for bit on the CPU,
    with the same data order (tests/test_train.py:538)."""
    model = {**DROPOUT, "fused_train": fused}
    train = {"noisy_eta": 0.01, "lr_decay": 0.9}
    a = port_trainer(fixture_root, tmp_path / "a", model, train)
    aq, bq = [], []
    record_steps(a, [], aq)
    a.fit(epochs=4, eval_each=False)
    b1 = port_trainer(fixture_root, tmp_path / "b1", model, train)
    record_steps(b1, [], bq)
    b1.fit(epochs=2, eval_each=False)
    path = b1.save()
    b2 = port_trainer(fixture_root, tmp_path / "b2", model, train)
    record_steps(b2, [], bq)
    b2.restore(path)
    assert b2.epoch == 2 and b2.state.step == 20
    b2.fit(epochs=2, eval_each=False)
    assert_same_state(a.state, b2.state)
    assert (a.lr, a.mult_lr, a.epoch, a.loss_ema) == \
        (b2.lr, b2.mult_lr, b2.epoch, b2.loss_ema)
    assert len(aq) == len(bq) == 40
    for x, y in zip(aq, bq):
        np.testing.assert_array_equal(x, y)


def test_bucketed_epoch_equals_unbucketed(fixture_root, tmp_path):
    """One epoch with the token axis cut to bucket 8 gives the params of one
    at full length (the fixture's lengths are 2..9, so bucket 8 cuts some
    batches), dropout on (tests/test_train.py:270)."""
    a = port_trainer(fixture_root, tmp_path / "full", DROPOUT,
                     {"length_buckets": ()})
    b = port_trainer(fixture_root, tmp_path / "cut", DROPOUT,
                     {"length_buckets": (8,)})
    assert b._train_ladder == [8, SPEC.seq_len]
    noise = noise_only_leaves(a)
    assert noise == NOISE_ONLY
    cut = []
    put = b._put_batch
    b._put_batch = lambda batch, max_t=None, **kw: (cut.append(max_t),
                                                    put(batch, max_t=max_t, **kw))[1]
    a.train_epoch()
    b.train_epoch()
    assert 8 in cut
    for (path, x), y in zip(jax.tree_util.tree_leaves_with_path(a.state.params),
                            jax.tree_util.tree_leaves(b.state.params)):
        if jax.tree_util.keystr(path) not in noise:   # see NOISE_ONLY
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)


def test_guard_restores_the_last_checkpoint(fixture_root, tmp_path):
    """A tripped guard restores the snapshot and aborts the epoch; the order
    stream is realigned and the next epoch runs clean
    (tests/test_train.py:404)."""
    tr = port_trainer(fixture_root, tmp_path / "guard", DROPOUT)
    tr.fit(epochs=1, eval_each=False)
    saved = tr.state
    tr.loss_ema = 1e-9      # any normal loss now trips the guard
    rec = tr.train_epoch()
    assert rec["exploded"] == 1 and rec.get("aborted") is True
    assert tr.epoch == 1 and tr.state.step == saved.step
    assert tr.state.seed != saved.seed     # the retry draws other masks
    for x, y in zip(tree_leaves(tr.state.params), tree_leaves(saved.params)):
        assert torch.equal(x, y)
    td = tr.data.train_data
    assert td.batch_index == 0 and td.reorder_count == tr.epoch + 1
    np.testing.assert_array_equal(
        td.batch_order,
        np.random.default_rng((td.seed, tr.epoch)).permutation(td.num_examples))
    rec2 = tr.train_epoch()
    assert not rec2.get("aborted") and rec2["exploded"] == 0
    assert tr.epoch == 2 and tr._abort_streak == 0


def test_guard_falls_back_before_any_checkpoint(fixture_root, tmp_path):
    """No snapshot yet: the guard puts back the initial state, rewinds the
    EMA, and the next epoch trains (tests/test_train.py:437)."""
    tr = port_trainer(fixture_root, tmp_path / "guard0", DROPOUT)
    init = tr.state
    tr.loss_ema = 1e-9
    rec = tr.train_epoch()
    assert rec["exploded"] == 1 and rec.get("aborted") is True
    for x, y in zip(tree_leaves((tr.state.params, tr.state.opt)),
                    tree_leaves((init.params, init.opt))):
        assert torch.equal(x, y)
    assert tr.state.step == 0 and tr.epoch == 0 and tr.loss_ema is None
    assert tr.data.train_data.batch_index == 0
    rec2 = tr.train_epoch()
    assert not rec2.get("aborted") and tr.epoch == 1


def test_guard_streak_raises(fixture_root, tmp_path):
    """Each trip perturbs the seed, the fallback rewinds epoch and LR, and
    three trips in a row raise (tests/test_train.py:866)."""
    tr = port_trainer(fixture_root, tmp_path / "streak", DROPOUT)
    tr.epoch, tr.lr = 5, 1e-5
    seed0 = tr.state.seed
    assert tr._guard(float("inf")) is False
    assert tr.epoch == 0 and tr.lr == tr.tcfg.learning_rate
    assert tr.mult_lr == tr.tcfg.mult_learning_rate
    seed1 = tr.state.seed
    assert seed1 != seed0
    assert tr._guard(float("nan")) is False
    assert tr.state.seed not in (seed0, seed1)
    with pytest.raises(RuntimeError, match="consecutive"):
        tr._guard(float("inf"))
    tr2 = port_trainer(fixture_root, tmp_path / "clear", DROPOUT)
    tr2._abort_streak = 2
    tr2.train_epoch()
    assert tr2._abort_streak == 0


def test_sweep_after_restore_uses_the_restored_weights(fixture_root, tmp_path):
    """The serving step keeps its bf16 weight packs per params object; a
    restore hands it a new one, so the next sweep answers with the restored
    weights, not a stale pack."""
    run = port_trainer(fixture_root, tmp_path / "run", DROPOUT)
    run.fit(epochs=2, eval_each=False)
    first = os.path.join(run.ckpt_dir, "snapshot_iter000010_epoch1.00.pt")
    x = port_trainer(fixture_root, tmp_path / "x", DROPOUT)
    packs = []
    pack = x.predict_step._weights_for.fn
    x.predict_step._weights_for.fn = lambda p: packs.append(p) or pack(p)
    at_init = x.evaluate(write_submissions=False, return_rows=True)
    x.restore(first)
    restored = x.evaluate(write_submissions=False, return_rows=True)
    assert len(packs) == 2 and packs[1] is x.state.params
    y = port_trainer(fixture_root, tmp_path / "y", DROPOUT)
    y.restore(first)
    fresh = y.evaluate(write_submissions=False, return_rows=True)
    assert restored["rows_oe"] == fresh["rows_oe"]
    assert restored["testOEacc"] == fresh["testOEacc"]
    assert restored["rows_oe"] != at_init["rows_oe"]


def test_put_batch_ships_compute_dtype_and_dequantizes(fixture_root, tmp_path):
    tr = port_trainer(fixture_root, tmp_path / "dt")
    tr.data.train_data.inorder()
    batch = tr.data.train_data.next_batch(tr.source)
    dev = tr._put_batch(batch, max_t=5)
    assert dev["feats"].dtype == torch.float32 and dev["tokens"].shape[1] == 5
    np.testing.assert_array_equal(dev["feats"].numpy(), batch.feats)
    b16 = port_trainer(fixture_root, tmp_path / "b16", {"compute_dtype": "bfloat16"})
    assert b16._put_batch(batch)["feats"].dtype == torch.bfloat16
    q = tfeat.QuantFeats(values=np.full((2, 3, 4), -5, np.int8),
                         scales=np.asarray([0.5, 2.0], np.float32))
    got = tr._put_batch(dataclasses.replace(
        batch, feats=q, tokens=batch.tokens[:2], lengths=batch.lengths[:2],
        labels=batch.labels[:2], qids=batch.qids[:2]))["feats"]
    np.testing.assert_array_equal(got.numpy(), q.dequantize())
    padded = tr._pad_batch_to(dataclasses.replace(batch, feats=q, tokens=batch.tokens[:2],
                                                  lengths=batch.lengths[:2],
                                                  labels=batch.labels[:2],
                                                  qids=batch.qids[:2]), 5)
    assert padded.feats.values.shape[0] == 5 and list(padded.qids[2:]) == \
        [batch.qids[1]] * 3


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_pinning_casts_and_cuts_each_batch(fixture_root, tmp_path, monkeypatch,
                                           compute_dtype):
    """On the card the loader's prefetch thread hands over each batch whole
    in pinned memory: features in the step's type, tokens cut to their
    bucket, every other array as it was.  On the CPU there is no such step.
    Page-locked memory needs a card, so here the copy stands in for it."""
    tr = port_trainer(fixture_root, tmp_path / "pin",
                      {"compute_dtype": compute_dtype}, {"length_buckets": (4, 8)})
    assert tr._pinning(tr._train_ladder) is None
    pinned = []

    def fake_pinned(a, dtype=None):
        pinned.append(a)
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t if dtype is None else t.to(dtype)

    monkeypatch.setattr(ttrainer, "_pinned", fake_pinned)
    monkeypatch.setattr(tr, "device", torch.device("cuda"))
    td = tr.data.train_data
    td.set_batch_order_option("sort")      # short batches first: some cut
    td.reorder()
    batches = list(td.batches(tr.source, finish=tr._pinning(tr._train_ladder)))
    td.reorder()
    plain = list(td.batches(tr.source))
    assert len(pinned) == 4 * len(plain)
    widths = set()
    for got, want in zip(batches, plain):
        t = ttrainer.Trainer._bucket_t(tr._train_ladder, want.lengths)
        widths.add(got.tokens.shape[1])
        np.testing.assert_array_equal(got.tokens.numpy(), want.tokens[:, :t])
        assert got.feats.dtype == tr._feat_dtype
        torch.testing.assert_close(got.feats, torch.from_numpy(want.feats).to(tr._feat_dtype),
                                   rtol=0, atol=0)
        for k in ("lengths", "labels"):
            np.testing.assert_array_equal(getattr(got, k).numpy(), getattr(want, k))
        assert got.mc_answers is want.mc_answers is None
        np.testing.assert_array_equal(got.qids, want.qids)
    assert min(widths) < SPEC.seq_len


def test_trainer_device_rule_and_unported_options(fixture_root, tmp_path,
                                                  monkeypatch):
    """A mesh that is not ``parallel.mesh.Mesh`` is a TypeError (the mesh
    itself runs in tests/test_torch_port_mesh_trainer.py); fine-tuning
    refuses what the JAX package refuses: training a backbone with none
    given, and the 'imggroup' order over images of uneven question counts
    (tests/test_torch_port_finetune.py runs the path itself)."""
    exp = tiny(get_experiment("ours_ms"))
    data, src, _ = _inputs((tload, tfeat), fixture_root, exp, 8)
    bb = {"convs": [{"w": torch.zeros(3, 3, 3, 4), "b": torch.zeros(4)}]}
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        ttrainer.Trainer(exp, data, src, str(tmp_path), mesh=object(), device="cpu")
    ft = exp.replace(train=dataclasses.replace(exp.train, train_backbone=True))
    for e, kw, match in (
            (ft, dict(device="cpu"), "train_backbone needs an image data source"),
            (ft.replace(data=dataclasses.replace(exp.data, batch_order="imggroup")),
             dict(backbone="vgg16", bb_params=bb, device="cpu"), "not uniform")):
        with pytest.raises(ValueError, match=match):
            ttrainer.Trainer(e, data, src, str(tmp_path), **kw)
    with pytest.raises(ValueError, match="together"):
        ttrainer.Trainer(exp, data, src, str(tmp_path), backbone="vgg16", device="cpu")
    with pytest.raises(ValueError, match="train_backbone needs backbone="):
        ttrainer.make_train_step(exp.model, ft.train, device="cpu")
    # attention dumps are ported: visatt is no longer refused
    assert ttrainer.Trainer(exp.replace(visatt=True), data, src, str(tmp_path),
                            device="cpu").exp.visatt
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrainer.Trainer(exp, data, src, str(tmp_path))


@pytest.mark.parametrize("name", ["ours_ss", "ours_ms", "ours_full", "ours_resnet",
                                  "ours_resnet_ft", "ours_vit"])
def test_experiments_match_the_jax_presets(name):
    """get_experiment keeps get_train_preset's halves and the JAX preset's
    name, alg_name, save_dir and data; the other fields are the JAX
    defaults, but fused_eval (the port's sweep runs its kernels)."""
    from rau_vqa_tpu_torch.config import get_train_preset
    t, j = get_experiment(name), jax_get_preset(name)
    assert (t.model, t.train) == get_train_preset(name)
    for f in ("name", "alg_name", "save_dir", "visatt", "graph_interval",
              "profile_dir", "eval_buckets"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.fused_eval and not j.fused_eval
    for f in dataclasses.fields(t.data):
        assert getattr(t.data, f.name) == getattr(j.data, f.name), f.name
    for split in ("val2014", "test2015", "test-dev2015", "train2014"):
        for tbs in (0, 7):
            assert dataclasses.replace(t.data, split=split, test_batch_size=tbs) \
                .resolved_test_batch_size() == dataclasses.replace(
                    j.data, split=split, test_batch_size=tbs).resolved_test_batch_size()
    for f in dataclasses.fields(t.train):
        if hasattr(j.train, f.name):
            assert getattr(t.train, f.name) == getattr(j.train, f.name), f.name


def test_fit_renders_the_jax_curves(fixture_root, tmp_path):
    """Every graph_interval epochs fit renders the curves the JAX package's
    render_curves makes from the same log (none without matplotlib)."""
    from rau_vqa_tpu.utils.plots import render_curves as jax_render
    tr = port_trainer(fixture_root, tmp_path / "run", {"n_hops": 1},
                      graph_interval=1)
    tr.fit(epochs=1)
    got = sorted(os.listdir(tmp_path / "run" / "graphs")) \
        if os.path.isdir(tmp_path / "run" / "graphs") else []
    want = jax_render(str(tmp_path / "run" / "training_log"),
                      str(tmp_path / "jax_graphs"), 1)
    assert got == sorted(os.path.basename(p) for p in want)


# ---------------------------------------------------------------------------
# from images through a frozen backbone
# ---------------------------------------------------------------------------

IMAGE_MODEL = {"cnn_dim": 512, "cnn_w": 2, "cnn_h": 2, "mult_dropout": 0.0}


@pytest.fixture(scope="module")
def image_fixture_root(tmp_path_factory):
    """The fixture with its images at 64 px (a 2x2 VGG16 grid)."""
    root = str(tmp_path_factory.mktemp("port_trainer_images"))
    jfix.generate_fixture(root, SPEC, images=True, image_size=64)
    return root


def image_trainers(root, tmp_path, bb, model=None, train=None, backbone="vgg16"):
    """(JAX trainer, port trainer): the same backbone tree, frozen, over the
    fixture's images decoded by PIL (64 px for VGG16 and a 2x2 grid of 512;
    for the ViT the tiny one of tests/test_torch_port_vgg_vit.py at 28 px,
    2x2 of 64); the port's starts from JAX's params."""
    from rau_vqa_tpu.data import images as jimages
    from rau_vqa_tpu_torch.data import images as timages
    from tests.test_torch_port_vgg_vit import JTINY, TTINY
    vit = backbone == "vit"
    model = {**IMAGE_MODEL, **({"cnn_dim": JTINY.dim} if vit else {}), **(model or {})}
    size = JTINY.image_size if vit else 64
    vqa_dir = os.path.join(root, "vqa_prepro")
    gt = jload.load_gt_annotations(os.path.join(vqa_dir, "gt_annotations.json"))
    out = []
    for exp, load, images, kw in (
            (tiny(jax_get_preset("ours_ms"), model, train), jload, jimages,
             dict(bb_params=bb, vit_cfg=JTINY if vit else None)),
            (tiny(get_experiment("ours_ms"), model, train, fused_eval=False), tload, timages,
             dict(bb_params=params_from_jax(bb), vit_cfg=TTINY if vit else None,
                  device="cpu"))):
        data = load.load_vqa_data(vqa_dir, exp.train.batch_size, split="val2014",
                                  test_batch_size=8)
        src = images.ImageDirSource(os.path.join(root, "images"), size=size)
        cls = jtrainer.Trainer if load is jload else ttrainer.Trainer
        out.append(cls(exp, data, src, str(tmp_path / load.__name__.split(".")[0]),
                       gt_anno=gt, backbone=backbone, **kw))
    jt, tt = out
    tt.state = tt.state._replace(params=params_from_jax(jax.tree.map(np.asarray,
                                                                     jt.state.params)))
    return jt, tt


@pytest.mark.parametrize("backbone,feat_norm", [("vgg16", False), ("vgg16", True),
                                                ("vit", False)])
def test_frozen_backbone_epoch_and_sweep_match_jax(image_fixture_root, tmp_path, backbone,
                                                   feat_norm):
    """One epoch and a sweep from the fixture's images through a frozen
    VGG16 (JAX's init, x0.72 a convolution) or a tiny ViT: per-step losses
    and epoch records at the train step's bar, params at 2e-3 per leaf by
    norm, the data order exactly, and the sweep's rows and accuracies equal
    (the plain float32 path on both sides), raw and RMS-normalized
    features."""
    from tests.test_torch_port_vgg_vit import JTINY, jax_vgg
    bb = (jax_vgg(0, 0.72) if backbone == "vgg16" else
          jax.tree.map(np.asarray, jvit.vit_init(jax.random.PRNGKey(0), JTINY)))
    jt, tt = image_trainers(image_fixture_root, tmp_path, bb, backbone=backbone,
                            train={"backbone_feat_norm": feat_norm})
    # the attention score's bias has a zero gradient in exact arithmetic
    # whatever the features (NOISE_ONLY); the detector finds no other leaf
    assert noise_only_leaves(tt) <= NOISE_ONLY
    a, b = jt.evaluate(return_rows=True), tt.evaluate(return_rows=True)
    assert b["rows_oe"] == a["rows_oe"] and b["testOEacc"] == a["testOEacc"]
    jl, tl, jq, tq = [], [], [], []
    record_steps(jt, jl, jq)
    record_steps(tt, tl, tq)
    ja, ta = jt.train_epoch(), tt.train_epoch()
    for k in ja:
        if k in ("sec", "examples_per_sec"):
            continue
        if k in ("epoch", "steps", "exploded", "lr", "mult_lr") or k.startswith("cmploss"):
            assert ta[k] == ja[k], k
        else:
            close(ta[k], ja[k], msg=k)
    assert len(tl) == len(jl) == 10
    close(torch.stack(tl).numpy(), np.asarray(jl), msg="per-step losses")
    for x, y in zip(tq, jq):
        np.testing.assert_array_equal(x, y)
    assert_params_close(tt.state.params, jt.state.params, NOISE_ONLY)
    a, b = jt.evaluate(return_rows=True), tt.evaluate(return_rows=True)
    assert b["rows_oe"] == a["rows_oe"] and b["rows_mc"] == a["rows_mc"]
    assert b["testOEacc"] == a["testOEacc"]
    path = tt.save()
    with open(path[:-len(".pt")] + ".json") as f:
        meta = json.load(f)
    assert meta["backbone_feat_norm"] is feat_norm and meta["backbone"] is None


def test_image_batches_stay_uint8_until_the_device(image_fixture_root, tmp_path, monkeypatch):
    """The pinning hook keeps an image batch uint8 (a float32 cast on the host
    is 4x the bytes and the wrong operand); _put_batch featurizes it on the
    device in the step's type, as extract_features does."""
    from rau_vqa_tpu_torch.models.pipeline import extract_features
    from tests.test_torch_port_vgg_vit import jax_vgg
    _, tt = image_trainers(image_fixture_root, tmp_path, jax_vgg(1, 0.72),
                           model={"compute_dtype": "bfloat16"})
    pinned = []

    def fake_pinned(a, dtype=None):
        pinned.append((np.asarray(a).dtype, dtype))
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t if dtype is None else t.to(dtype)

    monkeypatch.setattr(ttrainer, "_pinned", fake_pinned)
    monkeypatch.setattr(tt, "device", torch.device("cuda"))
    td = tt.data.train_data
    td.inorder()
    batch = next(iter(td.batches(tt.source, finish=tt._pinning(tt._train_ladder))))
    assert batch.feats.dtype == torch.uint8 and batch.feats.shape == (16, 64, 64, 3)
    assert pinned[0] == (np.uint8, None)
    monkeypatch.setattr(tt, "device", torch.device("cpu"))
    dev = tt._put_batch(batch)
    assert dev["feats"].dtype == torch.bfloat16 and dev["feats"].shape == (16, 4, 512)
    want = extract_features("vgg16", tt.bb_params, batch.feats).to(torch.bfloat16)
    assert torch.equal(dev["feats"], want)
