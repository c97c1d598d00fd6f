"""Fine-tuning at the flagship presets' widths, the port against the JAX
package, on the CPU: the three paths the card runs in the smoke's
fine-tuning phase, cut in depth and batch only.

- ``ours_vit`` grouped fine-tuning: one train step of the preset's head at
  its full widths (S 256, cnn 1024, rnn 512, 8 hops, 1000 answers) over a
  ViT of ViT-L/14's width (224 px, patch 14, dim 1024, 16 heads) cut to 2
  blocks, B=6 questions on 2 unique images (``img_repeat`` 3), with the
  backbone's block remat on and off, float32, dropout and gradient noise
  off.  Bar: every per-hop loss and every parameter leaf of the four
  groups elementwise at the train step's rtol 2e-3, atol 1e-6
  (tests/test_torch_port_paper_dims.py).
- ``ours_resnet_ft``'s fused hop loop (cnn 2048, S 196, M 512, F 256, R
  512, 8 hops, 1000 answers, the hop loop's dropout on) with features that
  require grad: the port's route, the backward kernel's plain version on
  CPU tensors, against JAX's autodiff of its plain loop (its fused route
  off the TPU).  Bars: float32 the scores and the features' gradient at
  rtol 2e-3, atol 1e-6; bf16 (JAX's ``compute_dtype`` bf16 at default
  matmul precision, as the preset ships) the features' gradient and the
  scores within 5% by norm, JAX's bf16 bar.
- A 3-epoch ``Trainer.fit`` fine-tuning a tiny ViT from the fixture's
  JPEGs in the ``imggroup`` order: the learning rate each group's Adam
  update takes at each step equals the JAX package's schedule (its
  Trainer's rates handed to its step, the backbone's at
  ``backbone_lr_scale``), no epoch aborts, and a resume from epoch 2's
  snapshot gives epoch 3's loss and parameters bit for bit.

Inputs come from numpy with a seed and reach both packages; the port
starts from the JAX package's initial state (``params_from_jax``).
"""

import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rau_vqa_tpu.config import TrainConfig as JaxTrainConfig
from rau_vqa_tpu.config import get_preset as jax_preset
from rau_vqa_tpu.models import rau as jrau
from rau_vqa_tpu.models.backbones import vit as JVT
from rau_vqa_tpu.ops import rau_train_hops as jth
from rau_vqa_tpu.train import trainer as jtrainer
from rau_vqa_tpu_torch.convert import map_tree, params_from_jax, tree_leaves
from rau_vqa_tpu_torch.models.backbones import vit as TVT
from rau_vqa_tpu_torch.ops import rau_train_hops as tth
from rau_vqa_tpu_torch.train import trainer as ttrainer
from tests.test_torch_port_finetune import (
    _trainer, by_path, jax_vit, port_state, trees_equal)
from tests.test_torch_port_train import port_model_cfg, port_train_cfg

NO_DROPOUT = dict(embed_dropout=0.0, rnn_dropout=0.0, mult_dropout=0.0, att_rnn_dropout=0.0)
# ViT-L/14's width and heads, cut to 2 of its 24 blocks
VIT_L2 = dict(image_size=224, patch=14, dim=1024, depth=2, heads=16)
B, G, T = 6, 3, 8                     # questions, questions an image, tokens
LR, MULT_LR = 3e-3, 3e-4


@pytest.fixture(autouse=True)
def four_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# (i) ours_vit: a grouped fine-tuning step through a ViT of ViT-L's width
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vit_start():
    """The JAX package's initial 4-group state at ``ours_vit``'s head widths
    over the 2-block ViT-L, one grouped batch and JAX's step on it."""
    jcfg = dataclasses.replace(jax_preset("ours_vit").model, **NO_DROPOUT)
    jvit_cfg = JVT.ViTConfig(**VIT_L2)
    bb = jax.tree.map(np.asarray, JVT.vit_init(jax.random.PRNGKey(1), jvit_cfg))
    state = jtrainer.init_train_state(jax.random.PRNGKey(0), jcfg, bb_params=bb)
    rs = np.random.RandomState(31)
    lengths = rs.randint(1, T + 1, B).astype(np.int32)
    lengths[0] = T
    tokens = np.zeros((B, T), np.int32)
    for k in range(B):
        tokens[k, :lengths[k]] = rs.randint(1, jcfg.vocab_size, lengths[k])
    images = rs.randint(0, 256, (B // G, 224, 224, 3)).astype(np.uint8)
    labels = rs.randint(0, jcfg.answer_size, B).astype(np.int32)
    batch = (tokens, lengths, images, labels)
    # JAX's step without remat (its remat gives the same values and grads,
    # tests/test_finetune.py:27-62)
    jtcfg = JaxTrainConfig(train_backbone=True, backbone_remat=False, noisy_eta=0.0)
    jstep = jax.jit(jtrainer.make_train_step(jcfg, jtcfg, backbone="vit", vit_cfg=jvit_cfg,
                                             img_repeat=G))
    jnew, jm = jstep(state, *(jnp.asarray(a) for a in batch),
                     jnp.ones(jcfg.n_hops, jnp.float32), jnp.float32(LR),
                     jnp.float32(MULT_LR))
    return jcfg, jtcfg, state, batch, jnew, jm


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
def test_ours_vit_grouped_fine_tuning_step_matches_jax(vit_start, remat):
    """The port's step with the ViT's block remat on and off against JAX's."""
    jcfg, jtcfg, jstate, batch, jnew, jm = vit_start
    assert (jcfg.cnn_spat, jcfg.cnn_dim, jcfg.rnn_size, jcfg.n_hops, jcfg.answer_size) == (
        256, 1024, 512, 8, 1000)
    hop_scale = np.ones(jcfg.n_hops, np.float32)
    tcfg = dataclasses.replace(port_train_cfg(jtcfg), backbone_remat=remat)
    assert tcfg.backbone_trust_ratio > 0
    step = ttrainer.make_train_step(port_model_cfg(jcfg), tcfg, device="cpu", backbone="vit",
                                    vit_cfg=TVT.ViTConfig(**VIT_L2), img_repeat=G)
    new, tm = step(port_state(jstate), *batch, hop_scale, LR, MULT_LR)
    np.testing.assert_allclose(tm["ce_per_hop"].numpy(), np.asarray(jm["ce_per_hop"]),
                               rtol=2e-3, atol=1e-6)
    assert tm["grad_norm_backbone"].item() > 0
    got, want = by_path(new.params), by_path(jax.tree.map(np.asarray, jnew.params))
    init = by_path(jax.tree.map(np.asarray, jstate.params))
    assert got.keys() == want.keys() and any(k.startswith("['backbone']") for k in got)
    for k, w in want.items():
        g = got[k].detach().numpy()
        np.testing.assert_allclose(g, w, rtol=2e-3, atol=1e-6, err_msg=k)
        # a leaf moved in both packages or in neither
        assert np.array_equal(g, init[k]) == np.array_equal(w, init[k]), k


# ---------------------------------------------------------------------------
# (ii) ours_resnet_ft's fused hop loop with the features' gradient
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def resnet_ft_hops():
    """``ours_resnet_ft``'s head weights (the JAX init), q, features and a
    score cotangent at its widths, B=2."""
    jcfg = jax_preset("ours_resnet_ft").model
    assert (jcfg.cnn_spat, jcfg.cnn_dim, jcfg.multfeat_dim, jcfg.attfeat_dim,
            jcfg.att_state_dim, jcfg.n_hops, jcfg.answer_size) == (196, 2048, 512, 256, 512,
                                                                   8, 1000)
    assert jcfg.mult_dropout > 0
    mp = jax.tree.map(np.asarray, jrau.init_params(jax.random.PRNGKey(2), jcfg)["mult"])
    rs = np.random.RandomState(32)
    Bh = 2
    q = rs.randn(Bh, jcfg.rnnout_dim).astype(np.float32)
    feats = np.abs(rs.randn(Bh, jcfg.cnn_spat, jcfg.cnn_dim)).astype(np.float32)
    g_scores = rs.randn(jcfg.n_hops, Bh, jcfg.answer_size).astype(np.float32)
    return jcfg, mp, q, feats, g_scores


def norm_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resnet_ft_fused_hop_loop_features_gradient_matches_jax(resnet_ft_hops, dtype):
    jcfg0, mp, q, feats, g_scores = resnet_ft_hops
    jcfg = dataclasses.replace(jcfg0, fused_train=True, compute_dtype=dtype,
                               matmul_precision="default" if dtype == "bfloat16"
                               else "highest")
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    seed = 987

    def jloss(f):
        jmp = jax.tree.map(lambda w: jnp.asarray(w, jdt), mp)
        scores = jth.rau_train_hops_reference(jmp, jcfg, jnp.asarray(q, jdt), f,
                                              jnp.int32(seed))[0]
        return jnp.sum(scores * g_scores), scores

    (_, jscores), jdf = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(feats, jdt))
    cfg = port_model_cfg(jcfg, fused_train_bwd="kernel")
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    f = torch.as_tensor(feats).to(tdt).requires_grad_()
    scores = tth.rau_train_hops(map_tree(lambda w: w.to(tdt), params_from_jax(mp)), cfg,
                                torch.as_tensor(q).to(tdt), f, seed)[0]
    (df,) = torch.autograd.grad(scores, f, torch.as_tensor(g_scores))
    assert df.shape == f.shape and float(np.abs(np.asarray(jdf, np.float32)).max()) > 1e-6
    got_s, want_s = scores.detach().float().numpy(), np.asarray(jscores, np.float32)
    got_d, want_d = df.float().numpy(), np.asarray(jdf, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got_s, want_s, rtol=2e-3, atol=1e-6)
        np.testing.assert_allclose(got_d, want_d, rtol=2e-3, atol=1e-6)
    else:
        assert norm_rel(got_s, want_s) <= 0.05
        assert norm_rel(got_d, want_d) <= 0.05


# ---------------------------------------------------------------------------
# (iii) a 3-epoch fit: the learning-rate schedule and the resume
# ---------------------------------------------------------------------------

# the fit's fixture: 48 questions on 12 images (4 a group), 3 steps an epoch
FIT_SPEC = dict(n_train=48, n_test=16, n_images=12)


def _jax_ft_trainer(root, workdir, exp_port, bb):
    """The JAX package's Trainer over the same bundle, experiment and
    backbone as the port's ``_trainer``."""
    from rau_vqa_tpu.data import images as jimages
    from rau_vqa_tpu.data import loader as jload
    from rau_vqa_tpu.data.fixtures import FixtureSpec, generate_fixture

    generate_fixture(root, FixtureSpec(**FIT_SPEC), images=True, image_size=28,
                     uniform_img_assign=True)
    exp = jax_preset("ours_ms")
    exp = exp.replace(
        model=dataclasses.replace(exp.model, **{
            f.name: getattr(exp_port.model, f.name) for f in dataclasses.fields(exp.model)
            if hasattr(exp_port.model, f.name)}),
        train=dataclasses.replace(exp.train, **{
            f.name: getattr(exp_port.train, f.name) for f in dataclasses.fields(exp.train)
            if hasattr(exp_port.train, f.name)}),
        data=dataclasses.replace(exp.data, split="val2014", batch_order="imggroup"))
    vqa_dir = os.path.join(root, "vqa_prepro")
    data = jload.load_vqa_data(vqa_dir, exp.train.batch_size, split="val2014",
                               test_batch_size=8)
    src = jimages.ImageDirSource(os.path.join(root, "images"), size=28)
    return jtrainer.Trainer(exp, data, src, str(workdir), backbone="vit", bb_params=bb,
                            vit_cfg=JVT.ViTConfig(image_size=28, patch=14, dim=32, depth=2,
                                                  heads=2))


def test_three_epoch_fit_decays_every_group_as_jax_and_resumes_bit_for_bit(tmp_path,
                                                                          monkeypatch):
    from rau_vqa_tpu_torch.data.fixtures import FixtureSpec

    spec = FixtureSpec(**FIT_SPEC)
    tr, _ = _trainer(str(tmp_path / "fix"), tmp_path / "run", spec=spec)
    assert tr.img_repeat == 4 and tr.train_backbone
    tcfg = tr.tcfg
    assert tcfg.lr_decay == tcfg.mult_lr_decay == 0.9 and tcfg.lr_decay_interval == 1
    # the rate each group's Adam update takes, step by step
    taken = []
    adam = ttrainer.adam_update
    monkeypatch.setattr(ttrainer, "adam_update", lambda p, g, lr, *a, **k: (
        taken.append(lr), adam(p, g, lr, *a, **k))[1])
    records = []
    epoch = tr.train_epoch
    monkeypatch.setattr(tr, "train_epoch", lambda: records.append(epoch()) or records[-1])
    tr.fit(3)
    assert [r["epoch"] for r in records] == [1, 2, 3]
    assert not any(r.get("aborted") for r in records)
    assert all(r["grad_norm_backbone"] > 0 for r in records)
    steps = [r["steps"] for r in records]
    assert steps == [3, 3, 3]
    groups = ("embed", "rnn", "mult", "backbone")
    assert len(taken) == len(groups) * sum(steps)

    # the JAX package's schedule: the rates its Trainer hands its step
    jtr = _jax_ft_trainer(str(tmp_path / "jfix"), tmp_path / "jrun", tr.exp,
                          jax_vit(3))
    handed = []
    jstep = jtr.train_step
    jtr.train_step = lambda *a: (handed.append((float(a[-2]), float(a[-1]))), jstep(*a))[1]
    jrecords = [jtr.train_epoch() for _ in range(3)]
    assert [r["steps"] for r in jrecords] == steps
    assert [(r["lr"], r["mult_lr"]) for r in jrecords] == [(r["lr"], r["mult_lr"])
                                                          for r in records]
    lr, mult_lr = tcfg.learning_rate, tcfg.mult_learning_rate
    for e, r in enumerate(records):
        assert (r["lr"], r["mult_lr"]) == (lr, mult_lr), e
        lr, mult_lr = lr * 0.9, mult_lr * 0.9
    for i, (jlr, jmult) in enumerate(handed):
        got = dict(zip(groups, taken[4 * i:4 * i + 4]))
        assert np.float32(got["embed"]) == np.float32(got["rnn"]) == np.float32(jlr), i
        assert np.float32(got["mult"]) == np.float32(jmult), i
        # JAX's backbone group: lr * backbone_lr_scale in float32
        np.testing.assert_allclose(got["backbone"], jlr * tcfg.backbone_lr_scale, rtol=1e-7)
    assert got["backbone"] == got["embed"] * float(tcfg.backbone_lr_scale)

    # the resume from epoch 2's snapshot runs epoch 3 to the same bits
    snaps = sorted(glob.glob(os.path.join(tr.ckpt_dir, "*epoch2.00*.pt")))
    assert len(snaps) == 1, os.listdir(tr.ckpt_dir)
    tr2, _ = _trainer(str(tmp_path / "fix"), tmp_path / "resumed", spec=spec)
    tr2.restore(snaps[0])
    assert tr2.epoch == 2 and tr2.lr == records[2]["lr"] and tr2.mult_lr == records[2]["mult_lr"]
    rec3 = tr2.train_epoch()
    assert rec3["loss"] == records[2]["loss"] and rec3["steps"] == records[2]["steps"]
    assert trees_equal(tr2.state.params, tr.state.params)
    assert trees_equal(tr2.state.opt, tr.state.opt)
    assert (tr2.state.step, tr2.epoch, tr2.lr) == (tr.state.step, tr.epoch, tr.lr)
    assert any(not torch.equal(a, b) for a, b in zip(
        tree_leaves(tr.state.params["backbone"]),
        tree_leaves(map_tree(lambda x: x.float(), params_from_jax(jax_vit(3))))))


# ---------------------------------------------------------------------------
# the FLOP count of a ViT-L/14 fine-tuning step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
def test_vit_finetune_step_flops_is_the_counters(remat):
    """``train_step_flops`` for a grouped ViT fine-tuning step (the 2-block
    ViT-L at 224 px, 2 images, 3 questions each): the ViT's forward and
    backward less the patch embedding's input gradient, with remat one more
    forward of its blocks but their last product (``fc2``: the checkpoint
    stops at the last tensor the backward saved; the patch embedding is not
    checkpointed), and the head with the features' gradient, against
    ``FlopCounterMode`` over the step."""
    from torch.utils.flop_counter import FlopCounterMode

    from rau_vqa_tpu_torch import config as tconfig
    from rau_vqa_tpu_torch.utils.flops import train_step_flops
    from tests.test_torch_port_scripts import JCFG as SCFG
    from tests.test_torch_port_scripts import port_cfg

    vit_cfg = TVT.ViTConfig(**VIT_L2)
    mcfg = port_cfg(SCFG, cnn_dim=1024, cnn_w=16, cnn_h=16)
    tcfg = tconfig.TrainConfig(train_backbone=True, backbone_remat=remat)
    rs = np.random.RandomState(2)
    images = rs.randint(0, 256, (2, 224, 224, 3)).astype(np.uint8)
    T = mcfg.seq_len
    tokens, lengths = rs.randint(1, mcfg.vocab_size, (6, T)), rs.randint(1, T + 1, 6)
    labels = rs.randint(0, mcfg.answer_size, 6)
    bb = TVT.vit_init(torch.Generator().manual_seed(0), vit_cfg, device="cpu")
    state = ttrainer.init_train_state(mcfg, 0, device="cpu", bb_params=bb)
    step = ttrainer.make_train_step(mcfg, tcfg, device="cpu", backbone="vit", vit_cfg=vit_cfg,
                                    img_repeat=3)
    with FlopCounterMode(display=False) as fc:
        step(state, tokens, lengths, images, labels, np.ones(mcfg.n_hops, np.float32), LR,
             MULT_LR)
    got = fc.get_total_flops()
    want = train_step_flops(mcfg, 6, T, backbone="vit", size=224, n_images=2,
                            train_backbone=True, backbone_remat=remat, vit_cfg=vit_cfg)
    assert abs(want / got - 1) <= 0.02, (want, got)


def test_bench_train_runs_the_finetune_variants_fused_on_request():
    """``bench_train --ft-fused``: the fine-tuning variants through the fused
    hop loop (the training kernels, the backward with the features'
    gradient), ``ours_resnet_ft`` as shipped with ``--ft-no-remat``; without
    it the preset's unfused hops."""
    from rau_vqa_tpu_torch import config as tconfig
    from rau_vqa_tpu_torch.scripts import bench_train as tbt

    m, t = tconfig.get_train_preset("ours_resnet_ft")
    for fused in (False, True):
        v = tbt.variant("finetunegrp", m, t, f32=False, preset="ours_resnet_ft",
                        ft_no_remat=True, ft_fused=fused)
        assert v.kind == "finetune" and v.grouped and v.backbone == "resnet101"
        assert v.mcfg.fused_train is fused and v.mcfg.compute_dtype == "bfloat16"
        assert v.mcfg.fused_train_bwd == "kernel" and not v.tcfg.backbone_remat
    assert not tbt.variant("plain", m, t, f32=False, ft_fused=True).mcfg.fused_train
