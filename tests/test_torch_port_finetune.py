"""Backbone fine-tuning in the port (rau_vqa_tpu_torch) against the JAX
package's (tests/test_finetune.py), on the CPU in float32.

Sizes: a tiny ViT (image 28, patch 14, dim 32, depth 2, 2 heads; the JAX
test's) under a head of its 2x2 grid; VGG16 and ResNet-101 at their full
widths at 32 px, B=2.  Bars: remat against no remat at JAX's (values 1e-6,
grads rtol 1e-5 / atol 1e-4, tests/test_finetune.py:27-62); one train step
against JAX's at the train step's per-leaf bars (rtol 2e-3, atol 1e-6;
tests/test_torch_port_train.py), the backbone's leaves held alike; the
fused hop loop's features gradient against JAX's autodiff of its plain loop
at rtol 1e-4.  Inputs come from numpy with a seed and reach both
packages."""

import base64
import dataclasses
import glob
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rau_vqa_tpu.config import ModelConfig as JaxModelConfig
from rau_vqa_tpu.config import TrainConfig as JaxTrainConfig
from rau_vqa_tpu.models.backbones import vit as JVT
from rau_vqa_tpu.ops import rau_train_hops as jth
from rau_vqa_tpu.train import trainer as jtrainer
from rau_vqa_tpu.utils import checkpoint as jck
from rau_vqa_tpu_torch import cli as tcli
from rau_vqa_tpu_torch import config as tconfig
from rau_vqa_tpu_torch.convert import map_tree, params_from_jax, tree_leaves
from rau_vqa_tpu_torch.models import pipeline as TP
from rau_vqa_tpu_torch.models.backbones import resnet as TR
from rau_vqa_tpu_torch.models.backbones import vgg as TV
from rau_vqa_tpu_torch.models.backbones import vit as TVT
from rau_vqa_tpu_torch.ops import rau_train_hops as tth
from rau_vqa_tpu_torch.train import optim as toptim
from rau_vqa_tpu_torch.train import trainer as ttrainer
from rau_vqa_tpu_torch.utils import checkpoint as tck
from tests.test_torch_port_backbone import narrow_resnet
from tests.test_torch_port_train import port_model_cfg, port_train_cfg
from tests.test_torch_port_vgg_vit import jax_vgg

VIT = dict(image_size=28, patch=14, dim=32, depth=2, heads=2)
JVIT, TVIT = JVT.ViTConfig(**VIT), TVT.ViTConfig(**VIT)
# the head of the JAX test's _tiny_mcfg over the tiny ViT's 2x2x32 grid
JCFG = JaxModelConfig(vocab_size=40, answer_size=9, seq_len=7, embed_dim=8, rnn_size=16,
                      rnn_layers=2, cnn_dim=32, cnn_w=2, cnn_h=2, multfeat_dim=16,
                      attfeat_dim=8, att_rnn_size=16, n_hops=2, embed_dropout=0.0,
                      rnn_dropout=0.0, mult_dropout=0.0)
LR, MULT_LR = 1e-3, 1e-4
HOP_SEED = 4321


def t(x):
    return torch.as_tensor(np.array(x))


def u8(B, size, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (B, size, size, 3)).astype(np.uint8)


def batch(B=8, seed=0, cfg=JCFG):
    rs = np.random.RandomState(seed)
    lengths = rs.randint(1, cfg.seq_len + 1, B).astype(np.int32)
    tokens = np.zeros((B, cfg.seq_len), np.int32)
    for k in range(B):
        tokens[k, :lengths[k]] = rs.randint(1, cfg.vocab_size, lengths[k])
    images = rs.randint(0, 256, (B, 28, 28, 3)).astype(np.uint8)
    labels = rs.randint(0, cfg.answer_size, B).astype(np.int32)
    return tokens, lengths, images, labels


def jax_vit(seed):
    return jax.tree.map(np.asarray, JVT.vit_init(jax.random.PRNGKey(seed), JVIT))


def port_state(jstate, seed=0):
    params = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    groups = [g for g in ("embed", "rnn", "mult", "backbone") if g in params]
    return ttrainer.TrainState(params, {g: toptim.adam_init(params[g]) for g in groups},
                               step=0, seed=seed)


def by_path(tree):
    return {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def assert_trees_close(got, want, rtol, atol):
    g, w = by_path(got), by_path(want)
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_allclose(np.asarray(g[k].detach() if torch.is_tensor(g[k]) else g[k]),
                                   np.asarray(w[k]), rtol=rtol, atol=atol, err_msg=k)


def trees_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


# ---------------------------------------------------------------------------
# block remat in the three backbones
# ---------------------------------------------------------------------------

def _backbone(kind):
    if kind == "vgg16":
        return params_from_jax(jax_vgg(0, 0.72)), u8(2, 32), None
    if kind == "resnet101":
        bb = TR.resnet101_init(torch.Generator().manual_seed(0), device="cpu")
        return bb, u8(2, 32), None
    return params_from_jax(jax_vit(0)), u8(2, 28), TVIT


@pytest.mark.parametrize("kind", ["vgg16", "resnet101", "vit"])
def test_remat_matches_no_remat_values_and_grads(kind):
    """The same features and grads with each block checkpointed
    (tests/test_finetune.py:27-62, at its bars)."""
    bb, images, vit_cfg = _backbone(kind)
    x = torch.as_tensor(images)
    outs = {}
    for remat in (False, True):
        p = map_tree(lambda a: a.detach().requires_grad_(), bb)
        y = TP.extract_features(kind, p, x, vit_cfg, remat=remat)
        grads = torch.autograd.grad(y.square().sum(), tree_leaves(p))
        outs[remat] = (y.detach(), grads)
    np.testing.assert_allclose(outs[True][0].numpy(), outs[False][0].numpy(),
                               rtol=1e-6, atol=1e-6)
    for g1, g0 in zip(outs[True][1], outs[False][1]):
        np.testing.assert_allclose(g1.numpy(), g0.numpy(), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("kind", ["vgg16", "resnet101", "vit"])
def test_remat_grads_match_jax(kind):
    """The backbone's gradient under remat, against JAX's
    ``jax.grad`` of its remat forward (a narrow ResNet in the JAX layout
    for ResNet-101's blocks).  The loss weighs the features at random: the
    sum of squares of LayerNorm'd ViT tokens is nearly constant, which
    leaves most of the ViT's gradient to rounding."""
    from rau_vqa_tpu.models import pipeline as JP
    if kind == "vgg16":
        jbb, images = jax_vgg(1, 0.72), u8(2, 32, 1)
    elif kind == "resnet101":
        jbb, images = narrow_resnet(2, blocks=(2, 1, 1, 1)), u8(2, 32, 2)
    else:
        jbb, images = jax_vit(3), u8(2, 28, 3)
    cfg = {"vit_cfg": JVIT} if kind == "vit" else {}
    shape = JP.extract_features(kind, jbb, jnp.asarray(images), **cfg).shape
    r = np.random.RandomState(7).randn(*shape).astype(np.float32)

    def jloss(p):
        return jnp.sum(JP.extract_features(kind, p, jnp.asarray(images), remat=True,
                                           **cfg) * r)

    want = jax.grad(jloss)(jax.tree.map(jnp.asarray, jbb))
    p = map_tree(lambda a: a.requires_grad_(), params_from_jax(jbb))
    y = TP.extract_features(kind, p, torch.as_tensor(images), TVIT if kind == "vit" else None,
                            remat=True)
    flat = iter(torch.autograd.grad((y * torch.as_tensor(r)).sum(), tree_leaves(p)))
    got, want = by_path(map_tree(lambda _: next(flat), p)), by_path(want)
    assert got.keys() == want.keys()
    for k, w in want.items():
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(got[k].numpy() / scale, w / scale, rtol=0, atol=3e-5,
                                   err_msg=k)


def test_remat_and_fused_stages_are_exclusive():
    folded = TR.fold_batchnorm(params_from_jax(narrow_resnet(1, blocks=(2, 1, 1, 1))))
    with pytest.raises(ValueError, match="exclusive"):
        TR.resnet101_apply(folded, torch.zeros(1, 32, 32, 3), fused_stages=(0,), remat=True)


@pytest.mark.parametrize("kind", ["vgg16", "resnet101"])
def test_a_training_step_leaves_nothing_in_the_weight_memo(kind):
    """The prepared-weight memo keeps serving trees alone: a tree being
    trained is prepared afresh, so no step's tree or graph stays reachable
    from the memo, which still holds the serving tree it held."""
    memo = TR._prepared if kind == "resnet101" else TV._prepared
    bb, images, _ = _backbone(kind)
    x = torch.as_tensor(images)
    with torch.no_grad():
        TP.extract_features(kind, bb, x)
    held = [tree for tree, _ in memo.entries]
    assert held and held[-1] is bb
    for remat in (False, True):
        p = map_tree(lambda a: a.detach().requires_grad_(), bb)
        y = TP.extract_features(kind, p, x, remat=remat)
        torch.autograd.grad(y.sum(), tree_leaves(p))
        assert [tree for tree, _ in memo.entries] == held
        for tree, value in memo.entries:
            assert not any(a.requires_grad for a in tree_leaves(tree))
            assert not any(torch.is_tensor(a) and a.grad_fn is not None
                           for a in tree_leaves(value))


# ---------------------------------------------------------------------------
# F2: the fused hop loop's features gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bwd", ["kernel", "xla"])
def test_fused_hop_loop_differentiates_the_features(bwd):
    """With fused_train=True and features that require grad, their gradient
    is JAX's autodiff of ``rau_train_hops_reference`` (the JAX package's
    fused route on the CPU), with every dropout mask on.  The kernel route
    on the CPU is the backward kernel's plain version."""
    jcfg = dataclasses.replace(JCFG, n_hops=3, mult_dropout=0.3, fused_train=True)
    cfg = port_model_cfg(jcfg, fused_train_bwd=bwd)
    rs = np.random.RandomState(5)
    from rau_vqa_tpu.models import rau as jrau
    mp = jax.tree.map(np.asarray, jrau.init_params(jax.random.PRNGKey(1), jcfg)["mult"])
    B = 5
    q = rs.randn(B, jcfg.rnnout_dim).astype(np.float32)
    feats = rs.randn(B, jcfg.cnn_spat, jcfg.cnn_dim).astype(np.float32)
    g_scores = rs.randn(jcfg.n_hops, B, jcfg.answer_size).astype(np.float32)

    def jloss(f):
        scores = jth.rau_train_hops_reference(mp, jcfg, jnp.asarray(q), f,
                                              jnp.int32(HOP_SEED))[0]
        return jnp.sum(scores * g_scores)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(feats)))
    f = torch.as_tensor(feats).requires_grad_()
    scores = tth.rau_train_hops(params_from_jax(mp), cfg, torch.as_tensor(q), f, HOP_SEED)[0]
    (got,) = torch.autograd.grad(scores, f, torch.as_tensor(g_scores), allow_unused=True)
    assert got is not None, "the fused hop loop gave the features no gradient"
    assert float(np.abs(want).max()) > 1e-3
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)


def test_frozen_features_leave_the_backward_as_it_was():
    """Features that do not require grad: the backward's grads are those of
    the call without the features' product, bit for bit."""
    cfg = port_model_cfg(dataclasses.replace(JCFG, mult_dropout=0.3, fused_train=True))
    rs = np.random.RandomState(6)
    from rau_vqa_tpu_torch.models.rau import init_params
    mp = init_params(cfg, torch.Generator().manual_seed(0), "cpu")["mult"]
    q = torch.as_tensor(rs.randn(3, cfg.rnnout_dim).astype(np.float32))
    feats = torch.as_tensor(rs.randn(3, cfg.cnn_spat, cfg.cnn_dim).astype(np.float32))
    seed = torch.tensor([HOP_SEED], dtype=torch.int32)
    _, _, _, c_all, h_all = tth.train_hops_fwd(mp, cfg, q, feats, seed)
    gmerge = torch.as_tensor(rs.randn(cfg.n_hops, 3, cfg.multfeat_dim).astype(np.float32))
    em0, gw0 = tth.train_hops_bwd(mp, cfg, q, feats, seed, c_all, h_all, gmerge)
    em1, gw1 = tth.train_hops_bwd(mp, cfg, q, feats, seed, c_all, h_all, gmerge, True)
    assert tth.DFEATS not in gw0 and gw1[tth.DFEATS].shape == feats.shape
    assert all(torch.equal(em0[k], em1[k]) for k in em0)
    assert all(torch.equal(gw0[k], gw1[k]) for k in gw0)
    plan0 = tth.bwd_plan(3, cfg.cnn_spat, cfg.cnn_dim, cfg.multfeat_dim, cfg.attfeat_dim,
                         cfg.att_state_dim, cfg.rnnout_dim, 132)
    plan1 = tth.bwd_plan(3, cfg.cnn_spat, cfg.cnn_dim, cfg.multfeat_dim, cfg.attfeat_dim,
                         cfg.att_state_dim, cfg.rnnout_dim, 132, dfeats=True)
    names = [p.name for p in plan1.phases]
    assert names == [p.name for p in plan0.phases][:names.index("dfeats")] + ["dfeats"] + \
        [p.name for p in plan0.phases][names.index("dfeats"):]
    df = plan1.phases[names.index("dfeats")]
    P = 3 * cfg.cnn_spat
    assert (df.M, df.N, df.K) == (P, cfg.cnn_dim, cfg.multfeat_dim) and not df.split


# ---------------------------------------------------------------------------
# the 4-group train step against JAX's
# ---------------------------------------------------------------------------

def _jax_ft_state(jcfg):
    return jtrainer.init_train_state(jax.random.PRNGKey(0), jcfg, bb_params=jax_vit(1))


@pytest.mark.parametrize("fused", [True, False])
def test_fine_tuning_step_matches_jax(fused, monkeypatch):
    """One step of make_train_step(train_backbone=True) through the ViT, noise
    off: fused with the hop loop's dropout on (the counter-hash masks are
    the same bits in both packages, the hop seed JAX's), unfused with
    dropout off.  Every metric, the new params and the Adam moments (m holds
    the clipped grads) of all four groups agree."""
    jcfg = dataclasses.replace(JCFG, fused_train=fused, mult_dropout=0.2 if fused else 0.0)
    jtcfg = JaxTrainConfig(train_backbone=True, noisy_eta=0.0)
    tokens, lengths, images, labels = batch(seed=1)
    hop_scale = np.ones(jcfg.n_hops, np.float32)
    jstate = _jax_ft_state(jcfg)
    jstep = jax.jit(jtrainer.make_train_step(jcfg, jtcfg, backbone="vit", vit_cfg=JVIT))
    jnew, jm = jstep(jstate, *(jnp.asarray(a) for a in (tokens, lengths, images, labels,
                                                          hop_scale)),
                     jnp.float32(LR), jnp.float32(MULT_LR))
    if fused:
        # the step's hop seed, as JAX's rau_forward draws it from the state's key
        _, k_fwd, _ = jax.random.split(jstate.rng, 3)
        seed = int(jax.random.randint(jax.random.fold_in(k_fwd, 1), (), 0,
                                      jnp.iinfo(jnp.int32).max, dtype=jnp.int32))
        forward = ttrainer.rau_forward
        monkeypatch.setattr(ttrainer, "rau_forward",
                            lambda *a, **k: forward(*a, **{**k, "hop_seed": seed}))
    step = ttrainer.make_train_step(port_model_cfg(jcfg), port_train_cfg(jtcfg),
                                    device="cpu", backbone="vit", vit_cfg=TVIT)
    new, tm = step(port_state(jstate), tokens, lengths, images, labels, hop_scale, LR,
                   MULT_LR)
    assert set(tm) == set(jm) and "grad_norm_backbone" in tm
    for k in jm:
        np.testing.assert_allclose(tm[k].detach().numpy(), np.asarray(jm[k]),
                                   rtol=2e-3, atol=1e-6, err_msg=k)
    assert_trees_close(new.params, jax.tree.map(np.asarray, jnew.params), 2e-3, 1e-6)
    for g in ("embed", "rnn", "mult", "backbone"):
        assert_trees_close(new.opt[g]["m"], jax.tree.map(np.asarray, jnew.opt[g]["m"]),
                           2e-3, 1e-8)
    moved = [not trees_equal(new.params[g], port_state(jstate).params[g])
             for g in ("embed", "rnn", "mult", "backbone")]
    assert all(moved)


def test_init_train_state_keeps_float32_masters():
    bb16 = map_tree(lambda a: a.to(torch.bfloat16), params_from_jax(jax_vit(1)))
    state = ttrainer.init_train_state(port_model_cfg(JCFG), 0, device="cpu", bb_params=bb16)
    assert set(state.params) == set(state.opt) == {"embed", "rnn", "mult", "backbone"}
    assert {a.dtype for a in tree_leaves(state.params["backbone"])} == {torch.float32}
    assert {a.dtype for a in tree_leaves(state.opt["backbone"]["m"])} == {torch.float32}


def _port_ft(tcfg=None, **kw):
    cfg = port_model_cfg(JCFG)
    tcfg = tcfg or tconfig.TrainConfig(train_backbone=True, noisy_eta=0.0)
    state = ttrainer.init_train_state(cfg, 0, device="cpu", bb_params=params_from_jax(jax_vit(1)))
    step = ttrainer.make_train_step(cfg, tcfg, device="cpu", backbone="vit", vit_cfg=TVIT,
                                    **kw)
    return cfg, tcfg, state, step


def test_img_repeat_matches_duplicated_images():
    """Grouped batches (each unique image once through the backbone, its
    features repeated to its questions) give the update of the duplicated
    images (tests/test_finetune.py:194-221, at its bars)."""
    k = 2
    tokens, lengths, images, labels = batch(seed=2)
    uniq = images[::k]
    dup = np.repeat(uniq, k, axis=0)
    hop_scale = np.ones(JCFG.n_hops, np.float32)
    _, _, state, step_dup = _port_ft()
    _, _, _, step_grp = _port_ft(img_repeat=k)
    s1, m1 = step_dup(state, tokens, lengths, dup, labels, hop_scale, LR, MULT_LR)
    s2, m2 = step_grp(state, tokens, lengths, uniq, labels, hop_scale, LR, MULT_LR)
    np.testing.assert_allclose(m2["loss"].item(), m1["loss"].item(), rtol=1e-6)
    assert_trees_close(s2.params, map_tree(lambda a: a.numpy(), s1.params), 2e-4, 1e-6)


def test_grad_accum_through_the_backbone_matches_one_batch():
    """Two microbatches, each input split by its own length (the unique
    images of a grouped batch too), give one full batch's update
    (tests/test_finetune.py:125-151)."""
    tokens, lengths, images, labels = batch(seed=3)
    hop_scale = np.ones(JCFG.n_hops, np.float32)
    _, tcfg, state, step = _port_ft()
    _, _, _, step2 = _port_ft(dataclasses.replace(tcfg, grad_accum=2))
    s1, m1 = step(state, tokens, lengths, images, labels, hop_scale, LR, MULT_LR)
    s2, m2 = step2(state, tokens, lengths, images, labels, hop_scale, LR, MULT_LR)
    np.testing.assert_allclose(m2["loss"].item(), m1["loss"].item(), rtol=1e-5)
    assert_trees_close(s2.params, map_tree(lambda a: a.numpy(), s1.params), 1e-4, 1e-6)
    # grouped: 8 questions on 4 unique images, microbatches of 4 and 2 images
    _, _, _, grp = _port_ft(img_repeat=2)
    _, _, _, grp2 = _port_ft(dataclasses.replace(tcfg, grad_accum=2), img_repeat=2)
    g1, n1 = grp(state, tokens, lengths, images[::2], labels, hop_scale, LR, MULT_LR)
    g2, n2 = grp2(state, tokens, lengths, images[::2], labels, hop_scale, LR, MULT_LR)
    np.testing.assert_allclose(n2["loss"].item(), n1["loss"].item(), rtol=1e-5)
    assert_trees_close(g2.params, map_tree(lambda a: a.numpy(), g1.params), 1e-4, 1e-6)
    _, _, _, bad = _port_ft(dataclasses.replace(tcfg, grad_accum=4), img_repeat=4)
    with pytest.raises(ValueError, match="image-group boundaries"):
        bad(state, tokens, lengths, images[::4], labels, hop_scale, LR, MULT_LR)


def test_zero_signal_freeze_ignores_injected_noise():
    """With hop_scale 0 every gradient is exactly zero: the backbone's noise
    keeps its post-noise norm above 0, yet the freeze, which reads the
    gradient before the noise, holds it still; the head integrates its noise
    (tests/test_finetune.py:909-943)."""
    tcfg = tconfig.TrainConfig(train_backbone=True, backbone_grad_noise=True, noisy_eta=0.3,
                               noisy_gamma=0.55)
    _, _, state, step = _port_ft(tcfg)
    tokens, lengths, images, labels = batch(seed=4)
    new, m = step(state, tokens, lengths, images, labels, np.zeros(JCFG.n_hops, np.float32),
                  LR, MULT_LR)
    assert m["grad_norm_backbone"].item() > 0
    assert trees_equal(new.params["backbone"], state.params["backbone"])
    assert not trees_equal(new.params["embed"], state.params["embed"])


def test_trust_ratio_cap():
    """Oversized steps scale to tau (||w|| + 1e-3), small ones pass as they
    are, a zero-norm leaf still moves (tests/test_finetune.py:224-247)."""
    old = {"w": torch.ones(4) * 2.0, "b": torch.zeros(3), "s": torch.ones(2)}
    new = {"w": old["w"] + 1.0, "b": old["b"] + 1e-2, "s": old["s"] + 1e-6}
    out = toptim.trust_ratio_cap(new, old, tau=0.01)
    np.testing.assert_allclose((out["w"] - old["w"]).norm().item(), 0.01 * (4 + 1e-3),
                               rtol=1e-5)
    ub = (out["b"] - old["b"]).norm().item()
    np.testing.assert_allclose(ub, 0.01 * 1e-3, rtol=1e-5)
    assert ub > 0
    assert torch.equal(out["s"], new["s"])


def test_fine_tuning_needs_a_backbone():
    cfg = port_model_cfg(JCFG)
    with pytest.raises(ValueError, match="train_backbone"):
        ttrainer.make_train_step(cfg, tconfig.TrainConfig(train_backbone=True), device="cpu")
    with pytest.raises(ValueError, match="img_repeat"):
        ttrainer.make_train_step(cfg, tconfig.TrainConfig(), device="cpu", img_repeat=2)


def test_resnet_ft_preset():
    """ours_resnet_ft as the JAX package ships it: a trainable backbone,
    grouped batches, no remat, bf16 (tests/test_finetune.py:249-260)."""
    exp = tconfig.get_experiment("ours_resnet_ft")
    assert exp.train.train_backbone and not exp.train.backbone_remat
    assert exp.train.batch_size == 288 and exp.data.batch_order == "imggroup"
    assert exp.model.compute_dtype == "bfloat16" and exp.model.cnn_dim == 2048


# ---------------------------------------------------------------------------
# the Trainer, snapshots, the service and the CLI
# ---------------------------------------------------------------------------

def _trainer(root, workdir, *, train_backbone=True, order="imggroup", bb=None,
             dtype="float32", spec=None):
    from rau_vqa_tpu_torch.data.fixtures import FixtureSpec, fixture_bundle
    from rau_vqa_tpu_torch.data.images import ImageDirSource
    from rau_vqa_tpu_torch.data.loader import build_vqa_data
    bundle = fixture_bundle(root, spec or FixtureSpec(), images=True, image_size=28,
                            uniform_img_assign=True)
    exp = tconfig.get_experiment("ours_ms")
    exp = exp.replace(
        model=dataclasses.replace(exp.model, n_hops=2, cnn_dim=VIT["dim"], cnn_w=2, cnn_h=2,
                                  embed_dim=16, rnn_size=16, multfeat_dim=16, attfeat_dim=8,
                                  att_rnn_size=16, embed_dropout=0.0, rnn_dropout=0.0,
                                  mult_dropout=0.1, compute_dtype=dtype),
        train=dataclasses.replace(exp.train, batch_size=16, noisy_eta=0.0, grad_clip=10.0,
                                  length_buckets=(), train_backbone=train_backbone,
                                  backbone_lr_scale=0.5),
        data=dataclasses.replace(exp.data, split="val2014", batch_order=order))
    data = build_vqa_data(bundle.info, bundle.arrays, 16, split="val2014", test_batch_size=8)
    src = ImageDirSource(os.path.join(root, "images"), size=28, backend="pil")
    gt = {int(k): v for k, v in bundle.gt.items()}
    bb = params_from_jax(jax_vit(3)) if bb is None else bb
    return ttrainer.Trainer(exp, data, src, str(workdir), gt_anno=gt, device="cpu",
                            backbone="vit", bb_params=bb, vit_cfg=TVIT), bundle


def test_trainer_fine_tunes_saves_resumes_and_serves(tmp_path):
    """A grouped fine-tuning epoch on the fixture's images: the backbone
    moves, the sweep featurizes with the trained group, the 4-group snapshot
    records its backbone and resumes to the same bits, the service answers
    through the snapshot's own backbone as ``answer_pixels`` does, and a
    head-only snapshot warm-starts a fine-tuning run
    (tests/test_finetune.py:319-475)."""
    root = str(tmp_path / "fix")
    tr, bundle = _trainer(root, tmp_path / "run")
    assert tr.img_repeat == 4     # 160 questions on 40 images
    bb0 = map_tree(lambda a: a.clone(), tr.state.params["backbone"])
    rec = tr.train_epoch()
    assert np.isfinite(rec["loss"]) and "grad_norm_backbone" in rec
    assert not trees_equal(tr.state.params["backbone"], bb0)
    assert tr._bb_tree() is tr.state.params["backbone"]
    res = tr.evaluate(write_submissions=False)
    assert len(res["testOEacc"]) == tr.mcfg.n_hops + 2
    path = tr.save()
    meta = tck.checkpoint_meta(path)
    assert meta["train_backbone"] is True and meta["backbone"] == "vit"
    assert tck.has_backbone_group(path)
    tr2, _ = _trainer(root, tmp_path / "run2")
    tr2.restore(path)
    assert trees_equal(tr2.state.params, tr.state.params)
    assert trees_equal(tr2.state.opt["backbone"]["v"], tr.state.opt["backbone"]["v"])
    # the service: the snapshot's backbone, in the type it was trained in
    from rau_vqa_tpu_torch.data.loader import build_vqa_data
    from rau_vqa_tpu_torch.serve import RAUService
    data = build_vqa_data(bundle.info, bundle.arrays, 1, split="val2014", test_batch_size=1)
    svc = RAUService(path, None, [], data=data, device="cpu", vit_cfg=TVIT)
    try:
        assert svc.backbone == "vit" and svc.feat_norm is False
        assert trees_equal(svc.bb_params, tr.state.params["backbone"])
        from PIL import Image
        buf = io.BytesIO()
        Image.fromarray(u8(1, 28, 9)[0]).save(buf, format="PNG")
        question = "w01 w02 w03"
        out = svc.answer(question, image_b64=base64.b64encode(buf.getvalue()).decode())
        tokens, length = data.question_to_tokens(question, normalize=True)
        ids, _ = TP.answer_pixels(ttrainer.head_params(tr.state.params),
                                  tr.state.params["backbone"], tr.mcfg, "vit",
                                  svc._decode_image(buf.getvalue()), tokens[None],
                                  np.asarray([length]), vit_cfg=TVIT, device="cpu")
        answers = [data.answers[int(i)] for i in ids[:, 0]]
        assert out["per_hop"] == answers[:-2]
        assert out["answers"][0]["answer"] == answers[-1]
    finally:
        svc.close()
    # warm start: a frozen-backbone run's head-only snapshot
    frozen, _ = _trainer(root, tmp_path / "frozen", train_backbone=False, order="shuffle")
    frozen.train_epoch()
    head = frozen.save()
    assert not tck.has_backbone_group(head)
    warm, _ = _trainer(root, tmp_path / "warm")
    bb_init = map_tree(lambda a: a.clone(), warm.state.params["backbone"])
    warm.restore(head)
    assert trees_equal(ttrainer.head_params(warm.state.params),
                       ttrainer.head_params(frozen.state.params))
    assert trees_equal(warm.state.params["backbone"], bb_init)
    assert warm.epoch == 0 and warm.state.step == 0


def test_bf16_sweep_and_service_run_the_backbone_the_step_trains(tmp_path):
    """Under bf16 the step computes the backbone on a bf16 cast of its
    float32 masters; the eval sweep's features and the service's backbone
    are that same cast, not the float32 masters."""
    from rau_vqa_tpu_torch.data.loader import build_vqa_data
    from rau_vqa_tpu_torch.serve import RAUService
    root = str(tmp_path / "fix")
    tr, bundle = _trainer(root, tmp_path / "run", dtype="bfloat16")
    masters = tr.state.params["backbone"]
    assert {a.dtype for a in tree_leaves(masters)} == {torch.float32}
    images = t(u8(3, 28, 11))
    with torch.no_grad():
        want = ttrainer.featurizer(tr.mcfg, tr.tcfg, "vit", TVIT)(masters, images)
        f32 = TP.extract_features("vit", masters, images, TVIT)
    got = tr._featurize(images)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert not torch.equal(got.float(), f32)
    path = tr.save()
    data = build_vqa_data(bundle.info, bundle.arrays, 1, split="val2014", test_batch_size=1)
    svc = RAUService(path, None, [], data=data, device="cpu", vit_cfg=TVIT)
    try:
        assert svc.mcfg.compute_dtype == "bfloat16"
        assert trees_equal(svc.bb_params, ttrainer.trained_backbone(tr.mcfg, masters))
        assert {a.dtype for a in tree_leaves(svc.bb_params)} == {torch.bfloat16}
    finally:
        svc.close()


def test_load_backbone_group_from_both_formats(tmp_path):
    """A fine-tuned snapshot's 4th group, from the JAX package's .msgpack
    (a plain ResNet folded on the way, a folded one as it is) and from the
    port's .pt; a head-only snapshot is refused
    (tests/test_finetune.py:524-557)."""
    from rau_vqa_tpu.models.backbones import resnet as JR
    plain = narrow_resnet(4, blocks=(2, 1, 1, 1))
    folded = jax.tree.map(np.asarray, JR.fold_batchnorm(plain))
    for name, tree in (("plain", plain), ("folded", folded)):
        path = jck.save_checkpoint(str(tmp_path / name), 1, 1.0,
                                   {"params": {"embed": {"x": np.zeros(3)}, "backbone": tree},
                                    "step": np.int32(1)})
        got = tck.load_backbone_group(path, "resnet101")
        want = TR.fold_batchnorm(params_from_jax(plain)) if name == "plain" \
            else params_from_jax(folded)
        assert_trees_close(got, map_tree(lambda a: a.numpy(), want), 1e-6, 1e-6)
        if name == "plain":
            raw = tck.load_backbone_group(path, "resnet101", fold=False)
            assert "bn1" in raw and torch.equal(raw["conv1"]["w"], torch.as_tensor(plain["conv1"]["w"]))
        with pytest.raises(ValueError, match="not a vgg16 tree"):
            tck.load_backbone_group(path, "vgg16")
    vit = params_from_jax(jax_vit(5))
    pt = tck.save_checkpoint(str(tmp_path / "pt"), 2, 1.0,
                             {"params": {"embed": {"x": torch.zeros(3)}, "backbone": vit},
                              "step": 2})
    assert trees_equal(tck.load_backbone_group(pt, "vit"), vit)
    head = jck.save_checkpoint(str(tmp_path / "head"), 3, 1.0,
                               {"params": {"embed": {"x": np.zeros(3)}}, "step": np.int32(3)})
    with pytest.raises(ValueError, match="backbone"):
        tck.load_backbone_group(head, "resnet101")


def test_cli_fixture_fine_tunes_and_evaluates(tmp_path):
    """``train --fixture --train-backbone``: the fixture's 64 px images, a
    random VGG16, one epoch and its sweep, a snapshot with the 4th group
    and the RMS interface in its sidecar; ``eval`` of it from the images
    adopts both (tests/test_finetune.py:477-521)."""
    wd = str(tmp_path / "run")
    assert tcli.main(["--device", "cpu", "train", "--preset", "ours_ms", "--fixture",
                      "--train-backbone", "--no-backbone-remat", "--nhop", "2", "--epochs",
                      "1", "--save-dir", wd]) == 0
    snaps = sorted(glob.glob(wd + "/snapshot/*.pt"))
    assert snaps
    bb = tck.load_backbone_group(snaps[-1], "vgg16")
    assert len(bb["convs"]) == 13
    with open(os.path.splitext(snaps[-1])[0] + ".json") as f:
        meta = json.load(f)
    assert meta["backbone_feat_norm"] is True and meta["train_backbone"] is True
    assert meta["backbone"] == "vgg16"
    ewd = str(tmp_path / "eval")
    assert tcli.main(["--device", "cpu", "eval", "--preset", "ours_ms", "--fixture",
                      "--checkpoint", snaps[-1], "--image-root",
                      os.path.join(wd, "fixture", "images"), "--image-size", "64",
                      "--save-dir", ewd]) == 0
    assert glob.glob(ewd + "/results/hop_*/*_results.json")


@pytest.mark.parametrize("flags,match", [
    (["--preset", "ours_ms", "--backbone-lr-scale", "0.5"], "needs --train-backbone"),
    (["--preset", "ours_ms", "--no-backbone-remat"], "needs --train-backbone"),
    (["--preset", "ours_ms", "--train-backbone"], "needs --image-root"),
    (["--preset", "ours_resnet_ft"], "fine-tunes the backbone"),
])
def test_cli_fine_tuning_flag_errors(tmp_path, flags, match):
    with pytest.raises(SystemExit, match=match):
        tcli.main(["--device", "cpu", "train", *flags, "--save-dir", str(tmp_path)])
