"""The port's from-pixels path against the JAX package, on the CPU.

A narrow ResNet (tests/test_torch_port_backbone.py: stem 16, widths
8/16/32/64, 64 px -> a 2x2 grid of 256 features) under a small RAU head
whose ``cnn_dim`` and grid match it.  ``extract_features`` and
``pixels_forward`` (both plain float32) are held to the JAX package's at
3e-5 of the features' scale and at 1e-4.  ``answer_pixels(device="cpu")``
runs the serving code with the kernels' plain versions: the stage kernel's
(float32 here) and the head's with bf16 dots, so it is held to JAX's
float32 ``answer_pixels`` at the serving bars: answer agreement >= 0.95,
attention within rtol 0.05 / atol 5e-4.  VGG16 (full widths, 64 px) and a
tiny ViT (tests/test_torch_port_vgg_vit.py) go through the same three entry
points at the same bars, each under a head of its grid and width.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from rau_vqa_tpu.config import ModelConfig as JaxModelConfig
from rau_vqa_tpu.models import pipeline as JP
from rau_vqa_tpu.models import rau as jrau
from rau_vqa_tpu.models.backbones import resnet as JR
from rau_vqa_tpu.models.backbones import vgg as JV
from rau_vqa_tpu.models.backbones import vit as JVT
from rau_vqa_tpu_torch import config as tconfig
from rau_vqa_tpu_torch.convert import params_from_jax, params_to_jax
from rau_vqa_tpu_torch.models import pipeline as TP
from rau_vqa_tpu_torch.models import rau as trau
from rau_vqa_tpu_torch.models.backbones import resnet as TR
from rau_vqa_tpu_torch.models.backbones import vgg as TV
from rau_vqa_tpu_torch.models.backbones import vit as TVT
from rau_vqa_tpu_torch.ops import fused_resnet, lstm_encoder, rau_hops
from tests.test_torch_port_backbone import assert_scaled_close, narrow_resnet
from tests.test_torch_port_vgg_vit import JTINY, TTINY

JCFG = JaxModelConfig(
    vocab_size=50, answer_size=16, seq_len=9, embed_dim=8, rnn_size=16,
    rnn_layers=2, cnn_dim=256, cnn_w=2, cnn_h=2, multfeat_dim=16,
    attfeat_dim=8, att_rnn_size=16, n_hops=3)
CFG = tconfig.ModelConfig(**{f.name: getattr(JCFG, f.name)
                             for f in dataclasses.fields(tconfig.ModelConfig)})


def setup(B, seed=0, folded=True):
    """(head params, backbone tree) as numpy trees, and the batch."""
    p = jax.tree.map(np.asarray, jrau.init_params(jax.random.PRNGKey(seed), JCFG))
    bb = narrow_resnet(seed + 100)
    if folded:
        bb = jax.tree.map(np.asarray, JR.fold_batchnorm(bb))
    rs = np.random.RandomState(seed)
    images = rs.randint(0, 256, (B, 64, 64, 3)).astype(np.uint8)
    lengths = rs.randint(1, JCFG.seq_len + 1, B).astype(np.int32)
    tokens = np.zeros((B, JCFG.seq_len), np.int32)
    for k in range(B):
        tokens[k, :lengths[k]] = rs.randint(1, JCFG.vocab_size, lengths[k])
    return p, bb, images, tokens, lengths


@pytest.mark.parametrize("feat_norm", [False, True])
def test_extract_features_matches_jax(feat_norm):
    _, bb, images, _, _ = setup(3, seed=1, folded=False)
    want = JP.extract_features("resnet101", bb, jnp.asarray(images), feat_norm=feat_norm)
    got = TP.extract_features("resnet101", params_from_jax(bb), torch.as_tensor(images),
                              feat_norm=feat_norm)
    assert got.shape == (3, JCFG.cnn_spat, JCFG.cnn_dim)
    assert_scaled_close(got.numpy(), np.asarray(want), 3e-5)
    if feat_norm:
        np.testing.assert_allclose(got.square().mean(-1).numpy(), 1.0, rtol=1e-4)


def test_extract_features_other_backbones_are_still_to_port():
    """VGG16 and the ViT are ported (their parity tests follow); what stays
    to port of them, their fine-tuning, names its item; an unknown backbone
    is refused."""
    _, bb, images, _, _ = setup(1)
    with pytest.raises(NotImplementedError, match="queue 1, item 5, fine-tuning"):
        TV.vgg16_pool5_apply(params_from_jax(jax_vgg(0)), torch.zeros(1, 32, 32, 3),
                             remat=True)
    with pytest.raises(NotImplementedError, match="queue 1, item 5, fine-tuning"):
        TVT.vit_apply(params_from_jax(jax_vit(0)), TTINY, torch.zeros(1, 28, 28, 3),
                      remat=True)
    with pytest.raises(ValueError, match="unknown backbone"):
        TP.extract_features("alexnet", params_from_jax(bb), torch.as_tensor(images))


# ---------------------------------------------------------------------------
# VGG16 (full widths, 64 px -> 2x2x512, He init x0.72 as the JAX CLI's
# fixture) and a tiny ViT (28 px, patch 14 -> 2x2x64), each under a head of
# its grid and width
# ---------------------------------------------------------------------------

OTHER = {"vgg16": (512, 64), "vit": (TTINY.dim, TTINY.image_size)}


def jax_vgg(seed):
    return jax.tree.map(lambda a: np.asarray(a) * (0.72 if a.ndim == 4 else 1.0),
                        JV.vgg16_pool5_init(jax.random.PRNGKey(seed)))


def jax_vit(seed):
    return jax.tree.map(np.asarray, JVT.vit_init(jax.random.PRNGKey(seed), JTINY))


def other_setup(backbone, B, seed=0):
    """(JAX head config, port head config, head params, backbone tree) and
    the batch, for ``backbone`` in ``OTHER``."""
    dim, size = OTHER[backbone]
    jcfg = dataclasses.replace(JCFG, cnn_dim=dim)
    cfg = dataclasses.replace(CFG, cnn_dim=dim)
    p = jax.tree.map(np.asarray, jrau.init_params(jax.random.PRNGKey(seed), jcfg))
    bb = (jax_vgg if backbone == "vgg16" else jax_vit)(seed + 100)
    _, _, _, tokens, lengths = setup(B, seed)
    images = np.random.RandomState(seed + 7).randint(0, 256, (B, size, size, 3)).astype(np.uint8)
    return jcfg, cfg, p, bb, images, tokens, lengths


@pytest.fixture
def tiny_jax_vit(monkeypatch):
    """The JAX package's pixels_forward and answer_pixels take the default
    ViT config: here the tiny one."""
    monkeypatch.setattr(JVT, "VIT_L14", JTINY)


@pytest.mark.parametrize("backbone", ["vgg16", "vit"])
@pytest.mark.parametrize("feat_norm", [False, True])
def test_extract_features_other_backbones_match_jax(backbone, feat_norm):
    _, _, _, bb, images, _, _ = other_setup(backbone, 3, seed=1)
    kw = {"vit_cfg": JTINY} if backbone == "vit" else {}
    want = JP.extract_features(backbone, bb, jnp.asarray(images), feat_norm=feat_norm, **kw)
    got = TP.extract_features(backbone, params_from_jax(bb), torch.as_tensor(images),
                              TTINY if backbone == "vit" else None, feat_norm=feat_norm)
    assert got.shape == (3, 4, OTHER[backbone][0])
    assert_scaled_close(got.numpy(), np.asarray(want), 3e-5)
    if feat_norm:
        np.testing.assert_allclose(got.square().mean(-1).numpy(), 1.0, rtol=1e-4)


@pytest.mark.parametrize("backbone", ["vgg16", "vit"])
def test_pixels_forward_other_backbones_match_jax(backbone, tiny_jax_vit):
    jcfg, cfg, p, bb, images, tokens, lengths = other_setup(backbone, 4, seed=2)
    want = JP.pixels_forward(p, bb, jcfg, backbone, jnp.asarray(images),
                             jnp.asarray(tokens), jnp.asarray(lengths))
    got = TP.pixels_forward(params_from_jax(p), params_from_jax(bb), cfg, backbone,
                            torch.as_tensor(images), torch.as_tensor(tokens),
                            torch.as_tensor(lengths), vit_cfg=TTINY)
    for name in ("scores", "do_pred", "attprob", "final_c", "final_h"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("backbone", ["vgg16", "vit"])
def test_answer_pixels_other_backbones_cpu_match_jax(backbone, tiny_jax_vit):
    """The serving entry point on the CPU: the head's kernels' plain
    versions (bf16 dots), no kernel launched, at the serving bars."""
    B = 8
    jcfg, cfg, p, bb, images, tokens, lengths = other_setup(backbone, B, seed=3)
    want_ids, want_att = JP.answer_pixels(p, bb, jcfg, backbone, jnp.asarray(images),
                                          jnp.asarray(tokens), jnp.asarray(lengths))
    before = (fused_resnet.KERNEL.launches, lstm_encoder.KERNEL.launches,
              rau_hops.KERNEL.launches)
    ids, att = TP.answer_pixels(params_from_jax(p), params_from_jax(bb), cfg, backbone,
                                images, tokens, lengths, vit_cfg=TTINY, device="cpu")
    assert (fused_resnet.KERNEL.launches, lstm_encoder.KERNEL.launches,
            rau_hops.KERNEL.launches) == before
    H = jcfg.n_hops
    assert ids.shape == (H + 2, B) and att.shape == (H + 2, B, jcfg.cnn_spat)
    assert (ids.numpy() == np.asarray(want_ids)).mean() >= 0.95
    np.testing.assert_allclose(att.numpy(), np.asarray(want_att), rtol=0.05, atol=5e-4)


@pytest.mark.parametrize("folded", [False, True])
def test_pixels_forward_matches_jax(folded):
    p, bb, images, tokens, lengths = setup(4, seed=2, folded=folded)
    want = JP.pixels_forward(p, bb, JCFG, "resnet101", jnp.asarray(images),
                             jnp.asarray(tokens), jnp.asarray(lengths))
    got = TP.pixels_forward(params_from_jax(p), params_from_jax(bb), CFG, "resnet101",
                            torch.as_tensor(images), torch.as_tensor(tokens),
                            torch.as_tensor(lengths))
    for name in ("scores", "do_pred", "attprob", "final_c", "final_h"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("B", [5, 8])
def test_answer_pixels_cpu_matches_jax(B):
    p, bb, images, tokens, lengths = setup(B, seed=3)
    want_ids, want_att = JP.answer_pixels(p, bb, JCFG, "resnet101", jnp.asarray(images),
                                          jnp.asarray(tokens), jnp.asarray(lengths))
    before = (fused_resnet.KERNEL.launches, lstm_encoder.KERNEL.launches,
              rau_hops.KERNEL.launches)
    ids, att = TP.answer_pixels(params_from_jax(p), params_from_jax(bb), CFG,
                                "resnet101", images, tokens, lengths, device="cpu")
    assert (fused_resnet.KERNEL.launches, lstm_encoder.KERNEL.launches,
            rau_hops.KERNEL.launches) == before
    H = JCFG.n_hops
    assert ids.shape == (H + 2, B) and att.shape == (H + 2, B, JCFG.cnn_spat)
    assert (ids.numpy() == np.asarray(want_ids)).mean() >= 0.95
    np.testing.assert_allclose(att.numpy(), np.asarray(want_att), rtol=0.05, atol=5e-4)


def _count_calls(monkeypatch, memo):
    """Record the trees ``memo`` computes its value for."""
    seen, fn = [], memo.fn
    monkeypatch.setattr(memo, "fn", lambda tree: seen.append(tree) or fn(tree))
    return seen


def test_answer_pixels_casts_head_weights_once_per_parameter_set(monkeypatch):
    p, bb, images, tokens, lengths = setup(2, seed=4)
    tp, tbb = params_from_jax(p), params_from_jax(bb)
    casts = _count_calls(monkeypatch, TP._head_weights)
    for _ in range(2):
        TP.answer_pixels(tp, tbb, CFG, "resnet101", images, tokens, lengths, device="cpu")
    assert len(casts) == 1 and casts[0] is tp
    tp2 = params_from_jax(p)
    TP.answer_pixels(tp2, tbb, CFG, "resnet101", images, tokens, lengths, device="cpu")
    assert len(casts) == 2 and casts[1] is tp2


def test_backbone_prepares_each_tree_once_while_two_alternate(monkeypatch):
    """A bf16 serving tree and its float32 copy in turn: each is prepared
    once; the fused path prepares only the blocks F.conv2d runs."""
    _, bb, images, _, _ = setup(1, seed=5)
    trees = [params_from_jax(bb), params_from_jax(bb)]
    preps = _count_calls(monkeypatch, TR._prepared)
    x = torch.as_tensor(images).float() / 255.0
    for _ in range(2):
        for tree in trees:
            TR.resnet101_apply(tree, x, fused_stages=(0, 1, 2, 3))
    assert len(preps) == 2 and preps[0] is trees[0] and preps[1] is trees[1]
    prep = TR._prepared(trees[0])
    assert sorted(prep["blocks"]) == [(s, 0) for s in range(4)]
    assert sorted(prep["stacks"]) == [0, 1, 2, 3]


def test_params_from_jax_takes_bfloat16_trees():
    """JAX hands bf16 leaves over as ml_dtypes.bfloat16 arrays: they become
    torch.bfloat16 tensors with the same bits, and go back unchanged."""
    tree = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                        JR.fold_batchnorm(narrow_resnet(5, blocks=(2, 1, 1, 1))))
    got = params_from_jax(tree)
    for a, t in zip(jax.tree.leaves(tree), jax.tree.leaves(got, is_leaf=torch.is_tensor)):
        assert a.dtype == ml_dtypes.bfloat16 and t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.view(torch.int16).numpy(), a.view(np.int16))
    back = params_to_jax(got)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert b.dtype == ml_dtypes.bfloat16
        np.testing.assert_array_equal(b.view(np.int16), a.view(np.int16))
    # the bf16 tree runs: float32 images are cast to the weights' type
    x = torch.as_tensor(np.random.RandomState(6).rand(1, 32, 32, 3).astype(np.float32))
    assert TR.resnet101_apply(got, x).dtype == torch.bfloat16


@pytest.mark.parametrize("entry", ["answer_pixels", "resnet101_init", "init_params"])
def test_entry_points_default_to_cuda_and_raise_without_a_card(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = torch.Generator().manual_seed(0)
    call = {
        "answer_pixels": lambda **kw: TP.answer_pixels(
            None, None, CFG, "resnet101", np.zeros((1, 64, 64, 3), np.uint8),
            np.ones((1, 9), np.int32), np.ones(1, np.int32), **kw),
        "resnet101_init": lambda **kw: TR.resnet101_init(gen, **kw),
        "init_params": lambda **kw: trau.init_params(CFG, gen, **kw),
    }[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(device="cuda")
