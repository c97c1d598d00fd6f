"""The port's VGG16 and ViT backbones against the JAX package's, on the CPU.

VGG16 at its full widths at 64 px (a 2x2 pool5 grid), B=2, float32, held to
``vgg16_pool5_apply`` at 3e-5 of the features' scale (the ResNet bar of
tests/test_torch_port_pipeline.py); a tiny ViT (image 28, patch 14, dim 64,
depth 2, 4 heads) held to ``vit_apply`` at rtol 1e-5.  The converters take
in-memory dicts with torchvision's and timm's key names (neither package is
imported) and give JAX's trees.  Weights come from JAX's initialisers and
cross with ``params_from_jax``."""

import jax
import numpy as np
import pytest
import torch

from rau_vqa_tpu.models.backbones import vgg as JV
from rau_vqa_tpu.models.backbones import vit as JVT
from rau_vqa_tpu_torch.convert import map_tree, params_from_jax, tree_leaves
from rau_vqa_tpu_torch.models.backbones import vgg as TV
from rau_vqa_tpu_torch.models.backbones import vit as TVT
from tests.test_torch_port_backbone import assert_scaled_close

TINY = dict(image_size=28, patch=14, dim=64, depth=2, heads=4)
JTINY, TTINY = JVT.ViTConfig(**TINY), TVT.ViTConfig(**TINY)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def by_path(tree):
    """{key path: leaf} of a tree of dicts and lists (tensors are leaves)."""
    return {jax.tree_util.keystr(k): v
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def assert_same_tree(got, want):
    g, w = by_path(got), by_path(want)
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]), err_msg=k)


def jax_vgg(seed, scale=1.0):
    """JAX's VGG16 init as numpy, its convolutions scaled by ``scale``."""
    return jax.tree.map(lambda a: np.asarray(a) * (scale if a.ndim == 4 else 1.0),
                        JV.vgg16_pool5_init(jax.random.PRNGKey(seed)))


def test_vgg16_pool5_apply_matches_jax():
    bb = jax_vgg(0)
    x = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32) * 60.0
    want = np.asarray(JV.vgg16_pool5_apply(bb, jax.numpy.asarray(x)))
    got = TV.vgg16_pool5_apply(params_from_jax(bb), torch.as_tensor(x))
    assert got.shape == want.shape == (2, 4, 512) and got.dtype == torch.float32
    assert_scaled_close(got.numpy(), want, 3e-5)


@pytest.mark.parametrize("size", [32, 96])
def test_vgg16_grid_follows_the_image(size):
    """Stride 32: 32 px -> 1 cell, 96 px -> 3x3; max-pools floor as JAX's
    VALID reduce_window does (a 3 px map pools to 1)."""
    bb = jax_vgg(2, 0.72)
    x = np.random.RandomState(size).randn(1, size, size, 3).astype(np.float32)
    want = np.asarray(JV.vgg16_pool5_apply(bb, jax.numpy.asarray(x)))
    got = TV.vgg16_pool5_apply(params_from_jax(bb), torch.as_tensor(x)).numpy()
    assert got.shape == want.shape == (1, (size // 32) ** 2, 512)
    assert_scaled_close(got, want, 3e-5)


def test_vgg16_init_has_the_jax_tree():
    got = TV.vgg16_pool5_init(torch.Generator().manual_seed(0), torch.bfloat16, "cpu")
    want = JV.vgg16_pool5_init(jax.random.PRNGKey(0))
    assert len(got["convs"]) == len(want["convs"]) == 13
    for g, w in zip(got["convs"], want["convs"]):
        assert tuple(g["w"].shape) == w["w"].shape and tuple(g["b"].shape) == w["b"].shape
        assert g["w"].dtype == torch.bfloat16 and not g["b"].float().any()
    # He-normal: std sqrt(2 / fan_in) at the first and the last convolution
    for g, fan_in in ((got["convs"][0], 27), (got["convs"][-1], 9 * 512)):
        assert abs(g["w"].float().std().item() / (2 / fan_in) ** 0.5 - 1) < 0.1


def _torchvision_vgg_state(rs):
    """torchvision's vgg16 ``features`` keys at narrow widths (the converter
    reads keys and layouts, not widths)."""
    state, c_in = {}, 3
    for i, c in zip(TV.TORCH_CONV_INDICES, [4, 4, 6, 6, 8, 8, 8, 5, 5, 5, 7, 7, 7]):
        state[f"features.{i}.weight"] = rs.randn(c, c_in, 3, 3).astype(np.float32)
        state[f"features.{i}.bias"] = rs.randn(c).astype(np.float32)
        c_in = c
    state["classifier.0.weight"] = rs.randn(3, 2).astype(np.float32)   # ignored
    return state


@pytest.mark.parametrize("as_tensors", [False, True])
def test_vgg16_from_torch_state_matches_jax(as_tensors):
    state = _torchvision_vgg_state(np.random.RandomState(3))
    want = JV.vgg16_from_torch_state(state)
    if as_tensors:
        state = {k: torch.as_tensor(v) for k, v in state.items()}
    got = TV.vgg16_from_torch_state(state)
    assert len(tree_leaves(got)) == 26
    assert_same_tree(got, want)


def _timm_state(rs, cfg, cls_token=True):
    D, P, M = cfg.dim, cfg.patch, int(cfg.dim * cfg.mlp_ratio)

    def t(*shape):
        return (rs.randn(*shape) * 0.05).astype(np.float32)

    state = {"pos_embed": t(1, cfg.seq + int(cls_token), D),
             "patch_embed.proj.weight": t(D, 3, P, P), "patch_embed.proj.bias": t(D),
             "norm.weight": 1 + t(D), "norm.bias": t(D), "cls_token": t(1, 1, D)}
    for i in range(cfg.depth):
        p = f"blocks.{i}"
        state.update({f"{p}.norm1.weight": 1 + t(D), f"{p}.norm1.bias": t(D),
                      f"{p}.norm2.weight": 1 + t(D), f"{p}.norm2.bias": t(D),
                      f"{p}.attn.qkv.weight": t(3 * D, D), f"{p}.attn.qkv.bias": t(3 * D),
                      f"{p}.attn.proj.weight": t(D, D), f"{p}.attn.proj.bias": t(D),
                      f"{p}.mlp.fc1.weight": t(M, D), f"{p}.mlp.fc1.bias": t(M),
                      f"{p}.mlp.fc2.weight": t(D, M), f"{p}.mlp.fc2.bias": t(D)})
    return state


@pytest.mark.parametrize("cls_token", [True, False])
def test_vit_from_timm_state_matches_jax(cls_token):
    state = _timm_state(np.random.RandomState(4), JTINY, cls_token)
    want = JVT.vit_from_timm_state(state, JTINY)
    got = TVT.vit_from_timm_state({k: torch.as_tensor(v) for k, v in state.items()}, TTINY)
    assert tuple(got["pos_embed"].shape) == (TTINY.seq, TTINY.dim)
    assert_same_tree(got, want)


@pytest.mark.parametrize("source", ["init", "timm"])
def test_vit_apply_matches_jax(source):
    if source == "init":
        p = np_tree(JVT.vit_init(jax.random.PRNGKey(5), JTINY))
    else:
        p = np_tree(JVT.vit_from_timm_state(_timm_state(np.random.RandomState(6), JTINY),
                                            JTINY))
    x = np.random.RandomState(7).randn(3, 28, 28, 3).astype(np.float32)
    want = np.asarray(JVT.vit_apply(p, JTINY, jax.numpy.asarray(x)))
    got = TVT.vit_apply(params_from_jax(p), TTINY, torch.as_tensor(x))
    assert got.shape == want.shape == (3, TTINY.seq, TTINY.dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_vit_init_has_the_jax_tree_and_scales():
    got = TVT.vit_init(torch.Generator().manual_seed(0), TTINY, device="cpu")
    want = JVT.vit_init(jax.random.PRNGKey(0), JTINY)
    gp, wp = by_path(got), by_path(want)
    assert gp.keys() == wp.keys()
    for k in wp:
        assert tuple(gp[k].shape) == wp[k].shape, k
    assert abs(gp["['pos_embed']"].std().item() / 0.02 - 1) < 0.2
    D = TTINY.dim
    assert abs(gp["['blocks'][0]['qkv']['w']"].std().item()
               / (2 / (D + 3 * D)) ** 0.5 - 1) < 0.1
    assert (gp["['ln_final']['scale']"] == 1).all()


def test_vit_init_draws_each_leaf_from_the_jax_distribution():
    """The fine-tuning A/B's tiny ViT (``ft_accuracy_ab --backbone vit``):
    over 40 seeds of each package, every leaf's pooled std within 5% of the
    JAX package's and its mean within 5% of that std; the constant leaves
    equal.  The two packages' draws differ seed for seed, so a run's
    frozen backbone is another sample of the same distribution."""
    cfg = dict(image_size=64, patch=16, dim=16, depth=2, heads=4)
    want = [by_path(JVT.vit_init(jax.random.PRNGKey(s), JVT.ViTConfig(**cfg)))
            for s in range(40)]
    got = [by_path(TVT.vit_init(torch.Generator().manual_seed(s), TVT.ViTConfig(**cfg),
                                device="cpu")) for s in range(40)]
    for k in want[0]:
        w = np.stack([np.asarray(t[k]) for t in want])
        g = np.stack([t[k].numpy() for t in got])
        assert g.shape == w.shape, k
        if w.std() == 0:
            np.testing.assert_array_equal(g, w, err_msg=k)
            continue
        assert abs(g.std() / w.std() - 1) < 0.05, (k, g.std(), w.std())
        assert abs(g.mean() - w.mean()) < 0.05 * w.std(), (k, g.mean(), w.mean())


def test_vit_config_grid():
    assert (TVT.VIT_L14.grid, TVT.VIT_L14.seq, TVT.VIT_L14.dim) == (16, 256, 1024)
    assert (TVT.VIT_B16.grid, TVT.VIT_B16.seq) == (14, 196)
    assert TVT.VIT_L14 == TVT.ViTConfig(**{f: getattr(JVT.VIT_L14, f) for f in
                                           ("image_size", "patch", "dim", "depth",
                                            "heads", "mlp_ratio", "ln_eps")})
    with pytest.raises(ValueError, match="multiple"):
        TVT.ViTConfig(image_size=30, patch=14).grid


def test_bf16_trees_run_in_bf16():
    """The forward follows the tree's type, as the JAX package's does."""
    bb = params_from_jax(jax_vgg(8, 0.72))
    bb16 = {"convs": [{k: v.to(torch.bfloat16) for k, v in c.items()} for c in bb["convs"]]}
    x = torch.randn(1, 32, 32, 3)
    f16 = TV.vgg16_pool5_apply(bb16, x)
    f32 = TV.vgg16_pool5_apply(bb, x)
    assert f16.dtype == torch.bfloat16
    assert_scaled_close(f16.float().numpy(), f32.numpy(), 0.05)
    vt = TVT.vit_init(torch.Generator().manual_seed(1), TTINY, torch.bfloat16, "cpu")
    assert TVT.vit_apply(vt, TTINY, torch.randn(2, 28, 28, 3)).dtype == torch.bfloat16


@pytest.mark.parametrize("backbone", ["vgg16", "vit"])
def test_remat_names_the_fine_tuning_item(backbone):
    """remat=True, once refused in the fine-tuning item's name, gives the
    features of the forward without it, under autograd too."""
    if backbone == "vgg16":
        bb, x = params_from_jax(jax_vgg(0, 0.72)), torch.randn(2, 32, 32, 3) * 50

        def apply(p, remat):
            return TV.vgg16_pool5_apply(p, x, remat=remat)
    else:
        bb, x = TVT.vit_init(torch.Generator(), TTINY, device="cpu"), torch.randn(2, 28, 28, 3)

        def apply(p, remat):
            return TVT.vit_apply(p, TTINY, x, remat=remat)
    want = apply(bb, False)
    torch.testing.assert_close(apply(bb, True), want, rtol=1e-6, atol=1e-6)
    got = apply(map_tree(lambda a: a.detach().requires_grad_(), bb), True)
    assert got.requires_grad
    torch.testing.assert_close(got.detach(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("entry", ["vgg16_pool5_init", "vit_init"])
def test_initialisers_default_to_cuda_and_raise_without_a_card(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = torch.Generator().manual_seed(0)
    call = {"vgg16_pool5_init": lambda **kw: TV.vgg16_pool5_init(gen, **kw),
            "vit_init": lambda **kw: TVT.vit_init(gen, TTINY, **kw)}[entry]
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call(**kw)


def test_vgg16_prepares_each_tree_once(monkeypatch):
    """The OIHW weights are made once per parameter set, two trees in turn."""
    seen, fn = [], TV._prepared.fn
    monkeypatch.setattr(TV._prepared, "fn", lambda tree: seen.append(tree) or fn(tree))
    trees = [params_from_jax(jax_vgg(9)), params_from_jax(jax_vgg(9))]
    x = torch.zeros(1, 32, 32, 3)
    for _ in range(2):
        for tree in trees:
            TV.vgg16_pool5_apply(tree, x)
    assert len(seen) == 2 and seen[0] is trees[0] and seen[1] is trees[1]
