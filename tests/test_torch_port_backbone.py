"""The port's ResNet-101 backbone and image normalization against the JAX
package, on the CPU.

Inputs are numpy arrays from fixed seeds, handed to both packages; the JAX
side runs at ``matmul_precision=highest`` (tests/conftest.py) and the torch
side in float32.  The whole network runs on a narrow tree (stem 16, widths
8/16/32/64, two blocks a stage, 64 px) with randomized BN statistics; the
port's fused stages run the stage kernel's plain version, held against JAX's
XLA folded path.  Bar for the network: 3e-5 of the features' largest
magnitude (tests/test_fused_resnet.py:100-102 holds the JAX kernel to the
same), since activations grow across the residual blocks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rau_vqa_tpu.models.backbones import resnet as JR
from rau_vqa_tpu.ops import transforms as JT
from rau_vqa_tpu_torch.convert import params_from_jax, params_to_jax
from rau_vqa_tpu_torch.models.backbones import resnet as TR
from rau_vqa_tpu_torch.ops import fused_resnet
from rau_vqa_tpu_torch.ops import transforms as TT


def narrow_resnet(seed, widths=(8, 16, 32, 64), blocks=(2, 2, 2, 2), stem=16):
    """A numpy tree in the JAX package's layout (HWIO convs, inference BN
    with randomized statistics) at narrow widths."""
    rs = np.random.RandomState(seed)

    def conv(kh, kw, ci, co):
        std = np.sqrt(2.0 / (kh * kw * ci))
        return {"w": (rs.randn(kh, kw, ci, co) * std).astype(np.float32)}

    def bn(c):
        return {"scale": rs.normal(1, 0.2, c).astype(np.float32),
                "offset": rs.normal(0, 0.2, c).astype(np.float32),
                "mean": rs.normal(0, 0.5, c).astype(np.float32),
                "var": rs.uniform(0.5, 1.5, c).astype(np.float32)}

    params = {"conv1": conv(7, 7, 3, stem), "bn1": bn(stem), "stages": []}
    c_in = stem
    for n_blocks, width in zip(blocks, widths):
        stage = []
        for b in range(n_blocks):
            blk = {"conv1": conv(1, 1, c_in, width), "bn1": bn(width),
                   "conv2": conv(3, 3, width, width), "bn2": bn(width),
                   "conv3": conv(1, 1, width, 4 * width), "bn3": bn(4 * width)}
            if b == 0:
                blk["down"] = conv(1, 1, c_in, 4 * width)
                blk["down_bn"] = bn(4 * width)
            stage.append(blk)
            c_in = 4 * width
        params["stages"].append(stage)
    return params


def T(x):
    return torch.as_tensor(np.array(x))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def assert_scaled_close(got, want, bar):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert np.abs(got - want).max() / scale <= bar


def test_color_normalize_and_vgg_preprocess_match_jax():
    img = np.random.RandomState(0).rand(2, 5, 7, 3).astype(np.float32)
    np.testing.assert_allclose(TT.color_normalize(T(img)).numpy(),
                               np.asarray(JT.color_normalize(jnp.asarray(img))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(TT.vgg_preprocess(T(img)).numpy(),
                               np.asarray(JT.vgg_preprocess(jnp.asarray(img))),
                               rtol=1e-6, atol=1e-4)
    assert TT.IMAGENET_MEAN == JT.IMAGENET_MEAN
    assert TT.IMAGENET_STD == JT.IMAGENET_STD
    assert TT.VGG_MEAN_BGR == JT.VGG_MEAN_BGR


@pytest.mark.parametrize("k,stride,size", [
    (1, 1, 8), (1, 2, 9), (3, 1, 9), (3, 2, 8), (3, 2, 9), (7, 2, 16), (7, 2, 15)])
def test_conv_matches_jax(k, stride, size):
    """Symmetric (k-1)//2 padding with the stride on the conv, even and odd
    inputs (where XLA's "SAME" would pick another sampling grid)."""
    rs = np.random.RandomState(k * 10 + stride)
    x = rs.randn(2, size, size + 1, 4).astype(np.float32)
    w = rs.randn(k, k, 4, 6).astype(np.float32)
    want = np.asarray(JR._conv(jnp.asarray(x), jnp.asarray(w), stride))
    got = TR._conv(T(x), T(w), stride).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("size", [8, 9, 16])
def test_maxpool_matches_jax(size):
    x = np.random.RandomState(size).randn(2, size, size + 3, 5).astype(np.float32)
    xj = jnp.pad(jnp.asarray(x), ((0, 0), (1, 1), (1, 1), (0, 0)),
                 constant_values=-jnp.inf)
    want = np.asarray(jax.lax.reduce_window(xj, -jnp.inf, jax.lax.max,
                                            (1, 3, 3, 1), (1, 2, 2, 1), "VALID"))
    got = TR._maxpool(T(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fold_batchnorm_matches_jax(dtype):
    """The fold runs in float32 and casts back to the conv's type, in both
    packages: the same leaves to one unit in the last place of the type,
    relative to each leaf and to its largest entry (numpy and torch round a
    few float32 quotients differently, and ``offset - mean * g`` cancels;
    bf16 trees cross as ml_dtypes.bfloat16 arrays)."""
    tree = narrow_resnet(3, blocks=(2, 1, 1, 1))
    tree = np_tree(jax.tree.map(lambda a: jnp.asarray(a, dtype), tree))
    want = np_tree(JR.fold_batchnorm(tree))
    got = params_to_jax(TR.fold_batchnorm(params_from_jax(tree)))
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (_, a), (_, b) in zip(flat_w, flat_g):
        assert a.dtype == b.dtype and a.shape == b.shape
        ulp = 2.0 ** -7 if dtype == "bfloat16" else 2.0 ** -22
        a, b = a.astype(np.float32), b.astype(np.float32)
        np.testing.assert_allclose(b, a, rtol=ulp, atol=ulp * np.abs(a).max())


def _torchvision_state(rs, widths, blocks, stem):
    """Random torchvision-named ResNet state dict (OIHW convs, BN stats)."""
    def bn(prefix, c):
        return {f"{prefix}.weight": rs.normal(1, .2, c).astype(np.float32),
                f"{prefix}.bias": rs.normal(0, .2, c).astype(np.float32),
                f"{prefix}.running_mean": rs.normal(0, .5, c).astype(np.float32),
                f"{prefix}.running_var": rs.uniform(.5, 1.5, c).astype(np.float32)}

    def conv(co, ci, k):
        return rs.randn(co, ci, k, k).astype(np.float32) * 0.2

    state = {"conv1.weight": conv(stem, 3, 7), **bn("bn1", stem)}
    c_in = stem
    for s, (n, w) in enumerate(zip(widths, blocks)):
        for b in range(w):
            p = f"layer{s + 1}.{b}"
            state[f"{p}.conv1.weight"] = conv(n, c_in, 1)
            state[f"{p}.conv2.weight"] = conv(n, n, 3)
            state[f"{p}.conv3.weight"] = conv(4 * n, n, 1)
            for i, c in ((1, n), (2, n), (3, 4 * n)):
                state.update(bn(f"{p}.bn{i}", c))
            if b == 0:
                state[f"{p}.downsample.0.weight"] = conv(4 * n, c_in, 1)
                state.update(bn(f"{p}.downsample.1", 4 * n))
            c_in = 4 * n
    return state


def test_resnet_from_torch_state_matches_jax():
    rs = np.random.RandomState(7)
    state = _torchvision_state(rs, widths=(8, 16), blocks=(2, 1), stem=16)
    want = np_tree(JR.resnet_from_torch_state(state, blocks=(2, 1)))
    got = params_to_jax(TR.resnet_from_torch_state(
        {k: torch.as_tensor(v) for k, v in state.items()}, blocks=(2, 1)))
    assert jax.tree.structure(want) == jax.tree.structure(got)
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        np.testing.assert_array_equal(b, a)
    # and the converted block computes what the JAX block computes
    x = rs.randn(2, 10, 10, 16).astype(np.float32)
    blk_j = JR.resnet_from_torch_state(state, blocks=(2, 1))["stages"][0][0]
    blk_t = params_from_jax(got)["stages"][0][0]
    np.testing.assert_allclose(TR._bottleneck(T(x), blk_t, 2).numpy(),
                               np.asarray(JR._bottleneck(jnp.asarray(x), blk_j, 2)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stride", [1, 2])
def test_folded_block_and_conv_b_match_jax(stride):
    folded = np_tree(JR.fold_batchnorm(narrow_resnet(9, blocks=(1, 1, 1, 1))))
    blk = folded["stages"][1][0]                       # with a downsample
    x = np.random.RandomState(stride).randn(2, 9, 8, 32).astype(np.float32)
    want = JR._bottleneck_folded(jnp.asarray(x), blk, stride)
    got = TR._bottleneck_folded(T(x), params_from_jax(blk), stride)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    conv = blk["conv1"] if stride == 1 else blk["down"]
    want = JR._conv_b(jnp.asarray(x), conv, stride)
    got = TR._conv_b(T(x), params_from_jax(conv), stride)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["unfolded", "folded", "fused"])
def test_resnet101_apply_matches_jax(mode):
    """Narrow tree, 64 px -> [B, 2*2, 256].  "fused" runs every stage's
    identity blocks through the port's stage wrapper (its plain version on
    the CPU) against JAX's XLA folded path."""
    tree = narrow_resnet(11)
    x = np.random.RandomState(12).randn(2, 64, 64, 3).astype(np.float32)
    if mode != "unfolded":
        tree = np_tree(JR.fold_batchnorm(tree))
    want = np.asarray(JR.resnet101_apply(tree, jnp.asarray(x)))
    stages = (0, 1, 2, 3) if mode == "fused" else ()
    launches = fused_resnet.KERNEL.launches
    got = TR.resnet101_apply(params_from_jax(tree), T(x), fused_stages=stages).numpy()
    assert fused_resnet.KERNEL.launches == launches
    assert got.shape == want.shape == (2, 4, 256)
    assert_scaled_close(got, want, 3e-5)


def test_resnet101_apply_raises_as_the_jax_package_does():
    tree = params_from_jax(narrow_resnet(1, blocks=(2, 1, 1, 1)))
    folded = TR.fold_batchnorm(tree)
    x = torch.zeros(3, 32, 32, 3)
    with pytest.raises(ValueError, match="exclusive"):
        TR.resnet101_apply(folded, x, fused_stages=(0,), remat=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TR.resnet101_apply(folded, x, remat=True)
    with pytest.raises(ValueError, match="fold_batchnorm"):
        TR.resnet101_apply(tree, x, fused_stages=(0,))
    with pytest.raises(ValueError, match="does not divide"):
        TR.resnet101_apply(folded, x, fused_stages=(0,), fused_block_b=2)
    s2d = dict(folded, conv1={"w": torch.zeros(4, 4, 12, 16), "b": torch.zeros(16)})
    with pytest.raises(NotImplementedError, match="space-to-depth"):
        TR.resnet101_apply(s2d, x)
    for fn in (TR.space_to_depth_stem, TR.quantize_resnet,
               lambda p: TR.resnet101_apply_int8(p, x)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fn(folded)


def test_resnet101_init_has_the_jax_tree():
    want = jax.eval_shape(lambda: JR.resnet101_init(jax.random.PRNGKey(0)))
    got = TR.resnet101_init(torch.Generator().manual_seed(0), torch.bfloat16,
                            device="cpu")
    assert jax.tree.structure(want) == jax.tree.structure(
        jax.tree.map(lambda t: 0, got, is_leaf=torch.is_tensor))
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got, is_leaf=torch.is_tensor)):
        assert tuple(b.shape) == a.shape and b.dtype == torch.bfloat16
    assert [len(s) for s in got["stages"]] == list(TR.RESNET101_BLOCKS)
    assert (TR.RESNET101_BLOCKS, TR.STAGE_WIDTH, TR.BN_EPS) == \
        (JR.RESNET101_BLOCKS, JR.STAGE_WIDTH, JR.BN_EPS)
    # He-normal: std sqrt(2 / fan_in)
    w = got["stages"][2][5]["conv2"]["w"].float()
    assert abs(w.std().item() / (2.0 / (9 * 256)) ** 0.5 - 1) < 0.02

