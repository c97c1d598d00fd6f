"""The port's ResNet-101 variants against the JAX package's, on the CPU: the
space-to-depth stem and the int8 mode.

Trees are the narrow numpy trees of tests/test_torch_port_backbone.py
(randomized BN statistics), folded by the JAX package and carried over leaf
by leaf.  Bars:
- ``space_to_depth_stem`` and ``quantize_resnet`` are rearrangements and
  roundings of the same float32 numbers: bit-equal;
- the stem alone at JAX's own bar for it (rtol 1e-4, atol 1e-5,
  tests/test_transforms_backbones.py:296-297);
- an s2d tree through ``resnet101_apply`` at the ResNet parity bar (3e-5 of
  the features' largest magnitude);
- the int8 convs' int32 accumulators: equal; the int8 net within
  norm-relative 1e-3 of JAX's int8 net (an activation on a rounding
  boundary may take the other code in either package) and at JAX's bars
  against float32 (corr > 0.995, rel < 0.1, tests/
  test_transforms_backbones.py:276-278).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rau_vqa_tpu.models.backbones import resnet as JR
from rau_vqa_tpu_torch.convert import params_from_jax
from rau_vqa_tpu_torch.models import backbones
from rau_vqa_tpu_torch.models.backbones import resnet as TR

from tests.test_torch_port_backbone import T, assert_scaled_close, narrow_resnet, np_tree


def folded_pair(seed, blocks=(1, 1, 1, 1), dtype=jnp.float32):
    """(JAX folded tree as numpy, the port's copy of it)."""
    tree = jax.tree.map(lambda a: jnp.asarray(a, dtype), narrow_resnet(seed, blocks=blocks))
    jt = np_tree(JR.fold_batchnorm(tree))
    return jt, params_from_jax(jt)


def bits(a):
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32) if a.dtype.kind == "f" \
        else a


# ---------------------------------------------------------------------------
# the space-to-depth stem
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_space_to_depth_stem_is_jax_bit_for_bit(dtype):
    jt, tt = folded_pair(1, dtype=dtype)
    want = np_tree(JR.space_to_depth_stem(jt))
    got = TR.space_to_depth_stem(tt)
    assert tuple(got["conv1"]["w"].shape) == (4, 4, 12, 16)
    for k in ("w", "b"):
        g = params_from_jax(want)["conv1"][k]
        assert got["conv1"][k].dtype == g.dtype
        assert torch.equal(got["conv1"][k].view(torch.int16 if g.dtype == torch.bfloat16
                                                else torch.int32),
                           g.view(torch.int16 if g.dtype == torch.bfloat16 else torch.int32))
    assert got["stages"] is tt["stages"]            # the rest of the tree is shared
    assert "conv1" in tt and tuple(tt["conv1"]["w"].shape) == (7, 7, 3, 16)


def test_s2d_stem_matches_conv1_at_jax_bar():
    """The 4x4/1 conv over the s2d input, padded (2, 1), is the 7x7/2 pad-3
    conv1: JAX's own test of the stem, here on the port."""
    rs = np.random.RandomState(0)
    w = rs.randn(7, 7, 3, 16).astype(np.float32) * 0.1
    b = rs.randn(16).astype(np.float32) * 0.1
    x = rs.randn(2, 32, 32, 3).astype(np.float32)
    ref = torch.relu(TR._conv(T(x), T(w), stride=2) + T(b))
    tree = TR.space_to_depth_stem({"conv1": {"w": T(w), "b": T(b)}, "stages": []})
    got = TR._stem(T(x), tree, TR._prepare(tree))
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)
    jref = jax.nn.relu(JR._conv(jnp.asarray(x), jnp.asarray(w), stride=2) + jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(jref), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(TR._s2d(T(x)).numpy(), np.asarray(JR._s2d(jnp.asarray(x))))


@pytest.mark.parametrize("stages", [(), (0, 1, 2, 3)])
def test_s2d_tree_through_resnet101_apply_matches_jax(stages):
    """On the shrunk net (two blocks a stage, so every stage has an identity
    run for the fused stages' plain version) against JAX's s2d tree, and
    against the port's 7x7 tree."""
    jt, tt = folded_pair(3, blocks=(2, 2, 2, 2))
    js2d = np_tree(JR.space_to_depth_stem(jt))
    x = np.random.RandomState(4).randn(2, 64, 64, 3).astype(np.float32)
    want = np.asarray(JR.resnet101_apply(js2d, jnp.asarray(x)))
    s2d = TR.space_to_depth_stem(tt)
    got = TR.resnet101_apply(s2d, T(x), fused_stages=stages)
    assert got.shape == (2, 4, 256)
    assert_scaled_close(got.numpy(), want, 3e-5)
    assert_scaled_close(got.numpy(), TR.resnet101_apply(tt, T(x)).numpy(), 3e-5)


def test_s2d_refusals():
    jt, tt = folded_pair(5)
    with pytest.raises(ValueError, match="even H and W"):
        TR.resnet101_apply(TR.space_to_depth_stem(tt), torch.zeros(1, 33, 32, 3))
    with pytest.raises(ValueError, match="fold_batchnorm"):
        TR.space_to_depth_stem(params_from_jax(narrow_resnet(5, blocks=(1, 1, 1, 1))))
    with pytest.raises(ValueError, match="7x7x3"):
        TR.space_to_depth_stem(TR.space_to_depth_stem(tt))


# ---------------------------------------------------------------------------
# the int8 mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_quantize_resnet_is_jax_bit_for_bit(dtype):
    """wq, wscale and b bit-equal, a zero output channel's scale 1 included;
    ``params_from_jax`` carries JAX's int8 tree over as it is."""
    jt, _ = folded_pair(6, dtype=dtype)
    conv2 = jt["stages"][1][0]["conv2"]
    conv2["w"] = np.array(conv2["w"])
    conv2["w"][..., 3] = 0                               # an all-zero channel
    tt = params_from_jax(jt)
    want = params_from_jax(np_tree(JR.quantize_resnet(jt)))
    got = TR.quantize_resnet(tt)
    flat_w = [(k, v) for k, v in _leaves(want)]
    flat_g = dict(_leaves(got))
    assert sorted(k for k, _ in flat_w) == sorted(flat_g)
    for k, w in flat_w:
        g = flat_g[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(bits(g.numpy()), bits(w.numpy()), err_msg=k)
    assert got["stages"][1][0]["conv2"]["wscale"][3] == 1.0
    assert want["conv1"]["wq"].dtype == torch.int8
    with pytest.raises(ValueError, match="fold_batchnorm"):
        TR.quantize_resnet(params_from_jax(narrow_resnet(6, blocks=(1, 1, 1, 1))))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


# the 448-px main path's shape classes, cut to 40 px: (k, stride, ci, co)
SHAPES = {"stem7x7s2": (7, 3, 16, 2), "1x1": (1, 24, 16, 1), "3x3s1": (3, 16, 24, 1),
          "3x3s2": (3, 16, 16, 2), "down1x1s2": (1, 24, 32, 2)}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_conv_int8_accumulators_equal_jax(name):
    k, ci, co, stride = SHAPES[name]
    rs = np.random.RandomState(k * 7 + ci)
    side = 40 if k == 7 else 20
    x = (rs.randn(2, side, side, ci) * 3).astype(np.float32)
    w = (rs.randn(k, k, ci, co) * 0.2).astype(np.float32)
    b = (rs.randn(co) * 0.1).astype(np.float32)
    jq = np_tree(JR.quantize_resnet({"conv1": {"w": w, "b": b}, "stages": []}))["conv1"]
    p = TR.quantize_resnet({"conv1": {"w": T(w), "b": T(b)}, "stages": []})["conv1"]
    # the activations' codes and scale, as the JAX function makes them
    xj = jnp.asarray(x)
    xscale = jnp.maximum(jnp.max(jnp.abs(xj)) / 127.0, 1e-8)
    xq_j = np.asarray(jnp.clip(jnp.round(xj / xscale), -127, 127).astype(jnp.int8))
    xq, xs = TR._quantize_act(T(x))
    np.testing.assert_array_equal(xq.numpy(), xq_j)
    assert xs.item() == np.float32(xscale)
    pad = ((k - 1) // 2, (k - 1) // 2)
    acc_j = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(xq_j), jnp.asarray(jq["wq"]), (stride, stride), (pad, pad),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32))
    acc = TR._conv_int8_acc(xq, p["wq"], stride)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), acc_j)
    np.testing.assert_allclose(TR._conv_int8(T(x), p, stride).numpy(),
                               np.asarray(JR._conv_int8(xj, jq, stride)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("m,k,n", [(5, 147, 64), (17, 8, 8), (40, 20, 12), (3, 9, 5)])
def test_int8_mm_pads_to_what_the_card_takes(m, k, n):
    """M > 16, K and N in multiples of 8: zero padding and a cut give the
    exact product at any shape."""
    rs = np.random.RandomState(m + k + n)
    a = torch.as_tensor(rs.randint(-127, 128, (m, k)).astype(np.int8))
    b = torch.as_tensor(rs.randint(-127, 128, (k, n)).astype(np.int8))
    got = TR._int8_mm(a, b)
    assert got.dtype == torch.int32 and got.shape == (m, n)
    torch.testing.assert_close(got, (a.long() @ b.long()).int(), rtol=0, atol=0)


def test_int8_net_matches_jax_int8_and_tracks_f32():
    """The shrunk net (one block a stage) at 64 px: the port's int8 features
    within norm-relative 1e-3 of JAX's, and at JAX's bars of the float32
    folded features."""
    jt, tt = folded_pair(7)
    x = np.random.RandomState(8).rand(2, 64, 64, 3).astype(np.float32)
    want = np.asarray(JR.resnet101_apply_int8(np_tree(JR.quantize_resnet(jt)),
                                              jnp.asarray(x)))
    got = backbones.resnet101_apply_int8(backbones.quantize_resnet(tt), T(x)).numpy()
    assert got.shape == want.shape == (2, 4, 256) and got.dtype == np.float32
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-3
    ref = TR.resnet101_apply(tt, T(x)).numpy().ravel()
    corr = np.corrcoef(ref, got.ravel())[0, 1]
    rel = np.linalg.norm(got.ravel() - ref) / (np.linalg.norm(ref) + 1e-9)
    assert corr > 0.995 and rel < 0.1, (corr, rel)


def test_int8_scale_is_per_batch():
    """The activation scale is the whole batch's, as in the JAX package: an
    example's features depend on the examples beside it."""
    _, tt = folded_pair(9)
    q = TR.quantize_resnet(tt)
    rs = np.random.RandomState(10)
    x = T(rs.rand(2, 64, 64, 3).astype(np.float32))
    alone = TR.resnet101_apply_int8(q, x[:1])
    loud = torch.cat([x[:1], x[1:] * 4.0])
    beside = TR.resnet101_apply_int8(q, loud)[:1]
    assert not torch.equal(alone, beside)
    torch.testing.assert_close(TR.resnet101_apply_int8(q, x)[:1],
                               TR.resnet101_apply_int8(q, x)[:1], rtol=0, atol=0)
