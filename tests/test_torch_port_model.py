"""The port's model core (rau_vqa_tpu_torch) against the JAX package, on the
CPU in float32: parameter interchange, both LSTM cells, the encoder, the eval
forward and the hop aggregation.  Inputs come from numpy with a seed; data
crosses between the frameworks as numpy arrays."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rau_vqa_tpu.config import ModelConfig as JaxModelConfig
from rau_vqa_tpu.config import get_preset as jax_get_preset
from rau_vqa_tpu.models import aggregate as jagg
from rau_vqa_tpu.models import cells as jcells
from rau_vqa_tpu.models import rau as jrau
from rau_vqa_tpu_torch import config as tconfig
from rau_vqa_tpu_torch.convert import map_tree, params_from_jax, params_to_jax, tree_leaves
from rau_vqa_tpu_torch.models import aggregate as tagg
from rau_vqa_tpu_torch.models import cells as tcells
from rau_vqa_tpu_torch.models import rau as trau

# the small configuration of tests/test_pallas_rau.py
JCFG = JaxModelConfig(
    vocab_size=50, answer_size=16, seq_len=9, embed_dim=8, rnn_size=16,
    rnn_layers=2, cnn_dim=12, cnn_w=4, cnn_h=2, multfeat_dim=16,
    attfeat_dim=8, att_rnn_size=16, n_hops=3)
RTOL, ATOL = 1e-4, 1e-5


def port_cfg(jcfg):
    names = {f.name for f in dataclasses.fields(tconfig.ModelConfig)}
    names.discard("fused_train_bwd")      # the port's default differs
    return tconfig.ModelConfig(**{n: getattr(jcfg, n) for n in names})


CFG = port_cfg(JCFG)


def jax_params(seed=0, cfg=JCFG):
    return jax.tree.map(np.asarray, jrau.init_params(jax.random.PRNGKey(seed), cfg))


def inputs(B, seed=0):
    rs = np.random.RandomState(seed)
    lengths = rs.randint(1, JCFG.seq_len + 1, B).astype(np.int32)
    tokens = np.zeros((B, JCFG.seq_len), np.int32)
    for k in range(B):
        tokens[k, :lengths[k]] = rs.randint(1, JCFG.vocab_size, lengths[k])
    feats = rs.randn(B, JCFG.cnn_spat, JCFG.cnn_dim).astype(np.float32)
    return tokens, lengths, feats


def t(x):
    return torch.as_tensor(np.array(x))


def test_params_roundtrip_bit_exact():
    p = jax_params(3)
    back = params_to_jax(params_from_jax(p))
    leaves_a = jax.tree_util.tree_leaves_with_path(p)
    leaves_b = jax.tree_util.tree_leaves_with_path(back)
    assert [k for k, _ in leaves_a] == [k for k, _ in leaves_b]
    for (_, a), (_, b) in zip(leaves_a, leaves_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_init_params_matches_jax_tree():
    tp = params_to_jax(trau.init_params(CFG, torch.Generator().manual_seed(0),
                                        device="cpu"))
    jp = jax_params(0)
    shapes = jax.tree.map(lambda a: a.shape, jp)
    assert jax.tree.map(lambda a: a.shape, tp) == shapes
    for leaf in jax.tree.leaves(tp):
        assert leaf.dtype == np.float32
        assert np.all(np.abs(leaf) <= 0.08)


@pytest.mark.parametrize("name", ["ours_ss", "ours_ms", "ours_full",
                                  "ours_resnet", "ours_resnet_ft", "ours_vit"])
def test_presets_match_jax(name):
    assert tconfig.get_preset(name) == port_cfg(jax_get_preset(name).model)


def test_deep_lstm_cell_matches_jax():
    p = jax_params(1)
    rs = np.random.RandomState(1)
    B, R = 5, JCFG.rnn_size
    x = rs.randn(B, JCFG.embed_dim).astype(np.float32)
    state = rs.randn(B, JCFG.rnnout_dim).astype(np.float32)
    want = jcells.deep_lstm_cell(p["rnn"], jnp.asarray(x), jnp.asarray(state),
                                 rnn_size=R)
    got = tcells.deep_lstm_cell(params_from_jax(p["rnn"]), t(x), t(state),
                                rnn_size=R)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_att_lstm_cell_matches_jax():
    p = jax_params(2)
    rs = np.random.RandomState(2)
    B, R = 5, JCFG.att_rnn_size
    x = rs.randn(B, JCFG.multfeat_dim).astype(np.float32)
    c = rs.randn(B, R).astype(np.float32)
    h = rs.randn(B, R).astype(np.float32)
    wc, wh = jcells.att_lstm_cell(p["mult"]["attlstm"], jnp.asarray(x),
                                  jnp.asarray(c), jnp.asarray(h), rnn_size=R)
    gc, gh = tcells.att_lstm_cell(params_from_jax(p["mult"]["attlstm"]),
                                  t(x), t(c), t(h), rnn_size=R)
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(gh.numpy(), np.asarray(wh), rtol=RTOL, atol=ATOL)


def test_encode_question_matches_jax():
    p = jax_params(4)
    tokens, lengths, _ = inputs(7, seed=4)
    want = jrau.encode_question(p, JCFG, jnp.asarray(tokens), jnp.asarray(lengths))
    got = trau.encode_question(params_from_jax(p), CFG, t(tokens), t(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_embed_image_and_answering_unit_match_jax():
    p = jax_params(5)
    mp_j, mp_t = p["mult"], params_from_jax(p["mult"])
    rs = np.random.RandomState(5)
    B = 6
    feats = rs.randn(B, JCFG.cnn_spat, JCFG.cnn_dim).astype(np.float32)
    q = rs.randn(B, JCFG.rnnout_dim).astype(np.float32)
    c = rs.randn(B, JCFG.att_state_dim).astype(np.float32)
    h = rs.randn(B, JCFG.att_state_dim).astype(np.float32)
    jif, jia = jrau.embed_image(mp_j, JCFG, jnp.asarray(feats))
    tif, tia = trau.embed_image(mp_t, t(feats))
    np.testing.assert_allclose(tif.numpy(), np.asarray(jif), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tia.numpy(), np.asarray(jia), rtol=RTOL, atol=ATOL)
    want = jrau.answering_unit(mp_j, JCFG, jnp.asarray(q), jif, jia,
                               jnp.asarray(c), jnp.asarray(h))
    got = trau.answering_unit(mp_t, CFG, t(q), tif, tia, t(c), t(h))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("B", [5, 19])
def test_rau_forward_matches_jax(B):
    p = jax_params(6)
    tokens, lengths, feats = inputs(B, seed=6)
    want = jrau.rau_forward(p, JCFG, jnp.asarray(tokens), jnp.asarray(lengths),
                            jnp.asarray(feats))
    got = trau.rau_forward(params_from_jax(p), CFG, t(tokens), t(lengths), t(feats))
    for name in ("scores", "do_pred", "attprob", "final_c", "final_h"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def test_rau_forward_train_names_the_training_slice():
    """Training runs the configuration as it is given, here the unfused one
    (the default): dropout needs a generator; with one, the forward gives
    finite outputs of the eval shapes and a gradient to every group."""
    assert not CFG.fused_train
    p = map_tree(lambda x: x.requires_grad_(), params_from_jax(jax_params(0)))
    tokens, lengths, feats = inputs(2)
    with pytest.raises(ValueError, match="generator"):
        trau.rau_forward(p, CFG, t(tokens), t(lengths), t(feats), train=True)
    out = trau.rau_forward(p, CFG, t(tokens), t(lengths), t(feats), train=True,
                           generator=torch.Generator().manual_seed(0))
    H, A, S = CFG.n_hops, CFG.answer_size, CFG.cnn_spat
    assert out.scores.shape == (H, 2, A) and out.attprob.shape == (H, 2, S)
    assert all(torch.isfinite(x).all() for x in out)
    out.scores.sum().backward()
    for group in ("embed", "rnn", "mult"):
        assert any(x.grad is not None and x.grad.abs().max() > 0
                   for x in tree_leaves(p[group])), group


@pytest.mark.parametrize("force_final", [True, False])
def test_select_aggregate_matches_jax(force_final):
    rs = np.random.RandomState(7)
    H, B, A = 4, 9, 5
    scores = rs.randn(H, B, A).astype(np.float32)
    do_pred = rs.uniform(0, 1, (H, B)).astype(np.float32)
    do_pred[:, :3] = 0.2          # never fires: only force_final can pick a hop
    wp, wg = jagg.select_aggregate(jnp.asarray(scores), jnp.asarray(do_pred),
                                   force_final=force_final)
    gp, gg = tagg.select_aggregate(t(scores), t(do_pred), force_final=force_final)
    np.testing.assert_array_equal(gg.numpy(), np.asarray(wg))
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), rtol=RTOL, atol=ATOL)
