"""The plain versions of the port's two kernels against the JAX package, on
the CPU: in float32 against the XLA paths, and with bf16 dots against the
Pallas kernels run in interpret mode.  Also: on CPU tensors the wrappers run
their plain versions and launch nothing."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rau_vqa_tpu.config import ModelConfig as JaxModelConfig
from rau_vqa_tpu.models import rau as jrau
from rau_vqa_tpu.ops.lstm_encoder import encode_question_fused as j_encode_fused
from rau_vqa_tpu.ops.rau_hops import rau_hops_pallas as j_hops_pallas
from rau_vqa_tpu.ops.rau_hops import rau_hops_reference as j_hops_reference
from rau_vqa_tpu_torch import config as tconfig
from rau_vqa_tpu_torch.convert import params_from_jax
from rau_vqa_tpu_torch.models.rau import embed_question
from rau_vqa_tpu_torch.ops import lstm_encoder, rau_hops
from rau_vqa_tpu_torch.ops.treeflat import pluck

# the small configuration of tests/test_pallas_rau.py
JCFG = JaxModelConfig(
    vocab_size=50, answer_size=16, seq_len=9, embed_dim=8, rnn_size=16,
    rnn_layers=2, cnn_dim=12, cnn_w=4, cnn_h=2, multfeat_dim=16,
    attfeat_dim=8, att_rnn_size=16, n_hops=3)
CFG = tconfig.ModelConfig(**{f.name: getattr(JCFG, f.name)
                             for f in dataclasses.fields(tconfig.ModelConfig)})
BF16 = torch.bfloat16


def setup(B, seed=0):
    p = jax.tree.map(np.asarray, jrau.init_params(jax.random.PRNGKey(seed), JCFG))
    rs = np.random.RandomState(seed)
    lengths = rs.randint(1, JCFG.seq_len + 1, B).astype(np.int32)
    tokens = np.zeros((B, JCFG.seq_len), np.int32)
    for k in range(B):
        tokens[k, :lengths[k]] = rs.randint(1, JCFG.vocab_size, lengths[k])
    q = rs.randn(B, JCFG.rnnout_dim).astype(np.float32)
    feats = rs.randn(B, JCFG.cnn_spat, JCFG.cnn_dim).astype(np.float32)
    ifeat, iatt = jrau.embed_image(p["mult"], JCFG, jnp.asarray(feats))
    return p, tokens, lengths, q, np.asarray(ifeat), np.asarray(iatt)


def T(x):
    return torch.as_tensor(np.array(x))


def test_lstm_encode_reference_f32_matches_encode_question():
    p, tokens, lengths, *_ = setup(16, seed=1)
    want = jrau.encode_question(p, JCFG, jnp.asarray(tokens), jnp.asarray(lengths))
    tp = params_from_jax(p)
    got = lstm_encoder.lstm_encode_reference(
        tp["rnn"], CFG, embed_question(tp, T(tokens)), T(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_lstm_encode_reference_bf16_matches_pallas_interpret():
    p, tokens, lengths, *_ = setup(16, seed=2)
    want = j_encode_fused(p, JCFG, jnp.asarray(tokens), jnp.asarray(lengths),
                          interpret=True)
    tp = params_from_jax(p)
    enc = lstm_encoder.pack_encoder_weights(tp["rnn"])
    got = lstm_encoder.lstm_encode_reference(
        enc, CFG, embed_question(tp, T(tokens)), T(lengths), dot_dtype=BF16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-4)


def test_lstm_encode_reference_zero_for_out_of_range_length():
    """Like the Pallas kernel, a row whose length is outside [1, T] is 0."""
    p, tokens, lengths, *_ = setup(4, seed=3)
    lengths[1] = 0
    tp = params_from_jax(p)
    got = lstm_encoder.lstm_encode_reference(
        tp["rnn"], CFG, embed_question(tp, T(tokens)), T(lengths))
    assert torch.all(got[1] == 0) and torch.any(got[0] != 0)


def test_rau_hops_reference_f32_matches_jax_reference():
    p, _, _, q, ifeat, iatt = setup(19, seed=4)
    ws, wd, wa = j_hops_reference(p["mult"], JCFG, jnp.asarray(q),
                                  jnp.asarray(ifeat), jnp.asarray(iatt))
    gs, gd, ga = rau_hops.rau_hops_reference(params_from_jax(p["mult"]), CFG,
                                             T(q), T(ifeat), T(iatt))
    for g, w in ((gs, ws), (gd, wd), (ga, wa)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)


def test_rau_hops_reference_bf16_matches_pallas_interpret():
    p, _, _, q, ifeat, iatt = setup(32, seed=5)
    ws, wd, wa = j_hops_pallas(p["mult"], JCFG, jnp.asarray(q), jnp.asarray(ifeat),
                               jnp.asarray(iatt), block_b=16, interpret=True)
    hw = rau_hops.pack_hop_weights(params_from_jax(p["mult"]))
    gs, gd, ga = rau_hops.rau_hops_reference(
        hw, CFG, T(q), T(ifeat).to(BF16), T(iatt).to(BF16), dot_dtype=BF16)
    # the bars of tests/test_pallas_rau.py:58-64 are 0.05/0.01, 5e-4, 5e-3
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-3, atol=1e-4)
    assert float((gs.argmax(-1).numpy() == np.asarray(ws).argmax(-1)).mean()) > 0.97
    np.testing.assert_allclose(ga.numpy(), np.asarray(wa), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-3, atol=1e-4)


def test_cpu_wrappers_run_plain_versions_and_launch_nothing():
    p, tokens, lengths, q, ifeat, iatt = setup(5, seed=6)
    tp = params_from_jax(p)
    before = (lstm_encoder.KERNEL.launches, rau_hops.KERNEL.launches)
    enc = lstm_encoder.pack_encoder_weights(tp["rnn"])
    emb = embed_question(tp, T(tokens))
    got = lstm_encoder.lstm_encode(enc, CFG, emb, T(lengths))
    want = lstm_encoder.lstm_encode_reference(enc, CFG, emb, T(lengths),
                                              dot_dtype=BF16)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    hw = rau_hops.pack_hop_weights(tp["mult"])
    args = (T(q), T(ifeat).to(BF16), T(iatt).to(BF16))
    got = rau_hops.rau_hops(hw, CFG, *args)
    want = rau_hops.rau_hops_reference(hw, CFG, *args, dot_dtype=BF16)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert (lstm_encoder.KERNEL.launches, rau_hops.KERNEL.launches) == before


@pytest.mark.parametrize("tree", ["rnn", "mult"])
def test_packed_weights_are_contiguous_bf16(tree):
    p = params_from_jax(setup(1)[0])
    pack = (lstm_encoder.pack_encoder_weights if tree == "rnn"
            else rau_hops.pack_hop_weights)
    packed = pack(p[tree])
    leaves = ([w for lp in packed["layers"] for w in lp.values()] if tree == "rnn"
              else [pluck(packed, path) for path in rau_hops.WEIGHT_ORDER])
    assert leaves and all(w.dtype == BF16 and w.is_contiguous() for w in leaves)
