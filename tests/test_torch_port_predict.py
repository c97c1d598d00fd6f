"""The port's prediction and serving step against the JAX package, on the CPU.

``predict`` (plain float32) against JAX ``predict``; answer ids under
``compute_answers`` / ``mc_mask``; the length-bucket ladder; the serving step
on the CPU (its wrappers run the plain versions, bf16 dots) against the JAX
fused path in interpret mode; and the device rules of ``make_predict_step``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rau_vqa_tpu.config import ModelConfig as JaxModelConfig
from rau_vqa_tpu.eval import predict as jpred
from rau_vqa_tpu.models import rau as jrau
from rau_vqa_tpu_torch import config as tconfig
from rau_vqa_tpu_torch.convert import params_from_jax
from rau_vqa_tpu_torch.eval import predict as tpred
from rau_vqa_tpu_torch.ops import lstm_encoder, rau_hops

# the small configuration of tests/test_pallas_rau.py
JCFG = JaxModelConfig(
    vocab_size=50, answer_size=16, seq_len=9, embed_dim=8, rnn_size=16,
    rnn_layers=2, cnn_dim=12, cnn_w=4, cnn_h=2, multfeat_dim=16,
    attfeat_dim=8, att_rnn_size=16, n_hops=3)
CFG = tconfig.ModelConfig(**{f.name: getattr(JCFG, f.name)
                             for f in dataclasses.fields(tconfig.ModelConfig)})


def setup(B, seed=0, max_len=None):
    p = jax.tree.map(np.asarray, jrau.init_params(jax.random.PRNGKey(seed), JCFG))
    rs = np.random.RandomState(seed)
    top = max_len or JCFG.seq_len
    lengths = rs.randint(1, top + 1, B).astype(np.int32)
    tokens = np.zeros((B, JCFG.seq_len), np.int32)
    for k in range(B):
        tokens[k, :lengths[k]] = rs.randint(1, JCFG.vocab_size, lengths[k])
    feats = rs.randn(B, JCFG.cnn_spat, JCFG.cnn_dim).astype(np.float32)
    mc = rs.randint(-1, JCFG.answer_size, (B, 4)).astype(np.int32)
    return p, tokens, lengths, feats, mc


def T(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("B", [16, 19])
def test_predict_matches_jax(B):
    p, tokens, lengths, feats, mc = setup(B, seed=B)
    jt, ja = jpred.predict(p, JCFG, jnp.asarray(tokens), jnp.asarray(lengths),
                           jnp.asarray(feats))
    tt, ta = tpred.predict(params_from_jax(p), CFG, T(tokens), T(lengths), T(feats))
    assert tt.shape == (JCFG.n_hops + 2, B, JCFG.answer_size)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-4, atol=1e-5)
    j_oe, j_mc = jpred.compute_answers(jt, jnp.asarray(mc))
    t_oe, t_mc = tpred.compute_answers(tt, T(mc))
    np.testing.assert_array_equal(t_oe.numpy(), np.asarray(j_oe))
    np.testing.assert_array_equal(t_mc.numpy(), np.asarray(j_mc))


def test_mc_mask_matches_jax_and_keeps_the_multiplication_quirk():
    mc = np.array([[3, -1, 0, 3], [-1, -1, -1, -1], [5, 1, 2, 15]], np.int32)
    want = jpred.mc_mask(jnp.asarray(mc), 16)
    got = tpred.mc_mask(T(mc), 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # all candidate logits negative: a masked-out 0 wins, as in the reference
    tab = -torch.ones(1, 1, 16)
    tab[0, 0, 7] = -5.0
    _, pick = tpred.compute_answers(tab, T(mc[:1]))
    assert int(pick[0, 0]) not in (0, 3)


@pytest.mark.parametrize("seq_len", [5, 9, 26])
def test_bucket_ladder_and_pick_bucket_match_jax(seq_len):
    for buckets in [(), (8, 16), (16, 8, 8), (0, 3, 30), (4,), (1, 2, 3, 4)]:
        ladder = tpred.bucket_ladder(seq_len, buckets)
        assert ladder == jpred.bucket_ladder(seq_len, buckets)
        for max_len in range(1, seq_len + 1):
            assert tpred.pick_bucket(ladder, max_len) == \
                jpred.pick_bucket(ladder, max_len)
        with pytest.raises(ValueError, match="ladder top"):
            tpred.pick_bucket(ladder, seq_len + 1)


def test_bucketed_step_equals_full_length_step():
    p, tokens, lengths, feats, _ = setup(12, seed=3, max_len=4)
    tp = params_from_jax(p)
    full = tpred.make_predict_step(CFG, device="cpu")(tp, tokens, lengths, feats)
    cut = tpred.make_predict_step(CFG, buckets=(4, 6), device="cpu")(
        tp, tokens, lengths, feats)
    for a, b in zip(full, cut):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("B", [16, 19])
def test_cpu_step_matches_jax_fused_interpret(B):
    """The step's plain versions (bf16 dots) against the JAX fused path with
    both Pallas kernels in interpret mode; B=19 exercises the JAX padding."""
    p, tokens, lengths, feats, _ = setup(B, seed=5)
    jt, ja = jpred.predict_fused(p, JCFG, jnp.asarray(tokens), jnp.asarray(lengths),
                                 jnp.asarray(feats), interpret=True,
                                 fuse_encoder=True)
    before = (lstm_encoder.KERNEL.launches, rau_hops.KERNEL.launches)
    step = tpred.make_predict_step(CFG, buckets=(4,), device="cpu")
    tt, ta = step(params_from_jax(p), tokens, lengths, feats)
    assert (lstm_encoder.KERNEL.launches, rau_hops.KERNEL.launches) == before
    assert tt.shape == (JCFG.n_hops + 2, B, JCFG.answer_size)
    assert ta.shape == (JCFG.n_hops + 2, B, JCFG.cnn_spat)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-3, atol=1e-5)
    np.testing.assert_array_equal(tpred.compute_answers(tt)[0].numpy(),
                                  np.asarray(jpred.compute_answers(jt)[0]))


def test_step_reuses_packed_weights_per_parameter_set():
    p, tokens, lengths, feats, _ = setup(3)
    tp = params_from_jax(p)
    step = tpred.make_predict_step(CFG, device="cpu")
    packs, pack = [], step._weights_for.fn
    step._weights_for.fn = lambda params: packs.append(params) or pack(params)
    step(tp, tokens, lengths, feats)
    step(tp, tokens, lengths, feats)
    assert len(packs) == 1 and packs[0] is tp
    tp2 = params_from_jax(p)
    step(tp2, tokens, lengths, feats)
    assert len(packs) == 2 and packs[1] is tp2


def test_make_predict_step_defaults_to_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpred.make_predict_step(CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpred.make_predict_step(CFG, device="cuda")
    assert tpred.make_predict_step(CFG, device="cpu").device.type == "cpu"
