"""The plain references agree with the program's plain float32 paths on the
CPU at small sizes, on the weights the benchmark makes."""

from __future__ import annotations

import numpy as np
import torch

import harness
import traffic
import weights
from reference import rau as ref_rau
from reference import resnet as ref_resnet
from rau_vqa_tpu_torch.config import ModelConfig
from rau_vqa_tpu_torch.eval.predict import predict
from rau_vqa_tpu_torch.models.pipeline import extract_features

SMALL = dict(vocab_size=40, embed_dim=12, rnn_size=16, rnn_layers=2, cnn_dim=24, cnn_w=3,
             cnn_h=3, multfeat_dim=20, attfeat_dim=10, att_rnn_size=16, att_rnn_layers=1,
             answer_size=30, n_hops=4, seq_len=7)


def test_rau_tables_match_the_program_predict():
    s = harness.Sizes(SMALL)
    g = torch.Generator().manual_seed(3)
    params = weights.rau_head(s, g, 0.3)
    rng = np.random.default_rng(3)
    lengths = traffic.question_lengths({"1": 1, "4": 2, "7": 1}, 9, rng)
    tokens = torch.from_numpy(traffic.question_tokens(lengths, 7, 40, rng))
    feats = torch.randn(9, 9, 24, generator=g).clamp(min=0)
    want_pred, want_att = predict(params, ModelConfig(**SMALL), tokens, torch.from_numpy(lengths),
                                  feats)
    sizes = {"rnn_size": 16, "n_hops": 4, "att_rnn_size": 16}
    got_pred, got_att, do = ref_rau.tables(params, sizes, tokens, torch.from_numpy(lengths), feats,
                                           rows=4)
    torch.testing.assert_close(got_pred, want_pred, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got_att, want_att, rtol=1e-5, atol=1e-6)
    assert do.shape == (4, 9)


def test_resnet_features_match_the_program_backbone():
    g = torch.Generator().manual_seed(4)
    bb = weights.resnet101_folded(g, torch.float32, residual_gain=0.1, bias_std=0.02)
    images = torch.randint(0, 256, (2, 64, 64, 3), generator=g, dtype=torch.uint8)
    want = extract_features("resnet101", bb, images)
    got = ref_resnet.features(bb, images)
    assert got.shape == want.shape == (2, 4, 2048)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    # a trained network's scale, not the JAX-style init's ~1e7
    assert 0.05 < got.pow(2).mean().sqrt().item() < 20.0


def test_lengths_are_the_same_multiset_for_every_seed():
    probs = {"2": 0.1, "5": 0.6, "9": 0.3}
    a = traffic.question_lengths(probs, 101, np.random.default_rng(1))
    b = traffic.question_lengths(probs, 101, np.random.default_rng(2 ** 31 + 5))
    assert sorted(a) == sorted(b) and list(a) != list(b)
    assert [int((a == k).sum()) for k in (2, 5, 9)] == [10, 61, 30]


def test_training_steps_match_the_program_step():
    """Two steps of the preset's recipe (every dropout on, gradient noise,
    clip, Adam): the masks and noise worked out again from the seed."""
    from rau_vqa_tpu_torch.config import TrainConfig
    from rau_vqa_tpu_torch.train.optim import adam_init
    from rau_vqa_tpu_torch.train.trainer import TrainState, make_train_step
    from reference import train as ref_train
    small = dict(SMALL, n_hops=3, rnn_dropout=0.5, embed_dropout=0.5, mult_dropout=0.5,
                 att_rnn_dropout=0.25)
    cfg, tcfg = ModelConfig(**small), TrainConfig()
    s = harness.Sizes(small)
    g = torch.Generator().manual_seed(5)
    params = weights.rau_head(s, g, 0.08)
    rng = np.random.default_rng(5)
    lengths = torch.from_numpy(traffic.batch_lengths({"2": 1, "5": 2, "7": 1}, 2, 8, rng))
    tokens = torch.from_numpy(traffic.question_tokens(lengths.numpy(), 7, 40, rng))
    labels = torch.from_numpy(traffic.zipf_labels(16, 30, 1.0, rng)).reshape(2, 8)
    feats = torch.randn(2, 8, 9, 24, generator=g).clamp(min=0)
    hop_scale = torch.ones(3)
    seed = 2 ** 31 + 99
    step = make_train_step(cfg, tcfg, device="cpu")
    state = TrainState(params, {k: adam_init(v) for k, v in params.items()}, 0, seed)
    ref_p, ref_o = params, ref_train.init_opt(params)
    for k in range(2):
        state, m = step(state, tokens[k], lengths[k], feats[k], labels[k], hop_scale,
                        tcfg.learning_rate, tcfg.mult_learning_rate)
        loss, _, _, ref_p, ref_o = ref_train.step(
            ref_p, ref_o, s, tcfg, seed, k, (tokens[k], lengths[k], feats[k], labels[k], hop_scale),
            tcfg.learning_rate, tcfg.mult_learning_rate)
        torch.testing.assert_close(m["loss"], loss, rtol=1e-5, atol=1e-6)
    for got, want in zip(ref_train.leaves(state.params), ref_train.leaves(ref_p)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
