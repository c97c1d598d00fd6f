"""Cutting the token axis in training leaves the port's gradients exact, as
tests/test_train.py ``test_truncated_train_grads_match_full`` pins for the
JAX package.

Steps past every question's last token are dropped by the last-token
gather, so their cotangents are zero; and every dropout mask depends on its
position, not on T: the encoder draws each site's masks for all
``seq_len`` timesteps up front and cuts them to T, so the hop loop's masks
(the unfused path's draws, the fused path's hop seed) come from the same
generator state at every T.  With dropout on at the embedding, the LSTM and
the answering units, the grads at T = seq_len and at a bucket that covers
the longest question agree at rtol 1e-5, in both paths.  The masks cannot
match ``jax.random``'s bits, so this is held within the port.
"""

import dataclasses

import numpy as np
import pytest
import torch

from rau_vqa_tpu_torch.config import get_preset
from rau_vqa_tpu_torch.convert import tree_leaves
from rau_vqa_tpu_torch.models.rau import encode_question, init_params, rau_forward
from rau_vqa_tpu_torch.train.losses import joint_loss_and_metrics

# the small configuration of tests/test_train.py:236-239, every dropout on
CFG = dataclasses.replace(
    get_preset("ours_ms"), vocab_size=50, answer_size=10, seq_len=20, embed_dim=8,
    rnn_size=16, cnn_dim=8, cnn_w=2, cnn_h=2, multfeat_dim=16, attfeat_dim=8,
    att_rnn_size=16, n_hops=2, embed_dropout=0.5, rnn_dropout=0.5, mult_dropout=0.5)
B, MAX_LEN, BUCKET = 8, 11, 16


def _batch():
    rs = np.random.RandomState(1)
    lengths = rs.randint(1, MAX_LEN + 1, B)
    lengths[0] = MAX_LEN
    tokens = np.zeros((B, CFG.seq_len), np.int64)
    for k in range(B):
        tokens[k, :lengths[k]] = rs.randint(1, CFG.vocab_size, lengths[k])
    labels = rs.randint(0, CFG.answer_size, B)
    feats = rs.randn(B, CFG.cnn_spat, CFG.cnn_dim).astype(np.float32)
    return (torch.as_tensor(tokens), torch.as_tensor(lengths), torch.as_tensor(feats),
            torch.as_tensor(labels))


def _grads(cfg, T):
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    leaves = [x.requires_grad_() for x in tree_leaves(params)]
    tokens, lengths, feats, labels = _batch()
    out = rau_forward(params, cfg, tokens[:, :T], lengths, feats, train=True,
                      generator=torch.Generator().manual_seed(7))
    loss, _ = joint_loss_and_metrics(out.scores, out.do_pred, labels,
                                     torch.ones(cfg.n_hops))
    return torch.autograd.grad(loss, leaves, allow_unused=True)


@pytest.mark.parametrize("path", ["unfused", "unfused_remat", "fused"])
def test_truncated_train_grads_match_full(path):
    cfg = dataclasses.replace(CFG, fused_train=path == "fused",
                              remat_hops=path == "unfused_remat")
    full, bucket = _grads(cfg, CFG.seq_len), _grads(cfg, BUCKET)
    assert len(full) == len(bucket)
    for i, (g, w) in enumerate(zip(bucket, full)):
        if w is None:
            assert g is None, i
            continue
        assert torch.isfinite(w).all(), i
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=f"leaf {i}")
    # the masks are on: a grad that none of them moved would hide the fault
    assert any(w is not None and w.abs().sum() > 0 for w in full)


def test_encoder_masks_do_not_depend_on_t():
    """The encoder's output at T = seq_len and at the bucket, with every
    dropout on, is the same; and so is the generator's state after it."""
    params = init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    tokens, lengths, _, _ = _batch()
    outs, states = [], []
    for T in (CFG.seq_len, BUCKET, MAX_LEN):
        g = torch.Generator().manual_seed(3)
        outs.append(encode_question(params, CFG, tokens[:, :T], lengths, train=True,
                                    generator=g))
        states.append(g.get_state())
    for o, s in zip(outs[1:], states[1:]):
        torch.testing.assert_close(o, outs[0], rtol=1e-6, atol=1e-7)
        assert torch.equal(s, states[0])
    # dropout is on: a draw from another seed changes the output
    other = encode_question(params, CFG, tokens, lengths, train=True,
                            generator=torch.Generator().manual_seed(4))
    assert not torch.allclose(other, outs[0])


def test_encoder_refuses_more_timesteps_than_seq_len_in_training():
    params = init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.ones(2, CFG.seq_len + 1, dtype=torch.int64)
    with pytest.raises(ValueError, match="seq_len"):
        encode_question(params, CFG, tokens, torch.tensor([3, 4]), train=True,
                        generator=torch.Generator().manual_seed(0))
