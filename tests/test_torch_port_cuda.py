"""The port's CUDA kernels against their plain versions, on the card.

Needs a CUDA device: every test takes the ``cuda_device`` fixture, which
skips without one.  The module imports no JAX, so it runs where only PyTorch
is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Shapes are the ``ours_ms`` widths; bars are those of tests/test_pallas_rau.py
for the Pallas kernels against their XLA paths.
"""

import numpy as np
import pytest
import torch

from rau_vqa_tpu_torch.config import get_preset
from rau_vqa_tpu_torch.eval.predict import (
    compute_answers,
    make_predict_step,
    predict,
)
from rau_vqa_tpu_torch.models.rau import embed_image, embed_question, init_params
from rau_vqa_tpu_torch.ops import lstm_encoder, rau_hops

pytestmark = pytest.mark.cuda

CFG = get_preset("ours_ms")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, dev, seed=0):
    params = init_params(CFG, torch.Generator().manual_seed(seed), dev)
    rs = np.random.RandomState(seed)
    lengths = rs.randint(1, CFG.seq_len + 1, B).astype(np.int32)
    tokens = np.zeros((B, CFG.seq_len), np.int64)
    for k in range(B):
        tokens[k, :lengths[k]] = rs.randint(1, CFG.vocab_size, lengths[k])
    feats = np.abs(rs.randn(B, CFG.cnn_spat, CFG.cnn_dim)).astype(np.float32)
    return (params, torch.as_tensor(tokens, device=dev),
            torch.as_tensor(lengths, device=dev),
            torch.as_tensor(feats, device=dev))


@pytest.mark.parametrize("B", [19, 512])
def test_lstm_encode_matches_plain(cuda_device, B):
    params, tokens, lengths, _ = _inputs(B, cuda_device)
    enc = lstm_encoder.pack_encoder_weights(params["rnn"])
    emb = embed_question(params, tokens).contiguous()
    got = lstm_encoder.lstm_encode(enc, CFG, emb, lengths)
    want = lstm_encoder.lstm_encode_reference(enc, CFG, emb, lengths,
                                              dot_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert got.shape == (B, CFG.rnnout_dim)
    torch.testing.assert_close(got, want, rtol=0.05, atol=5e-3)


@pytest.mark.parametrize("B", [19, 512])
def test_rau_hops_matches_plain(cuda_device, B):
    params, tokens, lengths, feats = _inputs(B, cuda_device)
    hw = rau_hops.pack_hop_weights(params["mult"])
    q = lstm_encoder.lstm_encode_reference(
        params["rnn"], CFG, embed_question(params, tokens), lengths)
    ifeat, iatt = embed_image(params["mult"], feats)
    ifeat = ifeat.to(torch.bfloat16).contiguous()
    iatt = iatt.to(torch.bfloat16).contiguous()
    s, d, a = rau_hops.rau_hops(hw, CFG, q, ifeat, iatt)
    s_ref, d_ref, a_ref = rau_hops.rau_hops_reference(
        hw, CFG, q, ifeat, iatt, dot_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert s.shape == (CFG.n_hops, B, CFG.answer_size)
    torch.testing.assert_close(s, s_ref, rtol=0.05, atol=0.01)
    assert (s.argmax(-1) == s_ref.argmax(-1)).float().mean().item() > 0.97
    torch.testing.assert_close(a, a_ref, rtol=0.05, atol=5e-4)
    torch.testing.assert_close(d, d_ref, rtol=0.05, atol=5e-3)


def test_predict_step_runs_both_kernels(cuda_device):
    B = 83
    params, tokens, lengths, feats = _inputs(B, cuda_device, seed=1)
    step = make_predict_step(CFG, buckets=(8, 16))
    before = (lstm_encoder.KERNEL.launches, rau_hops.KERNEL.launches)
    tab_pred, tab_att = step(params, tokens, lengths, feats)
    torch.cuda.synchronize()
    assert lstm_encoder.KERNEL.launches == before[0] + 1
    assert rau_hops.KERNEL.launches == before[1] + 1
    assert tab_pred.shape == (CFG.n_hops + 2, B, CFG.answer_size)
    assert tab_att.shape == (CFG.n_hops + 2, B, CFG.cnn_spat)
    assert torch.isfinite(tab_pred).all() and torch.isfinite(tab_att).all()
    with torch.no_grad():
        ref_pred, _ = predict(params, CFG, tokens, lengths, feats)
    torch.testing.assert_close(tab_pred, ref_pred, rtol=0.05, atol=0.02)
    oe, _ = compute_answers(tab_pred)
    oe_ref, _ = compute_answers(ref_pred)
    assert (oe == oe_ref).float().mean().item() > 0.95


def test_wrappers_reject_wrong_inputs(cuda_device):
    params, tokens, lengths, feats = _inputs(4, cuda_device)
    enc = lstm_encoder.pack_encoder_weights(params["rnn"])
    emb = embed_question(params, tokens).contiguous()
    with pytest.raises(ValueError):
        lstm_encoder.lstm_encode(enc, CFG, emb.double(), lengths)
    with pytest.raises(ValueError):
        lstm_encoder.lstm_encode(enc, CFG, emb, lengths.long())
    hw = rau_hops.pack_hop_weights(params["mult"])
    ifeat, iatt = embed_image(params["mult"], feats)
    q = torch.zeros(4, CFG.rnnout_dim, device=cuda_device)
    with pytest.raises(ValueError):   # features must come in as bf16
        rau_hops.rau_hops(hw, CFG, q, ifeat, iatt)
