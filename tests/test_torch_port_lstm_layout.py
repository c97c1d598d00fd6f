"""The question-LSTM kernel's host side on the CPU: the packed weight slabs
of ``pack_encoder_weights`` and the grid plan of ``lstm_plan``.

The slabs hold the bits of the JAX package's bf16 weights; gates computed
CTA by CTA from them, as the kernel splits the work, give the plain
version's output and the Pallas kernel's (interpret mode); and every plan
owns each hidden unit exactly once within a row group and fits a Hopper
block's shared memory."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rau_vqa_tpu.config import ModelConfig as JaxModelConfig
from rau_vqa_tpu.models import rau as jrau
from rau_vqa_tpu.ops.lstm_encoder import encode_question_fused as j_encode_fused
from rau_vqa_tpu_torch import config as tconfig
from rau_vqa_tpu_torch.convert import params_from_jax
from rau_vqa_tpu_torch.models.rau import embed_question
from rau_vqa_tpu_torch.ops import lstm_encoder

# narrow, with an embedding width (10) that is not a multiple of 16, so that
# layer 0's slab carries padding rows
JCFG = JaxModelConfig(
    vocab_size=50, answer_size=16, seq_len=9, embed_dim=10, rnn_size=32,
    rnn_layers=2, cnn_dim=12, cnn_w=4, cnn_h=2, multfeat_dim=16,
    attfeat_dim=8, att_rnn_size=16, n_hops=3)
CFG = tconfig.ModelConfig(**{f.name: getattr(JCFG, f.name)
                             for f in dataclasses.fields(tconfig.ModelConfig)})
BF16 = torch.bfloat16


def setup(B, seed=0, jcfg=JCFG):
    p = jax.tree.map(np.asarray, jrau.init_params(jax.random.PRNGKey(seed), jcfg))
    rs = np.random.RandomState(seed)
    lengths = rs.randint(1, jcfg.seq_len + 1, B).astype(np.int32)
    tokens = np.zeros((B, jcfg.seq_len), np.int32)
    for k in range(B):
        tokens[k, :lengths[k]] = rs.randint(1, jcfg.vocab_size, lengths[k])
    return p, tokens, lengths


def jax_bits(x):
    """The bits of ``x`` cast to bf16 by JAX, as int16."""
    return torch.from_numpy(np.asarray(jnp.asarray(x).astype(jnp.bfloat16))
                            .view(np.int16).copy())


def unpack_slab(slab, k_in):
    """[R, 4, K] -> (wi [k_in, 4R], padding rows, wh [R, 4R])."""
    R, _, K = slab.shape
    stacked = slab.permute(2, 1, 0).reshape(K, 4 * R)
    pad = K - R
    return stacked[:k_in], stacked[k_in:pad], stacked[pad:]


@pytest.mark.parametrize("tree_dtype", ["float32", "bfloat16"])
def test_slabs_round_trip_to_the_jax_bf16_bits(tree_dtype):
    p = setup(1)[0]
    if tree_dtype == "bfloat16":
        p = jax.tree.map(lambda x: np.asarray(jnp.asarray(x).astype(jnp.bfloat16)), p)
    enc = lstm_encoder.pack_encoder_weights(params_from_jax(p)["rnn"])
    R = CFG.rnn_size
    for L, jl in enumerate(p["rnn"]["layers"]):
        slab = enc["slabs"][L]
        k_in = CFG.embed_dim if L == 0 else R
        assert slab.dtype == BF16 and slab.is_contiguous()
        assert slab.shape == (R, 4, (16 if L == 0 else R) + R)
        wi, pad, wh = unpack_slab(slab, k_in)
        assert torch.equal(wi.view(torch.int16), jax_bits(jl["wi"]))
        assert torch.equal(wh.view(torch.int16), jax_bits(jl["wh"]))
        assert torch.all(pad == 0) and pad.shape[0] == (6 if L == 0 else 0)
        want_bias = (jax_bits(jl["bi"]).view(BF16).float()
                     + jax_bits(jl["bh"]).view(BF16).float()).reshape(4, R).T
        assert torch.equal(enc["bias"][L], want_bias)
        for k in ("wi", "bi", "wh", "bh"):   # the plain version's bf16 weights
            assert torch.equal(enc["layers"][L][k].view(torch.int16), jax_bits(jl[k]))


def sliced_encode(enc, cfg, emb, lengths, plan):
    """The kernel's split of the work in plain PyTorch: each row group's CTAs
    compute the gates of their own units from their slab slices, on the
    stacked bf16 operand [x_t | pad | h_{t-1}] (layer 0) or [h0_t | h1_{t-1}]
    (layer 1), and run the cell for them; h meets in bf16 between steps."""
    B, T, E = emb.shape
    R, L = cfg.rnn_size, cfg.rnn_layers
    pad = enc["slabs"][0].shape[2] - R - E
    rows = plan.row_groups * plan.rows
    out = torch.zeros(B, 2 * L * R)
    for r0 in range(0, B, rows):
        for g in range(plan.row_groups):
            rs = slice(min(B, r0 + g * plan.rows), min(B, r0 + (g + 1) * plan.rows))
            n = rs.stop - rs.start
            h = [torch.zeros(n, R, dtype=BF16) for _ in range(L)]
            c = [torch.zeros(n, R) for _ in range(L)]
            for t in range(T):
                x = torch.cat([emb[rs, t].to(BF16), torch.zeros(n, pad, dtype=BF16)], 1)
                for layer in range(L):
                    a = torch.cat([x, h[layer]], 1).float()
                    new_h = torch.empty(n, R)
                    for cta in range(plan.ctas // plan.row_groups):
                        grp, units = plan.cta_units(R, g * (R // plan.units) + cta)
                        assert grp == g
                        u = slice(units.start, units.stop)
                        w = enc["slabs"][layer][u].float()            # [U, 4, K]
                        gates = torch.einsum("bk,ugk->bug", a, w) + enc["bias"][layer][u]
                        i_g, f_g, o_g = torch.sigmoid(gates[..., :3]).unbind(-1)
                        c[layer][:, u] = f_g * c[layer][:, u] + i_g * torch.tanh(gates[..., 3])
                        new_h[:, u] = o_g * torch.tanh(c[layer][:, u])
                    h[layer] = new_h.to(BF16)
                    take = lengths[rs] == t + 1
                    out[rs.start:rs.stop][take, 2 * layer * R:(2 * layer + 1) * R] = c[layer][take]
                    out[rs.start:rs.stop][take, (2 * layer + 1) * R:(2 * layer + 2) * R] = \
                        new_h[take]
                    x = h[layer]
    return out


@pytest.mark.parametrize("n_sm,row_groups", [(132, None), (4, 1), (8, 2)])
def test_gates_from_the_slabs_match_the_plain_and_pallas_encoders(n_sm, row_groups):
    p, tokens, lengths = setup(40, seed=2)
    tp = params_from_jax(p)
    enc = lstm_encoder.pack_encoder_weights(tp["rnn"])
    emb = embed_question(tp, torch.as_tensor(tokens))
    lengths_t = torch.as_tensor(lengths)
    plan = lstm_encoder.lstm_plan(40, CFG.embed_dim, CFG.rnn_size, CFG.rnn_layers, n_sm,
                                  row_groups=row_groups)
    got = sliced_encode(enc, CFG, emb, lengths_t, plan)
    plain = lstm_encoder.lstm_encode_reference(enc, CFG, emb, lengths_t, dot_dtype=BF16)
    # the same bf16 operands, float32 sums in another order
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5)
    want = j_encode_fused(p, JCFG, jnp.asarray(tokens), jnp.asarray(lengths), block_b=8,
                          interpret=True)
    # the bar of test_lstm_encode_reference_bf16_matches_pallas_interpret
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("R", [32, 256, 512])
@pytest.mark.parametrize("B", [1, 2, 17, 512, 1024])
def test_plan_owns_every_unit_once_and_fits_shared_memory(B, R):
    n_sm = 132
    for L in (1, 2):
        plan = lstm_encoder.lstm_plan(B, 200, R, L, n_sm)
        assert plan.ctas <= n_sm and plan.ctas == plan.row_groups * (R // plan.units)
        assert plan.smem == lstm_encoder.smem_bytes(plan.units, 200, R, L, plan.splits,
                                                    plan.rows)
        assert plan.smem <= lstm_encoder.SMEM_LIMIT <= 227 * 1024
        assert plan.rows % lstm_encoder.ROWS == 0 and 1 <= plan.splits <= 8
        assert plan.passes * plan.row_groups * plan.rows >= B
        assert (plan.passes - 1) * plan.row_groups * plan.rows < B
        owned = {}
        for cta in range(plan.ctas):
            grp, units = plan.cta_units(R, cta)
            for u in units:
                owned[(grp, u)] = owned.get((grp, u), 0) + 1
        assert owned == {(g, u): 1 for g in range(plan.row_groups) for u in range(R)}
    # about one CTA a SM whatever B, at the flagship widths
    if R == 512:
        assert plan.ctas == 128


def test_plan_rejects_shapes_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="shared memory"):
        lstm_encoder.lstm_plan(4, 20000, 512, 2, 132)
    with pytest.raises(ValueError, match="multiple of 32"):
        lstm_encoder.lstm_plan(4, 200, 48, 2, 132)
    with pytest.raises(ValueError, match="1 or 2 layers"):
        lstm_encoder.lstm_plan(4, 200, 512, 3, 132)
    with pytest.raises(ValueError, match="SMs"):
        lstm_encoder.lstm_plan(4, 200, 512, 2, 16)


def test_plan_takes_rows_beyond_one_pass_in_further_passes():
    plan = lstm_encoder.lstm_plan(100_000, 200, 512, 2, 132)
    assert plan.passes > 1 and plan.splits == 1
    assert plan.smem <= lstm_encoder.SMEM_LIMIT
