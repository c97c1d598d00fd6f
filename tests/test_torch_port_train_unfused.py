"""The port's unfused training path (rau_vqa_tpu_torch/models/rau.py,
``fused_train=False``, the presets' default) against the JAX package's
(rau_vqa_tpu/models/rau.py:305-346), on the CPU in float32.

With all dropout off both packages compute the same function, so the grads,
one step's params and the Adam moments are held at the bars of the fused
step's tests (tests/test_torch_port_train.py: rtol 2e-3, the grads pass
through two frameworks' summation orders before clip and Adam): with a 1-
and a 2-layer ATTLSTM, with and without ``remat_hops``, and for the fused
configuration (JAX's with ``fused_train_impl="reference"``, the port's with
its plain versions, as on every CPU tensor).  Masks come from
``torch.Generator`` and cannot match ``jax.random``'s bits, so with dropout
on the tests hold the port to itself: a step is a function of its state,
each hop draws its own masks, and ``remat_hops`` recomputes the same masks.
Inputs come from numpy with a seed."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rau_vqa_tpu.config import ModelConfig as JaxModelConfig
from rau_vqa_tpu.config import TrainConfig as JaxTrainConfig
from rau_vqa_tpu.models import rau as jrau
from rau_vqa_tpu.train import losses as jlosses
from rau_vqa_tpu.train import trainer as jtrainer
from rau_vqa_tpu_torch import config as tconfig
from rau_vqa_tpu_torch.convert import params_from_jax, tree_leaves
from rau_vqa_tpu_torch.models import cells as tcells
from rau_vqa_tpu_torch.models import rau as trau
from rau_vqa_tpu_torch.train import optim as toptim
from rau_vqa_tpu_torch.train import trainer as ttrainer

# the small configuration of tests/test_pallas_train.py, unfused, dropout off
JCFG = JaxModelConfig(
    vocab_size=50, answer_size=17, seq_len=9, embed_dim=8, rnn_size=16,
    rnn_layers=2, cnn_dim=12, cnn_w=3, cnn_h=2, multfeat_dim=16,
    attfeat_dim=8, att_rnn_size=16, att_rnn_layers=1, n_hops=3,
    embed_dropout=0.0, rnn_dropout=0.0, mult_dropout=0.0)
ALL_DROPOUT = dict(embed_dropout=0.5, rnn_dropout=0.5, mult_dropout=0.5,
                   att_rnn_dropout=0.3)
# (att_rnn_layers, remat_hops, fused_train, the JAX side's fused_train_impl)
VARIANTS = [(1, False, False, "pallas"), (1, True, False, "pallas"),
            (2, False, False, "pallas"), (2, True, False, "pallas"),
            (1, False, True, "reference")]


def port_cfg(jcfg, **kw):
    names = {f.name for f in dataclasses.fields(tconfig.ModelConfig)}
    names.discard("fused_train_bwd")      # the port's default differs
    return tconfig.ModelConfig(**{**{n: getattr(jcfg, n) for n in names}, **kw})


def port_train_cfg(jtcfg):
    names = {f.name for f in dataclasses.fields(tconfig.TrainConfig)}
    return tconfig.TrainConfig(**{n: getattr(jtcfg, n) for n in names})


def jax_cfg(variant):
    layers, remat, fused, impl = variant
    return dataclasses.replace(JCFG, att_rnn_layers=layers, remat_hops=remat,
                               fused_train=fused, fused_train_impl=impl)


def _batch(B=8, seed=0):
    rs = np.random.RandomState(seed)
    lengths = rs.randint(1, JCFG.seq_len + 1, B).astype(np.int32)
    tokens = np.zeros((B, JCFG.seq_len), np.int32)
    for k in range(B):
        tokens[k, :lengths[k]] = rs.randint(1, JCFG.vocab_size, lengths[k])
    feats = rs.randn(B, JCFG.cnn_spat, JCFG.cnn_dim).astype(np.float32)
    labels = rs.randint(0, JCFG.answer_size, B).astype(np.int32)
    return tokens, lengths, feats, labels


def _port_state(jstate):
    params = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    return ttrainer.TrainState(
        params, {g: toptim.adam_init(params[g]) for g in ttrainer.PARAM_GROUPS},
        step=0, seed=0)


def _assert_paths_close(got, want, rtol, atol):
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        g = got
        for k in path:
            g = g[k.key if hasattr(k, "key") else k.idx]
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=rtol,
                                   atol=atol, err_msg=jax.tree_util.keystr(path))


def t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("variant", VARIANTS, ids=lambda v: "-".join(map(str, v)))
def test_loss_and_grads_match_jax(variant):
    jcfg = jax_cfg(variant)
    tokens, lengths, feats, labels = _batch()
    hop_scale = np.ones(JCFG.n_hops, np.float32)
    jstate = jtrainer.init_train_state(jax.random.PRNGKey(0), jcfg)

    def jloss(p):
        # JAX's unfused hops derive their keys from rng even without dropout
        o = jrau.rau_forward(p, jcfg, jnp.asarray(tokens), jnp.asarray(lengths),
                             jnp.asarray(feats), train=True, rng=jax.random.PRNGKey(0))
        return jlosses.joint_loss_and_metrics(o.scores, o.do_pred, jnp.asarray(labels),
                                              jnp.asarray(hop_scale))[0]

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jstate.params)
    grads, metrics = ttrainer.loss_and_grads(
        port_cfg(jcfg), _port_state(jstate).params, t(tokens), t(lengths),
        t(feats), t(labels), t(hop_scale), hop_seed=0)
    np.testing.assert_allclose(metrics["loss"].item(), float(jl), rtol=1e-5)
    _assert_paths_close(grads, jg, rtol=2e-3, atol=1e-6)
    if variant[0] == 2:   # the second ATTLSTM layer is on the path
        assert grads["mult"]["attlstm"]["layers"][1]["wh"].abs().max() > 0


@pytest.mark.parametrize("variant", VARIANTS, ids=lambda v: "-".join(map(str, v)))
def test_train_step_matches_jax(variant):
    """One step, all dropout off, noisy_eta 0: every metric, the new
    parameters and the Adam moments (m holds the clipped grads) agree."""
    jcfg = jax_cfg(variant)
    jtcfg = JaxTrainConfig(noisy_eta=0.0)
    tokens, lengths, feats, labels = _batch(seed=1)
    hop_scale = np.asarray([1.0, 0.0, 1.0], np.float32)
    jstate = jtrainer.init_train_state(jax.random.PRNGKey(1), jcfg)
    jstep = jax.jit(jtrainer.make_train_step(jcfg, jtcfg))
    jnew, jm = jstep(jstate, *(jnp.asarray(a) for a in (tokens, lengths, feats,
                                                          labels, hop_scale)),
                     jnp.float32(3e-3), jnp.float32(3e-4))
    step = ttrainer.make_train_step(port_cfg(jcfg), port_train_cfg(jtcfg), device="cpu")
    new, tm = step(_port_state(jstate), tokens, lengths, feats, labels, hop_scale,
                   3e-3, 3e-4)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(np.asarray(tm[k]), np.asarray(jm[k]), rtol=2e-3,
                                   atol=1e-6, err_msg=k)
    _assert_paths_close(new.params, jnew.params, rtol=2e-3, atol=1e-6)
    for g in ttrainer.PARAM_GROUPS:
        _assert_paths_close(new.opt[g]["m"], jnew.opt[g]["m"], rtol=2e-3, atol=1e-8)


def _dropout_cfg(**kw):
    return port_cfg(JCFG, **{**ALL_DROPOUT, "att_rnn_layers": 2, **kw})


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_with_dropout_is_a_function_of_its_state(remat):
    """Every dropout on (att_rnn_dropout too, two ATTLSTM layers) and the
    gradient noise: the same state gives the same step; the next step draws
    other masks and noise; the metrics are finite."""
    mcfg = _dropout_cfg(remat_hops=remat)
    step = ttrainer.make_train_step(mcfg, tconfig.TrainConfig(), device="cpu")
    state = ttrainer.init_train_state(mcfg, 5, device="cpu")
    batch = _batch() + (np.ones(JCFG.n_hops, np.float32), 3e-3, 3e-4)
    a, ma = step(state, *batch)
    b, _ = step(state, *batch)
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(x, y)
    c, mc = step(a, *batch)
    assert mc["grad_norm_mult"].item() != ma["grad_norm_mult"].item()
    for m in (ma, mc):
        assert all(torch.isfinite(v).all() for v in m.values())


def test_each_hop_draws_its_own_masks(monkeypatch):
    """In each hop the features, the question, both ATTLSTM layers' inputs,
    the LSTM's output and the merged feature are dropped, in that order,
    under masks that differ from hop to hop."""
    drawn = []
    plain_dropout = tcells.dropout

    def recording(x, rate, generator, train, rows=None):
        y = plain_dropout(x, rate, generator, train, rows)
        if train and rate > 0.0:
            drawn.append((tuple(x.shape), rate, y != 0))
        return y

    monkeypatch.setattr(trau, "dropout", recording)
    monkeypatch.setattr(tcells, "dropout", recording)
    mcfg = _dropout_cfg(embed_dropout=0.0, rnn_dropout=0.0)
    tokens, lengths, feats, _ = _batch()
    p = params_from_jax(jax.tree.map(np.asarray, jrau.init_params(
        jax.random.PRNGKey(0), jax_cfg((2, False, False, "pallas")))))
    trau.rau_forward(p, mcfg, t(tokens), t(lengths), t(feats), train=True,
                     generator=torch.Generator().manual_seed(0))
    B, S, Dc, Q = 8, JCFG.cnn_spat, JCFG.cnn_dim, JCFG.rnnout_dim
    M, R = JCFG.multfeat_dim, JCFG.att_rnn_size
    per_hop = [((B, S, Dc), 0.5), ((B, Q), 0.5), ((B, M), 0.3), ((B, R), 0.3),
               ((B, 2 * R), 0.3), ((B, M), 0.5)]
    assert [(shape, rate) for shape, rate, _ in drawn] == per_hop * JCFG.n_hops
    for site in range(len(per_hop)):
        masks = [m for _, _, m in drawn[site::len(per_hop)]]
        for i in range(len(masks)):
            for j in range(i):
                assert not torch.equal(masks[i], masks[j]), (per_hop[site], i, j)


def test_remat_hops_gives_the_same_grads():
    """remat_hops recomputes each hop in the backward under the masks it
    drew in the forward: with every dropout on, the grads equal those
    without remat."""
    tokens, lengths, feats, labels = _batch()
    params = ttrainer.init_train_state(_dropout_cfg(), 3, device="cpu").params
    grads = {}
    for remat in (False, True):
        grads[remat], _ = ttrainer.loss_and_grads(
            _dropout_cfg(remat_hops=remat), params, t(tokens), t(lengths), t(feats),
            t(labels), torch.ones(JCFG.n_hops),
            generator=torch.Generator().manual_seed(11))
    for x, y in zip(tree_leaves(grads[False]), tree_leaves(grads[True])):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert grads[True]["mult"]["i_embed"]["w"].abs().max() > 0


def test_unfused_dropout_needs_a_generator():
    tokens, lengths, feats, _ = _batch(2)
    p = params_from_jax(jax.tree.map(np.asarray, jrau.init_params(
        jax.random.PRNGKey(0), JCFG)))
    with pytest.raises(ValueError, match="generator"):
        trau.rau_forward(p, port_cfg(JCFG, att_rnn_dropout=0.2), t(tokens),
                         t(lengths), t(feats), train=True)


@pytest.mark.parametrize("change", [
    {}, dict(remat_hops=True), dict(compute_dtype="bfloat16", fused_train=True),
    dict(compute_dtype="bfloat16")],
    ids=["as_shipped", "remat_hops", "bf16_fused", "bf16_unfused"])
def test_ours_ms_preset_takes_a_step(change):
    """make_train_step(*get_train_preset("ours_ms"), device="cpu") at the
    preset's full widths, on a batch of 2 questions of up to 6 tokens."""
    mcfg, tcfg = tconfig.get_train_preset("ours_ms")
    mcfg = dataclasses.replace(mcfg, **change)
    step = ttrainer.make_train_step(mcfg, tcfg, device="cpu")
    state = ttrainer.init_train_state(mcfg, 0, device="cpu")
    rs = np.random.RandomState(0)
    tokens = np.zeros((2, mcfg.seq_len), np.int64)
    tokens[:, :6] = rs.randint(1, mcfg.vocab_size, (2, 6))
    lengths = np.asarray([6, 3], np.int32)
    feats = rs.rand(2, mcfg.cnn_spat, mcfg.cnn_dim).astype(np.float32)
    new, metrics = step(state, tokens, lengths, feats, np.asarray([3, 7]),
                        np.ones(mcfg.n_hops, np.float32), 3e-3, 3e-4)
    assert new.step == 1
    assert all(torch.isfinite(v).all() for v in metrics.values())
    assert all(x.dtype == torch.float32 for x in tree_leaves(new.params))
    assert not torch.equal(new.params["mult"]["cls"]["w"], state.params["mult"]["cls"]["w"])
