"""The port's training hop loop (rau_vqa_tpu_torch/ops/rau_train_hops.py)
and training forward (models/rau.py, train=True) against the JAX package,
on the CPU in float32, at the small configuration of
tests/test_pallas_train.py (B=8).

The JAX side runs its plain references (``rau_train_hops_reference`` and
``jax.grad`` through it), never the Pallas interpreter.  On the CPU the
port's ``rau_train_hops`` runs the kernels' plain versions: the forward's,
and with ``fused_train_bwd="kernel"`` the hand-derived backward (reverse hop
loop from the saved carries plus the outside products); with ``"xla"``
autograd through the port's reference.  Inputs come from numpy with a seed.

Bars: forward rtol 1e-5 (tests/test_pallas_train.py:97-106); grads rtol
2e-4 / atol 1e-5 (:153-155).  The two frameworks sum in different orders,
which these bars absorb at this size.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rau_vqa_tpu.config import ModelConfig as JaxModelConfig
from rau_vqa_tpu.models import rau as jrau
from rau_vqa_tpu.ops import rau_train_hops as jth
from rau_vqa_tpu_torch import config as tconfig
from rau_vqa_tpu_torch.convert import map_tree, params_from_jax
from rau_vqa_tpu_torch.models import rau as trau
from rau_vqa_tpu_torch.ops import rau_train_hops as tth

JCFG = JaxModelConfig(
    vocab_size=50, answer_size=17, seq_len=9, embed_dim=8, rnn_size=16,
    rnn_layers=2, cnn_dim=12, cnn_w=3, cnn_h=2, multfeat_dim=16,
    attfeat_dim=8, att_rnn_size=16, att_rnn_layers=1, n_hops=3)
B = 8
SEED = 12345


def port_cfg(jcfg, **kw):
    names = {f.name for f in dataclasses.fields(tconfig.ModelConfig)}
    names.discard("fused_train_bwd")      # the port's default differs
    return tconfig.ModelConfig(**{**{n: getattr(jcfg, n) for n in names}, **kw})


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(7)
    params = jax.tree.map(np.asarray, jrau.init_params(jax.random.PRNGKey(0), JCFG))
    q = rs.randn(B, JCFG.rnnout_dim).astype(np.float32)
    feats = rs.randn(B, JCFG.cnn_spat, JCFG.cnn_dim).astype(np.float32)
    labels = rs.randint(0, JCFG.answer_size, B).astype(np.int32)
    lengths = rs.randint(1, JCFG.seq_len + 1, B).astype(np.int32)
    tokens = np.zeros((B, JCFG.seq_len), np.int32)
    for k in range(B):
        tokens[k, :lengths[k]] = rs.randint(1, JCFG.vocab_size, lengths[k])
    return params, q, feats, labels, tokens, lengths


HOP_W = np.asarray([1.0 + 0.5 * h for h in range(JCFG.n_hops)], np.float32)


def jax_loss(scores, labels):
    # distinct per-hop weights catch hop-mixing bugs in the reverse loop
    logp = jax.nn.log_softmax(scores, axis=-1)
    nll = -jnp.take_along_axis(logp, jnp.asarray(labels)[None, :, None], -1)[..., 0]
    return jnp.sum(jnp.asarray(HOP_W) * jnp.mean(nll, axis=1))


def torch_loss(scores, labels):
    logp = torch.log_softmax(scores, dim=-1)
    idx = torch.as_tensor(labels).long()[None, :, None].expand(scores.shape[0], -1, 1)
    nll = -logp.gather(-1, idx)[..., 0]
    return torch.sum(torch.as_tensor(HOP_W) * nll.mean(1))


def assert_tree_close(got, want_jax, rtol, atol):
    """Every leaf of a JAX grad tree against the port's tree of the same
    paths."""
    for path, w in jax.tree_util.tree_leaves_with_path(want_jax):
        g = got
        for k in path:
            g = g[k.key if hasattr(k, "key") else k.idx]
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=rtol,
                                   atol=atol, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("rate", [0.5, 0.0])
def test_forward_reference_matches_jax(data, rate):
    params, q, feats, *_ = data
    jcfg = dataclasses.replace(JCFG, mult_dropout=rate)
    want = jth.rau_train_hops_reference(params["mult"], jcfg, jnp.asarray(q),
                                        jnp.asarray(feats), jnp.int32(SEED))
    got = tth.rau_train_hops_reference(params_from_jax(params["mult"]),
                                       port_cfg(jcfg), torch.as_tensor(q),
                                       torch.as_tensor(feats), SEED)
    names = ("scores", "do_pred", "attprob", "final_c", "final_h")
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5 if name == "scores" else 1e-6,
                                   err_msg=name)


def test_fused_forward_on_cpu_is_the_plain_version(data):
    params, q, feats, *_ = data
    cfg = port_cfg(JCFG)
    mp = params_from_jax(params["mult"])
    before = (tth.FWD_KERNEL.launches, tth.BWD_KERNEL.launches)
    got = tth.rau_train_hops(mp, cfg, torch.as_tensor(q), torch.as_tensor(feats), SEED)
    want = tth.rau_train_hops_reference(mp, cfg, torch.as_tensor(q),
                                        torch.as_tensor(feats), SEED)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert (tth.FWD_KERNEL.launches, tth.BWD_KERNEL.launches) == before


@pytest.mark.parametrize("bwd", ["kernel", "xla"])
@pytest.mark.parametrize("rate", [0.5, 0.0])
def test_backward_matches_jax_grad(data, bwd, rate):
    """Every leaf of ``mult`` and dq against jax.grad of JAX's reference;
    do_pred's weights get exactly zero, feats nothing."""
    params, q, feats, labels, *_ = data
    jcfg = dataclasses.replace(JCFG, mult_dropout=rate)

    def jloss(mp, q_):
        s = jth.rau_train_hops_reference(mp, jcfg, q_, jnp.asarray(feats),
                                         jnp.int32(SEED))[0]
        return jax_loss(s, labels)

    jl, (gmp, gq) = jax.value_and_grad(jloss, argnums=(0, 1))(
        params["mult"], jnp.asarray(q))

    cfg = port_cfg(jcfg, fused_train_bwd=bwd)
    mp = map_tree(lambda w: w.requires_grad_(), params_from_jax(params["mult"]))
    q_t = torch.as_tensor(q).requires_grad_()
    feats_t = torch.as_tensor(feats).requires_grad_()
    loss = torch_loss(tth.rau_train_hops(mp, cfg, q_t, feats_t, SEED)[0], labels)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    grads = map_tree(lambda w: w.grad, mp)
    assert_tree_close(grads, gmp, rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(q_t.grad.numpy(), np.asarray(gq), rtol=2e-4, atol=1e-5)
    assert torch.all(grads["do_pred"]["w"] == 0) and torch.all(grads["do_pred"]["b"] == 0)
    assert feats_t.grad is None
    assert grads["cls"]["w"].abs().max() > 0


def test_hand_derived_backward_matches_autograd(data):
    """The backward kernel's plain version plus the outside products equal
    autograd through the port's reference, leaf by leaf."""
    params, q, feats, labels, *_ = data
    cfg = port_cfg(JCFG)
    mp = params_from_jax(params["mult"])
    q_t, feats_t = torch.as_tensor(q), torch.as_tensor(feats)
    seed = torch.tensor([SEED], dtype=torch.int32)
    scores, _, attprob, c_all, h_all = tth.train_hops_fwd(mp, cfg, q_t, feats_t, seed)
    s = scores.detach().requires_grad_()
    g_scores, = torch.autograd.grad(torch_loss(s, labels), s)
    got, dq = tth._bwd_kernel(cfg, mp, q_t, feats_t, seed, c_all, h_all,
                              attprob, g_scores)
    want, dq_ref = tth._bwd_autograd(cfg, mp, q_t, feats_t, seed, g_scores)
    assert set(got) == set(want)
    for path in want:
        torch.testing.assert_close(got[path], want[path], rtol=2e-4, atol=1e-6,
                                   msg=str(path))
    torch.testing.assert_close(dq, dq_ref, rtol=2e-4, atol=1e-6)


def test_dropout_is_live_and_seeded(data):
    params, q, feats, *_ = data
    mp = params_from_jax(params["mult"])
    run = [tth.rau_train_hops(mp, port_cfg(JCFG), torch.as_tensor(q),
                              torch.as_tensor(feats), s)[0] for s in (1, 2, 1)]
    assert not torch.equal(run[0], run[1])
    assert torch.equal(run[0], run[2])


@pytest.mark.parametrize("change,error", [
    (dict(att_rnn_dropout=0.3), NotImplementedError),
    (dict(att_rnn_layers=2), NotImplementedError),
    (dict(fused_train_bwd="autodiff"), ValueError)])
def test_rejects_unsupported_config(data, change, error):
    params, q, feats, *_ = data
    cfg = dataclasses.replace(port_cfg(JCFG), **change)
    with pytest.raises(error):
        tth.rau_train_hops(params_from_jax(params["mult"]), cfg,
                           torch.as_tensor(q), torch.as_tensor(feats), SEED)


@pytest.mark.parametrize("bwd", ["kernel", "xla"])
def test_train_forward_matches_jax(data, bwd):
    """rau_forward(train=True, hop_seed=s) with the encoder's dropouts off
    against JAX's encode_question then rau_train_hops_reference(seed=s):
    the loss and the grads of all three groups."""
    params, _, feats, labels, tokens, lengths = data
    jcfg = dataclasses.replace(JCFG, embed_dropout=0.0, rnn_dropout=0.0,
                               fused_train=True)

    def jloss(p):
        q = jrau.encode_question(p, jcfg, jnp.asarray(tokens), jnp.asarray(lengths))
        s = jth.rau_train_hops_reference(p["mult"], jcfg, q, jnp.asarray(feats),
                                         jnp.int32(SEED))[0]
        return jax_loss(s, labels)

    jl, jg = jax.value_and_grad(jloss)(params)

    cfg = port_cfg(jcfg, fused_train_bwd=bwd)
    p = map_tree(lambda w: w.requires_grad_(), params_from_jax(params))
    out = trau.rau_forward(p, cfg, torch.as_tensor(tokens), torch.as_tensor(lengths),
                           torch.as_tensor(feats), train=True, hop_seed=SEED)
    assert not (out.do_pred.requires_grad or out.attprob.requires_grad
                or out.final_c.requires_grad or out.final_h.requires_grad)
    loss = torch_loss(out.scores, labels)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    assert_tree_close(map_tree(lambda w: w.grad, p), jg, rtol=2e-4, atol=1e-5)
    assert p["embed"]["lookup"].grad.abs().max() > 0
    assert p["rnn"]["layers"][0]["wi"].grad.abs().max() > 0


def test_train_forward_dropout_from_generator(data):
    """All dropout on: one generator seed gives one result, another seed
    another; without a generator the call is refused."""
    params, _, feats, _, tokens, lengths = data
    cfg = port_cfg(JCFG, fused_train=True)
    p = params_from_jax(params)
    args = (torch.as_tensor(tokens), torch.as_tensor(lengths), torch.as_tensor(feats))

    def run(seed):
        return trau.rau_forward(p, cfg, *args, train=True,
                                generator=torch.Generator().manual_seed(seed)).scores

    assert torch.equal(run(3), run(3))
    assert not torch.equal(run(3), run(4))
    with pytest.raises(ValueError, match="generator"):
        trau.rau_forward(p, cfg, *args, train=True)
