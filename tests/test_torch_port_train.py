"""The port's losses, optimizers and train step (rau_vqa_tpu_torch/train)
against the JAX package's (rau_vqa_tpu/train), on the CPU in float32.

Bars: losses and optimizers to float32 rounding (rtol 1e-6); the train step
at rtol 2e-3 (ROADMAP.md queue 1, item 4), since its grads pass through two
frameworks' different summation orders before clip and Adam.  Inputs come
from numpy with a seed and reach both packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rau_vqa_tpu.config import ModelConfig as JaxModelConfig
from rau_vqa_tpu.config import TrainConfig as JaxTrainConfig
from rau_vqa_tpu.config import get_preset as jax_get_preset
from rau_vqa_tpu.models import rau as jrau
from rau_vqa_tpu.train import losses as jlosses
from rau_vqa_tpu.train import optim as joptim
from rau_vqa_tpu.train import trainer as jtrainer
from rau_vqa_tpu_torch import config as tconfig
from rau_vqa_tpu_torch.convert import map_tree, params_from_jax, tree_leaves
from rau_vqa_tpu_torch.train import losses as tlosses
from rau_vqa_tpu_torch.train import optim as toptim
from rau_vqa_tpu_torch.train import trainer as ttrainer

# the small configuration of tests/test_pallas_train.py, fused, dropout off
JCFG = JaxModelConfig(
    vocab_size=50, answer_size=17, seq_len=9, embed_dim=8, rnn_size=16,
    rnn_layers=2, cnn_dim=12, cnn_w=3, cnn_h=2, multfeat_dim=16,
    attfeat_dim=8, att_rnn_size=16, att_rnn_layers=1, n_hops=3,
    fused_train=True, embed_dropout=0.0, rnn_dropout=0.0, mult_dropout=0.0)
PRESETS = ["ours_ss", "ours_ms", "ours_full", "ours_resnet", "ours_resnet_ft",
           "ours_vit"]


def port_model_cfg(jcfg, **kw):
    names = {f.name for f in dataclasses.fields(tconfig.ModelConfig)}
    names.discard("fused_train_bwd")      # the port's default differs
    return tconfig.ModelConfig(**{**{n: getattr(jcfg, n) for n in names}, **kw})


def port_train_cfg(jtcfg):
    names = {f.name for f in dataclasses.fields(tconfig.TrainConfig)}
    return tconfig.TrainConfig(**{n: getattr(jtcfg, n) for n in names})


def t(x):
    return torch.as_tensor(np.array(x))


def close(got, want, rtol=1e-6, atol=1e-7, msg=""):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                               np.asarray(want), rtol=rtol, atol=atol, err_msg=msg)


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", PRESETS)
def test_train_presets_match_jax(name):
    mcfg, tcfg = tconfig.get_train_preset(name)
    jexp = jax_get_preset(name)
    assert mcfg == port_model_cfg(jexp.model)
    assert tcfg == port_train_cfg(jexp.train)
    assert tconfig.get_preset(name) is mcfg


def test_fused_train_bwd_defaults_to_the_kernel():
    assert tconfig.ModelConfig().fused_train_bwd == "kernel"
    assert JaxModelConfig().fused_train_bwd == "xla"


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_joint_loss_and_metrics_match_jax(seed):
    rs = np.random.RandomState(seed)
    H, B, A = 4, 12, 7
    scores = rs.randn(H, B, A).astype(np.float32) * 2
    do_pred = rs.uniform(0, 1, (H, B)).astype(np.float32)
    labels = rs.randint(0, A, B).astype(np.int32)
    labels[:4] = scores[1, :4].argmax(-1)          # some hops answer right
    hop_scale = np.asarray([1.0, 0.0, 2.0, 1.0], np.float32)
    jl, jm = jlosses.joint_loss_and_metrics(jnp.asarray(scores), jnp.asarray(do_pred),
                                            jnp.asarray(labels), jnp.asarray(hop_scale))
    s = t(scores).requires_grad_()
    tl, tm = tlosses.joint_loss_and_metrics(s, t(do_pred), t(labels), t(hop_scale))
    close(tl, jl)
    assert set(tm) == set(jm) and len(tm) == 11
    for k in jm:
        close(tm[k], jm[k], msg=k)
    # only the weighted per-hop CE carries gradient
    jg = jax.grad(lambda x: jlosses.joint_loss_and_metrics(
        x, jnp.asarray(do_pred), jnp.asarray(labels), jnp.asarray(hop_scale))[0])(
        jnp.asarray(scores))
    tl.backward()
    close(s.grad, jg)
    assert torch.all(s.grad[1] == 0)


@pytest.mark.parametrize("epoch", [1, 16, 17, 25, 26, 35, 36, 50])
@pytest.mark.parametrize("name", ["ours_ss", "ours_ms", "ours_full", "ours_resnet"])
def test_hop_grad_scale_matches_jax(name, epoch):
    mcfg, tcfg = tconfig.get_train_preset(name)
    kw = dict(scale_by_nhop=tcfg.hop_grad_scale_nhop,
              stop_timing=tcfg.hop_stop_timing, epoch=epoch)
    got = tlosses.hop_grad_scale(mcfg.n_hops, **kw)
    want = jlosses.hop_grad_scale(mcfg.n_hops, **kw)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bce_and_cross_entropy_match_jax():
    rs = np.random.RandomState(3)
    logits = rs.randn(9, 5).astype(np.float32)
    labels = rs.randint(0, 5, 9).astype(np.int32)
    p = np.concatenate([[0.0, 1.0], rs.uniform(0, 1, 7)]).astype(np.float32)
    y = (rs.uniform(0, 1, 9) > 0.5).astype(np.float32)
    close(tlosses.cross_entropy(t(logits), t(labels)),
          jlosses.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    close(tlosses.bce(t(p), t(y)), jlosses.bce(jnp.asarray(p), jnp.asarray(y)))


# ---------------------------------------------------------------------------
# optimizers and the gradient pipeline
# ---------------------------------------------------------------------------

def _trees(seed=0):
    rs = np.random.RandomState(seed)
    params = {"a": rs.randn(6, 5).astype(np.float32),
              "b": [{"w": rs.randn(4).astype(np.float32)}]}
    grads = [map_tree(lambda x: (rs.randn(*x.shape) * 0.1).astype(np.float32), params)
             for _ in range(2)]
    return params, grads


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _ttree(tree):
    return map_tree(lambda x: torch.as_tensor(np.asarray(x)), tree)


def _close_trees(got, want, **kw):
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        close(g, w, **kw)


OPTIMIZERS = {
    "adam": (lambda p: joptim.adam_init(p), lambda p: toptim.adam_init(p),
             lambda p, g, s: joptim.adam_update(p, g, jnp.float32(3e-3), s),
             lambda p, g, s: toptim.adam_update(p, g, 3e-3, s)),
    "sgd": (lambda p: None, lambda p: None,
            lambda p, g, s: (joptim.sgd_update(p, g, 0.1), None),
            lambda p, g, s: (toptim.sgd_update(p, g, 0.1), None)),
    "sgdm": (joptim.sgdm_init, toptim.sgdm_init,
             lambda p, g, s: joptim.sgdm_update(p, g, 0.1, 0.9, s),
             lambda p, g, s: toptim.sgdm_update(p, g, 0.1, 0.9, s)),
    "sgdmom": (joptim.sgdmom_init, toptim.sgdmom_init,
               lambda p, g, s: joptim.sgdmom_update(p, g, 0.1, 0.9, s),
               lambda p, g, s: toptim.sgdmom_update(p, g, 0.1, 0.9, s)),
    "adagrad": (joptim.adagrad_init, toptim.adagrad_init,
                lambda p, g, s: joptim.adagrad_update(p, g, 0.1, 1e-8, s),
                lambda p, g, s: toptim.adagrad_update(p, g, 0.1, 1e-8, s)),
    "rmsprop": (joptim.rmsprop_init, toptim.rmsprop_init,
                lambda p, g, s: joptim.rmsprop_update(p, g, 0.1, 0.95, 1e-8, s),
                lambda p, g, s: toptim.rmsprop_update(p, g, 0.1, 0.95, 1e-8, s)),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_jax(name):
    j_init, t_init, j_upd, t_upd = OPTIMIZERS[name]
    params, grads = _trees()
    jp, tp = _jtree(params), _ttree(params)
    js, ts = j_init(jp), t_init(tp)
    for g in grads:                     # two steps: the state carries over
        jp, js = j_upd(jp, _jtree(g), js)
        tp, ts = t_upd(tp, _ttree(g), ts)
        _close_trees(tp, jp)
    if name == "adam":
        assert int(ts["t"]) == int(js["t"]) == 2
        _close_trees(ts["m"], js["m"])
        _close_trees(ts["v"], js["v"])


@pytest.mark.parametrize("max_norm", [0.1, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    _, grads = _trees(1)
    jc, jn = joptim.clip_by_global_norm(_jtree(grads[0]), max_norm)
    tc, tn = toptim.clip_by_global_norm(_ttree(grads[0]), max_norm)
    close(tn, jn)
    close(toptim.tree_norm(_ttree(grads[0])), joptim.tree_norm(_jtree(grads[0])))
    _close_trees(tc, jc)


@pytest.mark.parametrize("tau", [1e-3, 10.0])
def test_trust_ratio_cap_matches_jax(tau):
    params, grads = _trees(2)
    new = map_tree(lambda p, g: p - g, params, grads[0])
    want = joptim.trust_ratio_cap(_jtree(new), _jtree(params), tau)
    got = toptim.trust_ratio_cap(_ttree(new), _ttree(params), tau)
    _close_trees(got, want)


def test_gradient_noise_has_the_stated_std():
    """gamma multiplies: std = sqrt(eta / ((step + 1) * gamma))."""
    grads = {"w": torch.zeros(400, 500), "b": [torch.zeros(1000)]}
    step, eta, gamma = 3, 0.01, 0.55
    noised = toptim.add_gradient_noise(grads, torch.Generator().manual_seed(0),
                                       step, eta, gamma)
    x = torch.cat([v.flatten() for v in tree_leaves(noised)])
    std = (eta / ((step + 1) * gamma)) ** 0.5
    assert abs(x.std().item() / std - 1.0) < 0.01
    assert abs(x.mean().item()) < 0.01 * std
    again = toptim.add_gradient_noise(grads, torch.Generator().manual_seed(0),
                                      step, eta, gamma)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(noised), tree_leaves(again)))


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _batch(B=8, seed=0):
    rs = np.random.RandomState(seed)
    lengths = rs.randint(1, JCFG.seq_len + 1, B).astype(np.int32)
    tokens = np.zeros((B, JCFG.seq_len), np.int32)
    for k in range(B):
        tokens[k, :lengths[k]] = rs.randint(1, JCFG.vocab_size, lengths[k])
    feats = rs.randn(B, JCFG.cnn_spat, JCFG.cnn_dim).astype(np.float32)
    labels = rs.randint(0, JCFG.answer_size, B).astype(np.int32)
    return tokens, lengths, feats, labels


def _jax_state():
    return jtrainer.init_train_state(jax.random.PRNGKey(0), JCFG)


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
        close(g, w, rtol=rtol, atol=atol, msg=jax.tree_util.keystr(path))


def test_loss_and_grads_match_jax():
    tokens, lengths, feats, labels = _batch()
    hop_scale = np.ones(JCFG.n_hops, np.float32)
    jstate = _jax_state()

    def jloss(p):
        o = jrau.rau_forward(p, JCFG, jnp.asarray(tokens), jnp.asarray(lengths),
                        jnp.asarray(feats), train=True)
        return jlosses.joint_loss_and_metrics(o.scores, o.do_pred, jnp.asarray(labels),
                                              jnp.asarray(hop_scale))[0]

    jg = jax.jit(jax.grad(jloss))(jstate.params)
    grads, metrics = ttrainer.loss_and_grads(
        port_model_cfg(JCFG), _port_state(jstate).params, t(tokens), t(lengths),
        t(feats), t(labels), t(hop_scale), hop_seed=0)
    _assert_paths_close(grads, jg, rtol=2e-3, atol=1e-6)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(accum):
    """One step, all dropout off, noisy_eta 0: every metric, the new
    parameters and the Adam moments (m holds the clipped grads) agree."""
    jtcfg = JaxTrainConfig(noisy_eta=0.0, grad_accum=accum)
    tokens, lengths, feats, labels = _batch()
    hop_scale = np.asarray([1.0, 0.0, 1.0], np.float32)
    jstate = _jax_state()
    jstep = jax.jit(jtrainer.make_train_step(JCFG, jtcfg))
    jnew, jm = jstep(jstate, *(jnp.asarray(a) for a in (tokens, lengths, feats,
                                                          labels, hop_scale)),
                     jnp.float32(3e-3), jnp.float32(3e-4))
    step = ttrainer.make_train_step(port_model_cfg(JCFG), port_train_cfg(jtcfg),
                                    device="cpu")
    new, tm = step(_port_state(jstate), tokens, lengths, feats, labels, hop_scale,
                   3e-3, 3e-4)
    assert set(tm) == set(jm)
    for k in jm:
        close(tm[k], jm[k], rtol=2e-3, atol=1e-6, msg=k)
    assert new.step == 1
    _assert_paths_close(new.params, jnew.params, rtol=2e-3, atol=1e-6)
    for g in ttrainer.PARAM_GROUPS:
        _assert_paths_close(new.opt[g]["m"], jnew.opt[g]["m"], rtol=2e-3, atol=1e-8)


def test_train_step_is_a_function_of_its_state():
    """Dropout and noise on: the same state gives the same step; the next
    step draws other masks and noise."""
    mcfg = port_model_cfg(JCFG, mult_dropout=0.5, embed_dropout=0.5,
                          rnn_dropout=0.5)
    tcfg = tconfig.TrainConfig()
    step = ttrainer.make_train_step(mcfg, tcfg, device="cpu")
    state = ttrainer.init_train_state(mcfg, 5, device="cpu")
    batch = _batch() + (np.ones(JCFG.n_hops, np.float32), 3e-3, 3e-4)
    a, ma = step(state, *batch)
    b, mb = step(state, *batch)
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(x, y)
    c, mc = step(a, *batch)
    assert mc["grad_norm_mult"].item() != ma["grad_norm_mult"].item()
    for m in (ma, mc):
        assert all(torch.isfinite(v).all() for v in m.values())


def test_make_train_step_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mcfg = port_model_cfg(JCFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrainer.make_train_step(mcfg, tconfig.TrainConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrainer.init_train_state(mcfg, 0)


@pytest.mark.parametrize("mchange,tchange,kw", [
    ({}, dict(train_backbone=True), {}),
    ({}, {}, dict(img_repeat=2))])
def test_make_train_step_refuses_unported_paths(mchange, tchange, kw):
    mcfg = port_model_cfg(JCFG, **mchange)
    tcfg = dataclasses.replace(tconfig.TrainConfig(), **tchange)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttrainer.make_train_step(mcfg, tcfg, device="cpu", **kw)


def test_grad_accum_needs_a_divisible_batch():
    step = ttrainer.make_train_step(port_model_cfg(JCFG),
                                    tconfig.TrainConfig(grad_accum=3), device="cpu")
    state = ttrainer.init_train_state(port_model_cfg(JCFG), 0, device="cpu")
    with pytest.raises(ValueError, match="grad_accum"):
        step(state, *_batch(), np.ones(JCFG.n_hops, np.float32), 3e-3, 3e-4)
