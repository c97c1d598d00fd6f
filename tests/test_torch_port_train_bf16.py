"""The port's bf16 training path (``compute_dtype="bfloat16"``, the JAX CLI's
``--bf16``) against the JAX package's, on the CPU.

The hop loop (ops/rau_train_hops.py): the port's plain versions round both
operands of every product to bf16 where JAX's ``dot`` / ``dotT`` /
``gradw2`` cast them and sum in float32, so they compute JAX's function up
to the order of float32 sums.  Held at a norm-relative 1e-4 per output and
per grad leaf (forward readings ~1e-8): the forward against JAX's
``rau_train_hops_reference``; the hand-derived backward
(``fused_train_bwd="kernel"``, through the kernels' plain versions here)
against JAX's Pallas backward in interpret mode; autograd through the plain
version (``"xla"``) against ``jax.grad`` of JAX's reference.  The two
backwards round in different places (JAX's transpose of a bf16 product
rounds its output, the hand-derived backward its cotangent operand), so
each is held to its own counterpart.  The port's float32 path on the same
bf16-valued inputs lands beyond 10x the bar.

The inputs: the JAX package's init scaled by 3 (uniform in +-0.24), a numpy
seed for q and the features.  A float32 difference of ~1e-7 between the two
frameworks' sums flips a bf16 rounding now and then: one element moves by
a bf16 ulp (0.4%), and in a leaf of 24 rows that can reach ~1e-3 of its
norm.  Flips come most often from ``dqatt``, the sum over the cells of the
content score's cotangent, which cancels to a small part of its terms when
the attention is near uniform, as it is at the init scale of +-0.08.  These
inputs flip nothing: the grads agree to ~1e-7 or better.

The whole step (encoder included) cannot be held that tightly: XLA rounds
the bf16 encoder at its fusion boundaries, PyTorch after every op, and the
two encoders' outputs differ by ~5e-3 norm-relative, as far as the float32
encoder is from JAX's bf16 one.  So neither the loss nor a norm tells the
bf16 encoder from the float32 one here (on the fused path the float32 loss
is 1e-6 to 1e-5 from JAX's bf16 loss).  What does is bit agreement: the
port's bf16 encoder gives the same bf16 value as JAX's for 50-58% of its
outputs, the float32 encoder rounded to bf16 for 27-35% (readings over six
seeds), and the test holds them on either side of 42%.  The whole step,
fused and unfused, is held to JAX's bf16 loss at 5e-3 relative and to the
float32 step's at 5% (JAX's own bar, tests/test_pallas_train.py:227-242),
with the encoder's output and the scores in JAX's types and every grad
finite.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rau_vqa_tpu.config import ModelConfig as JaxModelConfig
from rau_vqa_tpu.config import TrainConfig as JaxTrainConfig
from rau_vqa_tpu.models import rau as jrau
from rau_vqa_tpu.ops import rau_train_hops as jth
from rau_vqa_tpu.train import trainer as jtrainer
from rau_vqa_tpu_torch import config as tconfig
from rau_vqa_tpu_torch.convert import map_tree, params_from_jax, tree_leaves
from rau_vqa_tpu_torch.models import rau as trau
from rau_vqa_tpu_torch.ops import rau_train_hops as tth
from rau_vqa_tpu_torch.train import optim as toptim
from rau_vqa_tpu_torch.train import trainer as ttrainer

JCFG = JaxModelConfig(
    vocab_size=50, answer_size=17, seq_len=9, embed_dim=8, rnn_size=16,
    rnn_layers=2, cnn_dim=12, cnn_w=3, cnn_h=2, multfeat_dim=16,
    attfeat_dim=8, att_rnn_size=16, att_rnn_layers=1, n_hops=3,
    compute_dtype="bfloat16")
B = 8
SEED = 12345
BAR = 1e-4
HOP_W = np.asarray([1.0 + 0.5 * h for h in range(JCFG.n_hops)], np.float32)


def port_cfg(jcfg, **kw):
    names = {f.name for f in dataclasses.fields(tconfig.ModelConfig)}
    names.discard("fused_train_bwd")      # the port's default differs
    return tconfig.ModelConfig(**{**{n: getattr(jcfg, n) for n in names}, **kw})


def norm_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _data():
    rs = np.random.RandomState(7)
    params = jrau.init_params(jax.random.PRNGKey(0), JCFG)
    mp16 = jax.tree.map(lambda w: (3.0 * w).astype(jnp.bfloat16), params["mult"])
    q = rs.randn(B, JCFG.rnnout_dim).astype(np.float32)
    feats = rs.randn(B, JCFG.cnn_spat, JCFG.cnn_dim).astype(np.float32)
    labels = rs.randint(0, JCFG.answer_size, B).astype(np.int32)
    return mp16, q, feats, labels


_DATA = _data()


@pytest.fixture(scope="module")
def data():
    return _DATA


def jax_loss(scores, labels):
    logp = jax.nn.log_softmax(scores, axis=-1)
    nll = -jnp.take_along_axis(logp, jnp.asarray(labels)[None, :, None], -1)[..., 0]
    return jnp.sum(jnp.asarray(HOP_W) * jnp.mean(nll, axis=1))


def torch_loss(scores, labels):
    logp = torch.log_softmax(scores, dim=-1)
    idx = torch.as_tensor(labels).long()[None, :, None].expand(scores.shape[0], -1, 1)
    return torch.sum(torch.as_tensor(HOP_W) * (-logp.gather(-1, idx)[..., 0]).mean(1))


def port_mp(mp16):
    return params_from_jax(jax.tree.map(np.asarray, mp16))


@pytest.mark.parametrize("rate", [0.5, 0.0])
def test_hop_forward_matches_jax(data, rate):
    """Scores, do_pred, attprob and the final state against JAX's bf16
    reference; the fused entry on the CPU is the plain version, bit for bit;
    the port's float32 products land beyond 10x the bar."""
    mp16, q, feats, _ = data
    jcfg = dataclasses.replace(JCFG, mult_dropout=rate)
    want = jth.rau_train_hops_reference(mp16, jcfg, jnp.asarray(q), jnp.asarray(feats),
                                        jnp.int32(SEED))
    mp = port_mp(mp16)
    args = (torch.as_tensor(q), torch.as_tensor(feats), SEED)
    got = tth.rau_train_hops_reference(mp, port_cfg(jcfg), *args)
    names = ("scores", "do_pred", "attprob", "final_c", "final_h")
    for name, g, w in zip(names, got, want):
        assert g.dtype == torch.float32
        assert norm_rel(g.numpy(), w) <= BAR, name
    fused = tth.rau_train_hops(mp, port_cfg(jcfg), *args)
    for g, w in zip(fused, got):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    f32 = tth.rau_train_hops_reference(map_tree(lambda w: w.float(), mp),
                                       port_cfg(jcfg, compute_dtype="float32"), *args)
    assert norm_rel(f32[0].numpy(), want[0]) > 10 * BAR


@functools.lru_cache(maxsize=None)
def _jax_grads_for(rate, bwd):
    return _jax_grads(*_DATA, dataclasses.replace(JCFG, mult_dropout=rate), bwd)


def _jax_grads(mp16, q, feats, labels, jcfg, bwd):
    if bwd == "kernel":   # the Pallas backward, interpreted
        def scores(mp, q_):
            return jth.rau_train_hops(mp, dataclasses.replace(jcfg, fused_train_bwd="kernel"),
                                      q_, jnp.asarray(feats), jnp.int32(SEED),
                                      block_b=B, interpret=True)[0]
    else:
        def scores(mp, q_):
            return jth.rau_train_hops_reference(mp, jcfg, q_, jnp.asarray(feats),
                                                jnp.int32(SEED))[0]
    return jax.grad(lambda mp, q_: jax_loss(scores(mp, q_), labels),
                    argnums=(0, 1))(mp16, jnp.asarray(q))


def _port_grads(mp16, q, feats, labels, cfg):
    mp = map_tree(lambda w: w.requires_grad_(), port_mp(mp16))
    q_t = torch.as_tensor(q).requires_grad_()
    torch_loss(tth.rau_train_hops(mp, cfg, q_t, torch.as_tensor(feats), SEED)[0],
               labels).backward()
    return map_tree(lambda w: w.grad, mp), q_t.grad


@pytest.mark.parametrize("bwd", ["kernel", "xla"])
@pytest.mark.parametrize("rate", [0.5, 0.0])
def test_hop_grads_match_jax(data, bwd, rate):
    """Every leaf's grad (bf16, the params' type) and dq against JAX's;
    do_pred's weights get exactly zero.  att_score b's grad is zero in exact
    arithmetic (the softmax is shift-invariant), rounding noise on both
    sides: held to an absolute 1e-6."""
    mp16, q, feats, labels = data
    jcfg = dataclasses.replace(JCFG, mult_dropout=rate)
    gmp, gq = _jax_grads_for(rate, bwd)
    grads, dq = _port_grads(mp16, q, feats, labels, port_cfg(jcfg, fused_train_bwd=bwd))
    for path, w in jax.tree_util.tree_leaves_with_path(gmp):
        g = grads
        for k in path:
            g = g[k.key if hasattr(k, "key") else k.idx]
        name = jax.tree_util.keystr(path)
        assert g.dtype == torch.bfloat16, name
        if path[0].key == "do_pred":
            assert torch.all(g == 0) and not np.asarray(w).any(), name
        elif path[0].key == "att_score" and path[1].key == "b":
            assert abs(g.item()) <= 1e-6 and abs(float(w[0])) <= 1e-6, name
        else:
            assert norm_rel(g.float().numpy(), np.asarray(w, np.float32)) <= BAR, name
    assert dq.dtype == torch.float32
    assert norm_rel(dq.numpy(), gq) <= BAR


def test_float32_grads_land_beyond_ten_bars(data):
    """The port's hand-derived backward with float32 products on the same
    bf16-valued inputs, against JAX's bf16 backward: every leaf beyond 10x
    the bar, so that the bar sees a product that is not rounded."""
    mp16, q, feats, labels = data
    jcfg = dataclasses.replace(JCFG, mult_dropout=0.5)
    gmp, _ = _jax_grads_for(0.5, "kernel")
    grads, _ = _port_grads(jax.tree.map(lambda w: w.astype(jnp.float32), mp16), q, feats,
                           labels, port_cfg(jcfg, compute_dtype="float32",
                                            fused_train_bwd="kernel"))
    for path, w in jax.tree_util.tree_leaves_with_path(gmp):
        if path[0].key == "do_pred" or (path[0].key == "att_score" and path[1].key == "b"):
            continue
        g = grads
        for k in path:
            g = g[k.key if hasattr(k, "key") else k.idx]
        assert norm_rel(g.numpy(), np.asarray(w, np.float32)) > 10 * BAR, jax.tree_util.keystr(path)


@pytest.mark.parametrize("rate", [0.5, 0.0])
def test_jax_backwards_round_in_different_places(rate):
    """Why each port backward is held to its own counterpart: JAX's Pallas
    backward and its autodiff of the reference, on the same inputs, are
    beyond 10x the bar apart on some leaf."""
    kernel, _ = _jax_grads_for(rate, "kernel")
    autodiff, _ = _jax_grads_for(rate, "xla")
    gaps = [norm_rel(np.asarray(a, np.float32), np.asarray(b, np.float32))
            for a, b in zip(jax.tree.leaves(kernel), jax.tree.leaves(autodiff))
            if np.asarray(b, np.float32).any()]
    assert max(gaps) > 10 * BAR


@pytest.mark.parametrize("change,error", [
    (dict(compute_dtype="float16"), ValueError),
    (dict(fused_train_bwd="mosaic"), ValueError)])
def test_rejects_unknown_types_and_impls(data, change, error):
    mp16, q, feats, _ = data
    cfg = port_cfg(JCFG, **change)
    with pytest.raises(error):
        tth.rau_train_hops(port_mp(mp16), cfg, torch.as_tensor(q), torch.as_tensor(feats), SEED)


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    lengths = rs.randint(1, JCFG.seq_len + 1, B).astype(np.int32)
    tokens = np.zeros((B, JCFG.seq_len), np.int32)
    for k in range(B):
        tokens[k, :lengths[k]] = rs.randint(1, JCFG.vocab_size, lengths[k])
    feats = rs.randn(B, JCFG.cnn_spat, JCFG.cnn_dim).astype(np.float32)
    labels = rs.randint(0, JCFG.answer_size, B).astype(np.int32)
    return tokens, lengths, feats, labels


def _recording_encoder(monkeypatch):
    """Record each output of the port's question encoder under rau_forward."""
    seen = []
    plain = trau.encode_question

    def recording(*args, **kwargs):
        seen.append(plain(*args, **kwargs))
        return seen[-1]

    monkeypatch.setattr(trau, "encode_question", recording)
    return seen


@pytest.mark.parametrize("bwd", ["kernel", "xla", "unfused"])
def test_bf16_train_step_matches_jax(bwd, monkeypatch):
    """One bf16 step, all dropout off, noisy_eta 0, from the JAX package's
    initial state, fused (either backward) or unfused: the loss within 5e-3
    of JAX's bf16 step's and within 5% of the port's float32 step's; the
    encoder's output bf16 and the per-hop losses in the type of JAX's (bf16
    unfused, where the whole hop runs in bf16; float32 fused); the params
    still float32, every grad norm and new param finite."""
    fused = bwd != "unfused"
    jcfg = dataclasses.replace(JCFG, fused_train=fused, embed_dropout=0.0, rnn_dropout=0.0,
                               mult_dropout=0.0, matmul_precision="default")
    jtcfg = JaxTrainConfig(noisy_eta=0.0)
    tokens, lengths, feats, labels = _batch()
    hop_scale = np.ones(JCFG.n_hops, np.float32)
    jstate = jtrainer.init_train_state(jax.random.PRNGKey(0), jcfg)
    _, jm = jax.jit(jtrainer.make_train_step(jcfg, jtcfg))(
        jstate, *(jnp.asarray(a) for a in (tokens, lengths, feats, labels, hop_scale)),
        jnp.float32(3e-3), jnp.float32(3e-4))
    params = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    state = ttrainer.TrainState(
        params, {g: toptim.adam_init(params[g]) for g in ttrainer.PARAM_GROUPS}, 0, 0)
    tcfg = tconfig.TrainConfig(noisy_eta=0.0)
    seen = _recording_encoder(monkeypatch)
    losses = {}
    for dtype in ("bfloat16", "float32"):
        mcfg = port_cfg(jcfg, compute_dtype=dtype, **({"fused_train_bwd": bwd} if fused else {}))
        new, tm = ttrainer.make_train_step(mcfg, tcfg, device="cpu")(
            state, tokens, lengths, feats, labels, hop_scale, 3e-3, 3e-4)
        losses[dtype] = tm["loss"].item()
        assert seen[-1].dtype == getattr(torch, dtype)
        assert all(torch.isfinite(v).all() for v in tm.values())
        assert all(x.dtype == torch.float32 and torch.isfinite(x).all()
                   for x in tree_leaves(new.params))
        if dtype == "bfloat16":
            assert str(tm["ce_per_hop"].dtype) == f"torch.{jm['ce_per_hop'].dtype}"
    assert str(jm["ce_per_hop"].dtype) == ("float32" if fused else "bfloat16")
    assert abs(losses["bfloat16"] - float(jm["loss"])) <= 5e-3 * abs(float(jm["loss"]))
    assert abs(losses["bfloat16"] - losses["float32"]) <= 0.05 * abs(losses["float32"])
    assert losses["bfloat16"] != losses["float32"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_encoder_agrees_with_jax_bit_for_bit_more_often_than_float32(seed, monkeypatch):
    """The encoder under rau_forward(train=True) with compute_dtype bf16,
    against JAX's bf16 encode_question on the same bf16-cast params (B=32):
    its bf16 outputs equal JAX's in at least 42% of the elements (readings
    50-58%), the float32 encoder's rounded to bf16 in under 42% (27-35%)."""
    rs = np.random.RandomState(seed)
    lengths = rs.randint(1, JCFG.seq_len + 1, 32).astype(np.int32)
    tokens = np.zeros((32, JCFG.seq_len), np.int32)
    for k in range(32):
        tokens[k, :lengths[k]] = rs.randint(1, JCFG.vocab_size, lengths[k])
    feats = rs.randn(32, JCFG.cnn_spat, JCFG.cnn_dim).astype(np.float32)
    jparams = jrau.init_params(jax.random.PRNGKey(seed), JCFG)
    want = np.asarray(jax.jit(lambda p: jrau.encode_question(
        jax.tree.map(lambda x: x.astype(jnp.bfloat16), p), JCFG, jnp.asarray(tokens),
        jnp.asarray(lengths)))(jparams).astype(jnp.float32))
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    seen = _recording_encoder(monkeypatch)
    agree = {}
    for dtype in ("bfloat16", "float32"):
        cfg = port_cfg(JCFG, compute_dtype=dtype, fused_train=True, embed_dropout=0.0,
                       rnn_dropout=0.0, mult_dropout=0.0)
        trau.rau_forward(params, cfg, torch.as_tensor(tokens), torch.as_tensor(lengths),
                         torch.as_tensor(feats), train=True, hop_seed=0)
        got = seen[-1].detach().to(torch.bfloat16).float().numpy()
        agree[dtype] = np.mean(got == want)
    assert agree["bfloat16"] >= 0.42 > agree["float32"], agree


def test_bf16_forward_casts_under_autograd(monkeypatch):
    """rau_forward(train=True) in bf16: the encoder's output is bf16, the
    scores float32, and the grads reach the float32 params through the
    casts."""
    jcfg = dataclasses.replace(JCFG, fused_train=True, embed_dropout=0.0, rnn_dropout=0.0)
    tokens, lengths, feats, labels = _batch(1)
    params = params_from_jax(jax.tree.map(np.asarray, jrau.init_params(
        jax.random.PRNGKey(1), jcfg)))
    seen = _recording_encoder(monkeypatch)
    out = trau.rau_forward(params, port_cfg(jcfg), torch.as_tensor(tokens),
                           torch.as_tensor(lengths), torch.as_tensor(feats), train=True,
                           hop_seed=7)
    assert seen[0].dtype == torch.bfloat16 and out.scores.dtype == torch.float32
    grads, metrics = ttrainer.loss_and_grads(
        port_cfg(jcfg), params, torch.as_tensor(tokens), torch.as_tensor(lengths),
        torch.as_tensor(feats), torch.as_tensor(labels), torch.ones(JCFG.n_hops),
        hop_seed=7)
    for g, p in zip(tree_leaves(grads), tree_leaves(params)):
        assert g.dtype == p.dtype == torch.float32 and torch.isfinite(g).all()
    assert grads["embed"]["lookup"].abs().max() > 0
    assert grads["mult"]["i_embed"]["w"].abs().max() > 0
    assert torch.isfinite(metrics["loss"])
