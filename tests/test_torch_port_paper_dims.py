"""Three train steps at the flagship's full widths, the port against the JAX
package, on the CPU: the step that ``paper_dims_run train`` takes ~950 times
on the card, in both of its routes.

``ours_ms`` as the presets ship it (vocab 12,605, rnn 512, 8 hops,
14x14x512 features, 1000 answers), with all dropout off and ``noisy_eta`` 0
so that both packages compute one function, B=4 questions of up to 8 tokens
a step, the run's learning rates (4e-3, 4e-4), three batches from a numpy
seed, one initial state (the JAX package's init, moved by
``params_from_jax``).  Routes: the unfused preset step (every hop in
PyTorch against JAX's unfused hops) and the fused step (the training
kernels' plain versions, as on every CPU tensor, against JAX's fused loop
through its reference, as its own tests run it off the TPU); each in
float32 and in bf16 (JAX's ``--bf16``: ``compute_dtype`` bf16 and its
default matmul precision).

Bars, each one the repo's JAX-parity tests already use:
- float32: every per-hop loss of each step and every parameter after step 3
  elementwise at the train step's rtol 2e-3, atol 1e-6
  (tests/test_torch_port_train_unfused.py).  Readings: losses within
  1.4e-7, leaves within 1.1e-5 norm-relative; each leaf's update (params
  less init) within 1.3e-5 of JAX's but ``mult.att_score.b``'s, whose
  gradient is rounding noise (tests/test_torch_port_trainer.py).
- bf16: every per-hop loss of each step within 5e-3 of JAX's bf16 step's
  and 5% of the port's float32 step's (tests/test_torch_port_train_bf16.py,
  tests/test_pallas_train.py:227-242), and every parameter after step 3 by
  norm per leaf at JAX's bf16 bar, 5%.  Readings: losses within 4.5e-3
  unfused (one bf16 ulp of a per-hop loss near 7) and 5.2e-4 fused; leaves
  within 6.0e-3 (the encoder's: the two frameworks round the bf16 encoder
  in different places, ~5e-3 of its output) and 1.1e-2 for
  ``mult.att_score.b``.  The bf16 params cannot be held tighter, nor by
  their update: Adam moves each element whose gradient is near 0 by about
  lr whichever way rounding tips it, and over three steps the port's bf16
  params land as far from JAX's bf16 ones as the port's float32 params do
  (measured at 0.8-6x, leaf by leaf).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rau_vqa_tpu.config import TrainConfig as JaxTrainConfig
from rau_vqa_tpu.config import get_preset as jax_preset
from rau_vqa_tpu.train import trainer as jtrainer
from rau_vqa_tpu_torch import config as tconfig
from rau_vqa_tpu_torch.convert import params_from_jax
from rau_vqa_tpu_torch.train import optim as toptim
from rau_vqa_tpu_torch.train import trainer as ttrainer

NO_DROPOUT = dict(embed_dropout=0.0, rnn_dropout=0.0, mult_dropout=0.0, att_rnn_dropout=0.0)
B, T, STEPS = 4, 8, 3
LR, MULT_LR = 4e-3, 4e-4              # paper_dims_run train --lr 4e-3 (mult at lr / 10)


def jax_cfg(fused, dtype):
    cfg = dataclasses.replace(jax_preset("ours_ms").model, fused_train=fused,
                              compute_dtype=dtype, **NO_DROPOUT)
    if fused:   # off the TPU the fused loop runs its reference
        cfg = dataclasses.replace(cfg, fused_train_impl="reference")
    if dtype == "bfloat16":   # the JAX CLI's --bf16
        cfg = dataclasses.replace(cfg, matmul_precision="default")
    return cfg


def port_cfg(jcfg, **kw):
    """The port's preset model config with the JAX one's values (its own
    ``fused_train_bwd`` default, the kernels' backward)."""
    names = {f.name for f in dataclasses.fields(tconfig.ModelConfig)} - {"fused_train_bwd"}
    base = tconfig.get_train_preset("ours_ms")[0]
    return dataclasses.replace(base, **{**{n: getattr(jcfg, n) for n in names}, **kw})


def port_train_cfg(jtcfg):
    return tconfig.TrainConfig(**{f.name: getattr(jtcfg, f.name)
                                  for f in dataclasses.fields(tconfig.TrainConfig)})


def batches(cfg):
    rs = np.random.RandomState(21)
    out = []
    for _ in range(STEPS):
        lengths = rs.randint(1, T + 1, B).astype(np.int32)
        lengths[0] = T
        tokens = np.zeros((B, T), np.int32)
        for k in range(B):
            tokens[k, :lengths[k]] = rs.randint(1, cfg.vocab_size, lengths[k])
        feats = rs.randn(B, cfg.cnn_spat, cfg.cnn_dim).astype(np.float32)
        labels = rs.randint(0, cfg.answer_size, B).astype(np.int32)
        out.append((tokens, lengths, feats, labels))
    return out


@pytest.fixture(scope="module")
def start():
    """The JAX package's initial state at full width (params are float32 in
    every configuration) and the three batches."""
    cfg = jax_cfg(False, "float32")
    state = jtrainer.init_train_state(jax.random.PRNGKey(0), cfg)
    return state, batches(cfg)


def port_state(jstate):
    params = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    return ttrainer.TrainState(
        params, {g: toptim.adam_init(params[g]) for g in ttrainer.PARAM_GROUPS}, step=0, seed=0)


def leaf(tree, path):
    for k in path:
        tree = tree[k.key if hasattr(k, "key") else k.idx]
    return tree


def run_port(mcfg, tcfg, state, data, hop_scale):
    step = ttrainer.make_train_step(mcfg, tcfg, device="cpu")
    losses = []
    for b in data:
        state, m = step(state, *b, hop_scale, LR, MULT_LR)
        losses.append(m["ce_per_hop"].float().numpy())
    return state, losses


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused_preset", "fused"])
def test_three_full_width_steps_match_jax(start, fused, dtype):
    jstate0, data = start
    jcfg = jax_cfg(fused, dtype)
    jtcfg = JaxTrainConfig(noisy_eta=0.0)
    hop_scale = np.ones(jcfg.n_hops, np.float32)
    jstep = jax.jit(jtrainer.make_train_step(jcfg, jtcfg))
    jstate, jlosses = jstate0, []
    for b in data:
        jstate, jm = jstep(jstate, *(jnp.asarray(a) for a in b), jnp.asarray(hop_scale),
                           jnp.float32(LR), jnp.float32(MULT_LR))
        jlosses.append(np.asarray(jm["ce_per_hop"], np.float32))

    mcfg = port_cfg(jcfg)
    assert mcfg.fused_train == fused and mcfg.compute_dtype == dtype
    assert (mcfg.vocab_size, mcfg.rnn_size, mcfg.n_hops, mcfg.cnn_spat, mcfg.cnn_dim,
            mcfg.answer_size) == (12605, 512, 8, 196, 512, 1000)
    new, losses = run_port(mcfg, port_train_cfg(jtcfg), port_state(jstate0), data, hop_scale)
    assert new.step == STEPS
    for i, (got, want) in enumerate(zip(losses, jlosses)):
        assert got.shape == want.shape == (jcfg.n_hops,)
        rtol = 2e-3 if dtype == "float32" else 5e-3
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6, err_msg=f"step {i + 1}")
    if dtype == "bfloat16":
        _, losses32 = run_port(port_cfg(jcfg, compute_dtype="float32"),
                               port_train_cfg(jtcfg), port_state(jstate0), data, hop_scale)
        for i, (got, f32) in enumerate(zip(losses, losses32)):
            np.testing.assert_allclose(got, f32, rtol=0.05, err_msg=f"step {i + 1}")
        assert any(not np.array_equal(g, f) for g, f in zip(losses, losses32))

    for path, want in jax.tree_util.tree_leaves_with_path(jstate.params):
        name = jax.tree_util.keystr(path)
        got = leaf(new.params, path).detach()
        assert got.dtype == torch.float32 and bool(torch.isfinite(got).all()), name
        got, want = got.numpy().astype(np.float64), np.asarray(want, np.float64)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-6, err_msg=name)
        else:
            rel = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert rel <= 0.05, (name, rel)
        # a leaf moved in both packages or in neither (do_pred's carry no
        # gradient, rau_vqa_tpu/train/losses.py:1-17)
        init = np.asarray(leaf(jstate0.params, path), np.float64)
        assert np.array_equal(got, init) == np.array_equal(want, init), name
