"""The host side of the serving hop-loop kernel (csrc/rau_hops.cu):
``hops_plan`` and the kernel's phase decomposition, on the CPU.

``hops_plan`` lists a call's launches in the order the C entry enqueues
them: prep and the question projection once, then every hop's eleven
phases.  Its tile GEMMs must cover every output element once and every
phase must fit a block's shared memory; it refuses shapes the kernel does
not take.  On the card, tests/test_torch_port_cuda.py and chip_smoke.py
hold these phases to the grids the built launcher reports.

``phase_hops`` below runs the kernel's phases in plain PyTorch, in the
plan's order, with the kernel's rounding points: q, h, qfeat, the
softmax, join and merge rounded to bf16 where a product reads them (each
written once in bf16 by its producer), the score's tanh rounded before its
dot with w_score, and the softmax, the pooling, the biases and the carry
in float32.  It is held to ``rau_hops_reference(dot_dtype=bf16)`` (the
kernel's plain version) at a norm-relative 1e-6, and to JAX's Pallas kernel
in interpret mode at the bars of tests/test_torch_port_ops.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rau_vqa_tpu.config import ModelConfig as JaxModelConfig
from rau_vqa_tpu.models import rau as jrau
from rau_vqa_tpu.ops.rau_hops import rau_hops_pallas as j_hops_pallas
from rau_vqa_tpu_torch import config as tconfig
from rau_vqa_tpu_torch.config import get_preset
from rau_vqa_tpu_torch.convert import params_from_jax
from rau_vqa_tpu_torch.ops import rau_hops
from rau_vqa_tpu_torch.ops.rau_train_hops import GEMM_TILES, ROWS_SMEM_LIMIT

# the small configuration of tests/test_torch_port_ops.py
JCFG = JaxModelConfig(
    vocab_size=50, answer_size=16, seq_len=9, embed_dim=8, rnn_size=16,
    rnn_layers=2, cnn_dim=12, cnn_w=4, cnn_h=2, multfeat_dim=16,
    attfeat_dim=8, att_rnn_size=16, n_hops=3)
CFG = tconfig.ModelConfig(**{f.name: getattr(JCFG, f.name)
                             for f in dataclasses.fields(tconfig.ModelConfig)})
OURS = get_preset("ours_ms")
BF16 = torch.bfloat16
SMEM_LIMIT = 232_448     # a Hopper block's opt-in shared memory
HOP_PHASES = ("h Wmem", "qfeat", "qatt", "rows_eval", "join", "join Wli", "gates", "cell",
              "merge", "classifier", "do_pred")


def norm_rel(got, want):
    got, want = got.double(), want.double()
    ref = want.norm().item()
    return (got - want).norm().item() / ref if ref else (got - want).norm().item()


# ---------------------------------------------------------------------------
# hops_plan
# ---------------------------------------------------------------------------

PLAN_CASES = [(OURS, b) for b in (1, 19, 37, 512)] + [(CFG, 8)]
PLAN_IDS = [f"ours_ms-B{b}" for b in (1, 19, 37, 512)] + ["small-B8"]


@pytest.mark.parametrize("cfg,B", PLAN_CASES, ids=PLAN_IDS)
def test_plan_covers_every_output_tile_once(cfg, B):
    """Each GEMM's grid of (BM, BN) tiles covers its [M, N] output exactly
    once, with no tile wholly outside it and no split K; the products are
    the hop's, on the bf16 body's small tile; a call is 2 + 11 H kernels."""
    plan = rau_hops.hops_plan(B, cfg)
    assert tuple(p.name for p in plan.setup) == ("prep", "q Wq")
    assert tuple(p.name for p in plan.hop) == HOP_PHASES
    assert plan.phases == plan.setup + plan.hop
    assert plan.kernels(cfg.n_hops) == 2 + 11 * cfg.n_hops
    gemms = [p for p in plan.phases if p.tile is not None]
    assert len(gemms) == 10
    small = GEMM_TILES[BF16]["small"][:2]
    for ph in gemms:
        assert ph.tile == small, ph.name
        bm, bn = ph.tile
        gx, gy, gz = ph.grid
        rows = np.zeros(ph.M, np.int64)
        cols = np.zeros(ph.N, np.int64)
        for y in range(gy):
            assert y * bm < ph.M, ph.name
            rows[y * bm:(y + 1) * bm] += 1
        for x in range(gx):
            assert x * bn < ph.N, ph.name
            cols[x * bn:(x + 1) * bn] += 1
        assert (rows == 1).all() and (cols == 1).all(), ph.name
        assert gz == 1 and not ph.split, ph.name
    Q, S, M, F = cfg.rnnout_dim, cfg.cnn_spat, cfg.multfeat_dim, cfg.attfeat_dim
    R, A = cfg.att_rnn_size, cfg.answer_size
    want = {"q Wq": (B, M, Q), "h Wmem": (B, S, R), "qfeat": (B, M, R), "qatt": (B, F, M),
            "join": (B, M, S), "join Wli": (B, 4 * R, M), "gates": (B, 4 * R, R),
            "merge": (B, M, R), "classifier": (B, A, M), "do_pred": (B, 1, M)}
    assert {p.name: (p.M, p.N, p.K) for p in gemms} == want


@pytest.mark.parametrize("cfg,B", PLAN_CASES, ids=PLAN_IDS)
def test_plan_launches_fit(cfg, B):
    """Every phase's shared memory fits a block, the row kernel's without
    the opt-in: qatt and w_score, the probabilities, and the pooling's
    partials; one CTA a row; the elementwise kernels cover their elements."""
    plan = rau_hops.hops_plan(B, cfg)
    for ph in plan.phases:
        assert 0 <= ph.smem <= SMEM_LIMIT, ph.name
        assert all(1 <= g <= 2 ** 31 - 1 for g in ph.grid), ph.name
        assert ph.grid[1] <= 65535 and ph.grid[2] <= 65535, ph.name
    by = {p.name: p for p in plan.phases}
    S, M, F, R = cfg.cnn_spat, cfg.multfeat_dim, cfg.attfeat_dim, cfg.att_rnn_size
    slices = max(1, rau_hops.ROWS_EVAL_THREADS // (M // 8))
    assert by["rows_eval"].grid == (B, 1, 1)
    assert by["rows_eval"].smem == 4 * (2 * F + S + slices * M) <= ROWS_SMEM_LIMIT
    ew = rau_hops.ROWS_EVAL_THREADS
    assert by["cell"].grid[0] * ew >= B * R
    prep = by["prep"].grid[0]
    assert prep == 4096 or prep * ew >= B * (cfg.rnnout_dim + R)


@pytest.mark.parametrize("change,match", [
    (dict(B=0), "at least 1"),
    (dict(cnn_w=0), "at least 1"),
    (dict(answer_size=0), "at least 1"),
    (dict(att_rnn_layers=2), "1-layer"),
    (dict(attfeat_dim=252), "multiples of 8"),
    (dict(multfeat_dim=500), "multiples of 8"),
    (dict(cnn_w=100, cnn_h=100), "shared memory"),
    (dict(B=30_000), "32-bit"),
])
def test_plan_rejects_shapes_the_kernel_does_not_take(change, match):
    change = dict(change)
    B = change.pop("B", 100)
    cfg = dataclasses.replace(OURS, **change)
    with pytest.raises(ValueError, match=match):
        rau_hops.hops_plan(B, cfg)


def test_cpu_wrapper_checks_nothing_of_the_plan():
    """On CPU tensors the wrapper is the plain version at any width (the
    plan's limits are the kernel's): an odd attfeat_dim runs there."""
    cfg = dataclasses.replace(CFG, attfeat_dim=6)
    mp, q, ifeat, iatt = _inputs(cfg, 3, seed=1)
    before = rau_hops.KERNEL.launches
    s, d, a = rau_hops.rau_hops(mp, cfg, q, ifeat, iatt)
    assert rau_hops.KERNEL.launches == before
    assert s.shape == (cfg.n_hops, 3, cfg.answer_size) and torch.isfinite(s).all()


# ---------------------------------------------------------------------------
# The phase decomposition in plain PyTorch
# ---------------------------------------------------------------------------

def _mm(a, b):
    """A product as the tile GEMM takes it: both operands in bf16, float32
    sums."""
    return a.to(BF16).float() @ b.to(BF16).float()


def hop_phase(name, v, mp, ifeat, iatt):
    """Run the phase ``name`` of one hop on the values ``v`` (the carry and
    what the hop made so far), as the kernel does; adds its values to
    ``v``.  Values named ``*_b`` are the bf16 copies a producer writes."""
    lp = mp["attlstm"]["layers"][0]

    def w(k, part="w"):
        return (lp if k == "attlstm" else mp[k])[part].float()

    if name == "h Wmem":
        v["msc"] = _mm(v["h_b"], w("att_mem"))
    elif name == "qfeat":
        v["qfeat"] = torch.tanh(((v["qwq"] + w("q_proj", "b")) + _mm(v["h_b"], w("h_proj")))
                                + w("h_proj", "b"))
        v["qfeat_b"] = v["qfeat"].to(BF16)
    elif name == "qatt":
        v["qatt"] = _mm(v["qfeat_b"], w("att_q")) + w("att_q", "b")
    elif name == "rows_eval":
        add = torch.tanh(iatt.float() + v["qatt"][:, None, :]).to(BF16).float()
        score = (add @ w("att_score"))[..., 0]
        score = ((score + w("att_score", "b")[0]) + v["msc"]) + w("att_mem", "b")
        v["p"] = torch.softmax(score, dim=1)
        v["p_b"] = v["p"].to(BF16)
        v["pool"] = (ifeat.float() * v["p"][:, :, None]).sum(1)
    elif name == "join":
        v["join"] = ((v["qfeat"] + v["pool"]) + _mm(v["p_b"], w("attprob_proj"))) \
            + w("attprob_proj", "b")
        v["join_b"] = v["join"].to(BF16)
    elif name == "join Wli":
        v["tmp"] = _mm(v["join_b"], w("attlstm", "wi"))
    elif name == "gates":
        v["gates"] = ((v["tmp"] + w("attlstm", "bi")) + _mm(v["h_b"], w("attlstm", "wh"))) \
            + w("attlstm", "bh")
    elif name == "cell":
        g, R = v["gates"], v["c"].shape[1]
        ig, gt = torch.sigmoid(g[:, :R]), torch.tanh(g[:, R:2 * R])
        fg, og = torch.sigmoid(g[:, 2 * R:3 * R]), torch.sigmoid(g[:, 3 * R:])
        v["c"] = fg * v["c"] + ig * gt
        v["h"] = og * torch.tanh(v["c"])
        v["h_b"] = v["h"].to(BF16)
    elif name == "merge":
        v["merge_b"] = ((v["join"] + _mm(v["h_b"], w("merge"))) + w("merge", "b")).to(BF16)
    elif name == "classifier":
        v["score"] = _mm(v["merge_b"], w("cls")) + w("cls", "b")
    elif name == "do_pred":
        v["do_pred"] = torch.sigmoid(_mm(v["merge_b"], w("do_pred"))[:, 0]
                                     + w("do_pred", "b")[0])
    else:
        raise AssertionError(f"no hop phase {name}")


def phase_hops(mp, cfg, q, ifeat, iatt):
    """The kernel's phases (``hops_plan``'s, setup then hop after hop) on
    CPU tensors: (scores, do_pred, attprob), as ``rau_hops``."""
    B, R = q.shape[0], cfg.att_rnn_size
    plan = rau_hops.hops_plan(B, cfg)
    assert tuple(p.name for p in plan.setup) == ("prep", "q Wq")
    v = {"c": torch.zeros(B, R), "h_b": torch.zeros(B, R, dtype=BF16)}
    v["qwq"] = _mm(q.to(BF16), mp["q_proj"]["w"].float())
    outs = ([], [], [])
    for _ in range(cfg.n_hops):
        for ph in plan.hop:
            hop_phase(ph.name, v, mp, ifeat, iatt)
        for o, k in zip(outs, ("score", "do_pred", "p")):
            o.append(v[k])
    return tuple(torch.stack(o) for o in outs)


def _inputs(cfg, B, seed):
    """Packed bf16 weights from the JAX init, q and the bf16 image
    embeddings (JAX's embed_image), all from numpy with a seed."""
    jcfg = dataclasses.replace(JCFG, attfeat_dim=cfg.attfeat_dim)
    p = jax.tree.map(np.asarray, jrau.init_params(jax.random.PRNGKey(seed), jcfg))
    rs = np.random.RandomState(seed)
    q = rs.randn(B, jcfg.rnnout_dim).astype(np.float32)
    feats = rs.randn(B, jcfg.cnn_spat, jcfg.cnn_dim).astype(np.float32)
    ifeat, iatt = jrau.embed_image(p["mult"], jcfg, jnp.asarray(feats))
    mp = rau_hops.pack_hop_weights(params_from_jax(p["mult"]))
    return (mp, torch.as_tensor(q), torch.as_tensor(np.array(ifeat)).to(BF16),
            torch.as_tensor(np.array(iatt)).to(BF16))


NAMES = ("scores", "do_pred", "attprob")


@pytest.mark.parametrize("B,seed", [(1, 3), (19, 4), (32, 5)])
def test_phases_match_the_plain_version(B, seed):
    """Every output of the phase decomposition against the kernel's plain
    version (``rau_hops_reference`` with bf16 dots) at 1e-6 norm-relative;
    the wrapper on CPU tensors is that plain version, and launches
    nothing."""
    mp, q, ifeat, iatt = _inputs(CFG, B, seed)
    before = rau_hops.KERNEL.launches
    want = rau_hops.rau_hops(mp, CFG, q, ifeat, iatt)
    assert rau_hops.KERNEL.launches == before
    got = phase_hops(mp, CFG, q, ifeat, iatt)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype == torch.float32 and g.shape == w.shape, name
        assert norm_rel(g, w) <= 1e-6, name


@functools.lru_cache(maxsize=None)
def _jax_pallas(B, seed):
    jcfg = JCFG
    p = jax.tree.map(np.asarray, jrau.init_params(jax.random.PRNGKey(seed), jcfg))
    rs = np.random.RandomState(seed)
    q = rs.randn(B, jcfg.rnnout_dim).astype(np.float32)
    feats = rs.randn(B, jcfg.cnn_spat, jcfg.cnn_dim).astype(np.float32)
    ifeat, iatt = jrau.embed_image(p["mult"], jcfg, jnp.asarray(feats))
    out = j_hops_pallas(p["mult"], jcfg, jnp.asarray(q), ifeat, iatt, block_b=16,
                        interpret=True)
    return tuple(np.asarray(x) for x in out)


@pytest.mark.parametrize("B,seed", [(16, 4), (32, 5)])
def test_phases_match_jax_pallas_interpret(B, seed):
    """The phase decomposition against JAX's Pallas kernel in interpret mode,
    at the bars of tests/test_torch_port_ops.py (scores rtol 1e-3 / atol
    1e-4 with argmax agreement > 0.97, attprob 1e-3 / 1e-5, do_pred 1e-3 /
    1e-4)."""
    ws, wd, wa = _jax_pallas(B, seed)
    mp, q, ifeat, iatt = _inputs(CFG, B, seed)
    gs, gd, ga = phase_hops(mp, CFG, q, ifeat, iatt)
    np.testing.assert_allclose(gs.numpy(), ws, rtol=1e-3, atol=1e-4)
    assert float((gs.argmax(-1).numpy() == ws.argmax(-1)).mean()) > 0.97
    np.testing.assert_allclose(ga.numpy(), wa, rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(gd.numpy(), wd, rtol=1e-3, atol=1e-4)
