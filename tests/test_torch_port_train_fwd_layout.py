"""The host side of the training forward kernel (csrc/rau_train_hops_fwd.cu):
``fwd_plan`` and the kernel's phase decomposition, on the CPU.

``fwd_plan`` lists one hop's launches in the order the C entry enqueues
them: the hop's forward phases, which the backward's ``bwd_plan`` also
begins with (csrc/rau_train_hops_phases.cuh), then the classifier and
do_pred.  Its tile GEMMs must cover every output element once, its
workspace must be the size the wrapper allocates, and every phase must fit
a block's shared memory.  On the card, tests/test_torch_port_cuda.py and
chip_smoke.py hold these phases to the grids the built launcher reports.

``phase_forward`` below runs the kernel's phases in plain PyTorch, in the
plan's order, with the kernel's rounding points: q_d and feats_d in the
product type, qfeat / join / merge_d rounded where they are stored for a
product, the softmax and pooling on unrounded values, the new carry
written straight into c_all / h_all.  It is held to
``train_hops_fwd_reference`` (the kernel's plain version) at a
norm-relative 1e-6 in both types: the two compute the same products on the
same rounded operands and differ only in the order of float32 sums.  It is
held to JAX's Pallas forward in interpret mode at the bars of
tests/test_torch_port_train_hops.py (float32: rtol 1e-5) and
tests/test_torch_port_train_bf16.py (bf16: 1e-4 norm-relative, on inputs
that flip no rounding between the frameworks).  ``forward_phase`` is the
hop's forward that phase_backward (tests/test_torch_port_train_bwd_layout.py)
runs too, as the two kernels do.
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
from rau_vqa_tpu.ops import rau_train_hops as jth
from rau_vqa_tpu_torch import config as tconfig
from rau_vqa_tpu_torch.config import get_preset
from rau_vqa_tpu_torch.convert import params_from_jax
from rau_vqa_tpu_torch.ops import rau_train_hops as tth

JCFG = JaxModelConfig(
    vocab_size=50, answer_size=17, seq_len=9, embed_dim=8, rnn_size=16,
    rnn_layers=2, cnn_dim=12, cnn_w=3, cnn_h=2, multfeat_dim=16,
    attfeat_dim=8, att_rnn_size=16, att_rnn_layers=1, n_hops=3)
B = 8
SEED = 12345
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
OURS = get_preset("ours_ms")
SMEM_LIMIT = 232_448     # a Hopper block's opt-in shared memory
FORWARD_PHASES = ("prep", "q_d Wq", "h Wmem", "qfeat", "qatt", "ifeat", "addfeat",
                  "rows_fwd", "join", "join Wli", "gates", "cell", "merge")


def port_cfg(jcfg, **kw):
    names = {f.name for f in dataclasses.fields(tconfig.ModelConfig)}
    names.discard("fused_train_bwd")      # the port's default differs
    return tconfig.ModelConfig(**{**{n: getattr(jcfg, n) for n in names}, **kw})


def norm_rel(got, want):
    got, want = got.double(), want.double()
    ref = want.norm().item()
    return (got - want).norm().item() / ref if ref else (got - want).norm().item()


def widths(cfg):
    return dict(S=cfg.cnn_spat, Dc=cfg.cnn_dim, M=cfg.multfeat_dim, F=cfg.attfeat_dim,
                R=cfg.att_state_dim, Q=cfg.rnnout_dim, A=cfg.answer_size)


def plan_for(cfg, B_, dtype, n_sm=132):
    w = widths(cfg)
    return tth.fwd_plan(B_, w["S"], w["Dc"], w["M"], w["F"], w["R"], w["Q"], w["A"], n_sm,
                        dtype)


# ---------------------------------------------------------------------------
# fwd_plan
# ---------------------------------------------------------------------------

PLAN_CASES = [(OURS, b) for b in (1, 19, 37, 100)] + [(port_cfg(JCFG), B)]
PLAN_IDS = [f"ours_ms-B{b}" for b in (1, 19, 37, 100)] + ["small-B8"]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("cfg,B_", PLAN_CASES, ids=PLAN_IDS)
def test_plan_covers_every_output_tile_once(cfg, B_, dtype):
    """Each GEMM's grid of (BM, BN) tiles covers its [M, N] output exactly
    once, with no tile wholly outside it and no split K; the products'
    shapes are the hop's."""
    plan = plan_for(cfg, B_, DTYPES[dtype])
    w = widths(cfg)
    P = B_ * w["S"]
    assert tuple(p.name for p in plan.phases) == FORWARD_PHASES + ("classifier", "do_pred")
    gemms = [p for p in plan.phases if p.tile is not None]
    assert len(gemms) == 12
    for ph in gemms:
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
    by = {p.name: p for p in gemms}
    assert (by["ifeat"].M, by["ifeat"].N, by["ifeat"].K) == (P, w["M"], w["Dc"])
    assert (by["addfeat"].M, by["addfeat"].N, by["addfeat"].K) == (P, w["F"], w["M"])
    assert (by["classifier"].M, by["classifier"].N, by["classifier"].K) == (B_, w["A"], w["M"])
    assert (by["do_pred"].M, by["do_pred"].N, by["do_pred"].K) == (B_, 1, w["M"])
    # the FMA body's tiles in both types: big for the [B*S, *] products,
    # small for the [B, *] ones
    big, small = (tth.GEMM_TILES[torch.float32][k][:2] for k in ("big", "small"))
    assert {p.name for p in gemms if p.M == P} == {"ifeat", "addfeat"}
    assert all(p.tile == (big if p.M == P else small) for p in gemms), [p.tile for p in gemms]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("cfg,B_", PLAN_CASES, ids=PLAN_IDS)
def test_forward_and_backward_begin_with_the_same_hop(cfg, B_, dtype):
    """bwd_plan's remat is the forward's hop: the same phases and products
    in the same order; in float32 the same grids and shared memory, so the
    two kernels sum alike; in bf16 the forward's products take the FMA
    body and the backward's mma.sync, the other kernels the same launches."""
    dt = DTYPES[dtype]
    fwd = plan_for(cfg, B_, dt)
    w = widths(cfg)
    bwd = tth.bwd_plan(B_, w["S"], w["Dc"], w["M"], w["F"], w["R"], w["Q"], 132, dt)
    n = len(FORWARD_PHASES)
    for f, b in zip(fwd.phases[:n], bwd.phases[:n]):
        assert (f.name, f.M, f.N, f.K) == (b.name, b.M, b.N, b.K)
        if dt == torch.float32 or f.tile is None:
            assert f == b, f.name
    assert fwd.work_floats == bwd.work_floats


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("cfg,B_", PLAN_CASES, ids=PLAN_IDS)
def test_buffers_are_what_the_wrapper_allocates_and_fit(cfg, B_, dtype):
    """work_floats is the [B*S, M + F] workspace of ifeat and addfeat; every
    phase's shared memory fits a block, the row kernel's without the
    opt-in.  (The scratch buffer is the launcher's own count, which the
    card's checks read.)"""
    plan = plan_for(cfg, B_, DTYPES[dtype])
    w = widths(cfg)
    assert plan.work_floats == B_ * w["S"] * (w["M"] + w["F"])
    for ph in plan.phases:
        assert 0 <= ph.smem <= SMEM_LIMIT, ph.name
    by = {p.name: p for p in plan.phases}
    assert by["rows_fwd"].smem == 4 * w["S"] <= tth.ROWS_SMEM_LIMIT
    assert by["rows_fwd"].grid == (B_, 1, 1)


@pytest.mark.parametrize("change,match", [
    (dict(B_=0), "at least 1"),
    (dict(S=0), "at least 1"),
    (dict(A=0), "at least 1"),
    (dict(n_sm=0), "at least 1"),
    (dict(Q=-1), "at least 1"),
    (dict(S=13_000), "shared memory"),
    (dict(B_=600_000), "32-bit"),
    (dict(B_=2 ** 21, S=1, Q=1024), "32-bit"),
    (dict(dtype=torch.float16), "float32 or bfloat16"),
])
def test_plan_rejects_shapes_the_kernel_does_not_take(change, match):
    args = dict(B_=100, **widths(OURS), n_sm=132, dtype=torch.float32)
    args.update(change)
    with pytest.raises(ValueError, match=match):
        tth.fwd_plan(args["B_"], args["S"], args["Dc"], args["M"], args["F"], args["R"],
                     args["Q"], args["A"], args["n_sm"], args["dtype"])


# ---------------------------------------------------------------------------
# The phase decomposition in plain PyTorch
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class HopInputs:
    """What one hop's forward phases read, and the workspace they write in
    place (ifeat [P, M], addfeat [P, F])."""
    mp: dict
    dd: torch.dtype
    q: torch.Tensor
    feats: torch.Tensor
    c: torch.Tensor
    h: torch.Tensor
    masks: tuple           # (feats, q, merge) scale masks, or Nones
    ifeat: torch.Tensor
    addfeat: torch.Tensor


def forward_phase(name, v, x: HopInputs):
    """Run the forward phase ``name`` of one hop (fwd_plan's, or the
    backward's remat) on the values ``v`` of the hop so far, as the kernel
    does: every product reads both operands rounded to the product type and
    sums in float32; qfeat, join and merge_d are also kept in that type
    (``*_t``), which their products read.  Adds the phase's values to
    ``v``."""
    mp, dd = x.mp, x.dd
    Bq, S, Dc = x.feats.shape
    P = Bq * S
    lp = mp["attlstm"]["layers"][0]
    fm, qm, mmask = x.masks

    def w(k, part="w"):               # a weight or bias, float32
        return (lp if k == "attlstm" else mp[k])[part].float()

    def mm(a, b):                     # a product: both operands rounded, f32 sums
        return tth._rnd(a, dd) @ tth._rnd(b, dd)

    if name == "prep":
        v["qd"] = tth._rnd(x.q.float() * qm if qm is not None else x.q.float(), dd)
        fd = x.feats.float() * fm if fm is not None else x.feats.float()
        v["fd"] = tth._rnd(fd.reshape(P, Dc), dd)
    elif name == "q_d Wq":
        v["tmp"] = mm(v["qd"], w("q_proj"))
    elif name == "h Wmem":
        v["msc"] = mm(x.h, w("att_mem"))
    elif name == "qfeat":
        v["qfeat"] = torch.tanh(((v["tmp"] + w("q_proj", "b")) + mm(x.h, w("h_proj")))
                                + w("h_proj", "b"))
        v["qfeat_t"] = v["qfeat"].to(dd)
    elif name == "qatt":
        v["qatt"] = mm(v["qfeat_t"], w("att_q")) + w("att_q", "b")
    elif name == "ifeat":
        x.ifeat[:] = torch.tanh(mm(v["fd"], w("i_embed")) + w("i_embed", "b"))
    elif name == "addfeat":
        x.addfeat[:] = torch.tanh((mm(x.ifeat, w("att_i")) + w("att_i", "b"))
                                  + v["qatt"].repeat_interleave(S, 0))
    elif name == "rows_fwd":
        score = mm(x.addfeat, w("att_score")).reshape(Bq, S)
        score = ((score + w("att_score", "b")[0]) + v["msc"]) + w("att_mem", "b")
        v["sc"] = torch.softmax(score, dim=1)
        v["pool"] = (x.ifeat.reshape(Bq, S, -1) * v["sc"][:, :, None]).sum(1)
    elif name == "join":
        v["join"] = ((v["qfeat"] + v["pool"]) + mm(v["sc"], w("attprob_proj"))) \
            + w("attprob_proj", "b")
        v["join_t"] = v["join"].to(dd)
    elif name == "join Wli":
        v["tmp"] = mm(v["join_t"], w("attlstm", "wi"))
    elif name == "gates":
        v["gates"] = ((v["tmp"] + w("attlstm", "bi")) + mm(x.h, w("attlstm", "wh"))) + w("attlstm", "bh")
    elif name == "cell":
        g = v["gates"]
        R = x.c.shape[1]
        ig, gt = torch.sigmoid(g[:, :R]), torch.tanh(g[:, R:2 * R])
        fg, og = torch.sigmoid(g[:, 2 * R:3 * R]), torch.sigmoid(g[:, 3 * R:])
        v["act"] = (ig, gt, fg, og)
        v["cn"] = fg * x.c + ig * gt
        v["hn"] = og * torch.tanh(v["cn"])
    elif name == "merge":
        pre = (v["join"] + mm(v["hn"], w("merge"))) + w("merge", "b")
        v["merge_t"] = (pre * mmask if mmask is not None else pre).to(dd)
    elif name == "classifier":
        v["score"] = mm(v["merge_t"], w("cls")) + w("cls", "b")
    elif name == "do_pred":
        v["do_pred"] = torch.sigmoid(mm(v["merge_t"], w("do_pred"))[:, 0]
                                     + w("do_pred", "b")[0])
    else:
        raise AssertionError(f"no forward phase {name}")


def phase_forward(mp, cfg, q, feats, seed):
    """The forward kernel's phases (``fwd_plan``'s, hop after hop) on CPU
    tensors: (scores, do_pred, attprob, c_all, h_all), as
    ``train_hops_fwd``."""
    dd = tth.dot_dtype(cfg)
    H, R = cfg.n_hops, cfg.att_state_dim
    Bq, S, Dc = feats.shape
    Q, M, F, A = q.shape[1], cfg.multfeat_dim, cfg.attfeat_dim, cfg.answer_size
    plan = tth.fwd_plan(Bq, S, Dc, M, F, R, Q, A, 4, dd)
    ifeat = torch.empty(Bq * S, M)
    addfeat = torch.empty(Bq * S, F)
    scores = torch.empty(H, Bq, A)
    do_pred = torch.empty(H, Bq)
    attprob = torch.empty(H, Bq, S)
    c_all = torch.zeros(H + 1, Bq, R)
    h_all = torch.zeros(H + 1, Bq, R)
    for hop in range(H):
        x = HopInputs(mp, dd, q, feats, c_all[hop], h_all[hop],
                      tth._masks(cfg, ((Bq, S, Dc), (Bq, Q), (Bq, M)), seed, hop),
                      ifeat, addfeat)
        v = {}
        for ph in plan.phases:
            forward_phase(ph.name, v, x)
        scores[hop], do_pred[hop], attprob[hop] = v["score"], v["do_pred"], v["sc"]
        c_all[hop + 1], h_all[hop + 1] = v["cn"], v["hn"]
    return scores, do_pred, attprob, c_all, h_all


@functools.lru_cache(maxsize=None)
def _data(dtype):
    """The small configuration's inputs; in bf16 the JAX init scaled by 3,
    which flips no rounding between the frameworks
    (tests/test_torch_port_train_bf16.py)."""
    rs = np.random.RandomState(7)
    params = jrau.init_params(jax.random.PRNGKey(0), JCFG)
    if dtype == "bfloat16":
        mult = jax.tree.map(lambda w: (3.0 * w).astype(jnp.bfloat16), params["mult"])
    else:
        mult = params["mult"]
    mult = jax.tree.map(np.asarray, mult)
    q = rs.randn(B, JCFG.rnnout_dim).astype(np.float32)
    feats = rs.randn(B, JCFG.cnn_spat, JCFG.cnn_dim).astype(np.float32)
    return mult, q, feats


def _port_inputs(dtype, rate):
    """(mp_k, cfg, q_k, feats_k, seed): the kernel's operands, as
    ``_FusedTrainHops`` makes them."""
    mult, q, feats = _data(dtype)
    cfg = port_cfg(JCFG, mult_dropout=rate, compute_dtype=dtype)
    mp_k, q_k, feats_k = tth._kernel_operands(cfg, params_from_jax(mult), torch.as_tensor(q),
                                              torch.as_tensor(feats))
    return mp_k, cfg, q_k, feats_k, torch.tensor([SEED], dtype=torch.int32)


NAMES = ("scores", "do_pred", "attprob", "c_all", "h_all")


@pytest.mark.parametrize("rate", [0.5, 0.0])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_phases_match_the_plain_version(dtype, rate):
    """Every output of the phase decomposition against
    ``train_hops_fwd_reference`` at 1e-6 norm-relative; the wrapper on CPU
    tensors is that plain version, and launches nothing."""
    args = _port_inputs(dtype, rate)
    before = (tth.FWD_KERNEL.launches, tth.FWD_BF16_KERNEL.launches)
    want = tth.train_hops_fwd(*args)
    assert (tth.FWD_KERNEL.launches, tth.FWD_BF16_KERNEL.launches) == before
    got = phase_forward(*args)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype == torch.float32 and g.shape == w.shape, name
        assert norm_rel(g, w) <= 1e-6, name


@functools.lru_cache(maxsize=None)
def _jax_pallas_forward(dtype, rate):
    mult, q, feats = _data(dtype)
    jcfg = dataclasses.replace(JCFG, mult_dropout=rate, compute_dtype=dtype)
    out = jth._run_fwd(jcfg, B, True, mult, jnp.asarray(q), jnp.asarray(feats),
                       jnp.int32(SEED))
    scores, do_pred, attprob, c_all, h_all = (np.asarray(x, np.float32) for x in out)
    return scores, do_pred[..., 0], attprob, c_all, h_all   # do_pred lane-padded


@pytest.mark.parametrize("rate", [0.5, 0.0])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_phases_match_jax_pallas_forward(dtype, rate):
    """The phase decomposition against JAX's Pallas forward (``_run_fwd``)
    in interpret mode: float32 at rtol 1e-5 (atol 1e-5 for the scores, 1e-6
    for the rest), bf16 at 1e-4 norm-relative per output."""
    want = _jax_pallas_forward(dtype, rate)
    got = phase_forward(*_port_inputs(dtype, rate))
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        if dtype == "float32":
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                       atol=1e-5 if name == "scores" else 1e-6, err_msg=name)
        else:
            assert norm_rel(g, torch.tensor(w)) <= 1e-4, name
