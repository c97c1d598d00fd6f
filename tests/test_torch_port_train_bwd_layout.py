"""The host side of the training backward kernel (csrc/rau_train_hops_bwd.cu):
``bwd_plan`` and the kernel's phase decomposition, on the CPU.

``bwd_plan`` lists one hop's launches in the order the C entry enqueues
them.  Its tile GEMMs must cover every output element once (and each split
weight grad every one of the B*S rows once, in ascending chunks), its
workspace must be the size the wrapper allocates, and every phase must fit
a block's shared memory.  On the card, tests/test_torch_port_cuda.py and
chip_smoke.py hold these phases to the grids the built launcher reports.

``phase_backward`` below runs the kernel's phases in plain PyTorch, in the
plan's order (the remat by tests/test_torch_port_train_fwd_layout.py's
``forward_phase``, as the kernel runs the forward's own phases), with the
kernel's in-place overwrites (dpre_add over addfeat,
dpre_i over ifeat), its feats_d and q_d buffers in the product type, its
per-row att_score w partials and its split-K chunks summed in a fixed
order.  It is held to ``train_hops_bwd_reference`` (the kernel's plain
version) at a norm-relative 1e-6 in both types: the two compute the same
products on the same rounded operands and differ only in the order of
float32 sums, and no bf16 rounding follows a sum that the split reorders
(the weight grads are outputs; dqatt and the bias sums are not split).
Through the autograd Function it is held to JAX's Pallas backward in
interpret mode at the bars of tests/test_torch_port_train_hops.py (float32)
and tests/test_torch_port_train_bf16.py (bf16, on inputs that flip no
rounding between the frameworks).
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
from rau_vqa_tpu_torch.convert import map_tree, params_from_jax
from rau_vqa_tpu_torch.ops import rau_train_hops as tth
from tests.test_torch_port_train_fwd_layout import FORWARD_PHASES, HopInputs, forward_phase

JCFG = JaxModelConfig(
    vocab_size=50, answer_size=17, seq_len=9, embed_dim=8, rnn_size=16,
    rnn_layers=2, cnn_dim=12, cnn_w=3, cnn_h=2, multfeat_dim=16,
    attfeat_dim=8, att_rnn_size=16, att_rnn_layers=1, n_hops=3)
B = 8
SEED = 12345
HOP_W = np.asarray([1.0 + 0.5 * h for h in range(JCFG.n_hops)], np.float32)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
OURS = get_preset("ours_ms")
SMEM_LIMIT = 232_448     # a Hopper block's opt-in shared memory


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
                R=cfg.att_state_dim, Q=cfg.rnnout_dim)


def plan_for(cfg, B_, dtype, n_sm=132, **kw):
    w = widths(cfg)
    return tth.bwd_plan(B_, w["S"], w["Dc"], w["M"], w["F"], w["R"], w["Q"], n_sm,
                        dtype, **kw)


# ---------------------------------------------------------------------------
# bwd_plan
# ---------------------------------------------------------------------------

PLAN_CASES = [(OURS, b) for b in (1, 19, 37, 100)] + [(port_cfg(JCFG), B)]
PLAN_IDS = [f"ours_ms-B{b}" for b in (1, 19, 37, 100)] + ["small-B8"]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("cfg,B_", PLAN_CASES, ids=PLAN_IDS)
def test_plan_covers_every_output_tile_once(cfg, B_, dtype):
    """Each GEMM's grid of (BM, BN) tiles covers its [M, N] output exactly
    once a K chunk, with no tile wholly outside it; the products' shapes
    are the hop's."""
    plan = plan_for(cfg, B_, DTYPES[dtype])
    w = widths(cfg)
    P = B_ * w["S"]
    gemms = [p for p in plan.phases if p.tile is not None]
    assert len(gemms) == 20
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
        assert gz == (plan.chunks if ph.split else 1), ph.name
    by = {p.name: p for p in gemms}
    assert (by["ifeat"].M, by["ifeat"].N, by["ifeat"].K) == (P, w["M"], w["Dc"])
    assert (by["i_embed w"].M, by["i_embed w"].N, by["i_embed w"].K) == (w["Dc"], w["M"], P)
    assert (by["att_i w"].M, by["att_i w"].N, by["att_i w"].K) == (w["M"], w["F"], P)
    assert {p.name for p in gemms if p.split} == {"att_i w", "i_embed w"}
    # the [B*S, *] products and the split grads take the big tile
    big = tth.GEMM_TILES[DTYPES[dtype]]["big"][:2]
    assert {p.name for p in gemms if p.tile == big} >= {
        "ifeat", "addfeat", "dpre_i", "att_i w", "i_embed w"}


@pytest.mark.parametrize("n_sm", [1, 4, 132, 1000])
@pytest.mark.parametrize("cfg,B_", PLAN_CASES, ids=PLAN_IDS)
def test_split_chunks_cover_the_rows_once_in_order(cfg, B_, n_sm):
    plan = plan_for(cfg, B_, torch.float32, n_sm=n_sm)
    P = B_ * widths(cfg)["S"]
    bounds = [(z * plan.chunk_rows, min(P, (z + 1) * plan.chunk_rows))
              for z in range(plan.chunks)]
    seen = np.concatenate([np.arange(a, b) for a, b in bounds])
    np.testing.assert_array_equal(seen, np.arange(P))   # once each, ascending
    assert all(a < b for a, b in bounds)                # no empty chunk
    assert plan.chunk_rows % tth.KSTEP == 0
    if n_sm == 132 and cfg is OURS and B_ == 100:
        # about two CTAs a SM for the i_embed w grad's 16 tiles on 132 SMs
        assert plan.chunks * 16 >= 2 * 132 > (plan.chunks - 1) * 16


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("cfg,B_", PLAN_CASES, ids=PLAN_IDS)
def test_buffers_are_what_the_wrapper_allocates_and_fit(cfg, B_, dtype):
    """work_floats is the [B*S, M + F] workspace; every phase's shared
    memory fits a block; the split-K partials of the two weight grads take
    a partial a chunk, not one a row.  (The scratch buffer is the launcher's
    own count, which the card's checks read.)"""
    dt = DTYPES[dtype]
    plan = plan_for(cfg, B_, dt)
    w = widths(cfg)
    P = B_ * w["S"]
    assert plan.work_floats == P * (w["M"] + w["F"])
    for ph in plan.phases:
        assert 0 <= ph.smem <= SMEM_LIMIT, ph.name
    for size in tth.GEMM_TILES[dt]:
        assert 0 < tth.gemm_smem(dt, size) <= SMEM_LIMIT
    by = {p.name: p for p in plan.phases}
    partials = sum(by[n].grid[2] * by[n].M * by[n].N for n in ("att_i w", "i_embed w"))
    assert partials == plan.chunks * (w["Dc"] * w["M"] + w["M"] * w["F"])
    if cfg is OURS and B_ == 100:
        # the old per-row partial grads took B (Dc M + M F) floats: 157 MB
        assert plan.chunks < B_ and partials * 4 < 40e6


@pytest.mark.parametrize("change,match", [
    (dict(B_=0), "at least 1"),
    (dict(S=0), "at least 1"),
    (dict(n_sm=0), "at least 1"),
    (dict(S=12_000), "shared memory"),
    (dict(B_=600_000), "32-bit"),
    (dict(M=0), "at least 1"),
    (dict(Q=-1), "at least 1"),
    (dict(B_=2 ** 28, S=1, Dc=1, M=1, F=1, R=1, Q=1, n_sm=2 ** 20), "65535"),
    (dict(dtype=torch.float16), "float32 or bfloat16"),
])
def test_plan_rejects_shapes_the_kernel_does_not_take(change, match):
    args = dict(B_=100, **widths(OURS), n_sm=132, dtype=torch.float32)
    args.update(change)
    with pytest.raises(ValueError, match=match):
        tth.bwd_plan(args["B_"], args["S"], args["Dc"], args["M"], args["F"], args["R"],
                     args["Q"], args["n_sm"], args["dtype"])


# ---------------------------------------------------------------------------
# The phase decomposition in plain PyTorch
# ---------------------------------------------------------------------------

def phase_backward(mp, cfg, q, feats, seed, c_all, h_all, gmerge, chunk_rows=None):
    """The backward kernel's phases (``bwd_plan``'s, hops in reverse) on
    CPU tensors: (emissions, feats-path grads), as ``train_hops_bwd``;
    ``chunk_rows`` another split of the weight grads' rows than the plan's."""
    dd = tth.dot_dtype(cfg)
    H = cfg.n_hops
    Bq, S, Dc = feats.shape
    Q, M, F, R = q.shape[1], cfg.multfeat_dim, cfg.attfeat_dim, cfg.att_state_dim
    P = Bq * S
    plan = tth.bwd_plan(Bq, S, Dc, M, F, R, Q, 4, dd)
    chunk_rows = chunk_rows or plan.chunk_rows
    lp = mp["attlstm"]["layers"][0]
    W = {"h": mp["h_proj"], "aq": mp["att_q"], "ai": mp["att_i"], "as": mp["att_score"],
         "am": mp["att_mem"], "ap": mp["attprob_proj"], "mg": mp["merge"]}

    def w(k, part="w"):
        return W[k][part].float()

    def r(x):
        return tth._rnd(x, dd)

    def mm(a, b):                     # a product: both operands rounded, f32 sums
        return r(a) @ r(b)

    ifeat = torch.empty(P, M)         # the workspace: ifeat, then dpre_i
    addfeat = torch.empty(P, F)       # addfeat, then dpre_add
    widths_ = {"M": M, "F": F, "S": S, "G": 4 * R}
    em = {name: torch.empty(H, Bq, widths_[wd], dtype=torch.float32 if cot else dd)
          for name, wd, cot in tth._EMITS}
    grads = {("i_embed", "w"): torch.zeros(Dc, M), ("i_embed", "b"): torch.zeros(M),
             ("att_i", "w"): torch.zeros(M, F), ("att_i", "b"): torch.zeros(F),
             ("att_score", "w"): torch.zeros(F, 1)}
    dc = torch.zeros(Bq, R)
    dh = torch.zeros(Bq, R)
    chunks = [(z0, min(P, z0 + chunk_rows)) for z0 in range(0, P, chunk_rows)]

    def split(a, b):                  # a^T b, one partial a chunk of rows
        return [mm(a[z0:z1].T, b[z0:z1]) for z0, z1 in chunks]

    def in_order(parts):              # the reduce kernel's sum, in order
        acc = torch.zeros_like(parts[0])
        for p in parts:
            acc = acc + p
        return acc

    shapes = ((Bq, S, Dc), (Bq, Q), (Bq, M))
    for hop in reversed(range(H)):
        masks = tth._masks(cfg, shapes, seed, hop)
        mmask = masks[2]
        c = c_all[hop]
        x = HopInputs(mp, dd, q, feats, c, h_all[hop], masks, ifeat, addfeat)
        v = {}

        def run(name):
            if name in FORWARD_PHASES:
                forward_phase(name, v, x)
                if name == "qfeat":
                    em["qfeat"][hop] = v["qfeat_t"]
                elif name == "join":
                    em["join"][hop] = v["join_t"]
                elif name == "merge":
                    em["merge_d"][hop] = v["merge_t"]
                    g = gmerge[hop]
                    em["dmerge_pre"][hop] = g * mmask if mmask is not None else g
            elif name == "dh_new":
                v["dhn"] = dh + mm(em["dmerge_pre"][hop], w("mg").T)
            elif name == "cell_bwd":
                ig, gt, fg, og = v["act"]
                tc = torch.tanh(v["cn"])
                dcn = v["dhn"] * og * (1.0 - tc * tc) + dc
                dc[:] = dcn * fg
                em["dgates"][hop] = torch.cat([
                    dcn * gt * ig * (1.0 - ig), dcn * ig * (1.0 - gt * gt),
                    dcn * c * fg * (1.0 - fg), v["dhn"] * tc * og * (1.0 - og)], dim=1)
            elif name == "djoin":
                em["djoin"][hop] = em["dmerge_pre"][hop] + mm(em["dgates"][hop],
                                                              lp["wi"].float().T)
            elif name == "dh_prev":
                v["dhp"] = mm(em["dgates"][hop], lp["wh"].float().T)
            elif name == "djoin Wp^T":
                v["tmp"] = mm(em["djoin"][hop], w("ap").T)
            elif name == "softmax_bwd":
                dj = em["djoin"][hop]
                datt = v["tmp"] + (ifeat.reshape(Bq, S, M) * dj[:, None, :]).sum(2)
                p = v["sc"]
                em["dscore_att"][hop] = p * (datt - (datt * p).sum(1, keepdim=True))
            elif name == "dpre_add":
                ds = em["dscore_att"][hop]
                a = addfeat.reshape(Bq, S, F)
                v["aspart"] = (r(a) * r(ds)[:, :, None]).sum(1)         # [B, F]
                addfeat[:] = ((ds[:, :, None] * w("as").reshape(1, 1, F))
                              * (1.0 - a * a)).reshape(P, F)
                em["dqatt"][hop] = addfeat.reshape(Bq, S, F).sum(1)
            elif name == "dscore Wmem^T":
                v["dhp"] = v["dhp"] + mm(em["dscore_att"][hop], w("am").T)
            elif name == "dpre_q":
                em["dpre_q"][hop] = (em["djoin"][hop] + mm(em["dqatt"][hop], w("aq").T)) \
                    * (1.0 - v["qfeat"] ** 2)
            elif name == "dh":
                dh[:] = v["dhp"] + mm(em["dpre_q"][hop], w("h").T)
            elif name == "att_i w":
                v["part6"] = split(ifeat, addfeat)
            elif name == "dpre_i":
                pj = v["sc"].reshape(P, 1) * em["djoin"][hop].repeat_interleave(S, 0)
                ifeat[:] = (pj + mm(addfeat, w("ai").T)) * (1.0 - ifeat ** 2)
            elif name == "i_embed w":
                v["part8"] = split(v["fd"], ifeat)
            elif name == "colsum":
                v["partb"] = [ifeat[z0:z0 + tth.COLSUM_ROWS].sum(0)
                              for z0 in range(0, P, tth.COLSUM_ROWS)]
            elif name == "reduce":
                for path, parts in ((("i_embed", "w"), v["part8"]),
                                    (("i_embed", "b"), v["partb"]),
                                    (("att_i", "w"), v["part6"]),
                                    (("att_i", "b"), list(em["dqatt"][hop])),
                                    (("att_score", "w"), list(v["aspart"]))):
                    grads[path] += in_order(parts).reshape(grads[path].shape)
            else:
                raise AssertionError(f"no phase {name}")

        for ph in plan.phases:
            run(ph.name)
    return em, grads


def _port_inputs(params_mult, cfg, q, feats, labels):
    """The kernels' operands and the backward's inputs, as ``_bwd_kernel``
    makes them: (mp_k, q_k, feats_k, seed, c_all, h_all, gmerge)."""
    dd = tth.dot_dtype(cfg)
    mp = params_from_jax(params_mult)
    mp_k, q_k, feats_k = tth._kernel_operands(cfg, mp, torch.as_tensor(q),
                                              torch.as_tensor(feats))
    seed = torch.tensor([SEED], dtype=torch.int32)
    scores, _, _, c_all, h_all = tth.train_hops_fwd(mp_k, cfg, q_k, feats_k, seed)
    s = scores.detach().requires_grad_()
    logp = torch.log_softmax(s, dim=-1)
    idx = torch.as_tensor(labels).long()[None, :, None].expand(s.shape[0], -1, 1)
    loss = torch.sum(torch.as_tensor(HOP_W) * (-logp.gather(-1, idx)[..., 0]).mean(1))
    g_scores, = torch.autograd.grad(loss, s)
    H, Bq = g_scores.shape[:2]
    gmerge = (tth._rnd(g_scores.reshape(H * Bq, -1), dd)
              @ tth._rnd(mp["cls"]["w"], dd).T).reshape(H, Bq, -1)
    return mp_k, q_k, feats_k, seed, c_all, h_all, gmerge.contiguous()


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
    labels = rs.randint(0, JCFG.answer_size, B).astype(np.int32)
    return mult, q, feats, labels


@pytest.mark.parametrize("rate", [0.5, 0.0])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_phases_match_the_plain_version(dtype, rate):
    """Every emission and feats-path grad of the phase decomposition against
    ``train_hops_bwd_reference`` at 1e-6 norm-relative (att_i b's at 1e-6
    of its terms' size), with the plan's two chunks of the 48 rows and with
    one."""
    mult, q, feats, labels = _data(dtype)
    cfg = port_cfg(JCFG, mult_dropout=rate, compute_dtype=dtype)
    args = _port_inputs(mult, cfg, q, feats, labels)
    want_em, want_g = tth.train_hops_bwd_reference(*args[:1], cfg, *args[1:])
    for chunk_rows in (None, 64):
        em, g = phase_backward(args[0], cfg, *args[1:], chunk_rows=chunk_rows)
        for name, _, _ in tth._EMITS:
            assert em[name].dtype == want_em[name].dtype, name
            assert norm_rel(em[name].float(), want_em[name].float()) <= 1e-6, name
        for path in tth._INKERNEL_GRADS:
            assert g[path].shape == want_g[path].shape, path
            if path == ("att_i", "b"):
                # the sum of H*B*S dpre_add rows, which cancel to ~1e-2 of
                # their size: held to 1e-6 of its terms' bound,
                # |dpre_add[., f]| <= |dscore| |w_score[f]|
                ws = args[0]["att_score"]["w"].float().reshape(-1)
                scale = (want_em["dscore_att"].abs().sum() * ws.abs()).norm().item()
                assert (g[path] - want_g[path]).norm().item() <= 1e-6 * scale, path
            else:
                assert norm_rel(g[path], want_g[path]) <= 1e-6, path


@functools.lru_cache(maxsize=None)
def _jax_pallas_grads(dtype, rate):
    mult, q, feats, labels = _data(dtype)
    jcfg = dataclasses.replace(JCFG, mult_dropout=rate, compute_dtype=dtype,
                               fused_train_bwd="kernel")

    def loss(mp, q_):
        s = jth.rau_train_hops(mp, jcfg, q_, jnp.asarray(feats), jnp.int32(SEED),
                               block_b=B, interpret=True)[0]
        logp = jax.nn.log_softmax(s, axis=-1)
        nll = -jnp.take_along_axis(logp, jnp.asarray(labels)[None, :, None], -1)[..., 0]
        return jnp.sum(jnp.asarray(HOP_W) * jnp.mean(nll, axis=1))

    return jax.grad(loss, argnums=(0, 1))(mult, jnp.asarray(q))


@pytest.mark.parametrize("rate", [0.5, 0.0])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_phases_match_jax_pallas_backward(dtype, rate, monkeypatch):
    """The whole hand-derived backward with the phase decomposition in the
    kernel's place, through the autograd Function, against JAX's Pallas
    backward in interpret mode: float32 at rtol 2e-4 / atol 1e-5 per
    element, bf16 at 1e-4 norm-relative per leaf; do_pred's grads zero."""
    mult, q, feats, labels = _data(dtype)
    gmp, gq = _jax_pallas_grads(dtype, rate)
    cfg = port_cfg(JCFG, mult_dropout=rate, compute_dtype=dtype, fused_train_bwd="kernel")
    monkeypatch.setattr(tth, "train_hops_bwd", phase_backward)
    mp = map_tree(lambda w: w.requires_grad_(), params_from_jax(mult))
    q_t = torch.as_tensor(q).requires_grad_()
    scores = tth.rau_train_hops(mp, cfg, q_t, torch.as_tensor(feats), SEED)[0]
    logp = torch.log_softmax(scores, dim=-1)
    idx = torch.as_tensor(labels).long()[None, :, None].expand(scores.shape[0], -1, 1)
    torch.sum(torch.as_tensor(HOP_W) * (-logp.gather(-1, idx)[..., 0]).mean(1)).backward()
    for path, want in jax.tree_util.tree_leaves_with_path(gmp):
        g = mp
        for k in path:
            g = g[k.key if hasattr(k, "key") else k.idx]
        got, name = g.grad, jax.tree_util.keystr(path)
        want = torch.tensor(np.asarray(want, np.float32))
        if path[0].key == "do_pred":
            assert torch.all(got == 0) and not want.any(), name
        elif dtype == "float32":
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4, atol=1e-5,
                                       err_msg=name)
        elif path[0].key == "att_score" and path[1].key == "b":
            # zero in exact arithmetic: rounding noise on both sides
            assert abs(got.float().item()) <= 1e-6 and abs(want.item()) <= 1e-6, name
        else:
            assert norm_rel(got.float(), want) <= 1e-4, name
    gq = torch.tensor(np.asarray(gq, np.float32))
    if dtype == "float32":
        np.testing.assert_allclose(q_t.grad.numpy(), gq.numpy(), rtol=2e-4, atol=1e-5)
    else:
        assert norm_rel(q_t.grad, gq) <= 1e-4
