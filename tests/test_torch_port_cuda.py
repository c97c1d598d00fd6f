"""The port's CUDA kernels against their plain versions, on the card.

Needs a CUDA device: every test takes the ``cuda_device`` fixture, which
skips without one.  The module imports no JAX, so it runs where only PyTorch
is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Shapes are the ``ours_ms`` widths.  Serving kernels: the bars of
tests/test_pallas_rau.py for the Pallas kernels against their XLA paths;
the encoder also at lengths 0, T and T + 1, on two calls (the same bits),
at 1 layer of 256, and with a grid that cannot be co-resident (it raises);
the hop loop at B in {1, 19, 83, 512}, two calls bit-equal, ``hops_plan``'s
phases the launcher's own (a dry run of it), the device kernels of a call
as the profiler records them the launcher's, and a scratch buffer the
launcher cannot run raises.
Training kernels (float32): the mask hash bit for bit; the forward at rtol
1e-4 / atol 1e-4 over 8 recurrent hops of float32 sums taken in another
order (two calls bit-equal in both types; a scratch buffer the launcher
cannot run raises; ``fwd_plan``'s phases are the launcher's own, by a dry
run of it); the backward's grads at a norm-relative error of 1e-3 per leaf, and
its emissions and feats-path grads against its plain version at B in {1,
19, 37, 100} (two calls bit-equal; a plan the launcher cannot run raises;
``bwd_plan``'s phases are the launcher's own, by a dry run of it).
Their bf16 instantiations at the bars of chip_smoke.py (one hop: each output
and grad leaf within ``TRAIN_BF16_BARS``, each bar under half the float32
distance; eight hops: ``train_bf16_deep_bar``, within twice the plain
version's own drift on the host and under 3/4 of the float32 distance); the
bf16 fused step and the unfused step, float32 and bf16, on the card.
From pixels: the identity-stage kernel at scale-normalised bars, and
``answer_pixels`` (``ours_resnet`` head, bf16 ResNet-101 at 448 px) against
``pixels_forward`` at the bars of chip_smoke.py's pixels phase; the stage
checks take their bars and random stacks from chip_smoke.py.  VGG16 and
ViT-L/14 from pixels: both serving kernels at ``ours_vit`` widths (S 256,
D 1024) against their plain versions at the serving bars, two calls
bit-equal, the hop kernel's plan the launcher's; ``answer_pixels`` of each
backbone against ``pixels_forward`` at the pixels phase's bars;
``quantize_feats_device`` bit for bit the host writer's, and
``precompute_features`` on the card against ``extract_features``.
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from chip_smoke import (
    device_kernels,
    norm_rel,
    scaled_err,
    stage_bar,
    stage_faults,
    stage_stack,
    train_bf16_bar,
    train_bf16_deep_bar,
    train_bf16_readings,
)
from rau_vqa_tpu_torch.config import get_preset, get_train_preset
from rau_vqa_tpu_torch.convert import map_tree, tree_leaves
from rau_vqa_tpu_torch.eval.predict import (
    _aggregate,
    compute_answers,
    make_predict_step,
    pack_kernel_weights,
    predict,
    predict_fused,
)
from rau_vqa_tpu_torch.models.backbones.resnet import fold_batchnorm, resnet101_init
from rau_vqa_tpu_torch.models.backbones.vgg import vgg16_pool5_init
from rau_vqa_tpu_torch.models.backbones.vit import VIT_L14, vit_init
from rau_vqa_tpu_torch.models.pipeline import (
    answer_pixels,
    extract_features,
    pixels_forward,
)
from rau_vqa_tpu_torch.models.rau import embed_image, embed_question, init_params
from rau_vqa_tpu_torch.ops import (
    fused_resnet,
    lstm_encoder,
    maskgen,
    rau_hops,
    rau_train_hops,
)
from rau_vqa_tpu_torch.train.trainer import init_train_state, make_train_step

pytestmark = pytest.mark.cuda

CFG = get_preset("ours_ms")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, dev, seed=0, cfg=CFG):
    params = init_params(cfg, torch.Generator().manual_seed(seed), dev)
    rs = np.random.RandomState(seed)
    lengths = rs.randint(1, cfg.seq_len + 1, B).astype(np.int32)
    tokens = np.zeros((B, cfg.seq_len), np.int64)
    for k in range(B):
        tokens[k, :lengths[k]] = rs.randint(1, cfg.vocab_size, lengths[k])
    feats = np.abs(rs.randn(B, cfg.cnn_spat, cfg.cnn_dim)).astype(np.float32)
    return (params, torch.as_tensor(tokens, device=dev),
            torch.as_tensor(lengths, device=dev),
            torch.as_tensor(feats, device=dev))


def _encoder_inputs(cfg, B, T, dev, seed=0, lengths=None):
    """(packed weights, emb [B, T, E], lengths) for ``cfg``'s encoder; lengths
    random in [1, T] unless given."""
    params = init_params(cfg, torch.Generator().manual_seed(seed), dev)
    rs = np.random.RandomState(seed)
    if lengths is None:
        lengths = rs.randint(1, T + 1, B)
    tokens = torch.as_tensor(rs.randint(1, cfg.vocab_size, (B, T)), device=dev)
    emb = embed_question(params, tokens).contiguous()
    return (lstm_encoder.pack_encoder_weights(params["rnn"]), emb,
            torch.as_tensor(np.asarray(lengths, np.int32), device=dev))


def _encode_and_check(cfg, enc, emb, lengths):
    got = lstm_encoder.lstm_encode(enc, cfg, emb, lengths)
    want = lstm_encoder.lstm_encode_reference(enc, cfg, emb, lengths,
                                              dot_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert got.shape == (emb.shape[0], cfg.rnnout_dim)
    torch.testing.assert_close(got, want, rtol=0.05, atol=5e-3)
    return got


@pytest.mark.parametrize("T", [8, 26])
@pytest.mark.parametrize("B", [1, 3, 19, 83, 512])
def test_lstm_encode_matches_plain(cuda_device, B, T):
    enc, emb, lengths = _encoder_inputs(CFG, B, T, cuda_device)
    before = lstm_encoder.KERNEL.launches
    _encode_and_check(CFG, enc, emb, lengths)
    assert lstm_encoder.KERNEL.launches == before + 1


def test_lstm_encode_zero_rows_and_full_lengths(cuda_device):
    """Rows of length 0 and T + 1 stay zero; a batch where every length is T."""
    T = 26
    enc, emb, lengths = _encoder_inputs(CFG, 5, T, cuda_device, lengths=[3, 0, T, T + 1, 1])
    got = _encode_and_check(CFG, enc, emb, lengths)
    assert torch.all(got[1] == 0) and torch.all(got[3] == 0)
    assert torch.all(got[[0, 2, 4]].abs().amax(1) > 0)
    enc, emb, lengths = _encoder_inputs(CFG, 40, T, cuda_device, lengths=[T] * 40)
    _encode_and_check(CFG, enc, emb, lengths)


@pytest.mark.parametrize("B", [1, 512])
def test_lstm_encode_is_deterministic(cuda_device, B):
    enc, emb, lengths = _encoder_inputs(CFG, B, 26, cuda_device, seed=3)
    first = lstm_encoder.lstm_encode(enc, CFG, emb, lengths)
    second = lstm_encoder.lstm_encode(enc, CFG, emb, lengths)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_lstm_encode_one_layer_r256(cuda_device):
    cfg = dataclasses.replace(CFG, rnn_size=256, rnn_layers=1)
    for B in (2, 200):
        enc, emb, lengths = _encoder_inputs(cfg, B, 12, cuda_device, seed=B)
        _encode_and_check(cfg, enc, emb, lengths)


def test_lstm_encode_raises_when_the_grid_cannot_be_co_resident(cuda_device):
    """A plan with more CTAs than the card holds at once is refused at
    launch: the wrapper raises and runs nothing in its place."""
    enc, emb, lengths = _encoder_inputs(CFG, 4, 8, cuda_device)
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    # 5 row groups of 256 CTAs: more than 4 a SM, the most 512-thread CTAs
    # a SM can hold
    plan = lstm_encoder.lstm_plan(4, CFG.embed_dim, CFG.rnn_size, CFG.rnn_layers,
                                  n_sm=10 ** 4, row_groups=5)
    assert plan.ctas > 4 * n_sm
    before = lstm_encoder.KERNEL.launches
    with pytest.raises(RuntimeError, match="failed to launch"):
        lstm_encoder.lstm_encode(enc, CFG, emb, lengths, plan=plan)
    assert lstm_encoder.KERNEL.launches == before


def _hops_inputs(B, dev, seed=0, cfg=CFG):
    """The hop kernel's inputs at ``cfg``'s widths (ours_ms by default):
    (hw, q, ifeat, iatt), the features in bf16 as ``predict_fused`` casts
    them."""
    params, tokens, lengths, feats = _inputs(B, dev, seed, cfg)
    hw = rau_hops.pack_hop_weights(params["mult"])
    q = lstm_encoder.lstm_encode_reference(
        params["rnn"], cfg, embed_question(params, tokens), lengths)
    ifeat, iatt = embed_image(params["mult"], feats)
    return hw, q, ifeat.to(torch.bfloat16).contiguous(), iatt.to(torch.bfloat16).contiguous()


@pytest.mark.parametrize("B", [1, 19, 83, 512])
def test_rau_hops_matches_plain(cuda_device, B):
    """The serving bars of tests/test_pallas_rau.py (scores rtol 0.05 / atol
    0.01 and argmax agreement > 0.97, attprob atol 5e-4, do_pred atol 5e-3)
    at the service's latency case, ragged batches and bulk eval; a second
    call gives the same bits; one launch counted a call."""
    hw, q, ifeat, iatt = _hops_inputs(B, cuda_device)
    before = rau_hops.KERNEL.launches
    s, d, a = rau_hops.rau_hops(hw, CFG, q, ifeat, iatt)
    again = rau_hops.rau_hops(hw, CFG, q, ifeat, iatt)
    s_ref, d_ref, a_ref = rau_hops.rau_hops_reference(
        hw, CFG, q, ifeat, iatt, dot_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert rau_hops.KERNEL.launches == before + 2
    assert all(torch.equal(x, y) for x, y in zip((s, d, a), again))
    assert s.shape == (CFG.n_hops, B, CFG.answer_size)
    agree = (s.argmax(-1) == s_ref.argmax(-1)).float().mean().item()
    print(f"rau_hops B={B}: scores {(s - s_ref).abs().max().item():.3e} (atol 0.01, rtol "
          f"0.05), argmax agreement {agree:.4f} (> 0.97), attprob "
          f"{(a - a_ref).abs().max().item():.3e} (atol 5e-4), do_pred "
          f"{(d - d_ref).abs().max().item():.3e} (atol 5e-3)")
    torch.testing.assert_close(s, s_ref, rtol=0.05, atol=0.01)
    assert agree > 0.97
    torch.testing.assert_close(a, a_ref, rtol=0.05, atol=5e-4)
    torch.testing.assert_close(d, d_ref, rtol=0.05, atol=5e-3)


_HOPS_WIDTHS = (CFG.rnnout_dim, CFG.cnn_spat, CFG.multfeat_dim, CFG.attfeat_dim,
                CFG.att_rnn_size, CFG.answer_size)


@pytest.mark.parametrize("B", [1, 4, 19, 37, 83, 512])
def test_hops_plan_is_the_launchers(cuda_device, B):
    """hops_plan's phases are the launches the built C entry makes (a dry
    run of a one-hop call): the same count, the same grids, shared memory
    within the plan's."""
    plan = rau_hops.hops_plan(B, CFG)
    scratch, launches = rau_hops.hops_launcher_plan(B, *_HOPS_WIDTHS)
    assert scratch > 0
    assert [l[:3] for l in launches] == [ph.grid for ph in plan.phases]
    assert all(l[3] <= ph.smem for l, ph in zip(launches, plan.phases))


@pytest.mark.parametrize("B", [1, 83])
def test_rau_hops_device_kernels_are_the_launchers(cuda_device, B):
    """The device kernels of one call, as torch.profiler records them
    (memsets and copies not counted), are the launcher's: its two setup
    launches and one hop's launches for each hop."""
    hw, q, ifeat, iatt = _hops_inputs(B, cuda_device)
    plan = rau_hops.hops_plan(B, CFG)
    _, launches = rau_hops.hops_launcher_plan(B, *_HOPS_WIDTHS)
    want = len(plan.setup) + CFG.n_hops * (len(launches) - len(plan.setup))
    with torch.no_grad():
        # raises where a call's kernel records (or, where the profiler lost
        # some, its launch records) are not ``want``
        device_kernels(lambda: rau_hops.rau_hops(hw, CFG, q, ifeat, iatt), want,
                       f"rau_hops B={B}", torch.cuda.get_device_name(0))
    assert want == plan.kernels(CFG.n_hops)


@pytest.mark.parametrize("short", [64, None], ids=["scratch_short", "scratch_none"])
def test_rau_hops_raises_for_a_plan_it_cannot_run(cuda_device, short):
    """The C entry refuses a scratch buffer shorter than it carves; nothing
    is counted."""
    hw, q, ifeat, iatt = _hops_inputs(19, cuda_device)
    scratch, _ = rau_hops.hops_launcher_plan(19, *_HOPS_WIDTHS)
    before = rau_hops.KERNEL.launches
    with pytest.raises(RuntimeError, match="failed to launch"):
        rau_hops._launch(hw, CFG, q, ifeat, iatt, scratch - short if short else 0)
    assert rau_hops.KERNEL.launches == before


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


# ---------------------------------------------------------------------------
# training kernels
# ---------------------------------------------------------------------------

TRAIN_CFG = dataclasses.replace(CFG, fused_train=True)


def _train_inputs(B, dev, seed=0):
    params, *_, feats = _inputs(B, dev, seed)
    q = 0.5 * torch.randn(B, CFG.rnnout_dim, device=dev,
                          generator=torch.Generator(dev).manual_seed(seed))
    return params["mult"], q, feats


@pytest.mark.parametrize("seed", [0, 12345, 2 ** 31 - 2])
def test_mask_hash_matches_plain_bit_for_bit(cuda_device, seed):
    B, row0 = 19, 37
    seed_t = torch.tensor([seed], dtype=torch.int32, device=cuda_device)
    widths = {0: (CFG.cnn_spat, CFG.cnn_dim), 1: (CFG.rnnout_dim,),
              2: (CFG.multfeat_dim,)}
    for hop in (0, 7):
        for site, rest in widths.items():
            got = maskgen.dropout_mask(seed_t, hop, site, (B,) + rest, row0, 0.5)
            want = maskgen.dropout_scale_mask(
                (B,) + rest, row0, maskgen.site_salt(seed, hop, site), 0.5)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("B", [19, 100])
def test_train_hops_fwd_matches_plain(cuda_device, B):
    mp, q, feats = _train_inputs(B, cuda_device)
    seed = torch.tensor([4242], dtype=torch.int32, device=cuda_device)
    got = rau_train_hops.train_hops_fwd(mp, TRAIN_CFG, q, feats, seed)
    want = rau_train_hops.train_hops_fwd_reference(mp, TRAIN_CFG, q, feats, seed)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


_FWD_WIDTHS = (CFG.cnn_spat, CFG.cnn_dim, CFG.multfeat_dim, CFG.attfeat_dim,
               CFG.att_state_dim, CFG.rnnout_dim, CFG.answer_size)


def _fwd_call(B, dev, dtype, seed=3):
    """The forward's inputs at ours_ms widths in ``dtype``: (mp, cfg, q,
    feats, seed)."""
    cfg = dataclasses.replace(TRAIN_CFG, compute_dtype="float32" if dtype == torch.float32
                              else "bfloat16")
    mp, q, feats = _train_inputs(B, dev, seed=seed)
    mp = map_tree(lambda w: w.to(dtype), mp)
    s = torch.tensor([seed], dtype=torch.int32, device=dev)
    return mp, cfg, q.to(dtype), feats.to(dtype), s


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_hops_fwd_is_deterministic_and_counted(cuda_device, dtype):
    """Two calls of the forward on the same inputs give the same bits; one
    launch of its instantiation counted a call."""
    args = _fwd_call(100, cuda_device, dtype)
    kernel = rau_train_hops._KERNELS[dtype][0]
    before = kernel.launches
    got = rau_train_hops.train_hops_fwd(*args)
    again = rau_train_hops.train_hops_fwd(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    assert all(torch.isfinite(g).all() for g in got)


@pytest.mark.parametrize("short", [64, None], ids=["scratch_short", "scratch_none"])
def test_train_hops_fwd_raises_for_a_plan_it_cannot_run(cuda_device, short):
    """The C entry refuses a scratch buffer shorter than it carves; nothing
    is counted."""
    args = _fwd_call(19, cuda_device, torch.float32)
    scratch, _ = rau_train_hops.fwd_launcher_plan(19, *_FWD_WIDTHS, torch.float32)
    before = rau_train_hops.FWD_KERNEL.launches
    with pytest.raises(RuntimeError, match="failed to launch"):
        rau_train_hops._launch_fwd(*args, scratch - short if short else 0)
    assert rau_train_hops.FWD_KERNEL.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 19, 37, 100])
def test_fwd_plan_is_the_launchers(cuda_device, B, dtype):
    """fwd_plan's phases are the launches the built C entry makes (a dry
    run of it): the same count, the same grids, shared memory within the
    plan's."""
    plan = rau_train_hops.fwd_plan(B, *_FWD_WIDTHS, _n_sm(), dtype)
    scratch, launches = rau_train_hops.fwd_launcher_plan(B, *_FWD_WIDTHS, dtype)
    assert scratch > 0
    assert [l[:3] for l in launches] == [ph.grid for ph in plan.phases]
    assert all(l[3] <= ph.smem for l, ph in zip(launches, plan.phases))


def test_train_hops_bwd_matches_autograd(cuda_device):
    B = 19
    mp, q, feats = _train_inputs(B, cuda_device, seed=1)
    labels = torch.randint(0, CFG.answer_size, (B,), device=cuda_device)
    hop_w = torch.tensor([1.0 + 0.5 * h for h in range(CFG.n_hops)],
                         device=cuda_device)

    def grads(bwd):
        cfg = dataclasses.replace(TRAIN_CFG, fused_train_bwd=bwd)
        mp_ = map_tree(lambda w: w.detach().clone().requires_grad_(), mp)
        q_ = q.clone().requires_grad_()
        s = rau_train_hops.rau_train_hops(mp_, cfg, q_, feats, 99)[0]
        ce = torch.nn.functional.cross_entropy(
            s.reshape(-1, s.shape[-1]), labels.repeat(CFG.n_hops),
            reduction="none").reshape(CFG.n_hops, B).mean(1)
        (hop_w * ce).sum().backward()
        return mp_, q_.grad

    before = rau_train_hops.BWD_KERNEL.launches
    got, dq = grads("kernel")
    assert rau_train_hops.BWD_KERNEL.launches == before + 1
    want, dq_ref = grads("xla")
    torch.cuda.synchronize()
    for path in rau_train_hops._DIFF_WEIGHTS:
        g = rau_train_hops.pluck(got, path).grad
        w = rau_train_hops.pluck(want, path).grad
        if path == ("att_score", "b"):   # zero in exact arithmetic
            assert g.abs().max() < 1e-5 and w.abs().max() < 1e-5
            continue
        assert ((g - w).norm() / w.norm()).item() <= 1e-3, path
    assert ((dq - dq_ref).norm() / dq_ref.norm()).item() <= 1e-3
    assert torch.all(got["do_pred"]["w"].grad == 0)


@pytest.mark.parametrize("H,B", [(1, 19), (8, 19), (8, 100)])
def test_train_hops_bf16_match_plain(cuda_device, H, B):
    """The bf16 kernels against their bf16 plain versions: at one hop within
    TRAIN_BF16_BARS, each under half the float32 plain version's distance
    (a product left unrounded lands beyond it); at eight hops within
    train_bf16_deep_bar."""
    cfg = dataclasses.replace(TRAIN_CFG, compute_dtype="bfloat16", n_hops=H)
    mp, _, _ = _train_inputs(B, cuda_device, seed=2)
    readings = train_bf16_readings(rau_train_hops, cfg, mp, B, np.random.RandomState(3),
                                   cuda_device, host=H > 1)
    for kind, per in readings.items():
        for name, r in per.items():
            if H > 1:
                assert r["kernel"] <= train_bf16_deep_bar(r), (kind, name, r)
            elif r["float32"] == 0:     # no bf16 product reaches it
                assert r["kernel"] == 0, (kind, name, r)
            else:
                bar = train_bf16_bar(kind, name)
                assert r["kernel"] <= bar < 0.5 * r["float32"], (kind, name, r)


def _bwd_call(B, dev, dtype, seed=5):
    """The backward's inputs at ours_ms widths: (mp, cfg, q, feats, seed,
    c_all, h_all, gmerge) in ``dtype``, the carries from the forward kernel."""
    cfg = dataclasses.replace(TRAIN_CFG, compute_dtype="float32" if dtype == torch.float32
                              else "bfloat16")
    mp, q, feats = _train_inputs(B, dev, seed=seed)
    mp = map_tree(lambda w: w.to(dtype), mp)
    q, feats = q.to(dtype), feats.to(dtype)
    s = torch.tensor([seed], dtype=torch.int32, device=dev)
    _, _, _, c_all, h_all = rau_train_hops.train_hops_fwd(mp, cfg, q, feats, s)
    g = 1e-3 * torch.randn(CFG.n_hops, B, CFG.answer_size, device=dev,
                           generator=torch.Generator(dev).manual_seed(seed))
    gmerge = (rau_train_hops._rnd(g, dtype) @ rau_train_hops._rnd(mp["cls"]["w"], dtype).T)
    return mp, cfg, q, feats, s, c_all, h_all, gmerge.contiguous()


@pytest.mark.parametrize("B", [1, 19, 37, 100])
def test_train_hops_bwd_matches_plain_at_each_batch(cuda_device, B):
    """The float32 backward's emissions and feats-path grads against its
    plain version, norm-relative 1e-3 each (the grad bar), at batches that
    fill no tile (1, 37), a ragged one (19) and the main path's (100); one
    launch counted a call; two calls give the same bits."""
    args = _bwd_call(B, cuda_device, torch.float32)
    before = rau_train_hops.BWD_KERNEL.launches
    em, gw = rau_train_hops.train_hops_bwd(*args)
    assert rau_train_hops.BWD_KERNEL.launches == before + 1
    em2, gw2 = rau_train_hops.train_hops_bwd(*args)
    want_em, want_gw = rau_train_hops.train_hops_bwd_reference(*args)
    torch.cuda.synchronize()
    for k in em:
        assert ((em[k] - want_em[k]).norm() / want_em[k].norm()).item() <= 1e-3, k
        assert torch.equal(em[k], em2[k]), k
    for k in gw:
        assert ((gw[k] - want_gw[k]).norm() / want_gw[k].norm()).item() <= 1e-3, k
        assert torch.equal(gw[k], gw2[k]), k


@pytest.mark.parametrize("H,B", [(1, 1), (1, 37), (8, 37)])
def test_train_hops_bf16_match_plain_at_ragged_batches(cuda_device, H, B):
    """The bf16 kernels at the bars of test_train_hops_bf16_match_plain, at
    batches that fill no tile."""
    cfg = dataclasses.replace(TRAIN_CFG, compute_dtype="bfloat16", n_hops=H)
    mp, _, _ = _train_inputs(B, cuda_device, seed=4)
    readings = train_bf16_readings(rau_train_hops, cfg, mp, B, np.random.RandomState(6),
                                   cuda_device, host=H > 1)
    for name, r in readings["bwd"].items():
        if H > 1:
            assert r["kernel"] <= train_bf16_deep_bar(r), (name, r)
        elif r["float32"] == 0:
            assert r["kernel"] == 0, (name, r)
        else:
            assert r["kernel"] <= train_bf16_bar("bwd", name), (name, r)


def test_train_hops_bwd_bf16_is_deterministic_and_counted(cuda_device):
    args = _bwd_call(100, cuda_device, torch.bfloat16)
    before = rau_train_hops.BWD_BF16_KERNEL.launches
    em, gw = rau_train_hops.train_hops_bwd(*args)
    em2, gw2 = rau_train_hops.train_hops_bwd(*args)
    torch.cuda.synchronize()
    assert rau_train_hops.BWD_BF16_KERNEL.launches == before + 2
    assert all(torch.equal(em[k], em2[k]) for k in em)
    assert all(torch.equal(gw[k], gw2[k]) for k in gw)


@pytest.mark.parametrize("B", [1, 19, 100])
def test_train_hops_bwd_dfeats_matches_plain(cuda_device, B):
    """The float32 backward with the features' gradient: dfeats and every
    emission and grad against the plain version, norm-relative 1e-3; two
    calls give the same bits; the emissions and grads are those of the call
    without dfeats, bit for bit; each call counted in BWD_DFEATS_KERNEL
    alone."""
    args = _bwd_call(B, cuda_device, torch.float32)
    k0, k1 = rau_train_hops.BWD_KERNEL, rau_train_hops.BWD_DFEATS_KERNEL
    before = (k0.launches, k1.launches)
    em, gw = rau_train_hops.train_hops_bwd(*args, dfeats=True)
    em2, gw2 = rau_train_hops.train_hops_bwd(*args, dfeats=True)
    assert (k0.launches, k1.launches) == (before[0], before[1] + 2)
    em0, gw0 = rau_train_hops.train_hops_bwd(*args)
    want_em, want_gw = rau_train_hops.train_hops_bwd_reference(*args, dfeats=True)
    torch.cuda.synchronize()
    df = rau_train_hops.DFEATS
    assert gw[df].shape == args[3].shape and df not in gw0
    for k in gw:
        assert norm_rel(gw[k], want_gw[k]) <= 1e-3, k
        assert torch.equal(gw[k], gw2[k]), k
        assert k == df or torch.equal(gw[k], gw0[k]), k
    for k in em:
        assert norm_rel(em[k], want_em[k]) <= 1e-3, k
        assert torch.equal(em[k], em0[k]), k


@pytest.mark.parametrize("H,B", [(1, 19), (1, 100), (8, 100)])
def test_train_hops_bwd_bf16_dfeats_at_the_bf16_bars(cuda_device, H, B):
    """The bf16 backward's features gradient against its bf16 plain version
    at the backward's bf16 bars: one hop within TRAIN_BF16_BARS' weights
    bar, under half the float32 plain version's distance; eight hops within
    train_bf16_deep_bar.  Two calls give the same bits."""
    cfg = dataclasses.replace(TRAIN_CFG, compute_dtype="bfloat16", n_hops=H)
    mp, _, _ = _train_inputs(B, cuda_device, seed=8)
    readings = train_bf16_readings(rau_train_hops, cfg, mp, B, np.random.RandomState(9),
                                   cuda_device, host=H > 1, dfeats=True)
    r = readings["bwd"]["feats"]
    if H > 1:
        assert r["kernel"] <= train_bf16_deep_bar(r), r
    else:
        assert r["kernel"] <= train_bf16_bar("bwd", "feats") < 0.5 * r["float32"], r
    args = _bwd_call(B, cuda_device, torch.bfloat16)
    before = rau_train_hops.BWD_DFEATS_BF16_KERNEL.launches
    _, gw = rau_train_hops.train_hops_bwd(*args, dfeats=True)
    _, gw2 = rau_train_hops.train_hops_bwd(*args, dfeats=True)
    torch.cuda.synchronize()
    assert rau_train_hops.BWD_DFEATS_BF16_KERNEL.launches == before + 2
    assert all(torch.equal(gw[k], gw2[k]) for k in gw)


_BWD_WIDTHS = (CFG.cnn_spat, CFG.cnn_dim, CFG.multfeat_dim, CFG.attfeat_dim,
               CFG.att_state_dim, CFG.rnnout_dim)


@pytest.mark.parametrize("change", [dict(chunk_rows=48), dict(chunk_rows=0),
                                    dict(scratch_floats=-64)],
                         ids=["chunk_rows_48", "chunk_rows_0", "scratch_short"])
def test_train_hops_bwd_raises_for_a_plan_it_cannot_run(cuda_device, change):
    """The C entry refuses a split of the rows that is not a multiple of 32
    and a scratch buffer shorter than it carves; nothing is counted."""
    args = _bwd_call(19, cuda_device, torch.float32)
    plan = rau_train_hops.bwd_plan(19, *_BWD_WIDTHS, _n_sm(), torch.float32)
    scratch, _ = rau_train_hops.launcher_plan(19, *_BWD_WIDTHS, torch.float32,
                                              plan.chunk_rows)
    run = dict(chunk_rows=plan.chunk_rows, scratch_floats=scratch)
    run.update(change)
    if "scratch_floats" in change:
        run["scratch_floats"] = scratch + change["scratch_floats"]
    before = rau_train_hops.BWD_KERNEL.launches
    with pytest.raises(RuntimeError, match="failed to launch"):
        rau_train_hops._launch_bwd(*args, **run)
    assert rau_train_hops.BWD_KERNEL.launches == before


@pytest.mark.parametrize("dfeats", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 19, 37, 100])
def test_bwd_plan_is_the_launchers(cuda_device, B, dtype, dfeats):
    """bwd_plan's phases are the launches the built C entry makes (a dry
    run of it), with the features' gradient and without: the same count,
    the same grids, shared memory within the plan's; a split it cannot run
    gives -1."""
    plan = rau_train_hops.bwd_plan(B, *_BWD_WIDTHS, _n_sm(), dtype, dfeats)
    scratch, launches = rau_train_hops.launcher_plan(B, *_BWD_WIDTHS, dtype, plan.chunk_rows,
                                                     dfeats)
    assert scratch > 0
    assert [l[:3] for l in launches] == [ph.grid for ph in plan.phases]
    assert all(l[3] <= ph.smem for l, ph in zip(launches, plan.phases))
    if B == 100:   # the old per-row partial grads alone took 157 MB
        assert scratch * 4 < 100e6
    assert rau_train_hops.launcher_plan(B, *_BWD_WIDTHS, dtype, 48)[0] == -1


def test_train_hops_bf16_wrappers_take_bf16(cuda_device):
    cfg = dataclasses.replace(TRAIN_CFG, compute_dtype="bfloat16")
    mp, q, feats = _train_inputs(4, cuda_device)
    mp16 = map_tree(lambda w: w.to(torch.bfloat16), mp)
    seed = torch.tensor([1], dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="q must be"):
        rau_train_hops.train_hops_fwd(mp16, cfg, q, feats.to(torch.bfloat16), seed)
    with pytest.raises(ValueError, match="q_proj/w must be"):
        rau_train_hops.train_hops_fwd(mp, cfg, q.to(torch.bfloat16),
                                      feats.to(torch.bfloat16), seed)


def _train_batch(cfg, B, dev):
    _, tokens, lengths, feats = _inputs(B, dev)
    labels = torch.randint(0, cfg.answer_size, (B,), device=dev)
    return tokens, lengths, feats, labels, torch.ones(cfg.n_hops)


def test_bf16_train_step_runs_the_bf16_kernels(cuda_device):
    mcfg, tcfg = get_train_preset("ours_ms")
    mcfg = dataclasses.replace(mcfg, fused_train=True, compute_dtype="bfloat16")
    kernels = (rau_train_hops.FWD_BF16_KERNEL, rau_train_hops.BWD_BF16_KERNEL,
               rau_train_hops.FWD_KERNEL, rau_train_hops.BWD_KERNEL)
    before = [k.launches for k in kernels]
    state, metrics = make_train_step(mcfg, tcfg)(
        init_train_state(mcfg, 0), *_train_batch(mcfg, 16, cuda_device), 3e-3, 3e-4)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kernels, before)] == [1, 1, 0, 0]
    assert all(torch.isfinite(v).all() for v in metrics.values())
    assert state.params["mult"]["i_embed"]["w"].dtype == torch.float32


@pytest.mark.parametrize("change", [{}, dict(remat_hops=True), dict(compute_dtype="bfloat16")],
                         ids=["as_shipped", "remat_hops", "bf16"])
def test_unfused_train_step_runs_on_the_card(cuda_device, change):
    """The ours_ms preset as shipped, with remat_hops, and in bf16: no fused
    training kernel runs, the metrics are finite."""
    mcfg, tcfg = get_train_preset("ours_ms")
    mcfg = dataclasses.replace(mcfg, **change)
    kernels = (rau_train_hops.FWD_KERNEL, rau_train_hops.BWD_KERNEL,
               rau_train_hops.FWD_BF16_KERNEL, rau_train_hops.BWD_BF16_KERNEL)
    before = [k.launches for k in kernels]
    state, metrics = make_train_step(mcfg, tcfg)(
        init_train_state(mcfg, 0), *_train_batch(mcfg, 16, cuda_device), 3e-3, 3e-4)
    torch.cuda.synchronize()
    assert [k.launches for k in kernels] == before
    assert state.step == 1
    assert all(torch.isfinite(v).all() for v in metrics.values())


# ---------------------------------------------------------------------------
# from-pixels: the identity-stage kernel and answer_pixels
# ---------------------------------------------------------------------------

def _n_sm():
    return torch.cuda.get_device_properties(0).multi_processor_count


@pytest.mark.parametrize("shape,dtype,bar", [
    ((3, 9, 11, 128, 64, 2), torch.bfloat16, stage_bar(2)),     # narrow, ragged tiles
    ((2, 112, 112, 256, 64, 2), torch.bfloat16, stage_bar(2)),  # the 448-px stages
    ((2, 56, 56, 512, 128, 3), torch.bfloat16, stage_bar(3)),
    ((2, 28, 28, 1024, 256, 22), torch.bfloat16, stage_bar(22)),
    ((2, 14, 14, 2048, 512, 2), torch.bfloat16, stage_bar(2)),
    ((2, 16, 16, 256, 128, 2), torch.float32, 2e-5),
])
def test_fused_stage_matches_plain(cuda_device, shape, dtype, bar):
    """Scale-normalised errors (activations grow across the residual blocks
    at random init): bf16 at chip_smoke.py's ``stage_bar``, ~3x the sound
    kernel's readings; float32 at tests/test_fused_resnet.py's 2e-5.  The
    448-px stage shapes at B=2."""
    B, H, W, C, Cw, N = shape
    gen = torch.Generator(cuda_device).manual_seed(B + H)
    stack = stage_stack(N, C, Cw, dtype, gen, cuda_device)
    x = torch.randn(B, H, W, C, generator=gen, device=cuda_device).abs().to(dtype)
    before = fused_resnet.KERNEL.launches
    got = fused_resnet.fused_identity_stage(x, stack, block_b=1)
    want = fused_resnet.fused_identity_stage_reference(x, stack)
    torch.cuda.synchronize()
    assert fused_resnet.KERNEL.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    assert scaled_err(got, want) <= bar


# every instantiation of the bf16 kernel (tile, column chunk, ring): Cw = the
# chunk
INSTANCES = [((th, tw), nb, ring) for th, tw, nb, ring in fused_resnet.INSTANCES]


@pytest.mark.parametrize("tile,Cw,ring", INSTANCES)
@pytest.mark.parametrize("B", [1, 3])
def test_fused_stage_every_tile_on_edge_cut_images(cuda_device, tile, Cw, ring, B):
    """Each instantiation the plan can choose, on images its tiles do not
    divide."""
    H, W, C, N = 13, 21, 256, 2
    plan = fused_resnet.stage_plan(B, H, W, C, Cw, _n_sm(), tile=tile, ring=ring)
    gen = torch.Generator(cuda_device).manual_seed(Cw + B)
    stack = stage_stack(N, C, Cw, torch.bfloat16, gen, cuda_device)
    x = torch.randn(B, H, W, C, generator=gen, device=cuda_device).abs().to(torch.bfloat16)
    got = fused_resnet.fused_identity_stage(x, stack, block_b=1, plan=plan)
    want = fused_resnet.fused_identity_stage_reference(x, stack)
    torch.cuda.synchronize()
    assert scaled_err(got, want) <= stage_bar(N)


@pytest.mark.parametrize("W,C,Cw,tile,ring", [(21, 512, 128, None, None), (28, 256, 64, None, None)]
                         + [(21, 256, Cw, tile, ring) for tile, Cw, ring in INSTANCES])
def test_fused_stage_bar_sees_halo_and_bias_faults(cuda_device, W, C, Cw, tile, ring):
    """On tiles cut by the image's edge, with biases around +1, the kernel
    sits within the bar and a relu(b1) halo, a dropped b2 or a dropped b3
    lands beyond twice the bar; for each tile instantiation."""
    gen = torch.Generator(cuda_device).manual_seed(W)
    stack = stage_stack(2, C, Cw, torch.bfloat16, gen, cuda_device, bias_mean=1.0)
    x = torch.randn(3, 13, W, C, generator=gen, device=cuda_device).abs().to(torch.bfloat16)
    plan = tile and fused_resnet.stage_plan(3, 13, W, C, Cw, _n_sm(), tile=tile, ring=ring)
    got = fused_resnet.fused_identity_stage(x, stack, block_b=1, plan=plan)
    plain = fused_resnet.fused_identity_stage_reference
    want = plain(x, stack)
    assert scaled_err(got, want) <= stage_bar(2)
    for fault, wrong in stage_faults(plain, x, stack).items():
        assert scaled_err(wrong, want) > 2 * stage_bar(2), fault


@pytest.mark.parametrize("shape", [(2, 28, 28, 1024, 256, 3), (3, 14, 14, 2048, 512, 2)])
def test_fused_stage_two_calls_give_the_same_bits(cuda_device, shape):
    B, H, W, C, Cw, N = shape
    gen = torch.Generator(cuda_device).manual_seed(N)
    stack = stage_stack(N, C, Cw, torch.bfloat16, gen, cuda_device)
    x = torch.randn(B, H, W, C, generator=gen, device=cuda_device).abs().to(torch.bfloat16)
    first = fused_resnet.fused_identity_stage(x, stack, block_b=1)
    assert torch.equal(first, fused_resnet.fused_identity_stage(x, stack, block_b=1))


@pytest.mark.parametrize("change", [dict(ring=4), dict(th=4, tw=28)])
def test_fused_stage_raises_for_a_plan_that_cannot_launch(cuda_device, change):
    """A 4-deep ring at 4x14 (not instantiated) or a 4x28 tile at Cw=512
    (y1 alone takes 187 KB) cannot launch: the wrapper raises."""
    B, H, W, C, Cw = 2, 14, 14, 2048, 512
    plan = dataclasses.replace(fused_resnet.stage_plan(B, H, W, C, Cw, _n_sm()), **change)
    gen = torch.Generator(cuda_device).manual_seed(1)
    stack = stage_stack(1, C, Cw, torch.bfloat16, gen, cuda_device)
    x = torch.randn(B, H, W, C, generator=gen, device=cuda_device).to(torch.bfloat16)
    with pytest.raises(RuntimeError, match="failed to launch"):
        fused_resnet.fused_identity_stage(x, stack, block_b=1, plan=plan)


@pytest.mark.parametrize("C,Cw", [(256, 64), (512, 128), (1024, 256), (2048, 512)])
def test_stage_plan_smem_is_the_launchers(cuda_device, C, Cw):
    """``INSTANCES`` lists what the library instantiates, and ``smem_bytes``
    is what its launcher asks for, at each 448-px stage's widths."""
    for th, tw, nb, ring in itertools.product((4, 8), (8, 14, 28), (64, 128), (2, 3, 4, 5)):
        got = fused_resnet.launcher_smem(th, tw, nb, ring, C, Cw)
        if (th, tw, nb, ring) in fused_resnet.INSTANCES:
            assert got == fused_resnet.smem_bytes(th, tw, nb, ring, C, Cw) > 0
        else:
            assert got == -1, (th, tw, nb, ring)


def test_answer_pixels_runs_every_kernel(cuda_device):
    """One B=7 call at 448 px, held as chip_smoke.py holds it, against
    pixels_forward with bf16's own effect measured as pixels_forward on the
    bf16 tree against the float32 tree: answers > 0.95 counting bf16 ties;
    attention within twice bf16's own change plus 5e-4; the kernels' head to
    the float32 head on the same features at the serving bars; the fused
    backbone no farther from the float32 features than cuDNN's bf16 one."""
    cfg = get_preset("ours_resnet")
    B = 7
    params = init_params(cfg, torch.Generator().manual_seed(0), cuda_device)
    bb = fold_batchnorm(resnet101_init(torch.Generator().manual_seed(1), torch.bfloat16,
                                       cuda_device))
    rs = np.random.RandomState(2)
    images = torch.as_tensor(rs.randint(0, 256, (B, 448, 448, 3)).astype(np.uint8),
                             device=cuda_device)
    _, tokens, lengths, _ = _inputs(B, cuda_device, seed=2)
    before = (fused_resnet.KERNEL.launches, lstm_encoder.KERNEL.launches,
              rau_hops.KERNEL.launches)
    ids, att = answer_pixels(params, bb, cfg, "resnet101", images, tokens, lengths)
    torch.cuda.synchronize()
    assert (fused_resnet.KERNEL.launches, lstm_encoder.KERNEL.launches,
            rau_hops.KERNEL.launches) == (before[0] + 4, before[1] + 1, before[2] + 1)
    assert ids.shape == (cfg.n_hops + 2, B) and att.shape == (cfg.n_hops + 2, B, 196)
    assert torch.isfinite(att).all()
    with torch.no_grad():
        out = pixels_forward(params, bb, cfg, "resnet101", images, tokens, lengths)
        ref_pred, ref_att = _aggregate(out.scores, out.do_pred, out.attprob)
        f_ref = extract_features("resnet101", bb, images).float()
        f_fused = extract_features("resnet101", bb, images, fused_stages=(0, 1, 2, 3)).float()
        f32 = extract_features("resnet101", map_tree(lambda t: t.float(), bb), images)
        head_pred, head_att = predict_fused(params, pack_kernel_weights(params), cfg,
                                            tokens, lengths, f_ref)
        f32_pred, f32_att = predict(params, cfg, tokens, lengths, f32)
    ref_ids = ref_pred.argmax(-1)
    assert (head_pred.argmax(-1) == ref_ids).float().mean().item() > 0.95
    torch.testing.assert_close(head_att, ref_att, rtol=0.05, atol=5e-4)
    assert scaled_err(f_fused, f32) <= 1.5 * scaled_err(f_ref, f32) + 1e-3
    att_bf16 = (ref_att - f32_att).abs().max().item()
    assert (att - ref_att).abs().max().item() <= 2 * att_bf16 + 5e-4
    slack = 2 * (ref_pred - f32_pred).abs().amax(-1)
    gap = ref_pred.amax(-1) - ref_pred.gather(-1, ids[..., None])[..., 0]
    assert (gap <= slack).float().mean().item() > 0.95


def test_train_step_runs_both_kernels(cuda_device):
    mcfg, tcfg = get_train_preset("ours_ms")
    mcfg = dataclasses.replace(mcfg, fused_train=True)
    step = make_train_step(mcfg, tcfg)
    state = init_train_state(mcfg, 0)
    _, tokens, lengths, feats = _inputs(16, cuda_device)
    labels = torch.randint(0, CFG.answer_size, (16,), device=cuda_device)
    before = (rau_train_hops.FWD_KERNEL.launches, rau_train_hops.BWD_KERNEL.launches)
    state, metrics = step(state, tokens, lengths, feats, labels,
                          torch.ones(CFG.n_hops), 3e-3, 3e-4)
    torch.cuda.synchronize()
    assert (rau_train_hops.FWD_KERNEL.launches,
            rau_train_hops.BWD_KERNEL.launches) == (before[0] + 1, before[1] + 1)
    assert state.step == 1
    assert all(torch.isfinite(v).all() for v in metrics.values())


# ---------------------------------------------------------------------------
# VGG16 and ViT-L/14 from pixels; precomputation
# ---------------------------------------------------------------------------

VIT_CFG = get_preset("ours_vit")


@pytest.mark.parametrize("B", [1, 19, 64])
def test_serving_kernels_at_ours_vit_widths(cuda_device, B):
    """Both serving kernels where ours_vit runs them (S 256 cells of 1024
    channels): the serving bars, two calls bit-equal, the hop kernel's plan
    the launcher's dry run."""
    hw, q, ifeat, iatt = _hops_inputs(B, cuda_device, seed=3, cfg=VIT_CFG)
    assert ifeat.shape == (B, 256, VIT_CFG.multfeat_dim)
    s, d, a = rau_hops.rau_hops(hw, VIT_CFG, q, ifeat, iatt)
    again = rau_hops.rau_hops(hw, VIT_CFG, q, ifeat, iatt)
    s_ref, d_ref, a_ref = rau_hops.rau_hops_reference(
        hw, VIT_CFG, q, ifeat, iatt, dot_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip((s, d, a), again))
    torch.testing.assert_close(s, s_ref, rtol=0.05, atol=0.01)
    assert (s.argmax(-1) == s_ref.argmax(-1)).float().mean().item() > 0.97
    torch.testing.assert_close(a, a_ref, rtol=0.05, atol=5e-4)
    torch.testing.assert_close(d, d_ref, rtol=0.05, atol=5e-3)
    widths = (VIT_CFG.rnnout_dim, VIT_CFG.cnn_spat, VIT_CFG.multfeat_dim,
              VIT_CFG.attfeat_dim, VIT_CFG.att_rnn_size, VIT_CFG.answer_size)
    plan = rau_hops.hops_plan(B, VIT_CFG)
    scratch, launches = rau_hops.hops_launcher_plan(B, *widths)
    assert scratch > 0 and [x[:3] for x in launches] == [ph.grid for ph in plan.phases]
    enc, emb, lengths = _encoder_inputs(VIT_CFG, B, VIT_CFG.seq_len, cuda_device, seed=3)
    got = _encode_and_check(VIT_CFG, enc, emb, lengths)
    assert torch.equal(got, lstm_encoder.lstm_encode(enc, VIT_CFG, emb, lengths))


def _other_backbone(name, dev):
    """(head config, bf16 tree, image side): VGG16 He x0.72 a convolution
    (pool5 near unit scale) under ours_ms, ViT-L/14 under ours_vit."""
    gen = torch.Generator().manual_seed(1)
    if name == "vgg16":
        bb = vgg16_pool5_init(gen, device=dev)
        bb = {"convs": [{"w": (c["w"] * 0.72).to(torch.bfloat16),
                         "b": c["b"].to(torch.bfloat16)} for c in bb["convs"]]}
        return CFG, bb, 448
    return VIT_CFG, vit_init(gen, VIT_L14, torch.bfloat16, dev), 224


@pytest.mark.parametrize("backbone", ["vgg16", "vit"])
def test_answer_pixels_other_backbones(cuda_device, backbone):
    """One B=8 call: the encoder and hop kernels once each, no stage kernel;
    against pixels_forward on the same bf16 tree with bf16's own effect
    measured against the float32 tree: answers > 0.95 counting bf16 ties,
    attention within twice bf16's own change plus 5e-4."""
    cfg, bb, side = _other_backbone(backbone, cuda_device)
    B = 8
    params, tokens, lengths, _ = _inputs(B, cuda_device, seed=4, cfg=cfg)
    images = torch.as_tensor(np.random.RandomState(4).randint(0, 256, (B, side, side, 3))
                             .astype(np.uint8), device=cuda_device)
    before = (fused_resnet.KERNEL.launches, lstm_encoder.KERNEL.launches,
              rau_hops.KERNEL.launches)
    ids, att = answer_pixels(params, bb, cfg, backbone, images, tokens, lengths)
    torch.cuda.synchronize()
    assert (fused_resnet.KERNEL.launches, lstm_encoder.KERNEL.launches,
            rau_hops.KERNEL.launches) == (before[0], before[1] + 1, before[2] + 1)
    assert ids.shape == (cfg.n_hops + 2, B) and att.shape == (cfg.n_hops + 2, B, cfg.cnn_spat)
    with torch.no_grad():
        out = pixels_forward(params, bb, cfg, backbone, images, tokens, lengths)
        ref_pred, ref_att = _aggregate(out.scores, out.do_pred, out.attprob)
        f32 = extract_features(backbone, map_tree(lambda t: t.float(), bb), images)
        f32_pred, f32_att = predict(params, cfg, tokens, lengths, f32)
    assert (att - ref_att).abs().max().item() <= \
        2 * (ref_att - f32_att).abs().max().item() + 5e-4
    slack = 2 * (ref_pred - f32_pred).abs().amax(-1)
    gap = ref_pred.amax(-1) - ref_pred.gather(-1, ids[..., None])[..., 0]
    assert (gap <= slack).float().mean().item() > 0.95


def test_device_int8_quantization_is_the_hosts(cuda_device, tmp_path):
    """quantize_feats_device on the card: the bytes and scales of
    PackedShardWriter.write's host arithmetic, ties and a zero image too."""
    from rau_vqa_tpu_torch.data.features import PackedShardWriter
    from rau_vqa_tpu_torch.precompute import quantize_feats_device
    rs = np.random.RandomState(7)
    feats = (rs.randn(64, 196, 512) * rs.uniform(0.05, 40.0, (64, 1, 1))).astype(np.float32)
    feats[3] = 0.0
    feats[4, 0, 0] = np.float32(127.5)
    feats[4, 0, 1] = -np.float32(126.5)
    host = PackedShardWriter(str(tmp_path), 64, 196, 512, dtype="int8")
    host.write(0, feats)
    q, s = quantize_feats_device(torch.as_tensor(feats, device=cuda_device))
    np.testing.assert_array_equal(q.cpu().numpy(), np.asarray(host.arr))
    np.testing.assert_array_equal(s.cpu().numpy(), host.scales)


def test_precompute_on_the_card_is_extract_features(cuda_device, tmp_path):
    """5 PNGs at 64 px, batch 2 (the last batch padded): every row the
    backbone's output for the decoded images at the same batch size, to
    1e-5 of the features' RMS; the int8 shard the host's
    quantization of those rows, bit for bit."""
    from chip_smoke import png_bytes
    from rau_vqa_tpu_torch.data.features import PackedShardWriter, coco_feat_name
    from rau_vqa_tpu_torch.data.images import ImageDirSource
    from rau_vqa_tpu_torch.precompute import precompute_features
    rs = np.random.RandomState(5)
    (tmp_path / "val2014").mkdir()
    rel = []
    for i in range(5):
        p = f"val2014/COCO_val2014_{i:012d}.png"
        (tmp_path / p).write_bytes(png_bytes(rs.randint(0, 256, (64, 64, 3)).astype(np.uint8)))
        rel.append(p)
    _, bb, _ = _other_backbone("vgg16", cuda_device)
    store = precompute_features(str(tmp_path), rel, str(tmp_path / "f32"), "vgg16", bb,
                                size=64, batch_size=2)
    # the reference at the sweep's batch size, its last batch padded alike
    src = ImageDirSource(str(tmp_path), size=64)
    want = np.concatenate([extract_features("vgg16", bb, torch.as_tensor(
        src.get_batch(c + [c[-1]] * (2 - len(c))), device=cuda_device)).float().cpu().numpy()
        [:len(c)] for c in (rel[0:2], rel[2:4], rel[4:])])
    got = store.get_batch([coco_feat_name(p) for p in rel], [1] * 5)
    assert np.abs(got - want).max() <= 1e-5 * np.sqrt(np.square(want).mean())
    q8 = precompute_features(str(tmp_path), rel, str(tmp_path / "i8"), "vgg16", bb,
                             size=64, batch_size=2, dtype="int8")
    host = PackedShardWriter(str(tmp_path / "host"), 5, 4, 512, dtype="int8")
    host.write(0, np.asarray(store.mmap))
    np.testing.assert_array_equal(np.asarray(q8.mmap), np.asarray(host.arr))
    np.testing.assert_array_equal(q8.scales, host.scales)


# ---------------------------------------------------------------------------
# the device mesh (parallel/mesh.py) on the card
# ---------------------------------------------------------------------------

def _mesh_case(B, dev):
    """ours_ms at full width, fused float32 with the preset's dropout and
    noise: its config, initial params (host) and a batch (host)."""
    from rau_vqa_tpu_torch.train.trainer import init_train_state
    cfg, tcfg = get_train_preset("ours_ms")
    cfg = dataclasses.replace(cfg, fused_train=True)
    params = init_train_state(cfg, 0, device="cpu").params
    rs = np.random.RandomState(3)
    lengths = rs.randint(1, cfg.seq_len + 1, B).astype(np.int32)
    tokens = np.zeros((B, cfg.seq_len), np.int64)
    for k in range(B):
        tokens[k, :lengths[k]] = rs.randint(1, cfg.vocab_size, lengths[k])
    feats = np.abs(rs.randn(B, cfg.cnn_spat, cfg.cnn_dim)).astype(np.float32)
    labels = rs.randint(0, cfg.answer_size, B)
    return cfg, tcfg, params, (tokens, lengths, feats, labels)


def _single_steps(cfg, tcfg, params, batch, dev, n):
    from rau_vqa_tpu_torch.train.trainer import TrainState, make_train_step
    from rau_vqa_tpu_torch.train.optim import adam_init
    p = map_tree(lambda x: x.to(dev), params)
    state = TrainState(p, {g: adam_init(p[g]) for g in p}, 0, 0)
    step = make_train_step(cfg, tcfg, device=dev)
    losses = []
    for _ in range(n):
        state, m = step(state, *batch, torch.ones(cfg.n_hops, device=dev),
                        tcfg.learning_rate, tcfg.mult_learning_rate)
        losses.append(float(m["loss"]))
    return state, losses


def test_mesh_world_of_one_is_the_single_step_bit_for_bit(cuda_device):
    """A world of 1 on NCCL: make_sharded_train_step on mesh (1, 1), 2
    steps at B=19, equals make_train_step's loss and every parameter bit for
    bit."""
    import torch.distributed as dist

    from rau_vqa_tpu_torch.parallel import mesh as pm
    from rau_vqa_tpu_torch.train.optim import adam_init
    from rau_vqa_tpu_torch.train.trainer import TrainState
    cfg, tcfg, params, batch = _mesh_case(19, cuda_device)
    want, want_losses = _single_steps(cfg, tcfg, params, batch, cuda_device, 2)
    dev = pm.init_distributed()
    try:
        assert dist.get_backend() == "nccl"
        mesh = pm.make_mesh(1, 1)
        p = map_tree(lambda x: x.to(dev), params)
        state = TrainState(p, {g: adam_init(p[g]) for g in p}, 0, 0)
        step = pm.make_sharded_train_step(cfg, tcfg, mesh, state)
        state = pm.place_state(mesh, state)
        local = pm.shard_batch(mesh, *batch)
        losses = []
        for _ in range(2):
            state, m = step(state, *local, torch.ones(cfg.n_hops, device=dev),
                            tcfg.learning_rate, tcfg.mult_learning_rate)
            losses.append(float(m["loss"]))
    finally:
        dist.destroy_process_group()
    assert losses == want_losses
    for a, b in zip(tree_leaves(state.params), tree_leaves(want.params)):
        assert torch.equal(a, b)


def test_two_rank_dp_step_on_one_card(cuda_device, tmp_path):
    """2 ranks sharing the card over gloo (tests/torch_mesh_worker.py), DP
    (2, 1), 2 fused float32 steps at B=40 with dropout and noise on: the
    last loss within rtol 2e-4 and cls.w within rtol 2e-4 / atol 2e-5 of
    one process's steps on the whole batch."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    import torch_mesh_worker as W
    cfg, tcfg, params, batch = _mesh_case(40, cuda_device)
    want, want_losses = _single_steps(cfg, tcfg, params, batch, cuda_device, 2)
    torch.save({"model": dataclasses.asdict(cfg), "train": dataclasses.asdict(tcfg),
                "params": params, "batch": batch,
                "scenarios": [{"name": "dp", "mesh": (2, 1), "tp": False, "steps": 2,
                               "lrs": (tcfg.learning_rate, tcfg.mult_learning_rate)}]},
               str(tmp_path / "inputs.pt"))
    outs = W.launch("scenarios", str(tmp_path), 2, timeout=300,
                    extra_env={"MESH_WORKER_DEVICE": "cuda"})
    assert "backend gloo" in outs[0]
    got = torch.load(str(tmp_path / "rank0.pt"), weights_only=False)["dp"]
    np.testing.assert_allclose(got["losses"][-1], want_losses[-1], rtol=2e-4)
    torch.testing.assert_close(got["params"]["mult"]["cls"]["w"].cpu(),
                               want.params["mult"]["cls"]["w"].cpu(), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("f32", [True, False], ids=["float32", "bf16"])
def test_bench_train_fused_launches_match_its_steps(cuda_device, f32):
    """``bench_train --variants fused`` at B=8 as a user runs it: exit 0, a
    positive ms a step, the card's name, and its type's forward and backward
    kernels launched once a warm and a timed step (3 steps x (1 + 2 rounds)),
    no other training kernel."""
    import json
    import os
    import subprocess
    import sys
    from chip_smoke import train_launch_faults

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-m", "rau_vqa_tpu_torch.scripts.bench_train",
                           "--batch", "8", "--variants", "fused", "--steps", "3", "--rounds",
                           "2"] + (["--f32"] if f32 else []), cwd=repo, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["metric"] == "train_ms_per_step" and line["value"] > 0
    assert line["device"] == torch.cuda.get_device_name(0) and line["mfu"]["fused_b8"] > 0
    assert line["steps_by_variant"] == {"fused_b8": 9}
    assert train_launch_faults(line) == []
    fwd = "train_hops_fwd" if f32 else "train_hops_fwd_bf16"
    assert line["launches"][fwd] == 9
