"""The serving step's image embedding (``ops/embed_image.py``), on the CPU.

The 3xTF32 split as the kernel makes it (``cvt.rna.tf32.f32`` emulated
bitwise), and the product it gives against float64 beside the float32 and
1xTF32 products; the weight planes of ``pack_kernel_weights``; the CPU
wrapper bit for bit today's ``embed_image`` plus the two casts, and
``predict_fused`` on the CPU bit for bit the composition it replaced; the
shape rule, the operands the card's version refuses, and the tile plan; the
op's shape function; the kernel's names against the benchmark's readers.  The kernel itself runs
in ``tests/test_torch_port_cuda.py``.
"""

import dataclasses
import importlib.util
import os
import re
import types

import pytest
import torch

from rau_vqa_tpu_torch import config as tconfig
from rau_vqa_tpu_torch.eval import predict as tpred
from rau_vqa_tpu_torch.models.rau import embed_image as plain_embed_image
from rau_vqa_tpu_torch.models.rau import init_params
from rau_vqa_tpu_torch.ops import embed_image as E
from rau_vqa_tpu_torch.ops.lstm_encoder import encode_question_fused
from rau_vqa_tpu_torch.ops.rau_hops import rau_hops

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = tconfig.ModelConfig(
    vocab_size=50, answer_size=16, seq_len=9, embed_dim=8, rnn_size=16,
    rnn_layers=2, cnn_dim=12, cnn_w=4, cnn_h=2, multfeat_dim=16,
    attfeat_dim=8, att_rnn_size=16, n_hops=3)
# the benchmark's and the presets' widths (Dc, M, F)
WIDTHS = [(512, 512, 256), (1024, 512, 256), (2048, 512, 256)]


def _head(Dc, M, F, seed=0):
    """ReLU-normal features' weights: uniform(+-0.08), the reference's init."""
    g = torch.Generator().manual_seed(seed)

    def u(*s):
        return torch.rand(*s, generator=g) * 0.16 - 0.08

    return {"i_embed": {"w": u(Dc, M), "b": u(M)}, "att_i": {"w": u(M, F), "b": u(F)}}


def _feats(shape, seed=1):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed)).clamp_(min=0)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 3e4])
def test_split_zeroes_the_low_bits_and_keeps_the_operand(scale):
    """big has its low 13 mantissa bits zero (a tf32 value); big + small,
    small itself tf32, is within 2^-21 relative of the operand; the rounding
    is to nearest, ties away from zero."""
    x = torch.randn(20000, generator=torch.Generator().manual_seed(2)) * scale
    big, small = E.tf32_split(x)
    for part in (big, small):
        assert ((part.view(torch.int32) & 0x1FFF) == 0).all()
    rel = (big.double() + small.double() - x.double()).abs() / x.double().abs()
    assert rel.max().item() <= 2.0 ** -21
    # to nearest: |x - big| is at most half of tf32's unit in the last place
    ulp = 2.0 ** (torch.floor(torch.log2(x.double().abs())) - 10)
    assert ((x.double() - big.double()).abs() <= ulp / 2).all()
    ties = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 3 * 2.0 ** -11])
    assert E.tf32_round(ties).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10),
                                           1.0 + 2 * 2.0 ** -10]


@pytest.mark.parametrize("Dc", [512, 2048])
def test_3xtf32_product_is_as_accurate_as_float32(Dc):
    """On ReLU-normal features and uniform(+-0.08) weights, the three
    products of the split summed in float32 are within 2x of the float32
    product's largest error against float64; one tf32 product (the control)
    reads at least 100x the float32 product's error."""
    w = _head(Dc, 512, 256)["i_embed"]["w"]
    x = _feats((256, Dc))
    want = x.double() @ w.double()
    xb, xs = E.tf32_split(x)
    wb, ws = E.tf32_split(w)
    three = (xs @ wb + xb @ ws) + xb @ wb
    err = {name: (got.double() - want).abs().max().item()
           for name, got in (("f32", x @ w), ("3xtf32", three), ("1xtf32", xb @ wb))}
    print(f"Dc={Dc} max |err| vs float64: {err}")
    assert err["3xtf32"] <= 2 * err["f32"]
    assert err["1xtf32"] >= 100 * err["f32"]


@pytest.mark.parametrize("Dc,M,F", WIDTHS + [(12, 16, 8)])
def test_pack_kernel_weights_holds_the_split_planes(Dc, M, F):
    """``pack_kernel_weights``' ``embed`` entry: empty for weights off the
    card, which the plain version runs without planes; on the card each
    weight [K, N] as ``split_planes`` makes it: [2 N, K] float32, contiguous,
    the big rows tf32(W^T) and the small rows tf32(W^T - big)."""
    cfg = dataclasses.replace(SMALL, cnn_dim=Dc, multfeat_dim=M, attfeat_dim=F)
    params = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    assert tpred.pack_kernel_weights(params)["embed"] == {}
    for key, w in (("wi", params["mult"]["i_embed"]["w"]), ("wa", params["mult"]["att_i"]["w"])):
        K, N = w.shape
        planes = E.split_planes(w)
        assert planes.shape == (2 * N, K) and planes.dtype == torch.float32
        assert planes.is_contiguous()
        big = E.tf32_round(w.t())
        assert torch.equal(planes[:N], big)
        assert torch.equal(planes[N:], E.tf32_round(w.t() - big))
        assert (planes[:N].double() + planes[N:].double() - w.t().double()).abs().max() \
            <= 2.0 ** -21 * w.abs().max()


@pytest.mark.parametrize("Dc,M,F,lead", [(12, 16, 8, (3, 8)), (512, 512, 256, (2, 196)),
                                         (2048, 512, 256, (1, 5))])
def test_cpu_wrapper_is_embed_image_and_the_casts_bit_for_bit(Dc, M, F, lead):
    """On the CPU the op runs the plain version: today's ``embed_image``
    then the two casts to bf16, bit for bit; the planes are not read."""
    mp = _head(Dc, M, F, seed=Dc)
    feats = _feats(lead + (Dc,), seed=M)
    assert E.pack_embed_weights(mp) == {}
    ifeat, iatt = E.embed_image(mp, {}, feats)
    want_i, want_a = plain_embed_image(mp, feats)
    assert ifeat.dtype == iatt.dtype == torch.bfloat16
    assert ifeat.is_contiguous() and iatt.is_contiguous()
    assert torch.equal(ifeat, want_i.to(torch.bfloat16))
    assert torch.equal(iatt, want_a.to(torch.bfloat16))
    zeros = {"wi": torch.zeros(2 * M, Dc), "wa": torch.zeros(2 * F, M)}
    assert torch.equal(E.embed_image(mp, zeros, feats)[0], ifeat)


@pytest.mark.parametrize("B", [1, 7])
def test_cpu_predict_fused_is_the_composition_it_replaced(B):
    """``predict_fused`` on the CPU equals, bit for bit, the encoder, the
    float32 ``embed_image`` cast to bf16, the hop loop and the aggregation."""
    params = init_params(SMALL, torch.Generator().manual_seed(B), "cpu")
    g = torch.Generator().manual_seed(10 + B)
    lengths = torch.randint(1, SMALL.seq_len + 1, (B,), generator=g, dtype=torch.int32)
    tokens = torch.randint(1, SMALL.vocab_size, (B, SMALL.seq_len), generator=g)
    feats = torch.randn(B, SMALL.cnn_spat, SMALL.cnn_dim, generator=g)
    kw = tpred.pack_kernel_weights(params)
    with torch.no_grad():
        got = tpred.predict_fused(params, kw, SMALL, tokens, lengths, feats)
        q = encode_question_fused(params, kw["rnn"], SMALL, tokens, lengths)
        ifeat, iatt = plain_embed_image(params["mult"], feats)
        scores, do_pred, attprob = rau_hops(kw["mult"], SMALL, q,
                                            ifeat.to(torch.bfloat16).contiguous(),
                                            iatt.to(torch.bfloat16).contiguous())
        want = tpred._aggregate(scores, do_pred, attprob)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("rows,Dc,M,F,takes", [
    (512 * 196, 512, 512, 256, True),       # ours_ms, ours_ss, ours_full at B = 512
    (1 * 196, 2048, 512, 256, True),        # ours_resnet, a single question
    (16 * 256, 1024, 512, 256, True),       # ours_vit's HTTP bucket
    (120 * 196, 2048, 512, 256, True),      # the pixels cell
    (1, 4, 8, 8, True),                     # the smallest it takes
    (8 * 8, 12, 16, 8, True),               # the tests' tiny widths: K and column tails
    (196, 48, 96, 200, True),               # widths off every tile
    (0, 512, 512, 256, False),              # no rows
    (196, 514, 512, 256, False),            # Dc off TMA's 16-byte row pitch
    (196, 512, 100, 256, False),            # M off rau_hops's 8
    (196, 512, 512, 4, False),              # F off rau_hops's 8
    (2 ** 31, 512, 512, 256, False),        # rows past 32 bits
])
def test_shape_rule(rows, Dc, M, F, takes):
    if takes:
        E.check_widths(rows, Dc, M, F)
    else:
        with pytest.raises(ValueError, match="embed_image"):
            E.check_widths(rows, Dc, M, F)


def _op_args(mp, feats):
    return (feats, mp["i_embed"]["w"], mp["i_embed"]["b"], mp["att_i"]["w"], mp["att_i"]["b"],
            E.split_planes(mp["i_embed"]["w"]), E.split_planes(mp["att_i"]["w"]))


def test_the_card_refuses_what_the_kernel_cannot_take():
    """The op's CUDA implementation, called here on CPU tensors, refuses
    before any launch: widths off the shape rule, strided features, bf16
    weights, planes of other weights and features of another width raise
    ``ValueError``; the config widths and the tiny ones with their planes
    pass its check."""
    for mp, feats in ((_head(512, 512, 256), _feats((1, 196, 512))),
                      (_head(12, 16, 8), _feats((2, 8, 12)))):
        assert E.check_operands(*_op_args(mp, feats)) == feats.numel() // feats.shape[-1]
    big, odd = _head(512, 512, 256), _head(512, 100, 256)
    bf16 = {k: {n: t.to(torch.bfloat16) for n, t in v.items()} for k, v in big.items()}
    args = _op_args(big, _feats((1, 196, 512)))
    refused = [_op_args(odd, args[0]),
               _op_args(big, _feats((1, 196, 1024))[..., ::2]),
               _op_args(bf16, args[0])[:5] + args[5:],
               args[:5] + (args[6], args[5]),
               _op_args(big, _feats((1, 196, 256)))]
    for bad in refused:
        with pytest.raises(ValueError, match="embed_image"):
            E._embed_image_cuda(*bad)
    on_card = types.SimpleNamespace(device=torch.device("cuda"))   # all the wrapper reads
    with pytest.raises(ValueError, match="planes"):
        E.embed_image(big, {}, on_card)


def test_plan_covers_column_tails():
    """Widths below a tile's (the tests' tiny ones) take the narrowest tile,
    whose last column tile the kernel masks, as they do at 96 columns; 128
    columns or more may take the wider tile."""
    assert E.embed_plan(8 * 8, 16, 8, 132) == E.EmbedPlan((64, 64), (64, 64))
    assert E.embed_plan(512 * 196, 96, 8, 132) == E.EmbedPlan((64, 64), (64, 64))
    assert E.embed_plan(512 * 196, 200, 136, 132) == E.EmbedPlan((128, 128), (128, 128))


@pytest.mark.parametrize("rows,tile_i,tile_a", [
    (512 * 196, (128, 128), (128, 128)),    # the serving cells: the largest tile
    (120 * 196, (128, 128), (128, 128)),    # the pixels cell
    (16 * 196, (64, 128), (64, 64)),        # the HTTP service's bucket
    (196, (64, 64), (64, 64)),              # one question
])
def test_plan_picks_the_tile_from_the_row_count(rows, tile_i, tile_a):
    plan = E.embed_plan(rows, 512, 256, 132)
    assert (plan.ifeat, plan.iatt) == (tile_i, tile_a)
    for (bm, bn), N in ((plan.ifeat, 512), (plan.iatt, 256)):
        assert (bm, bn) in E.EMBED_TILES and N % bn == 0


def test_bounds_are_three_tf32_products():
    """The 3xTF32 bound at B = 512: 1.44 ms at Dc 2048, 0.48 ms at Dc 512."""
    assert E.bound_s(512 * 196, 2048, 512, 256) * 1e3 == pytest.approx(1.435, abs=5e-3)
    assert E.bound_s(512 * 196, 512, 512, 256) * 1e3 == pytest.approx(0.478, abs=5e-3)


def test_fake_op_gives_the_shapes_and_dtypes():
    from torch._subclasses.fake_tensor import FakeTensorMode

    args = _op_args(_head(64, 128, 64), torch.empty(5, 7, 64))
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(t) for t in args]
        ifeat, iatt = torch.ops.rau_vqa.embed_image(*fake)
    assert tuple(ifeat.shape) == (5, 7, 128) and tuple(iatt.shape) == (5, 7, 64)
    assert ifeat.dtype == iatt.dtype == torch.bfloat16


def test_kernel_names_are_for_the_embed_image_reader_alone():
    """Every kernel of csrc/embed_image.cu carries ``embed_image`` in its name
    and matches none of the benchmark's other readers' patterns; the new
    reader reads the kernels' ms a step and nothing without them."""
    src = open(os.path.join(ROOT, "rau_vqa_tpu_torch", "csrc", "embed_image.cu")).read()
    kernels = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
                         src)
    assert kernels
    others = ("gemm_mma", "gemm_fma", "prep_kernel", "cell_kernel", "rows_eval_kernel",
              "lstm_encode_kernel", "identity_block")
    for name in kernels:
        assert "embed_image" in name and not any(p in name for p in others)
    spec = importlib.util.spec_from_file_location(
        "embed_image_ms", os.path.join(ROOT, "portbench", "metrics", "embed_image_ms.py"))
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)

    class View:
        def __init__(self, steps, kernels):
            self.steps, self.kernels = steps, kernels

        def kernel_s(self, patterns):
            rx = re.compile("|".join(patterns))
            return sum(s for n, s in self.kernels.items() if rx.search(n))

    name = "void (anonymous namespace)::embed_image_tf32x3<2, 128, true>(CUtensorMap)"
    assert reader.read(View(4, {name: 0.006, "sm80_xmma_gemm_f32f32": 0.01})) == \
        pytest.approx(1.5)
    assert reader.read(View(4, {"sm80_xmma_gemm_f32f32": 0.01})) is None
    assert reader.read(View(0, {name: 0.006})) is None
