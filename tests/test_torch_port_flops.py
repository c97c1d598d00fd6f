"""The one analytic count (rau_vqa_tpu_torch/utils/flops.py) that
chip_smoke.py's bounds and the benches' ``mfu`` read, held to
``torch.utils.flop_counter.FlopCounterMode`` over the plain versions at tiny
widths: the serving step (``predict``: the encoder over every token, the
image embedding, the hops, the aggregation), a narrow ResNet (the stem, the
bottlenecks with their strided 3x3 and downsamples), VGG16 and a tiny ViT.
The counts of products must be equal."""

import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from rau_vqa_tpu_torch.config import get_preset
from rau_vqa_tpu_torch.convert import params_from_jax
from rau_vqa_tpu_torch.eval.predict import predict
from rau_vqa_tpu_torch.models.backbones import resnet, vgg, vit
from rau_vqa_tpu_torch.models.rau import init_params
from rau_vqa_tpu_torch.utils import flops as F
from tests.test_torch_port_backbone import narrow_resnet
from tests.test_torch_port_vgg_vit import TTINY


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread a test process (restored after), so that the
    parallel test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def counted(fn, *args) -> int:
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        fn(*args)
    return fc.get_total_flops()


@pytest.mark.parametrize("B,rnn_layers", [(1, 2), (5, 2), (7, 1)])
def test_serving_step_count_is_the_counters(B, rnn_layers):
    cfg = dataclasses.replace(
        get_preset("ours_ms"), n_hops=3, vocab_size=50, embed_dim=8, rnn_size=16,
        rnn_layers=rnn_layers, multfeat_dim=16, attfeat_dim=8, att_rnn_size=16,
        cnn_dim=12, cnn_w=4, cnn_h=2, answer_size=16, seq_len=9)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(B)
    tokens = torch.randint(1, cfg.vocab_size, (B, cfg.seq_len), generator=gen)
    lengths = torch.randint(1, cfg.seq_len + 1, (B,), generator=gen)
    feats = torch.randn(B, cfg.cnn_spat, cfg.cnn_dim, generator=gen)
    # the plain encoder runs every row over all T tokens
    assert counted(predict, params, cfg, tokens, lengths, feats) == \
        F.serve_step_flops(cfg, B, B * cfg.seq_len)


@pytest.mark.parametrize("folded", [False, True])
def test_resnet_count_is_the_counters(folded):
    bb = params_from_jax(narrow_resnet(3))
    if folded:
        bb = resnet.fold_batchnorm(bb)
    x = torch.randn(2, 64, 64, 3)
    want = 2 * F.resnet101_flops(64, blocks=(2, 2, 2, 2), widths=(8, 16, 32, 64), stem=16)
    assert counted(resnet.resnet101_apply, bb, x) == want


def test_vgg_and_vit_counts_are_the_counters():
    gen = torch.Generator().manual_seed(0)
    bb = vgg.vgg16_pool5_init(gen, device="cpu")
    assert counted(vgg.vgg16_pool5_apply, bb, torch.randn(1, 32, 32, 3)) == F.vgg_flops(32)
    vb = vit.vit_init(gen, TTINY, device="cpu")
    x = torch.randn(3, TTINY.image_size, TTINY.image_size, 3)
    assert counted(vit.vit_apply, vb, TTINY, x) == 3 * F.vit_flops(TTINY)
    assert F.backbone_flops("vit", 224, TTINY) == F.vit_flops(TTINY)
    with pytest.raises(ValueError, match="unknown backbone"):
        F.backbone_flops("alexnet", 224)


def test_bounds_read_the_same_count():
    """lstm_bound and hops_bound take their operations from the counts
    above; the bound is the larger of the bytes' time and the operations'."""
    cfg = get_preset("ours_ms")
    assert F.bound(3.35e12, 0, F.H100_BF16_FLOPS) == (1e3, "bytes")
    assert F.bound(0, 989e12, F.H100_BF16_FLOPS) == (1e3, "operations")
    hw = {"w": torch.zeros(0)}
    for B in (1, 512):
        ms, by = F.hops_bound(cfg, hw, B)
        t_ops = F.hops_flops(cfg, B) / F.H100_BF16_FLOPS * 1e3
        assert ms >= t_ops and (by == "operations") == (ms == t_ops)
    enc = {"slabs": [torch.zeros(0)], "bias": torch.zeros(0)}
    lengths = torch.full((512,), 26)
    ms, _ = F.lstm_bound(cfg, enc, lengths, 26)
    assert ms >= F.lstm_step_flops(cfg) * 512 * 26 / F.H100_BF16_FLOPS * 1e3
