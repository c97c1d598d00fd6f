"""The from-pixels cells of the SigLIP tower and VGG16 on the CPU, with their
backbones cut to a tiny size that keeps what SigLIP forces (a side that is
not a multiple of the patch, a head width that is not a power of two, the
tanh GELU, the 0.5 normalisation): a sound run is correct and reports the
cell's metrics, an altered answer or attention map is not; and the counts
against a hand count."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

import counts_backbones

TINY_TOWER = dict(image_size=46, patch=14, dim=24, depth=2, heads=2, mlp_dim=40)
CELLS = ("ours_siglip.pixels_b32", "ours_ms.pixels_vgg_b64")


@pytest.fixture
def backbone_bench(tiny_bench):
    """The tiny benchmark with each backbone's output the head's input:
    SigLIP 46 px -> 3x3 patches of 24 (heads of 12), VGG16 64 px -> 2x2x512."""
    c = tiny_bench.load("configs", "ours_siglip.json")
    c["backbone"].update(TINY_TOWER)
    c.update(image_size=46, cnn_w=3, cnn_h=3, cnn_dim=24)
    tiny_bench.save(c, "configs", "ours_siglip.json")
    c = tiny_bench.load("configs", "ours_ms.json")
    c.update(image_size=64, cnn_w=2, cnn_h=2, cnn_dim=512)
    tiny_bench.save(c, "configs", "ours_ms.json")
    cell = tiny_bench.load("cells", "ours_ms.pixels_vgg_b64.json")
    cell["backbone"]["image_size"] = 64
    tiny_bench.save(cell, "cells", "ours_ms.pixels_vgg_b64.json")
    for name in CELLS:
        cell = tiny_bench.load("cells", name + ".json")
        cell["traffic"].update(reference_rows=3)
        tiny_bench.save(cell, "cells", name + ".json")
    return tiny_bench


@pytest.mark.parametrize("trace", [False, True], ids=["timed", "traced"])
@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(backbone_bench, workload, trace):
    rc, line, err = backbone_bench.run(workload, seconds=0.5, trace=trace)
    assert rc == 0 and line["correct"] is True, err[-2000:]
    if not trace:
        assert set(line["metrics"]) == {"pixels_images_per_s", "pixels_p95_ms", "setup_s"}
    else:
        assert set(line["metrics"]) <= {"pixels.mfu", "pixels.device_idle_share",
                                        "vit_attention_roofline", "vit.backbone_idle_ms"}
        # the CPU has no device trace: only the request's operations read
        assert "pixels.mfu" in line["metrics"]


def _alter(which):
    def wrap(tables):
        tab_pred, tab_att = (t.clone() for t in tables)
        if which == "answer":
            tab_pred[:, 0] = tab_pred[:, 0].roll(1, -1)
        else:
            tab_att[:, 0] = tab_att[:, 0].roll(1, -1)
        return tab_pred, tab_att
    return wrap


@pytest.mark.parametrize("which", ["answer", "attention"])
@pytest.mark.parametrize("workload", CELLS)
def test_an_altered_output_is_not_correct(backbone_bench, monkeypatch, workload, which):
    import rau_vqa_tpu_torch.models.pipeline as pl
    orig = pl.predict_fused
    monkeypatch.setattr(pl, "predict_fused", lambda *a, **k: _alter(which)(orig(*a, **k)))
    rc, line, _ = backbone_bench.run(workload, seconds=0.5)
    assert rc == 0 and line["correct"] is False
    key = "answer_miss" if which == "answer" else "att_err"
    assert line["checks"][key]["value"] > line["checks"][key]["limit"]


def _ctx(bench, workload, device):
    import harness
    cell = bench.load("cells", workload + ".json")
    config = bench.load("configs", cell["config"] + ".json")
    return SimpleNamespace(cell=cell, config=config, sizes=harness.Sizes(config),
                           device=torch.device(device))


def test_on_the_card_a_head_that_is_not_the_backbones_output_raises(backbone_bench):
    import harness
    driver = harness.load_module("drivers", "pixels_backbone")
    c = backbone_bench.load("configs", "ours_siglip.json")
    c.update(cnn_w=2, cnn_h=2)
    backbone_bench.save(c, "configs", "ours_siglip.json")
    ctx = _ctx(backbone_bench, "ours_siglip.pixels_b32", "cuda")
    spec = driver.backbone_spec(ctx)
    assert spec["depth"] == 2 and spec["image_size"] == 46
    with pytest.raises(ValueError, match="gives 3x3x24 features"):
        driver.check_program(ctx, spec)


@pytest.mark.parametrize("workload", CELLS)
def test_elsewhere_the_backbone_is_cut_to_the_cut_head(tiny_bench, workload):
    """``tiny_bench`` cuts the heads (SigLIP's to 2x2x1152, ours_ms' to 3x3x8)
    and leaves the backbones whole; off the card the driver cuts them to
    the head, on the card it leaves them."""
    import harness
    driver = harness.load_module("drivers", "pixels_backbone")
    whole = driver.backbone_spec(_ctx(tiny_bench, workload, "cuda"))
    ctx = _ctx(tiny_bench, workload, "cpu")
    spec = driver.backbone_spec(ctx)
    driver.check_program(ctx, spec)
    if workload.startswith("ours_siglip"):
        assert (whole["depth"], whole["image_size"]) == (27, 384)
        # 2 x 14 px and the 6 px past the last patch, one block of 16 heads
        assert spec == {**whole, "image_size": 34, "depth": 1}
    else:
        assert "widths" not in whole and whole["image_size"] == 448
        assert spec == {**whole, "image_size": 96, "widths": [8] * 13}


def test_tower_counts_by_hand():
    # S = (46 // 14)^2 = 9 tokens of 24, MLP 40, 2 blocks
    t = dict(TINY_TOWER)
    patch = 2 * 9 * (14 * 14 * 3) * 24
    per_token = 2 * (3 * 24 * 24 + 24 * 24) + 2 * (24 * 40 + 40 * 24)
    attn = 2 * (9 * 9 * 24) * 2
    assert counts_backbones.tower_seq(t) == 9
    assert counts_backbones.tower_flops(t) == patch + 2 * (9 * per_token + attn)
    assert counts_backbones.attention_flops(t, 5) == 2 * 5 * attn
    assert counts_backbones.attention_bytes(t, 5) == 2 * 4 * 5 * 9 * 24 * 2


def test_siglip_counts_at_the_published_shape():
    t = dict(image_size=384, patch=14, dim=1152, depth=27, mlp_dim=4304)
    assert counts_backbones.tower_seq(t) == 729
    # ~0.67 TFLOP an image; the attention 27 x 4 x 729^2 x 1152 at B = 1
    assert abs(counts_backbones.tower_flops(t) - 0.6664e12) < 0.0005e12
    assert counts_backbones.attention_flops(t, 1) == 27 * 4 * 729 * 729 * 1152
    # compute-bound at B = 32: 27 layers x 78.4 GFLOP at 989 TFLOP/s
    assert abs(counts_backbones.attention_bound_s(t, 32) - 2.141e-3) < 2e-6


def test_vgg16_counts_by_hand():
    convs = [(3, 64), (64, 64), (64, 128), (128, 128), (128, 256), (256, 256), (256, 256),
             (256, 512), (512, 512), (512, 512), (512, 512), (512, 512), (512, 512)]
    sides = [448] * 2 + [224] * 2 + [112] * 3 + [56] * 3 + [28] * 3
    want = sum(2 * 9 * a * b * s * s for (a, b), s in zip(convs, sides))
    assert counts_backbones.vgg16_flops(448) == want
    # 15.35 G multiply-adds an image at 224 px, four times that at 448
    assert abs(want - 4 * 2 * 15.35e9) < 0.01 * 4 * 2 * 15.35e9
    # every convolution at 8 channels, 96 px
    narrow = [(3, 8)] + [(8, 8)] * 12
    sides = [96] * 2 + [48] * 2 + [24] * 3 + [12] * 3 + [6] * 3
    assert counts_backbones.vgg16_flops(96, [8] * 13) == sum(
        2 * 9 * a * b * s * s for (a, b), s in zip(narrow, sides))
