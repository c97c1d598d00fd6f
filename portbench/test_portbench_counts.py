"""The frozen counts agree with the program's ``utils/flops.py`` on every
operation count at the cells' shapes; the kernels' bytes differ only by the
packed slabs' padding, which the frozen counts leave out."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import counts
import harness
from rau_vqa_tpu_torch.config import get_preset
from rau_vqa_tpu_torch.eval.predict import pack_kernel_weights
from rau_vqa_tpu_torch.utils import flops

CONFIGS = ["ours_ms", "ours_resnet"]


def _sizes(name):
    return harness.Sizes(harness.load_json(harness.BENCH, "configs", name + ".json"))


@pytest.mark.parametrize("name", CONFIGS)
def test_configuration_is_the_preset(name):
    assert harness.model_config(harness.load_json(harness.BENCH, "configs", name + ".json")) \
        == get_preset(name)


@pytest.mark.parametrize("name,B", [("ours_ms", 512), ("ours_resnet", 512), ("ours_resnet", 120)])
def test_serving_operations_match(name, B):
    s, cfg = _sizes(name), get_preset(name)
    tokens = 7 * B
    assert counts.serve_step_flops(s, B, tokens) == flops.serve_step_flops(cfg, B, tokens)
    assert counts.hops_flops(s, B) == flops.hops_flops(cfg, B)
    assert counts.lstm_step_flops(s) == flops.lstm_step_flops(cfg)


@pytest.mark.parametrize("name", CONFIGS)
def test_kernel_bounds_match_up_to_the_slab_padding(name):
    s, cfg = _sizes(name), get_preset(name)
    B, T = 64, cfg.seq_len
    g = torch.Generator().manual_seed(0)
    import weights
    params = weights.rau_head(s, g, 0.08)
    kw = pack_kernel_weights(params)
    lengths = torch.full((B,), 7, dtype=torch.int32)
    want_ms, _ = flops.lstm_bound(cfg, kw["rnn"], lengths, T)
    got = counts.lstm_bound_s(s, B, T, int(lengths.sum())) * 1e3
    assert got == pytest.approx(want_ms, rel=0.02)
    want_ms, _ = flops.hops_bound(cfg, kw["mult"], B)
    assert counts.hops_bound_s(s, B) * 1e3 == pytest.approx(want_ms, rel=1e-6)
    assert counts.hop_weight_elements(s) * 2 == flops.nbytes(kw["mult"])


def test_training_and_backbone_operations_match():
    s, cfg = _sizes("ours_ms"), get_preset("ours_ms")
    for T in (8, 16, 26):
        assert counts.train_step_flops(s, 512, T) == flops.train_step_flops(cfg, 512, T)
    assert counts.resnet101_flops(448) == flops.resnet101_flops(448)
    for run, want in zip(counts.identity_runs(120, 448),
                         [(120, 112, 112, 256, 64, 2), (120, 56, 56, 512, 128, 3),
                          (120, 28, 28, 1024, 256, 22), (120, 14, 14, 2048, 512, 2)]):
        assert run == want
        assert counts.stage_bound_s(*run) * 1e3 == pytest.approx(flops.stage_bound(*run)[0])
    assert np.isclose(counts.H100_BF16_FLOPS, flops.H100_BF16_FLOPS)
