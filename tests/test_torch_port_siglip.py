"""SigLIP so400m/14 and VGG16 as the port's from-pixels backbones, against
the benchmark's plain references (``portbench/reference/vit.py``,
``vgg.py`` and ``rau.py``), on the CPU.

The SigLIP tower at a small size that keeps everything the published shape
forces: a side that is not a multiple of the patch (46 px, patch 14: a 3x3
grid, the last 4 px dropped), a head width that is not a power of two (dim
72 in 4 heads of 18), the tanh GELU and the 0.5 normalisation, float32, held
to the reference tower at 1e-5 of the features' scale (float32 sums taken in
another order; the features are LayerNorm outputs of unit scale).  The
whole path, ``answer_pixels(..., "siglip", device="cpu")``, against the
reference tower and head: the attention maps within 2e-3 (the CPU head's
bf16 products, as the card's kernels take them, against the reference's
float32; the maps' values are ~1/9) and no served answer off the
reference's best where that leads by more than 2% of the largest score.
VGG16 likewise at 64 px.  The attention op's CPU path is the two products
around a softmax bit for bit; the counts agree with a hand count and with
``utils/flops.py``; the preset, the CLI's flags, the Hugging Face
converter and the tower's spans.  ViT-L/14's own parity with the JAX
package stays in tests/test_torch_port_vgg_vit.py, unchanged."""

import importlib.util
import json
import math
import os

import numpy as np
import pytest
import torch

from rau_vqa_tpu_torch.config import get_experiment, get_preset
from rau_vqa_tpu_torch.models import pipeline
from rau_vqa_tpu_torch.models.backbones import vgg as TV
from rau_vqa_tpu_torch.models.backbones import vit as TVT
from rau_vqa_tpu_torch.models.rau import init_params
from rau_vqa_tpu_torch.ops import attention as attn_op
from rau_vqa_tpu_torch.utils import flops

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bench_module(*parts):
    """A module of the benchmark's folder, loaded by its path (the folder is
    not a package, and its names stay off ``sys.path``)."""
    path = os.path.join(ROOT, "portbench", *parts)
    spec = importlib.util.spec_from_file_location("portbench_" + "_".join(parts)[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF_VIT = _bench_module("reference", "vit.py")
REF_VGG = _bench_module("reference", "vgg.py")
REF_RAU = _bench_module("reference", "rau.py")
COMPARE = _bench_module("compare.py")

SMALL_TOWER = dict(image_size=46, patch=14, dim=72, depth=2, heads=4, mlp_dim=100, gelu="tanh",
                   mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5), valid_patches=True)
TOWER = TVT.ViTConfig(**SMALL_TOWER)
HEAD = dict(vocab_size=40, answer_size=30, seq_len=7, embed_dim=12, rnn_size=16, rnn_layers=2,
            multfeat_dim=16, attfeat_dim=8, att_rnn_size=16, n_hops=4)
MARGIN = 0.02


def _ref_tower(cfg):
    return {"patch": cfg.patch, "heads": cfg.heads, "ln_eps": cfg.ln_eps, "mean": cfg.mean,
            "std": cfg.std}


def _tower_params(seed, cfg=TOWER):
    """vit_init's tree with nonzero biases and LayerNorm offsets, so that
    every bias is read."""
    g = torch.Generator().manual_seed(seed)
    tree = TVT.vit_init(g, cfg, device="cpu")

    def jitter(t):
        return t + 0.05 * torch.randn(t.shape, generator=g)
    tree["patch_embed"]["b"] = jitter(tree["patch_embed"]["b"])
    for blk in tree["blocks"]:
        for k in ("qkv", "proj", "fc1", "fc2"):
            blk[k]["b"] = jitter(blk[k]["b"])
        for k in ("ln1", "ln2"):
            blk[k] = {"scale": jitter(blk[k]["scale"]), "offset": jitter(blk[k]["offset"])}
    return tree


def _images(B, side, seed):
    return torch.as_tensor(np.random.RandomState(seed).randint(0, 256, (B, side, side, 3))
                           .astype(np.uint8))


def _questions(cfg, B, seed):
    rs = np.random.RandomState(seed)
    lengths = rs.randint(1, cfg.seq_len + 1, B).astype(np.int64)
    tokens = np.zeros((B, cfg.seq_len), np.int64)
    for k in range(B):
        tokens[k, :lengths[k]] = rs.randint(1, cfg.vocab_size, lengths[k])
    return torch.as_tensor(tokens), torch.as_tensor(lengths)


def _scaled_err(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


# ---------------------------------------------------------------------------
# the tower
# ---------------------------------------------------------------------------

def test_siglip_config_is_the_published_shape():
    c = TVT.SIGLIP_SO400M_14_384
    assert (c.image_size, c.patch, c.dim, c.depth, c.heads, c.mlp, c.gelu) == \
        (384, 14, 1152, 27, 16, 4304, "tanh")
    assert (c.grid, c.seq, c.dim // c.heads, c.ln_eps) == (27, 729, 72, 1e-6)
    assert c.mean == c.std == (0.5, 0.5, 0.5) and c.valid_patches
    assert pipeline.TOWERS["siglip"] is c and "siglip" in pipeline.BACKBONES


def test_vit_l14_config_is_unchanged():
    c = TVT.VIT_L14
    assert (c.image_size, c.patch, c.dim, c.depth, c.heads, c.mlp, c.gelu, c.grid) == \
        (224, 14, 1024, 24, 16, 4096, "erf", 16)
    assert not c.valid_patches and c.mean == (0.485, 0.456, 0.406)


def test_a_side_off_the_patch_raises_unless_the_patches_are_valid():
    with pytest.raises(ValueError, match="not a multiple of patch"):
        TVT.ViTConfig(image_size=46, patch=14, dim=72, heads=4).grid
    assert TOWER.grid == 3 and TOWER.seq == 9
    with pytest.raises(ValueError, match="gelu"):
        TVT.ViTConfig(gelu="quick")


def test_vit_init_makes_the_siglip_tree():
    tree = TVT.vit_init(torch.Generator().manual_seed(0), TOWER, device="cpu")
    assert tree["patch_embed"]["w"].shape == (14, 14, 3, 72)
    assert tree["pos_embed"].shape == (9, 72) and len(tree["blocks"]) == 2
    blk = tree["blocks"][0]
    assert blk["qkv"]["w"].shape == (72, 216)
    assert blk["fc1"]["w"].shape == (72, 100) and blk["fc2"]["w"].shape == (100, 72)


@pytest.mark.parametrize("seed", [0, 1])
def test_siglip_tower_matches_the_reference(seed):
    bb = _tower_params(seed)
    images = _images(3, 46, seed)
    got = pipeline.extract_features("siglip", bb, images, vit_cfg=TOWER)
    want = REF_VIT.features(bb, _ref_tower(TOWER), images)
    assert got.shape == want.shape == (3, 9, 72) and got.dtype == torch.float32
    assert _scaled_err(got, want) < 1e-5


def test_siglip_tower_reads_the_tanh_gelu_and_its_normalisation():
    """The tower run with the exact GELU or ImageNet's normalisation lands
    more than ten times the bar of the test above from the reference: both
    are read."""
    bb = _tower_params(2)
    images = _images(2, 46, 2)
    want = REF_VIT.features(bb, _ref_tower(TOWER), images)
    for other in (dict(gelu="erf"), dict(mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225))):
        cfg = TVT.ViTConfig(**{**SMALL_TOWER, **other})
        got = pipeline.extract_features("siglip", bb, images, vit_cfg=cfg)
        assert _scaled_err(got, want) > 10 * 1e-5, other


def test_siglip_drops_the_pixels_past_the_last_patch():
    bb = _tower_params(3)
    images = _images(2, 46, 3)
    changed = images.clone()
    changed[:, 42:, :] = 0
    changed[:, :, 42:] = 255
    a = pipeline.extract_features("siglip", bb, images, vit_cfg=TOWER)
    b = pipeline.extract_features("siglip", bb, changed, vit_cfg=TOWER)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the whole path against the reference tower and head
# ---------------------------------------------------------------------------

def _whole_path(backbone, cfg, bb, images, vit_cfg, ref_feats, seed):
    B = images.shape[0]
    params = init_params(cfg, torch.Generator().manual_seed(seed + 10), "cpu")
    tokens, lengths = _questions(cfg, B, seed)
    ids, att = pipeline.answer_pixels(params, bb, cfg, backbone, images, tokens, lengths,
                                      vit_cfg=vit_cfg, device="cpu")
    sizes = {"rnn_size": cfg.rnn_size, "n_hops": cfg.n_hops, "att_rnn_size": cfg.att_rnn_size}
    ref_pred, ref_att, ref_do = REF_RAU.tables(params, sizes, tokens, lengths, ref_feats, rows=3)
    assert ids.shape == (cfg.n_hops + 2, B) and att.shape == (cfg.n_hops + 2, B, cfg.cnn_spat)
    err = COMPARE.attention_maps(att, ref_att, ref_do)["att_err"]
    miss = COMPARE.answer_misses(ids, ref_pred, ref_do, MARGIN)
    return err, miss, ids, ref_pred


@pytest.mark.parametrize("seed", [0, 1])
def test_answer_pixels_through_siglip_matches_the_reference(seed):
    cfg = get_preset("ours_siglip").__class__(**HEAD, cnn_dim=72, cnn_w=3, cnn_h=3)
    bb = _tower_params(seed + 4)
    images = _images(5, 46, seed + 4)
    ref_feats = REF_VIT.features(bb, _ref_tower(TOWER), images)
    err, miss, ids, ref_pred = _whole_path("siglip", cfg, bb, images, TOWER, ref_feats, seed)
    assert err < 2e-3 and miss == 0, (err, miss)
    # the comparison sees a wrong answer: one row's ids moved by one place
    wrong = ids.clone()
    wrong[:, 0] = (wrong[:, 0] + 1) % cfg.answer_size
    ref_do = torch.zeros(cfg.n_hops, ids.shape[1])
    assert COMPARE.answer_misses(wrong, ref_pred, ref_do, 0.0) > 0


def _vgg_params(seed):
    bb = TV.vgg16_pool5_init(torch.Generator().manual_seed(seed), device="cpu")
    return {"convs": [{"w": c["w"] * 0.72, "b": 0.5 * torch.randn(c["b"].shape,
                                                                  generator=torch.Generator()
                                                                  .manual_seed(seed + i))}
                      for i, c in enumerate(bb["convs"])]}


def test_vgg16_matches_the_reference():
    bb = _vgg_params(0)
    images = _images(2, 64, 0)
    got = pipeline.extract_features("vgg16", bb, images)
    want = REF_VGG.features(bb, images)
    assert got.shape == want.shape == (2, 4, 512)
    assert _scaled_err(got, want) < 3e-5


def test_answer_pixels_through_vgg16_matches_the_reference():
    cfg = get_preset("ours_ms").__class__(**HEAD, cnn_dim=512, cnn_w=2, cnn_h=2)
    bb = _vgg_params(1)
    images = _images(4, 64, 1)
    ref_feats = REF_VGG.features(bb, images)
    err, miss, _, _ = _whole_path("vgg16", cfg, bb, images, None, ref_feats, 1)
    assert err < 2e-3 and miss == 0, (err, miss)


# ---------------------------------------------------------------------------
# the attention op, the counts, the preset, the CLI, the converter, the spans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_cpu_path_is_the_two_products_bit_for_bit(dtype):
    g = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(2, 4, 9, 18, generator=g).to(dtype) for _ in range(3))
    before = attn_op.KERNEL.launches
    got = attn_op.attention(q, k, v)
    att = torch.softmax((q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(18)), dim=-1)
    assert got.dtype == dtype and torch.equal(got, att @ v)
    assert attn_op.KERNEL.launches == before       # CPU calls are not counted


def test_tower_counts_match_a_hand_count_and_the_programs(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "counts", _bench_module("counts.py"))
    counts_backbones = _bench_module("counts_backbones.py")
    t = dict(image_size=384, patch=14, dim=1152, depth=27, mlp_dim=4304)
    S, D, F = 729, 1152, 4304
    hand = 2 * S * 14 * 14 * 3 * D + 27 * (S * (2 * 4 * D * D + 2 * 2 * D * F) + 4 * S * S * D)
    assert counts_backbones.tower_flops(t) == hand
    assert counts_backbones.tower_flops(t) == flops.vit_flops(TVT.SIGLIP_SO400M_14_384)
    assert counts_backbones.vgg16_flops(448) == flops.vgg_flops(448)


def test_ours_siglip_preset():
    cfg = get_preset("ours_siglip")
    assert (cfg.cnn_dim, cfg.cnn_w, cfg.cnn_h, cfg.n_hops) == (1152, 27, 27, 8)
    assert cfg.cnn_spat == TVT.SIGLIP_SO400M_14_384.seq
    ms = get_preset("ours_ms")
    assert {f: getattr(cfg, f) for f in ("multfeat_dim", "attfeat_dim", "rnn_size",
                                         "att_rnn_size", "answer_size")} == \
        {f: getattr(ms, f) for f in ("multfeat_dim", "attfeat_dim", "rnn_size",
                                     "att_rnn_size", "answer_size")}
    exp = get_experiment("ours_siglip")
    assert exp.name == "ours_siglip" and exp.model == cfg


def test_the_benchmark_configuration_is_the_preset_and_the_tower():
    with open(os.path.join(ROOT, "portbench", "configs", "ours_siglip.json")) as f:
        c = json.load(f)
    cfg = get_preset("ours_siglip")
    for k in ("cnn_dim", "cnn_w", "cnn_h", "n_hops", "multfeat_dim", "attfeat_dim"):
        assert c[k] == getattr(cfg, k), k
    bb, tower = c["backbone"], TVT.SIGLIP_SO400M_14_384
    for k in ("image_size", "patch", "dim", "depth", "heads", "mlp_dim", "gelu", "ln_eps",
              "valid_patches"):
        assert bb[k] == getattr(tower, k), k
    assert tuple(bb["mean"]) == tower.mean and tuple(bb["std"]) == tower.std


def test_cli_takes_the_siglip_backbone(tmp_path):
    from rau_vqa_tpu_torch import cli
    assert "siglip" in cli.BACKBONE_CHOICES
    assert cli._vit_cfg("siglip") is TVT.SIGLIP_SO400M_14_384 and cli._vit_cfg("vgg16") is None
    cli._validate_backbone_image_size("siglip", 384, "--size")
    with pytest.raises(SystemExit, match="384"):
        cli._validate_backbone_image_size("siglip", 448, "--size")
    # the flag parses: the run gets as far as the (empty) image directory
    with pytest.raises(SystemExit, match="no images found"):
        cli.main(["--device", "cpu", "precompute-features", "--image-root", str(tmp_path),
                  "--out", str(tmp_path / "out"), "--backbone", "siglip"])


def test_hf_siglip_converter():
    D, P = 72, 14
    g = torch.Generator().manual_seed(6)

    def r(*shape):
        return torch.randn(shape, generator=g)
    state = {"vision_model.embeddings.patch_embedding.weight": r(D, 3, P, P),
             "vision_model.embeddings.patch_embedding.bias": r(D),
             "vision_model.embeddings.position_embedding.weight": r(9, D),
             "vision_model.post_layernorm.weight": r(D), "vision_model.post_layernorm.bias": r(D),
             "vision_model.head.probe": r(1, 1, D), "text_model.embeddings.x": r(3)}
    for i in range(2):
        pre = f"vision_model.encoder.layers.{i}."
        for n, (o, k) in {"self_attn.q_proj": (D, D), "self_attn.k_proj": (D, D),
                          "self_attn.v_proj": (D, D), "self_attn.out_proj": (D, D),
                          "mlp.fc1": (100, D), "mlp.fc2": (D, 100)}.items():
            state[pre + n + ".weight"], state[pre + n + ".bias"] = r(o, k), r(o)
        for n in ("layer_norm1", "layer_norm2"):
            state[pre + n + ".weight"], state[pre + n + ".bias"] = r(D), r(D)
    tree = TVT.vit_from_hf_siglip_state(state, TOWER)
    pre = "vision_model.encoder.layers.1."
    qkv = tree["blocks"][1]["qkv"]
    assert torch.equal(qkv["w"], torch.cat([state[pre + f"self_attn.{n}_proj.weight"].t()
                                            for n in "qkv"], 1))
    assert torch.equal(qkv["b"][D:2 * D], state[pre + "self_attn.k_proj.bias"])
    assert torch.equal(tree["blocks"][1]["fc2"]["w"], state[pre + "mlp.fc2.weight"].t())
    assert torch.equal(tree["ln_final"]["scale"], state["vision_model.post_layernorm.weight"])
    assert torch.equal(tree["pos_embed"], state["vision_model.embeddings.position_embedding.weight"])
    # the patch embedding is the Hugging Face convolution
    x = torch.randn(1, 3, 46, 46, generator=g)
    want = torch.nn.functional.conv2d(x, state["vision_model.embeddings.patch_embedding.weight"],
                                      state["vision_model.embeddings.patch_embedding.bias"],
                                      stride=P)
    pe = tree["patch_embed"]
    got = torch.nn.functional.conv2d(x, pe["w"].permute(3, 2, 0, 1), pe["b"], stride=P)
    torch.testing.assert_close(got, want)
    # keys without the ``vision_model.`` prefix (a bare vision tower's)
    bare = {k[len("vision_model."):]: v for k, v in state.items()
            if k.startswith("vision_model.")}
    again = TVT.vit_from_hf_siglip_state(bare, TOWER)
    assert torch.equal(again["blocks"][0]["proj"]["w"], tree["blocks"][0]["proj"]["w"])


def test_the_tower_gives_its_spans_inside_the_backbones(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    cfg = get_preset("ours_siglip").__class__(**HEAD, cnn_dim=72, cnn_w=3, cnn_h=3)
    params = init_params(cfg, torch.Generator().manual_seed(7), "cpu")
    tokens, lengths = _questions(cfg, 2, 7)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pipeline.answer_pixels(params, _tower_params(7), cfg, "siglip", _images(2, 46, 7),
                               tokens, lengths, vit_cfg=TOWER, device="cpu")
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        ranges = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                        for e in json.load(f)["traceEvents"]
                        if e.get("ph") == "X" and e.get("cat") == "user_annotation")
    names = [n for _, _, n in ranges]
    assert names.count("vit.patch_embed") == names.count("vit.final_ln") == 1
    assert names.count("vit.attention") == names.count("vit.mlp") == TOWER.depth
    backbone = [(a, b) for a, b, n in ranges if n == "pipeline.backbone"]
    assert len(backbone) == 1
    for a, b, n in ranges:
        if n.startswith("vit."):
            assert backbone[0][0] <= a and b <= backbone[0][1], n
