"""The port's measurement scripts (rau_vqa_tpu_torch/scripts/) against the JAX
side's (scripts/), on the CPU at tiny widths.

- The training bench's chain: with dropout and gradient noise off, in
  float32, two chained steps of ``bench_train.make_chain`` give the params
  of JAX's ``make_train_step`` applied twice to the same salted tokens, at
  the bar tests/test_torch_port_train_unfused.py holds one step to (rtol
  2e-3, atol 1e-6: the grads pass through two frameworks' summation orders
  before clip and Adam), for the variants plain, remat, trunc, accum and
  maskref (JAX's ``fused_train_impl="reference"``).
- The FLOP count: ``utils/flops.py`` ``train_step_flops`` against
  ``torch.utils.flop_counter.FlopCounterMode`` over one unfused CPU step,
  within 2%.  On these shapes it is exact: the count leaves out what
  autograd does not run (``do_pred``'s backward, the input gradients of the
  features, of the zero states and of the pixels) and adds the metrics'
  select aggregate.  (At a 1x1 feature grid the attention pooling is an
  elementwise product, which the counter does not count: the one term that
  can part them.)
- The same inputs as JAX: ``bench_serve`` sends the JAX script's payloads
  in the JAX script's order (its warm-up bursts as sets); ``bench_precompute``
  writes the JAX script's JPEG bytes, and its sweep the JAX path's float32
  rows at the precompute tests' bar (3e-5 of the features' scale).
"""

import argparse
import dataclasses
import importlib.util
import json
import os
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from rau_vqa_tpu.config import ModelConfig as JaxModelConfig
from rau_vqa_tpu.config import TrainConfig as JaxTrainConfig
from rau_vqa_tpu.train import trainer as jtrainer
from rau_vqa_tpu.train.losses import hop_grad_scale as jax_hop_grad_scale
from rau_vqa_tpu_torch import config as tconfig
from rau_vqa_tpu_torch.convert import params_from_jax
from rau_vqa_tpu_torch.scripts import bench_precompute as tpre
from rau_vqa_tpu_torch.scripts import bench_serve as tserve
from rau_vqa_tpu_torch.scripts import bench_train as tbt
from rau_vqa_tpu_torch.train import optim as toptim
from rau_vqa_tpu_torch.train import trainer as ttrainer
from rau_vqa_tpu_torch.utils.benchparams import random_backbone
from rau_vqa_tpu_torch.utils.flops import train_step_flops
from tests.test_torch_port_backbone import assert_scaled_close
from tests.test_torch_port_train_unfused import (
    _assert_paths_close,
    port_cfg,
    port_train_cfg,
)
from tests.test_torch_port_vgg_vit import jax_vgg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the unfused step's small configuration, dropout off
JCFG = JaxModelConfig(
    vocab_size=50, answer_size=17, seq_len=9, embed_dim=8, rnn_size=16,
    rnn_layers=2, cnn_dim=12, cnn_w=3, cnn_h=2, multfeat_dim=16,
    attfeat_dim=8, att_rnn_size=16, att_rnn_layers=1, n_hops=3,
    embed_dropout=0.0, rnn_dropout=0.0, mult_dropout=0.0)
B = 8


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread a test process (restored after), so that the
    parallel test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_script(name: str):
    """The JAX side's ``scripts/<name>.py`` as a module (not run)."""
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                  os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# the training bench's chain against JAX's step applied twice
# ---------------------------------------------------------------------------

def jax_variant(name: str):
    """The JAX script's configurations of a variant (scripts/bench_train.py:
    110-147) over JCFG, float32 at ``highest``."""
    jcfg = dataclasses.replace(JCFG, remat_hops=name == "remat")
    jtcfg = JaxTrainConfig(noisy_eta=0.0)
    if name == "maskref":
        jcfg = dataclasses.replace(jcfg, fused_train=True, fused_train_impl="reference")
    if name.startswith("accum"):
        jtcfg = dataclasses.replace(jtcfg, grad_accum=int(name[5:]))
    return jcfg, jtcfg


@pytest.mark.parametrize("name", ["plain", "remat", "trunc5", "accum2", "maskref"])
def test_train_chain_is_jax_step_twice(name):
    jcfg, jtcfg = jax_variant(name)
    v = tbt.variant(name, port_cfg(JCFG), port_train_cfg(jtcfg), f32=True)
    assert v.mcfg.compute_dtype == "float32" and v.tcfg.noisy_eta == 0.0
    inp = tbt.make_inputs(v, B, 1, torch.device("cpu"))
    host = {k: inp[k].numpy() for k in ("tokens", "lengths", "feats", "labels")}
    if name.startswith("trunc"):
        assert host["tokens"].shape == (B, 5) and host["lengths"].max() <= 5
    jstate = jtrainer.init_train_state(jax.random.PRNGKey(0), jcfg)
    hop_scale = jax_hop_grad_scale(jcfg.n_hops, scale_by_nhop=jtcfg.hop_grad_scale_nhop,
                                   stop_timing=jtcfg.hop_stop_timing, epoch=1)
    jstep = jax.jit(jtrainer.make_train_step(jcfg, jtcfg))
    js = jstate
    for k in range(2):
        toks = np.where(host["tokens"] > 0, (host["tokens"] + 100 + k) % JCFG.vocab_size, 0)
        js, _ = jstep(js, jnp.asarray(toks), jnp.asarray(host["lengths"]),
                      jnp.asarray(host["feats"]), jnp.asarray(host["labels"]), hop_scale,
                      jnp.float32(tbt.LR), jnp.float32(tbt.MULT_LR))
    params = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    state = ttrainer.TrainState(params, {g: toptim.adam_init(params[g])
                                         for g in ttrainer.PARAM_GROUPS}, step=0, seed=0)
    step = ttrainer.make_train_step(v.mcfg, v.tcfg, device="cpu")
    out = tbt.make_chain(step, v, inp, 2)(state, 100)
    assert out.step == 2
    _assert_paths_close(out.params, js.params, rtol=2e-3, atol=1e-6)


def test_variant_switches():
    m, t = tconfig.get_train_preset("ours_ms")
    assert tbt.variant("fused16", m, t, f32=False).mcfg.fused_train
    assert tbt.variant("fused", m, t, f32=False).mcfg.compute_dtype == "bfloat16"
    ref = tbt.variant("maskref", m, t, f32=True).mcfg
    assert ref.fused_train and ref.fused_train_bwd == "reference"
    assert tbt.variant("accum", m, t, f32=True).tcfg.grad_accum == 4
    grp = tbt.variant("finetunegrp", m, t, f32=False, preset="ours_resnet", pixels_size=64)
    assert (grp.kind, grp.grouped, grp.backbone) == ("finetune", True, "resnet101")
    assert grp.tcfg.train_backbone and grp.tcfg.backbone_remat
    assert (grp.mcfg.cnn_w, grp.mcfg.cnn_h) == (2, 2)
    pix = tbt.variant("pixels", m, t, f32=False)
    assert (pix.kind, pix.backbone) == ("pixels", "vgg16") and not pix.tcfg.train_backbone
    with pytest.raises(ValueError):
        tbt.variant("fusedx", m, t, f32=False)


# ---------------------------------------------------------------------------
# the FLOP count against FlopCounterMode
# ---------------------------------------------------------------------------

def counted_step(mcfg, tcfg, feats, **kw):
    rs = np.random.RandomState(0)
    T = mcfg.seq_len
    tokens = rs.randint(1, mcfg.vocab_size, (6, T))
    lengths = rs.randint(1, T + 1, 6)
    labels = rs.randint(0, mcfg.answer_size, 6)
    step = ttrainer.make_train_step(mcfg, tcfg, device="cpu", **kw)
    bb = None
    if tcfg.train_backbone:
        bb, _ = random_backbone(kw["backbone"], 1, torch.float32, fold_bn=False)
    state = ttrainer.init_train_state(mcfg, 0, device="cpu", bb_params=bb)
    with FlopCounterMode(display=False) as fc:
        step(state, tokens, lengths, feats, labels, np.ones(mcfg.n_hops, np.float32),
             3e-3, 3e-4)
    return fc.get_total_flops()


@pytest.mark.parametrize("name", ["plain", "remat"])
def test_train_step_flops_is_the_counters(name):
    mcfg = port_cfg(JCFG, remat_hops=name == "remat")
    feats = np.random.RandomState(1).randn(6, mcfg.cnn_spat, mcfg.cnn_dim).astype(np.float32)
    got = counted_step(mcfg, tconfig.TrainConfig(), feats)
    want = train_step_flops(mcfg, 6, mcfg.seq_len)
    assert abs(want / got - 1) <= 0.02, (want, got)


def test_finetune_step_flops_is_the_counters():
    """VGG16 fine-tuned at 64 px (a 2x2 grid), grouped 3 questions an image,
    with blockwise remat: its forward, remat and backward less the pixels'
    gradient, and the head with the features' gradient."""
    mcfg = port_cfg(JCFG, cnn_dim=512, cnn_w=2, cnn_h=2)
    tcfg = tconfig.TrainConfig(train_backbone=True, backbone_remat=True)
    images = np.random.RandomState(1).randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    got = counted_step(mcfg, tcfg, images, backbone="vgg16", img_repeat=3)
    want = train_step_flops(mcfg, 6, mcfg.seq_len, backbone="vgg16", size=64, n_images=2,
                            train_backbone=True, backbone_remat=True)
    assert abs(want / got - 1) <= 0.02, (want, got)


# ---------------------------------------------------------------------------
# the same inputs as the JAX scripts
# ---------------------------------------------------------------------------

class _Done(Exception):
    pass


class _FakeService:
    """Stands in for either package's service: phase A2's first step ends
    the script, after the warm-up and phase A."""

    def __init__(self, *a, **kw):
        self.mcfg = argparse.Namespace(seq_len=26, cnn_spat=4, cnn_dim=8)
        self.params = None

    def predict(self, *a, **kw):
        raise _Done()

    def close(self):
        pass


class _FakeServer:
    server_address = ("127.0.0.1", 1)

    def serve_forever(self):
        pass

    def shutdown(self):
        pass

    def server_close(self):
        pass


def sent_payloads(monkeypatch, module, run):
    """The payloads a bench_serve module posts up to phase A2: (the warm-up's
    as one sorted list, phase A's in order)."""
    sent = []
    monkeypatch.setattr(module, "_post", lambda port, p: sent.append(p) or {"answers": [1]})
    with pytest.raises(_Done):
        run()
    warm = 1 + 4 + 8 + 4
    return sorted(json.dumps(p, sort_keys=True) for p in sent[:warm]), sent[warm:]


def test_serve_pool_is_the_jax_scripts(monkeypatch, tmp_path):
    import rau_vqa_tpu.serve as jserve
    import rau_vqa_tpu.utils.rigcheck as jrig
    import rau_vqa_tpu_torch.serve as tserve_mod

    made = []

    def mkdtemp(*a, **kw):       # the JAX script's bundle under tmp_path
        d = tmp_path / f"d{len(made)}"
        d.mkdir()
        made.append(d)
        return str(d)

    monkeypatch.setattr(tempfile, "mkdtemp", mkdtemp)
    argv = ["--tiny", "--unloaded", "6", "--max-batch", "4"]
    jmod = jax_script("bench_serve")
    monkeypatch.setattr(jrig, "bench_preflight", lambda *a, **k: {"platform": "cpu"})
    monkeypatch.setattr(jrig, "bench_watchdog", lambda *a, **k: argparse.Namespace(
        cancel=lambda: None))
    monkeypatch.setattr(jrig, "enable_compile_cache_for_probe", lambda *a, **k: None)
    for mod in (jserve, tserve_mod):
        monkeypatch.setattr(mod, "RAUService", _FakeService)
        monkeypatch.setattr(mod, "serve", lambda *a, **k: _FakeServer())
    monkeypatch.setattr(sys, "argv", ["bench_serve.py"] + argv)
    jwarm, jseq = sent_payloads(monkeypatch, jmod, jmod.main)
    twarm, tseq = sent_payloads(monkeypatch, tserve,
                                lambda: tserve.main(argv + ["--device", "cpu"]))
    assert len(jseq) == len(tseq) == 6 and len(jwarm) == len(twarm) == 17
    assert tseq == jseq and twarm == jwarm
    assert len({p["question"] for p in tseq}) == 6


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    """The two scripts' 6 synthetic JPEGs, each in its own directory."""
    root = tmp_path_factory.mktemp("bench_precompute")
    jdir, tdir = root / "jax", root / "port"
    jdir.mkdir()
    tdir.mkdir()
    jax_script("bench_precompute").make_images(str(jdir), 6)
    tpre.make_images(str(tdir), 6)
    return str(jdir), str(tdir)


def test_precompute_jpegs_are_the_jax_scripts(jpegs):
    jdir, tdir = jpegs
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir)) and len(names) == 6
    for n in names:
        with open(os.path.join(jdir, n), "rb") as a, open(os.path.join(tdir, n), "rb") as b:
            assert a.read() == b.read(), n


def test_precompute_shard_is_the_jax_paths(jpegs, tmp_path):
    """A 6-image, 64 px VGG16 sweep at batch 2 in float32 (--f32): the port
    script's sweep against the JAX script's call of the JAX package, on
    JAX's init carried over."""
    from rau_vqa_tpu import precompute as JPC
    from rau_vqa_tpu_torch.data.features import coco_feat_name
    from rau_vqa_tpu_torch.precompute import scan_image_dir

    _, tdir = jpegs
    rel = scan_image_dir(tdir)
    assert rel == JPC.scan_image_dir(tdir)
    bb = jax_vgg(0)
    want = JPC.precompute_features(tdir, rel, str(tmp_path / "jax"), "vgg16", bb, size=64,
                                   batch_size=2, dtype="float32", compute_dtype=None)
    args = argparse.Namespace(size=64, batch=2, dtype="float32", f32=True)
    _, got = tpre.sweep(tdir, rel, str(tmp_path / "port"), "vgg16", params_from_jax(bb), args,
                        torch.device("cpu"))
    assert got.index == want.index and len(got.index) == 6
    names = [coco_feat_name(p) for p in rel]
    assert_scaled_close(got.get_batch(names, [1] * 6), want.get_batch(names, [1] * 6), 3e-5)


def test_full_width_serve_fixture(tmp_path):
    """The JAX script's full-width spec (one image class an answer, 1000, as
    one-channel bumps over 512 channels) is refused by the JAX package's own
    fixture; the port's script takes dense class codes, which change the
    features' values only (the pool's words and feature names come from the
    vocabulary and the image list)."""
    from rau_vqa_tpu.data.fixtures import FixtureSpec as JaxSpec
    from rau_vqa_tpu.data.fixtures import generate_fixture as jax_fixture

    with pytest.raises(ValueError, match="needs feat_dim"):
        jax_fixture(str(tmp_path / "jax"), JaxSpec(
            n_train=64, n_test=32, n_images=32, n_words=12000, n_answers=1000, seq_len=26,
            feat_dim=512, feat_w=14, feat_h=14))
    spec = tserve.fixture_spec(False)
    assert spec.class_code == "dense"
    assert (spec.n_train, spec.n_test, spec.n_images, spec.n_words, spec.n_answers,
            spec.seq_len, spec.feat_dim, spec.feat_w, spec.feat_h) == \
        (64, 32, 32, 12000, 1000, 26, 512, 14, 14)
