"""The port's serving artifacts (rau_vqa_tpu_torch/eval/export.py and
eval/chain.py) against the JAX package's, on the CPU.

The counterparts of the cases of tests/test_export.py, but its TPU-lowering
case (``test_sweep_programs_tpu_lowering_no_hardware``), which has none on
the card: ``torch.export`` keeps the serving kernels as the ``rau_vqa::``
custom ops, whatever device the program serves on.  Both packages export
from one JAX ``.msgpack`` snapshot of a tiny config.  The plain artifact
(``--no-fused-eval``) is held to the JAX package's artifact of the same
snapshot at rtol 1e-4 / atol 1e-5; the default (fused) artifact to the JAX
``predict_fused`` (both Pallas kernels in interpret mode) at rtol 1e-3 /
atol 1e-4 with per-hop answers equal (tests/test_torch_port_serve.py's
bars), and to the port's ``PredictStep`` bit for bit.  The chain programs
with ``fused=False`` give the JAX chains' salt and answer sums.  The symbolic
batch is run at B=1 and at batches no ladder names; a saved artifact loads
and runs in a fresh interpreter that imports nothing but
``rau_vqa_tpu_torch.eval.export``.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rau_vqa_tpu import cli as jcli
from rau_vqa_tpu.config import get_preset as jget_preset
from rau_vqa_tpu.eval import chain as jchain
from rau_vqa_tpu.eval import export as jexport
from rau_vqa_tpu.eval import predict as jpred
from rau_vqa_tpu.models import rau as jrau
from rau_vqa_tpu.models.backbones import resnet as JR
from rau_vqa_tpu.train.trainer import init_train_state as jinit_state
from rau_vqa_tpu.utils.checkpoint import save_checkpoint as jsave
from rau_vqa_tpu_torch import cli as tcli
from rau_vqa_tpu_torch.config import ModelConfig
from rau_vqa_tpu_torch.convert import params_from_jax
from rau_vqa_tpu_torch.eval import chain as tchain
from rau_vqa_tpu_torch.eval import export as E
from rau_vqa_tpu_torch.eval import predict as tpred
from rau_vqa_tpu_torch.models import pipeline as TP
from rau_vqa_tpu_torch.ops import fused_resnet, lstm_encoder, rau_hops
from rau_vqa_tpu_torch.train.trainer import init_train_state
from rau_vqa_tpu_torch.utils.checkpoint import save_checkpoint
from tests.test_torch_port_backbone import narrow_resnet
from tests.test_torch_port_trainer import one_torch_thread  # noqa: F401 (autouse)

PLAIN = dict(rtol=1e-4, atol=1e-5)
FUSED = dict(rtol=1e-3, atol=1e-4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny_jcfg(**kw):
    """tests/test_export.py's tiny config (``kw`` replaces its widths)."""
    dims = dict(n_hops=2, vocab_size=50, embed_dim=8, rnn_size=8, multfeat_dim=8,
                attfeat_dim=8, att_rnn_size=8, cnn_dim=8, cnn_w=2, cnn_h=2,
                answer_size=10, seq_len=6)
    return dataclasses.replace(jget_preset("ours_ms").model, **{**dims, **kw})


def port_cfg(jcfg):
    return ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})


def make_inputs(cfg, b, max_len=None, seed=0):
    """tests/test_export.py's inputs: ZEROPAD past each length."""
    rs = np.random.RandomState(seed)
    T = cfg.seq_len
    lens = rs.randint(1, (max_len or T) + 1, b).astype(np.int32)
    toks = rs.randint(1, cfg.vocab_size, (b, T)).astype(np.int32)
    toks[np.arange(T)[None, :] >= lens[:, None]] = 0
    feats = rs.randn(b, cfg.cnn_spat, cfg.cnn_dim).astype(np.float32)
    return toks, lens, feats


def T(x):
    return torch.as_tensor(np.asarray(x))


def port_state(cfg, params):
    """A train state of the port holding ``params``, as a snapshot holds one."""
    state = init_train_state(cfg, 0, device="cpu")._asdict()
    return {**state, "params": params}


@pytest.fixture(scope="module")
def snap(tmp_path_factory):
    """A JAX .msgpack snapshot of the tiny config (step 3) and its params."""
    root = tmp_path_factory.mktemp("export")
    jcfg = tiny_jcfg()
    state = jinit_state(jax.random.PRNGKey(7), jcfg)
    path = jsave(str(root / "ckpt"), 3, 1.0, state._asdict(),
                 extra={"model_config": dataclasses.asdict(jcfg)})
    p = jax.tree.map(np.asarray, state.params)
    return {"root": root, "path": path, "jcfg": jcfg, "cfg": port_cfg(jcfg), "p": p}


@pytest.fixture(scope="module")
def fused_art(snap):
    """``export`` of the snapshot as the service runs it, ladder 4/6."""
    art = str(snap["root"] / "fused")
    assert tcli.main(["--device", "cpu", "export", "--checkpoint", snap["path"],
                      "--out", art, "--eval-buckets", "4"]) == 0
    return art


@pytest.fixture(scope="module")
def plain_arts(snap):
    """The plain (--no-fused-eval) artifact of the port and the JAX
    package's artifact of the same snapshot."""
    art, jart = str(snap["root"] / "plain"), str(snap["root"] / "jax")
    assert tcli.main(["--device", "cpu", "export", "--checkpoint", snap["path"],
                      "--out", art, "--eval-buckets", "4", "--no-fused-eval"]) == 0
    assert jcli.main(["export", "--checkpoint", snap["path"], "--out", jart,
                      "--eval-buckets", "4"]) == 0
    return art, jart


def test_cli_export_from_snapshot(snap, fused_art, tmp_path):
    """export: a self-describing snapshot (.msgpack, and the port's .pt of
    the same params) -> an artifact whose answers are the live step's."""
    with open(os.path.join(fused_art, "meta.json")) as f:
        meta = json.load(f)
    assert meta["format"] == "rau_vqa_tpu_torch.export" and meta["kind"] == "predict"
    assert meta["ladder"] == [4, 6] and meta["step"] == 3
    assert meta["fused"] is True and meta["device"] == "cpu"
    assert sorted(os.listdir(fused_art)) == ["meta.json", "predict_T04.pt2",
                                             "predict_T06.pt2"]
    cfg, tp = snap["cfg"], params_from_jax(snap["p"])
    pt = save_checkpoint(str(tmp_path / "pt"), 3, 1.0, port_state(cfg, tp),
                         extra={"model_config": dataclasses.asdict(cfg)})
    art_pt = str(tmp_path / "from_pt")
    assert tcli.main(["--device", "cpu", "export", "--checkpoint", pt, "--out", art_pt,
                      "--eval-buckets", "none"]) == 0
    toks, lens, feats = make_inputs(cfg, 4, seed=2)
    want = tpred.make_predict_step(cfg, device="cpu")(tp, toks, lens, feats)
    for art in (fused_art, art_pt):
        got = E.load_exported(art)(toks, lens, feats)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("B", [1, 5, 8])
def test_fused_artifact_matches_jax_predict_fused_and_the_step(snap, fused_art, B):
    """The symbolic batch at B=1 and at batches no ladder names: the
    kernels' plain versions through the custom ops, equal to PredictStep and
    within the serving bars of JAX's both-kernel predict_fused."""
    cfg, jcfg = snap["cfg"], snap["jcfg"]
    toks, lens, feats = make_inputs(cfg, B, seed=B)
    run = E.load_exported(fused_art)
    before = (lstm_encoder.KERNEL.launches, rau_hops.KERNEL.launches)
    tab, att = run(toks, lens, feats)
    assert (lstm_encoder.KERNEL.launches, rau_hops.KERNEL.launches) == before
    want = tpred.make_predict_step(cfg, buckets=(4,), device="cpu")(
        params_from_jax(snap["p"]), toks, lens, feats)
    torch.testing.assert_close(tab, want[0], rtol=0, atol=0)
    torch.testing.assert_close(att, want[1], rtol=0, atol=0)
    jt, ja = jpred.predict_fused(snap["p"], jcfg, jnp.asarray(toks), jnp.asarray(lens),
                                 jnp.asarray(feats), interpret=True, fuse_encoder=True)
    assert tab.shape == (cfg.n_hops + 2, B, cfg.answer_size)
    np.testing.assert_allclose(tab.numpy(), np.asarray(jt), **FUSED)
    np.testing.assert_allclose(att.numpy(), np.asarray(ja), **FUSED)
    np.testing.assert_array_equal(tab.argmax(-1).numpy(), np.asarray(jt).argmax(-1))


@pytest.mark.parametrize("B", [1, 3, 8])
def test_plain_artifact_matches_the_jax_artifact(snap, plain_arts, B):
    """The --no-fused-eval artifact against the JAX package's artifact of
    the same snapshot (and the live plain predict, bit for bit)."""
    art, jart = plain_arts
    cfg = snap["cfg"]
    toks, lens, feats = make_inputs(cfg, B, seed=10 + B)
    tab, att = E.load_exported(art)(toks, lens, feats)
    jt, ja = jexport.load_exported(jart)(toks, lens, feats)
    np.testing.assert_allclose(tab.numpy(), np.asarray(jt), **PLAIN)
    np.testing.assert_allclose(att.numpy(), np.asarray(ja), **PLAIN)
    np.testing.assert_array_equal(tab.argmax(-1).numpy(), np.asarray(jt).argmax(-1))
    live = tpred.predict(params_from_jax(snap["p"]), cfg, T(toks), T(lens), T(feats))
    torch.testing.assert_close(tab, live[0], rtol=0, atol=0)


def test_export_bucket_dispatch_exact(snap, fused_art):
    """A short-question batch runs the T=4 program alone and equals the
    full-length live step exactly (the ladder's truncation is exact)."""
    cfg = snap["cfg"]
    toks, lens, feats = make_inputs(cfg, 5, max_len=4, seed=1)
    run = E.load_exported(fused_art)
    got = run(toks, lens, feats)
    assert list(run._programs) == [4]
    want = tpred.make_predict_step(cfg, device="cpu")(
        params_from_jax(snap["p"]), toks, lens, feats)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_pick_bucket_overflow_raises(snap, fused_art):
    cfg = snap["cfg"]
    ladder = tpred.bucket_ladder(cfg.seq_len, (4,))
    assert ladder == [4, cfg.seq_len]
    assert [tpred.pick_bucket(ladder, n) for n in (3, 4, 5)] == [4, 4, cfg.seq_len]
    with pytest.raises(ValueError, match="exceeds the ladder top"):
        tpred.pick_bucket(ladder, cfg.seq_len + 1)
    toks, lens, feats = make_inputs(cfg, 3)
    lens[0] = cfg.seq_len + 5
    with pytest.raises(ValueError, match="exceeds the ladder top"):
        E.load_exported(fused_art)(toks, lens, feats)


def test_export_rejects_foreign_dirs(plain_arts, fused_art, tmp_path):
    """A foreign directory and the JAX package's artifact are refused by
    name; the JAX loader refuses the port's (its format)."""
    os.makedirs(tmp_path / "x")
    with open(tmp_path / "x" / "meta.json", "w") as f:
        json.dump({"format": "something_else"}, f)
    with pytest.raises(ValueError, match="not a rau_vqa_tpu_torch.export artifact"):
        E.load_exported(str(tmp_path / "x"))
    with pytest.raises(ValueError, match="JAX package's artifact"):
        E.load_exported(plain_arts[1])
    with pytest.raises(ValueError, match="not a rau_vqa_tpu export"):
        jexport.load_exported(fused_art)


def test_saved_artifact_runs_in_a_fresh_interpreter(snap, fused_art, tmp_path):
    """The ops register on importing eval/export.py alone, before
    torch.export.load reads the saved program."""
    toks, lens, feats = make_inputs(snap["cfg"], 3, seed=4)
    np.savez(tmp_path / "in.npz", toks=toks, lens=lens, feats=feats)
    code = ("import sys, numpy as np, torch\n"
            "from rau_vqa_tpu_torch.eval.export import load_exported\n"
            f"d = np.load({str(tmp_path / 'in.npz')!r})\n"
            f"tab, att = load_exported({fused_art!r})(d['toks'], d['lens'], d['feats'])\n"
            f"np.save({str(tmp_path / 'out.npy')!r}, tab.numpy())\n"
            "assert 'jax' not in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          env={**os.environ, "OMP_NUM_THREADS": "1"}, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    want, _ = E.load_exported(fused_art)(toks, lens, feats)
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"), want.numpy())


def test_cli_export_shape_mismatch_fails_loudly(snap, tmp_path):
    """A metadata-less snapshot under a mismatched --preset is refused with
    the checkpoint's shape error, not baked in."""
    pt = save_checkpoint(str(tmp_path / "pt"), 1, 1.0,
                         port_state(snap["cfg"], params_from_jax(snap["p"])))
    os.remove(os.path.splitext(pt)[0] + ".json")
    with pytest.raises(ValueError, match="shape mismatch"):
        tcli.main(["--device", "cpu", "export", "--checkpoint", pt,
                   "--out", str(tmp_path / "art")])


def test_cli_export_pixels_vit(snap, tmp_path, monkeypatch):
    """export --backbone vit takes the ViT config's input side (not the
    stride-32 rule) and checks the side and the grid up front."""
    from rau_vqa_tpu_torch.models.backbones import vit as tvit
    vcfg = tvit.ViTConfig(image_size=16, patch=4, dim=32, depth=1, heads=4, mlp_ratio=2.0)
    monkeypatch.setattr(tvit, "VIT_L14", vcfg)
    bb = tvit.vit_init(torch.Generator().manual_seed(1), vcfg, device="cpu")
    monkeypatch.setattr(tcli, "_load_backbone_state", lambda *a, **k: bb)
    jcfg = tiny_jcfg(cnn_dim=32, cnn_w=4, cnn_h=4)
    path = jsave(str(tmp_path / "c"), 1, 1.0, jinit_state(jax.random.PRNGKey(0), jcfg)._asdict(),
                 extra={"model_config": dataclasses.asdict(jcfg)})
    art = str(tmp_path / "art")
    assert tcli.main(["--device", "cpu", "export", "--checkpoint", path, "--out", art,
                      "--backbone", "vit", "--backbone-state", "x"]) == 0
    with open(os.path.join(art, "meta.json")) as f:
        meta = json.load(f)
    assert meta["kind"] == "pixels_predict" and meta["image_size"] == 16
    assert meta["ladder"] == [6]           # no buckets by default from pixels
    with pytest.raises(SystemExit):        # a side the position embedding refuses
        tcli.main(["--device", "cpu", "export", "--checkpoint", path, "--out",
                   str(tmp_path / "a2"), "--backbone", "vit", "--backbone-state", "x",
                   "--image-size", "448"])
    with pytest.raises(SystemExit):        # the snapshot's grid is not the ViT's
        tcli.main(["--device", "cpu", "export", "--checkpoint", snap["path"], "--out",
                   str(tmp_path / "a3"), "--backbone", "vit", "--backbone-state", "x"])


@pytest.fixture(scope="module")
def pixels_setup():
    """A head for the narrow ResNet's 2x2 grid of 256 features at 64 px."""
    jcfg = tiny_jcfg(cnn_dim=256)
    p = jax.tree.map(np.asarray, jrau.init_params(jax.random.PRNGKey(0), jcfg))
    bb = jax.tree.map(np.asarray, JR.fold_batchnorm(narrow_resnet(101)))
    return jcfg, port_cfg(jcfg), p, bb


def test_export_pixels_roundtrip(pixels_setup, tmp_path):
    """The from-pixels artifact (backbone baked in): the fused program
    equals the live fused path (every identity run through the stage op,
    the head's two ops) bit for bit at B=1, 3, 8 across two buckets; the
    plain one is held to the JAX package's artifact."""
    jcfg, cfg, p, bb = pixels_setup
    tp, tbb = params_from_jax(p), params_from_jax(bb)
    art = str(tmp_path / "pix")
    paths = E.export_pixels_predict(tp, cfg, "resnet101", tbb, art, image_size=64,
                                    buckets=(4,), device="cpu")
    assert set(paths) == {4, 6} and all(os.path.basename(v).startswith("pixels_T")
                                        for v in paths.values())
    run = E.load_exported(art)
    kw = tpred.pack_kernel_weights(tp)
    rs = np.random.RandomState(7)
    for b, max_len in ((1, 4), (3, 6), (8, 4)):
        images = rs.randint(0, 256, (b, 64, 64, 3)).astype(np.uint8)
        toks, lens, _ = make_inputs(cfg, b, max_len=max_len, seed=b)
        before = fused_resnet.KERNEL.launches
        got = run(images, toks, lens)
        assert fused_resnet.KERNEL.launches == before
        feats = TP.extract_features("resnet101", tbb, T(images),
                                    fused_stages=TP.SERVING_STAGES).float()
        want = tpred.predict_fused(tp, kw, cfg, T(toks), T(lens), feats)
        for a, w in zip(got, want):
            torch.testing.assert_close(a, w, rtol=0, atol=0)
    with pytest.raises(ValueError, match="expects images"):
        run(np.zeros((1, 32, 32, 3), np.uint8), toks[:1], lens[:1])
    plain, jart = str(tmp_path / "plain"), str(tmp_path / "jax")
    E.export_pixels_predict(tp, cfg, "resnet101", tbb, plain, image_size=64, fused=False,
                            device="cpu")
    jexport.export_pixels_predict(p, jcfg, "resnet101", bb, jart, image_size=64)
    images = rs.randint(0, 256, (3, 64, 64, 3)).astype(np.uint8)
    toks, lens, _ = make_inputs(cfg, 3, seed=3)
    tab, att = E.load_exported(plain)(images, toks, lens)
    jt, ja = jexport.load_exported(jart)(images, toks, lens)
    np.testing.assert_allclose(tab.numpy(), np.asarray(jt), **PLAIN)
    np.testing.assert_allclose(att.numpy(), np.asarray(ja), **PLAIN)


def test_export_serve_chain_roundtrip(snap, tmp_path):
    """The bench's chain artifact (kind serve_chain, the parameters as
    operands) gives the live chain's salt and sums; the plain chain gives
    the JAX chain's."""
    cfg, jcfg, p = snap["cfg"], snap["jcfg"], snap["p"]
    tp = params_from_jax(p)
    B, K = 4, 3
    art = str(tmp_path / "chain")
    E.export_serve_chain(tp, cfg, art, batch=B, chain=K, n_acc=2, device="cpu")
    with open(os.path.join(art, "meta.json")) as f:
        meta = json.load(f)
    assert meta["kind"] == "serve_chain" and (meta["batch"], meta["chain"]) == (B, K)
    toks, lens, feats = make_inputs(cfg, B, seed=2)
    salt0 = torch.tensor(7, dtype=torch.int32)
    salt_a, acc_a = E.load_exported(art)(tp, T(toks), T(lens), T(feats), salt0)
    salt_b, acc_b = tchain.make_serve_chain(cfg, K, 2)(tp, T(toks), T(lens), T(feats), salt0)
    assert tuple(acc_a.shape) == (cfg.n_hops + 2, 2)
    torch.testing.assert_close(acc_a, acc_b, rtol=0, atol=0)
    assert int(salt_a) == int(salt_b)
    js, ja = jax.jit(jchain.make_serve_chain(jcfg, K, 2))(p, toks, lens, feats, np.int32(7))
    ts, ta = tchain.make_serve_chain(cfg, K, 2, fused=False)(tp, T(toks), T(lens), T(feats),
                                                            salt0)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert int(ts) == int(js)


def test_export_pixels_chain_roundtrip(pixels_setup, tmp_path):
    """The from-pixels chain (kind pixels_chain, both trees as operands):
    the artifact gives the live chain's numbers, the plain chain the JAX
    chain's."""
    jcfg, cfg, p, bb = pixels_setup
    tp, tbb = params_from_jax(p), params_from_jax(bb)
    size, B, K, Q = 64, 2, 2, 2
    art = str(tmp_path / "pchain")
    E.export_pixels_chain(tbb, tp, cfg, "resnet101", art, batch=B, chain=K, qpi=Q,
                          image_size=size, n_acc=2, fused_stages=(0, 1, 2, 3), device="cpu")
    rs = np.random.RandomState(3)
    images = T(rs.randint(0, 256, (B, size, size, 3)).astype(np.uint8))
    toks, lens, _ = make_inputs(cfg, B * Q, seed=3)
    salt0 = torch.tensor(5, dtype=torch.int32)
    args = (tbb, tp, images, T(toks), T(lens), salt0)
    salt_a, acc_a = E.load_exported(art)(*args)
    salt_b, acc_b = tchain.make_pixels_chain(cfg, "resnet101", K, Q, 2,
                                             fused_stages=(0, 1, 2, 3))(*args)
    torch.testing.assert_close(acc_a, acc_b, rtol=0, atol=0)
    assert int(salt_a) == int(salt_b)
    js, ja = jax.jit(jchain.make_pixels_chain(jcfg, "resnet101", K, Q, 2))(
        bb, p, images.numpy(), toks, lens, np.int32(5))
    ts, ta = tchain.make_pixels_chain(cfg, "resnet101", K, Q, 2, fused=False)(*args)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert int(ts) == int(js)


def test_serve_chain_accepts_python_int_salt(snap):
    cfg = snap["cfg"]
    toks, lens, feats = make_inputs(cfg, 4, seed=5)
    salt, acc = tchain.make_serve_chain(cfg, 2, 2)(params_from_jax(snap["p"]), T(toks),
                                                   T(lens), T(feats), 0)
    assert tuple(acc.shape) == (cfg.n_hops + 2, 2) and salt.dtype == torch.int32
    assert int(salt) > 0


def test_export_serve_chain_meta_clamps_n_acc(snap, tmp_path):
    """meta.json gives the program's own acc shape: n_acc clamped to the
    batch, as the chain clamps it."""
    cfg, tp = snap["cfg"], params_from_jax(snap["p"])
    art = str(tmp_path / "clamp")
    E.export_serve_chain(tp, cfg, art, batch=2, chain=1, n_acc=8, device="cpu")
    with open(os.path.join(art, "meta.json")) as f:
        meta = json.load(f)
    assert meta["n_acc"] == 2 and meta["outputs"]["acc"] == [cfg.n_hops + 2, 2]
    toks, lens, feats = make_inputs(cfg, 2, seed=1)
    _, acc = E.load_exported(art)(tp, T(toks), T(lens), T(feats),
                                  torch.tensor(0, dtype=torch.int32))
    assert list(acc.shape) == meta["outputs"]["acc"]


def test_chain_artifact_unknown_code_rev_not_stale(snap, tmp_path):
    """An artifact built outside a checkout (code_rev 'unknown') is not
    rebuilt inside one; a changed protocol is."""
    cfg, tp = snap["cfg"], params_from_jax(snap["p"])
    art = str(tmp_path / "rev")
    expect = {"kind": "serve_chain", "batch": 2, "chain": 1,
              "model_config": dataclasses.asdict(cfg)}
    builds = []

    def build():
        builds.append(1)
        E.export_serve_chain(tp, cfg, art, batch=2, chain=1, n_acc=2, device="cpu")

    E.load_or_build_chain_artifact(art, build, expect, log=lambda *_: None)
    assert len(builds) == 1
    meta_path = os.path.join(art, "meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta["code_rev"] = "unknown"
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    E.load_or_build_chain_artifact(art, build, expect, log=lambda *_: None)
    assert len(builds) == 1
    E.load_or_build_chain_artifact(art, build, dict(expect, chain=2), log=lambda *_: None)
    assert len(builds) == 2
    with pytest.raises(ValueError, match="model_config"):
        E.load_or_build_chain_artifact(art, build, {"kind": "serve_chain"})


def test_ops_have_a_kernel_on_each_device_and_a_shape_function():
    """Each serving op dispatches to its plain version on the CPU and to
    its own implementation on CUDA (none falls through to the CPU one), and
    has a shape function for the trace."""
    for op in ("lstm_encode", "rau_hops", "fused_identity_stage"):
        name = f"rau_vqa::{op}"
        for key in ("CPU", "CUDA", "Meta"):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(name, key), (op, key)
    assert E._KIND_VERSION == jexport._KIND_VERSION
