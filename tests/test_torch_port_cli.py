"""The port's CLI (``python -m rau_vqa_tpu_torch.cli``) against the JAX
package's, on the CPU (``--device cpu``): the same commands write the same
file names, and the port's ``eval`` of a JAX-written snapshot writes the
rows the JAX CLI's ``eval`` of it writes (both through the plain float32
path: the JAX CLI's default, the port's ``--plain-eval``)."""

import json
import os

import pytest
import torch

from rau_vqa_tpu import cli as jcli
from rau_vqa_tpu_torch import cli as tcli
from tests.test_torch_port_trainer import one_torch_thread  # noqa: F401 (autouse)


def listing(root):
    """Every file under ``root``, relative, the snapshot suffixes cut."""
    out = set()
    for d, _, files in os.walk(root):
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), root)
            for suffix in (".msgpack", ".pt"):
                if rel.endswith(suffix):
                    rel = rel[:-len(suffix)] + "[snapshot]"
            out.add(rel)
    return out


def results(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "results")):
        for f in files:
            with open(os.path.join(d, f)) as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = json.load(fh)
    return out


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX CLI trains ours_ss on its fixture for two epochs."""
    root = tmp_path_factory.mktemp("jax_cli")
    assert jcli.main(["train", "--preset", "ours_ss", "--fixture", "--epochs",
                      "2", "--save-dir", str(root / "run")]) == 0
    return root


def test_train_eval_ask_write_the_jax_cli_files(jax_run, tmp_path, capsys):
    run = tmp_path / "run"
    assert tcli.main(["--device", "cpu", "train", "--preset", "ours_ss",
                      "--fixture", "--epochs", "2", "--save-dir", str(run)]) == 0
    assert "final testOE accuracy per hop" in capsys.readouterr().out
    jax_files = {f for f in listing(jax_run / "run")
                 if not f.startswith("fixture")}
    port_files = {f for f in listing(run) if not f.startswith("fixture")}
    assert port_files == jax_files
    assert "snapshot/snapshot_iter000020_epoch2.00[snapshot]" in port_files
    assert sorted(results(run)) == sorted(results(jax_run / "run"))
    with open(run / "config.json") as f1, open(jax_run / "run" / "config.json") as f2:
        port_cfg, jax_cfg = json.load(f1), json.load(f2)
    assert port_cfg["model"]["vocab_size"] == jax_cfg["model"]["vocab_size"]
    assert set(port_cfg["train"]) <= set(jax_cfg["train"])
    rows = [json.loads(x) for x in open(run / "training_log" / "metrics.jsonl")]
    jrows = [json.loads(x) for x in
             open(jax_run / "run" / "training_log" / "metrics.jsonl")]
    assert [(r["kind"], sorted(r)) for r in rows] == \
        [(r["kind"], sorted(r)) for r in jrows]

    snap = str(run / "snapshot" / "snapshot_iter000020_epoch2.00.pt")
    # --device after the command works too
    assert tcli.main(["eval", "--device", "cpu", "--fixture", "--checkpoint",
                      snap, "--save-dir", str(tmp_path / "ev")]) == 0
    out = capsys.readouterr().out
    assert "evaluating snapshot at epoch 2 (1 hops)" in out
    assert sorted(results(tmp_path / "ev")) == [
        k for k in sorted(results(run)) if "2.00" in k]
    assert tcli.main(["--device", "cpu", "ask", "--fixture", "--checkpoint",
                      snap, "--question", "w01 w02 w03", "--feat-name",
                      "COCO_val2014_000000000003.t7", "--topk", "3",
                      "--save-dir", str(tmp_path / "ask")]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "Q: w01 w02 w03" and len(lines) == 4
    assert all(line.strip().startswith(f"{i + 1}. ans")
               for i, line in enumerate(lines[1:]))


def test_eval_of_a_jax_snapshot_writes_the_jax_rows(jax_run, tmp_path, capsys):
    snap = str(jax_run / "run" / "snapshot" / "snapshot_iter000020_epoch2.00.msgpack")
    assert jcli.main(["eval", "--fixture", "--checkpoint", snap,
                      "--save-dir", str(tmp_path / "jax")]) == 0
    assert tcli.main(["--device", "cpu", "eval", "--fixture", "--plain-eval",
                      "--checkpoint", snap, "--save-dir",
                      str(tmp_path / "port")]) == 0
    j, t = results(tmp_path / "jax"), results(tmp_path / "port")
    assert sorted(t) == sorted(j) and len(t) == 2 * 3   # OE, MC x (1 hop + 2)
    assert t == j
    # the port's default sweep (its serving kernels' plain versions, bf16
    # products) answers the same questions
    assert tcli.main(["--device", "cpu", "eval", "--fixture", "--checkpoint",
                      snap, "--save-dir", str(tmp_path / "fused")]) == 0
    f = results(tmp_path / "fused")
    assert sorted(f) == sorted(j)
    assert all([r["question_id"] for r in f[k]] == [r["question_id"] for r in j[k]]
               for k in f)


def test_fixture_command_writes_the_jax_bundle(tmp_path):
    assert tcli.main(["fixture", "--out", str(tmp_path / "t")]) == 0
    assert jcli.main(["fixture", "--out", str(tmp_path / "j")]) == 0
    assert listing(tmp_path / "t") == listing(tmp_path / "j")
    for name in ("data_prepro.json", "gt_annotations.json"):
        with open(tmp_path / "t" / "vqa_prepro" / name) as a, \
                open(tmp_path / "j" / "vqa_prepro" / name) as b:
            assert json.load(a) == json.load(b)


def test_commands_default_to_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["train", "--fixture", "--epochs", "1", "--save-dir",
                   str(tmp_path / "run")])
    assert tcli.main(["train", "--fixture", "--epochs", "1", "--save-dir",
                      str(tmp_path / "run"), "--device", "cpu"]) == 0


# ---------------------------------------------------------------------------
# from raw images through a frozen backbone
# ---------------------------------------------------------------------------

def _torchvision_vgg16(path, seed=0):
    """A torchvision-format vgg16 state dict of JAX's init (x0.72 a
    convolution) at ``path``; returns JAX's tree."""
    import numpy as np

    from rau_vqa_tpu_torch.models.backbones.vgg import TORCH_CONV_INDICES
    from tests.test_torch_port_vgg_vit import jax_vgg
    bb = jax_vgg(seed, 0.72)
    state = {}
    for i, c in zip(TORCH_CONV_INDICES, bb["convs"]):
        state[f"features.{i}.weight"] = torch.as_tensor(
            np.ascontiguousarray(c["w"].transpose(3, 2, 0, 1)))
        state[f"features.{i}.bias"] = torch.as_tensor(c["b"])
    torch.save(state, path)
    return bb


@pytest.fixture(scope="module")
def image_run(tmp_path_factory):
    """A JAX snapshot of the image head (ours_ms, 2x2x512) fitted one epoch
    from the fixture's images through a frozen VGG16, and that VGG16 as a
    torchvision .pth."""
    from tests.test_torch_port_trainer import image_fixture_root, image_trainers
    root = tmp_path_factory.mktemp("image_cli")
    fix = image_fixture_root.__wrapped__(tmp_path_factory)
    pth = str(root / "vgg16.pth")
    bb = _torchvision_vgg16(pth)
    jt, _ = image_trainers(fix, root, bb)
    jt.train_epoch()
    return {"ck": jt.save(), "images": os.path.join(fix, "images"), "pth": pth}


def test_eval_from_images_writes_the_jax_cli_rows(image_run, tmp_path, capsys):
    """``eval --image-root --backbone vgg16 --backbone-state`` of a JAX
    snapshot: the rows the JAX CLI's eval writes (the plain float32 path on
    both sides; the native decoder, bit-equal on both), and the decoder that
    ran is printed."""
    flags = ["--checkpoint", image_run["ck"], "--fixture", "--image-root",
             image_run["images"], "--backbone", "vgg16", "--backbone-state",
             image_run["pth"], "--image-size", "64"]
    assert jcli.main(["eval", *flags, "--save-dir", str(tmp_path / "j")]) == 0
    assert tcli.main(["--device", "cpu", "eval", *flags, "--plain-eval",
                      "--save-dir", str(tmp_path / "t")]) == 0
    assert "images decoded by: " in capsys.readouterr().out
    want, got = results(tmp_path / "j"), results(tmp_path / "t")
    assert sorted(got) == sorted(want) and len(got) > 0
    assert got == want


def test_train_and_eval_a_fixture_through_a_random_backbone(tmp_path, capsys):
    """``train --fixture --backbone vgg16``: the fixture's images at 64 px, a
    random VGG16 from seed 0 (He x0.72 a convolution: pool5 near unit
    scale); ``eval --fixture --backbone vgg16`` of its snapshot makes the
    same backbone and scores the last sweep's accuracy."""
    run = tmp_path / "run"
    assert tcli.main(["--device", "cpu", "train", "--preset", "ours_ss", "--fixture",
                      "--backbone", "vgg16", "--epochs", "1", "--save-dir", str(run)]) == 0
    out = capsys.readouterr().out
    assert "random-init vgg16" in out and "images decoded by: native" in out
    final = [x for x in out.splitlines() if x.startswith("final testOE")][0]
    with open(run / "config.json") as f:
        model = json.load(f)["model"]
    assert (model["cnn_dim"], model["cnn_w"], model["cnn_h"]) == (512, 2, 2)
    ck = str(run / "snapshot" / "snapshot_iter000010_epoch1.00.pt")
    assert tcli.main(["--device", "cpu", "eval", "--checkpoint", ck, "--fixture",
                      "--backbone", "vgg16", "--save-dir", str(tmp_path / "ev")]) == 0
    hops = [x.split("OE ")[1].split(",")[0] for x in capsys.readouterr().out.splitlines()
            if x.startswith("hop ")]
    assert ", ".join(hops) == final.split(": ")[1]
    # the random backbone's scale: pool5 near unit, the head's tanh alive
    from rau_vqa_tpu_torch.models import pipeline
    from rau_vqa_tpu_torch.models.backbones import vgg
    bb = vgg.vgg16_pool5_init(torch.Generator().manual_seed(0), device="cpu")
    bb = {"convs": [{"w": c["w"] * 0.72, "b": c["b"]} for c in bb["convs"]]}
    x = torch.randint(0, 256, (4, 64, 64, 3), dtype=torch.uint8)
    std = pipeline.extract_features("vgg16", bb, x).std().item()
    assert 0.1 < std < 5.0, std


@pytest.mark.parametrize("flags,match", [
    (["--backbone", "vgg16", "--image-size", "70"], "multiple of 32"),
    (["--backbone", "vgg16", "--image-size", "128"], "4x4=16 feature grid"),
    (["--backbone", "vit", "--image-size", "448"], "fix the input at 224px"),
    (["--backbone", "vit", "--image-size", "224"], "256 tokens"),
    (["--image-size", "64"], "needs --backbone"),
])
def test_image_root_checks_the_grid_first(tmp_path, flags, match):
    """The backbone's grid against the model's, before any weights load."""
    with pytest.raises(SystemExit, match=match):
        tcli.main(["--device", "cpu", "train", "--preset", "ours_ss", "--fixture",
                   "--image-root", str(tmp_path), "--save-dir", str(tmp_path / "r"),
                   *flags])


def test_backbone_refusals(tmp_path, capsys):
    """The ViT has no random fixture backbone.  What fine-tuning's item
    once refused runs since it was ported: a fine-tuned JAX snapshot as
    ``--backbone-state`` (its backbone group, and the RMS interface its
    sidecar records, adopted by the fresh head), and ``--preset
    ours_resnet_ft`` on the fixture (a random VGG16 fine-tuned in bf16 over
    grouped images)."""
    import numpy as np

    from rau_vqa_tpu.utils import checkpoint as jck
    from rau_vqa_tpu_torch.utils import checkpoint as tck
    from tests.test_torch_port_vgg_vit import jax_vgg
    with pytest.raises(SystemExit, match="conv backbones"):
        tcli.main(["--device", "cpu", "train", "--fixture", "--backbone", "vit",
                   "--save-dir", str(tmp_path / "v")])
    snap = jck.save_checkpoint(
        str(tmp_path / "ft"), 5, 1.0,
        {"params": {"embed": {"x": np.zeros(3)}, "backbone": jax_vgg(4, 0.72)},
         "step": np.int32(5)},
        extra={"train_backbone": True, "backbone": "vgg16", "backbone_feat_norm": True})
    run = tmp_path / "m"
    assert tcli.main(["--device", "cpu", "train", "--fixture", "--backbone", "vgg16",
                      "--backbone-state", snap, "--epochs", "1",
                      "--save-dir", str(run)]) == 0
    assert f"adopting backbone_feat_norm=True from {snap}" in capsys.readouterr().out
    (meta,) = [json.load(open(p)) for p in run.glob("snapshot/*.json")]
    assert meta["backbone_feat_norm"] is True and meta["train_backbone"] is False
    run = tmp_path / "rft"
    assert tcli.main(["--device", "cpu", "train", "--preset", "ours_resnet_ft", "--fixture",
                      "--epochs", "1", "--save-dir", str(run)]) == 0
    (pt,) = run.glob("snapshot/*.pt")
    meta = tck.checkpoint_meta(str(pt))
    assert meta["train_backbone"] is True and meta["backbone"] == "vgg16"
    assert meta["model_config"]["compute_dtype"] == "bfloat16"
    assert len(tck.load_backbone_group(str(pt), "vgg16")["convs"]) == 13


@pytest.mark.parametrize("backbone", ["vgg16", "vit"])
def test_backbone_state_loads_as_the_jax_cli(tmp_path, backbone, monkeypatch):
    """``_load_backbone_state``: a torchvision vgg16 or timm ViT state dict
    (.pth) -> JAX's tree, in the type asked (bf16 by default, the serving
    type)."""
    import jax
    import numpy as np

    from rau_vqa_tpu.models.backbones import vit as JVT
    from rau_vqa_tpu_torch.models.backbones import vit as TVT
    from tests.test_torch_port_vgg_vit import JTINY, TTINY, _timm_state, assert_same_tree
    path = str(tmp_path / f"{backbone}.pth")
    if backbone == "vgg16":
        _torchvision_vgg16(path, seed=1)
    else:
        monkeypatch.setattr(JVT, "VIT_L14", JTINY)
        monkeypatch.setattr(TVT, "VIT_L14", TTINY)
        torch.save({k: torch.as_tensor(v) for k, v in
                    _timm_state(np.random.RandomState(2), JTINY).items()}, path)
    want = jcli._load_backbone_state(backbone, path)
    got = tcli._load_backbone_state(backbone, path, torch.device("cpu"), torch.float32)
    assert_same_tree(got, jax.tree.map(np.asarray, want))
    b16 = tcli._load_backbone_state(backbone, path, torch.device("cpu"))
    assert {t.dtype for t in jax.tree.leaves(b16)} == {torch.bfloat16}
