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
