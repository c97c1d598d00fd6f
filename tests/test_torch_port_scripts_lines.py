"""CPU smokes of the port's measurement scripts (rau_vqa_tpu_torch/scripts/)
as a user runs them, and of the Table 1 recipe's commands.

Each script runs in a subprocess with ``--device cpu`` at the tiny flags
that tests/test_cli.py:418-442 gives the JAX side's, and its last line is
checked: the JAX script's ``metric`` and keys, ``value > 0``, no ``error``,
no ``vs_baseline``, and the port's keys (``device`` "cpu" and null
``power_limit_w`` and canary on the CPU, ``launches``).  The training
bench's first case runs through the root wrapper, bench_torch_train.py.
The two experiment scripts (paper_dims_run, ft_accuracy_ab) run at tiny
sizes as ``slow`` cases; ``paper_dims_run train`` with and without
``--fused-train`` also runs in this process, one epoch of two steps at the
full widths.  repro_table1.sh needs VQA's data, which is not in
the repository: it is syntax-checked, then run with ``python`` standing in
for a recorder, and each command it would run is parsed by the port's CLI.
"""

import json
import os
import shutil
import stat
import subprocess
import sys

import pytest

from rau_vqa_tpu_torch import cli as tcli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ONE_THREAD = {**os.environ, "OMP_NUM_THREADS": "1"}   # beside the other test workers
PORT_KEYS = {"metric", "value", "unit", "device", "power_limit_w", "rig_canary_tflops",
             "rig_canary_frac_peak", "launches"}


def run(argv, timeout=300):
    """The command from the repository's root; (exit code, last line, stderr)."""
    proc = subprocess.run([sys.executable, *argv, "--device", "cpu"], cwd=REPO,
                          env=ONE_THREAD, capture_output=True, text=True, timeout=timeout)
    line = None
    if proc.stdout.strip():
        line = json.loads(proc.stdout.strip().splitlines()[-1])
    return proc.returncode, line, proc.stderr[-3000:]


def check_line(line, metric, unit):
    assert PORT_KEYS <= set(line), PORT_KEYS - set(line)
    assert "error" not in line and "vs_baseline" not in line
    assert line["metric"] == metric and line["unit"] == unit and line["value"] > 0
    assert line["device"] == "cpu" and line["power_limit_w"] is None
    assert line["rig_canary_tflops"] is None and line["launches"] == {}


def module(name):
    return ["-m", f"rau_vqa_tpu_torch.scripts.{name}"]


def test_bench_train_root_wrapper():
    rc, line, err = run(["bench_torch_train.py", "--batch", "8", "--steps", "1", "--rounds",
                         "1", "--variants", "plain"])
    assert rc == 0, err
    check_line(line, "train_ms_per_step", "ms")
    for k in ("results", "questions_per_sec", "spread", "mfu", "flops_per_step",
              "launches_by_variant", "steps_by_variant"):
        assert set(line[k]) == {"plain_b8"}, k
    assert line["value"] == line["results"]["plain_b8"]
    assert line["questions_per_sec"]["plain_b8"] == pytest.approx(
        8 / line["value"] * 1e3, rel=1e-3)
    assert line["mfu"]["plain_b8"] is None and line["flops_per_step"]["plain_b8"] > 0
    assert line["steps_by_variant"]["plain_b8"] == 2 and line["compute_dtype"] == "bfloat16"


def test_bench_train_pixels_variant():
    """A frozen VGG16 featurizes inline at 64 px, 3 questions an image."""
    rc, line, err = run(module("bench_train") + [
        "--batch", "6", "--qpi", "3", "--steps", "1", "--rounds", "1", "--variants",
        "pixels", "--pixels-size", "64", "--preset", "ours_ms"])
    assert rc == 0, err
    check_line(line, "train_ms_per_step", "ms")
    assert set(line["results"]) == {"pixels_b6"}
    assert "from-pixels training" in err


def test_bench_precompute_line():
    rc, line, err = run(module("bench_precompute") + [
        "--backbone", "vgg16", "--n", "6", "--size", "64", "--batch", "2"])
    assert rc == 0, err
    check_line(line, "precompute_images_per_sec", "images/sec")
    assert (line["backbone"], line["size"], line["batch"], line["storage_dtype"],
            line["n_images"]) == ("vgg16", 64, 2, "float32", 6)
    assert line["sweep_sec"] > 0 and line["decoder"]


def test_probe_serving_batch_line():
    rc, line, err = run(module("probe_serving_batch") + [
        "--batches", "4,8", "--rounds", "1", "--chain", "2", "--canary", "128,2,1"])
    assert rc == 0, err
    check_line(line, "serving_batch_sweep", "questions/sec")
    assert [s["batch"] for s in line["sweep"]] == [4, 8]
    assert all(s["qps"] > 0 and s["flops_per_step"] > 0 for s in line["sweep"])
    assert line["value"] == max(s["qps"] for s in line["sweep"])


def test_bench_serve_line():
    rc, line, err = run(module("bench_serve") + [
        "--tiny", "--clients", "4", "--requests", "2", "--unloaded", "4", "--max-batch", "4"])
    assert rc == 0, err
    check_line(line, "serve_questions_per_sec", "questions/sec")
    for k in ("latency_p50_ms", "latency_p99_ms", "loaded_p50_ms", "loaded_p99_ms",
              "mean_microbatch", "dispatch_b1_ms", "dispatch_bmax_ms", "service_answer_ms"):
        assert line[k] > 0, k
    assert line["errors"] == 0 and line["clients"] == 4
    assert 1 <= line["mean_microbatch"] <= 4


def test_profile_vit_line():
    rc, line, err = run(module("profile_vit") + ["--batch", "2", "--chain", "1", "--rounds",
                                                 "1"])
    assert rc == 0, err
    check_line(line, "vit_profile_ms", "ms")
    assert set(line["components_ms"]) == {"vit_full", "patch", "blocks", "mhsa", "mlp", "head"}
    assert all(v > 0 for v in line["components_ms"].values())
    assert line["value"] == line["components_ms"]["vit_full"]
    assert set(line["spread"]) == set(line["components_ms"])


def test_scripts_refuse_a_missing_card():
    """Without ``--device cpu`` a script asks for the card: here there is
    none, and it ends with the error line and exit code 3, never on the
    CPU."""
    proc = subprocess.run([sys.executable, *module("probe_serving_batch"), "--batches", "4"],
                          cwd=REPO, env=ONE_THREAD, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 3, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["metric"] == "serving_batch_sweep" and line["value"] == 0.0
    assert "preflight" in line["error"]


@pytest.mark.parametrize("fused", [False, True], ids=["preset", "fused_train"])
def test_paper_dims_run_train_takes_fused_train(tmp_path, monkeypatch, capsys, fused):
    """``train --fused-train`` sets the Trainer's ``fused_train`` (each step
    then runs the hop loop through the training kernels' wrappers, their
    plain versions here) and the line says so; without it the preset's
    unfused hops run.  Tiny data at the full widths: 16 questions, B=8."""
    from rau_vqa_tpu_torch.models import rau as trau
    from rau_vqa_tpu_torch.scripts import paper_dims_run
    from rau_vqa_tpu_torch.train.trainer import Trainer

    root = str(tmp_path / "pd")
    assert paper_dims_run.main(["generate", "--root", root, "--n-train", "16", "--n-test", "8",
                                "--n-images", "4", "--class-code", "dense"]) == 0
    configs, hop_loops = [], []
    init = Trainer.__init__
    monkeypatch.setattr(Trainer, "__init__", lambda self, exp, *a, **kw: (
        configs.append(exp.model), init(self, exp, *a, **kw))[1])
    fused_loop = trau.rau_train_hops
    monkeypatch.setattr(trau, "rau_train_hops", lambda *a, **kw: (
        hop_loops.append(1), fused_loop(*a, **kw))[1])
    rc = paper_dims_run.main(["train", "--root", root, "--epochs", "1", "--batch-size", "8",
                              "--lr", "4e-3", "--lr-decay", "1.0", "--train-acc", "0",
                              "--test-acc", "0", "--device", "cpu"]
                             + (["--fused-train"] if fused else []))
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line["criterion"]["met"], line
    assert [m.fused_train for m in configs] == [fused]
    assert configs[0].compute_dtype == "bfloat16" and line["compute_dtype"] == "bfloat16"
    assert line["fused_train"] is fused and line["launches"] == {}
    assert len(hop_loops) == (2 if fused else 0)      # one a step
    assert line["aborted_epochs"] == 0 and [h["epoch"] for h in line["history"]] == [1]
    assert set(line["history"][0]) == {"epoch", "train_acc", "test_acc", "loss",
                                       "examples_per_sec", "steps", "sec", "aborted"}
    assert line["history"][0]["steps"] == 2


@pytest.mark.slow
def test_paper_dims_run_subcommands(tmp_path):
    root = str(tmp_path / "pd")
    proc = subprocess.run([sys.executable, *module("paper_dims_run"), "generate", "--root",
                           root, "--n-train", "128", "--n-test", "64", "--n-images", "8"],
                          cwd=REPO, env=ONE_THREAD, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert os.path.exists(os.path.join(root, "shard_int8", "features.npy"))
    assert not os.path.exists(os.path.join(root, "feat"))
    # the criterion is out of reach in one epoch: exit code 1, as the JAX
    # script's; met with a criterion of 0
    rc, line, err = run(module("paper_dims_run") + [
        "train", "--root", root, "--epochs", "1", "--batch-size", "64"])
    assert rc == 1, err
    assert line["metric"] == "paper_dims_best_testOEacc" and not line["criterion"]["met"]
    assert line["dims"] == {"vocab": 12605, "answers": 200, "rnn": 512, "hops": 8,
                            "feat": [196, 512]}
    rc, line, err = run(module("paper_dims_run") + [
        "train", "--root", root, "--epochs", "1", "--batch-size", "64", "--train-acc", "0",
        "--test-acc", "0", "--workdir", str(tmp_path / "run2")])
    assert rc == 0 and line["criterion"]["met"], err
    assert os.path.exists(os.path.join(root, "results", "learnability.json"))
    rc, line, err = run(module("paper_dims_run") + [
        "timebox", "--root", root, "--epochs", "1", "--batch-size", "64", "--minutes", "5",
        "--host-pass-examples", "128", "--workdir", str(tmp_path / "run3")])
    assert rc == 0, err
    assert line["metric"] == "host_pipeline_examples_per_sec" and line["value"] > 0
    assert line["host_only_examples_per_sec"] > 0 and len(line["epochs"]) == 1


@pytest.mark.slow
def test_ft_accuracy_ab_line(tmp_path):
    rc, line, err = run(module("ft_accuracy_ab") + [
        "--root", str(tmp_path / "ab"), "--epochs", "1", "--n-train", "32", "--n-test", "16"])
    assert rc == 0, err
    assert line["metric"] == "ft_ab_gap" and line["value"] is not None
    assert set(line["arms"]) == {"frozen", "finetune"}
    assert line["arms"]["finetune"]["history"][0]["grad_norm_backbone"] > 0
    assert line["arms"]["frozen"]["history"][0]["grad_norm_backbone"] == 0
    assert line["arms"]["frozen"]["backbone_max_change"] == 0
    assert line["arms"]["finetune"]["backbone_max_change"] > 0
    assert os.path.exists(tmp_path / "ab" / "result.json")


REPRO = os.path.join(REPO, "rau_vqa_tpu_torch", "scripts", "repro_table1.sh")


def test_repro_table1_syntax():
    subprocess.run(["bash", "-n", REPRO], check=True, timeout=60)


def recorded_commands(tmp_path, target, env=None):
    """The port's CLI commands repro_table1.sh runs for ``target``, from a copy
    of it in a tree whose raw data directories exist (so nothing is fetched)
    and whose ``python`` records its arguments."""
    tree = tmp_path / "tree"
    (tree / "rau_vqa_tpu_torch" / "scripts").mkdir(parents=True)
    shutil.copy(REPRO, tree / "rau_vqa_tpu_torch" / "scripts")
    for d in ("VQA_prepro", "vqa_VGG16Conv_pool5_448", "vqa_resnet_101_convfeat_448"):
        (tree / "data" / d).mkdir(parents=True, exist_ok=True)
    bindir = tmp_path / "bin"
    bindir.mkdir(exist_ok=True)
    log = tmp_path / "commands.tsv"
    shim = bindir / "python"
    shim.write_text('#!/bin/sh\nfor a in "$@"; do printf \'%s\\t\' "$a"; done >> "$LOG"\n'
                    'echo >> "$LOG"\n')
    shim.chmod(shim.stat().st_mode | stat.S_IEXEC)
    env = {**os.environ, **(env or {}), "LOG": str(log),
           "PATH": f"{bindir}:{os.environ['PATH']}"}
    subprocess.run(["bash", str(tree / "rau_vqa_tpu_torch" / "scripts" / "repro_table1.sh"),
                    target], check=True, env=env, timeout=60, capture_output=True)
    return [ln.rstrip("\t").split("\t") for ln in log.read_text().splitlines()]


def parse_with_port_cli(monkeypatch, commands):
    """Each command through the port's CLI parser, its handler replaced by a
    recorder: (command, parsed args) pairs."""
    seen = []
    for name in ("cmd_train", "cmd_pack_features"):
        monkeypatch.setattr(tcli, name, lambda args, n=name: seen.append((n, args)) or 0)
    for argv in commands:
        assert argv[:2] == ["-m", "rau_vqa_tpu_torch.cli"], argv
        assert tcli.main(argv[2:]) == 0
    return seen


def test_repro_table1_commands_parse(tmp_path, monkeypatch):
    seen = parse_with_port_cli(monkeypatch, recorded_commands(tmp_path, "all"))
    trains = [a for n, a in seen if n == "cmd_train"]
    assert [a.preset for a in trains] == ["ours_ss", "ours_ms", "ours_full", "ours_resnet"]
    for a in trains:
        assert a.bf16 and a.epochs == 40 and a.split == "test-dev2015"
        assert a.device == "cuda" and a.train_buckets == "8,16" and a.eval_buckets == "8,16"
    assert trains[-1].feat_dir == ["data/packed_resnet448"]
    packs = [a for n, a in seen if n == "cmd_pack_features"]
    assert {a.out for a in packs} == {"data/packed_vgg448", "data/packed_resnet448"}
    assert {a.cnnout_dim for a in packs} == {512, 2048}


def test_repro_table1_val_split_scores_officially(tmp_path, monkeypatch):
    anno = tmp_path / "tree" / "data" / "vqa_official" / "mscoco_val2014_annotations.json"
    anno.parent.mkdir(parents=True)
    anno.write_text("{}")
    cmds = recorded_commands(tmp_path, "ms", env={"SPLIT": "val2014", "EPOCHS": "2",
                                                  "DEVICE": "cpu"})
    seen = parse_with_port_cli(monkeypatch, cmds)
    (train,) = [a for n, a in seen if n == "cmd_train"]
    assert train.split == "val2014" and train.epochs == 2 and train.device == "cpu"
    assert train.official_anno == "data/vqa_official/mscoco_val2014_annotations.json"
    assert train.vqa_dir == "data/VQA_prepro/data_train_val"
