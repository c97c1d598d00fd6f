"""The port's Trainer, checkpoints, precompute_features and CLI on a device
mesh of 2 gloo ranks on the CPU (tests/torch_mesh_worker.py), against one
process: tests/test_multihost.py:221-283 and :554-, tests/test_parallel.py:
255-313, tests/test_precompute.py:152-175 and tests/test_cli.py:85-100 for
the port.  One module-scoped launch serves each group of assertions, each a
test case of its own; every launch has its own timeout."""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import torch_mesh_worker as W  # noqa: E402
from rau_vqa_tpu_torch.convert import params_from_jax, tree_leaves  # noqa: E402


def _load(tmp, n=2):
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(n)]


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    """One process: 2 epochs and the sweep, the odd-batch sweep, and a
    checkpoint after 1 epoch for the mesh to restore."""
    tmp = str(tmp_path_factory.mktemp("single"))
    root = os.path.join(tmp, "fixture")
    tr = W.fixture_trainer(root, os.path.join(tmp, "run"))
    for _ in range(2):
        tr.train_epoch()
    res = tr.evaluate(write_submissions=False)
    odd = W.fixture_trainer(root, os.path.join(tmp, "odd"), test_batch_size=5)
    r5 = odd.evaluate(write_submissions=False)
    one = W.fixture_trainer(root, os.path.join(tmp, "one"))
    one.train_epoch()
    acc = W.fixture_trainer(root, os.path.join(tmp, "accum"), grad_accum=4)
    acc.train_epoch()
    return {"trainer": tr, "res": res, "odd": r5, "dir": tmp, "one": one, "accum": acc,
            "one_path": one.save(), "figs": sorted(os.listdir(os.path.join(tmp, "run",
                                                                          "figures")))}


@pytest.fixture(scope="module")
def meshed(single, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("meshed"))
    torch.save({"dir": tmp, "single_ckpt": single["one_path"]},
               os.path.join(tmp, "inputs.pt"))
    W.launch("trainer", tmp, 2, timeout=300)
    return _load(tmp), tmp


@pytest.mark.multiproc
def test_trainer_two_ranks_match_one_process(single, meshed):
    """2 epochs: the step count, the head bias, the sweep's OE accuracy."""
    ranks, _ = meshed
    tr = single["trainer"]
    for r in ranks:
        assert r["step"] == tr.state.step > 0
        np.testing.assert_allclose(r["cls_b"], tr.state.params["mult"]["cls"]["b"][:4],
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(r["testOEacc"], single["res"]["testOEacc"],
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.multiproc
def test_one_writer_and_the_same_attention_pngs(single, meshed):
    """Rank 0 alone writes: the sweep's PNGs are the single process's set,
    and the run's log holds each epoch once."""
    _, tmp = meshed
    figs = sorted(os.listdir(os.path.join(tmp, "run", "figures")))
    assert figs == single["figs"] and figs
    with open(os.path.join(tmp, "run", "training_log", "metrics.jsonl")) as f:
        kinds = [json.loads(line)["kind"] for line in f]
    assert kinds.count("train") == 2 and kinds.count("test") == 1


@pytest.mark.multiproc
def test_mesh_eval_pads_odd_batches(single, meshed):
    """Test batches of 5 over a data axis of 2 are padded and sliced: the
    same OE and MC accuracy as one process (tests/test_parallel.py:255-313)."""
    for r in meshed[0]:
        np.testing.assert_allclose(r["odd"]["testOEacc"], single["odd"]["testOEacc"],
                                   atol=1e-6)
        np.testing.assert_allclose(r["odd"]["testMCacc"], single["odd"]["testMCacc"],
                                   atol=1e-6)


@pytest.mark.multiproc
def test_trainer_grad_accum_on_two_ranks_matches_one_process(single, meshed):
    """grad_accum 4 over a data axis of 2 (batch 16: each rank 2 rows of
    each global microbatch of 4): the step count and the head bias of one
    process's epoch."""
    acc = single["accum"]
    for r in meshed[0]:
        assert r["accum_step"] == acc.state.step > 0
        np.testing.assert_allclose(r["accum_cls_b"], acc.state.params["mult"]["cls"]["b"][:4],
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.multiproc
def test_trainer_refuses_rank_rows_that_grad_accum_does_not_split(meshed):
    """Batch 20 with grad_accum 4 divides, and so does 20 over 2 ranks, but
    a rank's 10 rows do not split into 4 microbatches: every rank raises
    rather than drop rows."""
    for r in meshed[0]:
        assert "a rank's 10 rows must divide by grad_accum 4" in r["accum_error"]


def _trees_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


@pytest.mark.multiproc
def test_tp_checkpoint_of_two_ranks_loads_in_one_process(single, meshed):
    """A (1, 2) TP run holds the LSTM gate projections as (in, 4R / 2) on
    each rank (and cls.w whole: the fixture's 5 answers do not divide by
    2); its snapshot, written by rank 0 alone, holds whole leaves that one
    process loads."""
    ranks, tmp = meshed
    assert ranks[0]["tp_path"] and ranks[1]["tp_path"] == ""
    cfg = single["trainer"].mcfg
    assert cfg.answer_size == 5
    assert ranks[0]["tp_cls_w_local"] == (cfg.multfeat_dim, cfg.answer_size)
    assert ranks[0]["tp_wi_local"] == (cfg.embed_dim, 4 * cfg.rnn_size // 2)
    one = W.fixture_trainer(os.path.join(single["dir"], "fixture"),
                            os.path.join(single["dir"], "load"))
    one.restore(ranks[0]["tp_path"])
    assert one.epoch == 1 and one.state.step == ranks[0]["tp_state"].step
    assert _trees_equal(one.state.params, ranks[0]["tp_state"].params)
    assert _trees_equal(one.state.opt, ranks[0]["tp_state"].opt)


@pytest.mark.multiproc
def test_one_process_checkpoint_restores_on_a_tp_mesh(single, meshed):
    """The reverse: one process's snapshot, restored on the (1, 2) mesh, is
    cut to each rank's slice again and gathers back to the same state."""
    for r in meshed[0]:
        assert r["restored_cls_w_local"] == r["tp_cls_w_local"]
        assert r["restored"].step == single["one"].state.step
        assert _trees_equal(r["restored"].params, single["one"].state.params)
        assert _trees_equal(r["restored"].opt, single["one"].state.opt)


# ---------------------------------------------------------------------------
# precompute_features
# ---------------------------------------------------------------------------

@pytest.mark.multiproc
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_precompute_on_two_ranks_writes_the_single_process_shard(dtype, tmp_path):
    """Each rank featurizes its rows of each padded batch; rank 0 writes the
    shard one process writes, byte for byte (tests/test_precompute.py:
    152-175); 5 images in batches of 4, the last one padded."""
    from rau_vqa_tpu_torch.precompute import precompute_features
    from tests.test_precompute import _make_images
    from tests.test_torch_port_vgg_vit import jax_vgg
    rel = _make_images(str(tmp_path / "imgs"), n=5)
    bb = params_from_jax(jax_vgg(0))
    precompute_features(str(tmp_path / "imgs"), rel, str(tmp_path / "one"), "vgg16", bb,
                        size=32, batch_size=4, backend="pil", dtype=dtype, device="cpu")
    torch.save({"image_root": str(tmp_path / "imgs"), "rel": rel, "bb": bb,
                "out": str(tmp_path / "two"), "dtype": dtype},
               str(tmp_path / "inputs.pt"))
    W.launch("precompute", str(tmp_path), 2, timeout=180)
    assert [r["n"] for r in _load(str(tmp_path))] == [5, 5]
    names = sorted(os.listdir(tmp_path / "one"))
    assert sorted(os.listdir(tmp_path / "two")) == names
    for n in names:
        assert (tmp_path / "two" / n).read_bytes() == (tmp_path / "one" / n).read_bytes(), n


# ---------------------------------------------------------------------------
# the CLI under torch.distributed.run
# ---------------------------------------------------------------------------

@pytest.mark.multiproc
def test_train_on_a_tp_mesh_from_the_cli(tmp_path):
    """``train --mesh-data 1 --mesh-model 2 --tp`` on 2 ranks of
    ``python -m torch.distributed.run``: the config records the mesh as the
    JAX CLI's does (tests/test_cli.py:85-100), rank 0 writes the results."""
    wd = str(tmp_path / "mesh_run")
    port = str(W.free_port())
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
           "--nproc-per-node", "2", "--master-addr", "127.0.0.1", "--master-port", port,
           "-m", "rau_vqa_tpu_torch.cli", "--device", "cpu", "train", "--preset",
           "ours_ms", "--fixture", "--nhop", "2", "--epochs", "2", "--save-dir", wd,
           "--mesh-data", "1", "--mesh-model", "2", "--tp"]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=W.REPO)
    p = subprocess.Popen(cmd, env=env, cwd=W.REPO, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = p.communicate(timeout=240)
    finally:
        if p.poll() is None:
            os.killpg(p.pid, 9)
            p.wait()
    assert p.returncode == 0, out[-4000:]
    assert "backend gloo" in out and "mesh: {'data': 1, 'model': 2}" in out
    with open(os.path.join(wd, "config.json")) as f:
        cfg = json.load(f)
    assert cfg["mesh"]["enabled"] is True
    assert cfg["mesh"]["data_axis"] == 1
    assert cfg["mesh"]["model_axis"] == 2
    assert cfg["mesh"]["shard_params_tp"] is True
    assert glob.glob(os.path.join(wd, "results", "hop_01", "vqa_OpenEnded_*"))
