"""With the timed path broken underneath, a whole run (the look for a card
skipped, the program's plain versions on the CPU at a tiny size) comes out
not correct: once for each fault a cell can have.  Sound runs of the same
cells come out correct."""

from __future__ import annotations

import pytest
import torch

import harness

SPEC = harness.load_json(harness.ROOT, "BENCHMARK.json")
BY_DRIVER = {}
for _w in SPEC["workloads"]:
    _cell = harness.load_json(harness.BENCH, "cells", _w["name"] + ".json")
    BY_DRIVER.setdefault(_cell["driver"], []).append(_w["name"])


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_a_sound_run_is_correct(tiny_bench, workload):
    rc, line, err = tiny_bench.run(workload, seconds=0.5)
    assert rc == 0 and line["correct"] is True, err[-2000:]


def _alter_first_row(tab_pred, tab_att):
    """Row 0's answers moved by one place, as a fault where they are made."""
    tab_pred = tab_pred.clone()
    tab_pred[:, 0] = tab_pred[:, 0].roll(1, -1)
    return tab_pred, tab_att


@pytest.mark.parametrize("workload", BY_DRIVER.get("serve", []))
def test_serve_answer_altered_where_produced(tiny_bench, monkeypatch, workload):
    import rau_vqa_tpu_torch.eval.predict as pr
    orig = pr.predict_fused
    monkeypatch.setattr(pr, "predict_fused", lambda *a, **k: _alter_first_row(*orig(*a, **k)))
    rc, line, _ = tiny_bench.run(workload, seconds=0.5)
    assert rc == 0 and line["correct"] is False


def _alter_first_map(tab_pred, tab_att):
    """Row 0's attention maps moved by one place, as a fault where they are
    made."""
    tab_att = tab_att.clone()
    tab_att[:, 0] = tab_att[:, 0].roll(1, -1)
    return tab_pred, tab_att


@pytest.mark.parametrize("workload", BY_DRIVER.get("pixels", []))
def test_pixels_attention_altered_where_produced(tiny_bench, monkeypatch, workload):
    import rau_vqa_tpu_torch.models.pipeline as pl
    orig = pl.predict_fused
    monkeypatch.setattr(pl, "predict_fused", lambda *a, **k: _alter_first_map(*orig(*a, **k)))
    rc, line, _ = tiny_bench.run(workload, seconds=0.5)
    assert rc == 0 and line["correct"] is False


@pytest.mark.parametrize("workload", BY_DRIVER.get("pixels", []))
def test_pixels_answer_altered_where_produced(tiny_bench, monkeypatch, workload):
    """The answer ids alone altered: the attention maps stay sound."""
    import rau_vqa_tpu_torch.models.pipeline as pl
    orig = pl.predict_fused
    monkeypatch.setattr(pl, "predict_fused", lambda *a, **k: _alter_first_row(*orig(*a, **k)))
    rc, line, _ = tiny_bench.run(workload, seconds=0.5)
    assert rc == 0 and line["correct"] is False
    assert line["checks"]["att_err"]["value"] <= line["checks"]["att_err"]["limit"]
    assert line["checks"]["answer_miss"]["value"] > 0


def _state_unchanged(step):
    def broken(state, *args):
        return state, step(state, *args)[1]
    return broken


def _half_batch(step):
    def broken(state, tokens, lengths, feats, labels, *rest):
        h = tokens.shape[0] // 2
        return step(state, tokens[:h], lengths[:h], feats[:h], labels[:h], *rest)
    return broken


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch],
                         ids=["state_unchanged", "half_batch"])
@pytest.mark.parametrize("workload", BY_DRIVER.get("train", []))
def test_train_faults(tiny_bench, monkeypatch, workload, fault):
    import rau_vqa_tpu_torch.train.trainer as tr
    orig = tr.make_train_step
    monkeypatch.setattr(tr, "make_train_step", lambda *a, **k: fault(orig(*a, **k)))
    rc, line, _ = tiny_bench.run(workload, seconds=0.5)
    assert rc == 0 and line["correct"] is False


def _once_warm(fault, sound_calls: int):
    """``fault`` from the step's call ``sound_calls`` on: a step that runs
    soundly through set-up and goes wrong once warmed up."""
    def wrap(step):
        broken, calls = fault(step), [0]

        def maybe(*args):
            calls[0] += 1
            return (step if calls[0] <= sound_calls else broken)(*args)
        return maybe
    return wrap


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch],
                         ids=["state_unchanged", "half_batch"])
@pytest.mark.parametrize("workload", BY_DRIVER.get("train", []))
def test_train_faults_in_the_window_alone(tiny_bench, monkeypatch, workload, fault):
    """Set-up's steps sound, the window's broken: the window's own steps
    are compared."""
    import rau_vqa_tpu_torch.train.trainer as tr
    cell = tiny_bench.load("cells", workload + ".json")
    orig = tr.make_train_step
    wrap = _once_warm(fault, cell["traffic"]["check_steps"])
    monkeypatch.setattr(tr, "make_train_step", lambda *a, **k: wrap(orig(*a, **k)))
    rc, line, _ = tiny_bench.run(workload, seconds=0.5)
    assert rc == 0 and line["correct"] is False
    for name in ("loss_gap", "grad_gap", "change_gap"):
        assert line["checks"][name]["value"] <= line["checks"][name]["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_control_fails_at_the_cells_size(cuda_device, workload):
    """The control on three seeds at the cell's own size: some number over
    its limit on each."""
    cell = harness.load_json(harness.BENCH, "cells", workload + ".json")
    config = harness.load_json(harness.BENCH, "configs", cell["config"] + ".json")
    driver = harness.load_module("drivers", cell["driver"])
    for seed in (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303):
        ctx = harness.Context(workload, seed, 0.0, False, cell, config, harness.Sizes(config),
                              cuda_device)
        numbers = driver.control(ctx)
        torch.backends.cuda.matmul.allow_tf32 = False
        assert any(v > cell["limits"][k] for k, v in numbers.items()), (seed, numbers)
        torch.cuda.empty_cache()
