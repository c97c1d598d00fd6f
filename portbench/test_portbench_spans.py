"""The readers of the program's spans, on synthetic Chrome traces with known
ranges and device intervals read by ``tracing.read_trace``: each gives the
known idle milliseconds, reads nothing from a program without the spans or
from a trace without device work, and the spans leave every other reader's
value as it is."""

from __future__ import annotations

import dataclasses
import json
import os

import pytest

import harness
import tracing

NEW = ("serve.entry_idle_ms", "train.autograd_idle_ms", "train.optimizer_idle_ms")
# the readers the benchmark had before the program's spans, which must read
# the same with and without them
OLD = ("fused_resnet_roofline", "lstm_encoder_roofline", "pixels.device_idle_share",
       "pixels.library_ms", "pixels.mfu", "rau_hops_roofline", "serve.device_idle_share",
       "serve.library_ms", "serve.mfu", "train.device_idle_share", "train.kernels_per_step",
       "train.mfu")
WORK = {"step_flops": 4e9, "hops_bound_s": 1e-5, "lstm_bound_s": 2e-5, "stage_bound_s": 3e-5}


def _trace(tmp_path, ranges, device, steps):
    """A Chrome trace over a 1000 us window: ``ranges`` (name, start, end)
    as host ranges, ``device`` (category, name, start, end); read as the
    harness reads it."""
    events = [{"ph": "X", "cat": "user_annotation", "name": tracing.WINDOW, "ts": 0, "dur": 1000}]
    events += [{"ph": "X", "cat": "user_annotation", "name": n, "ts": a, "dur": b - a}
               for n, a, b in ranges]
    events += [{"ph": "X", "cat": c, "name": n, "ts": a, "dur": b - a} for c, n, a, b in device]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return tracing.read_trace(str(path), steps, dict(WORK))


def serve_view(tmp_path, spans=True):
    """Two serving steps; idle gaps of 60, 10, 180, 90 and 50 us, of which
    60 + 10 + 180 lie inside ``predict.step`` (by the innermost range at
    their middles: ``predict.place``, ``predict.step``, ``predict.place``),
    90 and 50 outside every range."""
    ranges = [("serve.entry", 100, 400), ("serve.entry", 500, 800),
              ("pixels.fetch_answers", 850, 900)]
    if spans:
        ranges += [("predict.step", 110, 398), ("predict.place", 110, 200),
                   ("predict.encoder", 200, 260), ("predict.hops", 260, 390),
                   ("predict.step", 505, 790), ("predict.place", 505, 620),
                   ("predict.encoder", 620, 700), ("predict.hops", 700, 780)]
    device = [("kernel", "sgemm_128x64", 0, 120), ("kernel", "lstm_encode_kernel", 180, 260),
              ("kernel", "rows_eval_kernel", 260, 390), ("gpu_memcpy", "Memcpy HtoD", 400, 420),
              ("kernel", "lstm_encode_kernel", 600, 700), ("kernel", "rows_eval_kernel", 700, 780),
              ("kernel", "sgemm_128x64", 870, 950)]
    return _trace(tmp_path, ranges, device, steps=2)


def pixels_view(tmp_path, spans=True):
    """One request: the images' copy, the backbone's and the head's kernels."""
    ranges = [("pixels.entry", 100, 700), ("pixels.fetch_answers", 700, 760)]
    if spans:
        ranges += [("pipeline.answer_pixels", 105, 690), ("pipeline.place", 105, 200),
                   ("pipeline.backbone", 200, 500), ("predict.hops", 500, 680)]
    device = [("gpu_memcpy", "Memcpy HtoD", 120, 190), ("kernel", "identity_block_tma", 210, 600),
              ("kernel", "rows_eval_kernel", 620, 720)]
    return _trace(tmp_path, ranges, device, steps=1)


def train_view(tmp_path, spans=True):
    """One training step over [0, 900]: idle gaps of 15 us in place, 60 in
    the forward, 40 in the backward, 10-20 in each group's noise, clip and
    Adam, 50 after the step."""
    ranges = [("train.entry", 0, 905)]
    if spans:
        ranges += [("trainer.step", 0, 900), ("trainer.place", 0, 50),
                   ("trainer.forward", 50, 300), ("trainer.backward", 300, 600)]
        for g0 in (600, 700, 800):
            ranges += [("trainer.noise", g0, g0 + 30), ("trainer.clip", g0 + 30, g0 + 60),
                       ("trainer.adam", g0 + 60, g0 + 100)]
    busy = [(0, 30), (45, 100), (160, 400), (440, 605), (625, 640), (650, 670), (690, 710),
            (720, 740), (750, 770), (790, 810), (820, 840), (850, 870), (890, 950)]
    device = [("kernel", f"elementwise_{i}", a, b) for i, (a, b) in enumerate(busy)]
    return _trace(tmp_path, ranges, device, steps=1)


VIEWS = (serve_view, pixels_view, train_view)


def _read(name, view):
    return harness.load_module("metrics", name).read(view)


@pytest.mark.parametrize("name,view,want", [
    ("serve.entry_idle_ms", serve_view, 1e3 * 250e-6 / 2),
    ("train.autograd_idle_ms", train_view, 1e3 * (60 + 40) * 1e-6),
    ("train.optimizer_idle_ms", train_view, 1e3 * (40 + 30 + 60) * 1e-6),
])
def test_readers_give_the_known_idle(tmp_path, name, view, want):
    assert _read(name, view(tmp_path)) == pytest.approx(want)


def test_the_idle_gaps_are_labelled_by_the_innermost_span(tmp_path):
    """Each gap goes whole to the innermost range at its middle: the train
    step's gaps by phase, the idle outside the step to the harness's range
    or to none."""
    v = train_view(tmp_path)
    want = {"trainer.place": 15, "trainer.forward": 60, "trainer.backward": 40,
            "trainer.noise": 20 + 10 + 10, "trainer.clip": 10 + 10 + 10,
            "trainer.adam": 20 + 20 + 20, "host.outside_harness_calls": 50}
    assert v.gaps == {k: pytest.approx(us * 1e-6) for k, us in want.items()}
    s = serve_view(tmp_path)
    assert s.gaps == {"predict.place": pytest.approx(240e-6), "predict.step": pytest.approx(10e-6),
                      "host.outside_harness_calls": pytest.approx(140e-6)}


@pytest.mark.parametrize("name", NEW)
def test_readers_read_nothing_without_the_programs_spans_or_a_device(tmp_path, name):
    """The parent's program has no spans: its traced run leaves the metric
    out; so does a trace with no device work (a CPU run)."""
    for view in VIEWS:
        assert _read(name, view(tmp_path, spans=False)) is None
        assert _read(name, dataclasses.replace(view(tmp_path), busy_s=0.0)) is None


@pytest.mark.parametrize("view", VIEWS)
@pytest.mark.parametrize("name", OLD)
def test_the_spans_leave_every_other_reader_as_it_was(tmp_path, name, view):
    assert _read(name, view(tmp_path)) == _read(name, view(tmp_path, spans=False))


def test_old_readers_are_all_there():
    here = os.listdir(os.path.join(harness.BENCH, "metrics"))
    assert all(f"{n}.py" in here for n in OLD + NEW) and not set(OLD) & set(NEW)
