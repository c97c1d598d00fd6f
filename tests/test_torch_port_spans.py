"""The port's spans (``utils/spans.py``) on the CPU.

With no profiler running a span never enters ``record_function``.  Under
``torch.profiler`` with CPU activity the three entry points, the serving
step, ``answer_pixels`` on a narrow folded ResNet and a train step, give the
spans by their names, nested as the benchmark's readers expect, read from
the Chrome trace as the benchmark reads it.  Their outputs are bit for bit
the same with the profiler on and off, and an exported predict program
holds no profiler op.  ``read_spans`` gives a synthetic trace's known
readings.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rau_vqa_tpu_torch.config import ModelConfig, TrainConfig
from rau_vqa_tpu_torch.eval.export import export_predict
from rau_vqa_tpu_torch.eval.predict import make_predict_step
from rau_vqa_tpu_torch.models.pipeline import answer_pixels
from rau_vqa_tpu_torch.models.rau import init_params
from rau_vqa_tpu_torch.train.optim import adam_init
from rau_vqa_tpu_torch.train.trainer import PARAM_GROUPS, TrainState, make_train_step
from rau_vqa_tpu_torch.utils import spans

CFG = ModelConfig(vocab_size=50, answer_size=16, seq_len=9, embed_dim=8, rnn_size=16,
                  rnn_layers=2, cnn_dim=256, cnn_w=2, cnn_h=2, multfeat_dim=16,
                  attfeat_dim=8, att_rnn_size=16, n_hops=3)
B = 3
HEAD = ("predict.encoder", "predict.embed_image", "predict.hops", "predict.aggregate")


def _folded_resnet(gen, widths=(8, 16, 32, 64), stem=16):
    """A folded (conv + bias) ResNet tree, two blocks a stage, 64 px -> a
    2x2 grid of 256 features."""
    def conv(kh, kw, ci, co):
        w = torch.randn((kh, kw, ci, co), generator=gen) * (2.0 / (kh * kw * ci)) ** 0.5
        return {"w": w, "b": 0.02 * torch.randn((co,), generator=gen)}

    tree = {"conv1": conv(7, 7, 3, stem), "stages": []}
    c_in = stem
    for width in widths:
        stage = []
        for b in range(2):
            blk = {"conv1": conv(1, 1, c_in, width), "conv2": conv(3, 3, width, width),
                   "conv3": conv(1, 1, width, 4 * width)}
            if b == 0:
                blk["down"] = conv(1, 1, c_in, 4 * width)
            stage.append(blk)
            c_in = 4 * width
        tree["stages"].append(stage)
    return tree


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    lengths = rs.randint(1, CFG.seq_len + 1, B).astype(np.int32)
    tokens = np.zeros((B, CFG.seq_len), np.int32)
    for k in range(B):
        tokens[k, :lengths[k]] = rs.randint(1, CFG.vocab_size, lengths[k])
    return tokens, lengths, rs


def _params(seed=0):
    return init_params(CFG, torch.Generator().manual_seed(seed), "cpu")


def run_predict():
    tokens, lengths, rs = _batch(1)
    feats = rs.randn(B, CFG.cnn_spat, CFG.cnn_dim).astype(np.float32)
    step = make_predict_step(CFG, buckets=(4,), device="cpu")
    return step(_params(1), tokens, lengths, feats)


def run_pixels():
    tokens, lengths, rs = _batch(2)
    images = rs.randint(0, 256, (B, 64, 64, 3)).astype(np.uint8)
    bb = _folded_resnet(torch.Generator().manual_seed(2))
    return answer_pixels(_params(2), bb, CFG, "resnet101", images, tokens, lengths,
                         device="cpu")


def run_train():
    tokens, lengths, rs = _batch(3)
    feats = rs.randn(B, CFG.cnn_spat, CFG.cnn_dim).astype(np.float32)
    labels = rs.randint(0, CFG.answer_size, B).astype(np.int32)
    params = _params(3)
    state = TrainState(params, {g: adam_init(params[g]) for g in params}, step=0, seed=3)
    tcfg = TrainConfig()
    step = make_train_step(CFG, tcfg, device="cpu")
    new, metrics = step(state, tokens, lengths, feats, labels, np.ones(CFG.n_hops, np.float32),
                        tcfg.learning_rate, tcfg.mult_learning_rate)
    return [new.params, new.opt, metrics]


# each entry point's spans and the span each is nested in
PARENTS = {
    "predict": {"predict.step": None, "predict.place": "predict.step",
                "predict.weights": "predict.step", **{h: "predict.step" for h in HEAD}},
    "pixels": {"pipeline.answer_pixels": None, "pipeline.place": "pipeline.answer_pixels",
               "pipeline.backbone": "pipeline.answer_pixels",
               **{h: "pipeline.answer_pixels" for h in HEAD}},
    "train": {"trainer.step": None, "trainer.place": "trainer.step",
              "trainer.forward": "trainer.step", "trainer.backward": "trainer.step",
              "trainer.noise": "trainer.step", "trainer.clip": "trainer.step",
              "trainer.adam": "trainer.step"},
}
RUN = {"predict": run_predict, "pixels": run_pixels, "train": run_train}


def _ranges(fn, tmp_path):
    """``fn()`` under the profiler: its result and the trace's ranges,
    (start, end, name) in start order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                    for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation")
    return out, ranges


def _parent(r, ranges):
    """The innermost other range that holds ``r``."""
    around = [(b - a, name) for a, b, name in ranges
              if (a, b, name) != r and a <= r[0] and r[1] <= b]
    return min(around)[1] if around else None


def _flat(out):
    if torch.is_tensor(out):
        return [out]
    if isinstance(out, dict):
        return [t for k in sorted(out) for t in _flat(out[k])]
    return [t for x in out for t in _flat(x)]


def test_span_with_the_profiler_off_is_a_shared_null_context(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not spans.profiling()
    assert spans.span("a") is spans.span("b")
    with spans.span("a") as inner:
        assert inner is None


@pytest.mark.parametrize("entry", sorted(RUN))
def test_entry_points_enter_no_record_function_with_the_profiler_off(monkeypatch, entry):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    RUN[entry]()


def test_span_records_under_the_profiler(tmp_path):
    def fn():
        assert spans.profiling()
        with spans.span("outer"):
            with spans.span("inner"):
                pass

    _, ranges = _ranges(fn, tmp_path)
    assert [r[2] for r in ranges] == ["outer", "inner"]
    assert _parent(ranges[1], ranges) == "outer"
    assert not spans.profiling()


@pytest.mark.parametrize("entry", sorted(RUN))
def test_entry_points_give_their_spans_nested_as_listed(tmp_path, entry):
    _, ranges = _ranges(RUN[entry], tmp_path)
    parents = PARENTS[entry]
    assert {name for _, _, name in ranges} == set(parents)
    for r in ranges:
        assert _parent(r, ranges) == parents[r[2]], r[2]
    names = [name for _, _, name in ranges]
    top = [n for n, p in parents.items() if p is None]
    assert names.count(top[0]) == 1
    if entry == "train":
        triples = [n for n in names if n in ("trainer.noise", "trainer.clip", "trainer.adam")]
        assert triples == ["trainer.noise", "trainer.clip", "trainer.adam"] * len(PARAM_GROUPS)
        assert names.count("trainer.forward") == names.count("trainer.backward") == 1
    if entry == "pixels":
        assert names.count("pipeline.backbone") == names.count("pipeline.place") == 1


@pytest.mark.parametrize("entry", sorted(RUN))
def test_outputs_are_bit_identical_with_the_profiler_on_and_off(tmp_path, entry):
    off = _flat(RUN[entry]())
    on, _ = _ranges(RUN[entry], tmp_path)
    on = _flat(on)
    assert len(on) == len(off) > 0
    for a, b in zip(on, off):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_exported_predict_program_holds_no_profiler_op(tmp_path):
    paths = export_predict(_params(4), CFG, str(tmp_path), device="cpu")
    for path in paths.values():
        ep = torch.export.load(path)
        targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
        assert targets and not [t for t in targets if "profiler" in t], targets
        assert "rau_vqa.rau_hops" in " ".join(targets)



def test_read_spans_gives_the_known_time_idle_and_blocking_calls(tmp_path):
    """``s.step`` over [0, 100] us with itself nested over [40, 70];
    ``s.place`` over [0, 20] and [200, 210]; device work over [10, 30] and
    [50, 90]; blocking calls at 5, 60 and 205, one more at 120 outside every
    span, and a launch (not blocking) at 15."""
    ranges = [("s.step", 0, 100), ("s.place", 0, 20), ("s.step", 40, 70), ("s.place", 200, 210)]
    events = [{"cat": "user_annotation", "name": n, "ts": a, "dur": b - a} for n, a, b in ranges]
    events += [{"cat": c, "name": n, "ts": a, "dur": d} for c, n, a, d in (
        ("kernel", "k", 10, 20), ("gpu_memcpy", "Memcpy HtoD", 50, 40),
        ("cuda_runtime", "cudaStreamSynchronize", 5, 3),
        ("cuda_runtime", "cudaStreamSynchronize", 60, 3),
        ("cuda_driver", "cuCtxSynchronize", 205, 1),
        ("cuda_runtime", "cudaDeviceSynchronize", 120, 3),
        ("cuda_runtime", "cudaLaunchKernel", 15, 3))]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": [{"ph": "X", **e} for e in events]}))
    got = spans.read_spans(str(path))
    assert got == {
        "s.step": {"calls": 2, "host_ms": pytest.approx(0.1), "idle_ms": pytest.approx(0.04),
                   "blocking": 2},
        "s.place": {"calls": 2, "host_ms": pytest.approx(0.03), "idle_ms": pytest.approx(0.02),
                    "blocking": 2}}


def test_read_spans_of_a_cpu_train_step(tmp_path):
    _ranges(run_train, tmp_path)
    got = spans.read_spans(str(tmp_path / "trace.json"))
    assert set(got) == set(PARENTS["train"])
    assert all(r["idle_ms"] is None and r["blocking"] == 0 for r in got.values())
    assert got["trainer.step"]["calls"] == 1
    assert got["trainer.adam"]["calls"] == len(PARAM_GROUPS)
    assert got["trainer.step"]["host_ms"] >= got["trainer.backward"]["host_ms"] > 0

