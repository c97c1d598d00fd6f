"""The port's HTTP inference service (rau_vqa_tpu_torch/serve.py) against
the JAX package's (rau_vqa_tpu/serve.py), on the CPU.

Both serve one JAX ``.msgpack`` snapshot (the tiny regime of
tests/test_torch_port_trainer.py, fitted two epochs) over the same fixture
``vqa_dir`` and ``.t7`` features.  The port's ``RAUService(device="cpu")``
runs its two serving kernels' plain versions (bf16 dots).  The JAX
``RAUService(fused=True)`` runs its hop-loop kernel but the question LSTM in
XLA float32 (``predict_fused`` without ``fuse_encoder``,
rau_vqa_tpu/eval/predict.py:136-138), so the port's service is held to the
JAX service with its step set to ``predict_fused(fuse_encoder=True)``: both
Pallas kernels, in interpret mode, as tests/test_torch_port_predict.py holds
the step.  Bars: scores at rtol 1e-3 / atol 1e-4 and
attention rows at atol 1e-4 (tests/test_torch_port_predict.py's bar for the
serving kernels), per-hop answers equal; the plain float32 services at rtol
1e-4 / atol 1e-5.  Scores compare by value in rank order, and answer names
only where neighbouring scores are apart by more than the bar (a near tie
may order either way).  Every wait is bounded; servers and collector threads
stop in teardown."""

import base64
import hashlib
import io
import json
import os
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import rau_vqa_tpu.models.pipeline as jpipe
from rau_vqa_tpu.eval import predict as jpred
from rau_vqa_tpu.serve import RAUService as JaxService
from rau_vqa_tpu_torch.data.features import pack_feature_dir
from rau_vqa_tpu_torch.models import pipeline as tpipe
from rau_vqa_tpu_torch.serve import RAUService, serve
from tests.test_torch_port_trainer import (  # noqa: F401 (an autouse fixture)
    SPEC,
    jax_trainer,
    jfix,
    one_torch_thread,
)

FUSED_BAR = dict(rtol=1e-3, atol=1e-4)
PLAIN_BAR = dict(rtol=1e-4, atol=1e-5)
WAIT = 30.0       # seconds: the bound on every join, event and HTTP call


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port_serve"))
    jfix.generate_fixture(root, SPEC)
    jt = jax_trainer(root, os.path.join(root, "run"))
    jt.fit(epochs=2, eval_each=False)
    ck = jt.save()
    feat_dir = os.path.join(root, "feat")
    return {"root": root, "ck": ck, "vqa": os.path.join(root, "vqa_prepro"),
            "feat": [feat_dir], "names": sorted(os.listdir(feat_dir))}


def port_service(env, **kw):
    return RAUService(env["ck"], env["vqa"], env["feat"], device="cpu", **kw)


def jax_service(env, **kw):
    """The JAX service; with ``fused=True`` its step runs both Pallas
    kernels (the encoder's too) in interpret mode, with buckets (8, 16)."""
    svc = JaxService(env["ck"], env["vqa"], env["feat"], preset="ours_ms",
                     **kw)
    if kw.get("fused"):
        cfg = svc.mcfg
        run = jax.jit(lambda p, t, l, f: jpred.predict_fused(
            p, cfg, t, l, f, interpret=True, fuse_encoder=True))
        ladder = jpred.bucket_ladder(cfg.seq_len, (8, 16))

        def step(p, tokens, lengths, feats):
            T = jpred.pick_bucket(ladder, int(np.max(lengths)))
            return run(p, tokens[:, :T], lengths, feats)
        svc.predict = step
    return svc


@pytest.fixture(scope="module")
def services(env):
    """The port's service and the JAX one, both through the kernels."""
    svc = port_service(env)
    yield svc, jax_service(env, fused=True)
    svc.close()


@pytest.fixture(scope="module")
def http(services):
    """The port's service over HTTP on 127.0.0.1, a free port."""
    server = serve(services[0], port=0, host="127.0.0.1")
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    yield server.server_address[1]
    server.shutdown()
    server.server_close()
    t.join(WAIT)
    assert not t.is_alive()


def request(port, path, payload=None):
    """(status, JSON body) of a GET (payload None) or POST."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=WAIT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def assert_same_answer(got, want, bar):
    """Scores by value in rank order; names where the ranks are apart by
    more than the bar; per-hop answers equal; attention rows at atol 1e-4."""
    gs = np.array([a["score"] for a in got["answers"]])
    ws = np.array([a["score"] for a in want["answers"]])
    np.testing.assert_allclose(gs, ws, **bar)
    tol = 2 * (bar["atol"] + bar["rtol"] * np.abs(ws))
    for i in range(len(ws)):
        apart = all(abs(ws[i] - ws[j]) > tol[i] for j in (i - 1, i + 1)
                    if 0 <= j < len(ws))
        if apart:
            assert got["answers"][i]["answer"] == want["answers"][i]["answer"]
    assert got["per_hop"] == want["per_hop"]
    assert got["question"] == want["question"]
    assert ("attention" in got) == ("attention" in want)
    if "attention" in want:
        assert got["attention"]["grid"] == want["attention"]["grid"]
        np.testing.assert_allclose(got["attention"]["rows"],
                                   want["attention"]["rows"], rtol=0,
                                   atol=1e-4)


QUESTIONS = ["w01 w02 w03", "w05 w04", "What is w07 w08?", "w10",
             "w12 w03 w09 w11 w02", "w09 w06 zzz"]


def test_answer_matches_jax(services, env):
    svc, jsvc = services
    for i, q in enumerate(QUESTIONS):
        kw = dict(feat_name=env["names"][3 * i], topk=5, attention=i % 2 == 0)
        assert_same_answer(svc.answer(q, **kw), jsvc.answer(q, **kw), FUSED_BAR)


def test_answer_many_matches_jax(services, env):
    svc, jsvc = services
    kw = dict(feat_name=env["names"][7], topk=3, attention=True)
    got = svc.answer_many(QUESTIONS[:3], **kw)
    want = jsvc.answer_many(QUESTIONS[:3], **kw)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert_same_answer(g, w, FUSED_BAR)


def test_plain_eval_matches_jax_plain(env):
    svc = port_service(env, fused=False)
    jsvc = jax_service(env, fused=False)
    try:
        for i, q in enumerate(QUESTIONS[:4]):
            kw = dict(feat_name=env["names"][5 * i + 1], attention=True)
            assert_same_answer(svc.answer(q, **kw), jsvc.answer(q, **kw),
                               PLAIN_BAR)
    finally:
        svc.close()


def test_packed_shard_answers_as_the_t7_files(services, env, tmp_path):
    """A float32 shard of pack_feature_dir, read through the CLI's
    _make_feature_source, serves the .t7 files' answers bit for bit."""
    svc = services[0]
    with open(os.path.join(env["vqa"], "data_prepro.json")) as f:
        info = json.load(f)
    imgs = info["unique_img_train"] + info["unique_img_test"]
    shard = str(tmp_path / "shard")
    pack_feature_dir(env["feat"], imgs, [1] * len(imgs), shard, SPEC.feat_dim,
                     SPEC.feat_w, SPEC.feat_h)
    packed = RAUService(env["ck"], env["vqa"], [shard], device="cpu")
    try:
        assert packed.source.__class__.__name__ == "PackedFeatureStore"
        for name in env["names"][:3]:
            assert packed.answer("w01 w02", feat_name=name) == \
                svc.answer("w01 w02", feat_name=name)
    finally:
        packed.close()


def test_stats_have_the_jax_keys(services, env):
    svc, jsvc = services
    svc.answer("w01", feat_name=env["names"][0])
    jsvc.answer("w01", feat_name=env["names"][0])
    st = svc.stats()
    assert set(st) == set(jsvc.stats())
    assert st["requests_served"] >= 1 and st["dispatches"] >= 1
    assert st["pixels_artifact"] is False
    assert st["image_size"] == jsvc.stats()["image_size"] == SPEC.feat_w * 32


def fake_group(n, svc, make_feats):
    tokens, length = svc.data.question_to_tokens("w01 w02", normalize=True)
    return [{"tokens": tokens, "length": length, "feats": make_feats(),
             "done": threading.Event()} for _ in range(n)]


@pytest.mark.parametrize("max_batch", [16, 6])
def test_pad_bucket_of_each_group_size_is_jax(env, max_batch):
    """The padded batch of a group of n: the first of (1, 4, 8, max_batch)
    holding n, as serve.py:354 of the JAX package (a max_batch below 8
    included)."""
    svc = port_service(env, max_batch=max_batch)
    jsvc = jax_service(env, max_batch=max_batch)
    cfg = svc.mcfg
    seen = {"port": [], "jax": []}

    def spy(who, wrap):
        def predict(params, tokens, lengths, feats):
            seen[who].append((tokens.shape[0], feats.shape[0]))
            B = tokens.shape[0]
            return (wrap(np.zeros((cfg.n_hops + 2, B, cfg.answer_size))),
                    wrap(np.zeros((cfg.n_hops + 2, B, cfg.cnn_spat))))
        return predict

    svc.predict = spy("port", torch.as_tensor)
    jsvc.predict = spy("jax", np.asarray)
    zero = np.zeros((cfg.cnn_spat, cfg.cnn_dim), np.float32)
    try:
        for n in range(1, max_batch + 1):
            svc._run_group_inner(fake_group(n, svc, lambda: torch.as_tensor(zero)))
            jsvc._run_group_inner(fake_group(n, jsvc, lambda: jax.device_put(zero)))
        want = ([1, 4, 4, 4, 8, 8, 8, 8] + [16] * 8)[:max_batch]
        assert seen["port"] == seen["jax"] == [(b, b) for b in want]
    finally:
        svc.close()


def test_concurrent_requests_share_dispatches(env):
    svc = port_service(env, max_wait_ms=50.0)
    try:
        qs = [(f"w0{i + 1} w03", env["names"][i]) for i in range(4)]
        seq = {q: svc.answer(q, feat_name=f) for q, f in qs}
        before = svc.stats()
        out, errors = [], []

        def ask(q, f):
            try:
                out.append((q, svc.answer(q, feat_name=f)))
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)
        threads = [threading.Thread(target=ask, args=qf)
                   for qf in qs for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
        assert not any(t.is_alive() for t in threads) and not errors
        assert len(out) == 12 and all(a == seq[q] for q, a in out)
        st = svc.stats()
        assert st["requests_served"] - before["requests_served"] == 12
        assert st["dispatches"] - before["dispatches"] < 12
        assert st["max_batch_seen"] > 1
    finally:
        svc.close()


def test_blocked_predict_times_out_and_health_says_wedged(env):
    svc = port_service(env, request_timeout_s=0.3)
    server = serve(svc, port=0, host="127.0.0.1")
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    port = server.server_address[1]
    release = threading.Event()
    real = svc.predict

    def blocked(*a):
        release.wait(WAIT)
        return real(*a)
    try:
        assert request(port, "/healthz") == (200, {"status": "ok"})
        svc.predict = blocked
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="timed out"):
            svc.answer("w01 w02", feat_name=env["names"][0])
        assert time.monotonic() - t0 < 5.0
        deadline = time.monotonic() + WAIT
        while svc.health()["status"] != "wedged" and time.monotonic() < deadline:
            time.sleep(0.02)
        code, body = request(port, "/healthz")
        assert code == 503 and body["status"] == "wedged"
        assert body["dispatch_stuck_s"] >= 0.3
        release.set()
        while svc.health()["status"] != "ok" and time.monotonic() < deadline:
            time.sleep(0.02)
        assert request(port, "/healthz") == (200, {"status": "ok"})
        svc.predict = real
        assert svc.answer("w01 w02", feat_name=env["names"][0])["answers"]
    finally:
        release.set()
        server.shutdown()
        server.server_close()
        svc.close()
        t.join(WAIT)


class Interrupt(BaseException):
    pass


@pytest.mark.parametrize("error", [RuntimeError("dispatch failed"),
                                   Interrupt("dispatch interrupted")])
def test_failing_dispatch_releases_every_waiter(env, error, monkeypatch):
    """Every request of the failing group gets the error, a BaseException
    included (which then ends the collector; the next request starts a new
    one)."""
    svc = port_service(env, max_wait_ms=200.0)
    ended = []
    monkeypatch.setattr(threading, "excepthook", lambda a: ended.append(a))
    real = svc.predict

    def failing(*a):
        raise error
    svc.predict = failing
    got = []

    def ask(i):
        try:
            svc.answer("w01", feat_name=env["names"][i])
        except BaseException as e:  # noqa: BLE001 — the test's subject
            got.append(e)
    try:
        threads = [threading.Thread(target=ask, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
        assert not any(t.is_alive() for t in threads)
        assert len(got) == 4 and all(e is error for e in got)
        if isinstance(error, Interrupt):
            # the collector ended with it, and marked itself gone
            assert svc._batcher is None
            deadline = time.monotonic() + WAIT
            while not ended and time.monotonic() < deadline:
                time.sleep(0.01)
            assert ended and ended[0].exc_value is error
        svc.predict = real
        assert svc.answer("w01", feat_name=env["names"][0])["answers"]
    finally:
        svc.close()


def png_bytes(seed, size=64):
    rs = np.random.RandomState(seed)
    buf = io.BytesIO()
    Image.fromarray(rs.randint(0, 256, (size, size, 3), dtype=np.uint8)).save(
        buf, format="PNG")
    return buf.getvalue()


def pooled_features(pixels, S, D):
    """Deterministic features from pixels: each of the S grid cells' mean
    of each channel, tiled over D (the backbone's stand-in)."""
    x = np.asarray(pixels, np.float64)[0] / 255.0
    cells = np.stack([c.mean((0, 1)) for row in np.array_split(x, SPEC.feat_w)
                      for c in np.array_split(row, SPEC.feat_h, axis=1)])
    return np.tile(cells, (1, D // 3 + 1))[None, :, :D].astype(np.float32)


def fake_backbones(monkeypatch, svc, jsvc, calls, delay=0.0):
    S, D = svc.mcfg.cnn_spat, svc.mcfg.cnn_dim

    def jax_extract(backbone, bb_params, arr, vit_cfg=None, **kw):
        return pooled_features(arr, S, D)

    def port_extract(backbone, bb_params, images_u8, **kw):
        calls.append(kw.get("fused_stages"))
        time.sleep(delay)
        return torch.as_tensor(pooled_features(images_u8.numpy(), S, D))

    monkeypatch.setattr(jpipe, "extract_features", jax_extract)
    monkeypatch.setattr(tpipe, "extract_features", port_extract)
    svc.backbone, svc.bb_params = "resnet101", {}
    if jsvc is not None:
        jsvc.backbone, jsvc.bb_params = "vgg16", {}


def test_image_requests_match_jax(env, monkeypatch):
    """image_b64 requests: the native decoder on both sides (bit-equal),
    the backbone's stand-in, then both caches and the predict step."""
    svc, jsvc = port_service(env), jax_service(env, fused=True)
    calls = []
    fake_backbones(monkeypatch, svc, jsvc, calls)
    try:
        for seed in (1, 2):
            b64 = base64.b64encode(png_bytes(seed, 80 + 16 * seed)).decode()
            kw = dict(image_b64=b64, topk=4, attention=True)
            got = svc.answer_many(QUESTIONS[:2], **kw)
            want = jsvc.answer_many(QUESTIONS[:2], **kw)
            for g, w in zip(got, want):
                assert_same_answer(g, w, FUSED_BAR)
        assert calls == [tpipe.SERVING_STAGES] * 2
        assert svc.stats()["feat_cache_entries"] == 2
    finally:
        svc.close()


def test_lrus_evict_in_jax_order(env, monkeypatch):
    svc = port_service(env, feat_cache_size=2)
    jsvc = jax_service(env, feat_cache_size=2)
    fake_backbones(monkeypatch, svc, jsvc, [])
    try:
        n = env["names"]
        for name in (n[0], n[1], n[0], n[2], n[3], n[2]):
            svc._feats_for(name, None)
            jsvc._feats_for(name, None)
            assert list(svc._dev_feat_cache) == list(jsvc._dev_feat_cache)
        imgs = [png_bytes(s) for s in (3, 4, 3, 5, 4)]
        for img in imgs:
            svc._featurize_image(img)
            jsvc._featurize_image(img)
            assert list(svc._feat_cache) == list(jsvc._feat_cache)
        assert list(svc._feat_cache) == [hashlib.sha256(imgs[i]).hexdigest()
                                         for i in (3, 4)]
        # an entry evicted from the device LRU comes back with its bits
        a = svc._feats_for(n[1], None).clone()
        for name in n[4:7]:
            svc._feats_for(name, None)
        assert ("f", n[1], 1) not in svc._dev_feat_cache
        assert torch.equal(svc._feats_for(n[1], None), a)
    finally:
        svc.close()


def run_threads(fn, n):
    out, errors = [], []

    def run():
        try:
            out.append(fn())
        except Exception as e:  # noqa: BLE001 — collected for the test
            errors.append(e)
    threads = [threading.Thread(target=run) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT)
    assert not any(t.is_alive() for t in threads)
    return out, errors


def test_same_image_at_once_runs_the_backbone_once(env, monkeypatch):
    svc = port_service(env)
    calls = []
    fake_backbones(monkeypatch, svc, None, calls, delay=0.2)
    try:
        img = png_bytes(9)
        out, errors = run_threads(lambda: svc._featurize_image(img), 4)
        assert not errors and len(out) == 4 and len(calls) == 1
        assert all(o is out[0] for o in out)
        svc._featurize_image(png_bytes(10))
        assert len(calls) == 2
        # three requests at once over HTTP-like answer calls: one more run
        b64 = base64.b64encode(png_bytes(11)).decode()
        out, errors = run_threads(
            lambda: svc.answer("w01 w02", image_b64=b64), 3)
        assert not errors and len(calls) == 3
        assert len({json.dumps(o) for o in out}) == 1
    finally:
        svc.close()


def test_corrupt_image_releases_its_waiters(env, monkeypatch):
    svc = port_service(env)
    calls = []
    fake_backbones(monkeypatch, svc, None, calls)
    real = svc._decode_image

    def slow(raw):
        time.sleep(0.2)       # the others queue behind the in-flight mark
        return real(raw)
    svc._decode_image = slow
    try:
        out, errors = run_threads(
            lambda: svc._featurize_image(b"not an image"), 3)
        assert not out and len(errors) == 3 and not calls
        assert not svc._feat_inflight and not svc._feat_cache
    finally:
        svc.close()


def test_http_status_codes(http, env):
    port = http
    assert request(port, "/healthz") == (200, {"status": "ok"})
    code, body = request(port, "/answer", {"question": "w01 w02",
                                           "feat_name": env["names"][0],
                                           "topk": 2})
    assert code == 200 and len(body["answers"]) == 2
    assert len(body["per_hop"]) == 2 and "attention" not in body
    code, body = request(port, "/answer_many",
                         {"questions": ["w01", "w02 w03"],
                          "feat_name": env["names"][1], "attention": True})
    assert code == 200 and len(body["results"]) == 2
    rows = body["results"][0]["attention"]["rows"]
    assert len(rows) == 4 and all(abs(sum(r) - 1) < 1e-3 for r in rows)
    code, body = request(port, "/answer", {"question": "w01",
                                           "feat_name": "no-such-file.t7"})
    assert code == 400 and body["error"]
    code, body = request(port, "/answer", {"question": "w01"})
    assert code == 400 and "feat_name" in body["error"]
    code, body = request(port, "/answer", {"question": "w01",
                                           "feat_name": env["names"][0],
                                           "datatype": 2})
    assert code == 400 and "datatype" in body["error"]
    code, body = request(port, "/answer", {"question": "w01",
                                           "image_b64": base64.b64encode(
                                               png_bytes(1)).decode()})
    assert code == 400 and "no visual backbone" in body["error"]
    assert request(port, "/nothing")[0] == 404
    assert request(port, "/nothing", {"question": "w01"})[0] == 404
    code, body = request(port, "/stats")
    assert code == 200 and body["requests_served"] >= 3


def test_unported_options_are_refused(env, tmp_path, monkeypatch):
    with pytest.raises(NotImplementedError, match="queue 1, item 8, export"):
        RAUService(None, env["vqa"], env["feat"], artifact=str(tmp_path),
                   device="cpu")
    # the three backbones are ported (test_backbone_image_requests_match_jax)
    with pytest.raises(ValueError, match="unknown backbone"):
        port_service(env, backbone="alexnet")
    # a snapshot whose sidecar says the backbone was fine-tuned
    ck = str(tmp_path / "ft.msgpack")
    with open(env["ck"], "rb") as a, open(ck, "wb") as b:
        b.write(a.read())
    with open(os.path.splitext(env["ck"])[0] + ".json") as f:
        meta = json.load(f)
    with open(str(tmp_path / "ft.json"), "w") as f:
        json.dump({**meta, "train_backbone": True, "backbone": "resnet101"}, f)
    # (its group is served since backbone fine-tuning was ported; a sidecar
    # that claims one the snapshot lacks is refused)
    with pytest.raises(ValueError, match="no 'backbone' parameter group"):
        RAUService(ck, env["vqa"], env["feat"], device="cpu")
    # a packed shard of RMS-normalized rows for a raw-trained head
    shard = str(tmp_path / "rms")
    from rau_vqa_tpu_torch.data.features import PackedShardWriter
    w = PackedShardWriter(shard, 1, SPEC.feat_w * SPEC.feat_h, SPEC.feat_dim,
                          feat_norm=True)
    w.write(0, np.zeros((1, SPEC.feat_w * SPEC.feat_h, SPEC.feat_dim)))
    w.finish([env["names"][0]])
    with pytest.raises(ValueError, match="feat_norm"):
        RAUService(env["ck"], env["vqa"], [shard], device="cpu")
    # the card by default, and no card here
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RAUService(env["ck"], env["vqa"], env["feat"])


def test_cli_serve(env, tmp_path, monkeypatch):
    """``serve --fixture`` builds the fixture's data in memory and answers
    over HTTP; the unported options are refused."""
    from rau_vqa_tpu_torch import cli as tcli
    from rau_vqa_tpu_torch import serve as tserve

    started = []
    real_serve = tserve.serve
    monkeypatch.setattr(tserve, "serve", lambda svc, port: started.append(
        (svc, real_serve(svc, port, host="127.0.0.1"))) or started[-1][1])
    args = ["--device", "cpu", "serve", "--checkpoint", env["ck"], "--fixture",
            "--save-dir", str(tmp_path), "--port", "0", "--plain-eval",
            "--max-wait-ms", "1", "--eval-buckets", "4"]
    rc = []
    t = threading.Thread(target=lambda: rc.append(tcli.main(args)), daemon=True)
    t.start()
    deadline = time.monotonic() + WAIT
    while not started and time.monotonic() < deadline:
        time.sleep(0.02)
    svc, server = started[0]
    try:
        assert svc.fused is False and svc.max_wait_ms == 1.0
        code, body = request(server.server_address[1], "/answer",
                             {"question": "w01 w02",
                              "feat_name": env["names"][0]})
        assert code == 200 and body["answers"]
        want = port_service(env, fused=False)
        try:
            assert body == want.answer("w01 w02", feat_name=env["names"][0])
        finally:
            want.close()
    finally:
        server.shutdown()
        t.join(WAIT)
    assert not t.is_alive() and rc == [0]
    with pytest.raises(NotImplementedError, match="item 8, export"):
        tcli.main(["--device", "cpu", "serve", "--checkpoint", env["ck"],
                   "--artifact", str(tmp_path)])
    with pytest.raises(SystemExit, match="--backbone-state"):
        tcli.main(["--device", "cpu", "serve", "--checkpoint", env["ck"],
                   "--backbone", "vit"])
    # a snapshot as --backbone-state gives its fine-tuned group, which a
    # head-only snapshot lacks
    with pytest.raises(ValueError, match="no 'backbone' parameter group"):
        tcli.main(["--device", "cpu", "serve", "--checkpoint", env["ck"],
                   "--backbone", "resnet101", "--backbone-state", env["ck"]])


def test_backbone_state_loads_as_the_jax_cli(tmp_path):
    """``--backbone-state``: a torchvision ResNet-101 state dict (.pth, at
    narrow widths here) -> the folded tree the JAX CLI makes, in bf16."""
    from rau_vqa_tpu import cli as jcli
    from rau_vqa_tpu_torch import cli as tcli
    from rau_vqa_tpu_torch.convert import map_tree, tree_leaves
    from tests.test_torch_port_backbone import _torchvision_state

    state = _torchvision_state(np.random.RandomState(3), widths=(8, 16, 32, 64),
                               blocks=(3, 4, 23, 3), stem=16)
    path = str(tmp_path / "resnet101.pth")
    torch.save({k: torch.as_tensor(v) for k, v in state.items()}, path)
    got = tcli._load_backbone_state("resnet101", path, torch.device("cpu"))
    assert all(x.dtype == torch.bfloat16 and x.device.type == "cpu"
               for x in tree_leaves(got))
    want = jax.tree.leaves(jcli._load_backbone_state("resnet101", path))
    got = jax.tree.leaves(map_tree(lambda x: x.float().numpy(), got))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):     # within bf16's rounding of JAX's float32
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=2 ** -8, atol=2 ** -8 * np.abs(b).max())


def test_image_without_a_decoder_is_a_400_naming_both(env, monkeypatch):
    """Without the native decoder and PIL an image_b64 request is a 400
    whose text names the native decoder's build error and the missing PIL;
    the decode failure releases its waiters and nothing is cached."""
    import sys

    from rau_vqa_tpu_torch.data import native as tnative

    svc = port_service(env)
    calls = []
    fake_backbones(monkeypatch, svc, None, calls)
    server = serve(svc, port=0, host="127.0.0.1")
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        def unavailable(image_bytes, size):
            raise tnative.NativeUnavailable(
                "libimage_decode.so: Command [...] returned non-zero exit status 1.\n"
                "--- compiler output ---\n"
                "image_decode.cpp:32:10: fatal error: jpeglib.h: No such file or directory")
        other = base64.b64encode(png_bytes(8)).decode()
        monkeypatch.setattr(tnative, "decode_image_bytes", unavailable)
        monkeypatch.setitem(sys.modules, "PIL", None)         # import PIL fails
        code, body = request(server.server_address[1], "/answer",
                             {"question": "w01", "image_b64": other})
        assert code == 400
        assert "native decoder" in body["error"] and "jpeglib.h" in body["error"]
        assert "PIL is not installed" in body["error"]
        assert calls == [] and svc.stats()["feat_cache_entries"] == 0
        assert not svc._feat_inflight
    finally:
        server.shutdown()
        server.server_close()
        svc.close()
        t.join(WAIT)


@pytest.fixture(scope="module")
def image_envs(tmp_path_factory):
    """JAX snapshots of image heads, each fitted one epoch from the
    fixture's images through a frozen backbone: VGG16 (64 px, 2x2x512) and
    the tiny ViT (28 px, 2x2x64)."""
    from rau_vqa_tpu.models.backbones import vit as jvit
    from tests.test_torch_port_trainer import image_fixture_root, image_trainers
    from tests.test_torch_port_vgg_vit import JTINY, jax_vgg
    fix = image_fixture_root.__wrapped__(tmp_path_factory)
    out = {}
    for backbone, bb in (("vgg16", jax_vgg(0, 0.72)),
                         ("vit", jax.tree.map(np.asarray,
                                              jvit.vit_init(jax.random.PRNGKey(0), JTINY)))):
        root = tmp_path_factory.mktemp(f"port_serve_{backbone}")
        jt, _ = image_trainers(fix, root, bb, backbone=backbone)
        jt.train_epoch()
        out[backbone] = {"ck": jt.save(), "vqa": os.path.join(fix, "vqa_prepro"),
                         "feat": [], "bb": bb, "images": os.path.join(fix, "images")}
    return out


@pytest.mark.parametrize("backbone", ["vgg16", "vit"])
def test_backbone_image_requests_match_jax(image_envs, backbone, monkeypatch):
    """image_b64 requests through a VGG16 or ViT service: decoded at
    cnn_w x 32 or x 14 px (the JAX rule), featurized in the backbone
    thread, answered as the JAX service answers them at the serving bars."""
    from rau_vqa_tpu.models.backbones import vit as jvit
    from rau_vqa_tpu_torch.convert import params_from_jax
    from tests.test_torch_port_vgg_vit import JTINY, TTINY
    env = image_envs[backbone]
    monkeypatch.setattr(jvit, "VIT_L14", JTINY)   # the JAX service's ViT
    svc = port_service(env, backbone=backbone, bb_params=params_from_jax(env["bb"]),
                       vit_cfg=TTINY if backbone == "vit" else None)
    jsvc = jax_service(env, fused=True, backbone=backbone, bb_params=env["bb"])
    try:
        assert svc.image_size == jsvc.image_size == (28 if backbone == "vit" else 64)
        for rel in ("val2014/COCO_val2014_000000000003.jpg",
                    "val2014/COCO_val2014_000000000011.jpg"):
            with open(os.path.join(env["images"], rel), "rb") as f:
                b64 = base64.b64encode(f.read()).decode()
            kw = dict(image_b64=b64, topk=4, attention=True)
            for g, w in zip(svc.answer_many(QUESTIONS[:2], **kw),
                            jsvc.answer_many(QUESTIONS[:2], **kw)):
                assert_same_answer(g, w, FUSED_BAR)
        assert svc.stats()["feat_cache_entries"] == 2
    finally:
        svc.close()
