"""HTTP service bench of the port: single-question latency and saturated
throughput of ``rau_vqa_tpu_torch.serve`` on one CUDA card.

Counterpart of ``scripts/bench_serve.py``.  ``ours_ms`` at full width
(vocab ~12k, 1000 answers, 26 tokens, 14x14x512 features) is served from an
untrained ``.pt`` snapshot (seed 0) over the port's synthetic fixture
bundle (``data/fixtures.py``), by an in-process ``serve()`` on 127.0.0.1,
length buckets off, with the JAX script's warm-up bursts (1, then 4, 8 and
``--max-batch`` at once).  Every request carries a distinct question and
feature pair from a pool built with ``RandomState(0)`` in the JAX script's
order, so both scripts send the same payloads.  Phases:

  A.  unloaded: ``--unloaded`` sequential requests -> p50 / p99 ms;
  A2. where that latency lives: ``svc.predict`` at bucket 1 and at
      ``--max-batch`` (the device step, CUDA-synchronised), then
      ``svc.answer`` (tokenizing, the batcher and the step, no HTTP);
  B.  saturated: ``--clients`` client threads in this process, each
      ``--requests`` back-to-back requests -> q/s, loaded p50 / p99, and the
      phase's mean micro-batch from ``/stats``.

    python3 -m rau_vqa_tpu_torch.scripts.bench_serve [--clients 32] [--requests 40]
        [--unloaded 50] [--max-batch 16] [--max-wait-ms 5] [--tiny] [--device cpu]

``--tiny`` gives the JAX script's CPU-smoke fixture.  Prints one JSON line:
``metric`` serve_questions_per_sec and the JAX script's keys
(``latency_p50_ms``, ``latency_p99_ms``, ``loaded_p50_ms``,
``loaded_p99_ms``, ``clients``, ``errors``, ``mean_microbatch``,
``dispatch_b1_ms``, ``dispatch_bmax_ms``, ``service_answer_ms``), with
``launches`` (the serving kernels' over the run), ``device``,
``power_limit_w`` and the canary; no ``vs_baseline``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import threading
import time
import urllib.request
from typing import Dict, List

import numpy as np
import torch

from rau_vqa_tpu_torch.scripts._common import (
    add_device_arg,
    canary_keys,
    launch_counts,
    launches_since,
    log,
    run_script,
    sync,
)

METRIC = "serve_questions_per_sec"
UNIT = "questions/sec"
POOL = 2048


def _post(port: int, payload: dict) -> dict:
    req = urllib.request.Request(f"http://127.0.0.1:{port}/answer",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def _stats(port: int) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=60) as r:
        return json.loads(r.read())


def fixture_spec(tiny: bool):
    """The JAX script's synthetic bundle: full width, or its CPU smoke's.  At
    full width the image classes are dense codes: the JAX script's spec
    (one class an answer, 1000, as one-channel bumps over 512 channels) is
    refused by the fixture of either package; the classes change the
    features' values only, not the vocabulary, the feature names or the
    work."""
    from rau_vqa_tpu_torch.data.fixtures import FixtureSpec

    if tiny:
        return FixtureSpec(n_train=16, n_test=8, n_images=8)
    return FixtureSpec(n_train=64, n_test=32, n_images=32, n_words=12000, n_answers=1000,
                       seq_len=26, feat_dim=512, feat_w=14, feat_h=14, class_code="dense")


def request_pool(rs: np.random.RandomState, vocab: List[str], feat_names: List[str],
                 seq_len: int, n: int = POOL) -> List[dict]:
    """``n`` payloads of 3 to min(12, seq_len) words each, drawn from ``rs``
    as the JAX script draws them (``vocab[0]`` is ZEROPAD; UNK is left out)."""
    words = [w for w in vocab[1:] if w != "UNK"]

    def make_payload() -> dict:
        k = int(rs.randint(3, min(12, seq_len) + 1))
        qs = " ".join(words[j] for j in rs.randint(0, len(words), k))
        return {"question": qs, "feat_name": feat_names[int(rs.randint(len(feat_names)))]}

    return [make_payload() for _ in range(n)]


def warm_up(port: int, pool: List[dict], max_batch: int) -> None:
    """The JAX script's warm-up: one request, then bursts of 4, 8 and
    ``max_batch`` concurrent ones (``pool[i + 7 * burst]``)."""
    t0 = time.perf_counter()
    _post(port, pool[0])
    log(f"bench_serve: first request {time.perf_counter() - t0:.2f}s")
    for burst in (4, 8, max_batch):
        errs = []

        def fire(p):
            try:
                _post(port, p)
            except Exception as e:     # noqa: BLE001 -- reported below
                errs.append(e)
        ts = [threading.Thread(target=fire, args=(pool[i + burst * 7],)) for i in range(burst)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        if errs:
            raise SystemExit(f"warmup burst {burst} failed: {errs[0]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--clients", type=int, default=32,
                    help="concurrent clients in the saturated phase")
    ap.add_argument("--requests", type=int, default=40,
                    help="requests a client in the saturated phase")
    ap.add_argument("--unloaded", type=int, default=50,
                    help="sequential requests in the latency phase")
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    ap.add_argument("--tiny", action="store_true", help="tiny dims for CPU smokes")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if args.unloaded + 310 > POOL:
        raise SystemExit(f"--unloaded must leave the pool's requests 300-309 to phase A2 "
                         f"(at most {POOL - 310})")

    def body() -> Dict:
        from rau_vqa_tpu_torch.config import get_preset
        from rau_vqa_tpu_torch.data.fixtures import generate_fixture
        from rau_vqa_tpu_torch.data.loader import load_vqa_data
        from rau_vqa_tpu_torch.serve import RAUService, serve
        from rau_vqa_tpu_torch.train.trainer import init_train_state
        from rau_vqa_tpu_torch.utils.checkpoint import save_checkpoint

        spec = fixture_spec(args.tiny)
        before = launch_counts()
        with tempfile.TemporaryDirectory(prefix="bench_serve_") as root:
            vqa_dir = generate_fixture(root, spec)
            feat_dir = os.path.join(root, "feat")
            log(f"bench_serve: synthetic bundle at {root} (vocab {spec.n_words}, answers "
                f"{spec.n_answers}, feats {spec.feat_w}x{spec.feat_h}x{spec.feat_dim})")
            data = load_vqa_data(vqa_dir, 1, test_batch_size=1)
            mcfg = dataclasses.replace(
                get_preset("ours_ms"), vocab_size=data.vocab_size,
                answer_size=data.answer_size, seq_len=data.seq_len, cnn_dim=spec.feat_dim,
                cnn_w=spec.feat_w, cnn_h=spec.feat_h, compute_dtype="bfloat16")
            state = init_train_state(mcfg, 0, device=device)
            ck = save_checkpoint(os.path.join(root, "snapshot"), 0, 0.0, state._asdict(),
                                 extra={"model_config": dataclasses.asdict(mcfg)})
            del state
            # length buckets off: one token axis, four micro-batch buckets
            svc = RAUService(ck, vqa_dir, [feat_dir], preset="ours_ms", buckets=(),
                             max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
                             device=device)
            server = serve(svc, port=0, host="127.0.0.1")
            port = server.server_address[1]
            threading.Thread(target=server.serve_forever, daemon=True).start()
            try:
                rs = np.random.RandomState(0)
                pool = request_pool(rs, data.vocab, sorted(os.listdir(feat_dir)),
                                    spec.seq_len)
                line = phases(args, svc, port, pool, rs, device)
            finally:
                server.shutdown()
                server.server_close()
                svc.close()
        line["launches"] = {n: c for n, c in launches_since(before).items() if c}
        line.update(canary_keys(device))
        return line

    return run_script(METRIC, UNIT, device, body, timeout_s=3000.0)


def phases(args, svc, port: int, pool: List[dict], rs, device: torch.device) -> Dict:
    """The warm-up and phases A, A2 and B against the running service."""
    log("bench_serve: warm-up")
    warm_up(port, pool, args.max_batch)

    # A. unloaded latency
    lat = []
    for i in range(args.unloaded):
        t0 = time.perf_counter()
        out = _post(port, pool[100 + i])
        lat.append(time.perf_counter() - t0)
        if not out.get("answers"):
            raise RuntimeError(f"bench_serve: no answers in {out}")
    lat_ms = np.array(lat) * 1e3
    p50, p99 = float(np.percentile(lat_ms, 50)), float(np.percentile(lat_ms, 99))
    log(f"bench_serve: unloaded p50 {p50:.2f} ms, p99 {p99:.2f} ms over {args.unloaded} "
        f"sequential requests")

    # A2. where the unloaded latency lives: the step alone at bucket 1 and
    # at max_batch (distinct operands each call), then service.answer
    mc = svc.mcfg

    def time_direct(n: int, i: int) -> float:
        toks = np.zeros((n, mc.seq_len), np.int32)
        toks[:, :5] = 1 + (i % 50)
        lens = np.full((n,), 5, np.int32)
        fts = rs.rand(n, mc.cnn_spat, mc.cnn_dim).astype(np.float32)
        t_toks = torch.as_tensor(toks, device=device)
        t_fts = torch.as_tensor(fts, device=device)
        sync(device)
        t0 = time.perf_counter()
        with torch.no_grad():
            out = svc.predict(svc.params, t_toks, lens, t_fts)[0]
        out.cpu()
        return time.perf_counter() - t0

    time_direct(1, 0), time_direct(args.max_batch, 0)     # warm
    lat_d1 = [time_direct(1, i) for i in range(1, 11)]
    lat_db = [time_direct(args.max_batch, i) for i in range(1, 11)]
    ans = []
    for i in range(10):
        p = pool[300 + i]
        t0 = time.perf_counter()
        svc.answer(p["question"], feat_name=p["feat_name"])
        ans.append(time.perf_counter() - t0)
    dispatch1_ms = float(np.median(lat_d1)) * 1e3
    dispatchb_ms = float(np.median(lat_db)) * 1e3
    answer_ms = float(np.median(ans)) * 1e3
    log(f"bench_serve: decomposition: the step at b1 {dispatch1_ms:.2f} ms, at "
        f"b{args.max_batch} {dispatchb_ms:.2f} ms, service.answer {answer_ms:.2f} ms, "
        f"HTTP p50 {p50:.2f} ms")

    # B. saturated throughput; /stats before it, so that the warm-up's and
    # phase A's single dispatches stay out of its mean micro-batch
    pre = _stats(port)
    results: list = []
    errors: list = []
    lock = threading.Lock()

    def client(cid: int):
        rs_c = np.random.RandomState(1000 + cid)
        for _ in range(args.requests):
            p = pool[int(rs_c.randint(len(pool)))]
            t0 = time.perf_counter()
            try:
                _post(port, p)
                dt = time.perf_counter() - t0
                with lock:
                    results.append(dt)
            except Exception as e:     # noqa: BLE001 -- reported in the line
                with lock:
                    errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(c,)) for c in range(args.clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    n_ok = len(results)
    qps = n_ok / wall
    loaded_ms = np.array(results) * 1e3
    lp50 = float(np.percentile(loaded_ms, 50)) if n_ok else 0.0
    lp99 = float(np.percentile(loaded_ms, 99)) if n_ok else 0.0
    stats = _stats(port)
    # the phase's own mean micro-batch: requests over dispatches across it
    d0, d1 = pre.get("dispatches", 0), stats.get("dispatches", 0)
    mean_b = ((stats.get("requests_served", 0) - pre.get("requests_served", 0))
              / max(1, d1 - d0))
    log(f"bench_serve: saturated {qps:.1f} q/s with {args.clients} clients ({n_ok} ok, "
        f"{len(errors)} errors), loaded p50 {lp50:.2f} / p99 {lp99:.2f} ms, mean "
        f"micro-batch {mean_b:.2f} over {d1 - d0} dispatches")
    if errors:
        log(f"bench_serve: first error: {errors[0]}")
    return {"metric": METRIC, "value": round(qps, 1), "unit": UNIT,
            "latency_p50_ms": round(p50, 3), "latency_p99_ms": round(p99, 3),
            "loaded_p50_ms": round(lp50, 3), "loaded_p99_ms": round(lp99, 3),
            "clients": args.clients, "requests": args.requests, "errors": len(errors),
            "mean_microbatch": round(float(mean_b), 2),
            "dispatch_b1_ms": round(dispatch1_ms, 3),
            "dispatch_bmax_ms": round(dispatchb_ms, 3),
            "service_answer_ms": round(answer_ms, 3), "max_batch": args.max_batch,
            "max_wait_ms": args.max_wait_ms}


if __name__ == "__main__":
    sys.exit(main())
