"""HTTP inference service of the port, on one CUDA card.

POST /answer with JSON {"question": str, "feat_name": str} (precomputed
features) or {"question": str, "image_b64": str} (an encoded image, through
the VGG16, ResNet-101 or ViT backbone when one is configured) returns the top-k answers of
the "select" aggregate and each hop's answer.  POST /answer_many with
{"questions": [str, ...], "feat_name"|"image_b64"} answers several questions
about ONE image: its features are fetched once and the questions share a
micro-batch.  Either POST takes {"attention": true} for the per-hop spatial
attention rows (the maps the reference dumps as PNGs,
Ours_SS/...lua:926-932), "topk" and "datatype" (the 1-based feature
directory of a multi-directory source).  GET /healthz answers 503 "wedged"
once a dispatch has been stuck past ``request_timeout_s``; GET /stats gives
the operator's counters.

Concurrent requests are micro-batched: one collector thread takes the queue,
lingers up to ``max_wait_ms`` while fewer than ``max_batch`` requests wait,
pads the group to the first of (1, 4, 8, max_batch) that holds it and runs
one predict step for the whole group.  The collector thread is the only
thread that runs the predict step (the question-LSTM and hop-loop kernels,
or with ``fused=False`` the plain float32 ``predict``); request threads
tokenize, read features and upload them with blocking copies.  Features stay
on the device in an LRU keyed by feature name or image hash.  Image requests
decode on the host (the native C++ decoder, else PIL); one lasting backbone
thread runs the backbone for them, one image at a time (a ResNet's identity
runs in the stage kernel); a host LRU keeps those features, and concurrent requests
for one image wait for one backbone run.

``RAUService(artifact=)`` (``serve --artifact``) serves an exported artifact
(``eval/export.py``) in place of a snapshot.

The port's counterpart of ``rau_vqa_tpu/serve.py``.
"""

from __future__ import annotations

import base64
import contextlib
import dataclasses
import hashlib
import io
import json
import threading
import time
import warnings
from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np
import torch

from rau_vqa_tpu_torch.convert import map_tree
from rau_vqa_tpu_torch.data.features import QuantFeats, check_feat_interface
from rau_vqa_tpu_torch.devices import pick_device
from rau_vqa_tpu_torch.eval.predict import make_predict_step, predict
from rau_vqa_tpu_torch.models import pipeline

PAD_BUCKETS = (1, 4, 8)   # then max_batch: the group sizes a dispatch pads to


class RAUService:
    """A snapshot served for single questions, micro-batched, on ``device``
    (``cuda`` when None, raising without a card; ``"cpu"`` runs the
    kernels' plain versions).

    ``checkpoint`` is the port's ``.pt`` snapshot or the JAX package's
    ``.msgpack`` one; its model config is adopted.  The vocabulary and
    answers come from ``vqa_dir`` (``data_prepro.{json,h5}``, the h5
    read by ``data/hdf5.py``) or from ``data``, a ``VQAData`` built in memory.  ``fused``
    runs the serving kernels through ``make_predict_step`` with length
    ``buckets`` ((8, 16) when None); ``fused=False`` the plain float32
    ``predict``.  ``backbone`` (``"vgg16"``, ``"resnet101"`` or ``"vit"``,
    with ``vit_cfg``, ViT-L/14 when None) with ``bb_params`` on ``device``
    (for ResNet-101 a ``fold_batchnorm`` tree) answers image requests,
    decoded at ``cnn_w`` x 32 px for the conv backbones and ``cnn_w`` x 14
    for the ViT (``rau_vqa_tpu/serve.py:176-181``).  A fine-tuned snapshot
    (its sidecar's ``train_backbone``) serves images through its own trained
    backbone group, as stored, unless ``bb_params`` is given
    (``rau_vqa_tpu/serve.py:150-165``).

    ``artifact`` (in place of ``checkpoint``) serves an exported artifact
    directory (``eval/export.py``; ``rau_vqa_tpu/serve.py:55-140``): the
    service adopts its model config and ladder, and its program is baked
    (``fused`` and ``buckets`` are the artifact's).  A ``pixels_predict``
    artifact bakes its backbone in: requests send ``image_b64``, decoded at
    its ``image_size``.  A ``predict`` artifact carries the head's
    ``backbone_feat_norm`` for image requests through a separate
    ``backbone``.  The benches' chain kinds are refused.  The artifact pins
    its device: ``device`` must be the one it was exported on."""

    def __init__(self, checkpoint: Optional[str], vqa_dir: Optional[str],
                 feat_dirs, *, preset: str = "ours_ms",
                 artifact: Optional[str] = None,
                 backbone: Optional[str] = None, bb_params=None, vit_cfg=None,
                 fused: bool = True, buckets=None,
                 max_batch: int = 16, max_wait_ms: float = 5.0,
                 feat_cache_size: int = 256,
                 request_timeout_s: float = 2600.0,
                 data=None, device=None):
        from rau_vqa_tpu_torch.cli import _adopt_snapshot, _make_feature_source
        from rau_vqa_tpu_torch.config import get_experiment
        from rau_vqa_tpu_torch.data.loader import load_vqa_data
        from rau_vqa_tpu_torch.train.trainer import init_train_state, trained_backbone
        from rau_vqa_tpu_torch.utils.checkpoint import (
            checkpoint_meta,
            load_checkpoint,
            model_config_from_meta,
        )

        if (checkpoint is None) == (artifact is None):
            raise ValueError("pass exactly one of checkpoint (the port's .pt snapshot or "
                             "the JAX package's .msgpack one) / artifact")
        if backbone not in (None,) + pipeline.BACKBONES:
            raise ValueError(f"unknown backbone {backbone!r}")
        self.device = pick_device(device, "RAUService")
        runner = None
        if artifact is not None:
            runner = self._load_artifact(artifact, buckets, backbone)
            exp = get_experiment(preset).replace(
                model=model_config_from_meta(runner.meta["model_config"]))
            meta = {"backbone_feat_norm": runner.meta.get("backbone_feat_norm", False)}
        else:
            meta = checkpoint_meta(checkpoint)
            exp = _adopt_snapshot(get_experiment(preset), checkpoint)
        if data is None:
            if not vqa_dir:
                raise ValueError("pass vqa_dir or data")
            data = load_vqa_data(vqa_dir, 1, split=exp.data.split,
                                 test_batch_size=1)
        self.data = data
        self.mcfg = dataclasses.replace(
            exp.model, vocab_size=data.vocab_size,
            answer_size=data.answer_size, seq_len=data.seq_len)
        # the head's feature interface (RMS-normalized or raw), which image
        # requests featurize to and a packed shard must carry
        self.feat_norm = bool(meta.get("backbone_feat_norm", False))
        self.pixels_artifact = runner is not None and runner.kind == "pixels_predict"
        if runner is not None:
            if self.mcfg != exp.model:
                m = exp.model
                raise ValueError(
                    f"the artifact was exported for vocab/answer/seq_len "
                    f"{(m.vocab_size, m.answer_size, m.seq_len)} but the data provides "
                    f"{(data.vocab_size, data.answer_size, data.seq_len)}")
            self.params = None
            self.fused = bool(runner.meta["fused"])
            self.predict = ((lambda p, t, l, imgs: runner(imgs, t, l)) if self.pixels_artifact
                            else (lambda p, t, l, f: runner(t, l, f)))
        else:
            template = init_train_state(self.mcfg, 0, device="cpu")._asdict()
            # the head's three groups, and a fine-tuned snapshot's own backbone
            # where none is given, computing in the type it was trained in
            own_bb = bb_params is None and meta.get("train_backbone") and meta.get("backbone")
            if own_bb:
                backbone = meta["backbone"]
            tree, _ = load_checkpoint(checkpoint, template,
                                      backbone=backbone if own_bb else None)
            if own_bb:
                bb_params = trained_backbone(self.mcfg, map_tree(
                    lambda x: x.to(self.device), tree["params"].pop("backbone")))
            self.params = map_tree(lambda x: x.to(self.device), tree["params"])
            self.fused = bool(fused)
            self.predict = (make_predict_step(
                self.mcfg, buckets=(8, 16) if buckets is None else tuple(buckets),
                device=self.device) if self.fused else self._plain_predict)
        self.backbone = backbone
        self.bb_params = bb_params
        self.vit_cfg = vit_cfg
        # the decode size: a pixels artifact's own input side, else the
        # head's feature grid (the conv backbones are stride 32, ViT-L/14's
        # patches 14 px)
        self.image_size = (int(runner.meta["image_size"]) if self.pixels_artifact
                           else self.mcfg.cnn_w * (14 if backbone == "vit" else 32))
        self.source = (_make_feature_source(",".join(feat_dirs), self.mcfg)
                       if feat_dirs else None)
        if self.source is not None and not self.pixels_artifact:
            check_feat_interface(self.source, self.feat_norm, "serve")

        self.lock = threading.Lock()
        self._queue: list = []
        self._qcond = threading.Condition()
        self._batcher: Optional[threading.Thread] = None
        self._closed = False
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)   # 0: no lingering
        self.request_timeout_s = float(request_timeout_s)   # 0: unbounded
        self._dispatch_started: Optional[float] = None
        self._total_requests = 0
        self._total_dispatches = 0
        self._batch_sizes_served = deque(maxlen=1000)
        self._stats_lock = threading.Lock()
        # host image-feature LRU (numpy, keyed by the image's sha256) with
        # in-flight coalescing, and the device LRU of features ready for a
        # dispatch, keyed ("f", name, datatype) or ("i", sha256)
        self.feat_cache_size = int(feat_cache_size)
        self._feat_cache: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self._feat_inflight: Dict[str, threading.Event] = {}
        self._feat_cache_lock = threading.Lock()
        self._dev_feat_cache: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()
        self._zero_feat: Optional[torch.Tensor] = None
        # one lasting thread runs every backbone call, one image at a time:
        # each HTTP request comes in a thread of its own, and a thread's
        # first cuDNN and cuBLAS calls make that thread's handles (30-60 ms
        # a thread on the H100's host, PERF.md)
        self._backbone_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="rau-serve-backbone")

    def _load_artifact(self, artifact: str, buckets, backbone):
        """The artifact's runner, refusing the benches' chain programs and
        an artifact of another device; warns where flags cannot apply."""
        from rau_vqa_tpu_torch.eval.export import load_exported
        from rau_vqa_tpu_torch.eval.predict import bucket_ladder

        runner = load_exported(artifact)
        if runner.chain:
            raise ValueError(
                f"artifact kind {runner.kind!r} is a benchmark chain program, not a "
                f"serving program: export one with `python -m rau_vqa_tpu_torch.cli "
                f"export` (kind 'predict' or 'pixels_predict')")
        if runner.device.type != self.device.type:
            raise ValueError(f"the artifact was exported on {runner.device.type} and "
                             f"serves only there; this service runs on {self.device}")
        seq_len = runner.meta["model_config"]["seq_len"]
        if buckets is not None and bucket_ladder(seq_len, buckets) != runner.ladder:
            warnings.warn(f"serving from an artifact: buckets {tuple(buckets)} ignored; "
                          f"the artifact's ladder is {runner.ladder} (export again with "
                          f"--eval-buckets to change it)")
        if runner.kind == "pixels_predict" and backbone is not None:
            warnings.warn("serving from a pixels artifact: the backbone given is ignored "
                          "(the program bakes its own)")
        return runner

    def _plain_predict(self, params, tokens, lengths, feats):
        """The plain float32 path (``fused=False``) on the device."""
        with torch.no_grad():
            return predict(params, self.mcfg,
                           torch.as_tensor(tokens, device=self.device),
                           torch.as_tensor(lengths, device=self.device), feats)

    def _on_device(self):
        """The service's card as the calling thread's current device."""
        return (torch.cuda.device(self.device) if self.device.type == "cuda"
                else contextlib.nullcontext())

    def _wait_s(self) -> Optional[float]:
        return self.request_timeout_s if self.request_timeout_s > 0 else None

    # -- image features ------------------------------------------------

    def _decode_image(self, image_bytes: bytes) -> np.ndarray:
        """Encoded image -> uint8 [1, size, size, 3]: the native decoder
        (JPEG, PNG), else PIL; raises ValueError naming the missing decoder
        when neither can run."""
        from rau_vqa_tpu_torch.data.native import (
            NativeUnavailable,
            decode_image_bytes,
        )
        try:
            arr, ok = decode_image_bytes(image_bytes, self.image_size)
            if ok:
                return arr
            native = "the native decoder cannot read it (it reads JPEG and PNG)"
        except NativeUnavailable as e:
            lines = str(e).splitlines()
            why = next((x for x in lines if "error" in x), lines[0]).strip()
            native = (f"the native decoder (native/image_decode.cpp) is "
                      f"unavailable: {why}")
        try:
            from PIL import Image
        except ImportError:
            raise ValueError(f"cannot decode image_b64: {native}, and PIL "
                             f"is not installed") from None
        from rau_vqa_tpu_torch.data.images import decode_scale_center_crop
        with Image.open(io.BytesIO(image_bytes)) as img:
            return decode_scale_center_crop(img, self.image_size)[None]

    def _extract(self, pixels: np.ndarray) -> np.ndarray:
        """uint8 [1, size, size, 3] -> host float32 [1, S, D] features:
        the backbone on the device (a ResNet's identity runs in the stage
        kernel), in the service's backbone thread.  A pixels artifact runs
        its own backbone: the pixels are what it takes."""
        if self.pixels_artifact:
            return pixels
        return self._backbone_pool.submit(self._run_backbone, pixels).result(
            self._wait_s())

    def _run_backbone(self, pixels: np.ndarray) -> np.ndarray:
        with self._on_device(), torch.no_grad():
            feats = pipeline.extract_features(
                self.backbone, self.bb_params,
                torch.tensor(pixels, device=self.device), vit_cfg=self.vit_cfg,
                fused_stages=pipeline.SERVING_STAGES, feat_norm=self.feat_norm)
            return feats.float().cpu().numpy()

    def _featurize_image(self, image_bytes: bytes,
                         key: Optional[str] = None) -> np.ndarray:
        """The host LRU: features [1, S, D] of an encoded image, by its
        sha256, computed once however many requests ask at once.  A
        failure releases the waiters; the next of them tries again."""
        if not self.pixels_artifact and (self.backbone is None or self.bb_params is None):
            raise ValueError("no visual backbone configured; send feat_name")
        key = key or hashlib.sha256(image_bytes).hexdigest()
        while True:
            with self._feat_cache_lock:
                if key in self._feat_cache:
                    self._feat_cache.move_to_end(key)
                    return self._feat_cache[key]
                inflight = self._feat_inflight.get(key)
                if inflight is None:
                    self._feat_inflight[key] = threading.Event()
                    break
            if not inflight.wait(self._wait_s()):
                raise RuntimeError(f"image features for {key[:12]} not ready "
                                   f"after {self.request_timeout_s:.0f}s")
        try:
            feats = self._extract(self._decode_image(image_bytes))
            with self._feat_cache_lock:
                self._feat_cache[key] = feats
                while len(self._feat_cache) > self.feat_cache_size:
                    self._feat_cache.popitem(last=False)
        finally:
            with self._feat_cache_lock:
                ev = self._feat_inflight.pop(key, None)
            if ev is not None:
                ev.set()
        return feats

    # -- dynamic micro-batching ----------------------------------------

    def _submit(self, items) -> None:
        """Queue ``items`` for the collector, starting one where none runs
        (check-then-act under the queue's lock: ONE collector)."""
        with self._qcond:
            if self._closed:
                raise RuntimeError("the service is closed")
            if self._batcher is None or not self._batcher.is_alive():
                self._batcher = threading.Thread(
                    target=self._batch_loop, name="rau-serve-collector",
                    daemon=True)
                self._batcher.start()
            self._queue.extend(items)
            self._qcond.notify_all()

    def _batch_loop(self) -> None:
        while True:
            with self._qcond:
                while not self._queue and not self._closed:
                    self._qcond.wait()
                if not self._queue:
                    return   # closed and drained
                # linger so that concurrent arrivals share the dispatch
                deadline = self.max_wait_ms / 1e3
                while (len(self._queue) < self.max_batch and deadline > 0
                       and not self._closed):
                    t0 = time.monotonic()
                    self._qcond.wait(timeout=deadline)
                    deadline -= time.monotonic() - t0
                group = self._queue[:self.max_batch]
                del self._queue[:len(group)]
            try:
                self._run_group(group)
            except BaseException as e:  # noqa: BLE001 — fail the whole group
                # every waiter is released, a sticky CUDA error included
                failed = group
                if not isinstance(e, Exception):
                    # an interrupt or exit ends this thread: what is still
                    # queued fails too, and the next request starts a
                    # new collector
                    with self._qcond:
                        failed = group + self._queue
                        del self._queue[:]
                        self._batcher = None
                for item in failed:
                    item["error"] = e
                    item["done"].set()
                if not isinstance(e, Exception):
                    raise

    def _run_group(self, group) -> None:
        # health() compares this mark with request_timeout_s: a dispatch
        # that never returns raises nothing, only elapsed time shows it
        self._dispatch_started = time.monotonic()
        try:
            with self._on_device():
                self._run_group_inner(group)
        finally:
            self._dispatch_started = None

    def _run_group_inner(self, group) -> None:
        n = len(group)
        bucket = next(b for b in PAD_BUCKETS + (self.max_batch,) if b >= n)
        tokens = np.zeros((bucket, self.mcfg.seq_len), np.int32)
        lengths = np.ones((bucket,), np.int32)
        for i, item in enumerate(group):
            tokens[i] = item["tokens"]
            lengths[i] = item["length"]
        if self._zero_feat is None:
            shape = ((self.image_size, self.image_size, 3) if self.pixels_artifact
                     else (self.mcfg.cnn_spat, self.mcfg.cnn_dim))
            self._zero_feat = torch.zeros(shape, dtype=self._feat_dtype(), device=self.device)
        fs = [item["feats"] for item in group]
        fs += [self._zero_feat] * (bucket - n)
        with self.lock:
            tab_pred, tab_att = self.predict(self.params, tokens, lengths,
                                             torch.stack(fs))
        tab = tab_pred.float().cpu().numpy()          # [H+2, bucket, A]
        # attention crosses to the host only when the group asked for it
        att = (tab_att.float().cpu().numpy()
               if any(it.get("attention") for it in group) else None)
        with self._stats_lock:
            self._batch_sizes_served.append(n)
            self._total_requests += n
            self._total_dispatches += 1
        for i, item in enumerate(group):
            item["tab"] = tab[:, i]
            if att is not None and item.get("attention"):
                item["att"] = att[:, i]
            item["done"].set()

    def _feat_dtype(self) -> torch.dtype:
        """What a request's visual operand is on the device: a pixels
        artifact's uint8 image, else float32 features."""
        return torch.uint8 if self.pixels_artifact else torch.float32

    def _device_feats(self, key: tuple, load) -> torch.Tensor:
        """The device feature LRU: a hit uploads nothing; a miss uploads
        ``load()``'s host array with a blocking copy."""
        with self._feat_cache_lock:
            hit = self._dev_feat_cache.get(key)
            if hit is not None:
                self._dev_feat_cache.move_to_end(key)
                return hit
        with self._on_device():
            arr = torch.tensor(load(), dtype=self._feat_dtype(), device=self.device)
        with self._feat_cache_lock:
            self._dev_feat_cache[key] = arr
            while len(self._dev_feat_cache) > self.feat_cache_size:
                self._dev_feat_cache.popitem(last=False)
        return arr

    def _feats_for(self, feat_name: Optional[str], image_b64: Optional[str],
                   datatype: int = 1) -> torch.Tensor:
        if self.pixels_artifact and feat_name is not None:
            raise ValueError("this service runs a from-pixels artifact (its backbone "
                             "baked into the program): send image_b64, not feat_name")
        if feat_name is not None:
            if self.source is None:
                raise ValueError(
                    "no --feat-dir configured: this service cannot resolve "
                    "feat_name requests — send image_b64")

            def load():
                # datatype routes multi-directory .t7 sources (the test2015
                # train2014+val2014 layout, vqa_prepro_loader.lua:876)
                try:
                    feats = self.source.get_batch([feat_name], [int(datatype)])
                except (KeyError, FileNotFoundError) as e:
                    raise ValueError(f"unknown feat_name {feat_name!r}") from e
                if isinstance(feats, QuantFeats):
                    feats = feats.dequantize()
                return feats[0]
            return self._device_feats(("f", feat_name, int(datatype)), load)
        if image_b64 is not None:
            raw = base64.b64decode(image_b64)
            sha = hashlib.sha256(raw).hexdigest()
            # the host copy stays cached too: the in-flight coalescing and a
            # device eviction then cost no backbone run
            return self._device_feats(
                ("i", sha), lambda: self._featurize_image(raw, key=sha)[0])
        raise ValueError("need feat_name or image_b64")

    def _enqueue(self, questions, feats, attention: bool):
        """Tokenize (outside the collector's lock), queue, wait; returns
        the finished items in order."""
        items = []
        for q in questions:
            tokens, length = self.data.question_to_tokens(q, normalize=True)
            items.append({"tokens": tokens, "length": length, "feats": feats,
                          "done": threading.Event(), "question": q,
                          "attention": attention})
        self._submit(items)
        for item in items:
            self._wait_done(item)
        return items

    def answer_many(self, questions, *, feat_name: Optional[str] = None,
                    image_b64: Optional[str] = None, topk: int = 5,
                    attention: bool = False, datatype: int = 1):
        """Several questions about ONE image (VQA asks ~3 an image): its
        features once, the questions queued together."""
        feats = self._feats_for(feat_name, image_b64, datatype)
        return [self._format_answer(it["question"], it["tab"], topk,
                                    att=it.get("att"))
                for it in self._enqueue(list(questions), feats, attention)]

    def answer(self, question: str, *, feat_name: Optional[str] = None,
               image_b64: Optional[str] = None, topk: int = 5,
               attention: bool = False, datatype: int = 1) -> Dict:
        return self.answer_many([question], feat_name=feat_name,
                                image_b64=image_b64, topk=topk,
                                attention=attention, datatype=datatype)[0]

    def _format_answer(self, question: str, tab: np.ndarray, topk: int,
                       att: Optional[np.ndarray] = None) -> Dict:
        final = tab[-1]                            # "select" aggregate
        order = np.argsort(final)[::-1][:topk]
        out = {
            "question": question,
            "answers": [{"answer": self.data.answers[int(i)],
                         "score": float(final[i])} for i in order],
            "per_hop": [self.data.answers[int(tab[h].argmax())]
                        for h in range(tab.shape[0] - 2)],
        }
        if att is not None:
            # the n_hops hop attentions, then the uniform and select
            # aggregates: each a softmax over the w*h feature grid
            out["attention"] = {
                "grid": [int(self.mcfg.cnn_w), int(self.mcfg.cnn_h)],
                "rows": [[round(float(v), 6) for v in att[h]]
                         for h in range(att.shape[0])],
            }
        return out

    def _wait_done(self, item) -> None:
        """Bounded wait on a queued request, re-raising its error."""
        if not item["done"].wait(self._wait_s()):
            raise RuntimeError(
                f"serving dispatch timed out after "
                f"{self.request_timeout_s:.0f}s — the device may be hung; "
                f"GET /healthz now reports wedged")
        if "error" in item:
            raise item["error"]

    def health(self) -> Dict:
        """"wedged" once a dispatch has been stuck past
        request_timeout_s (a hung device call raises nothing)."""
        started = self._dispatch_started
        if started is not None and self.request_timeout_s > 0:
            stuck = time.monotonic() - started
            if stuck > self.request_timeout_s:
                return {"status": "wedged",
                        "dispatch_stuck_s": round(stuck, 1)}
        return {"status": "ok"}

    def stats(self) -> Dict:
        """Operator counters for GET /stats (the JAX service's keys)."""
        with self._stats_lock:
            sizes = list(self._batch_sizes_served)   # a 1000-dispatch window
            total_req = self._total_requests
            total_disp = self._total_dispatches
        with self._feat_cache_lock:
            cache_entries = len(self._feat_cache)
            dev_cache_entries = len(self._dev_feat_cache)
        return {
            "requests_served": int(total_req),
            "dispatches": int(total_disp),
            "mean_batch": round(float(np.mean(sizes)), 3) if sizes else 0.0,
            "max_batch_seen": int(max(sizes)) if sizes else 0,
            "feat_cache_entries": cache_entries,
            "device_feat_cache_entries": dev_cache_entries,
            "pixels_artifact": bool(self.pixels_artifact),
            "image_size": int(self.image_size),
            "max_batch": self.max_batch,
            "max_wait_ms": self.max_wait_ms,
        }

    def close(self, timeout: float = 30.0) -> None:
        """Stop the collector once the queue is drained; later requests
        raise."""
        with self._qcond:
            self._closed = True
            self._qcond.notify_all()
        self._backbone_pool.shutdown(wait=False, cancel_futures=True)
        if self._batcher is not None:
            self._batcher.join(timeout)


def make_handler(service: RAUService):
    class Handler(BaseHTTPRequestHandler):
        # TCP_NODELAY: no small response waits for the peer's delayed ACK
        disable_nagle_algorithm = True

        def log_message(self, *args):
            pass

        def _send(self, code: int, payload: Dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                h = service.health()
                self._send(200 if h["status"] == "ok" else 503, h)
            elif self.path == "/stats":
                self._send(200, service.stats())
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path not in ("/answer", "/answer_many"):
                self._send(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                kw = dict(feat_name=req.get("feat_name"),
                          image_b64=req.get("image_b64"),
                          topk=int(req.get("topk", 5)),
                          attention=bool(req.get("attention", False)),
                          datatype=int(req.get("datatype", 1)))
                if self.path == "/answer_many":
                    result = {"results": service.answer_many(
                        req["questions"], **kw)}
                else:
                    result = service.answer(req["question"], **kw)
                self._send(200, result)
            except Exception as e:  # noqa: BLE001 — the service's boundary
                self._send(400, {"error": str(e)})

    return Handler


class _Server(ThreadingHTTPServer):
    # the default listen backlog of 5 resets a burst of 32 clients
    request_queue_size = 128


def serve(service: RAUService, port: int = 8080,
          host: str = "0.0.0.0") -> ThreadingHTTPServer:
    """The HTTP server over ``service``, bound and not yet serving: call
    ``serve_forever()`` on it (``shutdown()`` from another thread stops
    it).  ``port=0`` takes a free port (``server.server_address[1]``)."""
    server = _Server((host, port), make_handler(service))
    print(f"rau-vqa-torch inference service on "
          f"{host}:{server.server_address[1]}", flush=True)
    return server
