"""Ahead-of-time serving artifacts: the predict program as ``torch.export``
programs (``.pt2``).

Counterpart of ``rau_vqa_tpu/eval/export.py`` (:1-437), with
``torch.export`` in place of ``jax.export`` and ``.pt2`` files in place of
StableHLO.  An artifact directory holds

    meta.json              format, version, kind, ladder, device, fused,
                           shapes, model_config, extra metadata
    predict_T{T:02d}.pt2   one program per token-length bucket (kind
                           "predict"; "pixels_T{T:02d}.pt2" for
                           "pixels_predict")
    chain.pt2              the benches' K-chained program (kinds
                           "serve_chain" and "pixels_chain")

The batch axis is a symbolic ``Dim`` (one program serves any batch size of
at least 1); the token axis is concrete per bucket, as in JAX, and
truncating the tokens to any bucket covering the batch's longest question is
exact.  The serving kinds bake the parameters in as constants, prepared
before the trace: the kernels' weights (``pack_kernel_weights``) and,
from pixels, the backbone's prepared convolutions and stacked identity runs,
so that a call casts and stacks nothing.  The chain kinds take the
parameters as operands.

The default program is what the port's service runs, ``predict_fused``: the
question LSTM, the image embedding and the hop loop as the custom ops
``rau_vqa::lstm_encode``, ``rau_vqa::embed_image`` and ``rau_vqa::rau_hops``
(and, from pixels through ResNet-101,
``rau_vqa::fused_identity_stage``), which ``torch.export`` keeps as calls, so
the loaded program launches the same kernels on the card.  ``fused=False``
exports the plain float32 ``predict``, the program the JAX artifact holds.
An exported program pins the device of its constants and inputs: export on
the device the artifact serves on.  Loading imports ``rau_vqa_tpu_torch.ops``
first, so that the ops are registered before ``torch.export.load``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

# registers the rau_vqa:: custom ops that a saved program calls
import rau_vqa_tpu_torch.ops.embed_image  # noqa: F401
import rau_vqa_tpu_torch.ops.fused_resnet  # noqa: F401
import rau_vqa_tpu_torch.ops.lstm_encoder  # noqa: F401
import rau_vqa_tpu_torch.ops.rau_hops  # noqa: F401
from rau_vqa_tpu_torch.convert import map_tree
from rau_vqa_tpu_torch.devices import pick_device
from rau_vqa_tpu_torch.eval.predict import (
    bucket_ladder,
    pack_kernel_weights,
    pick_bucket,
    predict,
    predict_fused,
)

FORMAT = "rau_vqa_tpu_torch.export"
JAX_FORMAT = "rau_vqa_tpu.export"
EXPORT_VERSION = 3      # this runtime reads versions <= 3
# per kind, as the JAX package numbers them
_KIND_VERSION = {"predict": 1, "pixels_predict": 2, "serve_chain": 3, "pixels_chain": 3}
_META = "meta.json"
TOKEN_CONTRACT = "0 = ZEROPAD, answers 0-based (data/loader.py)"


def _code_rev() -> str:
    """The checkout's git revision, or "unknown" outside one.  Chain
    artifacts pin it: a change to the traced source changes no shape."""
    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True, timeout=10,
            cwd=os.path.dirname(os.path.abspath(__file__))).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


class _Program(torch.nn.Module):
    """``fn(*inputs)`` as a module for ``torch.export``: the tensors ``fn``
    closes over become the program's constants."""

    def __init__(self, fn):
        super().__init__()
        self._fn = fn

    def forward(self, *inputs):
        return self._fn(*inputs)


def _export(fn, args, dynamic_shapes, path: str) -> str:
    with torch.no_grad():
        ep = torch.export.export(
            _Program(fn), tuple(args),
            dynamic_shapes=None if dynamic_shapes is None else {"inputs": dynamic_shapes})
    # the example inputs would be saved with the program (a chain's features
    # are 205 MB at B=512): they only gave the shapes
    ep.example_inputs = None
    torch.export.save(ep, path)
    return path


def _write_meta(out_dir: str, meta: Dict) -> None:
    with open(os.path.join(out_dir, _META), "w") as f:
        json.dump(meta, f, indent=1)


def _head_outputs(cfg) -> Dict:
    return {"tab_pred": [int(cfg.n_hops) + 2, "b", int(cfg.answer_size)],
            "tab_att": [int(cfg.n_hops) + 2, "b", int(cfg.cnn_spat)]}


def _head(params, cfg, fused: bool):
    """``(tokens, lengths, feats) -> (tab_pred, tab_att)`` over weights
    prepared now: the kernels' bf16 copies (fused), or the tree cast to
    ``cfg.compute_dtype`` (plain)."""
    if fused:
        kw = pack_kernel_weights(params)
        return lambda t, l, f: predict_fused(params, kw, cfg, t, l, f)
    if cfg.compute_dtype == "bfloat16":
        params = map_tree(lambda x: x.to(torch.bfloat16), params)
    return lambda t, l, f: predict(params, cfg, t, l, f)


def _example_batch(cfg, B: int, T: int, device):
    tokens = torch.ones(B, T, dtype=torch.int32, device=device)
    lengths = torch.full((B,), T, dtype=torch.int32, device=device)
    return tokens, lengths


def export_predict(params, cfg, out_dir: str, *, buckets: Sequence[int] = (),
                   fused: bool = True, device=None,
                   extra_meta: Optional[Dict] = None) -> Dict[int, str]:
    """Export the predict program (params baked in) to ``out_dir``, on
    ``device`` (``cuda`` when None; ``params`` are moved there).

    Returns {bucket T: path}; ``buckets`` follows the eval ladder
    (``make_predict_step``), the full ``cfg.seq_len`` program always
    included."""
    device = pick_device(device, "export_predict")
    params = map_tree(lambda x: x.to(device), params)
    os.makedirs(out_dir, exist_ok=True)
    ladder = bucket_ladder(cfg.seq_len, buckets)
    head = _head(params, cfg, fused)
    b = torch.export.Dim("b", min=1)
    paths = {}
    for T in ladder:
        tokens, lengths = _example_batch(cfg, 3, T, device)
        feats = torch.zeros(3, cfg.cnn_spat, cfg.cnn_dim, device=device)
        paths[T] = _export(head, (tokens, lengths, feats), ({0: b}, {0: b}, {0: b}),
                           os.path.join(out_dir, f"predict_T{T:02d}.pt2"))
    _write_meta(out_dir, {
        "format": FORMAT, "version": _KIND_VERSION["predict"], "kind": "predict",
        "ladder": ladder, "device": device.type, "fused": bool(fused),
        "inputs": {"tokens": ["b", "T"], "lengths": ["b"],
                   "feats": ["b", int(cfg.cnn_spat), int(cfg.cnn_dim)]},
        "outputs": _head_outputs(cfg), "token_contract": TOKEN_CONTRACT,
        "model_config": dataclasses.asdict(cfg), **(extra_meta or {})})
    return paths


def export_pixels_predict(params, cfg, backbone: str, bb_params, out_dir: str, *,
                          image_size: int = 448, buckets: Sequence[int] = (),
                          fused: bool = True, vit_cfg=None, feat_norm: bool = False,
                          device=None, extra_meta: Optional[Dict] = None) -> Dict[int, str]:
    """Export the whole from-pixels program: uint8 images + tokens ->
    answers, the backbone's normalization, the backbone and the head in one
    program, both parameter sets baked in.  ``fused`` runs every ResNet
    identity run in the stage kernel and the head in its two kernels, as
    ``answer_pixels``; ``fused=False`` the plain backbone and ``predict``.

    The backbone's weights are constants of EVERY bucket's program
    (ResNet-101 ~85 MB in bf16 a file), so the default is one full-length
    program."""
    from rau_vqa_tpu_torch.models.pipeline import SERVING_STAGES, extract_features

    device = pick_device(device, "export_pixels_predict")
    params = map_tree(lambda x: x.to(device), params)
    bb_params = map_tree(lambda x: x.to(device), bb_params)
    os.makedirs(out_dir, exist_ok=True)
    ladder = bucket_ladder(cfg.seq_len, buckets)
    head = _head(params, cfg, fused)
    stages = SERVING_STAGES if fused and backbone == "resnet101" else ()

    def run(images_u8, tokens, lengths):
        # feat_norm: the interface the head was trained on
        feats = extract_features(backbone, bb_params, images_u8, vit_cfg,
                                 fused_stages=stages, feat_norm=feat_norm)
        return head(tokens, lengths, feats.float())

    images = torch.zeros(3, image_size, image_size, 3, dtype=torch.uint8, device=device)
    b = torch.export.Dim("b", min=1)
    paths = {}
    with torch.no_grad():     # prepares the backbone's weights before the trace
        run(images[:1], *_example_batch(cfg, 1, cfg.seq_len, device))
    for T in ladder:
        tokens, lengths = _example_batch(cfg, 3, T, device)
        paths[T] = _export(run, (images, tokens, lengths), ({0: b}, {0: b}, {0: b}),
                           os.path.join(out_dir, f"pixels_T{T:02d}.pt2"))
    _write_meta(out_dir, {
        "format": FORMAT, "version": _KIND_VERSION["pixels_predict"],
        "kind": "pixels_predict", "ladder": ladder, "device": device.type,
        "fused": bool(fused), "backbone": backbone, "image_size": int(image_size),
        "backbone_feat_norm": bool(feat_norm),
        "inputs": {"images_u8": ["b", int(image_size), int(image_size), 3],
                   "tokens": ["b", "T"], "lengths": ["b"]},
        "outputs": _head_outputs(cfg), "token_contract": TOKEN_CONTRACT,
        "model_config": dataclasses.asdict(cfg), **(extra_meta or {})})
    return paths


def export_serve_chain(params, cfg, out_dir: str, *, batch: int, chain: int,
                       n_acc: int = 8, fused: bool = True, device=None,
                       extra_meta: Optional[Dict] = None) -> str:
    """Export bench_torch.py's K-chained program (``eval/chain.py``), the K
    steps unrolled in one program.  The parameters are OPERANDS (``params``
    gives their shapes and types); batch and chain length are concrete: the
    artifact is the measurement protocol."""
    from rau_vqa_tpu_torch.eval.chain import make_serve_chain

    device = pick_device(device, "export_serve_chain")
    os.makedirs(out_dir, exist_ok=True)
    n_acc = min(int(n_acc), int(batch))     # the chain's own clamp
    params = map_tree(lambda x: x.to(device), params)
    tokens, lengths = _example_batch(cfg, batch, cfg.seq_len, device)
    feats = torch.zeros(batch, cfg.cnn_spat, cfg.cnn_dim, device=device)
    salt0 = torch.zeros((), dtype=torch.int32, device=device)
    path = _export(make_serve_chain(cfg, chain, n_acc, fused=fused),
                   (params, tokens, lengths, feats, salt0), None,
                   os.path.join(out_dir, "chain.pt2"))
    _write_meta(out_dir, {
        "format": FORMAT, "version": _KIND_VERSION["serve_chain"], "kind": "serve_chain",
        "device": device.type, "fused": bool(fused),
        "batch": int(batch), "chain": int(chain), "n_acc": n_acc,
        "inputs": {"params": "operand tree (shapes in model_config)",
                   "tokens": [int(batch), int(cfg.seq_len)], "lengths": [int(batch)],
                   "feats": [int(batch), int(cfg.cnn_spat), int(cfg.cnn_dim)],
                   "salt0": []},
        "outputs": {"salt": [], "acc": [int(cfg.n_hops) + 2, n_acc]},
        "model_config": dataclasses.asdict(cfg), "code_rev": _code_rev(),
        **(extra_meta or {})})
    return path


def export_pixels_chain(bb_params, params, cfg, backbone: str, out_dir: str, *,
                        batch: int, chain: int, qpi: int, image_size: int, n_acc: int,
                        fused: bool = True, vit_cfg=None, fused_stages=(),
                        feat_norm: bool = False, device=None,
                        extra_meta: Optional[Dict] = None) -> str:
    """Export bench_torch_pixels.py's chained from-pixels program; both
    weight trees are operands, and the backbone's variant (folded or not) is
    pinned by the tree's structure."""
    from rau_vqa_tpu_torch.eval.chain import make_pixels_chain

    device = pick_device(device, "export_pixels_chain")
    os.makedirs(out_dir, exist_ok=True)
    n_acc = min(int(n_acc), int(batch * qpi))
    params = map_tree(lambda x: x.to(device), params)
    bb_params = map_tree(lambda x: x.to(device), bb_params)
    images = torch.zeros(batch, image_size, image_size, 3, dtype=torch.uint8, device=device)
    tokens, lengths = _example_batch(cfg, batch * qpi, cfg.seq_len, device)
    salt0 = torch.zeros((), dtype=torch.int32, device=device)
    fn = make_pixels_chain(cfg, backbone, chain, qpi, n_acc, vit_cfg=vit_cfg,
                           fused_stages=tuple(fused_stages), feat_norm=feat_norm,
                           fused=fused)
    path = _export(fn, (bb_params, params, images, tokens, lengths, salt0), None,
                   os.path.join(out_dir, "chain.pt2"))
    _write_meta(out_dir, {
        "format": FORMAT, "version": _KIND_VERSION["pixels_chain"], "kind": "pixels_chain",
        "device": device.type, "fused": bool(fused), "backbone": backbone,
        "image_size": int(image_size), "batch": int(batch), "chain": int(chain),
        "qpi": int(qpi), "n_acc": n_acc, "backbone_feat_norm": bool(feat_norm),
        "fused_stages": [int(s) for s in fused_stages],
        "inputs": {"bb_params": "operand tree (variant pinned by its structure)",
                   "params": "operand tree",
                   "images_u8": [int(batch), int(image_size), int(image_size), 3],
                   "tokens": [int(batch * qpi), int(cfg.seq_len)],
                   "lengths": [int(batch * qpi)], "salt0": []},
        "outputs": {"salt": [], "acc": [int(cfg.n_hops) + 2, n_acc]},
        "model_config": dataclasses.asdict(cfg), "code_rev": _code_rev(),
        **(extra_meta or {})})
    return path


def read_meta(art_dir: str) -> Dict:
    """An artifact directory's meta.json, refusing what is not the port's:
    the JAX package's StableHLO artifacts by name, anything else as
    foreign."""
    path = os.path.join(art_dir, _META)
    if not os.path.exists(path):
        raise ValueError(f"{art_dir!r} has no {_META}: not a {FORMAT} artifact")
    with open(path) as f:
        meta = json.load(f)
    if meta.get("format") == JAX_FORMAT:
        raise ValueError(
            f"{art_dir!r} is the JAX package's artifact ({JAX_FORMAT}: StableHLO "
            f"programs for a JAX runtime); export one for this runtime with "
            f"`python -m rau_vqa_tpu_torch.cli export`")
    if meta.get("format") != FORMAT:
        raise ValueError(f"{art_dir!r} is not a {FORMAT} artifact "
                         f"(format {meta.get('format')!r})")
    if meta["version"] > EXPORT_VERSION:
        raise ValueError(f"artifact version {meta['version']} is newer than this "
                         f"runtime ({EXPORT_VERSION})")
    return meta


class ExportedPredict:
    """A callable over an artifact directory.  Loads each bucket's program on
    first use and sends each batch to the smallest bucket covering its
    longest question (exact, as the live ladder).  Inputs may be numpy
    arrays or tensors; they are moved to the artifact's device."""

    def __init__(self, art_dir: str):
        self.meta = read_meta(art_dir)
        self.art_dir = art_dir
        self.kind = self.meta.get("kind", "predict")
        if self.kind not in _KIND_VERSION:
            raise ValueError(f"unknown artifact kind {self.kind!r}")
        self.chain = self.kind in ("serve_chain", "pixels_chain")
        self.ladder = [] if self.chain else [int(t) for t in self.meta["ladder"]]
        self.device = torch.device(self.meta["device"])
        self._prefix = "predict" if self.kind == "predict" else "pixels"
        self._programs: Dict[int, torch.nn.Module] = {}

    def program(self, T: int = 0) -> torch.nn.Module:
        if T not in self._programs:
            name = "chain.pt2" if self.chain else f"{self._prefix}_T{T:02d}.pt2"
            ep = torch.export.load(os.path.join(self.art_dir, name))
            self._programs[T] = ep.module()
        return self._programs[T]

    def _tensor(self, x, dtype):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                               device=self.device).to(dtype)

    def _bucket(self, tokens, lengths):
        max_len = int(lengths.max()) if lengths.numel() else 1
        T = pick_bucket(self.ladder, max_len)
        toks = tokens[:, :T]
        if toks.shape[1] < T:      # right-pad with ZEROPAD to the bucket
            toks = torch.cat([toks, toks.new_zeros(toks.shape[0], T - toks.shape[1])], 1)
        return T, toks.contiguous()

    def __call__(self, *operands):
        """kind "predict": (tokens [B, <=seq_len], lengths [B], feats
        [B, S, D]); "pixels_predict": (images [B, s, s, 3] uint8, tokens,
        lengths); each returns (tab_pred [H+2, B, A], tab_att [H+2, B, S]).
        The chain kinds take their operands as the live chain does and
        return (salt, acc)."""
        if self.chain:
            return self.program()(*operands)
        with torch.no_grad():
            if self.kind == "pixels_predict":
                images, tokens, lengths = operands
                images = self._tensor(images, torch.uint8)
                s = int(self.meta["image_size"])
                if images.ndim != 4 or tuple(images.shape[1:]) != (s, s, 3):
                    raise ValueError(f"this artifact expects images [b, {s}, {s}, 3] "
                                     f"uint8; got {tuple(images.shape)}")
                lengths = self._tensor(lengths, torch.int32)
                T, toks = self._bucket(self._tensor(tokens, torch.int32), lengths)
                return self.program(T)(images, toks, lengths)
            tokens, lengths, feats = operands
            lengths = self._tensor(lengths, torch.int32)
            T, toks = self._bucket(self._tensor(tokens, torch.int32), lengths)
            return self.program(T)(toks, lengths, self._tensor(feats, torch.float32))


def load_exported(art_dir: str) -> ExportedPredict:
    return ExportedPredict(art_dir)


def load_or_build_chain_artifact(art_dir: str, build, expect_meta: Dict,
                                 log=print) -> ExportedPredict:
    """The benches' ``--artifact``: load the chained program from
    ``art_dir``, building it with ``build()`` when the directory is missing
    or its meta differs from ``expect_meta`` (a changed flag rebuilds).

    ``expect_meta`` must pin "model_config"; the git revision is pinned
    where both the artifact and this checkout know theirs.  Values compare
    through JSON, so tuples equal the lists meta.json stores."""
    expect = json.loads(json.dumps(expect_meta))
    if "model_config" not in expect:
        raise ValueError("expect_meta must pin model_config (stale-artifact guard)")
    rev = _code_rev()
    meta_path = os.path.join(art_dir, _META)
    why = None
    if not os.path.exists(meta_path):
        why = "missing"
    else:
        with open(meta_path) as f:
            meta = json.load(f)
        if rev != "unknown" and meta.get("code_rev", "unknown") != "unknown":
            expect["code_rev"] = rev
        stale = [k for k, v in expect.items() if meta.get(k) != v]
        if stale:
            why = "protocol/model mismatch: " + ", ".join(stale)
    if why is not None:
        log(f"bench: building chain artifact at {art_dir} ({why})")
        t0 = time.perf_counter()
        build()
        log(f"bench: artifact built in {time.perf_counter() - t0:.1f}s (torch.export)")
    return load_exported(art_dir)
