"""Checkpoint save/restore with optimizer state.

Counterpart of ``rau_vqa_tpu/utils/checkpoint.py``.  A snapshot carries the
params, the Adam moments, the step count and the seed of the train state
(the reference snapshots only the three flat parameter vectors and never
restores them, Ours_SS/LstmAttCtrlGradNoiseDontSelect.lua:349-355,
:1188-1197), so training is truly resumable.

The port's format: ``snapshot_iter{it:06d}_epoch{epoch:.2f}.pt``, which is
``torch.save`` of a tree of CPU tensors and ints (it loads with
``weights_only=True``), beside the JAX package's JSON sidecar (lr, mult_lr,
loss_ema, the model config ...) and ``LATEST`` file.  ``load_checkpoint``
also reads the JAX package's ``snapshot_….msgpack`` files, through
``utils/msgpack_flax.py``.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import re
from typing import Any, Dict, Optional, Tuple

import torch

from rau_vqa_tpu_torch.config import ModelConfig
from rau_vqa_tpu_torch.convert import map_tree, params_from_jax
from rau_vqa_tpu_torch.roadmap import still_to_port
from rau_vqa_tpu_torch.utils import msgpack_flax

SUFFIX = ".pt"
JAX_SUFFIX = ".msgpack"


def checkpoint_name(step: int, epoch: float) -> str:
    return f"snapshot_iter{step:06d}_epoch{epoch:.2f}"


# Background writer: ONE thread so successive saves serialize in order
# (LATEST always names a fully written snapshot; keep_last pruning never
# races a write).  ThreadPoolExecutor threads are non-daemon, so pending
# writes complete even if the interpreter exits without a flush.
_writer = None
_pending = []


def _get_writer():
    global _writer
    if _writer is None:
        from concurrent.futures import ThreadPoolExecutor
        _writer = ThreadPoolExecutor(max_workers=1,
                                     thread_name_prefix="ckpt-writer")
    return _writer


def _failed_future(err: BaseException):
    """An already-resolved future carrying ``err`` — used to re-queue a
    collected-but-not-yet-raised write error when a flush is interrupted."""
    from concurrent.futures import Future
    fut: "Future[None]" = Future()
    fut.set_exception(err)
    return fut


def flush_checkpoint_writes() -> None:
    """Block until every background checkpoint write has landed; then
    re-raise the first write error (all futures are waited before any
    raise, so no write is abandoned mid-flight).  Call before reading
    ``latest_checkpoint`` in the saving process, and before treating
    training artifacts as durable."""
    global _pending
    pending, _pending = _pending, []
    first_err = None
    i = 0   # the handler below slices pending[i:]; an interrupt landing
    try:    # before the first loop binding must re-queue everything
        for i, fut in enumerate(pending):
            try:
                fut.result()
            except Exception as e:    # wait all, raise first; Exception
                if first_err is None:  # (not BaseException) so a Ctrl-C
                    first_err = e      # delivered here still aborts...
    except BaseException:
        # ...but an abort must not abandon the rest: push un-waited futures
        # back so a later flush still waits them and still sees first_err
        _pending = pending[i:] + _pending
        if first_err is not None:
            _pending.insert(0, _failed_future(first_err))
        raise
    if first_err is not None:
        raise first_err


def _step_of(fname: str) -> int:
    m = re.search(r"iter(\d+)", fname)
    return int(m.group(1)) if m else -1


def _write(ckpt_dir: str, name: str, path: str, host_tree: Any,
           meta: Dict, keep_last: Optional[int]) -> None:
    buf = io.BytesIO()   # a file name would enter the archive's records
    torch.save(host_tree, buf)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, path)
    with open(os.path.join(ckpt_dir, name + ".json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(ckpt_dir, "LATEST"), "w") as f:
        f.write(name)
    if keep_last is not None and keep_last > 0:
        # sort by the parsed step: lexicographic order misranks steps past
        # the 6-digit zero-padding (iter1000000 < iter999999 as strings)
        snaps = sorted((f for f in os.listdir(ckpt_dir)
                        if f.startswith("snapshot_") and f.endswith(SUFFIX)),
                       key=_step_of)
        for old in snaps[:-keep_last]:
            for suffix in (SUFFIX, ".json"):
                stale = os.path.join(ckpt_dir, old[:-len(SUFFIX)] + suffix)
                if os.path.exists(stale):
                    os.remove(stale)


def to_host(x):
    """A detached CPU copy of a tensor; any other leaf as it is."""
    return x.detach().to("cpu", copy=True) if torch.is_tensor(x) else x


def save_checkpoint(ckpt_dir: str, step: int, epoch: float, tree: Any,
                    extra: Optional[Dict] = None,
                    keep_last: Optional[int] = None,
                    background: bool = False) -> str:
    """Save a tree of dicts and lists of tensors and ints; returns the path.
    With ``keep_last`` only the newest N snapshots are kept.

    ``background=True`` moves serialization and disk IO to a single writer
    thread and returns at once.  The copy to the host still happens here,
    before the caller's next step.  Use :func:`flush_checkpoint_writes`
    before reading the snapshot back in the same process.

    Every save first drains pending background writes: no race on LATEST
    and keep_last pruning, and at most one host copy of the state in
    flight."""
    flush_checkpoint_writes()
    os.makedirs(ckpt_dir, exist_ok=True)
    name = checkpoint_name(step, epoch)
    path = os.path.join(ckpt_dir, name + SUFFIX)
    host_tree = map_tree(to_host, tree)
    meta = {"step": step, "epoch": epoch, **(extra or {})}
    if background:
        _pending.append(_get_writer().submit(
            _write, ckpt_dir, name, path, host_tree, meta, keep_last))
    else:
        _write(ckpt_dir, name, path, host_tree, meta, keep_last)
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """Newest fully written snapshot path (the port's or the JAX
    package's), or None.  Flushes this process's pending background writes
    first, so a caller that just issued an async save always sees it."""
    flush_checkpoint_writes()
    marker = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(marker):
        return None
    with open(marker) as f:
        name = f.read().strip()
    for suffix in (SUFFIX, JAX_SUFFIX):
        path = os.path.join(ckpt_dir, name + suffix)
        if os.path.exists(path):
            return path
    return None


def _walk(template: Any, tree: Any, where: str = ""):
    """(key path, template leaf, tree leaf) pairs; raises where the two
    trees' structures differ."""
    if isinstance(template, dict):
        if not isinstance(tree, dict) or set(tree) != set(template):
            raise ValueError(f"checkpoint structure mismatch at {where or '/'}: "
                             f"expected keys {sorted(template)}, snapshot has "
                             f"{sorted(tree) if isinstance(tree, dict) else type(tree)}")
        for k in template:
            yield from _walk(template[k], tree[k], f"{where}/{k}")
    elif isinstance(template, (list, tuple)):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(template):
            raise ValueError(f"checkpoint structure mismatch at {where}: "
                             f"expected {len(template)} entries")
        for i, (t, r) in enumerate(zip(template, tree)):
            yield from _walk(t, r, f"{where}/{i}")
    else:
        yield where, template, tree


def validate_tree_shapes(template: Any, tree: Any) -> None:
    """Raise when ``tree``'s structure, leaf shapes or leaf types differ
    from ``template``'s: a config/snapshot mismatch must fail here, not
    evaluate garbage."""
    for where, t, r in _walk(template, tree):
        if torch.is_tensor(t):
            if not torch.is_tensor(r) or t.shape != r.shape:
                raise ValueError(
                    f"checkpoint shape mismatch at {where}: expected "
                    f"{tuple(t.shape)} from config, snapshot has "
                    f"{tuple(r.shape) if torch.is_tensor(r) else type(r)} — "
                    f"rebuild the model with the snapshot's config")
            if t.dtype != r.dtype:
                raise ValueError(f"checkpoint type mismatch at {where}: "
                                 f"expected {t.dtype}, snapshot has {r.dtype}")


def checkpoint_meta(path: str) -> Dict:
    """The sidecar meta dict for a snapshot (empty if absent)."""
    meta_path = os.path.splitext(path)[0] + ".json"
    if meta_path != path and os.path.exists(meta_path):
        with open(meta_path) as f:
            return json.load(f)
    return {}


# fields of the JAX package's ModelConfig that the port does not have:
# accepted at these values (or any, where None)
_JAX_ONLY_FIELDS = {"param_dtype": ("float32",),
                    "matmul_precision": ("highest", "default"),
                    "fused_train_block": None, "fused_train_impl": None}


def model_config_from_meta(mc: Dict, *, from_jax: bool = False) -> ModelConfig:
    """The ``ModelConfig`` a snapshot's sidecar records (``model_config``).

    A JAX package's sidecar may carry its own fields: ``param_dtype`` must
    be float32 (the port keeps float32 params), ``matmul_precision``
    "highest" or "default" (the port's float32 products are full float32;
    its bf16 ones come from ``compute_dtype``), ``fused_train_block`` and
    ``fused_train_impl`` (its Pallas tiling) are dropped.  So is its
    ``fused_train_bwd``: the JAX package picks its backward by what Mosaic
    compiles, and both of the port's give the same gradient."""
    mc = dict(mc)
    for name, allowed in _JAX_ONLY_FIELDS.items():
        v = mc.pop(name, None)
        if v is not None and allowed is not None and v not in allowed:
            raise ValueError(f"snapshot model_config {name}={v!r}: the port "
                             f"runs only {' / '.join(allowed)}")
    if from_jax:
        mc.pop("fused_train_bwd", None)
    known = {f.name for f in dataclasses.fields(ModelConfig)}
    unknown = sorted(set(mc) - known)
    if unknown:
        raise ValueError(f"snapshot model_config has fields the port does "
                         f"not know: {unknown}")
    return ModelConfig(**mc)


def _from_state_dict(template: Any, raw: Any, where: str = "") -> Any:
    """``raw`` (flax's state dict: lists stored as {"0": ..., "1": ...})
    in ``template``'s structure."""
    if isinstance(template, dict):
        if not isinstance(raw, dict) or set(raw) != set(template):
            raise ValueError(f"JAX snapshot structure mismatch at "
                             f"{where or '/'}: expected keys {sorted(template)}")
        return {k: _from_state_dict(template[k], raw[k], f"{where}/{k}")
                for k in template}
    if isinstance(template, (list, tuple)):
        keys = [str(i) for i in range(len(template))]
        if not isinstance(raw, dict) or sorted(raw) != sorted(keys):
            raise ValueError(f"JAX snapshot structure mismatch at {where}: "
                             f"expected {len(template)} entries")
        return [_from_state_dict(t, raw[k], f"{where}/{k}")
                for t, k in zip(template, keys)]
    return raw


def _from_jax_snapshot(path: str, template: Dict, meta: Dict) -> Dict:
    """A JAX package's TrainState snapshot (params, opt, step, rng) as the
    port's train-state tree (params, opt, step, seed)."""
    with open(path, "rb") as f:
        raw = msgpack_flax.loads(f.read())
    if "backbone" in raw.get("params", {}) or meta.get("train_backbone"):
        raise NotImplementedError(
            f"{path} carries a fine-tuned backbone group: "
            + still_to_port("backbone fine-tuning", "fine-tuning"))
    if "model_config" in meta:
        model_config_from_meta(meta["model_config"], from_jax=True)
    params = params_from_jax(_from_state_dict(template["params"],
                                              raw["params"], "/params"))
    opt = {}
    for g, t in template["opt"].items():
        r = raw["opt"][g]
        opt[g] = {"m": params_from_jax(_from_state_dict(t["m"], r["m"])),
                  "v": params_from_jax(_from_state_dict(t["v"], r["v"])),
                  "t": r["t"].clone()}
    print(f"{os.path.basename(path)}: the JAX snapshot's PRNG key has no "
          f"counterpart in the port's train state, which keeps its seed "
          f"{template['seed']}", flush=True)
    return {"params": params, "opt": opt, "step": int(raw["step"]),
            "seed": template["seed"]}


def load_checkpoint(path: str, template: Any) -> Tuple[Any, Dict]:
    """(tree, sidecar meta) of a snapshot saved by ``save_checkpoint``, or
    of the JAX package's ``.msgpack`` TrainState snapshot (then ``template``
    is the port's train state as a dict, and the tree comes back in its
    structure); leaves on the CPU.  ``template`` gives the structure, shapes
    and types the snapshot must have."""
    meta = checkpoint_meta(path)
    if path.endswith(JAX_SUFFIX):
        tree = _from_jax_snapshot(path, template, meta)
    else:
        tree = torch.load(path, map_location="cpu", weights_only=True)
    validate_tree_shapes(template, tree)
    return tree, meta
