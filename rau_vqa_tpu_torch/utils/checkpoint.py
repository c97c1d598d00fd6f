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
``utils/msgpack_flax.py``.  A fine-tuned snapshot carries a 4th parameter
group, ``"backbone"``; ``load_backbone_group`` takes it out of either
format.
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


def _read_msgpack(path: str) -> Dict:
    with open(path, "rb") as f:
        return msgpack_flax.loads(f.read())


def _read_snapshot(path: str) -> Dict:
    """A snapshot as stored, of either format."""
    if path.endswith(JAX_SUFFIX):
        return _read_msgpack(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def _from_jax_snapshot(path: str, raw: Dict, template: Dict, meta: Dict) -> Dict:
    """A JAX package's TrainState snapshot ``raw`` (params, opt, step, rng)
    as the port's train-state tree (params, opt, step, seed), in
    ``template``'s groups: a fine-tuned snapshot's backbone group comes
    along where the template has one and is left out where it has not."""
    if "model_config" in meta:
        model_config_from_meta(meta["model_config"], from_jax=True)
    groups = {k: v for k, v in raw["params"].items() if k in template["params"]}
    params = params_from_jax(_from_state_dict(template["params"], groups, "/params"))
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


def load_checkpoint(path: str, template: Any, *,
                    backbone: Optional[str] = None) -> Tuple[Any, Dict]:
    """(tree, sidecar meta) of a snapshot saved by ``save_checkpoint``, or
    of the JAX package's ``.msgpack`` TrainState snapshot (then ``template``
    is the port's train state as a dict, and the tree comes back in its
    structure); leaves on the CPU.  ``template`` gives the structure, shapes
    and types the snapshot must have; a fine-tuned snapshot's backbone group
    is left out for a template of the head's groups alone, as the JAX
    package's restore leaves it (the service, ``eval`` and ``ask``).  With
    ``backbone`` (its kind, as ``load_backbone_group`` takes it) that group
    comes back too, as ``tree["params"]["backbone"]``, from the same read."""
    meta = checkpoint_meta(path)
    raw = _read_snapshot(path)
    if path.endswith(JAX_SUFFIX):
        tree = _from_jax_snapshot(path, raw, template, meta)
    else:
        tree = raw
        if (_groups(tree) and "backbone" in tree["params"]
                and not (_groups(template) and "backbone" in template["params"])):
            tree = {**tree, "params": {k: v for k, v in tree["params"].items()
                                       if k != "backbone"},
                    "opt": {k: v for k, v in tree["opt"].items() if k != "backbone"}}
    validate_tree_shapes(template, tree)
    if backbone is not None:
        tree["params"]["backbone"] = _backbone_group(raw.get("params", {}), backbone, path)
    return tree, meta


def _groups(tree) -> bool:
    """Whether ``tree`` is a train state's, its params a dict of groups."""
    return isinstance(tree, dict) and isinstance(tree.get("params"), dict)


def has_backbone_group(path: str) -> bool:
    """Whether a snapshot carries a fine-tuned backbone group: its sidecar's
    ``train_backbone``, or the snapshot itself where there is no sidecar."""
    meta = checkpoint_meta(path)
    if "train_backbone" in meta:
        return bool(meta["train_backbone"])
    return "backbone" in _read_snapshot(path).get("params", {})


def _lists(raw: Any) -> Any:
    """A flax state dict's lists (stored as {"0": ..., "1": ...}) as lists."""
    if isinstance(raw, dict):
        if raw and all(k.isdigit() for k in raw) and sorted(map(int, raw)) == list(
                range(len(raw))):
            return [_lists(raw[str(i)]) for i in range(len(raw))]
        return {k: _lists(v) for k, v in raw.items()}
    if isinstance(raw, (list, tuple)):
        return [_lists(v) for v in raw]
    return raw


# the top-level keys of each conv backbone's tree, and of every tower's
_CONV_KEYS = {"vgg16": {"convs"}, "resnet101": {"conv1", "stages"}}
_TOWER_KEYS = {"patch_embed", "pos_embed", "blocks", "ln_final"}


def _backbone_keys() -> Dict:
    from rau_vqa_tpu_torch.models import pipeline
    return {**_CONV_KEYS, **{t: _TOWER_KEYS for t in pipeline.TOWERS}}


def load_backbone_group(path: str, kind: str, *, fold: bool = True) -> Dict:
    """The fine-tuned ``"backbone"`` group of a 4-group snapshot, the port's
    ``.pt`` or the JAX package's ``.msgpack``, as a tree of CPU tensors
    (``rau_vqa_tpu/utils/checkpoint.py:184-260``).  ``kind``: ``"vgg16"``,
    ``"resnet101"`` or ``"vit"`` (the sidecar's ``backbone``).  A ResNet's
    own structure decides: a plain (conv + BN) tree is folded with ``fold``
    (the serving form, exact at inference), a folded one comes as it is."""
    return _backbone_group(_read_snapshot(path).get("params", {}), kind, path, fold=fold)


def _backbone_group(params: Dict, kind: str, path: str, *, fold: bool = True) -> Dict:
    """``load_backbone_group`` of a snapshot's params already read from
    ``path``."""
    kinds = _backbone_keys()
    if kind not in kinds:
        raise ValueError(f"unknown backbone kind {kind!r}")
    raw = params.get("backbone")
    if raw is None:
        raise ValueError(f"{path} has no 'backbone' parameter group — not a "
                         f"fine-tuned snapshot (train with --train-backbone "
                         f"to produce one; a torchvision or timm state dict "
                         f"is read from a .pth)")
    bb = params_from_jax(_lists(raw))
    keys = set(bb) if isinstance(bb, dict) else set()
    if keys - ({"bn1"} if kind == "resnet101" else set()) != kinds[kind]:
        raise ValueError(f"{path}: its backbone group (keys {sorted(keys)}) is not "
                         f"a {kind} tree")
    if kind == "resnet101" and fold and "bn1" in bb:
        from rau_vqa_tpu_torch.models.backbones.resnet import fold_batchnorm
        bb = fold_batchnorm(bb)
    return bb
