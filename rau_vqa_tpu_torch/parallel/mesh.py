"""The ('data', 'model') device mesh: one process a device, DP and TP.

Counterpart of ``rau_vqa_tpu/parallel/mesh.py``.  JAX's mesh is one process
holding many devices, and GSPMD inserts the collectives; a PyTorch mesh is a
``torch.distributed`` world with one process a device, and this module makes
the collectives itself:

- ``make_mesh(n_data, n_model)`` lays the world's ranks out as an
  ``[n_data, n_model]`` grid in process-major order (rank ``d * n_model +
  m`` at ``(d, m)``, as ``make_multihost_mesh`` orders JAX's devices) and
  builds the data groups (one model index, every data index) and the model
  groups (one data index, every model index).  The mesh spans the whole
  world: a process-per-device world has no idle device to leave out.
- DP: each rank runs the step's kernels on its rows of the global batch;
  the gradients and metrics are all-reduced over the data group, then the
  single-process step's noise, clip and Adam run on the same values.
- TP (``param_pspecs(tp=True)``): the LSTM gate projections and the
  classifier are stored as this model rank's slice of their output dim,
  with their Adam moments.  The kernels take whole weights, so the step and
  the predict functions gather them over the model group first (JAX does
  the same in effect: GSPMD cannot split a ``pallas_call`` and gives it
  replicated operands); each sharded leaf's gradient is then cut to the
  rank's slice, and its squared norm is all-reduced over the model group
  where a norm spans the group (the clip, the zero-signal test, the trust
  ratio).

Every collective is an ``all_reduce`` (gathers: a zero-filled buffer in
which each rank writes its own part), the one collective that NCCL, gloo
on CUDA tensors and gloo on the CPU all take; under gloo each rank waits
for its device's work before a collective reads its tensors.  Dropout is
keyed by global row (``rau_forward(rows=)``), so every row gets the masks
of the single-process step on the global batch.
"""

from __future__ import annotations

import dataclasses
import os
import socket
from datetime import timedelta
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from rau_vqa_tpu_torch.config import ModelConfig, TrainConfig
from rau_vqa_tpu_torch.convert import MemoRecent, map_tree, tree_leaves
from rau_vqa_tpu_torch.train.optim import add_gradient_noise
from rau_vqa_tpu_torch.train.trainer import (
    StepReductions,
    TrainState,
    _SUM_METRICS,
    make_train_step,
)

AXES = ("data", "model")
# how long a collective waits for the other ranks before it raises
COLLECTIVE_TIMEOUT_S = 600.0


class P:
    """A leaf's partition spec, as JAX's ``PartitionSpec``: one entry a dim,
    ``"model"`` where the dim is split over the model axis, ``"data"`` over
    the data axis, None where it is whole.  A leaf of ``map_tree`` (not a
    tuple), compared equal to the tuple of its entries."""

    __slots__ = ("axes",)

    def __init__(self, *axes):
        self.axes = tuple(axes)

    def __iter__(self):
        return iter(self.axes)

    def __len__(self):
        return len(self.axes)

    def __getitem__(self, i):
        return self.axes[i]

    def __eq__(self, other):
        if not isinstance(other, (P, tuple)):
            return NotImplemented
        return tuple(self) == tuple(other)

    def __hash__(self):
        return hash(self.axes)

    def __repr__(self):
        return f"P{self.axes!r}"

    def model_dim(self) -> Optional[int]:
        """The dim split over 'model', None if none is."""
        return self.axes.index("model") if "model" in self.axes else None


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (JAX's ``NamedSharding``)."""
    mesh: "Mesh"
    spec: P


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's view of the mesh: ``shape == {"data": n_data, "model":
    n_model}``, the grid of ranks ``devices`` ``[n_data, n_model]``, this
    rank's coordinates, its data and model groups, its device and the
    world's backend."""
    devices: np.ndarray
    rank: int
    data_rank: int
    model_rank: int
    data_group: Any
    model_group: Any
    device: torch.device
    backend: str

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(AXES, self.devices.shape))

    @property
    def n_data(self) -> int:
        return int(self.devices.shape[0])

    @property
    def n_model(self) -> int:
        return int(self.devices.shape[1])

    @property
    def writer(self) -> bool:
        """Whether this rank writes the run's files (rank 0 alone)."""
        return self.rank == 0


# ---------------------------------------------------------------------------
# The world
# ---------------------------------------------------------------------------

_WORLD: Dict[str, Any] = {}   # what init_distributed chose: device, backend


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_distributed(backend: Optional[str] = None, device=None) -> torch.device:
    """Join the ``torch.distributed`` world that ``torchrun`` (``python -m
    torch.distributed.run``) describes in ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and
    ``MASTER_PORT``; without them, a world of one on a free local port.
    Returns this rank's device: ``cuda:LOCAL_RANK`` (made current) unless
    ``device="cpu"`` asks for the CPU.  The backend, printed: ``nccl`` when
    every rank of the host has a card of its own, ``gloo`` when ranks share
    a card (they then share ``cuda:LOCAL_RANK % cards``) or run on the CPU.
    It raises where no card is present or NCCL is asked for ranks that
    share one; it never moves work to the CPU unasked."""
    env = os.environ
    rank = int(env.get("RANK", "0"))
    world = int(env.get("WORLD_SIZE", "1"))
    local_rank = int(env.get("LOCAL_RANK", "0"))
    local_world = int(env.get("LOCAL_WORLD_SIZE", str(world)))
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device is available; pass "
                               "device='cpu' to run the ranks on the CPU")
        cards = torch.cuda.device_count()
        shared = local_world > cards
        dev = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(dev)
        chosen = "gloo" if shared else "nccl"
        if backend == "nccl" and shared:
            raise ValueError(f"init_distributed: NCCL cannot run {local_world} ranks on "
                             f"{cards} card(s) (two ranks may not share a device)")
    elif dev.type == "cpu":
        chosen = "gloo"
        if backend not in (None, "gloo"):
            raise ValueError(f"init_distributed: backend {backend!r} cannot run on the CPU")
    else:
        raise ValueError(f"init_distributed: unsupported device {dev}")
    backend = backend or chosen
    if not dist.is_initialized():
        addr = env.get("MASTER_ADDR", "127.0.0.1")
        port = env.get("MASTER_PORT") or (str(_free_port()) if world == 1 else None)
        if port is None:
            raise RuntimeError("init_distributed: WORLD_SIZE > 1 needs MASTER_PORT "
                               "(launch with python -m torch.distributed.run)")
        kw = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}", rank=rank,
                                world_size=world, timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S), **kw)
    _WORLD.update(device=dev, backend=dist.get_backend())
    print(f"init_distributed: rank {rank} of {world}, backend {dist.get_backend()}, "
          f"device {dev}", flush=True)
    return dev


def make_mesh(n_data: int = -1, n_model: int = 1, devices: Optional[Sequence[int]] = None
              ) -> Mesh:
    """('data', 'model') mesh over the world's ranks (``devices``: their
    order, ``range(world)`` by default), process-major.  Every rank calls it
    with the same arguments (it creates the process groups)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: call init_distributed() first")
    world = dist.get_world_size()
    devices = list(range(world)) if devices is None else list(devices)
    if n_data < 0:
        n_data = len(devices) // n_model
    if n_data * n_model > len(devices):
        raise ValueError(f"need {n_data * n_model} devices, have {len(devices)}")
    if n_data * n_model != world or sorted(devices) != list(range(world)):
        raise ValueError(
            f"a mesh of {n_data} x {n_model} leaves ranks of the world of {world} idle: "
            f"one process a device, the mesh spans the whole world")
    grid = np.asarray(devices).reshape(n_data, n_model)
    rank = dist.get_rank()
    d, m = (int(v[0]) for v in np.nonzero(grid == rank))
    data_group = model_group = None
    # every rank creates every group, in the same order
    for mi in range(n_model):
        g = dist.new_group([int(r) for r in grid[:, mi]])
        if mi == m:
            data_group = g
    for di in range(n_data):
        g = dist.new_group([int(r) for r in grid[di]])
        if di == d:
            model_group = g
    dev = _WORLD.get("device")
    if dev is None:
        raise RuntimeError("make_mesh: the world was not joined by init_distributed()")
    return Mesh(grid, rank, d, m, data_group, model_group, dev, dist.get_backend())


def mesh_from_config(mc) -> Mesh:
    """The Trainer's mesh from a ``MeshConfig`` (CLI --mesh-data /
    --mesh-model / --tp).  A world of several processes gets the
    process-major multihost layout."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world > 1:
        mesh = make_multihost_mesh(n_model=mc.model_axis)
        if mc.data_axis > 0 and mc.data_axis != mesh.shape["data"]:
            # the layout spans every rank; dropping an explicit --mesh-data
            # would change the per-shard batch behind the user's back
            raise ValueError(
                f"--mesh-data {mc.data_axis} conflicts with the "
                f"multihost layout: {world} devices / "
                f"model_axis {mc.model_axis} gives data={mesh.shape['data']} "
                f"(multi-process meshes always use every device; omit "
                f"--mesh-data or set it to {mesh.shape['data']})")
        return mesh
    return make_mesh(n_data=mc.data_axis, n_model=mc.model_axis)


def make_multihost_mesh(n_model: int = 1) -> Mesh:
    """Multi-host ('data', 'model') mesh, ranks process-major: each host's
    ranks are contiguous along 'data', and TP ('model') stays within a
    host's cards: n_model must divide the ranks a host (``LOCAL_WORLD_SIZE``)."""
    world = dist.get_world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    if local % n_model:
        raise ValueError(f"{local} chips/host not divisible by model axis {n_model}")
    return make_mesh(n_data=world // n_model, n_model=n_model)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def _ready(mesh: Mesh, t: torch.Tensor) -> None:
    """gloo reads CUDA tensors on its own stream: wait for the device's work."""
    if t.is_cuda and mesh.backend == "gloo":
        torch.cuda.current_stream(t.device).synchronize()


def all_reduce_(mesh: Mesh, t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (every rank of the group calls it)."""
    _ready(mesh, t)
    dist.all_reduce(t, group=group)
    return t


def _wire(t: torch.Tensor) -> torch.dtype:
    """The type a gather carries ``t`` in: float32 for half types (exact)."""
    return torch.float32 if t.dtype in (torch.bfloat16, torch.float16) else t.dtype


def gather_rows(mesh: Mesh, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The data group's ``x`` (each rank's rows of one batch, in equal
    parts along ``dim``) joined in row order, on every rank."""
    n, b = mesh.n_data, x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * b
    buf = torch.zeros(shape, dtype=_wire(x), device=x.device)
    buf.narrow(dim, mesh.data_rank * b, b).copy_(x)
    return all_reduce_(mesh, buf, mesh.data_group).to(x.dtype)


def barrier(mesh: Mesh) -> None:
    """Every rank of the world reaches this point before any goes on."""
    all_reduce_(mesh, torch.zeros(1, device=mesh.device), None)


def world_sum(mesh: Mesh, values: Sequence[float]) -> np.ndarray:
    """``values`` summed over the world, on every rank (host floats)."""
    t = torch.tensor(list(values), dtype=torch.float64, device=mesh.device)
    return all_reduce_(mesh, t, None).cpu().numpy()


# ---------------------------------------------------------------------------
# Sharding rules
# ---------------------------------------------------------------------------

def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def _tp_rule(path: Tuple, leaf, n_model: int = 0) -> P:
    """Tensor-parallel spec for one parameter leaf, keyed by its tree path:
    output-dim sharding on 'model' for the wide projections.  A leaf whose
    sharded dim does not divide by the model axis is replicated."""
    name = path[-1]          # 'w'/'b' or 'wi'/'bi'/'wh'/'bh' or 'lookup'
    parent = next((k for k in reversed(path[:-1]) if isinstance(k, str)), None)
    # LSTM gate projections: [in, 4R] / [4R]
    if name in ("wi", "wh"):
        spec = P(None, "model")
    elif name in ("bi", "bh"):
        spec = P("model")
    # classifier [M, A]: the widest product in the model
    elif parent == "cls":
        spec = P(None, "model") if name == "w" else P("model")
    else:
        # everything else (embeddings, small projections) replicated
        return P()
    if n_model > 1:
        shape = tuple(getattr(leaf, "shape", ()))
        for i, axis in enumerate(spec):
            if axis == "model" and shape[i] % n_model != 0:
                return P()
    return spec


def param_pspecs(params: Any, *, tp: bool, mesh: Optional[Mesh] = None) -> Any:
    """Spec tree matching ``params`` (whole leaves: the tree before
    ``place_state`` cuts it)."""
    if not tp:
        return map_tree(lambda _: P(), params)
    n_model = mesh.n_model if mesh is not None else 0
    return _map_with_path(lambda path, leaf: _tp_rule(path, leaf, n_model), params)


def state_shardings(mesh: Mesh, state: TrainState, *, tp: bool) -> TrainState:
    """``NamedSharding`` tree of the whole ``TrainState``: Adam moments
    mirror their parameters; step counts and seed replicated."""
    pspecs = param_pspecs(state.params, tp=tp, mesh=mesh)

    def ns(spec):
        return NamedSharding(mesh, spec)
    params_sh = map_tree(ns, pspecs)
    opt_sh = {g: {"m": map_tree(ns, pspecs[g]), "v": map_tree(ns, pspecs[g]),
                  "t": ns(P())} for g in state.opt}
    return TrainState(params=params_sh, opt=opt_sh, step=ns(P()), seed=ns(P()))


def _split(sh: NamedSharding) -> Optional[Tuple[int, int, int]]:
    """(dim, this rank's part, parts) of a leaf split over 'model', None
    for a whole one."""
    dim = sh.spec.model_dim()
    if dim is None or sh.mesh.n_model == 1:
        return None
    return dim, sh.mesh.model_rank, sh.mesh.n_model


def place_tree(tree, shardings):
    """A tree of whole leaves (on any device) placed by its shardings: on
    this rank's device, a leaf split over 'model' cut to this rank's part."""
    def place(x, sh):
        x = torch.as_tensor(x).to(sh.mesh.device)
        cut = _split(sh)
        if cut is None:
            return x
        dim, part, parts = cut
        k = x.shape[dim] // parts
        return x.narrow(dim, part * k, k).contiguous()
    return map_tree(place, tree, shardings)


def _pairs(tree, other) -> Tuple[list, list]:
    """The leaves of ``tree`` and of ``other`` (the same structure, dict
    keys in any order) side by side, in ``tree``'s order."""
    a, b = [], []
    map_tree(lambda x, y: (a.append(x), b.append(y)), tree, other)
    return a, b


def gather_tree(tree, shardings):
    """The inverse of ``place_tree``: every leaf whole on every rank, the
    split ones gathered over their model group in one collective."""
    leaves, shs = _pairs(tree, shardings)
    cut = [(i, _split(sh)) for i, sh in enumerate(shs)]
    cut = [(i, c) for i, c in cut if c is not None]
    if not cut:
        return tree
    mesh = shs[cut[0][0]].mesh
    whole = []
    for i, (dim, _, parts) in cut:
        shape = list(leaves[i].shape)
        shape[dim] *= parts
        whole.append(shape)
    sizes = [int(np.prod(s)) for s in whole]
    buf = torch.zeros(sum(sizes), dtype=torch.float32, device=leaves[cut[0][0]].device)
    views = list(torch.split(buf, sizes))
    for (i, (dim, part, _)), v, shape in zip(cut, views, whole):
        k = leaves[i].shape[dim]
        v.view(shape).narrow(dim, part * k, k).copy_(leaves[i])
    all_reduce_(mesh, buf, mesh.model_group)
    out = list(leaves)
    for (i, _), v, shape in zip(cut, views, whole):
        out[i] = v.view(shape).to(leaves[i].dtype)
    it = iter(out)
    return map_tree(lambda _: next(it), tree)


def replicate_tree(mesh: Mesh, tree):
    """A tree whole on every rank's device (the frozen backbone, and any
    other weight tree every rank reads whole)."""
    return map_tree(lambda x: torch.as_tensor(x).to(mesh.device), tree)


def _state_tree(state: TrainState) -> Dict:
    return {"params": state.params, "opt": state.opt}


def place_state(mesh: Mesh, state: TrainState, *, tp: bool = False) -> TrainState:
    """A ``TrainState`` of whole leaves placed on the mesh: a TP leaf and
    its Adam moments as this model rank's slice, everything else whole."""
    sh = state_shardings(mesh, state, tp=tp)
    t = place_tree(_state_tree(state), _state_tree(sh))
    return TrainState(t["params"], t["opt"], int(state.step), int(state.seed))


def gather_state(state: TrainState, shardings: TrainState) -> TrainState:
    """A placed state's whole leaves on every rank (a collective over each
    model group): what a checkpoint holds."""
    t = gather_tree(_state_tree(state), _state_tree(shardings))
    return TrainState(t["params"], t["opt"], state.step, state.seed)


# ---------------------------------------------------------------------------
# The batch
# ---------------------------------------------------------------------------

def batch_pspec() -> P:
    return P("data")


def rank_rows(mesh: Mesh, n: int, accum: int = 1):
    """This rank's rows of a global batch of ``n``: a slice, the data
    rank's contiguous ``n / n_data`` rows; with ``accum = k > 1`` an index,
    its part of each of the k microbatches (microbatch i = rows [i n / k,
    (i + 1) n / k), as the single-process step splits the batch), so that
    its own microbatch i holds global microbatch i's rows of this rank."""
    n_data = mesh.n_data
    b = n // n_data
    if accum <= 1:
        return slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)
    mb = n // accum // n_data
    return np.concatenate([np.arange(i * (n // accum) + mesh.data_rank * mb,
                                     i * (n // accum) + (mesh.data_rank + 1) * mb)
                           for i in range(accum)])


def _check_rows(mesh: Mesh, n: int, accum: int, local: bool) -> int:
    """The divisor of a batch's leading dim on this mesh; raises the JAX
    package's errors where it does not divide."""
    n_data = mesh.n_data
    local_div = n_data
    if local:
        # host-sharded input: each host passes its own rows (its ranks'
        # share of the 'data' axis), as JAX's processes do
        world = dist.get_world_size()
        hosts = world // int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
        if n_data % hosts:
            raise ValueError(
                f"'data' axis ({n_data}) must divide by the process "
                f"count ({hosts}) for host-sharded input")
        local_div = n_data // hosts
    if n % local_div:
        raise ValueError(
            f"leading dim {n} "
            f"{'(per-process local shard) ' if local else ''}not "
            f"divisible by {'its share of ' if local else ''}the "
            f"'data' axis ({local_div}) — every rank takes the same number "
            f"of rows; pad the batch "
            f"(Trainer._pad_batch_for_mesh) or pick a divisible "
            f"batch size")
    if accum > 1 and (n // local_div) % accum:
        raise ValueError(
            f"a rank's {n // local_div} rows must divide by grad_accum {accum} "
            f"(each of its microbatches holds its rows of one global microbatch)")
    return local_div


def _take(a, idx):
    if torch.is_tensor(a):
        return a[idx] if isinstance(idx, slice) else a[torch.as_tensor(idx)]
    return np.asarray(a)[idx]


def take_rows(mesh: Mesh, a, accum: int = 1):
    """This rank's rows (``rank_rows``) of ``a``, a global batch's array,
    where it stays (host or device); raises ``_check_rows``'s errors where
    the rows do not split evenly over 'data' and ``accum``."""
    _check_rows(mesh, a.shape[0], accum, local=False)
    return _take(a, rank_rows(mesh, a.shape[0], accum))


def shard_batch(mesh: Mesh, *arrays, local: bool = False, accum: int = 1):
    """This rank's rows of each array, on its device.  Each array's leading
    dim is split over 'data' (``rank_rows``; ``accum`` the step's
    ``grad_accum``).  By default the arrays are the global batch, the same
    on every rank; with ``local=True`` they are this host's rows (a host's
    ranks' share of the 'data' axis, process-major), as each JAX process
    passes its local shard."""
    out = []
    for a in arrays:
        if local:
            div = _check_rows(mesh, a.shape[0], accum, local)
            sub = dataclasses.replace(
                mesh, devices=mesh.devices[:div],
                data_rank=mesh.data_rank % div)
            rows = _take(a, rank_rows(sub, a.shape[0], accum))
        else:
            rows = take_rows(mesh, a, accum)
        out.append(torch.as_tensor(rows).to(mesh.device))
    return tuple(out) if len(out) > 1 else out[0]


# ---------------------------------------------------------------------------
# The sharded train step
# ---------------------------------------------------------------------------

def _sq(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.square(x.float()))


class ShardedReductions(StepReductions):
    """``make_train_step``'s reductions over a mesh (``StepReductions``):
    this rank's rows are part ``data_rank`` of ``n_data`` of each
    (micro)batch; split leaves are gathered for the forward, their grads
    cut to this rank's part, and every group's norms summed over the model
    group where they span it."""

    def __init__(self, mesh: Mesh, shardings: TrainState):
        self.mesh = mesh
        self.rank, self.n = mesh.data_rank, mesh.n_data
        self.params_sh = shardings.params
        self.cuts = {g: map_tree(_split, sh) for g, sh in self.params_sh.items()}

    def full_params(self, params):
        return gather_tree(params, self.params_sh)

    def reduce(self, grads, metrics):
        mesh = self.mesh

        def cut(g, c):
            if c is None:
                return g
            dim, part, parts = c
            k = g.shape[dim] // parts
            return g.narrow(dim, part * k, k)
        grads = {g: map_tree(cut, grads[g], self.cuts[g]) for g in grads}
        leaves = tree_leaves(grads)
        keys = list(metrics)
        flat = [x.reshape(-1).float() for x in leaves]
        flat += [metrics[k].reshape(-1).float() for k in keys]
        sizes = [t.numel() for t in flat]
        buf = torch.cat(flat)
        all_reduce_(mesh, buf, mesh.data_group)
        parts = torch.split(buf, sizes)
        n = self.n
        mean = (lambda t: t / n) if n > 1 else (lambda t: t)
        new = [mean(p).view(x.shape).to(x.dtype) for p, x in zip(parts, leaves)]
        it = iter(new)
        grads = map_tree(lambda _: next(it), grads)
        metrics = {k: (p if k in _SUM_METRICS else mean(p)).view(metrics[k].shape)
                   .to(metrics[k].dtype)
                   for k, p in zip(keys, parts[len(leaves):])}
        return grads, metrics

    def noise(self, group, grads, generator, step, eta, gamma):
        return add_gradient_noise(grads, generator, step, eta, gamma,
                                  shard=self.cuts[group])

    def _model_sum(self, t: torch.Tensor) -> torch.Tensor:
        return all_reduce_(self.mesh, t, self.mesh.model_group)

    def norm(self, group, tree):
        leaves, cuts = _pairs(tree, self.cuts[group])
        whole = [_sq(x) for x, c in zip(leaves, cuts) if c is None]
        split = [_sq(x) for x, c in zip(leaves, cuts) if c is not None]
        total = sum(whole)
        if split:
            total = total + self._model_sum(torch.stack(split).sum())
        return torch.sqrt(total)

    def leaf_norms(self, group, tree):
        leaves, cuts = _pairs(tree, self.cuts[group])
        sq = [_sq(x) for x in leaves]
        split = [i for i, c in enumerate(cuts) if c is not None]
        if split:
            summed = self._model_sum(torch.stack([sq[i] for i in split]))
            for j, i in enumerate(split):
                sq[i] = summed[j]
        it = iter(torch.sqrt(s) for s in sq)
        return map_tree(lambda _: next(it), tree)


def make_sharded_train_step(mcfg: ModelConfig, tcfg: TrainConfig, mesh: Mesh,
                            state: TrainState, *, tp: bool = False,
                            backbone: Optional[str] = None, vit_cfg=None,
                            img_repeat: int = 1):
    """The train step over ``mesh``: ``step(placed_state, tokens, lengths,
    feats, labels, hop_scale, lr, mult_lr) -> (placed_state, metrics)``
    with this rank's rows of the batch (``shard_batch(..., accum=
    tcfg.grad_accum)``) and the state ``place_state`` made.  ``state`` gives
    the tree and the whole leaves' shapes, which decide the specs: pass it
    before ``place_state``.  Each rank runs the step's kernels on its rows;
    the gradients and metrics are averaged over the data group (the sums of
    ``_SUM_METRICS`` summed) before the noise, the clip and Adam, which then
    run as in ``make_train_step``: the metrics come back equal on every
    rank.  Fine-tuning (``tcfg.train_backbone``, ``backbone``): ``feats``
    is this rank's uint8 images, and the backbone group is replicated."""
    shardings = state_shardings(mesh, state, tp=tp)
    return make_train_step(mcfg, tcfg, device=mesh.device, backbone=backbone,
                           vit_cfg=vit_cfg, img_repeat=img_repeat,
                           reductions=ShardedReductions(mesh, shardings))


# ---------------------------------------------------------------------------
# Sharded serving
# ---------------------------------------------------------------------------

def _gathered(mesh: Mesh, params, tp: bool) -> Callable:
    """``placed params -> whole params``, once per parameter set."""
    shardings = map_tree(lambda s: NamedSharding(mesh, s),
                         param_pspecs(params, tp=tp, mesh=mesh))
    return MemoRecent(lambda p: gather_tree(p, shardings))


def make_sharded_predict_fn(mcfg: ModelConfig, mesh: Mesh, params, *,
                            tp: bool = False, fused: bool = True):
    """The eval forward over the mesh: ``fn(placed_params, tokens, lengths,
    feats) -> (tab_pred, tab_att)`` of the global batch, on every rank,
    from this rank's rows (``shard_batch``).  Each rank runs
    ``PredictStep``'s kernels (``fused=False``: the plain float32
    ``predict``) on whole weights, gathered once per parameter set under TP,
    and the outputs are gathered in row order.  ``params`` (whole leaves)
    gives the specs."""
    from rau_vqa_tpu_torch.eval.predict import make_predict_step, predict

    whole = _gathered(mesh, params, tp)
    step = make_predict_step(mcfg, device=mesh.device) if fused else None

    def fn(p, tokens, lengths, feats):
        p = whole(p)
        if step is not None:
            tab_pred, tab_att = step(p, tokens, lengths, feats)
        else:
            with torch.no_grad():
                tab_pred, tab_att = predict(
                    p, mcfg, torch.as_tensor(tokens, device=mesh.device),
                    torch.as_tensor(lengths, device=mesh.device),
                    torch.as_tensor(feats, device=mesh.device).float())
        return gather_rows(mesh, tab_pred, 1), gather_rows(mesh, tab_att, 1)

    return fn


def make_sharded_predict(mcfg: ModelConfig, mesh: Mesh, params, *,
                         tp: bool = False, fused: bool = True):
    """``make_sharded_predict_fn`` with ``params`` (whole leaves) placed:
    (fn, placed_params)."""
    shardings = map_tree(lambda s: NamedSharding(mesh, s),
                         param_pspecs(params, tp=tp, mesh=mesh))
    placed = place_tree(params, shardings)
    return make_sharded_predict_fn(mcfg, mesh, params, tp=tp, fused=fused), placed


def make_sharded_pixels_predict(mcfg: ModelConfig, mesh: Mesh, params,
                                backbone: str, *, tp: bool = False,
                                vit_cfg=None, feat_norm: bool = False):
    """From-pixels serving over the mesh: ``fn(placed_params, bb_params,
    images_u8, tokens, lengths) -> (tab_pred, tab_att)`` of the global
    batch, from this rank's rows; each rank runs ``pixels_tables`` (the
    stage kernel for a ResNet, then the head's kernels) on its images with
    the backbone whole (replicated), the head's split leaves gathered."""
    from rau_vqa_tpu_torch.models.pipeline import pixels_tables

    whole = _gathered(mesh, params, tp)

    def fn(p, bb, images, tokens, lengths):
        tab_pred, tab_att = pixels_tables(whole(p), bb, mcfg, backbone, images, tokens,
                                          lengths, vit_cfg=vit_cfg, device=mesh.device,
                                          feat_norm=feat_norm)
        return gather_rows(mesh, tab_pred, 1), gather_rows(mesh, tab_att, 1)

    return fn

