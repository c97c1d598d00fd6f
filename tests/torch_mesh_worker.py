"""One rank of the port's multi-process mesh tests (tests/test_torch_port_mesh*.py).

    RANK=r WORLD_SIZE=n ... python tests/torch_mesh_worker.py <set> <dir>

joins a gloo world on the CPU (``init_distributed(device="cpu")``; on the
card with ``MESH_WORKER_DEVICE=cuda``, its ranks sharing it), reads
``<dir>/inputs.pt``, runs the scenarios of ``<set>`` and writes what it read
off to ``<dir>/rank<r>.pt``.  It imports the port alone (no JAX): the test
process makes the inputs, runs JAX and the single-process port, and holds
the ranks' readings against them.  ``launch`` starts the ranks with a
timeout of their own."""

from __future__ import annotations

import dataclasses
import os
import signal
import socket
import subprocess
import sys
from typing import Dict, List

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(which: str, workdir: str, n: int, timeout: float = 240.0,
           argv=None, extra_env=None) -> List[str]:
    """Run ``n`` ranks (this file with ``which`` and ``workdir``, or
    ``argv``) to their end; kill every rank's process group and raise if one
    fails or the launch outlasts ``timeout`` seconds.  Returns each rank's
    output."""
    port = str(free_port())
    procs = []
    for r in range(n):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                   OMP_NUM_THREADS="1", PYTHONPATH=REPO, **(extra_env or {}))
        cmd = argv or [sys.executable, os.path.abspath(__file__), which, workdir]
        procs.append(subprocess.Popen(cmd, env=env, cwd=REPO, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True,
                                      start_new_session=True))
    outs, failed = [], []
    try:
        for r, p in enumerate(procs):
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
            if p.returncode != 0:
                failed.append(f"rank {r} exited {p.returncode}:\n{out[-4000:]}")
    except subprocess.TimeoutExpired:
        failed.append(f"the launch outlasted {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


# ---------------------------------------------------------------------------
# the scenarios
# ---------------------------------------------------------------------------

def _cfgs(inp, sc):
    """A scenario's configs: the inputs' (or its own ``model_base``) with
    its overrides."""
    from rau_vqa_tpu_torch.config import ModelConfig, TrainConfig
    mcfg = ModelConfig(**{**sc.get("model_base", inp["model"]), **sc.get("model", {})})
    tcfg = TrainConfig(**{**inp["train"], **sc.get("train", {})})
    return mcfg, tcfg


def _state(params, seed=0):
    from rau_vqa_tpu_torch.convert import map_tree
    from rau_vqa_tpu_torch.train.optim import adam_init
    from rau_vqa_tpu_torch.train.trainer import TrainState
    params = map_tree(lambda x: x.clone(), params)
    return TrainState(params, {g: adam_init(params[g]) for g in params}, 0, seed)


def _no_row0():
    """The fused hop loop with its rows' place dropped (row0 = 0): the
    masks a rank would draw if they were keyed by the row within its call."""
    from rau_vqa_tpu_torch.models import rau
    plain = rau.rau_train_hops
    rau.rau_train_hops = lambda mp, cfg, q, feats, seed, row0=0: plain(mp, cfg, q, feats,
                                                                         seed, 0)
    return lambda: setattr(rau, "rau_train_hops", plain)


def run_step(inp, sc, mesh):
    from rau_vqa_tpu_torch.parallel import mesh as pm
    mcfg, tcfg = _cfgs(inp, sc)
    state = _state(sc.get("params", inp["params"]))
    batch = sc.get("batch", inp["batch"])
    kw = {}
    if "backbone" in sc:
        kw = dict(backbone=sc["backbone"], vit_cfg=sc.get("vit_cfg"))
    step = pm.make_sharded_train_step(mcfg, tcfg, mesh, state, tp=sc["tp"], **kw)
    shardings = pm.state_shardings(mesh, state, tp=sc["tp"])
    placed = pm.place_state(mesh, state, tp=sc["tp"])
    local = pm.shard_batch(mesh, *batch, accum=tcfg.grad_accum)
    hop_scale = torch.ones(mcfg.n_hops)
    restore = _no_row0() if sc.get("row0_zero") else None
    lr, mult_lr = sc.get("lrs", (1e-2, 1e-2))
    losses = []
    try:
        for _ in range(sc.get("steps", 3)):
            placed, metrics = step(placed, *local, hop_scale, lr, mult_lr)
            losses.append(float(metrics["loss"]))
    finally:
        if restore:
            restore()
    whole = pm.gather_state(placed, shardings)
    return {"losses": losses, "params": whole.params, "opt": whole.opt,
            "metrics": {k: v.detach() for k, v in metrics.items()},
            "cls_w_local": tuple(placed.params["mult"]["cls"]["w"].shape),
            "step": placed.step}


def run_predict(inp, sc, mesh):
    from rau_vqa_tpu_torch.parallel import mesh as pm
    mcfg, _ = _cfgs(inp, sc)
    tokens, lengths, feats = inp["predict_batch"]
    fn, placed = pm.make_sharded_predict(mcfg, mesh, inp["params"], tp=sc["tp"],
                                         fused=sc.get("fused", True))
    tab, att = fn(placed, *pm.shard_batch(mesh, tokens, lengths, feats))
    # a second call on the same parameter set gathers nothing new
    tab2, _ = fn(placed, *pm.shard_batch(mesh, tokens, lengths, feats))
    return {"tab": tab, "att": att, "again_equal": bool(torch.equal(tab, tab2))}


def run_pixels(inp, sc, mesh):
    from rau_vqa_tpu_torch.parallel import mesh as pm
    px = inp["pixels"][sc["backbone"]]
    mcfg = px["cfg"]
    fn = pm.make_sharded_pixels_predict(mcfg, mesh, px["params"], sc["backbone"],
                                        tp=sc["tp"], vit_cfg=px.get("vit_cfg"))
    shardings = pm.map_tree(lambda s: pm.NamedSharding(mesh, s),
                            pm.param_pspecs(px["params"], tp=sc["tp"], mesh=mesh))
    placed = pm.place_tree(px["params"], shardings)
    bb = pm.replicate_tree(mesh, px["bb"])
    tab, att = fn(placed, bb, *pm.shard_batch(mesh, px["images"], px["tokens"],
                                              px["lengths"]))
    return {"tab": tab, "att": att}


RUNNERS = {"step": run_step, "predict": run_predict, "pixels": run_pixels}


def mesh_layouts() -> Dict:
    """The world's meshes: each shape with this rank's coordinates, the
    default (the world over 'data') and the refusals of meshes that do not
    span the world."""
    import torch.distributed as dist

    from rau_vqa_tpu_torch.parallel import mesh as pm
    world = dist.get_world_size()
    out = {"default": pm.make_mesh().shape}
    for shape in ((world, 1), (1, world)):
        m = pm.make_mesh(*shape)
        out[shape] = (m.shape, m.data_rank, m.model_rank, m.devices.tolist())
    for shape in ((world + 1, 1), (1, 1)):
        try:
            pm.make_mesh(*shape)
            out[shape] = None
        except ValueError as e:
            out[shape] = str(e)
    return out


def run_scenarios(inp) -> Dict:
    from rau_vqa_tpu_torch.parallel import mesh as pm
    out, meshes = {"layouts": mesh_layouts()}, {}
    for sc in inp["scenarios"]:
        shape = tuple(sc["mesh"])
        if shape not in meshes:
            meshes[shape] = pm.make_mesh(*shape)
        out[sc["name"]] = RUNNERS[sc.get("kind", "step")](inp, sc, meshes[shape])
    return out


# ---------------------------------------------------------------------------
# the Trainer, its checkpoints and precompute_features
# ---------------------------------------------------------------------------

def fixture_trainer(root: str, workdir: str, *, mesh=None, tp=False, test_batch_size=8,
                    batch_size=16, grad_accum=1):
    """The port Trainer on the CLI's fixture (``cli._fixture_setup``: its
    .t7 features under ``root``), as tests/test_multihost.py:221-283 sets it
    up: ours_ms at 2 hops, batch 16, mult_dropout 0.1, the attention PNGs of
    one eval batch, eval bucket 8."""
    from rau_vqa_tpu_torch.cli import _fixture_setup, _make_feature_source
    from rau_vqa_tpu_torch.config import get_experiment
    from rau_vqa_tpu_torch.data.loader import build_vqa_data
    from rau_vqa_tpu_torch.train.trainer import Trainer
    exp = get_experiment("ours_ms")
    exp = exp.replace(model=dataclasses.replace(exp.model, n_hops=2))
    exp, bundle = _fixture_setup(exp, root)
    exp = exp.replace(train=dataclasses.replace(exp.train, batch_size=batch_size,
                                                grad_accum=grad_accum))
    exp = exp.replace(visatt=True, visatt_batches=1, eval_buckets=(8,), graph_interval=0,
                      mesh=dataclasses.replace(exp.mesh, enabled=mesh is not None,
                                               shard_params_tp=tp))
    data = build_vqa_data(bundle.info, bundle.arrays, exp.train.batch_size,
                          split=exp.data.split, test_batch_size=test_batch_size,
                          seed=exp.train.seed)
    src = _make_feature_source(exp.data.feat_dir, exp.model)
    gt = {int(k): v for k, v in bundle.gt.items()}
    return Trainer(exp, data, src, workdir, gt_anno=gt, device="cpu" if mesh is None else None,
                   mesh=mesh)


def _whole(trainer):
    from rau_vqa_tpu_torch.parallel.mesh import gather_state
    return gather_state(trainer.state, trainer._shardings)


def run_trainer(inp) -> Dict:
    """2 epochs on a (2, 1) mesh and the sweep (test batch 8), a second
    Trainer's sweep over odd test batches (5, padded to the data axis); an
    epoch with grad_accum 4, and the error of a batch of 20 with grad_accum
    4 (a rank's 10 rows do not split into 4); a (1, 2) TP Trainer's
    checkpoint after 1 epoch, and a single process's checkpoint restored on
    it."""
    import torch.distributed as dist

    from rau_vqa_tpu_torch.parallel import mesh as pm
    rank = dist.get_rank()
    root = os.path.join(inp["dir"], f"fixture_rank{rank}")
    out = {}
    dp = pm.make_mesh(2, 1)
    tr = fixture_trainer(root, os.path.join(inp["dir"], "run"), mesh=dp)
    for _ in range(2):
        tr.train_epoch()
    res = tr.evaluate(write_submissions=False)
    out["step"] = tr.state.step
    out["cls_b"] = tr.state.params["mult"]["cls"]["b"][:4].clone()
    out["testOEacc"] = res["testOEacc"]
    odd = fixture_trainer(root, os.path.join(inp["dir"], "odd"), mesh=dp, test_batch_size=5)
    r5 = odd.evaluate(write_submissions=False)
    out["odd"] = {"testOEacc": r5["testOEacc"], "testMCacc": r5["testMCacc"]}
    acc = fixture_trainer(root, os.path.join(inp["dir"], "accum"), mesh=dp, grad_accum=4)
    acc.train_epoch()
    out["accum_step"] = acc.state.step
    out["accum_cls_b"] = acc.state.params["mult"]["cls"]["b"][:4].clone()
    bad = fixture_trainer(root, os.path.join(inp["dir"], "bad"), mesh=dp, batch_size=20,
                          grad_accum=4)
    try:
        bad.train_epoch()
        out["accum_error"] = ""
    except ValueError as e:
        out["accum_error"] = str(e)
    tp = pm.make_mesh(1, 2)
    ck = fixture_trainer(root, os.path.join(inp["dir"], "tp"), mesh=tp, tp=True)
    ck.train_epoch()
    out["tp_path"] = ck.save()
    out["tp_state"] = _whole(ck)
    out["tp_cls_w_local"] = tuple(ck.state.params["mult"]["cls"]["w"].shape)
    out["tp_wi_local"] = tuple(ck.state.params["rnn"]["layers"][0]["wi"].shape)
    ck.restore(inp["single_ckpt"])
    out["restored"] = _whole(ck)
    out["restored_cls_w_local"] = tuple(ck.state.params["mult"]["cls"]["w"].shape)
    return out


def run_precompute(inp) -> Dict:
    """precompute_features on a (2, 1) mesh: the shard rank 0 writes."""
    from rau_vqa_tpu_torch.parallel import mesh as pm
    from rau_vqa_tpu_torch.precompute import precompute_features
    mesh = pm.make_mesh(2, 1)
    store = precompute_features(inp["image_root"], inp["rel"], inp["out"], "vgg16",
                                inp["bb"], size=32, batch_size=4, backend="pil",
                                dtype=inp["dtype"], mesh=mesh)
    return {"n": len(store.index)}


SETS = {"scenarios": run_scenarios, "trainer": run_trainer, "precompute": run_precompute}


def main(argv) -> int:
    which, workdir = argv
    torch.set_num_threads(1)
    import torch.distributed as dist

    from rau_vqa_tpu_torch.parallel.mesh import init_distributed
    init_distributed(device=os.environ.get("MESH_WORKER_DEVICE", "cpu"))
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    out = SETS[which](inp)
    torch.save(out, os.path.join(workdir, f"rank{dist.get_rank()}.pt"))
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
