"""The port's device mesh (rau_vqa_tpu_torch/parallel/mesh.py) on the CPU:
its specs and errors against the JAX package's, and the sharded train,
predict and pixels steps of 2 and 4 gloo ranks against the port's
single-process step and JAX's ``make_sharded_train_step`` on the same mesh
shape, at tests/test_parallel.py's bars.

The ranks are processes of tests/torch_mesh_worker.py (the port alone, one
thread each, each launch under its own timeout): one module-scoped launch
of 2 ranks runs every 2-rank scenario, one of 4 ranks the (2, 2) mesh, and
each assertion is a test case of its own.  JAX runs here, on conftest's 8
virtual devices."""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import torch_mesh_worker as W  # noqa: E402
from rau_vqa_tpu.config import ModelConfig as JModelConfig  # noqa: E402
from rau_vqa_tpu.config import TrainConfig as JTrainConfig  # noqa: E402
from rau_vqa_tpu.parallel import mesh as jmesh  # noqa: E402
from rau_vqa_tpu.train import trainer as jtrainer  # noqa: E402
from rau_vqa_tpu_torch import config as tconfig  # noqa: E402
from rau_vqa_tpu_torch.convert import params_from_jax, tree_leaves  # noqa: E402
from rau_vqa_tpu_torch.parallel import mesh as pm  # noqa: E402
from rau_vqa_tpu_torch.train import trainer as ttrainer  # noqa: E402

# tests/test_parallel.py:21-27
JCFG = JModelConfig(
    vocab_size=40, answer_size=8, seq_len=7, embed_dim=8, rnn_size=16,
    rnn_layers=2, cnn_dim=8, cnn_w=2, cnn_h=2, multfeat_dim=16,
    attfeat_dim=8, att_rnn_size=16, n_hops=2,
    embed_dropout=0.0, rnn_dropout=0.0, mult_dropout=0.0)
JTCFG = JTrainConfig(noisy_eta=0.0, grad_clip=10.0)
FUSED = {"fused_train": True}
DROP = {"embed_dropout": 0.3, "rnn_dropout": 0.3, "mult_dropout": 0.3}
NOISE = {"noisy_eta": 0.01}


def model_kw(jcfg):
    names = {f.name for f in dataclasses.fields(tconfig.ModelConfig)}
    names.discard("fused_train_bwd")
    return {n: getattr(jcfg, n) for n in names}


def train_kw(jtcfg):
    return {f.name: getattr(jtcfg, f.name) for f in dataclasses.fields(tconfig.TrainConfig)}


def make_batch(B=16):
    """tests/test_parallel.py's batch, as numpy."""
    rs = np.random.RandomState(0)
    tokens = rs.randint(1, JCFG.vocab_size, (B, JCFG.seq_len)).astype(np.int32)
    lengths = rs.randint(1, JCFG.seq_len + 1, B).astype(np.int32)
    feats = rs.randn(B, JCFG.cnn_spat, JCFG.cnn_dim).astype(np.float32)
    labels = rs.randint(0, JCFG.answer_size, B).astype(np.int32)
    return tokens, lengths, feats, labels


def jax_state():
    return jtrainer.init_train_state(jax.random.PRNGKey(0), JCFG)


def port_params():
    return params_from_jax(jax.tree.map(np.asarray, jax_state().params))


# (name, mesh, tp, model overrides, train overrides): the 2-rank steps
STEPS = [
    ("dp_fused", (2, 1), False, FUSED, {}),
    ("dp_unfused", (2, 1), False, {}, {}),
    ("tp_fused", (1, 2), True, FUSED, {}),
    ("tp_unfused", (1, 2), True, {}, {}),
    ("dp_fused_drop", (2, 1), False, {**FUSED, **DROP}, NOISE),
    ("dp_unfused_drop", (2, 1), False, DROP, NOISE),
    ("tp_fused_drop", (1, 2), True, {**FUSED, **DROP}, NOISE),
    ("dp_accum", (2, 1), False, FUSED, {"grad_accum": 2}),
    ("dp_accum_drop", (2, 1), False, {**FUSED, **DROP}, {"grad_accum": 2, **NOISE}),
    ("dp_unfused_accum_drop", (2, 1), False, DROP, {"grad_accum": 2, **NOISE}),
]
QUAD = [("dptp_fused", (2, 2), True, FUSED, {}),
        ("dptp_unfused", (2, 2), True, {}, {}),
        ("dptp_fused_drop", (2, 2), True, {**FUSED, **DROP}, NOISE)]


def scenarios(steps):
    return [{"name": n, "mesh": m, "tp": tp, "model": mk, "train": tk}
            for n, m, tp, mk, tk in steps]


def step_inputs(steps, extra=()):
    return {"model": model_kw(JCFG), "train": train_kw(JTCFG), "params": port_params(),
            "batch": make_batch(), "predict_batch": make_batch()[:3],
            "scenarios": scenarios(steps) + list(extra)}


# sharded predict (tests/test_parallel.py:236-251): (name, mesh, tp, fused)
PREDICT = [("predict_dp", (2, 1), False, True), ("predict_tp", (1, 2), True, True),
           ("predict_dp_plain", (2, 1), False, False)]
# from pixels (:317-405): each backbone, DP and TP
PIXELS = [(f"pixels_{b}_{'tp' if tp else 'dp'}", b, tp)
          for b in ("vgg16", "resnet101", "vit") for tp in (False, True)]
# fine-tuning through the tiny ViT (tests/test_finetune.py:154-191)
FINETUNE = [("ft_tp", (1, 2), True), ("ft_dp", (2, 1), False)]


def pixels_inputs():
    """Each backbone's head, tree and batch of tests/test_torch_port_pipeline.py,
    B=8: VGG16 at full width and 64 px, a narrow ResNet, a tiny ViT."""
    from tests import test_torch_port_pipeline as TPP
    out = {}
    for b in ("vgg16", "resnet101", "vit"):
        if b == "resnet101":
            p, bb, images, tokens, lengths = TPP.setup(8, seed=3)
            cfg, vit_cfg = TPP.CFG, None
        else:
            _, cfg, p, bb, images, tokens, lengths = TPP.other_setup(b, 8, seed=2)
            vit_cfg = TPP.TTINY if b == "vit" else None
        out[b] = {"cfg": cfg, "params": params_from_jax(p), "bb": params_from_jax(bb),
                  "images": images, "tokens": tokens, "lengths": lengths,
                  "vit_cfg": vit_cfg}
    return out


def finetune_inputs():
    """The fine-tuning state and batch of tests/test_torch_port_finetune.py."""
    from tests import test_torch_port_finetune as TPF
    cfg = model_kw(TPF.JCFG)
    state = ttrainer.init_train_state(tconfig.ModelConfig(**cfg), 0, device="cpu",
                                      bb_params=params_from_jax(TPF.jax_vit(1)))
    return cfg, state.params, TPF.batch(seed=1), TPF.TVIT


def run_launch(tmp, n, inp):
    torch.save(inp, os.path.join(tmp, "inputs.pt"))
    W.launch("scenarios", tmp, n, timeout=240)
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(n)]


def single_step(name_or_kw, steps=STEPS, n=3):
    """The port's single-process step on the whole batch, 3 steps."""
    _, _, _, mk, tk = next(s for s in steps if s[0] == name_or_kw)
    mcfg = tconfig.ModelConfig(**{**model_kw(JCFG), **mk})
    tcfg = tconfig.TrainConfig(**{**train_kw(JTCFG), **tk})
    step = ttrainer.make_train_step(mcfg, tcfg, device="cpu")
    state = W._state(port_params())
    losses = []
    for _ in range(n):
        state, m = step(state, *make_batch(), torch.ones(mcfg.n_hops), 1e-2, 1e-2)
        losses.append(float(m["loss"]))
    return state, m, losses


def jax_sharded(n_data, n_model, tp, model_kw_, train_kw_):
    jcfg = dataclasses.replace(JCFG, **model_kw_)
    jtcfg = dataclasses.replace(JTCFG, **train_kw_)
    mesh = jmesh.make_mesh(n_data=n_data, n_model=n_model)
    state = jmesh.place_state(mesh, jax_state(), tp=tp)
    step = jmesh.make_sharded_train_step(jcfg, jtcfg, mesh, state, tp=tp)
    batch = jmesh.shard_batch(mesh, *(jnp.asarray(a) for a in make_batch()))
    for _ in range(3):
        state, m = step(state, *batch, jnp.ones((jcfg.n_hops,)), jnp.float32(1e-2),
                        jnp.float32(1e-2))
    return state, m


# ---------------------------------------------------------------------------
# specs and errors (no launch)
# ---------------------------------------------------------------------------

def _paths(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, path + (k,))
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, (pm.P,)):
        for i, v in enumerate(tree):
            yield from _paths(v, path + (i,))
    else:
        yield path, tree


def _jax_specs(params, tp, mesh=None):
    specs = jmesh.param_pspecs(params, tp=tp, mesh=mesh)
    out = {}
    for path, spec in jax.tree_util.tree_leaves_with_path(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)):
        out[tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)] = tuple(spec)
    return out


class _FakeMesh:
    def __init__(self, n_model):
        self.n_model = n_model


@pytest.mark.parametrize("tp,n_model", [(False, 2), (True, 0), (True, 2), (True, 4),
                                        (True, 3)])
def test_param_pspecs_match_jax(tp, n_model):
    """Leaf for leaf, the fallback to replication included (n_model 3 and
    4 leave undivisible leaves whole in both)."""
    jparams = jax_state().params
    jm = jmesh.make_mesh(n_data=1, n_model=n_model) if n_model else None
    want = _jax_specs(jparams, tp, jm)
    got = dict(_paths(pm.param_pspecs(port_params(), tp=tp,
                                      mesh=_FakeMesh(n_model) if n_model else None)))
    assert set(got) == set(want)
    for path in want:
        assert got[path] == want[path], path
    if tp:
        # answer_size 8: split over 2 or 4 ranks, whole over 3
        assert got[("mult", "cls", "w")] == ((None, "model") if n_model != 3 else ())
        assert got[("embed", "lookup")] == ()


def test_make_mesh_needs_the_world():
    with pytest.raises(RuntimeError, match="init_distributed"):
        pm.make_mesh(1, 1)


def test_mesh_from_config_rejects_conflicting_data_axis(monkeypatch):
    """A multi-process mesh spans every rank: an explicit --mesh-data that
    disagrees fails with the real geometry (tests/test_parallel.py:416-435);
    a matching or default data axis gets the multihost layout, whose model
    axis must divide the ranks a host."""
    monkeypatch.setattr(pm.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(pm.dist, "get_world_size", lambda: 8)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    monkeypatch.setattr(pm, "make_mesh", lambda n_data, n_model: _grid_mesh(n_data, n_model))
    with pytest.raises(ValueError, match="conflicts"):
        pm.mesh_from_config(tconfig.MeshConfig(data_axis=3, model_axis=1))
    assert pm.mesh_from_config(tconfig.MeshConfig(data_axis=8)).shape["data"] == 8
    assert pm.mesh_from_config(tconfig.MeshConfig(model_axis=2)).shape == {
        "data": 4, "model": 2}
    with pytest.raises(ValueError, match="4 chips/host not divisible by model axis 3"):
        pm.mesh_from_config(tconfig.MeshConfig(model_axis=3))


def _grid_mesh(n_data, n_model, d=0, m=0):
    grid = np.arange(n_data * n_model).reshape(n_data, n_model)
    return pm.Mesh(grid, int(grid[d, m]), d, m, None, None, torch.device("cpu"), "gloo")


@pytest.mark.parametrize("n,n_data,world,local_world,accum,local,match", [
    (15, 2, 2, 2, 1, False, r"leading dim 15 not divisible by the 'data' axis \(2\)"),
    (16, 2, 2, 2, 3, False, "must divide by grad_accum 3"),
    (9, 4, 4, 2, 1, True, r"leading dim 9 \(per-process local shard\) not divisible by "
                          r"its share of the 'data' axis \(2\)"),
    (8, 2, 4, 1, 1, True, r"'data' axis \(2\) must divide by the process count \(4\)"),
])
def test_shard_batch_errors(n, n_data, world, local_world, accum, local, match,
                            monkeypatch):
    """JAX's wording (mesh.py:159-208), the multi-process one for a host's
    local batch (a host: LOCAL_WORLD_SIZE ranks); the port adds
    grad_accum's."""
    monkeypatch.setattr(pm.dist, "get_world_size", lambda: world)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local_world))
    with pytest.raises(ValueError, match=match):
        pm.shard_batch(_grid_mesh(n_data, 1), np.zeros((n, 3)), local=local, accum=accum)


def test_shard_batch_rows():
    """A rank's rows: contiguous, or, with grad_accum, its part of each
    global microbatch; a host's local batch by the rank's place on it."""
    x = np.arange(16)
    assert pm.shard_batch(_grid_mesh(2, 1, d=1), x).tolist() == list(range(8, 16))
    assert pm.shard_batch(_grid_mesh(2, 1, d=1), x, accum=2).tolist() == [
        4, 5, 6, 7, 12, 13, 14, 15]
    assert pm.shard_batch(_grid_mesh(4, 2, d=2, m=1), x).tolist() == [8, 9, 10, 11]


# ---------------------------------------------------------------------------
# 2 ranks: every 2-rank scenario in one launch
# ---------------------------------------------------------------------------

FT_TRAIN = {"train_backbone": True, "noisy_eta": 0.0}
FT_LRS = (1e-3, 1e-4)


def two_rank_extra():
    ft_cfg, ft_params, ft_batch, tvit = finetune_inputs()
    return (
        [{"name": "dp_fused_drop_row0", "mesh": (2, 1), "tp": False, "row0_zero": True,
          "model": {**FUSED, **DROP}, "train": NOISE}]
        + [{"name": n, "kind": "predict", "mesh": m, "tp": tp, "fused": f}
           for n, m, tp, f in PREDICT]
        + [{"name": n, "kind": "pixels", "mesh": (1, 2) if tp else (2, 1), "tp": tp,
            "backbone": b} for n, b, tp in PIXELS]
        + [{"name": n, "mesh": m, "tp": tp, "model_base": ft_cfg, "train": FT_TRAIN,
            "params": ft_params, "batch": ft_batch, "backbone": "vit", "vit_cfg": tvit,
            "steps": 1, "lrs": FT_LRS} for n, m, tp in FINETUNE])


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("mesh2"))
    inp = step_inputs(STEPS, extra=two_rank_extra())
    inp["pixels"] = pixels_inputs()
    return run_launch(tmp, 2, inp)


@pytest.fixture(scope="module")
def quad(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("mesh4"))
    return run_launch(tmp, 4, step_inputs(QUAD))


def _close(got, want, rtol, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


def _check_step(ranks, name, steps):
    """Loss and cls.w against the port's single-process step; every rank's
    metrics and whole params alike."""
    state, m, losses = single_step(name, steps)
    got = ranks[0][name]
    _close(got["losses"], losses, rtol=2e-4, atol=0)
    _close(got["params"]["mult"]["cls"]["w"], state.params["mult"]["cls"]["w"],
           rtol=2e-4, atol=2e-5)
    for path, w in _paths(state.params):
        g = got["params"]
        for k in path:
            g = g[k]
        _close(g, w, rtol=2e-4, atol=2e-5, msg=str(path))
    for r in ranks[1:]:
        for a, b in zip(tree_leaves(r[name]["params"]), tree_leaves(got["params"])):
            assert torch.equal(a, b), name
    assert got["step"] == 3


@pytest.mark.multiproc
def test_make_mesh_shapes_and_refusals(two):
    """The world of 2 as (2, 1) and (1, 2), process-major (rank d * n_model
    + m at (d, m)), the default all 'data'; a mesh larger than the world is
    the JAX package's oversubscription error, a smaller one leaves ranks
    idle and is refused too."""
    for rank, r in enumerate(two):
        lay = r["layouts"]
        assert lay["default"] == {"data": 2, "model": 1}
        assert lay[(2, 1)] == ({"data": 2, "model": 1}, rank, 0, [[0], [1]])
        assert lay[(1, 2)] == ({"data": 1, "model": 2}, 0, rank, [[0, 1]])
        assert lay[(3, 1)] == "need 3 devices, have 2"
        assert "leaves ranks of the world of 2 idle" in lay[(1, 1)]


@pytest.mark.multiproc
@pytest.mark.parametrize("name", [s[0] for s in STEPS])
def test_two_rank_step_matches_single_process(two, name):
    _check_step(two, name, STEPS)


@pytest.mark.multiproc
@pytest.mark.parametrize("name", ["dp_fused", "dp_unfused", "tp_fused", "tp_unfused"])
def test_two_rank_step_matches_jax_sharded(two, name):
    """Dropout off, noise off: the JAX package's sharded step on the same
    mesh shape (from the same initial params)."""
    _, (n_data, n_model), tp, mk, tk = next(s for s in STEPS if s[0] == name)
    jstate, jm = jax_sharded(n_data, n_model, tp, mk, tk)
    got = two[0][name]
    _close(got["losses"][-1], float(jm["loss"]), rtol=2e-4, atol=0)
    _close(got["params"]["mult"]["cls"]["w"],
           jax.device_get(jstate.params["mult"]["cls"]["w"]), rtol=2e-4, atol=2e-5)


@pytest.mark.multiproc
@pytest.mark.parametrize("name", ["tp_fused", "tp_unfused", "tp_fused_drop"])
def test_tp_stores_each_rank_s_slice(two, name):
    """Under TP cls.w is held as (M, A / n_model) on each rank
    (tests/test_parallel.py:67-97)."""
    for r in two:
        assert r[name]["cls_w_local"] == (JCFG.multfeat_dim, JCFG.answer_size // 2)
    assert two[0]["dp_fused"]["cls_w_local"] == (JCFG.multfeat_dim, JCFG.answer_size)


@pytest.mark.multiproc
def test_fused_dropout_needs_the_global_row(two):
    """The negative check: the same run with the masks keyed by the row
    within each rank's call (row0 = 0) leaves the single-process step."""
    state, _, losses = single_step("dp_fused_drop")
    got = two[0]["dp_fused_drop_row0"]
    with pytest.raises(AssertionError):
        _close(got["params"]["mult"]["cls"]["w"], state.params["mult"]["cls"]["w"],
               rtol=2e-4, atol=2e-5)
    assert not np.allclose(got["losses"], losses, rtol=2e-4, atol=0)


@pytest.mark.multiproc
def test_grad_accum_on_the_mesh_matches_the_plain_sharded_step(two):
    """tests/test_parallel.py:136-156: dropout off, accumulation exact."""
    a, b = two[0]["dp_accum"], two[0]["dp_fused"]
    _close(a["losses"], b["losses"], rtol=1e-5, atol=0)
    _close(a["params"]["mult"]["cls"]["w"], b["params"]["mult"]["cls"]["w"],
           rtol=2e-4, atol=2e-6)


@pytest.mark.multiproc
@pytest.mark.parametrize("name,tp,fused", [(n, tp, f) for n, _, tp, f in PREDICT])
def test_sharded_predict_matches_single_device(two, name, tp, fused):
    """Each rank's rows through PredictStep's kernels (their plain versions
    here), or the plain predict, gathered in row order: the single-device
    step's tables at tests/test_parallel.py:236-251's bars."""
    from rau_vqa_tpu_torch.eval.predict import make_predict_step, predict
    tokens, lengths, feats = make_batch()[:3]
    params = port_params()
    mcfg = tconfig.ModelConfig(**model_kw(JCFG))
    if fused:
        tab, att = make_predict_step(mcfg, device="cpu")(params, tokens, lengths, feats)
    else:
        with torch.no_grad():
            tab, att = predict(params, mcfg, torch.as_tensor(tokens),
                               torch.as_tensor(lengths), torch.as_tensor(feats))
    got = two[0][name]
    _close(got["tab"], tab, rtol=2e-4, atol=2e-5)
    _close(got["att"], att, rtol=2e-4, atol=1e-5)
    assert got["again_equal"]
    assert torch.equal(two[1][name]["tab"], got["tab"])


@pytest.mark.multiproc
@pytest.mark.parametrize("name,backbone,tp", PIXELS)
def test_sharded_pixels_predict_matches_single_device(two, name, backbone, tp):
    """From pixels: each rank runs its images through the backbone (the
    ResNet's identity runs through the stage kernel's plain version here)
    and the head's kernels; the tables of one process on the whole batch."""
    from rau_vqa_tpu_torch.models.pipeline import pixels_tables
    px = pixels_inputs()[backbone]
    tab, att = pixels_tables(px["params"], px["bb"], px["cfg"], backbone, px["images"],
                             px["tokens"], px["lengths"], vit_cfg=px["vit_cfg"],
                             device="cpu")
    got = two[0][name]
    _close(got["tab"], tab, rtol=2e-4, atol=2e-5)
    _close(got["att"], att, rtol=2e-4, atol=1e-5)


@pytest.mark.multiproc
@pytest.mark.parametrize("name", [n for n, _, _ in FINETUNE])
def test_sharded_fine_tuning_step_matches_single_process(two, name):
    """The fine-tuning step (the backbone a 4th group, replicated; uint8
    images sharded on 'data'): loss within 1e-5, every parameter within
    2e-4 / 1e-6 of one process's step (tests/test_finetune.py:154-191)."""
    cfg, params, batch, tvit = finetune_inputs()
    step = ttrainer.make_train_step(tconfig.ModelConfig(**cfg),
                                    tconfig.TrainConfig(**{**train_kw(JTCFG), **FT_TRAIN}),
                                    device="cpu", backbone="vit", vit_cfg=tvit)
    state, m = step(W._state(params), *batch, torch.ones(cfg["n_hops"]), *FT_LRS)
    got = two[0][name]
    _close(got["losses"][0], float(m["loss"]), rtol=1e-5, atol=0)
    for path, w in _paths(state.params):
        g = got["params"]
        for k in path:
            g = g[k]
        _close(g, w, rtol=2e-4, atol=1e-6, msg=str(path))


# ---------------------------------------------------------------------------
# 4 ranks: the (2, 2) mesh
# ---------------------------------------------------------------------------

@pytest.mark.multiproc
@pytest.mark.parametrize("name", [s[0] for s in QUAD])
def test_four_rank_dp_tp_step_matches_single_process(quad, name):
    _check_step(quad, name, QUAD)
    for r in quad:
        assert r[name]["cls_w_local"] == (JCFG.multfeat_dim, JCFG.answer_size // 2)


@pytest.mark.multiproc
@pytest.mark.parametrize("name", ["dptp_fused", "dptp_unfused"])
def test_four_rank_dp_tp_step_matches_jax_sharded(quad, name):
    _, (n_data, n_model), tp, mk, tk = next(s for s in QUAD if s[0] == name)
    jstate, jm = jax_sharded(n_data, n_model, tp, mk, tk)
    got = quad[0][name]
    _close(got["losses"][-1], float(jm["loss"]), rtol=2e-4, atol=0)
    _close(got["params"]["mult"]["cls"]["w"],
           jax.device_get(jstate.params["mult"]["cls"]["w"]), rtol=2e-4, atol=2e-5)
