"""The port's checkpoints (rau_vqa_tpu_torch/utils/checkpoint.py) and its
msgpack decoder (utils/msgpack_flax.py), on the CPU.

Bars: bit-exact.  The port's own snapshots round-trip every leaf and the
sidecar; the decoder gives every leaf of ``flax.serialization.to_bytes``
bit for bit; a JAX Trainer's snapshot restores into the port as
``params_from_jax`` of JAX's state, bit for bit, and answers the test split
with JAX's answer ids, scores within tests/test_torch_port_predict.py's
rtol 1e-4 / atol 1e-5."""

import dataclasses
import json
import os
import time

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rau_vqa_tpu.eval import predict as jpred
from rau_vqa_tpu_torch.convert import map_tree, params_from_jax, tree_leaves
from rau_vqa_tpu_torch.eval import predict as tpred
from rau_vqa_tpu_torch.utils import checkpoint as ck
from rau_vqa_tpu_torch.utils import msgpack_flax
from tests.test_torch_port_trainer import (  # noqa: F401 (an autouse fixture)
    DROPOUT,
    SPEC,
    assert_same_state,
    jax_trainer,
    one_torch_thread,
    port_trainer,
)


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    from rau_vqa_tpu.data.fixtures import generate_fixture
    root = str(tmp_path_factory.mktemp("port_ckpt_fixture"))
    generate_fixture(root, SPEC)
    return root


@pytest.fixture(autouse=True)
def clean_queue():
    yield
    ck._pending.clear()


def same_bits(a, b):
    """Every leaf of the trees ``a`` and ``b`` (matched by key) bit-equal."""
    out = []
    map_tree(lambda x, y: out.append(x.dtype == y.dtype and bits(x) == bits(y)),
             a, b)
    assert out and all(out)


def bits(x):
    """A leaf's raw bytes (tensor or numpy), for bit-exact comparison."""
    if torch.is_tensor(x):
        x = x.contiguous()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().tobytes(), tuple(x.shape)
    x = np.asarray(x)
    return x.tobytes(), x.shape


# ---------------------------------------------------------------------------
# the port's own snapshots
# ---------------------------------------------------------------------------

def test_snapshot_round_trip(fixture_root, tmp_path):
    """Params, Adam m/v/t, step, seed, lr, mult_lr, loss_ema, epoch and the
    sidecar's model_config come back (tests/test_train.py:360)."""
    a = port_trainer(fixture_root, tmp_path / "a", DROPOUT, {"lr_decay": 0.9})
    a.fit(epochs=2, eval_each=False)
    path = a.save()
    assert os.path.basename(path) == "snapshot_iter000020_epoch2.00.pt"
    torch.load(path, weights_only=True)      # plain tensors and ints
    b = port_trainer(fixture_root, tmp_path / "b", DROPOUT, {"lr_decay": 0.9})
    b.restore(path)
    assert_same_state(a.state, b.state)
    assert (b.lr, b.mult_lr, b.loss_ema, b.epoch) == \
        (a.lr, a.mult_lr, a.loss_ema, a.epoch)
    assert b.data.train_data.reorder_count == 3
    meta = ck.checkpoint_meta(path)
    assert ck.model_config_from_meta(meta["model_config"]) == a.mcfg
    assert meta["alg_name"] == a.exp.alg_name and meta["step"] == 20
    assert ck.latest_checkpoint(a.ckpt_dir) == path


def test_background_save_is_byte_identical(fixture_root, tmp_path):
    """(tests/test_train.py:382)"""
    tr = port_trainer(fixture_root, tmp_path / "run")
    tr.fit(epochs=1, eval_each=False)
    p_sync = tr.save()
    tr.ckpt_dir = str(tmp_path / "run" / "bg")
    p_bg = tr.save(background=True)
    assert ck.latest_checkpoint(tr.ckpt_dir) == p_bg   # flushes
    for suffix in (".pt", ".json"):
        with open(p_sync[:-3] + suffix, "rb") as f1, \
                open(p_bg[:-3] + suffix, "rb") as f2:
            assert f1.read() == f2.read()


def test_keep_last_prunes_by_parsed_step(tmp_path):
    d = str(tmp_path / "c")
    for step in (999_998, 999_999, 1_000_000, 1_000_001):
        ck.save_checkpoint(d, step, 1.0, {"x": torch.zeros(2)}, keep_last=2)
    left = sorted(f for f in os.listdir(d) if f.endswith(".pt"))
    assert left == [ck.checkpoint_name(1_000_000, 1.0) + ".pt",
                    ck.checkpoint_name(1_000_001, 1.0) + ".pt"]
    assert sorted(f for f in os.listdir(d) if f.endswith(".json")) == \
        [n[:-3] + ".json" for n in left]


def test_shape_and_structure_mismatches_raise(tmp_path):
    tree = {"params": {"w": torch.ones(3, 2), "layers": [torch.zeros(4)]},
            "step": 7}
    path = ck.save_checkpoint(str(tmp_path), 7, 1.0, tree)
    got, meta = ck.load_checkpoint(path, tree)
    assert meta["step"] == 7 and got["step"] == 7
    for bad in ({"params": {"w": torch.ones(2, 3), "layers": [torch.zeros(4)]},
                 "step": 7},
                {"params": {"w": torch.ones(3, 2), "layers": [torch.zeros(4)],
                            "extra": torch.zeros(1)}, "step": 7},
                {"params": {"w": torch.ones(3, 2, dtype=torch.float64),
                            "layers": [torch.zeros(4)]}, "step": 7}):
        with pytest.raises(ValueError, match="mismatch"):
            ck.load_checkpoint(path, bad)


def test_flush_surfaces_write_errors(tmp_path, monkeypatch):
    """(tests/test_train.py:632)"""
    def boom(*a, **k):
        raise OSError("disk full (simulated)")

    monkeypatch.setattr(ck, "_write", boom)
    ck.save_checkpoint(str(tmp_path / "c"), 1, 1.0, {"x": torch.zeros(2)},
                       background=True)
    with pytest.raises(OSError, match="disk full"):
        ck.flush_checkpoint_writes()
    ck.flush_checkpoint_writes()       # raised once, then clean


def test_save_drains_pending_first(tmp_path, monkeypatch):
    """(tests/test_train.py:650)"""
    real_write, calls = ck._write, []

    def slow_write(ckpt_dir, name, path, host_tree, meta, keep_last):
        if not calls:
            time.sleep(0.3)
        calls.append(name)
        real_write(ckpt_dir, name, path, host_tree, meta, keep_last)

    monkeypatch.setattr(ck, "_write", slow_write)
    d = str(tmp_path / "c")
    ck.save_checkpoint(d, 1, 1.0, {"x": torch.zeros(2)}, background=True)
    p2 = ck.save_checkpoint(d, 2, 2.0, {"x": torch.ones(2)})
    assert calls == [ck.checkpoint_name(1, 1.0), ck.checkpoint_name(2, 2.0)]
    assert ck.latest_checkpoint(d) == p2


def test_flush_interrupted_requeues():
    """(tests/test_train.py:763)"""
    class InterruptOnce:
        hits = 0

        def result(self):
            self.hits += 1
            if self.hits == 1:
                raise KeyboardInterrupt

    class Done:
        waited = False

        def result(self):
            self.waited = True

    ki, done = InterruptOnce(), Done()
    ck._pending.extend([ck._failed_future(OSError("disk full")), ki, done])
    with pytest.raises(KeyboardInterrupt):
        ck.flush_checkpoint_writes()
    assert len(ck._pending) == 3 and not done.waited
    with pytest.raises(OSError, match="disk full"):
        ck.flush_checkpoint_writes()
    assert done.waited and ki.hits == 2 and not ck._pending


@pytest.mark.parametrize("case", ["epoch_raises", "write_fails_too",
                                  "caller_in_handler"])
def test_fit_flush_rules(fixture_root, tmp_path, monkeypatch, case):
    """fit's finally: a queued snapshot lands even when an epoch raises; a
    write error does not mask the training error; a successful fit raises
    a pending write error even inside a caller's except block
    (tests/test_train.py:679-760)."""
    import warnings
    tr = port_trainer(fixture_root, tmp_path / "run")
    tr.tcfg = dataclasses.replace(tr.tcfg, checkpoint_interval=1)
    if case != "epoch_raises":
        monkeypatch.setattr(
            ck, "_write",
            lambda *a, **k: (_ for _ in ()).throw(OSError("disk full")))
    if case == "caller_in_handler":
        ck.save_checkpoint(tr.ckpt_dir, 1, 1.0, {"x": torch.zeros(2)},
                           background=True)
        try:
            raise KeyError("handled by the caller")
        except KeyError:
            with pytest.raises(OSError, match="disk full"):
                tr.fit(epochs=1, eval_each=False)
        return
    orig, calls = tr.train_epoch, []

    def epoch_then_boom():
        if calls:
            raise RuntimeError("epoch 2 dies (simulated)")
        calls.append(1)
        return orig()

    monkeypatch.setattr(tr, "train_epoch", epoch_then_boom)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        with pytest.raises(RuntimeError, match="epoch 2 dies"):
            tr.fit(epochs=2, eval_each=False)
    assert not ck._pending
    if case == "epoch_raises":
        latest = ck.latest_checkpoint(tr.ckpt_dir)
        assert latest is not None and os.path.getsize(latest) > 0
    else:
        assert any("checkpoint write also failed" in str(x.message) for x in w)


def test_own_format_fuzz_round_trip(tmp_path):
    """Random trees of every leaf type the snapshots may hold come back bit
    for bit, and a mutated shape is refused (tests/test_train.py:801)."""
    rs = np.random.RandomState(7)
    dtypes = [torch.float32, torch.float16, torch.bfloat16, torch.int32,
              torch.int8, torch.bool]

    def leaf():
        dt = dtypes[rs.randint(len(dtypes))]
        shape = tuple(int(rs.randint(0, 5)) for _ in range(rs.randint(0, 4)))
        raw = torch.from_numpy(np.asarray(rs.randn(*shape) * 100))
        return raw > 0 if dt is torch.bool else raw.to(dt)

    def tree(depth):
        if depth == 0 or rs.rand() < 0.3:
            return leaf()
        if rs.rand() < 0.3:
            return [tree(depth - 1) for _ in range(rs.randint(1, 3))]
        return {f"k{i}": tree(depth - 1) for i in range(rs.randint(1, 4))}

    for trial in range(10):
        t = {"params": tree(3), "step": int(rs.randint(1 << 30)),
             "big": int(rs.randint(1 << 30)) << 20}
        path = ck.save_checkpoint(str(tmp_path / f"f{trial}"), trial,
                                  float(trial), t)
        got, _ = ck.load_checkpoint(path, t)
        assert got["step"] == t["step"] and got["big"] == t["big"]
        for a, b in zip(tree_leaves(t), tree_leaves(got)):
            if torch.is_tensor(a):
                assert a.dtype == b.dtype and bits(a) == bits(b)
        arrays = [x for x in tree_leaves(t["params"])
                  if torch.is_tensor(x) and x.dim() > 0]
        if arrays:
            victim = arrays[rs.randint(len(arrays))]
            bad = map_tree(lambda x: torch.zeros(tuple(s + 1 for s in x.shape),
                                                 dtype=x.dtype)
                           if x is victim else x, t)
            with pytest.raises(ValueError):
                ck.load_checkpoint(path, bad)


# ---------------------------------------------------------------------------
# the msgpack decoder
# ---------------------------------------------------------------------------

def _flax_leaf_bits(x):
    x = np.asarray(x)
    if x.dtype == jnp.bfloat16:
        x = x.view(np.int16)
    return x.tobytes(), x.shape


@pytest.mark.parametrize("seed", range(4))
def test_decoder_matches_flax(seed):
    """flax's own bytes: f32, f16, bf16, i32, i8 and bool arrays, 0-d and
    zero-length ones, numpy scalars, Python scalars, ints past 32 bits
    (tests/test_train.py:801-863), every leaf bit-equal."""
    rs = np.random.RandomState(seed)
    dtypes = [np.float32, np.float16, jnp.bfloat16, np.int32, np.int8,
              np.bool_]

    def leaf():
        kind = rs.randint(6)
        if kind == 0:
            return [3.25, -1.5e300, 7, -(1 << 40), (1 << 63) - 1, -(1 << 63),
                    None, True, "t" * int(rs.randint(0, 300))][rs.randint(9)]
        if kind == 1:
            return np.float32(rs.randn()) if rs.rand() < 0.5 \
                else np.int64(rs.randint(-9, 9) << 35)
        dt = dtypes[rs.randint(len(dtypes))]
        shape = tuple(int(rs.randint(0, 5)) for _ in range(rs.randint(0, 4)))
        raw = np.asarray(rs.randn(*shape)) * 100
        return np.asarray(raw > 0) if dt is np.bool_ else np.asarray(raw.astype(dt))

    def tree(depth):
        if depth == 0 or rs.rand() < 0.3:
            return leaf()
        if rs.rand() < 0.2:
            return [tree(depth - 1) for _ in range(rs.randint(1, 3))]
        return {f"k{i}": tree(depth - 1) for i in range(rs.randint(1, 4))}

    for _ in range(8):
        t = {"params": tree(4), "step": np.asarray(5, np.int32),
             "rng": np.asarray([7, 1 << 31], np.uint32)}
        data = fser.to_bytes(t)
        want = fser.msgpack_restore(data)
        got = msgpack_flax.loads(data)
        flat_w = jax.tree_util.tree_leaves_with_path(
            want, is_leaf=lambda x: x is None)
        flat_g = jax.tree_util.tree_leaves_with_path(
            got, is_leaf=lambda x: x is None or torch.is_tensor(x))
        assert [k for k, _ in flat_w] == [k for k, _ in flat_g]
        for (k, w), (_, g) in zip(flat_w, flat_g):
            if isinstance(w, (np.ndarray, np.generic)):
                assert torch.is_tensor(g), k
                assert bits(g) == _flax_leaf_bits(w), k
                assert str(g.dtype).split(".")[1] == np.asarray(w).dtype.name, k
            else:
                assert type(g) is type(w) and g == w, k


def test_decoder_joins_chunked_arrays(monkeypatch):
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 64)
    big = np.arange(100, dtype=np.float32).reshape(4, 25)
    data = fser.to_bytes({"w": big, "small": np.ones(3, np.float32)})
    assert b"__msgpack_chunked_array__" in data
    got = msgpack_flax.loads(data)
    np.testing.assert_array_equal(got["w"].numpy(), big)
    np.testing.assert_array_equal(got["small"].numpy(), np.ones(3))


def test_decoder_refuses_what_it_does_not_read():
    import msgpack
    for bad in (fser.to_bytes({"c": 1 + 2j}),                 # ext 2
                msgpack.packb(msgpack.ExtType(9, b"x")),
                b"\xc1",                                      # never used
                fser.to_bytes({"w": np.ones(3)})[:-2],        # truncated
                msgpack.packb(1) + b"\x00",                   # trailing
                msgpack.packb(msgpack.ExtType(                # complex64
                    1, msgpack.packb(((2,), "complex64", b"\0" * 16))))):
        with pytest.raises(ValueError):
            msgpack_flax.loads(bad)


# ---------------------------------------------------------------------------
# the JAX package's snapshots
# ---------------------------------------------------------------------------

def test_jax_snapshot_restores_into_the_port(fixture_root, tmp_path, capsys):
    """The golden protocol across packages (tests/test_torch_convert.py:
    247-285): a JAX Trainer fits one epoch and saves; the port restores the
    .msgpack with params and Adam state equal to params_from_jax of JAX's
    bit for bit, adopts step, epoch and LR, and answers the test split with
    JAX's answer ids."""
    jt = jax_trainer(fixture_root, tmp_path / "jax", train={"lr_decay": 0.9})
    jt.fit(epochs=1, eval_each=False)
    path = jt.save()
    assert path.endswith("snapshot_iter000010_epoch1.00.msgpack")
    tt = port_trainer(fixture_root, tmp_path / "port", train={"lr_decay": 0.9},
                      fused_eval=False)
    seed = tt.state.seed
    tt.restore(path)
    assert "PRNG key" in capsys.readouterr().out
    same_bits(tt.state.params,
              params_from_jax(jax.tree.map(np.asarray, jt.state.params)))
    for g in ("embed", "rnn", "mult"):
        for k in ("m", "v"):
            same_bits(tt.state.opt[g][k], params_from_jax(
                jax.tree.map(np.asarray, jt.state.opt[g][k])))
        assert int(tt.state.opt[g]["t"]) == int(jt.state.opt[g]["t"]) == 10
        assert tt.state.opt[g]["t"].dtype == torch.int32
    assert tt.state.step == int(jt.state.step) == 10
    assert tt.state.seed == seed
    assert (tt.epoch, tt.lr, tt.mult_lr, tt.loss_ema) == \
        (jt.epoch, jt.lr, jt.mult_lr, jt.loss_ema)
    assert tt.lr == pytest.approx(1e-2 * 0.9)
    assert ck.model_config_from_meta(ck.checkpoint_meta(path)["model_config"],
                                     from_jax=True) == \
        dataclasses.replace(tt.mcfg, fused_train_bwd="kernel")
    # answer ids on the test split, and the scores behind them
    a = jt.evaluate(write_submissions=False, return_rows=True)
    b = tt.evaluate(write_submissions=False, return_rows=True)
    assert b["rows_oe"] == a["rows_oe"] and b["rows_mc"] == a["rows_mc"]
    test = tt.data.test_data
    test.inorder()
    batch = next(test.batches(tt.source))
    jtab, _ = jpred.predict(jt.state.params, jt.mcfg, jnp.asarray(batch.tokens),
                            jnp.asarray(batch.lengths), jnp.asarray(batch.feats))
    ttab, _ = tpred.predict(tt.state.params, tt.mcfg, torch.as_tensor(batch.tokens),
                            torch.as_tensor(batch.lengths),
                            torch.as_tensor(batch.feats))
    np.testing.assert_allclose(ttab.numpy(), np.asarray(jtab), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(ttab.argmax(-1).numpy(),
                                  np.asarray(jtab).argmax(-1))


def test_jax_meta_fields(tmp_path):
    """The JAX-only model fields are accepted at the port's values and
    refused otherwise; a snapshot with a backbone group is refused."""
    from rau_vqa_tpu.config import ModelConfig as JaxModelConfig
    mc = dataclasses.asdict(JaxModelConfig(n_hops=3, fused_train_block=8))
    cfg = ck.model_config_from_meta(mc, from_jax=True)
    assert cfg.n_hops == 3 and cfg.fused_train_bwd == "kernel"
    for field, value in (("param_dtype", "bfloat16"),
                         ("matmul_precision", "fastest")):
        with pytest.raises(ValueError, match=field):
            ck.model_config_from_meta({**mc, field: value}, from_jax=True)
    with pytest.raises(ValueError, match="not know"):
        ck.model_config_from_meta({**mc, "new_field": 1})
    d = tmp_path / "s"
    d.mkdir()
    path = d / "snapshot_iter000001_epoch1.00.msgpack"
    path.write_bytes(fser.to_bytes({"params": {"backbone": {"w": np.ones(2)}},
                                    "opt": {}, "step": np.asarray(1),
                                    "rng": np.zeros(2, np.uint32)}))
    (d / "snapshot_iter000001_epoch1.00.json").write_text(json.dumps({"epoch": 1}))
    (d / "LATEST").write_text("snapshot_iter000001_epoch1.00")
    assert ck.latest_checkpoint(str(d)) == str(path)
    with pytest.raises(NotImplementedError,
                       match=r"fine-tuning is still to port \(ROADMAP.md, queue 1, item 5"):
        ck.load_checkpoint(str(path), {"params": {}, "opt": {}, "step": 0,
                                       "seed": 0})
