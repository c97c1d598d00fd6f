"""The port's Torch7 snapshot converter (rau_vqa_tpu_torch/utils/
torch_convert.py) and its ``convert-snapshot`` command against the JAX
package's (rau_vqa_tpu/utils/torch_convert.py, rau_vqa_tpu/cli.py), on the
CPU.

Bars: bit for bit (layouts, converted params, written bytes); predictions
of the converted snapshots through the plain float32 path at rtol 1e-4 /
atol 1e-5 (tests/test_torch_port_predict.py's plain bar), answer ids
equal."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from rau_vqa_tpu import cli as jcli
from rau_vqa_tpu.config import ModelConfig as JaxModelConfig
from rau_vqa_tpu.config import get_preset as jax_get_preset
from rau_vqa_tpu.eval import predict as jpred
from rau_vqa_tpu.models.rau import init_params as jax_init_params
from rau_vqa_tpu.train.trainer import init_train_state as jax_init_state
from rau_vqa_tpu.utils import checkpoint as jck
from rau_vqa_tpu.utils import torch_convert as jtc
from rau_vqa_tpu_torch import cli as tcli
from rau_vqa_tpu_torch.config import ModelConfig, get_preset
from rau_vqa_tpu_torch.convert import map_tree, params_from_jax, tree_leaves
from rau_vqa_tpu_torch.eval import predict as tpred
from rau_vqa_tpu_torch.models.rau import init_params
from rau_vqa_tpu_torch.train.trainer import init_train_state
from rau_vqa_tpu_torch.utils import checkpoint as tck
from rau_vqa_tpu_torch.utils import torch_convert as ttc
from tests.test_torch_port_trainer import (  # noqa: F401 (an autouse fixture)
    SPEC,
    jax_trainer,
    jfix,
    one_torch_thread,
)

DIMS = dict(vocab_size=50, answer_size=17, seq_len=9, embed_dim=8,
            rnn_size=16, rnn_layers=2, cnn_dim=12, cnn_w=3, cnn_h=2,
            multfeat_dim=16, attfeat_dim=8, att_rnn_size=16,
            att_rnn_layers=2, n_hops=3)
JCFG = JaxModelConfig(**DIMS)
TCFG = ModelConfig(**DIMS)
GROUPS = ("embed", "rnn", "mult")


def same_bits(got, want):
    pairs = []
    map_tree(lambda a, b: pairs.append((a, b)), got, want)
    assert pairs and len(pairs) == len(tree_leaves(want))
    for a, b in pairs:
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("preset", ["ours_ss", "ours_ms", "ours_resnet"])
def test_layouts_and_group_sizes_are_jax(preset):
    jc, tc = jax_get_preset(preset).model, get_preset(preset)
    for g in GROUPS:
        assert ttc.GROUP_LAYOUTS[g](tc) == jtc.GROUP_LAYOUTS[g](jc)
        assert ttc.group_size(tc, g) == jtc.group_size(jc, g)


def test_group_sizes_count_the_ports_params():
    p = init_params(TCFG, torch.Generator().manual_seed(0), "cpu")
    for g in GROUPS:
        assert ttc.group_size(TCFG, g) == sum(x.numel() for x in tree_leaves(p[g]))


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(0), JCFG))


def test_convert_of_a_jax_export_is_params_from_jax(jax_params, tmp_path):
    path = str(tmp_path / "snap.t7")
    jtc.export_snapshot(path, jax_params, JCFG, it=42, epoch=3.0)
    got = ttc.convert_snapshot(path, TCFG)
    same_bits(got, params_from_jax(jtc.convert_snapshot(path, JCFG)))
    # and the round trip gives the params back
    same_bits(got, params_from_jax(jax_params))


def test_export_writes_the_jax_bytes(jax_params, tmp_path):
    opt = {"nhop": 3.0, "alg_name": "LstmAttCtrlGradNoiseDontSelect448Pool5"}
    jtc.export_snapshot(str(tmp_path / "j.t7"), jax_params, JCFG, it=7,
                        epoch=1.5, opt=opt)
    ttc.export_snapshot(str(tmp_path / "t.t7"), params_from_jax(jax_params),
                        TCFG, it=7, epoch=1.5, opt=opt)
    assert (tmp_path / "t.t7").read_bytes() == (tmp_path / "j.t7").read_bytes()
    for g in GROUPS:
        want = jtc.group_to_flat(jax_params[g], JCFG, g)
        got = ttc.group_to_flat(params_from_jax(jax_params)[g], TCFG, g)
        assert got.dtype == want.dtype == np.float64
        np.testing.assert_array_equal(got, want)
        # numpy leaves too, as the JAX side hands them over
        np.testing.assert_array_equal(ttc.group_to_flat(jax_params[g], TCFG, g), want)


def test_wrong_sizes_are_refused(jax_params):
    flat = jtc.group_to_flat(jax_params["mult"], JCFG, "mult")
    with pytest.raises(ValueError, match="model dims disagree"):
        ttc.flat_to_group(flat[:-1], TCFG, "mult")
    with pytest.raises(ValueError, match="layout"):
        ttc.group_to_flat({"lookup": torch.zeros(3, 3)}, TCFG, "embed")
    with pytest.raises(ValueError, match="snapshot table"):
        ttc.flats_from_snapshot([1, 2, 3])


def test_cli_converts_both_ways_as_the_jax_cli(tmp_path):
    """A JAX snapshot -> .t7 by each CLI (the same bytes); each CLI's .t7
    -> its own snapshot; the port's .pt holds params_from_jax of the JAX
    CLI's .msgpack, and predicts what it predicts."""
    root = str(tmp_path / "fix")
    jfix.generate_fixture(root, SPEC)
    jt = jax_trainer(root, str(tmp_path / "run"))
    ck = jt.save()
    mcfg = jt.mcfg
    dims = ["--vocab-size", str(mcfg.vocab_size), "--answer-size",
            str(mcfg.answer_size), "--seq-len", str(mcfg.seq_len)]
    t7 = {k: str(tmp_path / f"{k}.t7") for k in ("jax", "port")}
    assert jcli.main(["convert-snapshot", "--to-torch", "--input", ck,
                      "--output", t7["jax"]] + dims) == 0
    assert tcli.main(["convert-snapshot", "--to-torch", "--input", ck,
                      "--output", t7["port"]] + dims) == 0
    with open(t7["jax"], "rb") as a, open(t7["port"], "rb") as b:
        assert a.read() == b.read()
    cfg_json = str(tmp_path / "config.json")
    with open(cfg_json, "w") as f:
        json.dump({"model": dataclasses.asdict(mcfg)}, f)
    back = ["--config-json", cfg_json] + dims
    assert jcli.main(["convert-snapshot", "--input", t7["jax"], "--output",
                      str(tmp_path / "back.msgpack")] + back) == 0
    pt = str(tmp_path / "back.pt")
    assert tcli.main(["convert-snapshot", "--input", t7["port"], "--output",
                      pt] + back) == 0
    assert sorted(os.listdir(tmp_path)) == sorted(
        ["back.json", "back.msgpack", "back.pt", "config.json", "fix",
         "jax.t7", "port.t7", "run"])   # --output literally, no leftovers
    meta = tck.checkpoint_meta(pt)
    assert meta["converted_from"] == t7["port"]
    tcfg = tck.model_config_from_meta(meta["model_config"])
    assert tcfg == tck.model_config_from_meta(dataclasses.asdict(mcfg),
                                              from_jax=True)

    template = init_train_state(tcfg, 0, device="cpu")._asdict()
    port_tree, _ = tck.load_checkpoint(pt, template)
    jtree, _ = jck.load_checkpoint(str(tmp_path / "back.msgpack"),
                                   jax_init_state(jax.random.PRNGKey(0), mcfg)._asdict())
    jparams = jax.tree.map(np.asarray, jtree["params"])
    same_bits(port_tree["params"], params_from_jax(jparams))
    # and the round trip kept the trained snapshot's params
    same_bits(port_tree["params"],
              params_from_jax(jax.tree.map(np.asarray, jt.state.params)))

    batch = next(iter(jt.data.test_data.batches(jt.source)))
    want, _ = jpred.predict(jparams, mcfg, batch.tokens, batch.lengths, batch.feats)
    got, _ = tpred.predict(port_tree["params"], tcfg, torch.as_tensor(batch.tokens),
                           torch.as_tensor(batch.lengths), torch.as_tensor(batch.feats))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(tpred.compute_answers(got)[0].numpy(),
                                  np.asarray(jpred.compute_answers(want)[0]))
    # the .pt converts back to the same .t7
    again = str(tmp_path / "again.t7")
    assert tcli.main(["convert-snapshot", "--to-torch", "--input", pt,
                      "--output", again] + dims) == 0
    with open(again, "rb") as a, open(t7["jax"], "rb") as b:
        assert a.read() == b.read()
