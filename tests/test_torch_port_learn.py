"""The fixture-learning gate on the port (tests/test_train.py:339-356): the
port's Trainer, at the tiny configuration of tests/test_train.py:190-215,
30 epochs on the port's fixture written to disk (data_prepro.h5 by
data/hdf5.py, the .t7 features) on the CPU, from the JAX test's initial
weights (its Trainer's ``PRNGKey`` init through convert.py).  The fixture is
learnable by construction: best OE above 0.5 (chance is 0.2), the hop-1 OE
and MC submission files, 30 logged train rows, the last a completed epoch.

From the port's own init (``torch.Generator``) the same run learns too (OE
0.875) but the loss-explosion guard, the JAX package's rule (a batch loss
above 3x the EMA, ``rau_vqa_tpu/train/trainer.py:725``), rejects epochs 29
and 30 once the loss is down to ~0.3: the last rows are aborted epochs."""

import dataclasses
import os

import jax
import numpy as np
import pytest

from rau_vqa_tpu_torch.config import get_experiment
from rau_vqa_tpu_torch.convert import params_from_jax
from rau_vqa_tpu_torch.data.features import T7DirFeatureSource
from rau_vqa_tpu_torch.data.fixtures import FixtureSpec, generate_fixture
from rau_vqa_tpu_torch.data.loader import load_gt_annotations, load_vqa_data
from rau_vqa_tpu_torch.train.trainer import Trainer

SPEC = FixtureSpec()


def tiny_trainer(root, workdir, **model):
    """tests/test_train.py make_trainer on the port: the fast learning-rate
    regime of the 10-step epochs."""
    vqa_dir = generate_fixture(root, SPEC)
    exp = get_experiment("ours_ms")
    exp = exp.replace(
        model=dataclasses.replace(
            exp.model, n_hops=2, cnn_dim=SPEC.feat_dim, cnn_w=SPEC.feat_w,
            cnn_h=SPEC.feat_h, embed_dim=16, rnn_size=16, multfeat_dim=16,
            attfeat_dim=8, att_rnn_size=16, embed_dropout=0.0, rnn_dropout=0.0,
            mult_dropout=0.1, **model),
        train=dataclasses.replace(
            exp.train, batch_size=16, learning_rate=1e-2, mult_learning_rate=1e-2,
            lr_decay=1.0, mult_lr_decay=1.0, noisy_eta=0.0, grad_clip=10.0,
            length_buckets=()),
        data=dataclasses.replace(exp.data, split="val2014"))
    data = load_vqa_data(vqa_dir, batch_size=16, split="val2014", test_batch_size=8)
    src = T7DirFeatureSource([os.path.join(root, "feat")], SPEC.feat_dim,
                             SPEC.feat_w, SPEC.feat_h)
    gt = load_gt_annotations(os.path.join(vqa_dir, "gt_annotations.json"))
    return Trainer(exp, data, src, workdir, gt_anno=gt, device="cpu")


@pytest.mark.slow
def test_trainer_learns_fixture(tmp_path):
    from rau_vqa_tpu.data.fixtures import generate_fixture as jax_fixture
    from tests.test_train import make_trainer

    trainer = tiny_trainer(str(tmp_path / "fixture"), str(tmp_path / "run"))
    jax_fixture(str(tmp_path / "jax_fixture"), SPEC)
    init = params_from_jax(jax.tree.map(np.asarray, make_trainer(
        str(tmp_path / "jax_fixture"), str(tmp_path / "jax_run")).state.params))
    trainer.state = trainer.state._replace(params=init)
    trainer._fallback_state = trainer._fallback_state._replace(params=init)
    trainer.fit(epochs=30, eval_each=False)
    result = trainer.evaluate()
    oe = result["testOEacc"]
    assert max(oe) > 0.5, f"fixture not learned: {oe}"
    files = os.listdir(os.path.join(str(tmp_path / "run"), "results", "hop_01"))
    assert any(f.startswith("vqa_OpenEnded_mscoco_val2014_") for f in files)
    assert any(f.startswith("vqa_MultipleChoice_mscoco_val2014_") for f in files)
    rows = trainer.logger.read(kind="train")
    assert len(rows) == 30
    assert "trainacc_01" in rows[-1] and "trainloss_02" in rows[-1]
