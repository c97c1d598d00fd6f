"""rau_vqa_tpu_torch — the PyTorch/CUDA port of rau_vqa_tpu for NVIDIA Hopper.

The JAX package ``rau_vqa_tpu`` is the reference; this package imports none
of it and no JAX.  Layout mirrors the JAX package:

- ``config``   — model, training, data and experiment configuration, presets
- ``convert``  — parameter interchange with the JAX package's tree
- ``devices``  — the entry points' device rule (cuda unless asked for the CPU)
- ``data``     — the prepro bundle's loader, feature stores, the Torch7
  reader, the fixture generator
- ``models``   — LSTM cells, the RAU forward (eval and fused training), hop
  aggregation, the ResNet-101 backbone and the from-pixels pipeline
- ``ops``      — hand-written CUDA kernels (``csrc/``) with plain versions,
  image normalization
- ``eval``     — prediction, the serving step, submission files, the
  official VQA scorer
- ``train``    — losses, optimizers, the train step and the ``Trainer``
- ``utils``    — checkpoints (the port's and the JAX package's msgpack
  snapshots), metrics logging, curves
- ``cli``      — ``python -m rau_vqa_tpu_torch.cli train|eval|ask|fixture``
"""

from rau_vqa_tpu_torch.config import (  # noqa: F401
    ModelConfig,
    TrainConfig,
    get_preset,
    get_train_preset,
)
