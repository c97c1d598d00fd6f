"""rau_vqa_tpu_torch — the PyTorch/CUDA port of rau_vqa_tpu for NVIDIA Hopper.

The JAX package ``rau_vqa_tpu`` is the reference; this package imports none
of it and no JAX.  Layout mirrors the JAX package:

- ``config``   — model and training configuration, presets
- ``convert``  — parameter interchange with the JAX package's tree
- ``devices``  — the entry points' device rule (cuda unless asked for the CPU)
- ``models``   — LSTM cells, the RAU forward (eval and fused training), hop
  aggregation, the ResNet-101 backbone and the from-pixels pipeline
- ``ops``      — hand-written CUDA kernels (``csrc/``) with plain versions,
  image normalization
- ``eval``     — prediction and the serving step
- ``train``    — losses, optimizers and the train step
"""

from rau_vqa_tpu_torch.config import (  # noqa: F401
    ModelConfig,
    TrainConfig,
    get_preset,
    get_train_preset,
)
