"""rau_vqa_tpu_torch — the PyTorch/CUDA port of rau_vqa_tpu for NVIDIA Hopper.

The JAX package ``rau_vqa_tpu`` is the reference; this package imports none
of it and no JAX.  Layout mirrors the JAX package:

- ``config``   — model configuration and presets
- ``convert``  — parameter interchange with the JAX package's tree
- ``models``   — LSTM cells, the RAU eval forward, hop aggregation
- ``ops``      — hand-written CUDA kernels (``csrc/``) with plain versions
- ``eval``     — prediction and the serving step
"""

from rau_vqa_tpu_torch.config import ModelConfig, get_preset  # noqa: F401
