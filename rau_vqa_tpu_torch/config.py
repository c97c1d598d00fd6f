"""Model configuration for the PyTorch port.

An own copy of the architecture half of ``rau_vqa_tpu.config``: the port
imports nothing of the JAX package.  Defaults mirror the in-body constants
of the reference model (Ours_SS/LstmAttCtrlGradNoiseDontSelect.lua:202-228);
the presets carry the model dimensions of the paper's experiments.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters (field names as in the JAX package).
    The dropout rates come with the training slice."""

    vocab_size: int = 12605          # includes ZEROPAD at index 0
    answer_size: int = 1000          # netout_dim
    seq_len: int = 26                # max question length (h5 contract)

    embed_dim: int = 200             # word embedding
    rnn_size: int = 512              # question DeepLSTM hidden
    rnn_layers: int = 2              # question DeepLSTM depth

    cnn_dim: int = 512               # 512 VGG pool5 / 2048 ResNet
    cnn_w: int = 14
    cnn_h: int = 14
    multfeat_dim: int = 512          # multimodal feature dim
    attfeat_dim: int = 256           # attention hidden dim

    att_rnn_size: int = 512          # answering-unit LSTM hidden
    att_rnn_layers: int = 1          # answering-unit LSTM depth

    n_hops: int = 1                  # number of recurrent answering units

    @property
    def rnnout_dim(self) -> int:
        # packed (c, h) pairs for every layer (DeepLSTM.lua:22-25)
        return 2 * self.rnn_size * self.rnn_layers

    @property
    def att_state_dim(self) -> int:
        return self.att_rnn_size * self.att_rnn_layers

    @property
    def cnn_spat(self) -> int:
        return self.cnn_w * self.cnn_h


PRESETS = {
    "ours_ss": ModelConfig(n_hops=1, cnn_dim=512, cnn_w=14, cnn_h=14),
    "ours_ms": ModelConfig(n_hops=8, cnn_dim=512, cnn_w=14, cnn_h=14),
    "ours_full": ModelConfig(n_hops=8, cnn_dim=512, cnn_w=14, cnn_h=14),
    "ours_resnet": ModelConfig(n_hops=8, cnn_dim=2048, cnn_w=14, cnn_h=14),
    "ours_resnet_ft": ModelConfig(n_hops=8, cnn_dim=2048, cnn_w=14, cnn_h=14),
    "ours_vit": ModelConfig(n_hops=8, cnn_dim=1024, cnn_w=16, cnn_h=16),
}


def get_preset(name: str) -> ModelConfig:
    """The model dimensions of a named experiment preset."""
    try:
        return PRESETS[name]
    except KeyError:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(PRESETS)}")
