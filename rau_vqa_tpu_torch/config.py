"""Model and training configuration for the PyTorch port.

An own copy of the architecture and optimization halves of
``rau_vqa_tpu.config``: the port imports nothing of the JAX package.
Defaults mirror the in-body constants of the reference model
(Ours_SS/LstmAttCtrlGradNoiseDontSelect.lua:202-228, optimization at
:39-55); the presets carry the dimensions and training knobs of the paper's
experiments.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters (field names as in the JAX package)."""

    vocab_size: int = 12605          # includes ZEROPAD at index 0
    answer_size: int = 1000          # netout_dim
    seq_len: int = 26                # max question length (h5 contract)

    embed_dim: int = 200             # word embedding
    rnn_size: int = 512              # question DeepLSTM hidden
    rnn_layers: int = 2              # question DeepLSTM depth
    rnn_dropout: float = 0.5         # inter-layer dropout (reference :211)
    embed_dropout: float = 0.5       # word-embed dropout (reference :205)

    cnn_dim: int = 512               # 512 VGG pool5 / 2048 ResNet
    cnn_w: int = 14
    cnn_h: int = 14
    multfeat_dim: int = 512          # multimodal feature dim
    attfeat_dim: int = 256           # attention hidden dim

    att_rnn_size: int = 512          # answering-unit LSTM hidden
    att_rnn_layers: int = 1          # answering-unit LSTM depth
    att_rnn_dropout: float = 0.0     # answering-unit LSTM dropout (:227)
    mult_dropout: float = 0.5        # q-proj input / image feat / merge (:233,:239,:277)

    n_hops: int = 1                  # number of recurrent answering units

    # the training forward's type: "bfloat16" (what the JAX CLI's --bf16
    # gives any preset, and the ours_resnet_ft preset) casts every param and
    # the features to bf16 on entry; the fused hop loop then takes bf16
    # operands with float32 sums
    compute_dtype: str = "float32"
    # run the training hop loop through the fused kernel pair
    # (ops/rau_train_hops.py), with counter-hash dropout masks
    fused_train: bool = False
    # backward of the fused hop loop: "kernel" runs the backward CUDA kernel;
    # "xla" (the JAX name) runs autograd through the plain version.  The JAX
    # package defaults to "xla" only because its Pallas backward compiles
    # pathologically under Mosaic (rau_vqa_tpu/ops/rau_train_hops.py:619-625);
    # nvcc builds the CUDA backward in seconds, so the port defaults to it.
    fused_train_bwd: str = "kernel"
    # unfused path: recompute each hop in the backward instead of saving its
    # [B, S, M]-sized activations (torch.utils.checkpoint)
    remat_hops: bool = False

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


@dataclass(frozen=True)
class TrainConfig:
    """The optimization knobs that ``make_train_step`` reads (reference
    :39-55, :597-629; Adam internals optim_updates.lua:59-62)."""

    batch_size: int = 100
    learning_rate: float = 3e-3       # embed + rnn groups
    mult_learning_rate: float = 3e-4  # multimodal group
    grad_clip: float = 0.1            # per-group L2 norm clip
    noisy_eta: float = 0.01           # gradient noise
    noisy_gamma: float = 0.55
    seed: int = 123
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8
    # SS scales each hop's CE gradient by nHop (Ours_SS/...lua:569)
    hop_grad_scale_nhop: bool = False
    # Full/ResNet per-hop early-stop curriculum (Ours_Full/...lua:414-429)
    hop_stop_timing: Optional[Tuple[int, ...]] = None
    # k sequential microbatch backward passes per optimizer update (exact)
    grad_accum: int = 1
    # backbone fine-tuning belongs to the from-pixels slice of the port
    train_backbone: bool = False


# Early-stop tables, 1-indexed by hop in the reference; stored 0-indexed.
# Ours_Full/LstmAttCtrlGradNoiseDontSelect.lua:414-429
_FULL_STOP_TIMING = (1000, 35, 25, 20, 18, 16, 16, 16, 16, 1000)
# Ours_ResNet/LstmAttCtrlGradNoiseDontSelect.lua:416-427
_RESNET_STOP_TIMING = (1000, 30, 24, 20, 18, 16, 16, 15, 1000, 1000)

TRAIN_PRESETS = {
    "ours_ss": (ModelConfig(n_hops=1, cnn_dim=512, cnn_w=14, cnn_h=14),
                TrainConfig(hop_grad_scale_nhop=True)),
    "ours_ms": (ModelConfig(n_hops=8, cnn_dim=512, cnn_w=14, cnn_h=14),
                TrainConfig()),
    "ours_full": (ModelConfig(n_hops=8, cnn_dim=512, cnn_w=14, cnn_h=14),
                  TrainConfig(hop_stop_timing=_FULL_STOP_TIMING)),
    "ours_resnet": (ModelConfig(n_hops=8, cnn_dim=2048, cnn_w=14, cnn_h=14),
                    TrainConfig(batch_size=80,
                                hop_stop_timing=_RESNET_STOP_TIMING)),
    "ours_resnet_ft": (ModelConfig(n_hops=8, cnn_dim=2048, cnn_w=14, cnn_h=14,
                                   compute_dtype="bfloat16"),
                       TrainConfig(batch_size=288,
                                   hop_stop_timing=_RESNET_STOP_TIMING,
                                   train_backbone=True)),
    "ours_vit": (ModelConfig(n_hops=8, cnn_dim=1024, cnn_w=16, cnn_h=16),
                 TrainConfig()),
}
PRESETS = {name: pair[0] for name, pair in TRAIN_PRESETS.items()}


def get_train_preset(name: str) -> Tuple[ModelConfig, TrainConfig]:
    """The model dimensions and training knobs of a named preset."""
    try:
        return TRAIN_PRESETS[name]
    except KeyError:
        raise KeyError(f"unknown preset {name!r}; "
                       f"available: {sorted(TRAIN_PRESETS)}")


def get_preset(name: str) -> ModelConfig:
    """The model dimensions of a named experiment preset."""
    return get_train_preset(name)[0]
