"""Model and training configuration for the PyTorch port.

An own copy of the architecture and optimization halves of
``rau_vqa_tpu.config``: the port imports nothing of the JAX package.
Defaults mirror the in-body constants of the reference model
(Ours_SS/LstmAttCtrlGradNoiseDontSelect.lua:202-228, optimization at
:39-55); the presets carry the dimensions and training knobs of the paper's
experiments.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
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
    # "reference" runs the whole fused hop loop, its forward too, as the
    # plain version under autograd on any device: the JAX package's
    # fused_train_impl="reference", which the training bench's maskref
    # variant times to part the kernels' cost from the masks'
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
    :39-55, :597-629; Adam internals optim_updates.lua:59-62) and those of
    the ``Trainer``'s host loop (epochs, LR decay :1211-1220, the
    loss-explosion guard, buckets, eval and checkpoint cadence)."""

    batch_size: int = 100
    max_epochs: int = 50
    learning_rate: float = 3e-3       # embed + rnn groups
    mult_learning_rate: float = 3e-4  # multimodal group
    lr_decay: float = 0.9             # per-epoch exponential decay, both LRs
    mult_lr_decay: float = 0.9
    lr_decay_interval: int = 1        # in epochs
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
    # the loss-explosion guard: a step whose loss is non-finite or above
    # threshold x its EMA is undone (the reference declares the flag, :29)
    loss_explode_threshold: float = 3.0
    # train-step token axis cut to the smallest bucket covering the batch's
    # longest question (exact: the grads do not depend on T <= seq_len)
    length_buckets: Tuple[int, ...] = (8, 16)
    # backbone fine-tuning: the backbone joins the train state as a 4th
    # parameter group and the step differentiates through the pixels
    train_backbone: bool = False
    # the backbone group's LR: learning_rate times this
    backbone_lr_scale: float = 0.1
    # checkpoint the fine-tuned backbone block by block (the same grads,
    # less activation memory)
    backbone_remat: bool = True
    # the head's gradient noise on the backbone group too
    backbone_grad_noise: bool = False
    # per-leaf update cap of the backbone group: ||update|| <= tau *
    # (||leaf|| + 1e-3) a step; 0 disables
    backbone_trust_ratio: float = 2e-4
    # RMS-normalize each feature cell over D where a backbone makes the
    # features (models/pipeline.extract_features); snapshots record it
    backbone_feat_norm: bool = False
    test_interval: int = 1            # epochs between eval sweeps
    checkpoint_interval: int = 1      # epochs between checkpoints
    keep_last_checkpoints: int = 0    # 0 = keep every snapshot
    print_interval: int = 0           # steps between stdout lines (0 = off)


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
                                   train_backbone=True, backbone_remat=False)),
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


@dataclass(frozen=True)
class DataConfig:
    """Data locations and split selection (reference :31-37, :85-95)."""

    split: str = "val2014"            # [val2014|test2015|test-dev2015|train2014]
    vqa_dir: str = "./data/VQA_prepro/data_train_val"
    feat_dir: str = "./data/vqa_VGG16Conv_pool5_448/feat_448x448"
    gt_anno: str = "./data/VQA_prepro/comprehend/comprehend_val2014_annotations.json"
    official_anno: str = ""           # official VQA annotations JSON: eval
                                      # sweeps also report the 10-rater metric
    batch_order: str = "shuffle"      # [shuffle|inorder|sort|randsort|imggroup]
    test_batch_size: int = 0          # 0 => derive from split (reference :85-95)
    valid_ratio: float = 0.0

    def resolved_test_batch_size(self) -> int:
        if self.test_batch_size > 0:
            return self.test_batch_size
        # chosen to divide split sizes exactly (reference :85-95)
        return {"val2014": 83, "test2015": 57, "test-dev2015": 96,
                "train2014": 100}[self.split]


@dataclass(frozen=True)
class MeshConfig:
    """Parallelism layout (``parallel/mesh.py``): DP over 'data' is the
    primary strategy for this model size; TP over 'model' optionally shards
    the classifier and the LSTM gate projections.  One process a device:
    the mesh spans the whole ``torch.distributed`` world."""

    enabled: bool = False             # construct a mesh for the Trainer
    data_axis: int = -1               # -1 => the world size / model_axis
    model_axis: int = 1
    axis_names: Tuple[str, str] = ("data", "model")   # fixed: the JAX config's keys
    shard_params_tp: bool = False     # enable TP weight sharding rules

    def __post_init__(self):
        if tuple(self.axis_names) != ("data", "model"):
            raise ValueError(f"MeshConfig.axis_names is ('data', 'model'), "
                             f"not {tuple(self.axis_names)!r}")


@dataclass(frozen=True)
class ExperimentConfig:
    """One experiment: model, optimization, data, the device mesh and the
    host loop's observability knobs (the JAX package's, without
    ``DataConfig.prefetch``, which the JAX package does not read either)."""

    name: str = "ours_ss"
    alg_name: str = "LstmAttCtrlGradNoiseDontSelectSingleHopBalance448Pool5"
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    save_dir: str = "save_result_vqa"
    # observability (reference VISUALIZATION group, :57-62)
    visatt: bool = False          # dump attention-map PNGs during eval
    # eval batches to dump per epoch: 1 bounds the file count (default);
    # -1 = every test question, the reference's semantics (:926-932)
    visatt_batches: int = 1
    graph_interval: int = 10      # epochs between curve renders (:59)
    profile_dir: str = ""         # non-empty => torch.profiler trace of epoch 1
    # the eval sweep through ``make_predict_step`` (the two serving kernels
    # on the card).  The JAX package defaults to its plain XLA path; the
    # port defaults to its kernels, and False runs the plain float32
    # ``predict`` on the trainer's device
    fused_eval: bool = True
    # question-length buckets for the eval sweep; () = always full seq_len
    eval_buckets: Tuple[int, ...] = ()

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)


_TEST_DEV = DataConfig(split="test-dev2015",
                       vqa_dir="./data/VQA_prepro/data_train-val_test-dev")
# (name, alg_name, DataConfig) of each preset, as the JAX package sets them
_EXPERIMENTS = {
    "ours_ss": ("LstmAttCtrlGradNoiseDontSelectSingleHopBalance448Pool5",
                _TEST_DEV),
    "ours_ms": ("LstmAttCtrlGradNoiseDontSelect448Pool5", _TEST_DEV),
    "ours_full": ("LstmAttCtrlGradNoiseDontSelect448Pool5", _TEST_DEV),
    "ours_resnet": ("NIPSFinalResNet101sz448tmin15lambda0dot5",
                    dataclasses.replace(
                        _TEST_DEV,
                        feat_dir="./data/vqa_resnet_101_convfeat_448")),
    "ours_resnet_ft": ("NIPSFinalResNet101sz448FineTune",
                       dataclasses.replace(
                           _TEST_DEV,
                           feat_dir="./data/vqa_resnet_101_convfeat_448",
                           batch_order="imggroup")),
    "ours_vit": ("RauVitL14Stretch", DataConfig(split="val2014")),
}


def get_experiment(name: str) -> ExperimentConfig:
    """The whole experiment of a named preset: ``get_train_preset``'s model
    and training halves with the preset's data, name and ``alg_name``."""
    mcfg, tcfg = get_train_preset(name)
    alg_name, data = _EXPERIMENTS[name]
    return ExperimentConfig(name=name, alg_name=alg_name, model=mcfg,
                            train=tcfg, data=data)
