#!/usr/bin/env bash
# Reproduce the paper's Table 1 (arXiv 1606.03647) with the PyTorch port on
# one CUDA card.  Counterpart of scripts/repro_table1.sh.
#
# The reference's recipe (experiments/README.md:10-12): train each of the
# four experiments for 40 epochs, then submit the hop_01 (and uni/select)
# result JSONs of epoch 40 to the VQA v1 evaluation server.  This script is
# that recipe end to end over `python -m rau_vqa_tpu_torch.cli`: the data
# (scripts/get_data.sh fetches it, and needs the network), the feature
# packing, the training; the result files land under
# save_result_*/results/hop_XX/ with the server's naming.
#
# Usage:  rau_vqa_tpu_torch/scripts/repro_table1.sh [ss|ms|full|resnet|all]
#
# SPLIT=val2014 switches to the annotated val split and, when the official
# VQA v1 annotations are present (scripts/get_data.sh official), scores
# every eval sweep with the official 10-rater metric (testOEaccOfficial):
# no eval-server submission needed.  DEVICE=cpu runs on the CPU.
set -euo pipefail
cd "$(dirname "$0")/../.."

TARGET="${1:-all}"
EPOCHS="${EPOCHS:-40}"
SPLIT="${SPLIT:-test-dev2015}"
DEVICE="${DEVICE:-cuda}"
if [ "$SPLIT" = "val2014" ]; then
  VQA_DIR=data/VQA_prepro/data_train_val
else
  VQA_DIR=data/VQA_prepro/data_train-val_test-dev
fi
OFFICIAL_ANNO=data/vqa_official/mscoco_val2014_annotations.json

ensure_data() {
  [ -d data/VQA_prepro ] || scripts/get_data.sh prepro
  [ -d data/vqa_VGG16Conv_pool5_448 ] || scripts/get_data.sh vgg
  # scripts/get_data.sh pack's packing, through the port's CLI
  [ -d data/packed_vgg448 ] || python -m rau_vqa_tpu_torch.cli pack-features \
      --feat-dir data/vqa_VGG16Conv_pool5_448/feat_448x448 \
      --vqa-dir data/VQA_prepro/data_train_val \
      --out data/packed_vgg448 --cnnout-dim 512 --cnnout-w 14 --cnnout-h 14
}

ensure_resnet_data() {
  [ -d data/vqa_resnet_101_convfeat_448 ] || scripts/get_data.sh resnet
  [ -d data/packed_resnet448 ] || python -m rau_vqa_tpu_torch.cli pack-features \
      --feat-dir data/vqa_resnet_101_convfeat_448 \
      --vqa-dir data/VQA_prepro/data_train-val_test-dev \
      --out data/packed_resnet448 --cnnout-dim 2048
}

train_one() {  # preset feat_dir
  local extra=()
  if [ "$SPLIT" = "val2014" ] && [ -f "$OFFICIAL_ANNO" ]; then
    extra+=(--official-anno "$OFFICIAL_ANNO")
  fi
  python -m rau_vqa_tpu_torch.cli train --preset "$1" \
      --vqa-dir "$VQA_DIR" --split "$SPLIT" \
      --feat-dir "$2" --epochs "$EPOCHS" --bf16 \
      --train-buckets 8,16 --eval-buckets 8,16 --device "$DEVICE" \
      ${extra[@]+"${extra[@]}"}
}

case "$TARGET" in
  ss)     ensure_data; train_one ours_ss data/packed_vgg448 ;;
  ms)     ensure_data; train_one ours_ms data/packed_vgg448 ;;
  full)   ensure_data; train_one ours_full data/packed_vgg448 ;;
  resnet) ensure_data; ensure_resnet_data
          train_one ours_resnet data/packed_resnet448 ;;
  all)    "$0" ss; "$0" ms; "$0" full; "$0" resnet ;;
  *) echo "usage: $0 [ss|ms|full|resnet|all]" >&2; exit 1 ;;
esac

echo "submit results/hop_01 (epoch ${EPOCHS}) JSONs to the VQA v1 eval server"
