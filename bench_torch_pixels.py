"""From-pixels serving bench of the PyTorch port on one CUDA card: images and
questions -> answers through a backbone and the head's kernels, one JSON line
(``rau_vqa_tpu_torch/bench_pixels.py``).

    python3 bench_torch_pixels.py [--backbone resnet101|vgg16|vit] [--batch 120]
                                  [--qpi 3] [--chain 10] [--artifact [DIR]] [--device cpu]
                                  [--s2d | --int8]
"""

import sys

from rau_vqa_tpu_torch.bench_pixels import main

if __name__ == "__main__":
    sys.exit(main())
