"""Training-step bench of the PyTorch port on one CUDA card: ms a step of the
whole train step chained through its Adam state, in every variant of the JAX
package's training bench, one JSON line
(``rau_vqa_tpu_torch/scripts/bench_train.py``).

    python3 bench_torch_train.py [--batch 512] [--variants plain,remat] [--f32] [--device cpu]
"""

import sys

from rau_vqa_tpu_torch.scripts.bench_train import main

if __name__ == "__main__":
    sys.exit(main())
