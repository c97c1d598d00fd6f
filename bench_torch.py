"""Serving throughput bench of the PyTorch port on one CUDA card: VQA
questions/s of ``ours_ms`` through its kernels, one JSON line
(``rau_vqa_tpu_torch/bench.py``).

    python3 bench_torch.py [--batch 512] [--artifact [DIR]] [--device cpu]
"""

import sys

from rau_vqa_tpu_torch.bench import main

if __name__ == "__main__":
    sys.exit(main())
