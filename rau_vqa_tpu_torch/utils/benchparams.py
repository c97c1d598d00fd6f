"""Random parameter trees for the throughput benches, filled on the host.

Counterpart of ``rau_vqa_tpu/utils/benchparams.py`` (:1-72).  Throughput does
not depend on the weights' values, so the benches take the port's init trees
and fill every leaf from a numpy seed with the JAX package's rules: BN-like
leaves get well-conditioned values (``var`` > 0, ``scale`` ~ 1) so that a
folded tree stays finite.  The leaves are drawn in the JAX package's order
(a dict's keys sorted, as JAX's pytrees order them), so one seed gives both
packages the same numbers.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch


def _fill(tree, rs: np.random.RandomState, dtype, name=None):
    if isinstance(tree, dict):
        filled = {k: _fill(tree[k], rs, dtype, k) for k in sorted(tree)}
        return {k: filled[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return [_fill(v, rs, dtype, name) for v in tree]
    shape = tuple(tree.shape)
    if name == "var":
        arr = rs.uniform(0.5, 1.5, shape)
    elif name == "scale":
        arr = 1.0 + 0.1 * rs.standard_normal(shape)
    elif name in ("mean", "offset", "b"):
        arr = 0.1 * rs.standard_normal(shape)
    else:
        arr = 0.05 * rs.standard_normal(shape)
    return torch.from_numpy(arr.astype(np.float32)).to(dtype)


def np_params_like(init_fn: Callable, seed: int, dtype=torch.float32):
    """Random host (CPU) tensors with the structure of ``init_fn(dtype)``'s
    tree: leaves named ``var`` / ``scale`` / ``mean`` / ``offset`` / ``b`` get
    BN-safe fills, every other leaf a small gaussian, drawn in float32 and
    cast to ``dtype``."""
    return _fill(init_fn(dtype), np.random.RandomState(seed), dtype)


def random_backbone(backbone: str, seed: int, dtype=torch.bfloat16,
                    fold_bn: bool = True) -> Tuple[dict, int]:
    """(host tree, image size) of a named backbone at the bench's type.
    ResNet-101 comes folded (``fold_batchnorm``, the serving tree) unless
    ``fold_bn`` is False."""
    from rau_vqa_tpu_torch.models.backbones import resnet, vgg, vit

    gen = torch.Generator().manual_seed(seed)
    if backbone == "resnet101":
        bb = np_params_like(lambda dt: resnet.resnet101_init(gen, dt, "cpu"), seed, dtype)
        return (resnet.fold_batchnorm(bb) if fold_bn else bb), 448
    if backbone == "vgg16":
        return np_params_like(lambda dt: vgg.vgg16_pool5_init(gen, dt, "cpu"), seed, dtype), 448
    if backbone == "vit":
        bb = np_params_like(lambda dt: vit.vit_init(gen, vit.VIT_L14, dt, "cpu"), seed, dtype)
        return bb, vit.VIT_L14.image_size
    raise ValueError(f"unknown backbone {backbone!r}")
