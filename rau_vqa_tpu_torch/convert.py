"""Parameter interchange with the JAX package.

Both packages hold parameters as the same nested tree of dicts and lists
(groups ``embed`` / ``rnn`` / ``mult``, weights ``[in, out]``).  The JAX
side hands its tree over as numpy arrays (``jax.tree.map(np.asarray, p)``),
so the conversion is a plain copy leaf by leaf and nothing here imports jax.
"""

from __future__ import annotations

import numpy as np
import torch


def map_tree(fn, tree, *rest):
    """Apply ``fn`` to every leaf of a tree of dicts and lists; with more
    trees of the same structure, ``fn`` takes their leaves side by side."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tree(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts and lists, in ``map_tree`` order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def params_from_jax(tree, device="cpu"):
    """Nested dicts/lists of numpy arrays -> the same tree of tensors."""
    return map_tree(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(device), tree)


def params_to_jax(params):
    """Tree of tensors -> the same tree of numpy arrays (host copies)."""
    return map_tree(lambda t: t.detach().cpu().numpy(), params)
