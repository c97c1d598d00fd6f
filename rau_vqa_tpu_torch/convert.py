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


class MemoRecent:
    """``fn(tree)`` kept for the last two tree objects passed, compared by
    identity: the per-parameter-set preparation of weights (layout, type,
    stacking) runs once while the same trees come back, two of them in turn
    included (a bf16 serving tree and its float32 reference).  It assumes
    parameters are not changed in place between calls, as at eval.

    A tree being trained (a leaf requires grad) is prepared afresh on every
    call and never kept: each step's tree is new, and a kept entry would
    hold its prepared weights and, through them, the step's graph."""

    KEEP = 2

    def __init__(self, fn):
        self.fn = fn
        self.entries = []   # [(tree, fn(tree))], the most recent last

    def __call__(self, tree):
        if torch.is_grad_enabled() and any(
                torch.is_tensor(t) and t.requires_grad for t in tree_leaves(tree)):
            return self.fn(tree)
        for i, (t, value) in enumerate(self.entries):
            if t is tree:
                self.entries.append(self.entries.pop(i))
                return value
        value = self.fn(tree)
        self.entries.append((tree, value))
        del self.entries[:-self.KEEP]
        return value


def _tensor_from_numpy(a) -> torch.Tensor:
    if torch.is_tensor(a):   # a leaf already decoded to a tensor (msgpack)
        return a.detach().clone()
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        # ml_dtypes.bfloat16, as JAX hands bf16 leaves over: torch.from_numpy
        # does not know the type, so carry the bits over as int16
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _numpy_from_tensor(t: torch.Tensor):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes   # only for bf16 leaves; the card's machine may lack it
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_jax(tree, device="cpu"):
    """Nested dicts/lists of numpy arrays (or tensors) -> the same tree of
    tensors on ``device``, each leaf's type and bits kept (bfloat16
    included)."""
    return map_tree(lambda a: _tensor_from_numpy(a).to(device), tree)


def params_to_jax(params):
    """Tree of tensors -> the same tree of numpy arrays (host copies);
    bfloat16 leaves become ``ml_dtypes.bfloat16`` arrays, as JAX's are."""
    return map_tree(_numpy_from_tensor, params)
