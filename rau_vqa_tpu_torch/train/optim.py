"""Optimizers and the gradient pipeline on parameter trees.

Counterpart of ``rau_vqa_tpu/train/optim.py``: the reference's
utils/optim_updates.lua (adam :59-87, sgd :7, sgdm :11, sgdmom :21, adagrad
:33, rmsprop :46) as functions that take a tree of tensors (nested dicts and
lists) and return new trees; nothing is updated in place.

The gradient pipeline runs between backward and the optimizer in the
reference's order (noise after backward, clip after noise;
Ours_SS/LstmAttCtrlGradNoiseDontSelect.lua:597-629):

- ``add_gradient_noise``: iid N(0, sqrt(eta / ((t+1) * gamma))), the
  reference formula as written: gamma multiplies, it is not an exponent;
- ``clip_by_global_norm``: per-group L2 norm clip.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from rau_vqa_tpu_torch.convert import map_tree, tree_leaves

Tree = object


def tree_norm(tree: Tree) -> torch.Tensor:
    """L2 norm over every leaf, accumulated in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def add_gradient_noise(grads: Tree, generator: torch.Generator, step,
                       eta: float, gamma: float) -> Tree:
    """grad += N(0, sqrt(eta / ((step+1) * gamma))) elementwise (reference
    :597-605; ``step`` is the 1-based iteration counter).  The draws come
    from ``generator``, leaf by leaf in tree order."""
    std = (eta / ((float(step) + 1.0) * gamma)) ** 0.5
    return map_tree(
        lambda x: x + std * torch.randn(x.shape, generator=generator,
                                        device=x.device, dtype=x.dtype),
        grads)


def clip_by_global_norm(grads: Tree, max_norm: float
                        ) -> Tuple[Tree, torch.Tensor]:
    """Scale the whole group so its L2 norm is <= max_norm (reference
    :607-629, per parameter group).  Returns (clipped, pre-clip norm)."""
    norm = tree_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-20), max=1.0)
    return map_tree(lambda x: x * scale.to(x.dtype), grads), norm


def trust_ratio_cap(new_params: Tree, old_params: Tree, tau: float) -> Tree:
    """Per-leaf update cap (LARS/LAMB style): the step ``u = new - old`` is
    scaled so that ``||u|| <= tau * (||old|| + 1e-3)``; norms in float32."""
    def cap(n, o):
        u = n - o
        un = torch.sqrt(torch.sum(torch.square(u.float())))
        wn = torch.sqrt(torch.sum(torch.square(o.float())))
        scale = torch.clamp(tau * (wn + 1e-3) / torch.clamp(un, min=1e-20),
                            max=1.0)
        return o + u * scale.to(u.dtype)

    return map_tree(cap, new_params, old_params)


def _zeros(params: Tree) -> Tree:
    return map_tree(torch.zeros_like, params)


# ---------------------------------------------------------------------------
# Adam (optim_updates.lua:59-87)
# ---------------------------------------------------------------------------

def adam_init(params: Tree) -> Dict:
    """Zero moments and step count, on the parameters' device."""
    device = tree_leaves(params)[0].device
    return {"m": _zeros(params), "v": _zeros(params),
            "t": torch.zeros((), dtype=torch.int32, device=device)}


def adam_update(params: Tree, grads: Tree, lr, state: Dict, *,
                beta1: float = 0.9, beta2: float = 0.999,
                epsilon: float = 1e-8) -> Tuple[Tree, Dict]:
    """x -= lr * sqrt(1-b2^t)/(1-b1^t) * m / (sqrt(v) + eps); eps is added
    outside the sqrt, as optim_updates.lua:78-86 does."""
    t = state["t"] + 1
    tf = t.float()
    m = map_tree(lambda m_, g: beta1 * m_ + (1 - beta1) * g, state["m"], grads)
    v = map_tree(lambda v_, g: beta2 * v_ + (1 - beta2) * g * g,
                 state["v"], grads)
    step_size = (torch.as_tensor(lr, dtype=torch.float32, device=tf.device)
                 * torch.sqrt(1 - torch.pow(beta2, tf))
                 / (1 - torch.pow(beta1, tf)))
    params = map_tree(
        lambda x, m_, v_: x - step_size.to(x.dtype) * m_
        / (torch.sqrt(v_) + epsilon),
        params, m, v)
    return params, {"m": m, "v": v, "t": t}


# ---------------------------------------------------------------------------
# The rest of the optim_updates.lua family
# ---------------------------------------------------------------------------

def sgd_update(params: Tree, grads: Tree, lr) -> Tree:
    return map_tree(lambda x, g: x - lr * g, params, grads)


def sgdm_init(params: Tree) -> Dict:
    return {"v": _zeros(params)}


def sgdm_update(params: Tree, grads: Tree, lr, alpha, state: Dict
                ) -> Tuple[Tree, Dict]:
    """Standard momentum (optim_updates.lua:11-19)."""
    v = map_tree(lambda v_, g: alpha * v_ + lr * g, state["v"], grads)
    return map_tree(lambda x, v_: x - v_, params, v), {"v": v}


def sgdmom_init(params: Tree) -> Dict:
    return {"m": _zeros(params)}


def sgdmom_update(params: Tree, grads: Tree, lr, alpha, state: Dict
                  ) -> Tuple[Tree, Dict]:
    """Nesterov momentum (optim_updates.lua:21-31):
    m' = alpha*m - lr*g;  x += -alpha*m + (1+alpha)*m'."""
    m_old = state["m"]
    m = map_tree(lambda m_, g: alpha * m_ - lr * g, m_old, grads)
    params = map_tree(lambda x, mo, mn: x - alpha * mo + (1 + alpha) * mn,
                      params, m_old, m)
    return params, {"m": m}


def adagrad_init(params: Tree) -> Dict:
    return {"m": _zeros(params)}


def adagrad_update(params: Tree, grads: Tree, lr, epsilon, state: Dict
                   ) -> Tuple[Tree, Dict]:
    m = map_tree(lambda m_, g: m_ + g * g, state["m"], grads)
    params = map_tree(lambda x, g, m_: x - lr * g / (torch.sqrt(m_) + epsilon),
                      params, grads, m)
    return params, {"m": m}


def rmsprop_init(params: Tree) -> Dict:
    return {"m": _zeros(params)}


def rmsprop_update(params: Tree, grads: Tree, lr, alpha, epsilon, state: Dict
                   ) -> Tuple[Tree, Dict]:
    m = map_tree(lambda m_, g: alpha * m_ + (1 - alpha) * g * g,
                 state["m"], grads)
    params = map_tree(lambda x, g, m_: x - lr * g / (torch.sqrt(m_) + epsilon),
                      params, grads, m)
    return params, {"m": m}
