"""Flatten/rebuild helpers shared by the hop-loop kernel wrappers.

The hop-loop kernels take the ``mult`` parameter subtree as a flat list of
pointers in a fixed order of paths; ``pluck`` and ``rebuild`` convert
between the tree and that list, and ``mult_shapes`` gives the shape each
wrapper checks a leaf against.  ``rebuild`` walks each path by position,
never by a value lookup, so a path with a repeated key resolves to the
right leaf.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple


def pluck(tree, path: Sequence):
    """Fetch a leaf by path from a nested dict/list tree."""
    for p in path:
        tree = tree[p]
    return tree


def rebuild(order: Sequence[Sequence], flat: Sequence) -> Dict:
    """Inverse of ``[pluck(mp, p) for p in order]``: reassemble the nested
    dict/list tree from the flat leaf list."""
    mp: Dict = {}
    for path, leaf in zip(order, flat):
        node = mp
        for j, p in enumerate(path[:-1]):
            if isinstance(p, int):
                while len(node) <= p:
                    node.append({})
                node = node[p]
            else:
                if p not in node:
                    node[p] = [] if isinstance(path[j + 1], int) else {}
                node = node[p]
        node[path[-1]] = leaf
    return mp


def mult_shapes(cfg) -> Dict[Tuple, Tuple[int, ...]]:
    """The shape of every leaf of the ``mult`` tree with a 1-layer ATTLSTM
    (the hop-loop kernels' configuration), by path; ``cfg`` a ModelConfig."""
    Q, S, Dc = cfg.rnnout_dim, cfg.cnn_spat, cfg.cnn_dim
    M, F, R, A = cfg.multfeat_dim, cfg.attfeat_dim, cfg.att_rnn_size, cfg.answer_size
    return {("q_proj", "w"): (Q, M), ("q_proj", "b"): (M,),
            ("h_proj", "w"): (R, M), ("h_proj", "b"): (M,),
            ("i_embed", "w"): (Dc, M), ("i_embed", "b"): (M,),
            ("att_q", "w"): (M, F), ("att_q", "b"): (F,),
            ("att_i", "w"): (M, F), ("att_i", "b"): (F,),
            ("att_score", "w"): (F, 1), ("att_score", "b"): (1,),
            ("att_mem", "w"): (R, S), ("att_mem", "b"): (S,),
            ("attprob_proj", "w"): (S, M), ("attprob_proj", "b"): (M,),
            ("attlstm", "layers", 0, "wi"): (M, 4 * R),
            ("attlstm", "layers", 0, "bi"): (4 * R,),
            ("attlstm", "layers", 0, "wh"): (R, 4 * R),
            ("attlstm", "layers", 0, "bh"): (4 * R,),
            ("merge", "w"): (R, M), ("merge", "b"): (M,),
            ("cls", "w"): (M, A), ("cls", "b"): (A,),
            ("do_pred", "w"): (M, 1), ("do_pred", "b"): (1,)}
