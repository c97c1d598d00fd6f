"""Torch7 snapshot converter.

The reference checkpoints hold three flat parameter vectors,
``checkpoint.params = {embed, rnn, mult}``, made by ``:getParameters()``
(Ours_SS/LstmAttCtrlGradNoiseDontSelect.lua:322-324, saved at :1188-1197).
This module slices those vectors into the port's parameter tree (float32
tensors, the tree ``convert.params_from_jax`` gives) and back, so the
reference's released snapshots can be served and evaluated by the port.

Layout facts encoded here:

- Torch ``Linear`` stores ``weight [out, in]`` then ``bias [out]``; the tree
  keeps ``w [in, out]`` (x @ W), so weights transpose.
- ``SpatialConvolution(cin, cout, 1, 1)`` stores ``[cout, cin, 1, 1]``: a
  Linear after squeezing, transposed likewise.
- ``LookupTable`` stores ``[V, E]`` row-major.  Torch's 1-based rows are the
  same storage rows as the 0-based token ids (ZEROPAD is torch row 1, storage
  row 0, id 0), so the matrix maps verbatim.
- The flattening order follows ``module:parameters()``: depth first over the
  container or graph in construction order.  The per-group orders below are
  the build sequence of the nngraph modules (reference :198-320,
  model/DeepLSTM.lua, model/ATTLSTM.lua), kept as data (one list a group).

The port's own copy of ``rau_vqa_tpu/utils/torch_convert.py``, on the port's
``data/t7.py`` reader and writer.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from rau_vqa_tpu_torch.config import ModelConfig

# one layout entry: (destination path in the params tree,
#                    torch storage shape, needs_transpose)
Entry = Tuple[Tuple[str, ...], Tuple[int, ...], bool]


def embed_layout(cfg: ModelConfig) -> List[Entry]:
    """word_embed = LookupTable(V, E) (reference :203-206)."""
    return [(("embed", "lookup"), (cfg.vocab_size, cfg.embed_dim), False)]


def rnn_layout(cfg: ModelConfig) -> List[Entry]:
    """DeepLSTM: per layer i2h Linear(in, 4R) then h2h Linear(R, 4R)
    (DeepLSTM.lua:43-44), layers in order."""
    R = cfg.rnn_size
    out: List[Entry] = []
    d_in = cfg.embed_dim
    for L in range(cfg.rnn_layers):
        out += [
            (("rnn", "layers", str(L), "wi"), (4 * R, d_in), True),
            (("rnn", "layers", str(L), "bi"), (4 * R,), False),
            (("rnn", "layers", str(L), "wh"), (4 * R, R), True),
            (("rnn", "layers", str(L), "bh"), (4 * R,), False),
        ]
        d_in = R
    return out


def mult_layout(cfg: ModelConfig) -> List[Entry]:
    """The multimodal gModule's parameterized children in topological order
    (reference :291-307): q_embed -> i_embed -> attbycontent -> attbymemory
    -> classifier (which nests feat_attprob, ATTLSTM, merge, score, do_pred
    in its own construction order, :265-283)."""
    S = cfg.cnn_spat
    M = cfg.multfeat_dim
    F = cfg.attfeat_dim
    Ra = cfg.att_rnn_size
    out: List[Entry] = []
    # [q_embed] q_proj then h_proj (:233-234)
    out += [(("mult", "q_proj", "w"), (M, cfg.rnnout_dim), True),
            (("mult", "q_proj", "b"), (M,), False),
            (("mult", "h_proj", "w"), (M, cfg.att_state_dim), True),
            (("mult", "h_proj", "b"), (M,), False)]
    # [i_embed] 1x1 conv cnn_dim -> M (:240)
    out += [(("mult", "i_embed", "w"), (M, cfg.cnn_dim), True),
            (("mult", "i_embed", "b"), (M,), False)]
    # [attbycontent] qfeatatt Linear, ifeatproj conv, attscore conv (:246-251)
    out += [(("mult", "att_q", "w"), (F, M), True),
            (("mult", "att_q", "b"), (F,), False),
            (("mult", "att_i", "w"), (F, M), True),
            (("mult", "att_i", "b"), (F,), False),
            (("mult", "att_score", "w"), (1, F), True),
            (("mult", "att_score", "b"), (1,), False)]
    # [attbymemory] Linear att_state -> S (:287)
    out += [(("mult", "att_mem", "w"), (S, cfg.att_state_dim), True),
            (("mult", "att_mem", "b"), (S,), False)]
    # [classifier] (:265-283): feat_attprob, ATTLSTM (i2h, h2h per layer),
    # merge, out_score, do_pred
    out += [(("mult", "attprob_proj", "w"), (M, S), True),
            (("mult", "attprob_proj", "b"), (M,), False)]
    d_in = M
    for L in range(cfg.att_rnn_layers):
        out += [
            (("mult", "attlstm", "layers", str(L), "wi"), (4 * Ra, d_in), True),
            (("mult", "attlstm", "layers", str(L), "bi"), (4 * Ra,), False),
            (("mult", "attlstm", "layers", str(L), "wh"), (4 * Ra, Ra), True),
            (("mult", "attlstm", "layers", str(L), "bh"), (4 * Ra,), False),
        ]
        d_in = Ra
    out += [(("mult", "merge", "w"), (M, cfg.att_state_dim), True),
            (("mult", "merge", "b"), (M,), False),
            (("mult", "cls", "w"), (cfg.answer_size, M), True),
            (("mult", "cls", "b"), (cfg.answer_size,), False),
            (("mult", "do_pred", "w"), (1, M), True),
            (("mult", "do_pred", "b"), (1,), False)]
    return out


GROUP_LAYOUTS = {"embed": embed_layout, "rnn": rnn_layout, "mult": mult_layout}


def _get(tree: Dict, path: Tuple[str, ...]):
    """tree is {group: subtree}; path starts with the group name."""
    node: Any = tree
    for p in path:
        node = node[int(p)] if p.isdigit() else node[p]
    return node


def _set(tree: Dict, path: Tuple[str, ...], value) -> None:
    """Set ``value`` at ``path``, making dicts (and lists, where the next
    segment is a digit) along the way."""
    node: Any = tree
    for seg, nxt in zip(path[:-1], path[1:]):
        make = list if nxt.isdigit() else dict
        if seg.isdigit():
            while len(node) <= int(seg):
                node.append(make())
            node = node[int(seg)]
        else:
            if seg not in node:
                node[seg] = make()
            node = node[seg]
    last = path[-1]
    if last.isdigit():
        while len(node) <= int(last):
            node.append(None)
        node[int(last)] = value
    else:
        node[last] = value


def group_size(cfg: ModelConfig, group: str) -> int:
    return sum(int(np.prod(shape)) for _, shape, _ in GROUP_LAYOUTS[group](cfg))


def flat_to_group(flat: np.ndarray, cfg: ModelConfig, group: str,
                  layout: List[Entry] = None) -> Dict:
    """Slice one torch flat vector into the ``group`` subtree of the port's
    params, as float32 CPU tensors.  ``layout`` overrides the reconstructed
    ``GROUP_LAYOUTS`` order (one recovered by ``utils.layout_diag`` when a
    real snapshot's nngraph ``parameters()`` order disagrees)."""
    layout = GROUP_LAYOUTS[group](cfg) if layout is None else layout
    want = sum(int(np.prod(s)) for _, s, _ in layout)
    if flat.size != want:
        raise ValueError(
            f"{group} flat vector has {flat.size} elements; config expects "
            f"{want} — model dims disagree with the snapshot")
    tree: Dict = {group: {}}
    off = 0
    for path, shape, transpose in layout:
        n = int(np.prod(shape))
        arr = flat[off:off + n].reshape(shape)
        off += n
        _set(tree, path, torch.from_numpy(np.ascontiguousarray(
            arr.T if transpose else arr, dtype=np.float32)))
    return tree[group]


def _float64(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, np.float64)


def group_to_flat(params: Dict, cfg: ModelConfig, group: str,
                  layout: List[Entry] = None) -> np.ndarray:
    """Inverse: the ``group`` subtree (tensors or arrays) -> the torch flat
    vector, float64, in ``layout``'s order (``GROUP_LAYOUTS``' when None)."""
    layout = GROUP_LAYOUTS[group](cfg) if layout is None else layout
    chunks = []
    for path, shape, transpose in layout:
        arr = _float64(_get({group: params}, path))
        if transpose:
            arr = arr.T
        if arr.shape != shape:
            raise ValueError(f"{path}: shape {arr.shape} != layout {shape}")
        chunks.append(np.ascontiguousarray(arr).reshape(-1))
    return np.concatenate(chunks)


def flats_from_snapshot(snap) -> List[np.ndarray]:
    """The three flat parameter vectors of an already parsed snapshot
    table."""
    if not isinstance(snap, dict):
        raise ValueError("expected a snapshot table")
    flats = snap["params"]
    if isinstance(flats, dict):   # a lua 1-based table
        flats = [flats[float(i)] for i in (1, 2, 3)]
    return [np.asarray(f).reshape(-1) for f in flats]


def snapshot_flats(t7_path: str) -> List[np.ndarray]:
    """The three flat parameter vectors of a reference snapshot file."""
    from rau_vqa_tpu_torch.data import t7

    return flats_from_snapshot(t7.load_t7(t7_path))


def convert_snapshot(t7_path: str, cfg: ModelConfig) -> Dict:
    """A reference training snapshot (``{it, opt, epoch, params={1: embed,
    2: rnn, 3: mult}}``, reference :1192-1197) -> the port's params tree
    (float32 CPU tensors)."""
    flats = snapshot_flats(t7_path)
    return {g: flat_to_group(f, cfg, g)
            for g, f in zip(("embed", "rnn", "mult"), flats)}


def export_snapshot(t7_path: str, params: Dict, cfg: ModelConfig, *,
                    it: int = 0, epoch: float = 0.0,
                    opt: Dict = None) -> None:
    """Write the params as a reference-format snapshot.  ``opt`` adds the
    snapshot's option table, which the reference's Eval.lua adopts
    (``snap.opt.nhop``, ``alg_name``; reference :1192-1196, Eval.lua:116-118)."""
    from rau_vqa_tpu_torch.data import t7

    snap = {
        "it": float(it),
        "epoch": float(epoch),
        "params": [group_to_flat(params[g], cfg, g).astype(np.float32)
                   for g in ("embed", "rnn", "mult")],
    }
    if opt is not None:
        snap["opt"] = opt
    t7.save_t7(t7_path, snap)
