"""Diagnose / repair Torch snapshot flat-vector layouts.

The reference saves each param group as ONE flat vector produced by nngraph
``:getParameters()`` (Ours_SS/LstmAttCtrlGradNoiseDontSelect.lua:322-324,
snapshot at :1188-1197; Eval.lua:344-347 copies them back the same way).
utils.torch_convert reconstructs that flattening order from the module build
sequence (:198-320) — a reconstruction that cannot be verified against
*released* snapshots without network egress.  This module makes an order
mismatch diagnosable and repairable when a real snapshot appears:

1. ``layout_report(cfg)`` — the structural diagnosis with no snapshot at
   all: for each group, the entry list with sizes and the AMBIGUITY CLASSES
   (entries sharing an element count).  Entries with unique sizes can only
   sit at one set of offsets no matter what order torch used; only entries
   inside one class can be confused with each other.  For the paper dims the
   mult group has 4 nontrivial classes (the five M-sized biases, the two
   F-sized biases, the two (F,M) attention projections, and the
   att_state-to-M pair h_proj/merge) — everything else is pinned by size.

2. ``align_flat_by_content(flat, cfg, group, params)`` — given any trusted
   params tree (e.g. from our PyTorch cross-implementation, or a model
   round-tripped through third-party export code), recover the TRUE entry
   order of ``flat`` by content matching.  Returns the recovered layout,
   usable directly as ``flat_to_group(..., layout=...)``; compare against
   ``GROUP_LAYOUTS[group](cfg)`` to see (and permanently fix) the
   discrepancy.

3. ``search_layout_by_score(flat, cfg, group, score_fn)`` — no trusted
   params available (the real released-snapshot scenario): enumerate the
   orderings that differ from ours only inside ambiguity classes (all
   others are impossible by size) and pick the one maximizing ``score_fn``
   (e.g. fast-val accuracy of a small question subset against the
   RELEASED result JSONs that ship with every snapshot,
   experiments/*/download_trained_model.sh).

The port's own copy of ``rau_vqa_tpu/utils/layout_diag.py``; the trusted
tree may hold tensors (the port's) or arrays (the JAX package's), and the
subtrees ``flat_to_group`` gives are float32 CPU tensors.
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from rau_vqa_tpu_torch.config import ModelConfig
from rau_vqa_tpu_torch.utils.torch_convert import (
    Entry,
    GROUP_LAYOUTS,
    _float64,
    _get,
    flat_to_group,
)


def _entry_size(entry: Entry) -> int:
    return int(np.prod(entry[1]))


def ambiguity_classes(cfg: ModelConfig, group: str) -> List[List[Entry]]:
    """Entries of one group partitioned by element count.  Classes of size 1
    are order-pinned; only multi-entry classes admit order mismatches."""
    by_size: Dict[int, List[Entry]] = {}
    for entry in GROUP_LAYOUTS[group](cfg):
        by_size.setdefault(_entry_size(entry), []).append(entry)
    return [v for v in by_size.values()]


def layout_report(cfg: ModelConfig) -> str:
    """Human-readable diagnosis surface for all three groups."""
    lines = []
    for group in ("embed", "rnn", "mult"):
        layout = GROUP_LAYOUTS[group](cfg)
        total = sum(_entry_size(e) for e in layout)
        lines.append(f"[{group}] {len(layout)} tensors, {total} elements")
        off = 0
        for path, shape, transpose in layout:
            n = int(np.prod(shape))
            lines.append(f"  {off:>9d} +{n:<9d} {'/'.join(path):40s} "
                         f"torch{list(shape)}{' ^T' if transpose else ''}")
            off += n
        amb = [c for c in ambiguity_classes(cfg, group) if len(c) > 1]
        if amb:
            for c in amb:
                names = ", ".join("/".join(e[0]) for e in c)
                lines.append(f"  AMBIGUOUS ({_entry_size(c[0])} elems each): "
                             f"{names}")
        else:
            lines.append("  no ambiguity: every order mismatch is "
                         "size-detectable")
    return "\n".join(lines)


def align_flat_by_content(flat: np.ndarray, cfg: ModelConfig, group: str,
                          params: Dict, *, rtol: float = 1e-5,
                          atol: float = 1e-7) -> List[Entry]:
    """Recover the true entry order of ``flat`` by matching slice contents
    against a trusted ``params`` tree (our pytree convention).  Returns the
    recovered layout; raises with the offset and the candidate set when a
    segment matches nothing."""
    layout = GROUP_LAYOUTS[group](cfg)
    want = {e[0]: np.ascontiguousarray(
        _float64(_get({group: params}, e[0])).astype(np.float32).T
        if e[2] else _float64(_get({group: params}, e[0])).astype(np.float32)
    ).reshape(-1) for e in layout}
    total = sum(v.size for v in want.values())
    if flat.size != total:
        raise ValueError(f"{group}: flat has {flat.size} elements, "
                         f"params have {total}")
    flat = np.asarray(flat, np.float32).reshape(-1)
    remaining = dict(want)
    recovered: List[Entry] = []
    off = 0
    while remaining:
        match = None
        for path, vec in remaining.items():
            if off + vec.size <= flat.size and np.allclose(
                    flat[off:off + vec.size], vec, rtol=rtol, atol=atol):
                match = path
                break
        if match is None:
            sizes = sorted({v.size for v in remaining.values()})
            raise ValueError(
                f"{group}: no remaining tensor matches the slice at offset "
                f"{off} (remaining sizes: {sizes}) — contents disagree, not "
                f"just the order")
        recovered.append(next(e for e in layout if e[0] == match))
        off += want[match].size
        del remaining[match]
    return recovered


def layout_diff(cfg: ModelConfig, group: str,
                recovered: Sequence[Entry]) -> List[str]:
    """Positions where a recovered order disagrees with GROUP_LAYOUTS."""
    ours = GROUP_LAYOUTS[group](cfg)
    return [f"position {i}: ours {'/'.join(a[0])} vs snapshot "
            f"{'/'.join(b[0])}"
            for i, (a, b) in enumerate(zip(ours, recovered)) if a[0] != b[0]]


def _modules(layout: Sequence[Entry]) -> List[List[Entry]]:
    """Group consecutive entries into torch MODULES: each weight with the
    bias(es) that follow it under the same path prefix.  Torch's
    ``:parameters()`` returns each nn.Linear's weight and bias ADJACENTLY,
    so a real nngraph order mismatch permutes whole modules — never
    interleaves one module's tensors with another's.

    Grouping by path-prefix alone would be WRONG here: a DeepLSTM layer's
    i2h and h2h Linears are separate torch modules sharing our
    ('rnn','layers',L) prefix, and for every layer whose d_in == rnn_size
    their (weight, bias) signatures are identical — merging them would
    hide exactly the i2h<->h2h order ambiguity this module exists to
    enumerate."""
    out: List[List[Entry]] = []
    for entry in layout:
        leaf = entry[0][-1]
        if (out and leaf.startswith("b")
                and out[-1][0][0][:-1] == entry[0][:-1]):
            out[-1].append(entry)
        else:
            out.append([entry])
    return out


def candidate_layouts(cfg: ModelConfig, group: str,
                      max_candidates: int = 2048) -> List[List[Entry]]:
    """All orderings reachable by permuting MODULES with identical tensor
    size signatures.  Modules with unique signatures are pinned (a swap
    would be size-inconsistent somewhere); tensors inside a module never
    move (torch flattens weight/bias adjacently).  Ours-first, so index 0
    is the null hypothesis.  Swappable classes at paper dims include
    {att_q, att_i}, {h_proj, merge}, and every same-width i2h/h2h LSTM
    pair (layers with d_in == rnn_size)."""
    layout = GROUP_LAYOUTS[group](cfg)
    mods = _modules(layout)
    by_sig: Dict[Tuple[int, ...], List[int]] = {}
    for i, m in enumerate(mods):
        by_sig.setdefault(tuple(_entry_size(e) for e in m), []).append(i)
    classes = [idxs for idxs in by_sig.values() if len(idxs) > 1]
    perms_per_class = [list(itertools.permutations(idxs)) for idxs in classes]
    n = 1
    for p in perms_per_class:
        n *= len(p)
    if n > max_candidates:
        raise ValueError(f"{group}: {n} candidate orderings exceed "
                         f"max_candidates={max_candidates}")
    out = []
    for combo in itertools.product(*perms_per_class):
        slot_map = {i: i for i in range(len(mods))}
        for idxs, perm in zip(classes, combo):
            for dst, src in zip(idxs, perm):
                slot_map[dst] = src
        cand = [e for i in range(len(mods)) for e in mods[slot_map[i]]]
        out.append(cand)
    out.sort(key=lambda c: c != layout)
    return out


def search_layout_by_score(flat: np.ndarray, cfg: ModelConfig, group: str,
                           score_fn: Callable[[Dict], float],
                           max_candidates: int = 2048
                           ) -> Tuple[List[Entry], float]:
    """Try every ambiguity-class ordering, score the resulting subtree with
    ``score_fn`` (higher = better; e.g. answer agreement with a released
    result JSON on a question subset), return (best layout, best score)."""
    best, best_score = None, -np.inf
    for cand in candidate_layouts(cfg, group, max_candidates):
        sub = flat_to_group(np.asarray(flat), cfg, group, layout=cand)
        s = float(score_fn(sub))
        if s > best_score:
            best, best_score = cand, s
    return best, best_score
