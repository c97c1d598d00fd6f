"""One-command released-checkpoint parity harness.

The reference publishes one tarball per experiment containing the trained
snapshot(s) plus the exact per-hop result JSONs it produced
(`experiments/*/download_trained_model.sh`; snapshot format at
Ours_SS/LstmAttCtrlGradNoiseDontSelect.lua:1188-1197, result naming at
:1167-1186).  Those result files are the golden outputs: a converted
checkpoint that reproduces them through this pipeline proves layout and
numerics end-to-end (the "identical answer distributions" claim of
experiments/README.md:10-12).

This module is that whole pipeline as one call, offline-testable against a
fabricated released-format tarball (tests/test_torch_port_released.py):

    extract tarball -> pick the snapshot (highest epoch, or --epoch)
    -> adopt snap.opt.nhop / alg_name (Eval.lua:116-118 behaviour)
    -> convert the three flat vectors (utils.torch_convert; size mismatch
       triggers a layout_diag report instead of a crash)
    -> run the nHop+2 eval sweep through the port's Trainer (the serving
       kernels on the card)
    -> diff the answer sets against the result JSONs INSIDE the tarball.

With a released tarball on local disk:

    python -m rau_vqa_tpu_torch.cli verify-released \
        --tarball save_result_vqa_448_test-dev2015.tar.gz \
        --preset ours_ss --vqa-dir data/VQA_prepro/data_train-val_test-dev \
        --feat-dir data/vqa_VGG16Conv_pool5_448/feat_448x448

The port's own copy of ``rau_vqa_tpu/eval/released.py``: the converted
groups are loaded into the port ``Trainer``'s parameters on its device; a
device mesh stays refused (``roadmap.py``, item 7).
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import re
import tarfile
from typing import Any, Dict, List, Optional, Tuple


_SNAP_RE = re.compile(r"snapshot_iter(\d+)_epoch([0-9.]+?)\.t7$")


def extract_tarball(tarball: str, out_dir: str) -> str:
    """Extract a released tarball; returns the extraction root."""
    os.makedirs(out_dir, exist_ok=True)
    with tarfile.open(tarball) as tf:
        tf.extractall(out_dir, filter="data")
    return out_dir


def find_snapshots(root: str) -> List[Tuple[float, int, str]]:
    """All reference-format snapshots under ``root`` as
    (epoch, it, path), sorted by epoch (snapshot naming at reference
    :1188-1189: snapshot_iter%06d_epoch%.2f.t7)."""
    out = []
    for path in glob.glob(os.path.join(root, "**", "snapshot_*.t7"),
                          recursive=True):
        m = _SNAP_RE.search(os.path.basename(path))
        if m:
            out.append((float(m.group(2)), int(m.group(1)), path))
    return sorted(out)


def pick_snapshot(root: str, epoch: Optional[float] = None) -> Tuple[float, str]:
    snaps = find_snapshots(root)
    if not snaps:
        raise FileNotFoundError(
            f"no snapshot_iter*_epoch*.t7 under {root} — not a released "
            f"result tarball?")
    if epoch is not None:
        for e, _, p in snaps:
            if abs(e - epoch) < 1e-6:
                return e, p
        raise FileNotFoundError(
            f"epoch {epoch} not in tarball (available: "
            f"{[e for e, _, _ in snaps]})")
    e, _, p = snaps[-1]
    return e, p


def load_result_rows(root: str, task: str, hop: int, epoch: float,
                     split: str = "*") -> Optional[Dict[int, str]]:
    """qid -> answer map from the tarball's own result JSON for one hop
    (naming: reference :1171-1177; located under results/hop_XX).  Pin
    ``split`` — a tarball shipping more than one split's results would
    otherwise diff against an arbitrary glob hit."""
    pat = os.path.join(root, "**", f"hop_{hop:02d}",
                       f"vqa_{task}_mscoco_{split}_*{hop:02d}"
                       f"hop-{epoch:.2f}_results.json")
    paths = sorted(glob.glob(pat, recursive=True))
    if not paths:
        return None
    with open(paths[0]) as f:
        rows = json.load(f)
    return {int(r["question_id"]): r["answer"] for r in rows}


def _diff_rows(ours: List[Dict], theirs: Dict[int, str]) -> Dict[str, Any]:
    """Agreement stats between our rows and the tarball's qid->answer map."""
    ours_map = {int(r["question_id"]): r["answer"] for r in ours}
    common = set(ours_map) & set(theirs)
    agree = sum(ours_map[q] == theirs[q] for q in common)
    return {
        "n_ours": len(ours_map),
        "n_released": len(theirs),
        "n_common": len(common),
        "agree": agree / max(len(common), 1),
        "qid_mismatch": len(ours_map) != len(theirs)
                        or len(common) != len(ours_map),
    }


def adopt_snapshot_opt(exp, snap_opt: Dict) -> Any:
    """Adopt the snapshot's self-describing options, as Eval.lua does with
    snap.opt (Eval.lua:116-118): nhop, alg_name, and the CNN feature dims
    when present."""
    m = {}
    if "nhop" in snap_opt:
        m["n_hops"] = int(snap_opt["nhop"])
    for src, dst in (("cnnout_dim", "cnn_dim"), ("cnnout_w", "cnn_w"),
                     ("cnnout_h", "cnn_h")):
        if src in snap_opt:
            m[dst] = int(snap_opt[src])
    if m:
        exp = exp.replace(model=dataclasses.replace(exp.model, **m))
    if "alg_name" in snap_opt:
        exp = exp.replace(alg_name=str(snap_opt["alg_name"]))
    return exp


def verify_released(extracted_root: str, exp, data, source, workdir: str, *,
                    epoch: Optional[float] = None,
                    gt_anno: Optional[Dict[int, str]] = None,
                    official_anno: Optional[str] = None,
                    snapshot: Optional[Tuple[float, str, Dict]] = None,
                    device=None, mesh=None) -> Dict[str, Any]:
    """Run the full parity pipeline against an extracted released tarball.

    Returns a report: per-hop OE/MC agreement fractions vs the tarball's
    own result JSONs, plus ``min_agree`` over every hop compared.  A layout
    size mismatch produces ``{"error": "layout", "report": ...}`` with the
    layout_diag segmentation instead of raising.  With ``official_anno``
    (official VQA annotations JSON for the split), every hop additionally
    gets BOTH answer sets scored with the official 10-rater metric —
    'ours' vs 'released' accuracy side by side, the paper's "within 0.1%"
    claim as numbers.  ``device`` is the Trainer's (cuda when None); a
    ``mesh`` is refused, as the Trainer refuses it.
    """
    from rau_vqa_tpu_torch.convert import map_tree
    from rau_vqa_tpu_torch.data import t7
    from rau_vqa_tpu_torch.train.trainer import Trainer
    from rau_vqa_tpu_torch.utils import torch_convert as tc

    if snapshot is not None:
        # caller already picked + parsed it (large t7 blobs parse once)
        snap_epoch, snap_path, snap = snapshot
    else:
        snap_epoch, snap_path = pick_snapshot(extracted_root, epoch)
        snap = t7.load_t7(snap_path)
    snap_opt = snap.get("opt", {}) if isinstance(snap, dict) else {}
    exp = adopt_snapshot_opt(exp, snap_opt)

    trainer = Trainer(exp, data, source, workdir, gt_anno=gt_anno,
                      official_anno=official_anno, device=device, mesh=mesh)
    mcfg = trainer.mcfg

    flats = tc.flats_from_snapshot(snap)
    sizes_ok = all(f.size == tc.group_size(mcfg, g)
                   for f, g in zip(flats, ("embed", "rnn", "mult")))
    if not sizes_ok:
        from rau_vqa_tpu_torch.utils.layout_diag import layout_report
        return {
            "error": "layout",
            "snapshot": snap_path,
            "sizes": {g: {"snapshot": int(f.size),
                          "config": tc.group_size(mcfg, g)}
                      for f, g in zip(flats, ("embed", "rnn", "mult"))},
            "report": layout_report(mcfg),
        }

    params = {g: tc.flat_to_group(f, mcfg, g)
              for g, f in zip(("embed", "rnn", "mult"), flats)}
    # the converted groups into the Trainer's parameters, on its device and
    # in their types (the float64 snapshot rounds to float32 as it loads)
    trainer.state = trainer.state._replace(params=map_tree(
        lambda t, s: s.to(t.device, t.dtype), trainer.state.params, params))
    # keep the FRACTIONAL epoch (snapshot_iter%06d_epoch%.2f, e.g. 3.54):
    # evaluate() names submissions/attention dumps by it, and int() would
    # misname them vs the released files this harness diffs against
    trainer.epoch = snap_epoch

    result = trainer.evaluate(write_submissions=True, return_rows=True)

    report: Dict[str, Any] = {
        "snapshot": snap_path,
        "epoch": snap_epoch,
        "alg_name": exp.alg_name,
        "n_hops": mcfg.n_hops,
        "hops": {},
    }
    if "testOEacc" in result:
        report["testOEacc"] = result["testOEacc"]
    if "testOEaccOfficial" in result:
        report["testOEaccOfficial"] = result["testOEaccOfficial"]
    scorer = trainer._official_scorer   # built by evaluate() if requested

    def _official(rows_dict: Dict[int, str]) -> float:
        rep = scorer.score([{"question_id": q, "answer": a}
                            for q, a in rows_dict.items()])
        return rep["overall"] / 100.0

    agrees = []
    for h in range(mcfg.n_hops + 2):
        hop_report = {}
        released_oe = load_result_rows(extracted_root, "OpenEnded", h + 1,
                                       snap_epoch, split=exp.data.split)
        if released_oe is not None:
            hop_report["oe"] = _diff_rows(result["rows_oe"][h], released_oe)
            agrees.append(hop_report["oe"]["agree"])
            if scorer is not None:
                # the paper claim as numbers: our accuracy vs the
                # tarball's own answers under the official metric
                hop_report["oe"]["official_ours"] = \
                    result["testOEaccOfficial"][h]
                hop_report["oe"]["official_released"] = \
                    _official(released_oe)
        released_mc = load_result_rows(extracted_root, "MultipleChoice",
                                       h + 1, snap_epoch,
                                       split=exp.data.split)
        if released_mc is not None and result["rows_mc"] is not None:
            hop_report["mc"] = _diff_rows(result["rows_mc"][h], released_mc)
            agrees.append(hop_report["mc"]["agree"])
            if scorer is not None:
                hop_report["mc"]["official_ours"] = \
                    result["testMCaccOfficial"][h]
                hop_report["mc"]["official_released"] = \
                    _official(released_mc)
        if hop_report:
            report["hops"][h + 1] = hop_report
    if not agrees:
        report["error"] = "no_result_jsons"
    else:
        report["min_agree"] = min(agrees)
    return report
