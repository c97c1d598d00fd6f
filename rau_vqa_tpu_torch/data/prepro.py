"""VQA v1 preprocessing: official release JSONs -> data_prepro.{json,h5}.

The reference consumes bundles preprocessed by an EXTERNAL repo
(data/VQA_prepro/README.md: "data is preprocessed by scripts given by
VT-vision-lab/VQA_LSTM_CNN"; data/get_vqa_prepro.sh only downloads the
output).  This module produces the same on-disk contract natively
(the schema documented at vqa_prepro_loader.lua:1306-1330 and consumed by
data/loader.py), so a user holding only the official VQA v1 release
(questions + annotations JSONs) plus raw COCO images can build EVERY input
the framework needs: `prepro` -> bundle, `precompute-features` ->
feature shard, then train/eval/serve — zero reference downloads.

Pipeline (the published prepro's behavior, reimplemented):
  1. join questions with annotations per split (multiple_choice_answer is
     the training label, as in the upstream vqa_preprocessing.py merge)
  2. top-N answer vocabulary by train frequency (default 1000); train rows
     whose answer is outside it are dropped
  3. tokenize: lowercase + punctuation-splitting regex (punctuation marks
     are tokens); tokenizer is pluggable — exact token-level identity with
     the released bundles is unverifiable offline, so the convention is
     documented here rather than silently assumed
  4. word vocabulary with a count threshold; rare/unseen words -> 'UNK'
     (always present, last index)
  5. encode to [N, max_length] zero-padded int arrays — ids are 1-based
     with 0 = pad, exactly the released format (data/loader.py reads those
     values unchanged under its 0-based reinterpretation)
  6. unique image lists ('<split>/COCO_<split>_<012d>.jpg') + 1-based
     img_pos + per-question datatype = 1-based train-source index (the
     multi-dir feature routing of vqa_prepro_loader.lua:876)
  7. optional outputs: MC_ans_test from a MultipleChoice questions JSON
     (0 = choice not in the answer vocab -> loader's -1 'absent'), and the
     comprehend-format {qid: answer} fast-validation map when the test
     split has annotations

The port's own copy of ``rau_vqa_tpu/data/prepro.py``: the same order of
answers and words (``Counter.most_common`` breaks ties by first appearance,
the vocabulary keeps insertion order), so ``data_prepro.json`` comes out
byte for byte the same and the h5 arrays bit for bit; the h5 is written by
``data/hdf5.py``, the tokenizer is ``data/loader.py``'s.
"""

from __future__ import annotations

import json
import os
from collections import Counter
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from rau_vqa_tpu_torch.data.hdf5 import write_h5
from rau_vqa_tpu_torch.data.loader import tokenize
from rau_vqa_tpu_torch.data.qa_utils import cocoimg_name


@dataclass(frozen=True)
class PreproConfig:
    num_answers: int = 1000      # top-N answer vocabulary
    max_length: int = 26         # question token capacity (the h5 width)
    word_threshold: int = 0      # words with count <= threshold -> UNK
    mc_width: int = 18           # MC_ans_test columns (VQA v1 MC task)


@dataclass
class Entry:
    """One question row after the join step."""

    question_id: int
    split: str                   # 'train2014' / 'val2014' / 'test2015' ...
    image_id: int
    question: str
    answer: Optional[str] = None           # multiple_choice_answer
    multiple_choices: Optional[List[str]] = None


def join_split(questions_json: str, annotations_json: Optional[str],
               split: str) -> List[Entry]:
    """Join an official questions JSON with its annotations (by
    question_id), like the upstream vqa_preprocessing.py merge."""
    with open(questions_json) as f:
        qs = json.load(f)["questions"]
    ans_by_qid: Dict[int, str] = {}
    if annotations_json:
        with open(annotations_json) as f:
            for a in json.load(f)["annotations"]:
                ans_by_qid[int(a["question_id"])] = a["multiple_choice_answer"]
    out = []
    for q in qs:
        qid = int(q["question_id"])
        out.append(Entry(
            question_id=qid, split=split, image_id=int(q["image_id"]),
            question=q["question"], answer=ans_by_qid.get(qid),
            multiple_choices=q.get("multiple_choices")))
    return out


def _top_answers(entries: Sequence[Entry], n: int) -> List[str]:
    counts = Counter(e.answer for e in entries if e.answer is not None)
    return [a for a, _ in counts.most_common(n)]


def _build_vocab(token_lists: Sequence[List[str]], threshold: int) -> List[str]:
    counts: Counter = Counter()
    for toks in token_lists:
        counts.update(toks)
    vocab = [w for w, c in counts.items() if c > threshold]
    vocab.append("UNK")
    return vocab


def _encode(token_lists: Sequence[List[str]], word_to_ix: Dict[str, int],
            max_length: int) -> Tuple[np.ndarray, np.ndarray]:
    unk = word_to_ix["UNK"]
    n = len(token_lists)
    ques = np.zeros((n, max_length), np.int32)
    lengths = np.zeros((n,), np.int32)
    for i, toks in enumerate(token_lists):
        toks = toks[:max_length]
        lengths[i] = max(len(toks), 1)   # loader contract: length >= 1
        for j, t in enumerate(toks):
            ques[i, j] = word_to_ix.get(t, unk)
    return ques, lengths


# question-split -> physical COCO image directory.  test-dev2015 is a
# SUBSET of the test2015 image set: its questions reference files named
# COCO_test2015_<012d>.jpg under test2015/ (there is no test-dev image
# folder), and the released bundles' unique_img_test paths confirm it
# (vqa_prepro_loader.lua:1311 documents 'test2015/COCO_test2015_...jpg').
_IMG_SPLIT = {"test-dev2015": "test2015"}


def _img_index(entries: Sequence[Entry]) -> Tuple[List[str], np.ndarray]:
    """(unique image rel paths, 1-based per-entry img_pos)."""
    unique: List[str] = []
    by_path: Dict[str, int] = {}
    pos = np.zeros((len(entries),), np.int64)
    for i, e in enumerate(entries):
        img_split = _IMG_SPLIT.get(e.split, e.split)
        path = f"{img_split}/{cocoimg_name(img_split, e.image_id)}"
        ix = by_path.get(path)
        if ix is None:
            unique.append(path)
            ix = by_path[path] = len(unique)   # 1-based
        pos[i] = ix
    return unique, pos


def build_prepro(train_sources: Sequence[Tuple[str, Sequence[Entry]]],
                 test_entries: Sequence[Entry], out_dir: str,
                 cfg: PreproConfig = PreproConfig(), *,
                 write_gt: bool = True) -> Dict[str, object]:
    """Write data_prepro.{json,h5} (+ gt_annotations.json if the test
    split is annotated and ``write_gt``).

    ``train_sources`` is an ordered list of (split_name, entries): each
    source gets datatype index 1, 2, ... — the 1-based per-question
    feature-directory routing.  Returns a small summary dict."""
    os.makedirs(out_dir, exist_ok=True)
    flat_train: List[Entry] = []
    dt_all: List[int] = []
    for dt, (_name, entries) in enumerate(train_sources, start=1):
        for e in entries:
            if e.answer is None:
                raise ValueError(
                    f"train source {_name!r} has unannotated question "
                    f"{e.question_id} — train splits need annotations")
            flat_train.append(e)
            dt_all.append(dt)

    top = _top_answers(flat_train, cfg.num_answers)
    ans_to_ix = {a: i + 1 for i, a in enumerate(top)}   # 1-based
    keep = [i for i, e in enumerate(flat_train) if e.answer in ans_to_ix]
    dropped = len(flat_train) - len(keep)
    train = [flat_train[i] for i in keep]
    dt_train = np.asarray([dt_all[i] for i in keep], np.int32)

    train_toks = [tokenize(e.question) for e in train]
    test_toks = [tokenize(e.question) for e in test_entries]
    vocab = _build_vocab(train_toks, cfg.word_threshold)
    word_to_ix = {w: i + 1 for i, w in enumerate(vocab)}   # 1-based, 0 pad

    ques_tr, len_tr = _encode(train_toks, word_to_ix, cfg.max_length)
    ques_te, len_te = _encode(test_toks, word_to_ix, cfg.max_length)
    uniq_tr, pos_tr = _img_index(train)
    uniq_te, pos_te = _img_index(test_entries)

    mc = np.zeros((len(test_entries), cfg.mc_width), np.int32)
    for i, e in enumerate(test_entries):
        for j, choice in enumerate((e.multiple_choices or [])[:cfg.mc_width]):
            mc[i, j] = ans_to_ix.get(choice, 0)   # 0 -> loader's 'absent'

    arrays = {
        "ques_train": ques_tr,
        "ques_length_train": len_tr,
        "img_pos_train": pos_tr,
        "question_id_train": np.asarray(
            [e.question_id for e in train], np.int64),
        "answers": np.asarray(
            [ans_to_ix[e.answer] for e in train], np.int32),
    }
    if len(train_sources) > 1:
        arrays["datatype_train"] = dt_train
    arrays.update({
        "ques_test": ques_te,
        "ques_length_test": len_te,
        "img_pos_test": pos_te,
        "question_id_test": np.asarray(
            [e.question_id for e in test_entries], np.int64),
        "MC_ans_test": mc,
    })
    write_h5(os.path.join(out_dir, "data_prepro.h5"), arrays)

    with open(os.path.join(out_dir, "data_prepro.json"), "w") as f:
        json.dump({
            "ix_to_word": {str(i + 1): w for i, w in enumerate(vocab)},
            "ix_to_ans": {str(i + 1): a for i, a in enumerate(top)},
            "unique_img_train": uniq_tr,
            "unique_img_test": uniq_te,
        }, f)

    gt_path = None
    if write_gt and any(e.answer is not None for e in test_entries):
        # the comprehend-format fast-validation map (loader
        # load_gt_annotations: {qid: answer string})
        gt_path = os.path.join(out_dir, "gt_annotations.json")
        with open(gt_path, "w") as f:
            json.dump({str(e.question_id): e.answer for e in test_entries
                       if e.answer is not None}, f)

    return {"n_train": len(train), "n_dropped": dropped,
            "n_test": len(test_entries), "vocab_size": len(vocab),
            "n_answers": len(top), "gt_annotations": gt_path}
