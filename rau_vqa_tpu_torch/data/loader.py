"""VQA preprocessed-data loader.

Implements the data contract of the reference's ``data_prepro.json`` /
``data_prepro.h5`` bundle (schema documented at
utils/vqa_prepro_loader.lua:1306-1330) with one deliberate divergence:

**Token/answer indices are 0-based.**  The reference shifts every question
token by +1 so Lua's 1-based LookupTable sees padding as index 1
(vqa_prepro_loader.lua:1335,1373) and builds ``vocab_dict[1]='ZEROPAD'``
(:1393-1398).  Here the h5 token values are used unchanged: 0 = ZEROPAD,
word ids 1..N as stored; answer labels become h5-1 (0..answer_size-1).
Embedding row k therefore corresponds to Torch embedding row k+1 — which is
the *same physical row* of the weight matrix, so checkpoint conversion is a
pure reinterpretation.

Batch-order policies (shuffle / inorder / sort / randsort) reproduce
vqa_prepro_loader.lua:1219-1288 semantics, including the epoch boundary rule:
a batch is always full-size, the epoch has ``floor(N / B)`` batches, and the
order is regenerated when the *next* batch would overflow (:911-914).

Prefetch: the reference dedicates one torch-thread to load the next batch's
.t7 features while the trainer computes (:931-958).  Here a one-worker
executor double-buffers the feature gather; with a ``PackedFeatureStore`` the
gather itself is a single mmap fancy-index.

The port's own copy of ``rau_vqa_tpu/data/loader.py``.  The bundle is read
in two steps: ``read_prepro`` reads the files (``h5py`` is imported there
and only there), ``build_vqa_data`` builds the splits from the JSON info
and the arrays, so an in-memory bundle (``data/fixtures.py``) needs no
``h5py``.
"""

from __future__ import annotations

import json
import os
import re
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from rau_vqa_tpu_torch.data.features import FeatureSource, coco_feat_name


# the punctuation-splitting tokenizer every bundle's vocab was built with
# (rau_vqa_tpu/data/prepro.py tokenize): each mark is its own token
_TOKEN_SPLIT = re.compile(r"([-.\"',:? !\$#@~()*&\^%;\[\]/\\\+<>\n=])")


def tokenize(sentence: str) -> List[str]:
    return [t for t in _TOKEN_SPLIT.split(sentence.lower())
            if t not in ("", " ", "\n")]


@dataclass
class Batch:
    """One host-side batch, numpy, ready for device_put."""

    feats: object            # [B, S, D] float32, tuple of arrays, or None
    tokens: np.ndarray       # [B, T] int32, 0 = ZEROPAD
    lengths: np.ndarray      # [B] int32, >= 1
    labels: Optional[np.ndarray]   # [B] int32 0-based (train splits)
    mc_answers: Optional[np.ndarray]  # [B, NMC] int32 0-based, -1 = absent (test)
    qids: np.ndarray         # [B] int64


class SplitData:
    """One data split with batch-order state and prefetched batch iteration."""

    def __init__(self, name: str, questions: np.ndarray, lengths: np.ndarray,
                 img_names: List[str], datatypes: np.ndarray, qids: np.ndarray,
                 batch_size: int, *, answers: Optional[np.ndarray] = None,
                 mc_answers: Optional[np.ndarray] = None, seed: int = 123,
                 img_paths: Optional[List[str]] = None):
        assert questions.ndim == 2
        if questions.shape[0] == 0:
            raise ValueError(
                f"split {name!r} is empty — check valid_ratio / the h5 "
                f"bundle (an int(n * ratio) of 0 yields an empty val split)")
        assert lengths.min() >= 1, "every question must have >= 1 token"
        self.name = name
        self.questions = questions.astype(np.int32)
        self.lengths = lengths.astype(np.int32)
        self.img_names = img_names          # per-question feature-file name
        self.img_paths = img_paths          # per-question image rel path
        self.datatypes = datatypes.astype(np.int32)
        self.qids = qids.astype(np.int64)
        self.answers = None if answers is None else answers.astype(np.int32)
        self.mc_answers = None if mc_answers is None else mc_answers.astype(np.int32)
        self.num_examples = questions.shape[0]
        self.batch_size = batch_size
        self.seed = seed
        # each reorder draws from a counter-seeded stream so the epoch order
        # is a pure function of (seed, epoch) — training resumes with the
        # exact data order of an uninterrupted run
        self.reorder_count = 0
        self.order_policy = "shuffle"
        self.batch_order = np.arange(self.num_examples)
        self.batch_index = 0

    @property
    def iter_per_epoch(self) -> int:
        return self.num_examples // self.batch_size

    # ---- batch-order policies (vqa_prepro_loader.lua:1219-1288) ----

    def set_batch_order_option(self, policy: str) -> None:
        if policy not in ("shuffle", "inorder", "sort", "randsort",
                          "imggroup"):
            raise ValueError(f"unknown batch order policy {policy!r}")
        if policy == "imggroup":
            self.uniform_image_group_size()   # validate upfront, loudly
        self.order_policy = policy

    def uniform_image_group_size(self) -> int:
        """Questions-per-image count, required uniform (VQA v1 asks
        exactly 3 per image).  The 'imggroup' order and the fine-tuning
        img_repeat path depend on it; a valid_ratio re-split can break
        uniformity — fail with that diagnosis instead of mis-grouping."""
        keys = (self.img_paths if self.img_paths is not None
                else self.img_names)
        _, counts = np.unique(np.asarray(keys, dtype=object),
                              return_counts=True)
        if counts.min() != counts.max():
            raise ValueError(
                f"split {self.name!r}: questions-per-image is not uniform "
                f"(min {counts.min()}, max {counts.max()}) — the "
                f"'imggroup' batch order needs uniform groups (a "
                f"valid_ratio re-split slices questions, not images; use "
                f"valid_ratio=0 or the 'shuffle' order)")
        return int(counts[0])

    def reorder(self) -> None:
        self.batch_index = 0
        rng = np.random.default_rng((self.seed, self.reorder_count))
        self.reorder_count += 1
        if self.order_policy == "shuffle":
            self.batch_order = rng.permutation(self.num_examples)
        elif self.order_policy == "inorder":
            self.batch_order = np.arange(self.num_examples)
        elif self.order_policy == "sort":
            self.batch_order = np.argsort(self.lengths, kind="stable")
        elif self.order_policy == "randsort":
            # sort by length, random order within equal-length runs
            tiebreak = rng.permutation(self.num_examples)
            self.batch_order = np.lexsort((tiebreak, self.lengths))
        elif self.order_policy == "imggroup":
            # image-grouped shuffle: each image's questions stay
            # CONSECUTIVE, group order shuffles per epoch (counter-seeded
            # like the rest).  With uniform groups (validated in
            # set_batch_order_option) and batch_size % group == 0, every
            # batch starts on a group boundary — the contract the
            # fine-tuning img_repeat path needs (one backbone pass per
            # image; trainer.make_train_step)
            keys = (self.img_paths if self.img_paths is not None
                    else self.img_names)
            _, inv = np.unique(np.asarray(keys, dtype=object),
                               return_inverse=True)
            group_rank = rng.permutation(inv.max() + 1)
            self.batch_order = np.lexsort(
                (np.arange(self.num_examples), group_rank[inv]))

    def inorder(self) -> None:
        self.set_batch_order_option("inorder")
        self.reorder()

    # ---- batch fetch ----

    def _check_iterable(self) -> None:
        # raised at ITERATION time, not construction: a bundle may carry an
        # undersized split (e.g. a tiny valid_ratio re-split) that the
        # workflow never iterates — only actually drawing batches from it
        # is an error (batches are always full-size by contract, so
        # iter_per_epoch would be 0 and every epoch a silent no-op)
        if self.num_examples < self.batch_size:
            raise ValueError(
                f"split {self.name!r} has {self.num_examples} examples < "
                f"batch_size {self.batch_size}: zero full batches — lower "
                f"the batch size (the reference picks the test batch size "
                f"to divide the split, Ours_SS/...lua:85-95)")

    def _batch_indices(self) -> np.ndarray:
        self._check_iterable()
        idx = self.batch_order[self.batch_index:self.batch_index + self.batch_size]
        self.batch_index += self.batch_size
        # reorder when the NEXT batch would overflow (reference :911-914)
        if self.batch_index + self.batch_size > self.num_examples:
            self.reorder()
        return idx

    def _assemble(self, idx: np.ndarray, feats: np.ndarray) -> Batch:
        return Batch(
            feats=feats,
            tokens=self.questions[idx],
            lengths=self.lengths[idx],
            labels=None if self.answers is None else self.answers[idx],
            mc_answers=None if self.mc_answers is None else self.mc_answers[idx],
            qids=self.qids[idx],
        )

    def _fetch_source(self, source, idx: np.ndarray,
                      image_stride: int = 1) -> np.ndarray:
        """One source fetch: FeatureSource by feature-file name, or an image
        source (duck-typed: no ``dim`` attribute) by image path — the two
        operand kinds of the reference's next_batch_feat / next_batch_image /
        next_batch_feat_image family (vqa_prepro_loader.lua:1012-1192).

        ``image_stride = g > 1`` (image source + 'imggroup' order only):
        fetch every g-th row — the batch's UNIQUE images — skipping the
        decode-replicate of g-1 duplicate rows per group entirely (the
        grouped fine-tuning path repeats FEATURES on device instead)."""
        if hasattr(source, "dim"):
            if image_stride != 1:
                raise ValueError("image_stride applies to image sources")
            names = [self.img_names[i] for i in idx]
            return source.get_batch(names, self.datatypes[idx])
        if self.img_paths is None:
            raise ValueError("split has no image paths for an image source")
        return source.get_batch(
            [self.img_paths[i] for i in idx[::image_stride]])

    def next_batch(self, source: FeatureSource) -> Batch:
        idx = self._batch_indices()
        return self._assemble(idx, self._fetch_source(source, idx))

    def next_batch_text(self) -> Batch:
        """Text-only batch (the reference's next_batch, :1194-1217)."""
        idx = self._batch_indices()
        return self._assemble(idx, None)

    def next_batch_multi(self, sources) -> Batch:
        """Multi-operand batch: feats is a tuple, one entry per source (the
        reference's next_batch_twofeats / next_batch_feat_image, :220, :565)."""
        idx = self._batch_indices()
        feats = tuple(self._fetch_source(s, idx) for s in sources)
        return self._assemble(idx, feats)

    def batches(self, source: FeatureSource, num_batches: Optional[int] = None,
                prefetch: bool = True,
                include_tail: bool = False,
                image_stride: int = 1,
                finish: Optional[Callable[[Batch], Batch]] = None
                ) -> Iterator[Batch]:
        """Iterate batches; with prefetch the (i+1)-th feature gather overlaps
        consumption of the i-th batch (the reference's 1-worker thread pool,
        vqa_prepro_loader.lua:66-80,931-958).

        ``include_tail`` additionally yields one final PARTIAL batch covering
        the ``num_examples % batch_size`` remainder under the order in force
        at iteration start, so a full sweep covers every example — the
        reference instead requires the batch size to divide the split
        (Ours_SS/...lua:85-95).  The tail fetch is stateless: it does not
        advance batch_index/reorder, so epoch-order semantics for subsequent
        epochs are unchanged.  Only meaningful with num_batches=None.

        ``image_stride`` forwards to :meth:`_fetch_source` (grouped
        fine-tuning: decode each batch's unique images once).

        ``finish``, when given, maps each assembled batch to the one
        yielded; with prefetch it runs in the worker too (the trainer pins
        the batch there for its copy to the card)."""
        def make(idx):
            batch = self._assemble(idx, self._fetch_source(source, idx, image_stride))
            return batch if finish is None else finish(batch)

        tail_idx = None
        if include_tail:
            if num_batches is not None:
                raise ValueError("include_tail requires num_batches=None "
                                 "(a full sweep)")
            if self.batch_index != 0:
                # mid-epoch, 'one full sweep' is unsatisfiable: the loop
                # would cross the reorder boundary (repeating examples)
                # and the captured tail could be empty — fail loudly
                # instead of silently breaking the every-example promise
                raise ValueError(
                    f"include_tail requires an epoch boundary "
                    f"(batch_index={self.batch_index}); call inorder()/"
                    f"reorder() first")
            # capture NOW: _batch_indices reorders when the next batch would
            # overflow, replacing batch_order before the loop finishes
            start = self.batch_index + self.iter_per_epoch * self.batch_size
            tail_idx = self.batch_order[start:]
            if self.num_examples == 0:
                raise ValueError(f"split {self.name!r} is empty")
        else:
            self._check_iterable()   # n == 0 would otherwise no-op silently
        n = self.iter_per_epoch if num_batches is None else num_batches
        if not prefetch:
            for _ in range(n):
                yield make(self._batch_indices())
            if tail_idx is not None and tail_idx.size:
                yield make(tail_idx)
            return
        with ThreadPoolExecutor(max_workers=1) as pool:
            def submit():
                # indices advance synchronously; the fetch itself (feature
                # gather or image decode — _fetch_source's dispatch), the
                # batch's assembly and ``finish`` run in the worker, like
                # the reference's prefetch thread.
                # The pre-advance state snapshot lets an abandoned
                # generator rewind (below) — reorder() is a pure function
                # of (seed, reorder_count), so restoring the triple is
                # exact even across an epoch boundary.
                snap = (self.batch_index, self.reorder_count,
                        self.batch_order)
                return snap, pool.submit(make, self._batch_indices())

            if n == 0:
                # include_tail on a split smaller than batch_size: one
                # partial batch is the whole sweep
                if tail_idx is not None and tail_idx.size:
                    yield make(tail_idx)
                return
            pending = submit()
            try:
                for i in range(n):
                    _, fut = pending
                    batch = fut.result()
                    if i + 1 < n:
                        pending = submit()
                    elif tail_idx is not None and tail_idx.size:
                        # prefetch the tail like any other batch (no order
                        # state to snapshot — the indices were captured at
                        # iteration start and nothing advances)
                        pending = (None, pool.submit(make, tail_idx))
                    else:
                        pending = None
                    yield batch
                if pending is not None:
                    _, fut = pending
                    pending = None
                    yield fut.result()
            finally:
                if pending is not None and pending[0] is not None:
                    # generator closed early (break / islice / error):
                    # the prefetched batch was never yielded — rewind the
                    # order state so its examples are not silently
                    # skipped and the data order matches prefetch=False
                    # (a pending TAIL fetch has no snapshot: it is
                    # stateless, nothing to rewind)
                    (self.batch_index, self.reorder_count,
                     self.batch_order) = pending[0]


@dataclass
class VQAData:
    """The full dataset bundle: vocab/answer dictionaries + splits."""

    vocab: List[str]                  # index -> word; vocab[0] == 'ZEROPAD'
    vocab_map: Dict[str, int]
    answers: List[str]                # index -> answer string (0-based)
    answer_map: Dict[str, int]
    seq_len: int
    train_data: Optional[SplitData] = None
    val_data: Optional[SplitData] = None
    test_data: Optional[SplitData] = None

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    @property
    def answer_size(self) -> int:
        return len(self.answers)

    # ---- token/string helpers (vqa_prepro_loader.lua:154-218) ----

    def question_to_tokens(self, question: str, *, normalize: bool = False):
        """Tokenization against the vocab, unknowns -> 'UNK'
        (vqa_prepro_loader.lua:167-180).  A vocab without 'UNK' fails
        loudly on the first unknown word — the reference nil-indexes in
        the same situation; mapping unknowns to ZEROPAD would silently
        feed padding embeddings mid-question.

        ``normalize=False`` is the reference-exact raw whitespace split.
        ``normalize=True`` applies the lowercase + punctuation-splitting
        convention every bundle's vocab was BUILT with (data/prepro.py
        tokenize, the ``tokenize`` above) — without it, serve/ask-time questions like 'What color
        is the cat?' hit UNK on 'What' and 'cat?' and the model sees a
        question distribution unlike training."""
        toks = np.zeros((self.seq_len,), np.int32)
        if normalize:
            words = tokenize(question)
        else:
            words = question.split()
        unk = self.vocab_map.get("UNK")
        n = min(len(words), self.seq_len)
        for i, w in enumerate(words[:n]):
            tok = self.vocab_map.get(w, unk)
            if tok is None:
                raise KeyError(
                    f"word {w!r} is not in the vocabulary and this "
                    f"bundle has no 'UNK' entry to map it to")
            toks[i] = tok
        return toks, max(n, 1)

    def tokens_to_question(self, tokens: np.ndarray, length: Optional[int] = None) -> str:
        n = len(tokens) if length is None else length
        return " ".join(self.vocab[int(t)] for t in tokens[:n])

    def answer_to_index(self, answer: str) -> Optional[int]:
        return self.answer_map.get(answer)

    def index_to_answer(self, idx: int) -> str:
        return self.answers[int(idx)]


def _img_names_for(img_pos: np.ndarray, unique_imgs: Sequence[str]) -> List[str]:
    # img_pos is 1-based into the json unique image list (schema :1322)
    return [coco_feat_name(unique_imgs[int(p) - 1]) for p in img_pos]


# the h5 datasets of the bundle, in the order read_prepro reads them
PREPRO_ARRAYS = ("ques_train", "ques_length_train", "img_pos_train",
                 "question_id_train", "answers", "ques_test",
                 "ques_length_test", "img_pos_test", "question_id_test",
                 "MC_ans_test")


def read_prepro(vqa_dir: str) -> Tuple[Dict, Dict[str, np.ndarray]]:
    """The data_prepro.{json,h5} bundle as (JSON info, {dataset: array}),
    the h5 values unchanged (``datatype_train`` included when present)."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            f"reading {os.path.join(vqa_dir, 'data_prepro.h5')} needs h5py, "
            f"which this Python lacks; the in-memory bundle "
            f"(data/fixtures.py fixture_bundle) needs none") from e
    with open(os.path.join(vqa_dir, "data_prepro.json")) as f:
        info = json.load(f)
    with h5py.File(os.path.join(vqa_dir, "data_prepro.h5"), "r") as h5:
        arrays = {k: np.asarray(h5[k]) for k in PREPRO_ARRAYS}
        if "datatype_train" in h5:
            arrays["datatype_train"] = np.asarray(h5["datatype_train"])
    return info, arrays


def load_vqa_data(vqa_dir: str, batch_size: int, *, split: str = "val2014",
                  test_batch_size: Optional[int] = None,
                  valid_ratio: float = 0.0, seed: int = 123) -> VQAData:
    """Load the data_prepro.{json,h5} bundle (schema at
    vqa_prepro_loader.lua:1306-1330) and build train/test splits."""
    info, arrays = read_prepro(vqa_dir)
    return build_vqa_data(info, arrays, batch_size, split=split,
                          test_batch_size=test_batch_size,
                          valid_ratio=valid_ratio, seed=seed)


def build_vqa_data(info: Dict, arrays: Dict[str, np.ndarray],
                   batch_size: int, *, split: str = "val2014",
                   test_batch_size: Optional[int] = None,
                   valid_ratio: float = 0.0, seed: int = 123) -> VQAData:
    """Build train/test splits from the bundle's JSON info and h5 arrays
    (``read_prepro``'s pair, or the fixture's in-memory one).

    The split option selects which image lists back which side, mirroring
    vqa_prepro_loader.lua:1420-1470 (train2014/val2014 train on train2014;
    test2015/test-dev2015 train on train+val)."""
    ques_train = np.asarray(arrays["ques_train"], np.int32)
    len_train = np.asarray(arrays["ques_length_train"], np.int32)
    pos_train = np.asarray(arrays["img_pos_train"], np.int64)
    qid_train = np.asarray(arrays["question_id_train"], np.int64)
    answers = np.asarray(arrays["answers"], np.int32) - 1  # 0-based labels
    if "datatype_train" in arrays:
        dt_train = np.asarray(arrays["datatype_train"], np.int32)
    else:
        dt_train = np.ones_like(answers, np.int32)
    ques_test = np.asarray(arrays["ques_test"], np.int32)
    len_test = np.asarray(arrays["ques_length_test"], np.int32)
    pos_test = np.asarray(arrays["img_pos_test"], np.int64)
    qid_test = np.asarray(arrays["question_id_test"], np.int64)
    mc_ans = np.asarray(arrays["MC_ans_test"], np.int32) - 1  # -1 = absent

    # vocab: index 0 is ZEROPAD, h5 token values used unchanged (0-based contract)
    ix_to_word = info["ix_to_word"]
    ix_to_ans = info["ix_to_ans"]
    n_words = len(ix_to_word)
    vocab = ["ZEROPAD"] + [ix_to_word[str(i)] for i in range(1, n_words + 1)]
    vocab_map = {w: i for i, w in enumerate(vocab)}
    n_ans = len(ix_to_ans)
    answer_list = [ix_to_ans[str(i)] for i in range(1, n_ans + 1)]
    answer_map = {a: i for i, a in enumerate(answer_list)}

    seq_len = ques_train.shape[1]
    data = VQAData(vocab=vocab, vocab_map=vocab_map, answers=answer_list,
                   answer_map=answer_map, seq_len=seq_len)

    train_imgs = info["unique_img_train"]
    test_imgs = info["unique_img_test"]

    # img_pos is 1-BASED into the unique image lists (schema :1322); a
    # 0 would silently negative-wrap to the LAST image and pair every
    # question with the wrong features — guard like features.py does for
    # the analogous 1-based datatype contract
    for name, pos, imgs in (("img_pos_train", pos_train, train_imgs),
                            ("img_pos_test", pos_test, test_imgs)):
        if pos.size and not (1 <= pos.min() and pos.max() <= len(imgs)):
            raise ValueError(
                f"{name} must be 1-based into the unique image list "
                f"(len {len(imgs)}), got range "
                f"[{int(pos.min())}, {int(pos.max())}] — a 0-based "
                f"bundle would silently mis-pair every question's image")

    train_fields = dict(
        questions=ques_train, lengths=len_train,
        img_names=_img_names_for(pos_train, train_imgs),
        img_paths=[train_imgs[int(p) - 1] for p in pos_train],
        datatypes=dt_train, qids=qid_train, answers=answers,
    )

    if valid_ratio > 0.0:
        # re-split train into train/val (vqa_prepro_loader.lua:1346-1370)
        if valid_ratio > 1.0:
            raise ValueError(f"valid_ratio {valid_ratio} > 1")
        rng = np.random.default_rng(seed)
        n = answers.shape[0]
        perm = rng.permutation(n)
        val_sz = int(n * valid_ratio)
        val_idx, train_idx = perm[:val_sz], perm[val_sz:]

        def take(fields, idx):
            out = dict(fields)
            for k in ("questions", "lengths", "datatypes", "qids", "answers"):
                out[k] = fields[k][idx]
            for k in ("img_names", "img_paths"):
                out[k] = [fields[k][i] for i in idx]
            return out

        val_fields = take(train_fields, val_idx)
        train_fields = take(train_fields, train_idx)
        data.val_data = SplitData(f"{split}-val", batch_size=batch_size,
                                  seed=seed + 1, **val_fields)

    data.train_data = SplitData(f"{split}-train", batch_size=batch_size,
                                seed=seed, **train_fields)

    tb = test_batch_size or batch_size
    data.test_data = SplitData(
        split, batch_size=tb, seed=seed + 2,
        questions=ques_test, lengths=len_test,
        img_names=_img_names_for(pos_test, test_imgs),
        img_paths=[test_imgs[int(p) - 1] for p in pos_test],
        # the reference also pins the TEST split's datatype to 1
        # (vqa_prepro_loader.lua:1378: question_id:clone():fill(1)) — its
        # drivers pass a separate featpath table per loader instance, so
        # per-datatype routing only ever applies to the train split
        datatypes=np.ones_like(qid_test, np.int32), qids=qid_test,
        mc_answers=mc_ans,
    )
    return data


def load_gt_annotations(path: str) -> Dict[int, str]:
    """Fast-validation ground-truth map qid -> answer string
    (the 'comprehend' bundle, reference :192-196, :914-925)."""
    with open(path) as f:
        raw = json.load(f)
    return {int(k): v for k, v in raw.items()}
