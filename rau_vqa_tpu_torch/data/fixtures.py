"""Deterministic tiny-dataset fixture generator.

The reference has no test assets; SURVEY.md §4 calls for "a deterministic
fake-data fixture replacing the h5 (tiny vocab, N questions)".  This writes a
complete miniature of the real bundle — data_prepro.json, data_prepro.h5,
per-image .t7 feature files (Torch7 format, same layout the reference
downloads), and a comprehend-style ground-truth map — so every layer from the
h5 parser to the .t7 reader to the submission writer is exercised end-to-end.

The generated data is *learnable by construction*: the answer of each
question is a deterministic function of its first token and its image's mean
feature, so a few epochs of training must push accuracy well above chance.

The port's own copy of ``rau_vqa_tpu/data/fixtures.py``: ``generate_fixture``
writes the same files from the same seed, the h5 through the port's own
writer (``data/hdf5.py``).  ``fixture_bundle`` makes the same bundle in
memory (the JSON info and the h5 arrays, the features written as ``.t7``
files), for ``data.loader.build_vqa_data``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, NamedTuple

import numpy as np

from rau_vqa_tpu_torch.data import t7
from rau_vqa_tpu_torch.data.hdf5 import write_h5


@dataclass(frozen=True)
class FixtureSpec:
    n_train: int = 160
    n_test: int = 32
    n_images: int = 40
    n_words: int = 30          # excludes ZEROPAD; includes 'UNK'
    n_answers: int = 5
    seq_len: int = 9
    feat_dim: int = 16
    feat_w: int = 3
    feat_h: int = 3
    n_mc: int = 4              # multiple-choice candidates per question
    seed: int = 7
    # image classes (None = n_answers, the original behavior).  At paper
    # dims a 200-answer task with 200 image classes has a 40k-combo rule
    # table no reasonably-sized fixture covers — test would demand
    # compositional generalization of modular arithmetic rather than
    # measure trainability.  A small class count keeps every
    # (first_token, img_class) combo represented in train while the
    # answer space stays at full width (scripts/paper_dims_run.py).
    n_img_classes: int | None = None
    # feature-space class encoding: "channel" (one-channel +2 bump, the
    # original) or "dense" (a fixed random +/-1 pattern over ALL
    # channels).  The paper-dims runs showed the single-channel bump is a
    # hard read for the stacked-tanh head at 512 dims (held-out capped
    # ~33% while train ground past 70% on image/noise memorization);
    # dense codes make the class a robust high-SNR linear readout so the
    # held-out criterion measures optimizer/numerics, not channel-needle
    # extraction.
    class_code: str = "channel"
    feat_noise: float = 0.15   # within-class feature noise (the per-image
    #                            fingerprint; lower = less memorizable)

    @property
    def img_classes(self) -> int:
        return self.n_img_classes or self.n_answers


class FixtureBundle(NamedTuple):
    """The fixture's bundle in memory: the data_prepro.json ``info``, the
    data_prepro.h5 ``arrays`` (1-based values, as the file holds them), the
    test split's ground truth (qid string -> answer) and the directory of
    the ``.t7`` features."""

    info: Dict
    arrays: Dict[str, np.ndarray]
    gt: Dict[str, str]
    feat_dir: str


def generate_fixture(root: str, spec: FixtureSpec = FixtureSpec(), *,
                     images: bool = False, image_size: int = 64,
                     uniform_img_assign: bool = False,
                     image_mode: str = "gray") -> str:
    """Write the fixture bundle under ``root`` (data_prepro.{json,h5}, the
    .t7 features, gt_annotations.json; the h5 by ``data/hdf5.py``); returns
    the vqa_dir.
    Arguments as ``fixture_bundle``'s."""
    bundle = fixture_bundle(root, spec, images=images, image_size=image_size,
                            uniform_img_assign=uniform_img_assign,
                            image_mode=image_mode)
    vqa_dir = os.path.join(root, "vqa_prepro")
    os.makedirs(vqa_dir, exist_ok=True)
    write_h5(os.path.join(vqa_dir, "data_prepro.h5"), bundle.arrays)
    with open(os.path.join(vqa_dir, "data_prepro.json"), "w") as f:
        json.dump(bundle.info, f)
    # comprehend-style fast-val ground truth for the test split
    with open(os.path.join(vqa_dir, "gt_annotations.json"), "w") as f:
        json.dump(bundle.gt, f)
    return vqa_dir


def fixture_bundle(root: str, spec: FixtureSpec = FixtureSpec(), *,
                   images: bool = False, image_size: int = 64,
                   uniform_img_assign: bool = False,
                   image_mode: str = "gray") -> FixtureBundle:
    """Make the fixture: its .t7 features under ``root/feat`` and the rest
    in memory.

    ``images=True`` additionally writes tiny deterministic JPEGs under
    ``root/images/<split>/COCO_*.jpg`` (the paths the json's unique_img
    lists carry) so the from-pixels path — ImageDirSource → on-device
    backbone → RAU — can be exercised end-to-end offline.

    ``uniform_img_assign=True`` assigns images round-robin so every image
    carries exactly n/n_images questions (VQA v1's uniform ~3/image) —
    what the 'imggroup' batch order / grouped fine-tuning require."""
    rng = np.random.default_rng(spec.seed)
    feat_dir = os.path.join(root, "feat")
    os.makedirs(feat_dir, exist_ok=True)

    words = [f"w{i:02d}" for i in range(1, spec.n_words)] + ["UNK"]
    answer_words = [f"ans{i}" for i in range(spec.n_answers)]
    train_imgs = [f"train2014/COCO_train2014_{i:012d}.jpg"
                  for i in range(spec.n_images)]
    test_imgs = [f"val2014/COCO_val2014_{i:012d}.jpg"
                 for i in range(spec.n_images)]

    # per-image features; image class = i % img_classes baked into the mean
    n_cls = spec.img_classes
    if spec.class_code == "channel" and n_cls > spec.feat_dim:
        # only the channel-bump encoding indexes a channel per class;
        # dense codes span all channels and have no such limit
        raise ValueError(f"img_classes {n_cls} needs feat_dim >= {n_cls} "
                         f"(class is encoded as a channel bump)")

    if spec.class_code == "dense":
        # fixed per-class +/-1 codes from a sign-flipped Hadamard-ish
        # draw; amplitude 1.0 per channel vs feat_noise per-image noise
        code_rng = np.random.default_rng(spec.seed + 1)
        class_dirs = code_rng.choice(
            [-1.0, 1.0], size=(n_cls, spec.feat_dim)).astype(np.float32)
    elif spec.class_code != "channel":
        raise ValueError(f"unknown class_code {spec.class_code!r}")

    def make_feat(i: int) -> np.ndarray:
        base = rng.normal(0, spec.feat_noise,
                          (spec.feat_dim, spec.feat_w, spec.feat_h))
        if spec.class_code == "dense":
            base += class_dirs[i % n_cls][:, None, None]
        else:
            base[i % n_cls] += 2.0
        return base.astype(np.float32)

    from rau_vqa_tpu_torch.data.features import coco_feat_name

    img_class = {}
    for imgs in (train_imgs, test_imgs):
        for i, p in enumerate(imgs):
            # the loader looks features up by coco_feat_name — derive the
            # fixture's filenames with the same helper so they can't drift
            t7.save_t7(os.path.join(feat_dir, coco_feat_name(p)),
                       make_feat(i))
            img_class[p] = i % n_cls

    def make_split(n: int, imgs: List[str], qid_base: int):
        tokens = np.zeros((n, spec.seq_len), np.int32)
        lengths = np.zeros((n,), np.int32)
        img_pos = np.zeros((n,), np.int64)
        qids = np.arange(qid_base, qid_base + n, dtype=np.int64)
        labels = np.zeros((n,), np.int32)
        for k in range(n):
            L = int(rng.integers(2, spec.seq_len + 1))
            lengths[k] = L
            # question = one of n_answers templates: first token in
            # [1, n_answers], tail a deterministic function of it.  Random
            # tails would hand the model unique per-example memorization
            # keys and kill generalization; template questions make question
            # memorization equivalent to learning the rule.
            first = int(rng.integers(1, spec.n_answers + 1))
            tokens[k, 0] = first
            for i in range(1, L):
                tokens[k, i] = (first * 7 + i * 3) % (spec.n_words - 1) + 1
            img = (k % len(imgs) if uniform_img_assign
                   else int(rng.integers(0, len(imgs))))
            img_pos[k] = img + 1  # 1-based (h5 contract)
            # learnable rule: answer = (first token + image class) mod n_answers
            # — the question alone is uninformative, forcing image attention
            labels[k] = (first + img_class[imgs[img]]) % spec.n_answers
        return tokens, lengths, img_pos, qids, labels

    tr = make_split(spec.n_train, train_imgs, 1000)
    te = make_split(spec.n_test, test_imgs, 9000)

    if spec.n_mc - 1 > spec.n_answers:
        raise ValueError(
            f"FixtureSpec n_mc={spec.n_mc} needs {spec.n_mc - 1} distinct "
            f"candidate answers but only n_answers={spec.n_answers} exist")
    mc = np.zeros((spec.n_test, spec.n_mc), np.int32)
    for k in range(spec.n_test):
        cands = rng.permutation(spec.n_answers)[:spec.n_mc - 1]
        gt = te[4][k]
        if gt not in cands:
            cands[0] = gt
        mc[k, :spec.n_mc - 1] = cands + 1        # 1-based; 0 = absent
        # leave one slot absent to exercise the 0-padding path

    # the h5 datasets, in the order the JAX package writes them
    arrays = {
        "ques_train": tr[0],
        "ques_length_train": tr[1],
        "img_pos_train": tr[2],
        "question_id_train": tr[3],
        "answers": tr[4] + 1,                    # 1-based labels (h5 contract)
        "ques_test": te[0],
        "ques_length_test": te[1],
        "img_pos_test": te[2],
        "question_id_test": te[3],
        "MC_ans_test": mc,
    }
    info = {
        "ix_to_word": {str(i + 1): w for i, w in enumerate(words)},
        "ix_to_ans": {str(i + 1): a for i, a in enumerate(answer_words)},
        "unique_img_train": train_imgs,
        "unique_img_test": test_imgs,
    }
    gt = {str(int(q)): answer_words[int(a)] for q, a in zip(te[3], te[4])}

    if images:
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError("fixture images (images=True) need PIL, which "
                              "this Python lacks") from e

        if image_mode == "gray":
            # gray-level class encoding range check: class c occupies
            # [30+40c, 30+40c+39]; uint8 wraps silently above 255, aliasing
            # high classes onto class 0's band and capping attainable
            # accuracy with no error (n_answers <= 5 fits exactly)
            hi = 30 + 40 * (spec.img_classes - 1) + 39
            if hi > 255:
                raise ValueError(
                    f"fixture images encode the class as a gray level: "
                    f"img_classes={spec.img_classes} needs pixel values "
                    f"up to {hi} > 255 — use n_answers <= 5 with "
                    f"images=True")
        elif image_mode == "texture":
            # stripe textures: orientation x period, FIRST-ORDER
            # STATISTICS EQUALIZED across classes (identical pixel mean
            # and variance; only the spatial arrangement differs).  A
            # frozen random backbone's pooled features expose gray-level
            # signal linearly — this mode exists for the fine-tuning
            # accuracy A/B (VERDICT r4 #2), where the class must require
            # learning spatial filters, not reading the image mean.
            if spec.img_classes > 8:
                raise ValueError("texture mode defines 8 classes "
                                 "(4 orientations x 2 periods)")
        elif image_mode == "mixed":
            # texture + a WEAK overlapping gray cue.  Pure texture gives
            # the pixel gradient no foothold through a deep random conv
            # stack (measured: gB collapses to ~0 within 6 epochs and
            # both A/B arms sit at chance) — the weak mean cue keeps the
            # image pathway live (frozen arm capped by the deliberate
            # class overlap) while the stripes carry the clean signal
            # only trained filters can exploit.
            if spec.img_classes > 8:
                raise ValueError("mixed mode defines 8 classes")
        else:
            raise ValueError(f"unknown image_mode {image_mode!r}")
        img_root = os.path.join(root, "images")
        yy, xx = np.meshgrid(np.arange(image_size), np.arange(image_size),
                             indexing="ij")
        # (orientation coord, stripe period) per texture class
        tex_defs = [(yy, 8), (xx, 8), (yy + xx, 8), (yy - xx, 8),
                    (yy, 16), (xx, 16), (yy + xx, 16), (yy - xx, 16)]
        for rel in train_imgs + test_imgs:
            path = os.path.join(img_root, rel)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            # the image CONTENT must carry img_class (the label rule is
            # answer = (first token + img_class) mod n_answers) or the
            # from-pixels paths can only memorize train images and score
            # chance on test
            if image_mode == "gray":
                # separated gray level (noise width 40 < class spacing 40
                # — overlap-free, survives JPEG q92 and any resize), the
                # pixel analogue of the t7 fixture's per-class mean bump
                base = 30 + 40 * img_class[rel]
                pix = base + rng.integers(0, 40,
                                          (image_size, image_size, 3))
            elif image_mode == "texture":
                coord, period = tex_defs[img_class[rel]]
                stripes = ((coord // (period // 2)) % 2)   # exact 50/50
                pix = (80 + 96 * stripes)[:, :, None] \
                    + rng.integers(-16, 17, (image_size, image_size, 3))
            else:  # mixed
                coord, period = tex_defs[img_class[rel]]
                stripes = ((coord // (period // 2)) % 2)
                # weak mean cue: class spacing 8 << noise band 50 —
                # heavily overlapping, the frozen readout's ceiling
                gray = 96 + 8 * img_class[rel]
                pix = (gray + 64 * stripes)[:, :, None] \
                    + rng.integers(-25, 26, (image_size, image_size, 3))
            Image.fromarray(np.clip(pix, 0, 255).astype(np.uint8)
                            ).save(path, quality=92)

    return FixtureBundle(info=info, arrays=arrays, gt=gt, feat_dir=feat_dir)
