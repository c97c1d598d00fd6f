"""COCO naming helpers + VQA question-type map (utils/qa_utils.lua).

The port's own copy of ``rau_vqa_tpu/data/qa_utils.py``.
"""

from __future__ import annotations

# question types by answer vocabulary (qa_utils.lua:3-6)
QUESTION_TYPES = {
    1: "yes/no",
    2: "number",
    3: "other",
}


def cocofile_name(split: str, image_id: int, ext: str) -> str:
    """qa_utils.lua:8-10 — 'COCO_<split>_<012d>.<ext>'."""
    return f"COCO_{split}_{image_id:012d}.{ext}"


def cocoimg_name(split: str, image_id: int) -> str:
    """qa_utils.lua:11-13."""
    return cocofile_name(split, image_id, "jpg")


def cocofeat_name(split: str, image_id: int) -> str:
    """qa_utils.lua:14-16."""
    return cocofile_name(split, image_id, "t7")
