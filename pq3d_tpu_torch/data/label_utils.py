"""Label conversion and answer vocabularies; copy of
``pq3d_tpu/data/label_utils.py``.

``LabelConverter`` maps ScanNet's raw category names and ids to ScanNet200
class ids through the combined label tsv, and a tsv row (its sequential
raw id) to the 18-class benchmark id by its nyu40 name; the JAX class's
other tables, which nothing reads, are left out.  ``AnswerVocab``
orders answers by frequency for classifier-style QA labels; its
constructors read ScanQA's train answers and SQA3D's answer dictionary.
"""
from __future__ import annotations

import csv
import json
import os
from collections import Counter
from typing import Dict, List, Optional

import numpy as np

from pq3d_tpu_torch.data.scannet200_constants import (CLASS_LABELS_200,
                                                      RAW_ID_TO_200_ID)

_SCANNET18 = {
    "cabinet": 0, "bed": 1, "chair": 2, "sofa": 3, "table": 4, "door": 5,
    "window": 6, "bookshelf": 7, "picture": 8, "counter": 9, "desk": 10,
    "curtain": 11, "refrigerator": 12, "shower curtain": 13, "toilet": 14,
    "sink": 15, "bathtub": 16, "others": 17}


class LabelConverter:
    """ScanNet label-space conversions from the combined tsv.  Without the
    tsv on disk, a raw name that is a ScanNet200 class name maps to that
    class and every other name to ``ignore``."""

    def __init__(self, tsv_path: Optional[str] = None):
        self.raw_name_to_scannet_raw_id: Dict[str, int] = {}
        # sequential row id -> 18-class benchmark id via the nyu40 name
        self.id_to_scannetid: Dict[int, int] = {}
        self.has_tsv = bool(tsv_path and os.path.exists(tsv_path))
        if self.has_tsv:
            with open(tsv_path, encoding="utf-8") as f:
                rows = list(csv.reader(f, delimiter="\t", quotechar='"'))
            for rid, row in enumerate(rows[1:]):
                self.raw_name_to_scannet_raw_id[row[1]] = int(row[0])
                self.id_to_scannetid[rid] = _SCANNET18.get(
                    row[7], _SCANNET18["others"])
        self.scannet_raw_id_to_scannet200_id = dict(RAW_ID_TO_200_ID)

    def raw_to_scannet200(self, raw_id: int, ignore: int = -100) -> int:
        return self.scannet_raw_id_to_scannet200_id.get(int(raw_id), ignore)

    def name_to_scannet200(self, name: str, ignore: int = -100) -> int:
        """Raw category name -> ScanNet200 class id: through the tsv's
        ScanNet raw id when the tsv is there, else by exact class name."""
        if self.has_tsv:
            rid = self.raw_name_to_scannet_raw_id.get(name)
            if rid is None:
                return ignore
            return self.raw_to_scannet200(rid, ignore)
        try:
            return CLASS_LABELS_200.index(name)
        except ValueError:
            return ignore


class AnswerVocab:
    """Answers sorted by frequency, with stable itos/stoi."""

    def __init__(self, answers: List[str]):
        counts = Counter(answers)
        self.vocab = sorted(counts, key=lambda a: (-counts[a], a))
        self._stoi = {a: i for i, a in enumerate(self.vocab)}

    def __len__(self):
        return len(self.vocab)

    def stoi(self, answer: str) -> int:
        return self._stoi.get(answer, -1)

    def itos(self, idx: int) -> str:
        return self.vocab[idx] if 0 <= idx < len(self.vocab) else ""

    def multihot(self, answers: List[str]) -> np.ndarray:
        v = np.zeros(len(self.vocab), np.float32)
        for a in answers:
            i = self.stoi(a)
            if i >= 0:
                v[i] = 1.0
        return v

    @classmethod
    def from_scanqa_train(cls, base_dir: str) -> "AnswerVocab":
        """Every answer of ScanQA's train annotations."""
        path = os.path.join(base_dir, "ScanNet", "annotations", "qa",
                            "ScanQA_v1.0_train.json")
        with open(path) as f:
            data = json.load(f)
        return cls([a for item in data for a in item.get("answers", [])])

    @classmethod
    def from_sqa3d_dict(cls, base_dir: str) -> "AnswerVocab":
        """The keys of SQA3D's answer dictionary."""
        path = os.path.join(base_dir, "ScanNet", "annotations", "sqa_task",
                            "answer_dict.json")
        with open(path) as f:
            data = json.load(f)[0]
        return cls(list(data.keys()))
