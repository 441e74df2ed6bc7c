"""Answer vocabulary for classifier-style QA labels; copy of
``AnswerVocab`` from ``pq3d_tpu/data/label_utils.py`` (the annotation-file
constructors are not ported)."""
from __future__ import annotations

from collections import Counter
from typing import List

import numpy as np


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
