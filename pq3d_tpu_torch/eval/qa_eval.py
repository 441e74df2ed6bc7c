"""3D question answering evaluators: ScanQA / SQA3D, classifier and
generative; copy of ``pq3d_tpu/eval/qa_eval.py``.  The classifier ones
(``ScanQAEval``, ``SQA3DEval``) read ``answer_scores`` of the ``qa`` head,
which the port does not build yet.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from pq3d_tpu_torch.eval.base import BaseEvaluator
from pq3d_tpu_torch.eval.text_utils import answer_match, clean_answer

SQA_TYPES = ["what", "is", "how", "can", "which", "others"]


class ScanQAEval(BaseEvaluator):
    """Classifier-head answer acc@1 / acc@10 (ref scanqa_eval.py:28-64)."""

    def __init__(self, save_dir: Optional[str] = None):
        super().__init__(save_dir)
        self.target_metric = "ans1_acc"

    def update(self, out: Dict[str, Any], batch: Dict[str, Any]) -> None:
        scores = np.asarray(out["answer_scores"])
        label = np.asarray(batch["answer_label"])  # multi-hot (B, V)
        n = len(scores)
        rows = np.arange(n)
        top1 = scores.argmax(-1)
        top10 = np.argsort(-scores, axis=-1)[:, :10]
        c1 = label[rows, top1] == 1
        c10 = (label[rows[:, None], top10] == 1).any(-1)
        self.eval_dict["ans1_acc"].append((c1.mean(), n))
        self.eval_dict["ans10_acc"].append((c10.mean(), n))
        self.total_count += n


class ScanQAGenEval(BaseEvaluator):
    """Generated answer exact-membership acc (ref scanqa_eval.py:72-98)."""

    def __init__(self, save_dir: Optional[str] = None):
        super().__init__(save_dir)
        self.target_metric = "ans1_acc"

    def update(self, out: Dict[str, Any], batch: Dict[str, Any]) -> None:
        preds: List[str] = out["answer_pred"]
        gts: List[List[str]] = batch["answers"]
        n = len(preds)
        correct = sum(1 for p, g in zip(preds, gts) if p in g)
        self.eval_dict["ans1_acc"].append((correct / max(n, 1), n))
        self.total_count += n


class SQA3DEval(ScanQAEval):
    """acc@1 + per-question-type breakdown (ref sqa3d_eval.py:28-72)."""

    def update(self, out: Dict[str, Any], batch: Dict[str, Any]) -> None:
        super().update(out, batch)
        scores = np.asarray(out["answer_scores"])
        label = np.asarray(batch["answer_label"])
        types = np.asarray(batch["sqa_type"])
        top1 = scores.argmax(-1)
        c1 = label[np.arange(len(scores)), top1] == 1
        for t in np.unique(types):
            m = types == t
            self.eval_dict[SQA_TYPES[int(t)]].append(
                ((c1 & m).sum() / m.sum(), int(m.sum())))


class SQA3DGenEval(BaseEvaluator):
    """Generated answers with clean_answer normalization + substring match
    (ref sqa3d_eval.py:86-122)."""

    def __init__(self, save_dir: Optional[str] = None):
        super().__init__(save_dir)
        self.target_metric = "ans1_acc"

    def update(self, out: Dict[str, Any], batch: Dict[str, Any]) -> None:
        preds = [clean_answer(a) for a in out["answer_pred"]]
        gts = [[clean_answer(x) for x in a] for a in batch["answers"]]
        n = len(preds)
        c1 = np.array([answer_match(p, g) for p, g in zip(preds, gts)])
        self.eval_dict["ans1_acc"].append((c1.mean(), n))
        types = np.asarray(batch.get("sqa_type", np.zeros(n, int)))
        for t in np.unique(types):
            m = types == t
            self.eval_dict[SQA_TYPES[int(t)]].append(
                ((c1 & m).sum() / m.sum(), int(m.sum())))
        self.total_count += n
