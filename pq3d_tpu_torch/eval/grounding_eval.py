"""Visual grounding evaluators: ScanRefer, ReferIt3D (Nr3D/Sr3D),
Multi3DRefer; copy of ``pq3d_tpu/eval/grounding_eval.py``.

``update(out, batch)`` takes numpy views of the model's outputs and the
batch; ``record()`` aggregates (value, count) pairs (``eval/base.py``).
Box IoU is the port's ``utils/box_utils.aabb_iou`` (box volumes from the
sizes; the JAX evaluator's own copy takes them from the corners, equal up
to float rounding for boxes of non-negative size).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
from scipy.optimize import linear_sum_assignment

from pq3d_tpu_torch.eval.base import BaseEvaluator
from pq3d_tpu_torch.utils.box_utils import aabb_iou


class ScanReferEval(BaseEvaluator):
    """og_acc + acc@25/50 with unique/multiple splits
    (ref scanrefer_eval.py:14-70)."""

    def __init__(self, save_dir: Optional[str] = None):
        super().__init__(save_dir)
        self.target_metric = "og_acc"

    def update(self, out: Dict[str, Any], batch: Dict[str, Any]) -> None:
        logits = np.asarray(out["og3d_logits"])
        pred = logits.argmax(-1)
        n = len(pred)
        tgt = np.asarray(batch["tgt_object_id"]).reshape(n, -1)
        is_mult = np.asarray(batch.get("is_multiple",
                                       np.zeros(n, bool))).astype(bool)
        rows = np.arange(n)
        if tgt.shape[1] == logits.shape[1]:      # BCE one-hot label
            correct = tgt[rows, pred] > 0
        else:
            correct = tgt[:, 0] == pred
        self.eval_dict["og_acc"].append((correct.mean(), n))
        for iou in (25, 50):
            key = f"tgt_object_id_iou{iou}"
            if key not in batch:
                continue
            lab = np.asarray(batch[key])
            ok = lab[rows, pred] > 0
            self.eval_dict[f"og_acc_iou{iou}"].append((ok.mean(), n))
            for name, m in (("unique", ~is_mult), ("multiple", is_mult)):
                if m.sum():
                    self.eval_dict[f"og_acc_iou{iou}_{name}"].append(
                        ((ok & m).sum() / m.sum(), int(m.sum())))
        self.total_count += n


class ReferIt3DEval(BaseEvaluator):
    """og_acc + easy/hard, view-dep/indep splits
    (ref referit3d_eval.py:14-76)."""

    def __init__(self, save_dir: Optional[str] = None):
        super().__init__(save_dir)
        self.target_metric = "og_acc"

    def update(self, out: Dict[str, Any], batch: Dict[str, Any]) -> None:
        logits = np.asarray(out["og3d_logits"])
        pred = logits.argmax(-1)
        n = len(pred)
        tgt = np.asarray(batch["tgt_object_id"]).reshape(n, -1)
        rows = np.arange(n)
        if tgt.shape[1] == logits.shape[1]:
            correct = tgt[rows, pred] > 0
        else:
            correct = tgt[:, 0] == pred
        self.eval_dict["og_acc"].append((correct.mean(), n))
        splits = {
            "easy": ~np.asarray(batch.get("is_hard", np.zeros(n, bool))).astype(bool),
            "hard": np.asarray(batch.get("is_hard", np.zeros(n, bool))).astype(bool),
            "view_dep": np.asarray(batch.get("is_view_dependent",
                                             np.zeros(n, bool))).astype(bool),
        }
        splits["view_indep"] = ~splits["view_dep"]
        for name, m in splits.items():
            if m.sum():
                self.eval_dict[f"og_acc_{name}"].append(
                    ((correct & m).sum() / m.sum(), int(m.sum())))
        self.total_count += n


class Multi3DReferEval(BaseEvaluator):
    """F1@IoU25/50 via per-query Hungarian box matching + 5 eval subgroups
    (ref multi3drefer_eval.py:22-96)."""

    SUBGROUPS = ("zt_w_d", "zt_wo_d", "st_w_d", "st_wo_d", "mt")

    def __init__(self, save_dir: Optional[str] = None):
        super().__init__(save_dir)
        self.target_metric = "iou50_overall"

    @staticmethod
    def evaluate_one_query(pred_boxes: np.ndarray, gt_boxes: np.ndarray):
        np_, ng = len(pred_boxes), len(gt_boxes)
        if np_ == 0 and ng == 0:
            return 1.0, 1.0
        if np_ == 0 or ng == 0:
            return 0.0, 0.0
        side = max(np_, ng)
        iou = np.zeros((side, side), np.float32)
        for i in range(np_):
            for j in range(ng):
                iou[i, j] = aabb_iou(pred_boxes[i], gt_boxes[j])
        rows, cols = linear_sum_assignment(-iou)
        matched = iou[rows, cols][:np_]
        f25 = 2 * float((matched >= 0.25).sum()) / (np_ + ng)
        f50 = 2 * float((matched >= 0.5).sum()) / (np_ + ng)
        return f25, f50

    def update(self, out: Dict[str, Any], batch: Dict[str, Any]) -> None:
        probs = 1 / (1 + np.exp(-np.asarray(out["og3d_logits"])))
        obj_boxes = np.asarray(batch["obj_boxes"])         # (B, Q, 6)
        gts: List[np.ndarray] = batch["tgt_obj_boxes"]     # list of (M_i, 6)
        eval_types: List[str] = batch.get(
            "eval_type", ["mt"] * len(probs))
        for i in range(len(probs)):
            sel = probs[i] > 0.5
            if "query_pad_masks" in batch:
                sel &= np.asarray(batch["query_pad_masks"][i]).astype(bool)
            f25, f50 = self.evaluate_one_query(obj_boxes[i][sel],
                                               np.asarray(gts[i]))
            self.eval_dict["iou25_overall"].append((f25, 1))
            self.eval_dict["iou50_overall"].append((f50, 1))
            sub = eval_types[i]
            if sub in self.SUBGROUPS:
                self.eval_dict[f"iou25_{sub}"].append((f25, 1))
                self.eval_dict[f"iou50_{sub}"].append((f50, 1))
            self.total_count += 1
