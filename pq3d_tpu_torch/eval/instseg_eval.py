"""Instance-segmentation ranking and ScanNet-style mask AP (numpy);
copies of ``rank_instances``, ``InstSegEval``, ``mask_iou`` and
``average_precision`` from ``pq3d_tpu/eval/instseg_eval.py``.

``rank_instances`` serves answers (``serve.py``); ``InstSegEval`` scores
them in training: masks at segment level with segment-size weights, or at
full resolution when the batch carries the reconstruction maps, and AP by
the official ScanNet protocol (``eval/scannet_protocol.py``) or the greedy
confidence-ordered one.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

OVERLAPS = np.append(np.arange(0.5, 0.95, 0.05), 0.25)  # official: 0.5..0.9 + 0.25


def mask_iou(pred: np.ndarray, gt: np.ndarray,
             weights: Optional[np.ndarray] = None) -> float:
    if weights is None:
        inter = np.logical_and(pred, gt).sum()
        union = np.logical_or(pred, gt).sum()
    else:
        inter = (np.logical_and(pred, gt) * weights).sum()
        union = (np.logical_or(pred, gt) * weights).sum()
    return float(inter) / max(float(union), 1e-9)


def average_precision(scores: np.ndarray, is_tp: np.ndarray,
                      n_gt: int) -> float:
    """Confidence-ranked AP with monotone precision envelope."""
    if n_gt == 0:
        return float("nan")
    if len(scores) == 0:
        return 0.0
    order = np.argsort(-scores)
    tp = np.cumsum(is_tp[order])
    fp = np.cumsum(~is_tp[order])
    recall = tp / n_gt
    precision = tp / np.maximum(tp + fp, 1)
    # envelope
    precision = np.maximum.accumulate(precision[::-1])[::-1]
    r = np.concatenate([[0], recall, [recall[-1] if len(recall) else 0]])
    p = np.concatenate([[precision[0] if len(precision) else 0], precision, [0]])
    return float(np.sum((r[1:] - r[:-1]) * p[1:]))




def _softmax(x):
    x = x - x.max(-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(-1, keepdims=True)


def _sigmoid(x):
    return 1 / (1 + np.exp(-np.clip(x, -30, 30)))


def rank_instances(cls_logits: np.ndarray, mask_logits: np.ndarray,
                   seg_valid: np.ndarray, num_classes: int,
                   topk: int = 100, score_threshold: float = 0.0,
                   seg_to_full: Optional[np.ndarray] = None):
    """One scene's model outputs -> ranked instance predictions.

    Per-query topk (class, score) ranking with class-prob x mean-mask-prob
    scoring; with ``seg_to_full`` segment masks are reconstructed to full
    point resolution.  Returns a list of {"class", "score", "mask"} dicts.
    """
    probs = _softmax(cls_logits)[:, :num_classes]   # drop no-object column
    mask_prob = _sigmoid(mask_logits) * seg_valid[:, None]
    masks_bool = mask_prob > 0.5                    # (S, Q)
    flat = probs.reshape(-1)
    k = min(topk, len(flat))
    top_idx = np.argpartition(-flat, k - 1)[:k]
    preds = []
    for idx in top_idx:
        qi, ci = divmod(int(idx), num_classes)
        m = masks_bool[:, qi]
        mask_score = (mask_prob[m, qi].mean() if m.any() else 0.0)
        score = float(flat[idx]) * float(mask_score)
        if score <= score_threshold or not m.any():
            continue
        if seg_to_full is not None:
            m = m[np.minimum(seg_to_full, len(m) - 1)]
        preds.append({"class": ci, "score": score, "mask": m})
    return preds


class InstSegEval:
    """Accumulates per-scene predictions; record() computes AP/AP50/AP25
    (a numpy copy of the JAX package's evaluator without its DBSCAN
    split, which needs scikit-learn)."""

    def __init__(self, topk_per_scene: int = 100, num_classes: int = 200,
                 score_threshold: float = 0.0, save_dir: Optional[str] = None,
                 full_resolution: bool = False, use_dbscan: bool = False,
                 official_protocol: bool = True,
                 min_region_size: float = 100.0):
        if use_dbscan:
            raise NotImplementedError("the DBSCAN split is not ported")
        self.save_dir = save_dir
        self.topk = topk_per_scene
        self.num_classes = num_classes
        self.score_threshold = score_threshold
        self.full_resolution = full_resolution
        self.official_protocol = official_protocol
        self.min_region_size = min_region_size
        self.target_metric = "all_ap"
        self._preds: List[Dict] = []
        self._gts: List[Dict] = []
        self._have_sizes = False   # vert counts known -> min_region applies

    def reset(self):
        self._preds, self._gts = [], []
        self._have_sizes = False

    def update(self, out: Dict[str, Any], batch: Dict[str, Any]) -> None:
        cls_logits = np.asarray(out["predictions_class"][-1])   # (B,Q,C+1)
        mask_logits = np.asarray(out["predictions_mask"][-1])   # (B,S,Q)
        seg_valid = np.asarray(batch["seg_pad_masks"])
        gt_masks = np.asarray(batch["segment_masks"]).astype(bool)
        gt_labels = np.asarray(batch["instance_labels"])
        gt_valid = np.asarray(batch["instance_valid"]).astype(bool)
        if "segment_sizes" in batch:
            seg_sizes = np.asarray(batch["segment_sizes"])
            self._have_sizes = True
        else:
            seg_sizes = np.ones(seg_valid.shape)

        meta = batch.get("_meta", {}) if isinstance(batch.get("_meta"), dict) \
            else {}
        seg_to_full = meta.get("segment_to_full")
        full_gt = meta.get("full_instance_masks")
        points = meta.get("points")

        b = cls_logits.shape[0]
        for i in range(b):
            s2f = seg_to_full[i] if (self.full_resolution and seg_to_full
                                     and seg_to_full[i] is not None) else None
            fgt = full_gt[i] if (self.full_resolution and full_gt
                                 and full_gt[i] is not None) else None
            pts = points[i] if (points and s2f is not None) else None
            self._update_scene(cls_logits[i], mask_logits[i], seg_valid[i],
                               gt_masks[i], gt_labels[i], gt_valid[i],
                               seg_sizes[i], seg_to_full=s2f,
                               full_gt_masks=fgt, points=pts)

    def _update_scene(self, cls_logits, mask_logits, seg_valid, gt_masks,
                      gt_labels, gt_valid, seg_sizes, seg_to_full=None,
                      full_gt_masks=None, points=None):
        """Per-query topk (class, score) ranking (ref get_mask_and_scores,
        instseg_eval.py:283-304); optional full-resolution reconstruction
        (ref get_full_res_mask, instseg_eval.py:272-281)."""
        preds = rank_instances(cls_logits, mask_logits, seg_valid,
                               num_classes=self.num_classes, topk=self.topk,
                               score_threshold=self.score_threshold,
                               seg_to_full=seg_to_full)
        if points is not None and seg_to_full is not None:
            # axis-aligned boxes from predicted point masks (for box AP,
            # ref evaluator/instseg_eval.py box path -> common/eval_det.py)
            for p in preds:
                sel = points[p["mask"]]
                p["box"] = (np.concatenate([sel.min(0), sel.max(0)])
                            if len(sel) else None)
        self._preds.append(preds)
        if seg_to_full is not None and full_gt_masks is not None:
            gm = full_gt_masks[gt_valid[:len(full_gt_masks)]] \
                if len(full_gt_masks) else full_gt_masks
            gt = {"masks": gm,
                  "labels": gt_labels[gt_valid][:len(full_gt_masks)],
                  "weights": None}
            if points is not None and len(gm):
                gt["boxes"] = [np.concatenate([points[m].min(0),
                                               points[m].max(0)])
                               if m.any() else None for m in gm]
            self._gts.append(gt)
        else:
            self._gts.append({
                "masks": gt_masks[gt_valid] & seg_valid[None, :],
                "labels": gt_labels[gt_valid],
                "weights": seg_sizes,
            })

    def _ap_table(self, classes_present, overlaps, iou_fn):
        """Greedy per-class AP at each overlap (ref common/eval_instseg.py
        evaluate_matches + common/eval_det.py eval_det_cls)."""
        table = np.full((len(overlaps), max(len(classes_present), 1)),
                        np.nan)
        for ci, cls in enumerate(classes_present):
            scores, ious, n_gt = [], [], 0
            for scene_id, (preds, gt) in enumerate(zip(self._preds,
                                                       self._gts)):
                gt_idx = np.nonzero(gt["labels"] == cls)[0]
                n_gt += len(gt_idx)
                for p in preds:
                    if p["class"] != cls:
                        continue
                    best, bi = 0.0, -1
                    for j, g in enumerate(gt_idx):
                        iou = iou_fn(p, gt, g)
                        if iou > best:
                            best, bi = iou, j
                    scores.append(p["score"])
                    ious.append((scene_id, best, bi))
            scores = np.asarray(scores)
            best_ious = np.asarray([x[1] for x in ious]) if ious else \
                np.zeros(0)
            for oi, ov in enumerate(overlaps):
                # greedy: a pred is TP if best-IoU > ov and its gt unused
                # (confidence order)
                is_tp = np.zeros(len(scores), bool)
                if len(scores):
                    order = np.argsort(-scores)
                    used = set()
                    for r in order:
                        scene_gt = ious[r]
                        if best_ious[r] > ov and (scene_gt[0], scene_gt[2]) \
                                not in used and scene_gt[2] >= 0:
                            is_tp[r] = True
                            used.add((scene_gt[0], scene_gt[2]))
                table[oi, ci] = average_precision(scores, is_tp, n_gt)
        return table

    def record(self) -> Dict[str, float]:
        from pq3d_tpu_torch.data.scannet200_constants import (
            CLASS_LABELS_200, HEAD_CATS_200, COMMON_CATS_200, TAIL_CATS_200)
        classes_present = sorted({int(l) for g in self._gts
                                  for l in g["labels"] if int(l) >= 0})

        if self.official_protocol:
            from pq3d_tpu_torch.eval.scannet_protocol import \
                evaluate_scannet_ap
            scenes = [{"preds": preds, "gt_masks": gt["masks"],
                       "gt_labels": gt["labels"], "weights": gt["weights"]}
                      for preds, gt in zip(self._preds, self._gts)]
            # min_region_sizes is defined in verts; only meaningful when
            # vert counts are known (full-res masks or segment_sizes)
            full_res = any(g["weights"] is None and g["masks"].ndim == 2
                           and self.full_resolution for g in self._gts)
            min_region = (self.min_region_size
                          if (self._have_sizes or full_res) else 0.0)
            ap_table = evaluate_scannet_ap(
                scenes, classes_present, OVERLAPS,
                min_region_size=min_region)
        else:
            def mask_iou_fn(p, gt, g):
                return mask_iou(p["mask"], gt["masks"][g], gt["weights"])

            ap_table = self._ap_table(classes_present, OVERLAPS, mask_iou_fn)

        def _agg(cols):
            import warnings
            with np.errstate(invalid="ignore"), warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                sub = ap_table[:, cols] if cols else \
                    np.full((len(OVERLAPS), 1), np.nan)
                return (np.nanmean(sub[:-1, :]), np.nanmean(sub[0, :]),
                        np.nanmean(sub[-1, :]))

        all_ap, ap50, ap25 = _agg(list(range(len(classes_present))))
        results = {
            "all_ap": float(np.nan_to_num(all_ap)),
            "all_ap_50%": float(np.nan_to_num(ap50)),
            "all_ap_25%": float(np.nan_to_num(ap25)),
            "target_metric": float(np.nan_to_num(all_ap)),
        }

        # head/common/tail frequency breakdown (ref instseg_eval.py:151-243)
        if self.num_classes == len(CLASS_LABELS_200):
            for name, cats in (("head", HEAD_CATS_200),
                               ("common", COMMON_CATS_200),
                               ("tail", TAIL_CATS_200)):
                cols = [ci for ci, cls in enumerate(classes_present)
                        if CLASS_LABELS_200[cls] in cats]
                ap, a50, a25 = _agg(cols)
                results[f"{name}_ap"] = float(np.nan_to_num(ap))
                results[f"{name}_ap_50%"] = float(np.nan_to_num(a50))
                results[f"{name}_ap_25%"] = float(np.nan_to_num(a25))

        # box AP from mask AABBs (ref instseg_eval.py box path ->
        # common/eval_det.py); only when full-res points were available
        if any("box" in p for preds in self._preds for p in preds):
            def box_iou_fn(p, gt, g):
                pb = p.get("box")
                gb = gt.get("boxes", [None] * (g + 1))[g] \
                    if "boxes" in gt else None
                if pb is None or gb is None:
                    return 0.0
                lo = np.maximum(pb[:3], gb[:3])
                hi = np.minimum(pb[3:], gb[3:])
                inter = np.prod(np.maximum(hi - lo, 0))
                va = np.prod(pb[3:] - pb[:3])
                vb = np.prod(gb[3:] - gb[:3])
                return float(inter / max(va + vb - inter, 1e-9))

            box_table = self._ap_table(classes_present, (0.25, 0.5),
                                       box_iou_fn)
            with np.errstate(invalid="ignore"):
                results["box_ap_25%"] = float(np.nan_to_num(
                    np.nanmean(box_table[0, :])))
                results["box_ap_50%"] = float(np.nan_to_num(
                    np.nanmean(box_table[1, :])))
        return results
