"""Official ScanNet instance-segmentation AP protocol.

Clean-room implementation of the benchmark semantics the reference vendors
(reference: common/eval_instseg.py:16-180 evaluate_matches,
:320-360 assign_instances_for_scan), which differ from a plain greedy
confidence-matched AP in four load-bearing ways:

1. **min_region_sizes = 100**: predictions smaller than 100 verts are
   dropped; GT instances smaller than 100 verts are excluded from the GT
   set but their overlap with a prediction counts toward that prediction's
   *ignore* mass.
2. **Void handling**: verts not covered by any valid-class GT instance are
   void; a non-matched prediction whose ignore proportion (void + small-GT
   intersections) exceeds the overlap threshold is NOT a false positive.
3. **Multi-match**: if several predictions overlap one GT above threshold,
   the higher score keeps the match and the lower is appended as an extra
   false positive (each prediction can match at most one GT per threshold).
4. **AP integration**: precision/recall sampled at unique score thresholds,
   an artificial (r=0, p=1) end point, and trapezoid-free step-width dot
   product (the ScanNet benchmark's convolve formulation), with
   hard false negatives (unmatched GT) in the recall denominator.

Masks may be weighted (per-segment vert counts) so the protocol runs at
segment level with the same vert-count semantics as full resolution.
Numpy copy of ``pq3d_tpu/eval/scannet_protocol.py`` for the port.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

OVERLAPS = np.append(np.arange(0.5, 0.95, 0.05), 0.25)  # 0.5..0.9 + 0.25
MIN_REGION_SIZE = 100.0


def _count(mask: np.ndarray, weights: Optional[np.ndarray]) -> float:
    return float(mask.sum()) if weights is None else float(weights[mask].sum())


def _prepare_scene(scene: Dict, cls: int, min_region: float):
    """Per (scene, class): eligible GT list, small-GT list, class preds with
    vert counts, and the scene void mask."""
    weights = scene.get("weights")
    gt_masks = np.asarray(scene["gt_masks"])
    gt_labels = np.asarray(scene["gt_labels"])
    if gt_masks.ndim == 2:
        n_units = gt_masks.shape[1]
    else:
        n_units = len(scene["preds"][0]["mask"]) if scene["preds"] else 0
        gt_masks = gt_masks.reshape(0, n_units)
    valid_gt = gt_labels >= 0
    void = (~np.logical_or.reduce(gt_masks[valid_gt], axis=0)
            if valid_gt.any() else np.ones(n_units, bool))

    big, small = [], []
    for g in np.nonzero(gt_labels == cls)[0]:
        vc = _count(gt_masks[g], weights)
        (big if vc >= min_region else small).append((gt_masks[g], vc))
    preds = []
    for p in scene["preds"]:
        if p["class"] != cls:
            continue
        vc = _count(p["mask"], weights)
        if vc < min_region:
            continue
        preds.append((p["mask"], float(p["score"]), vc))
    return big, small, preds, void, weights


def evaluate_scannet_ap(scenes: List[Dict], classes: Sequence[int],
                        overlaps: np.ndarray = OVERLAPS,
                        min_region_size: float = MIN_REGION_SIZE
                        ) -> np.ndarray:
    """scenes: list of {preds: [{class, score, mask}], gt_masks (G,N) bool,
    gt_labels (G,), weights: optional (N,) vert counts}.
    Returns ap[len(overlaps), len(classes)] with NaN for absent classes."""
    ap = np.full((len(overlaps), len(classes)), np.nan)
    for ci, cls in enumerate(classes):
        per_scene = [_prepare_scene(s, cls, min_region_size) for s in scenes]
        for oi, th in enumerate(overlaps):
            y_true: List[float] = []
            y_score: List[float] = []
            hard_fn = 0
            has_gt = has_pred = False
            for big, small, preds, void, weights in per_scene:
                if big:
                    has_gt = True
                if preds:
                    has_pred = True
                visited = [False] * len(preds)
                matched_score = [None] * len(big)
                # GT-major matching with lower-score extra matches as FPs
                for gi, (gmask, gvc) in enumerate(big):
                    found = False
                    for pi, (pmask, score, pvc) in enumerate(preds):
                        if visited[pi]:
                            continue
                        inter = _count(np.logical_and(gmask, pmask), weights)
                        if inter <= 0:
                            continue
                        ov = inter / (gvc + pvc - inter)
                        if ov > th:
                            if matched_score[gi] is not None:
                                hi = max(matched_score[gi], score)
                                lo = min(matched_score[gi], score)
                                matched_score[gi] = hi
                                y_true.append(0.0)   # extra match -> FP
                                y_score.append(lo)
                            else:
                                found = True
                                matched_score[gi] = score
                                visited[pi] = True
                    if not found:
                        hard_fn += 1
                for s in matched_score:
                    if s is not None:
                        y_true.append(1.0)
                        y_score.append(s)
                # unmatched predictions: FP unless mostly ignore mass
                for pi, (pmask, score, pvc) in enumerate(preds):
                    overlapped = False
                    for gmask, gvc in big:
                        inter = _count(np.logical_and(gmask, pmask), weights)
                        if inter > 0 and inter / (gvc + pvc - inter) > th:
                            overlapped = True
                            break
                    if overlapped:
                        continue
                    ignore = _count(np.logical_and(void, pmask), weights)
                    for gmask, gvc in small:
                        ignore += _count(np.logical_and(gmask, pmask),
                                         weights)
                    if ignore / pvc <= th:
                        y_true.append(0.0)
                        y_score.append(score)
            if has_gt and has_pred:
                ap[oi, ci] = _ap_from_curve(np.asarray(y_true),
                                            np.asarray(y_score), hard_fn)
            elif has_gt:
                ap[oi, ci] = 0.0
    return ap


def _ap_from_curve(y_true: np.ndarray, y_score: np.ndarray,
                   hard_fn: int) -> float:
    """ScanNet benchmark AP integration (ref eval_instseg.py:123-173)."""
    order = np.argsort(y_score)
    y_true = y_true[order]
    y_score = y_score[order]
    cum = np.cumsum(y_true)
    total_tp = cum[-1] if len(cum) else 0
    thresholds, first_idx = np.unique(y_score, return_index=True)
    n = len(y_score)
    precision = np.zeros(len(first_idx) + 1)
    recall = np.zeros(len(first_idx) + 1)
    cum = np.append(cum, 0)   # cum[-1] lookup for idx 0 hits the 0 sentinel
    for k, idx in enumerate(first_idx):
        below = cum[idx - 1]            # TPs with score < threshold
        tp = total_tp - below
        fp = n - idx - tp
        fn = below + hard_fn
        precision[k] = tp / (tp + fp) if tp + fp else 0.0
        recall[k] = tp / (tp + fn) if tp + fn else 0.0
    precision[-1] = 1.0
    recall[-1] = 0.0
    r_conv = np.concatenate([[recall[0]], recall, [0.0]])
    step = np.convolve(r_conv, [-0.5, 0, 0.5], "valid")
    return float(np.dot(precision, step))


def average_aps(ap: np.ndarray, overlaps: np.ndarray = OVERLAPS):
    """(all_ap excl 0.25, ap50, ap25) per the benchmark's compute_averages
    (ref eval_instseg.py:181-197); columns = classes."""
    import warnings
    o50 = np.isclose(overlaps, 0.5)
    o25 = np.isclose(overlaps, 0.25)
    with np.errstate(invalid="ignore"), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return (float(np.nanmean(ap[~o25, :])),
                float(np.nanmean(ap[o50, :])),
                float(np.nanmean(ap[o25, :])))
