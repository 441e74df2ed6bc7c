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


def dbscan_labels(points: np.ndarray, eps: float) -> np.ndarray:
    """Cluster labels of scikit-learn's ``DBSCAN(eps, min_samples=1)`` on
    ``points`` (N, 3), computed with numpy and scipy.

    With ``min_samples=1`` every point is a core point, so the clusters
    are the connected components of the graph that links two points at a
    distance <= ``eps`` (squared distances in f64 against ``eps**2``, as
    scikit-learn's tree search compares them), numbered by their smallest
    point index as scikit-learn numbers them.  The points fall into
    cubic cells of side just under ``eps / sqrt(3)``, whose points are all
    linked.  Where the cells are sparse, the pairs within ``eps``
    (``cKDTree.query_pairs``, inclusive) give the components directly.
    Where they are dense (a 2 cm scan has thousands of points within 0.95
    m of each), the graph is not built pair by pair: two cells up to two
    apart on each axis join when their representative points (each the
    point nearest its cell's mean) or, failing that, a KD-tree query
    finds a pair within ``eps``, nearest cells first and skipping cells
    already joined."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    from scipy.spatial import cKDTree
    p = np.asarray(points, np.float64)
    n = len(p)
    if n == 0:
        return np.zeros(0, np.int64)
    eps2 = float(eps) * float(eps)
    side = float(eps) / np.sqrt(3.0) * (1.0 - 1e-9)
    cell = np.floor((p - p.min(0)) / side).astype(np.int64)
    dims = cell.max(0) + 3
    key = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
    ukey, cid = np.unique(key, return_inverse=True)
    cid = cid.reshape(-1)
    nc = len(ukey)

    def components(edges):
        e = np.concatenate(edges)
        graph = coo_matrix((np.ones(len(e), np.int8), (e[:, 0], e[:, 1])),
                           shape=(nc, nc))
        return connected_components(graph, directed=False)[1]

    # about 22 cells' volume lies within eps of a point
    if n * (n / nc) * 11 < 1e6:
        nc = n
        pairs = cKDTree(p).query_pairs(float(eps), output_type="ndarray")
        return _by_first_index(components([pairs.reshape(-1, 2)]), n)
    order = np.argsort(cid, kind="stable")
    bounds = np.concatenate([[0], np.cumsum(np.bincount(cid))])
    members = [order[a:b] for a, b in zip(bounds[:-1], bounds[1:])]
    # each cell's point nearest its mean: two cells whose representatives
    # lie within eps join without a tree query (in a dense mask, nearly
    # every pair of neighbouring cells)
    mean = np.stack([np.bincount(cid, p[:, k], nc) for k in range(3)], 1) \
        / np.diff(bounds)[:, None]
    rep = p[np.lexsort((((p - mean[cid]) ** 2).sum(1), cid))[bounds[:-1]]]
    trees: Dict[int, Any] = {}
    edges = [np.zeros((0, 2), np.int64)]
    labels = np.arange(nc)

    def d2_of(x, y):
        diff = x - y
        return diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1] \
            + diff[:, 2] * diff[:, 2]

    def linked(a, b):
        if b not in trees:
            trees[b] = cKDTree(p[members[b]])
        pa = p[members[a]]
        d, k = trees[b].query(pa, k=1, distance_upper_bound=eps * 1.001)
        hit = np.nonzero(np.isfinite(d))[0]
        return (d2_of(pa[hit], p[members[b][k[hit]]]) <= eps2).any()

    offs = [np.array(o) for o in np.ndindex(5, 5, 5)]
    offs = sorted((o - 2 for o in offs if tuple(o - 2) > (0, 0, 0)),
                  key=lambda o: (np.maximum(np.abs(o) - 1, 0) ** 2).sum())
    ucell = np.stack([ukey // (dims[1] * dims[2]), ukey // dims[2] % dims[1],
                      ukey % dims[2]], 1)
    for o in offs:
        nb = ucell + o
        ok = (nb >= 0).all(1) & (nb < dims).all(1)
        nkey = (nb[:, 0] * dims[1] + nb[:, 1]) * dims[2] + nb[:, 2]
        j = np.searchsorted(ukey, nkey).clip(max=nc - 1)
        a = np.nonzero(ok & (ukey[j] == nkey))[0]
        b = j[a]
        keep = labels[a] != labels[b]
        a, b = a[keep], b[keep]
        if not len(a):
            continue
        near = d2_of(rep[a], rep[b]) <= eps2
        if near.any():
            edges.append(np.stack([a[near], b[near]], 1))
            labels = components(edges)
        # the other pairs by tree queries, skipping labels joined meanwhile
        root: Dict[int, int] = {}

        def find(c):
            while root.get(c, c) != c:
                c = root[c]
            return c
        found = []
        for x, y in zip(a[~near].tolist(), b[~near].tolist()):
            rx, ry = find(int(labels[x])), find(int(labels[y]))
            if rx != ry and linked(x, y):
                root[rx] = ry
                found.append((x, y))
        if found:
            edges.append(np.array(found, np.int64))
            labels = components(edges)
    return _by_first_index(labels[cid], n)


def _by_first_index(comp: np.ndarray, n: int) -> np.ndarray:
    """Component ids renumbered 0, 1, ... in the order of each component's
    smallest point index (scikit-learn's cluster numbering)."""
    first = np.full(int(comp.max()) + 1, n, np.int64)
    np.minimum.at(first, comp, np.arange(n))
    order = np.argsort(first)
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    return rank[comp]


class InstSegEval:
    """Accumulates per-scene predictions; record() computes AP/AP50/AP25
    (a numpy copy of the JAX package's evaluator; its DBSCAN split,
    ``use_dbscan``, runs on numpy and scipy: ``dbscan_labels``).  Under a
    process group ``record``
    gathers every rank's scenes to rank 0 in the order one process meets
    them (``parallel/dist.gather_in_order``), scores them there and gives
    every rank the result; the JAX package's evaluator keeps each
    process's own scenes."""

    def __init__(self, topk_per_scene: int = 100, num_classes: int = 200,
                 score_threshold: float = 0.0, save_dir: Optional[str] = None,
                 full_resolution: bool = False, use_dbscan: bool = False,
                 dbscan_eps: float = 0.95, official_protocol: bool = True,
                 min_region_size: float = 100.0):
        self.save_dir = save_dir
        self.use_dbscan = use_dbscan
        self.dbscan_eps = dbscan_eps
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
        self._bounds: List[int] = []   # scenes recorded after each update

    def reset(self):
        self._preds, self._gts = [], []
        self._have_sizes = False
        self._bounds = []

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
        self._bounds.append(len(self._preds))

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
        if self.use_dbscan and points is not None:
            preds = self._dbscan_split(preds, points)
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

    def _dbscan_split(self, preds, points):
        """Each predicted full-resolution mask split into its spatial
        clusters (``dbscan_labels`` at ``dbscan_eps``), one prediction per
        cluster in the order of their smallest point index, with the
        mask's class and score; a mask of fewer than 2 points stays
        whole.  A query ranked under several classes brings the same mask
        more than once, and its clusters are found once."""
        out, seen = [], {}
        for p in preds:
            idx = np.nonzero(p["mask"])[0]
            if len(idx) < 2:
                out.append(p)
                continue
            key = p["mask"].tobytes()
            if key not in seen:
                seen[key] = dbscan_labels(points[idx], self.dbscan_eps)
            labels = seen[key]
            for c in np.unique(labels):
                m = np.zeros_like(p["mask"])
                m[idx[labels == c]] = True
                out.append({**p, "mask": m})
        return out

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
        from pq3d_tpu_torch.parallel import dist
        if dist.world() == 1:
            return self._score()
        ends = [0] + self._bounds
        chunks = [list(zip(self._preds[a:b], self._gts[a:b]))
                  for a, b in zip(ends, ends[1:])]
        have_sizes = any(dist.all_gather_object(self._have_sizes))
        merged = dist.gather_in_order(chunks)
        results = None
        if merged is not None:
            local = self._preds, self._gts, self._have_sizes
            self._preds = [p for p, _ in merged]
            self._gts = [g for _, g in merged]
            self._have_sizes = have_sizes
            try:
                results = self._score()
            finally:
                self._preds, self._gts, self._have_sizes = local
        return dist.broadcast_object(results)

    def _score(self) -> Dict[str, float]:
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
