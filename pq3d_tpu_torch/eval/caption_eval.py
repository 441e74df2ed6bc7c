"""Scan2Cap dense captioning evaluation: CIDEr/BLEU-4/ROUGE-L @ IoU25/50;
copy of ``pq3d_tpu/eval/caption_eval.py``.  Predictions whose predicted
box misses the target object at the IoU threshold are scored as empty
captions; corpus metrics run over the full object set.  Under a process
group ``record`` gathers every rank's items to rank 0 in the order one
process meets them, scores them there and gives every rank the result
(the JAX package's keeps each process's own items).
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import numpy as np

from pq3d_tpu_torch.eval.base import BaseEvaluator
from pq3d_tpu_torch.eval.caption_metrics import (cider_d, corpus_bleu,
                                                 meteor, meteor_lite,
                                                 rouge_l)
from pq3d_tpu_torch.utils.box_utils import aabb_iou


class Scan2CapEval(BaseEvaluator):
    def __init__(self, save_dir: Optional[str] = None):
        super().__init__(save_dir)
        self.target_metric = "cider@0.5"
        self._items: List[Dict] = []
        self._bounds: List[int] = []   # items recorded after each update

    def reset(self):
        super().reset()
        self._items = []
        self._bounds = []

    def update(self, out: Dict[str, Any], batch: Dict[str, Any]) -> None:
        """Expects out['caption_pred'] (list[str]) and batch with
        'corpus_key' (unique object key), 'ref_captions' (list[list[str]]),
        and per-item 'iou' (pred-box vs gt IoU; computed upstream or via
        boxes here)."""
        preds: List[str] = out["caption_pred"]
        keys: List[str] = batch["corpus_key"]
        refs = batch.get("ref_captions")
        if refs is None:  # single reference per object
            refs = [[c] for c in batch["caption"]]
        if "iou" in batch:
            ious = np.asarray(batch["iou"])
        elif "pred_boxes" in batch and "gt_boxes" in batch:
            pred_boxes = np.asarray(batch["pred_boxes"])
            gt_boxes = np.asarray(batch["gt_boxes"])
            ious = np.array([aabb_iou(p, g)
                             for p, g in zip(pred_boxes, gt_boxes)])
        else:
            # GT-box (LOC-prompt) captioning: localization is given
            ious = np.ones(len(preds))
        for i in range(len(preds)):
            self._items.append({"key": keys[i], "pred": preds[i],
                                "refs": refs[i], "iou": float(ious[i])})
        self.total_count += len(preds)
        self._bounds.append(len(self._items))

    def record(self) -> Dict[str, float]:
        from pq3d_tpu_torch.parallel import dist
        if dist.world() == 1:
            return self._score(self._items)
        ends = [0] + self._bounds
        merged = dist.gather_in_order([self._items[a:b]
                                       for a, b in zip(ends, ends[1:])])
        return dist.broadcast_object(
            None if merged is None else self._score(merged))

    def _score(self, items: List[Dict]) -> Dict[str, float]:
        results = {}
        # dedup: keep one prediction per object key (ref scan2cap dedups by
        # unique object, scan2cap.py:4-34)
        by_key: Dict[str, Dict] = {}
        for it in items:
            by_key.setdefault(it["key"], it)
        for thr in (0.25, 0.5):
            preds = {}
            refs = {}
            for k, it in by_key.items():
                pred = it["pred"] if it["iou"] >= thr else ""
                # predictions capped at 30 tokens (ref scan2cap_eval.py:25,51
                # word_tokenize(...)[:30]; whitespace split stands in for
                # nltk, which is absent here)
                pred = " ".join(pred.split()[:30])
                preds[k] = [("sos " + pred + " eos").strip()]
                refs[k] = [("sos " + r + " eos").strip() for r in it["refs"]]
            bleus, _ = corpus_bleu(preds, refs)
            results[f"bleu4@{thr}"] = bleus[3]
            results[f"rouge@{thr}"] = rouge_l(preds, refs)
            results[f"cider@{thr}"] = cider_d(preds, refs)
            # jar-based METEOR when METEOR_JAR is set (parity number);
            # meteor_lite (exact+stem matchers) is always available
            mj = meteor(preds, refs)
            if mj == mj:
                results[f"meteor@{thr}"] = mj
            results[f"meteor_lite@{thr}"] = meteor_lite(preds, refs)
        results["target_metric"] = results["cider@0.5"]
        if self.save_dir:
            os.makedirs(self.save_dir, exist_ok=True)
            with open(f"{self.save_dir}/results.json", "w") as f:
                json.dump(results, f, indent=2)
        return results
