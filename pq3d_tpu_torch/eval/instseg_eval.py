"""Instance ranking for serving (numpy); copy of ``rank_instances`` from
``pq3d_tpu/eval/instseg_eval.py``."""
from __future__ import annotations

from typing import Optional

import numpy as np


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
