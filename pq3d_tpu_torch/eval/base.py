"""Evaluator base; counterpart of ``pq3d_tpu/eval/base.py``:
``truncate_batch_rows`` (the wrap-padding rows of a final eval batch
dropped before an evaluator sees them) and ``BaseEvaluator`` (update ->
record, metrics accumulated as (value, count) pairs).  One process: the
JAX package's cross-host merge has no counterpart yet.
"""
from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Any, Dict, Optional

import numpy as np


def truncate_batch_rows(tree: Any, n_real: int, batch_rows: int) -> Any:
    """Cut the evaluator-facing copies of a wrap-padded batch to its
    ``n_real`` rows: numpy arrays whose leading dim is ``batch_rows``
    (anywhere in the tree; a list of such arrays, per round, is cut
    elementwise) and other lists or tuples of length ``batch_rows``
    (per-row payloads: meta lists, decoded texts)."""
    if n_real >= batch_rows:
        return tree

    def cut(x):
        if isinstance(x, dict):
            return {k: cut(v) for k, v in x.items()}
        if isinstance(x, np.ndarray):
            return x[:n_real] if (x.ndim >= 1
                                  and x.shape[0] == batch_rows) else x
        if isinstance(x, (list, tuple)):
            if x and all(isinstance(v, np.ndarray) and v.ndim >= 1
                         and v.shape[0] == batch_rows for v in x):
                return type(x)(v[:n_real] for v in x)
            if len(x) == batch_rows:
                return type(x)(x[:n_real])
            return type(x)(cut(v) for v in x)
        return x
    return cut(tree)


class BaseEvaluator:
    def __init__(self, save_dir: Optional[str] = None):
        self.save_dir = save_dir
        self.eval_dict: Dict[str, list] = defaultdict(list)
        self.total_count = 0
        self.best_result = -np.inf
        self.target_metric = "target_metric"

    def reset(self):
        self.eval_dict = defaultdict(list)
        self.total_count = 0

    def update(self, out: Dict[str, Any], batch: Dict[str, Any]) -> None:
        raise NotImplementedError

    def record(self) -> Dict[str, float]:
        """Count-weighted means of the accumulated (value, count) pairs,
        ``target_metric`` set from the evaluator's target; written to
        ``save_dir/results.json`` when a directory is given."""
        results = {}
        for k, pairs in self.eval_dict.items():
            v = sum(x * c for x, c in pairs)
            c = sum(c for _, c in pairs)
            results[k] = v / max(c, 1)
        if self.target_metric in results:
            results["target_metric"] = results[self.target_metric]
        if self.save_dir:
            os.makedirs(self.save_dir, exist_ok=True)
            with open(os.path.join(self.save_dir, "results.json"), "w") as f:
                json.dump(results, f, indent=2)
        return results
