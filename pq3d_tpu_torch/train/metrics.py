"""Metric logging and the experiment tracker; counterpart of
``pq3d_tpu/train/metrics.py``: a JSONL metrics log (no TensorBoard) and
the (epoch, best_result) state that is checkpointed with the model."""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict


class MetricsLogger:
    def __init__(self, exp_dir: str):
        self.exp_dir = exp_dir
        os.makedirs(exp_dir, exist_ok=True)
        self._jsonl = open(os.path.join(exp_dir, "metrics.jsonl"), "a")

    def log(self, metrics: Dict[str, Any], step: int, prefix: str = "train"):
        rec = {"step": step, "time": time.time(), "prefix": prefix}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                continue
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def close(self):
        self._jsonl.close()


class ExpTracker:
    """Epoch / best-result state carried across resume."""

    def __init__(self):
        self.epoch = 0
        self.best_result = -float("inf")

    def state_dict(self) -> Dict[str, Any]:
        return {"epoch": self.epoch, "best_result": self.best_result}

    def load_state_dict(self, d: Dict[str, Any]):
        self.epoch = int(d.get("epoch", 0))
        self.best_result = float(d.get("best_result", -float("inf")))

    def is_better(self, result: float) -> bool:
        if result > self.best_result:
            self.best_result = result
            return True
        return False
