"""Weighted sum of the stage-2 head losses; counterpart of ``Loss`` in
``pq3d_tpu/optim/loss_aggregator.py``.

The config's ``loss_list`` names losses of ``LOSSES``; ``loss_weights``
scales each (default 1).  A loss whose inputs are absent from the outputs
or the batch contributes nothing, since the mixed-task loader gives
batches with different keys.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch

from pq3d_tpu_torch.optim import losses as L


def _ground_loss(out, batch):
    if "ground_logits" not in out or "tgt_object_id" not in batch:
        return None
    return L.cross_entropy(out["ground_logits"], batch["tgt_object_id"])


def _og3d_loss(out, batch):
    if "og3d_logits" not in out or "tgt_object_id" not in batch:
        return None
    return L.cross_entropy(out["og3d_logits"], batch["tgt_object_id"])


def _generation_loss(out, batch):
    if "generation_logits" not in out or "response" not in batch:
        return None
    return L.generation_loss(out, batch)


def _answer_loss(out, batch):
    if "answer_scores" not in out or "answer_label" not in batch:
        return None
    return L.answer_loss(out, batch)


def _query3d_mask_loss(out, batch):
    if "predictions_mask" not in out or "gt_attn_mask" not in batch:
        return None
    return L.query3d_mask_loss(out["predictions_mask"],
                               out["predictions_class"], batch)


LOSSES: Dict[str, Callable] = {"ground_loss": _ground_loss,
                               "og3d_loss": _og3d_loss,
                               "generation_loss": _generation_loss,
                               "answer_loss": _answer_loss,
                               "query3d_mask_loss": _query3d_mask_loss}


class Loss:
    """``loss(out, batch) -> (total, {name: value})``, the parts holding
    only the losses that applied to the batch."""

    def __init__(self, loss_list: Sequence[str],
                 loss_weights: Optional[Mapping[str, float]] = None):
        for name in loss_list:
            if name not in LOSSES:
                raise KeyError(f"unknown loss {name!r}")
        self.entries = [(name, LOSSES[name]) for name in loss_list]
        self.weights = {k: float(v) for k, v in (loss_weights or {}).items()}

    def __call__(self, out: Dict, batch: Dict
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        total = None
        parts: Dict[str, torch.Tensor] = {}
        for name, fn in self.entries:
            val = fn(out, batch)
            if val is None:
                continue
            parts[name] = val
            term = self.weights.get(name, 1.0) * val
            total = term if total is None else total + term
        if total is None:
            dev = next((v.device for v in batch.values()
                        if isinstance(v, torch.Tensor)), None)
            total = torch.zeros((), device=dev)
        return total, parts
