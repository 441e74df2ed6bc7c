"""Losses (PyTorch); counterpart of ``pq3d_tpu/optim/losses.py``: the
stage-1 set criterion (``batch_class_cost``, ``batch_mask_cost``,
``instseg_layer_loss``, ``instseg_set_loss``), the direct criterion of the
GT-query variant (``batch_mask_loss``, ``batch_dice_loss``,
``instseg_direct_loss``) and the stage-2 head losses (``cross_entropy``,
``ground_loss``, ``generation_loss``).  ``query3d_mask_loss`` is not
ported.

All target tensors are padded; validity masks make the math exact.  The
matching costs of every prediction round are built at once, read back to
the host once, and assigned by one ``scipy.optimize.linear_sum_assignment``
call per (round, scene): what the reference does and what the JAX
package's ``hungarian.solve_scipy_callback`` does.  The JAX package's
device solver is a ``lax.while_loop``, not a kernel; both give the same
assignment of the real targets (padded targets cost a constant, so they
never change it).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

PAD_COST = 1e4  # constant cost for padded targets (preserves real matching)


def _bce_logits(x: torch.Tensor, t) -> torch.Tensor:
    """Elementwise binary cross entropy with logits (stable)."""
    return x.clamp_min(0) - x * t + torch.log1p(torch.exp(-x.abs()))


def batch_class_cost(pred_logits: torch.Tensor, labels: torch.Tensor,
                     ignore_label: int = -100) -> torch.Tensor:
    """-prob[target] matching cost; ignored targets cost a constant -1.
    (B,Q,C), (B,M) -> (B,Q,M)."""
    prob = torch.softmax(pred_logits.float(), -1)
    b, q, _ = prob.shape
    safe = labels.clamp_min(0).long()
    cost = -torch.gather(prob, 2, safe[:, None, :].expand(b, q, -1))
    return torch.where((labels == ignore_label)[:, None, :], -1.0, cost)


def batch_mask_cost(mask_logits: torch.Tensor, tgt_masks: torch.Tensor,
                    seg_valid: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """BCE + dice matching costs over valid segments: mask_logits (B,S,Q),
    tgt (B,M,S), seg_valid (B,S) -> (cost_bce, cost_dice), each (B,Q,M),
    averaged over the actual segment count."""
    x = mask_logits.float()
    t = tgt_masks.float()
    w = seg_valid.float()
    s_valid = w.sum(-1).clamp_min(1.0)[:, None, None]
    pos = _bce_logits(x, 1.0) * w[..., None]
    neg = _bce_logits(x, 0.0) * w[..., None]
    tw = t * w[:, None, :]
    cost_bce = (torch.einsum("bsq,bms->bqm", pos, tw)
                + torch.einsum("bsq,bms->bqm", neg,
                               (1 - t) * w[:, None, :])) / s_valid
    p = torch.sigmoid(x) * w[..., None]
    num = 2 * torch.einsum("bsq,bms->bqm", p, tw)
    den = p.sum(1)[:, :, None] + tw.sum(-1)[:, None, :]
    cost_dice = 1 - (num + 1) / (den + 1)
    return cost_bce, cost_dice


@dataclasses.dataclass(frozen=True)
class InstSegLossConfig:
    cost_class: float = 2.0
    cost_mask: float = 5.0
    cost_dice: float = 2.0
    num_classes: int = 200
    ignore_label: int = -100


def round_costs(predictions_class: List[torch.Tensor],
                predictions_mask: List[torch.Tensor],
                batch: Dict[str, torch.Tensor],
                cfg: InstSegLossConfig) -> torch.Tensor:
    """Matching costs of every round at once: (R, B, M, Q), rows =
    targets, padded targets at ``PAD_COST``; no gradient."""
    labels = batch["instance_labels"]
    tgt = batch["segment_masks"]
    inst_valid = batch["instance_valid"]
    seg_valid = batch["seg_pad_masks"]
    with torch.no_grad():
        r = len(predictions_class)
        cls_all = torch.cat(predictions_class)           # (R*B, Q, C)
        msk_all = torch.cat(predictions_mask)            # (R*B, S, Q)
        c_cls = batch_class_cost(cls_all, labels.repeat(r, 1),
                                 cfg.ignore_label)
        c_bce, c_dice = batch_mask_cost(msk_all, tgt.repeat(r, 1, 1),
                                        seg_valid.repeat(r, 1))
        cost = (cfg.cost_class * c_cls + cfg.cost_mask * c_bce
                + cfg.cost_dice * c_dice)
        cost = torch.where(inst_valid.repeat(r, 1)[:, None, :], cost,
                           PAD_COST)
        return cost.transpose(1, 2).reshape((r,) + labels.shape
                                            + (cost.shape[1],))


def assign(costs: np.ndarray) -> np.ndarray:
    """(R, B, M, Q) costs -> (R, B, M) query index per target: one
    ``linear_sum_assignment`` per (round, scene)."""
    out = np.zeros(costs.shape[:3], np.int64)
    for r in range(costs.shape[0]):
        for b in range(costs.shape[1]):
            rows, cols = linear_sum_assignment(costs[r, b])
            out[r, b, rows] = cols
    return out


def instseg_layer_loss(pred_logits: torch.Tensor, mask_logits: torch.Tensor,
                       col4row: torch.Tensor, labels: torch.Tensor,
                       tgt_masks: torch.Tensor, inst_valid: torch.Tensor,
                       seg_valid: torch.Tensor, cfg: InstSegLossConfig
                       ) -> Dict[str, torch.Tensor]:
    """CE + BCE + dice for one prediction round given an assignment."""
    b, q, _ = pred_logits.shape
    # classification: matched labels scattered onto queries (an extra
    # trash column takes the padded targets)
    scatter_idx = torch.where(inst_valid, col4row, q)
    target = torch.full((b, q + 1), cfg.num_classes, dtype=torch.long,
                        device=pred_logits.device)
    target.scatter_(1, scatter_idx, labels.long())
    target = target[:, :q]
    logp = torch.log_softmax(pred_logits.float(), -1)
    not_ignored = target != cfg.ignore_label
    safe_t = torch.where(not_ignored, target.clamp_max(cfg.num_classes), 0)
    nll = -torch.gather(logp, 2, safe_t[..., None])[..., 0]
    loss_ce = (nll * not_ignored).sum() / not_ignored.sum().clamp_min(1)

    # masks: the matched query's mask per target, (B, M, S)
    s = mask_logits.shape[1]
    idx = col4row.clamp_max(q - 1)[..., None].expand(-1, -1, s)
    matched = torch.gather(mask_logits.transpose(1, 2), 1, idx).float()
    t = tgt_masks.float()
    w_seg = seg_valid.float()[:, None, :]
    w_inst = inst_valid.float()
    # per-scene normalisation, then the mean over scenes with targets
    num_per_scene = w_inst.sum(-1).clamp_min(1.0)
    scene_ok = (w_inst.sum(-1) > 0).float()
    n_scenes = scene_ok.sum().clamp_min(1.0)

    bce = _bce_logits(matched, t)
    per_inst_bce = (bce * w_seg).sum(-1) / w_seg.sum(-1).clamp_min(1.0)
    loss_mask = (((per_inst_bce * w_inst).sum(-1) / num_per_scene)
                 * scene_ok).sum() / n_scenes

    p = torch.sigmoid(matched) * w_seg
    tw = t * w_seg
    dice = 1 - (2 * (p * tw).sum(-1) + 1) / (p.sum(-1) + tw.sum(-1) + 1)
    loss_dice = (((dice * w_inst).sum(-1) / num_per_scene)
                 * scene_ok).sum() / n_scenes
    return {"loss_ce": loss_ce, "loss_mask": loss_mask,
            "loss_dice": loss_dice}


def instseg_set_loss(predictions_class: List[torch.Tensor],
                     predictions_mask: List[torch.Tensor],
                     batch: Dict[str, torch.Tensor],
                     cfg: InstSegLossConfig = InstSegLossConfig()
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Set criterion over all prediction rounds (aux rounds suffixed
    ``_i``, the last unsuffixed), weighted by the matcher costs."""
    costs = round_costs(predictions_class, predictions_mask, batch, cfg)
    col_all = torch.from_numpy(assign(costs.cpu().numpy())).to(
        costs.device)
    losses: Dict[str, torch.Tensor] = {}
    total = 0.0
    n = len(predictions_class)
    for i in range(n):
        ld = instseg_layer_loss(
            predictions_class[i], predictions_mask[i], col_all[i],
            batch["instance_labels"], batch["segment_masks"],
            batch["instance_valid"], batch["seg_pad_masks"], cfg)
        suffix = "" if i == n - 1 else f"_{i}"
        losses[f"loss_ce{suffix}"] = ld["loss_ce"] * cfg.cost_class
        losses[f"loss_mask{suffix}"] = ld["loss_mask"] * cfg.cost_mask
        losses[f"loss_dice{suffix}"] = ld["loss_dice"] * cfg.cost_dice
        total = total + losses[f"loss_ce{suffix}"] + \
            losses[f"loss_mask{suffix}"] + losses[f"loss_dice{suffix}"]
    return total, losses


# ---------------------------------------------------------------------------
# direct (GT-matched) criterion: query i supervises instance i
# ---------------------------------------------------------------------------

def batch_mask_loss(logits: torch.Tensor, targets: torch.Tensor,
                    padding_mask: torch.Tensor) -> torch.Tensor:
    """Masked BCE per instance, averaged over the instances with a valid
    segment; logits, targets and padding_mask (B, M, S)."""
    w = padding_mask.float()
    loss = _bce_logits(logits.float(), targets.float())
    per_inst = (loss * w).sum(-1) / (w.sum(-1) + 1e-6)
    inst_ok = w.sum(-1) > 0
    return (per_inst * inst_ok).sum() / inst_ok.sum().clamp_min(1)


def batch_dice_loss(logits: torch.Tensor, targets: torch.Tensor,
                    padding_mask: torch.Tensor) -> torch.Tensor:
    """Masked dice per instance, averaged as ``batch_mask_loss``."""
    w = padding_mask.float()
    p = torch.sigmoid(logits.float())
    t = targets.float()
    inter = (p * t * w).sum(-1)
    union = ((p + t) * w).sum(-1)
    dice = 1 - (2 * inter + 1e-6) / (union + 1e-6)
    inst_ok = w.sum(-1) > 0
    return (dice * inst_ok).sum() / inst_ok.sum().clamp_min(1)


def instseg_direct_loss(predictions_class: List[torch.Tensor],
                        predictions_mask: List[torch.Tensor],
                        batch: Dict[str, torch.Tensor],
                        ignore_label: int = -100
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """GT-matched criterion, no assignment: query i supervises instance i
    in every round with mask BCE, dice and CE (unweighted, aux rounds
    suffixed ``_i``).  The CE counts an instance only when its label is
    not ignored and it has a valid segment: collate pads
    ``instance_labels`` with 0, so the label alone would make every padded
    slot a class-0 target."""
    labels = batch["instance_labels"]
    tgt = batch["segment_masks"]
    pad = batch["instance_valid"][..., None] & \
        batch["seg_pad_masks"][:, None, :]
    losses: Dict[str, torch.Tensor] = {}
    total = 0.0
    n = len(predictions_mask)
    for i in range(n):
        pred = predictions_mask[i].transpose(1, 2)        # (B, Q, S)
        m = min(pred.shape[1], tgt.shape[1])
        lm = batch_mask_loss(pred[:, :m], tgt[:, :m], pad[:, :m])
        ld = batch_dice_loss(pred[:, :m], tgt[:, :m], pad[:, :m])
        logits = predictions_class[i][:, :m]
        valid = (labels[:, :m] != ignore_label) & pad[:, :m].any(-1)
        logp = torch.log_softmax(logits.float().clamp_min(-100), -1)
        nll = -torch.gather(logp, 2,
                            labels[:, :m].clamp_min(0).long()[..., None]
                            )[..., 0]
        lc = (nll * valid).sum() / valid.sum().clamp_min(1)
        sfx = "" if i == n - 1 else f"_{i}"
        losses[f"loss_mask{sfx}"] = lm
        losses[f"loss_dice{sfx}"] = ld
        losses[f"loss_ce{sfx}"] = lc
        total = total + lm + ld + lc
    return total, losses


# ---------------------------------------------------------------------------
# stage-2 head losses
# ---------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Cross entropy along the last dim, in f32, after clamping the logits
    at -100 from below; a label of the logits' shape takes the BCE branch,
    averaged over every entry (padded object slots, whose logits are the
    clamped -1e9, included), else the label holds class indices."""
    logits = logits.float().clamp_min(-100)
    if label.shape == logits.shape:
        return _bce_logits(logits, label.float()).mean()
    logp = torch.log_softmax(logits, -1)
    return -torch.gather(logp.reshape(-1, logp.shape[-1]), 1,
                         label.reshape(-1, 1).long()).mean()


def ground_loss(out: Dict, batch: Dict) -> torch.Tensor:
    return cross_entropy(out["ground_logits"], batch["tgt_object_id"])


def generation_loss(out: Dict, batch: Dict, pad_id: int = 0
                    ) -> torch.Tensor:
    """Teacher-forced sequence cross entropy (f32 log-softmax over the
    vocabulary), averaged over the valid response tokens
    (``response_valid``, else the tokens that are not ``pad_id``)."""
    logits = out["generation_logits"].float()
    labels = batch["response"]
    valid = batch.get("response_valid")
    if valid is None:
        valid = labels != pad_id
    valid = valid.float()
    logp = torch.log_softmax(logits, -1)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    return (nll * valid).sum() / valid.sum().clamp_min(1)
