"""Optimizer, LR schedule and gradient clipping (PyTorch); counterpart of
``pq3d_tpu/optim/optimizers.py`` for the stage-1 solver: AdamW with the
``no_decay_mask`` rule, the reference-exact ``warmup_cosine`` schedule as
a ``LambdaLR``, and optax's ``clip_by_global_norm``.  Adam, SGD, Lion,
the other schedules, per-module LRs and gradient accumulation are not
ported.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterable, List, Tuple

import torch
import torch.nn as nn


def decays(name: str, p: torch.Tensor) -> bool:
    """The JAX package's ``no_decay_mask`` rule on a parameter name:
    weight decay applies unless the tensor is 1-D or its dotted name
    contains 'norm', 'bias' or 'scale' (the port keeps the flax module
    names, so the rule reads the same names)."""
    if p.dim() <= 1:
        return False
    low = name.lower()
    return not ("norm" in low or "bias" in low or "scale" in low)


def lr_lambda(name: str, total_steps: int, warmup_steps: int = 0):
    """Multiplier of the base LR at a step (the reference's LambdaLR
    lambda, the JAX ``make_schedule`` divided by lr): linear warmup to
    step == warmup_steps, then cosine with a 1e-5 floor."""
    if name != "warmup_cosine":
        raise NotImplementedError(f"schedule {name!r} is not ported "
                                  "(warmup_cosine only)")
    denom = max(total_steps - warmup_steps, 1)

    def f(step):
        if warmup_steps > 0 and step <= warmup_steps:
            return step / warmup_steps
        return max(0.5 * (1 + math.cos((step - warmup_steps) / denom
                                        * math.pi)), 1e-5)
    return f


def param_groups(model: nn.Module, weight_decay: float
                 ) -> List[Dict[str, Any]]:
    """AdamW's two groups: the trainable parameters that :func:`decays`
    selects, with ``weight_decay``, and the rest without."""
    groups: Dict[bool, List[torch.Tensor]] = {True: [], False: []}
    for name, p in model.named_parameters():
        if p.requires_grad:
            groups[decays(name, p)].append(p)
    return [{"params": ps, "weight_decay": weight_decay if dec else 0.0}
            for dec, ps in groups.items() if ps]


def build_optimizer(model: nn.Module, name: str = "AdamW", lr: float = 1e-4,
                    total_steps: int = 10000, warmup_steps: int = 0,
                    sched_name: str = "warmup_cosine", betas=(0.9, 0.98),
                    weight_decay: float = 0.01):
    """(AdamW, LambdaLR).  AdamW's eps is optax's 1e-8; torch's update
    equals optax's ``adamw`` up to float rounding."""
    if name.lower() != "adamw":
        raise NotImplementedError(f"optimizer {name!r} is not ported "
                                  "(AdamW only)")
    opt = torch.optim.AdamW(param_groups(model, weight_decay), lr=lr,
                            betas=tuple(betas), eps=1e-8)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lr_lambda(sched_name, total_steps, warmup_steps))
    return opt, sched


def build_from_config(cfg: Dict[str, Any], model: nn.Module,
                      total_steps: int):
    """(optimizer, scheduler, grad_norm max or None) from the config's
    ``solver`` section."""
    solver = cfg["solver"]
    if int(solver.get("gradient_accumulation_steps", 1) or 1) > 1:
        raise NotImplementedError("gradient accumulation is not ported")
    lr_set = [k for k, v in cfg["model"].items()
              if isinstance(v, dict) and v.get("lr") is not None]
    if lr_set:
        raise NotImplementedError(f"per-module LRs ({lr_set}) are not "
                                  "ported")
    optim = solver.get("optim") or {}
    oargs = optim.get("args") or {}
    sched = solver.get("sched") or {}
    sargs = sched.get("args") or {}
    opt, lr_sched = build_optimizer(
        model, name=optim.get("name", "AdamW"), lr=float(solver["lr"]),
        total_steps=total_steps,
        warmup_steps=int(sargs.get("warmup_steps", 0)),
        sched_name=sched.get("name", "warmup_cosine"),
        betas=tuple(oargs.get("betas", [0.9, 0.98])),
        weight_decay=float(oargs.get("weight_decay", 0.01)))
    grad_norm = float(solver.get("grad_norm", 0) or 0) or None
    return opt, lr_sched, grad_norm


def global_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient (optax.global_norm)."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         norm: torch.Tensor) -> None:
    """optax's ``clip_by_global_norm`` in place: unchanged while
    ``norm < max_norm``, else scaled by ``max_norm / norm`` (torch's
    ``clip_grad_norm_`` divides by ``norm + 1e-6`` instead).  Decided on
    the device, without a host sync."""
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    for g in grads:
        g.mul_(scale)
