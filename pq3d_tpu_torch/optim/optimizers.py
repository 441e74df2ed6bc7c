"""Optimizer, LR schedule and gradient clipping (PyTorch); counterpart of
``pq3d_tpu/optim/optimizers.py``: AdamW with the ``no_decay_mask`` rule,
per-module learning rates (``lr_scale_mask``), the reference-exact
``warmup_cosine`` schedule as a ``LambdaLR``, and optax's
``clip_by_global_norm``.  Adam, SGD, Lion, the other schedules and
gradient accumulation are not ported.

A per-module rate is its own AdamW parameter groups at that rate under the
same ``LambdaLR``: JAX scales the whole AdamW update, decay term included,
by ``lr_module / lr`` after the optimizer, which is the same update.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterable, List, Optional, Tuple

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


def param_groups(model: nn.Module, weight_decay: float,
                 lr: Optional[float] = None,
                 module_lrs: Optional[Dict[str, float]] = None
                 ) -> List[Dict[str, Any]]:
    """AdamW's groups: the trainable parameters split by rate (a top-level
    module named in ``module_lrs`` at its own, the rest at ``lr``, the
    optimizer's default when None; the base-rate groups first) and by
    :func:`decays` (``weight_decay`` or none).  Up to four groups with one
    module rate."""
    module_lrs = module_lrs or {}
    groups: Dict[Tuple[Optional[float], bool], List[torch.Tensor]] = {
        (lr, True): [], (lr, False): []}
    for name, p in model.named_parameters():
        if p.requires_grad:
            rate = module_lrs.get(name.split(".", 1)[0], lr)
            groups.setdefault((rate, decays(name, p)), []).append(p)
    return [{"params": ps, "weight_decay": weight_decay if dec else 0.0,
             **({} if rate is None else {"lr": float(rate)})}
            for (rate, dec), ps in groups.items() if ps]


def build_optimizer(model: nn.Module, name: str = "AdamW", lr: float = 1e-4,
                    total_steps: int = 10000, warmup_steps: int = 0,
                    sched_name: str = "warmup_cosine", betas=(0.9, 0.98),
                    weight_decay: float = 0.01,
                    module_lrs: Optional[Dict[str, float]] = None):
    """(AdamW, LambdaLR); the schedule scales every group's rate.  AdamW's
    eps is optax's 1e-8; torch's update equals optax's ``adamw`` up to
    float rounding."""
    if name.lower() != "adamw":
        raise NotImplementedError(f"optimizer {name!r} is not ported "
                                  "(AdamW only)")
    opt = torch.optim.AdamW(param_groups(model, weight_decay, lr,
                                         module_lrs),
                            lr=lr, betas=tuple(betas), eps=1e-8)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lr_lambda(sched_name, total_steps, warmup_steps))
    return opt, sched


def module_lrs_of(model_cfg: Dict[str, Any]) -> Dict[str, float]:
    """The per-module rates a model config sets: ``<head>_head.lr`` for
    each of its heads and ``<enc>.lr`` for the four encoders."""
    names = [f"{h}_head" for h in model_cfg.get("heads") or ()]
    names += ["txt_encoder", "mv_encoder", "pc_encoder", "voxel_encoder"]
    return {n: float(model_cfg[n]["lr"]) for n in names
            if isinstance(model_cfg.get(n), dict)
            and model_cfg[n].get("lr") is not None}


def build_from_config(cfg: Dict[str, Any], model: nn.Module,
                      total_steps: int):
    """(optimizer, scheduler, grad_norm max or None) from the config's
    ``solver`` section and the model's per-module rates."""
    solver = cfg["solver"]
    if int(solver.get("gradient_accumulation_steps", 1) or 1) > 1:
        raise NotImplementedError("gradient accumulation is not ported")
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
        weight_decay=float(oargs.get("weight_decay", 0.01)),
        module_lrs=module_lrs_of(cfg["model"]))
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
