"""Optimizers, LR schedules, gradient clipping and gradient accumulation
(PyTorch); counterpart of ``pq3d_tpu/optim/optimizers.py``: AdamW, Adam,
SGD (momentum 0.9) and Lion by name, weight decay under the
``no_decay_mask`` rule (AdamW and Lion; optax's Adam and SGD take none),
per-module learning rates (``lr_scale_mask``), the reference-exact
``warmup_cosine``, ``warmup_exp`` and ``constant`` schedules as a
``LambdaLR``, optax's ``clip_by_global_norm``, and ``optax.MultiSteps``'
gradient accumulation (:class:`GradientAccumulator`).

A per-module rate is its own parameter groups at that rate under the
same ``LambdaLR``: JAX scales the whole update, decay term included, by
``lr_module / lr`` after the optimizer, which is the same update.
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


def lr_lambda(name: Optional[str], total_steps: int, warmup_steps: int = 0,
              gamma: float = 0.1):
    """Multiplier of the base LR at an optimizer step (the reference's
    LambdaLR lambdas, the JAX ``make_schedule`` divided by lr): linear
    warmup to step == warmup_steps, then cosine with a 1e-5 floor
    (``warmup_cosine``) or ``gamma ** (step / (total - warmup))``
    (``warmup_exp``); ``constant`` (also for no name) is 1."""
    name = name or "constant"
    if name == "constant":
        return lambda step: 1.0
    denom = max(total_steps - warmup_steps, 1)
    if name == "warmup_cosine":
        def after(step):
            return max(0.5 * (1 + math.cos((step - warmup_steps) / denom
                                            * math.pi)), 1e-5)
    elif name == "warmup_exp":
        def after(step):
            return gamma ** (step / denom)
    else:
        raise NotImplementedError(f"schedule {name!r} is not one of "
                                  "warmup_cosine, warmup_exp, constant")

    def f(step):
        if warmup_steps > 0 and step <= warmup_steps:
            return step / warmup_steps
        return after(step)
    return f


class Lion(torch.optim.Optimizer):
    """``optax.lion``'s update: ``u = sign((1 - b1) g + b1 m)``, then ``m
    = (1 - b2) g + b2 m``, and ``p -= lr (u + weight_decay p)`` (the decay
    inside the update, as optax's ``add_decayed_weights`` puts it)."""

    def __init__(self, params, lr: float = 1e-4,
                 betas: Tuple[float, float] = (0.9, 0.99),
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas),
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Lion takes no closure")
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["exp_avg"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
                m, g = state["exp_avg"], p.grad
                u = torch.sign(g * (1 - b1) + m * b1)
                m.mul_(b2).add_(g * (1 - b2))
                if group["weight_decay"]:
                    u.add_(p * group["weight_decay"])
                p.sub_(u * group["lr"])


def param_groups(model: nn.Module, weight_decay: float,
                 lr: Optional[float] = None,
                 module_lrs: Optional[Dict[str, float]] = None
                 ) -> List[Dict[str, Any]]:
    """The optimizer's groups: the trainable parameters split by rate (a
    top-level module named in ``module_lrs`` at its own, the rest at
    ``lr``, the optimizer's default when None; the base-rate groups first)
    and by :func:`decays` (``weight_decay`` or none).  Up to four groups
    with one module rate."""
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
                    module_lrs: Optional[Dict[str, float]] = None,
                    gamma: float = 0.1):
    """(optimizer, LambdaLR); the schedule scales every group's rate.
    Adam and AdamW take optax's eps 1e-8 and equal optax's updates up to
    float rounding; SGD is optax's ``sgd(momentum=0.9)``."""
    key = name.lower()
    if key not in ("adamw", "adam", "sgd", "lion"):
        raise NotImplementedError(f"optimizer {name!r} is not one of AdamW, "
                                  "Adam, SGD, Lion")
    groups = param_groups(model, weight_decay if key in ("adamw", "lion")
                          else 0.0, lr, module_lrs)
    if key == "adamw":
        opt = torch.optim.AdamW(groups, lr=lr, betas=tuple(betas), eps=1e-8)
    elif key == "adam":
        opt = torch.optim.Adam(groups, lr=lr, betas=tuple(betas), eps=1e-8)
    elif key == "sgd":
        opt = torch.optim.SGD(groups, lr=lr, momentum=0.9)
    else:
        opt = Lion(groups, lr=lr, betas=tuple(betas))
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lr_lambda(sched_name, total_steps, warmup_steps, gamma))
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
    ``solver`` section and the model's per-module rates;
    ``total_steps`` counts optimizer steps."""
    solver = cfg["solver"]
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
        module_lrs=module_lrs_of(cfg["model"]),
        gamma=float(sargs.get("gamma", 0.1)))
    grad_norm = float(solver.get("grad_norm", 0) or 0) or None
    return opt, lr_sched, grad_norm


def accumulation_steps(cfg: Dict[str, Any]) -> int:
    """``solver.gradient_accumulation_steps``: micro-steps a step."""
    return max(int(cfg["solver"].get("gradient_accumulation_steps", 1)
                   or 1), 1)


class GradientAccumulator:
    """``optax.MultiSteps(every_k_schedule=k)``: each micro-step's
    gradients join a running mean (Welford, as optax updates it); on the
    k-th the mean replaces the gradients and the optimizer steps, so the
    clip applies to the mean and the schedule advances once per k
    micro-steps.  ``state_dict`` holds the micro-step count and the mean
    so far, so a resume continues a window."""

    def __init__(self, every_k: int):
        self.every_k = int(every_k)
        self.mini_step = 0
        self.acc: Optional[List[torch.Tensor]] = None

    def add(self, grads: List[torch.Tensor]) -> bool:
        """Fold in one micro-step's ``grads``; True (with ``grads`` now
        the mean of the window) when the optimizer should step."""
        if self.acc is None:
            self.acc = [torch.zeros_like(g) for g in grads]
        n = self.mini_step
        for a, g in zip(self.acc, grads):
            a.add_((g - a) / (n + 1))
        self.mini_step = (n + 1) % self.every_k
        if self.mini_step:
            return False
        for a, g in zip(self.acc, grads):
            g.copy_(a)
            a.zero_()
        return True

    def preload(self, params: List[torch.Tensor]) -> None:
        """Data parallel, before the backward of the micro-step that closes
        the window: each parameter's gradient set to the sum of this
        rank's earlier gradients of the window, so that the backward adds
        the last one and DDP all-reduces the window's sum."""
        if self.acc is None or self.mini_step == 0:
            return
        for p, a in zip(params, self.acc):
            p.grad = a * self.mini_step

    def close_synced(self, grads: List[torch.Tensor]) -> None:
        """Data parallel, after that backward: ``grads`` (the all-reduced
        sum of the window) become its mean, and a new window opens."""
        for g in grads:
            g.div_(self.every_k)
        self.mini_step = 0
        if self.acc is not None:
            for a in self.acc:
                a.zero_()

    def state_dict(self) -> Dict[str, Any]:
        return {"mini_step": self.mini_step,
                "acc": None if self.acc is None
                else [a.detach().cpu() for a in self.acc]}

    def load_state_dict(self, state: Dict[str, Any],
                        device: torch.device) -> None:
        self.mini_step = int(state["mini_step"])
        self.acc = None if state["acc"] is None \
            else [a.to(device) for a in state["acc"]]


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
