"""Train and eval steps (PyTorch); counterpart of ``make_train_step`` and
``make_eval_step`` in ``pq3d_tpu/train/state.py``.

One train step: forward in train mode, loss, backward, clip of the global
gradient norm, optimizer step, schedule step.  Parameters that the loss
does not reach get a zero gradient, so AdamW decays them as optax does
(torch's AdamW skips a parameter whose ``.grad`` is ``None``).  Under
gradient accumulation (``optim/optimizers.GradientAccumulator``) a call is
one micro-step, and only every k-th clips and steps, on the mean.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn

from pq3d_tpu_torch.optim.optimizers import (GradientAccumulator,
                                             clip_by_global_norm_,
                                             global_norm)

LossFn = Callable[[Dict, Dict], Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    scheduler, loss_fn: LossFn,
                    grad_norm_max: Optional[float] = None,
                    mark: Optional[Callable[[str], None]] = None,
                    accumulator: Optional[GradientAccumulator] = None):
    """``step(batch) -> metrics``: ``loss``, ``grad_norm`` (of this call's
    gradients, before the clip) and the loss parts, as detached device
    scalars.  ``mark``, when given, is called with ``"forward"``,
    ``"loss"``, ``"backward"`` and ``"optimizer"`` as each part of the
    step has been issued (a profiler records an event there).  With an
    ``accumulator`` the optimizer steps only when it closes a window."""
    params = [p for p in model.parameters() if p.requires_grad]
    mark = mark or (lambda part: None)

    def step(batch: Dict) -> Dict[str, torch.Tensor]:
        model.train()
        out = model(batch)
        mark("forward")
        total, parts = loss_fn(out, batch)
        mark("loss")
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        mark("backward")
        grads = []
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        norm = global_norm(grads)
        if accumulator is None or accumulator.add(grads):
            if grad_norm_max:
                clip_by_global_norm_(grads, grad_norm_max,
                                     norm if accumulator is None
                                     else global_norm(grads))
            optimizer.step()
            scheduler.step()
        mark("optimizer")
        return {"loss": total.detach(), "grad_norm": norm,
                **{k: v.detach() for k, v in parts.items()}}

    return step


def make_eval_step(model: nn.Module, loss_fn: Optional[LossFn] = None):
    """``step(batch) -> outputs`` in eval mode, plus ``eval_loss`` when a
    loss is given."""
    def step(batch: Dict) -> Dict:
        model.eval()
        with torch.inference_mode():
            out = model(batch)
            if loss_fn is not None:
                out = dict(out)
                out["eval_loss"] = loss_fn(out, batch)[0]
        return out
    return step
