"""Train and eval steps (PyTorch); counterpart of ``make_train_step`` and
``make_eval_step`` in ``pq3d_tpu/train/state.py``.

One train step: forward in train mode, loss, backward, clip of the global
gradient norm, optimizer step, schedule step.  Parameters that the loss
does not reach get a zero gradient, so AdamW decays them as optax does
(torch's AdamW skips a parameter whose ``.grad`` is ``None``).  Under
gradient accumulation (``optim/optimizers.GradientAccumulator``) a call is
one micro-step, and only every k-th clips and steps, on the mean.

Data parallel (``ddp``, the model wrapped in ``DistributedDataParallel``):
the loss a rank computes is its rows' share of the global batch's loss
(``optim/losses.py``), so the backward runs on the share times the world
size and DDP's average of the ranks' gradients is the gradient of the
global loss; the logged loss and its parts are the sums of the shares,
the same on every rank.  The clip reads the all-reduced gradients.  Under
accumulation the micro-steps that do not step skip DDP's all-reduce
(``no_sync``); the k-th starts from the window's earlier gradients summed
(``GradientAccumulator.preload``), so one all-reduce carries the window
and its mean is taken after it; there ``grad_norm`` is the norm of that
mean, where one process reports the k-th micro-step's own.

On a sharded mesh (``sharding``, from ``parallel/mesh.shard_params``:
``fsdp`` or ``tp`` above 1) the forward and the backward run inside
``sharding.gathered()`` (the fsdp shards gathered), on the share itself;
``sharding.reduce_grads`` then sums each gradient over the ranks that
must add it and keeps the rank's block, the clip reads the norm of the
whole model's gradient (``sharding.global_norm``: each element once), and
AdamW steps on the blocks.  Under accumulation the micro-steps that do
not step keep their own gradients in the compute shape, unreduced (the
counterpart of ``no_sync``), and the k-th reduces the window's sum.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn

from pq3d_tpu_torch.optim.optimizers import (GradientAccumulator,
                                             clip_by_global_norm_,
                                             global_norm)
from pq3d_tpu_torch.parallel.dist import global_sum, rows

LossFn = Callable[[Dict, Dict], Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    scheduler, loss_fn: LossFn,
                    grad_norm_max: Optional[float] = None,
                    mark: Optional[Callable[[str], None]] = None,
                    accumulator: Optional[GradientAccumulator] = None,
                    ddp: Optional[nn.Module] = None, sharding=None):
    """``step(batch) -> metrics``: ``loss``, ``grad_norm`` (of this call's
    gradients, before the clip) and the loss parts, as detached device
    scalars.  ``mark``, when given, is called with ``"forward"``,
    ``"loss"``, ``"backward"`` and ``"optimizer"`` as each part of the
    step has been issued (a profiler records an event there).  With an
    ``accumulator`` the optimizer steps only when it closes a window.
    ``ddp`` is ``model`` wrapped in ``DistributedDataParallel``: the
    forward goes through it.  ``sharding`` is the model's placement on a
    sharded mesh (module docstring)."""
    params = [p for p in model.parameters() if p.requires_grad]
    mark = mark or (lambda part: None)
    forward = model if ddp is None else ddp
    n_ranks = rows()
    if sharding is not None:
        return _sharded_step(model, optimizer, scheduler, loss_fn,
                             grad_norm_max, mark, accumulator, sharding,
                             params)

    def step(batch: Dict) -> Dict[str, torch.Tensor]:
        model.train()
        # data parallel with accumulation: only the micro-step that closes
        # the window all-reduces, and it carries the window's sum
        synced = ddp is not None and accumulator is not None
        closing = synced and \
            accumulator.mini_step == accumulator.every_k - 1
        with (ddp.no_sync() if synced and not closing
              else contextlib.nullcontext()):
            out = forward(batch)
            mark("forward")
            total, parts = loss_fn(out, batch)
            mark("loss")
            optimizer.zero_grad(set_to_none=True)
            if closing:
                accumulator.preload(params)
            (total * n_ranks if n_ranks > 1 else total).backward()
        mark("backward")
        grads = []
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        if closing:
            accumulator.close_synced(grads)
        norm = global_norm(grads)
        if closing or accumulator is None or accumulator.add(grads):
            if grad_norm_max:
                clip_by_global_norm_(grads, grad_norm_max,
                                     norm if accumulator is None or closing
                                     else global_norm(grads))
            optimizer.step()
            scheduler.step()
        mark("optimizer")
        metrics = _summed_metrics(total, parts)
        return {"loss": metrics.pop("loss"), "grad_norm": norm, **metrics}

    return step


def _summed_metrics(total, parts) -> Dict[str, torch.Tensor]:
    """The loss and its parts, each summed over the row group's shares."""
    metrics = {"loss": total.detach(),
               **{k: v.detach() for k, v in parts.items()}}
    if rows() > 1:
        summed = global_sum(torch.stack([v.float()
                                         for v in metrics.values()]))
        metrics = dict(zip(metrics, summed.unbind()))
    return metrics


def _sharded_step(model, optimizer, scheduler, loss_fn, grad_norm_max,
                  mark, accumulator, sharding, params):
    """``make_train_step`` on a sharded mesh (module docstring)."""
    def step(batch: Dict) -> Dict[str, torch.Tensor]:
        model.train()
        closing = accumulator is not None and \
            accumulator.mini_step == accumulator.every_k - 1
        with sharding.gathered():
            out = model(batch)
            mark("forward")
            total, parts = loss_fn(out, batch)
            mark("loss")
            optimizer.zero_grad(set_to_none=True)
            if closing:
                accumulator.preload(params)
            total.backward()
        mark("backward")
        grads = sharding.local_grads(params)
        if accumulator is not None and not closing:
            # a micro-step inside the window: this rank's own gradients
            norm = global_norm(grads)
            accumulator.add(grads)
        else:
            grads = sharding.reduce_grads(params, grads)
            for p, g in zip(params, grads):
                p.grad = g
            if closing:
                accumulator.close_synced(grads)
            norm = sharding.global_norm(params, grads)
            if grad_norm_max:
                clip_by_global_norm_(grads, grad_norm_max, norm)
            optimizer.step()
            scheduler.step()
        mark("optimizer")
        metrics = _summed_metrics(total, parts)
        return {"loss": metrics.pop("loss"), "grad_norm": norm, **metrics}

    return step


def make_eval_step(model: nn.Module, loss_fn: Optional[LossFn] = None,
                   sharding=None):
    """``step(batch) -> outputs`` in eval mode, plus ``eval_loss`` when a
    loss is given; on a sharded mesh inside ``sharding.gathered()``."""
    def step(batch: Dict) -> Dict:
        model.eval()
        with (sharding.gathered() if sharding is not None
              else contextlib.nullcontext()), torch.inference_mode():
            out = model(batch)
            if loss_fn is not None:
                out = dict(out)
                out["eval_loss"] = loss_fn(out, batch)[0]
        return out
    return step
