"""Checkpoint save / resume with ``torch.save``; counterpart of the
``CheckpointManager`` in ``pq3d_tpu/train/checkpoints.py``.

Named snapshots (``latest``, ``best``, ``ckpt_N``) each hold the model's
parameters and buffers, the optimizer, the LR scheduler, the step and the
experiment tracker, in ``<ckpt_dir>/<name>/state.pt``.  A save writes a
temporary file and renames it, so an interrupted save leaves the previous
snapshot whole.  ``load_pretrain`` is the non-strict warm start (stage 2
from a stage-1 checkpoint): by name and shape, as the JAX package's is by
flax path and shape.  The JAX package's orbax format and its warm start
from reference ``.bin`` files are not ported.
"""
from __future__ import annotations

import glob
import os
from typing import Any, Dict, List, Optional, Tuple

import torch

from pq3d_tpu_torch.models.layers import BatchNorm, MaskedBatchNorm

_FILE = "state.pt"


class CheckpointManager:
    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        os.makedirs(self.ckpt_dir, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.ckpt_dir, name, _FILE)

    def save(self, name: str, model, optimizer, scheduler, step: int,
             tracker: Dict[str, Any]) -> None:
        path = self._path(name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        payload = {"model": model.state_dict(),
                   "optimizer": optimizer.state_dict(),
                   "scheduler": scheduler.state_dict(),
                   "step": int(step), "tracker": dict(tracker)}
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)

    def restore(self, name: str, model, optimizer, scheduler
                ) -> Tuple[int, Dict[str, Any]]:
        """Load ``name`` into the given objects; returns (step, tracker)."""
        payload = torch.load(self._path(name), map_location="cpu",
                             weights_only=False)
        model.load_state_dict(payload["model"])
        optimizer.load_state_dict(payload["optimizer"])
        scheduler.load_state_dict(payload["scheduler"])
        return payload["step"], payload["tracker"]

    def exists(self, name: str) -> bool:
        return os.path.exists(self._path(name))


def warm_start_tensors(model: torch.nn.Module
                       ) -> Tuple[Dict[str, torch.Tensor],
                                  Dict[str, torch.Tensor]]:
    """What a warm start may fill: the parameters, and the BatchNorm
    running statistics (the JAX package's ``params`` and ``batch_stats``;
    other buffers, such as the Fourier features' ``gauss_B``, keep their
    init there too)."""
    stats = {}
    for name, mod in model.named_modules():
        if isinstance(mod, (BatchNorm, MaskedBatchNorm)):
            for b, t in mod.named_buffers(recurse=False):
                stats[f"{name}.{b}" if name else b] = t
    return dict(model.named_parameters()), stats


def load_pretrain(model: torch.nn.Module,
                  pretrained: Dict[str, torch.Tensor]) -> List[str]:
    """Non-strict warm start: every parameter and BatchNorm statistic of
    ``model`` takes the tensor of the same name and shape in
    ``pretrained``; the rest keep their init.  Prints the counts of each
    group (parameters, then statistics) as the JAX package prints its
    ``params`` and ``batch_stats`` trees; returns the loaded names."""
    loaded: List[str] = []
    for group in warm_start_tensors(model):
        done, skipped = [], []
        for name, t in group.items():
            src = pretrained.get(name)
            if src is not None and tuple(src.shape) == tuple(t.shape):
                with torch.no_grad():
                    t.copy_(src.to(t.dtype))
                done.append(name)
            else:
                skipped.append(name)
        if skipped:
            print(f"[pretrain] loaded {len(done)} leaves, kept init for "
                  f"{len(skipped)} (first few: {skipped[:5]})")
        loaded += done
    return loaded


def find_pretrain(path: str) -> Optional[str]:
    """The ``state.pt`` that ``pretrain_ckpt_path`` names: a checkpoint
    dir (its ``latest``), one snapshot's dir, or the file; None when there
    is none.  Reference ``pytorch_model*.bin`` files raise: importing them
    is ROADMAP A.3, not ported."""
    for cand in (os.path.join(path, "latest", _FILE),
                 os.path.join(path, _FILE)):
        if os.path.isfile(cand):
            return cand
    if os.path.isfile(path) and os.path.basename(path) == _FILE:
        return path
    if (os.path.isdir(path) and glob.glob(
            os.path.join(path, "pytorch_model*.bin"))) or (
            path.endswith((".bin", ".pth", ".pt")) and os.path.isfile(path)):
        raise NotImplementedError(
            f"warm start from reference torch weights ({path!r}) is not "
            f"ported (ROADMAP A.3, HF import); give a checkpoint of this "
            f"package")
    return None
