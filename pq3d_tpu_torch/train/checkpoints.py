"""Checkpoint save / resume with ``torch.save``; counterpart of the
``CheckpointManager`` in ``pq3d_tpu/train/checkpoints.py``.

Named snapshots (``latest``, ``best``, ``ckpt_N``) each hold the model's
parameters and buffers, the optimizer, the LR scheduler, the step, the
experiment tracker and what the trainer adds (the generator states that
dropout draws from, a gradient-accumulation window), in
``<ckpt_dir>/<name>/state.pt``.  A save writes a temporary file and
renames it, so an interrupted save leaves the previous snapshot whole.
``load_pretrain`` is the non-strict warm start (stage 2 from a stage-1
checkpoint): by name and shape, as the JAX package's is by flax path and
shape.  ``reference_weights`` finds the reference's torch files
(``pytorch_model*.bin``) that ``utils/hf_import.import_query3d`` reads
for the other warm start.  The JAX package's orbax format is not ported.
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
             tracker: Dict[str, Any],
             extra: Optional[Dict[str, Any]] = None,
             model_state: Optional[Dict[str, Any]] = None,
             optimizer_state: Optional[Dict[str, Any]] = None) -> None:
        """``model_state`` / ``optimizer_state``, when given, are written in
        place of the objects' own state dicts (a sharded model's gathered
        state, ``parallel/mesh.Sharding``)."""
        path = self._path(name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        payload = {"model": (model.state_dict() if model_state is None
                             else model_state),
                   "optimizer": (optimizer.state_dict()
                                 if optimizer_state is None
                                 else optimizer_state),
                   "scheduler": scheduler.state_dict(),
                   "step": int(step), "tracker": dict(tracker),
                   **(extra or {})}
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)

    def restore(self, name: str, model, optimizer, scheduler
                ) -> Tuple[int, Dict[str, Any], Dict[str, Any]]:
        """Load ``name`` into the given objects; returns (step, tracker,
        the ``extra`` entries it was saved with)."""
        payload = torch.load(self._path(name), map_location="cpu",
                             weights_only=False)
        model.load_state_dict(payload.pop("model"))
        optimizer.load_state_dict(payload.pop("optimizer"))
        scheduler.load_state_dict(payload.pop("scheduler"))
        return payload.pop("step"), payload.pop("tracker"), payload

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
    is none."""
    for cand in (os.path.join(path, "latest", _FILE),
                 os.path.join(path, _FILE)):
        if os.path.isfile(cand):
            return cand
    if os.path.isfile(path) and os.path.basename(path) == _FILE:
        return path
    return None


def reference_weights(path: str) -> List[str]:
    """The reference's torch weight files that ``pretrain_ckpt_path``
    names, as the JAX trainer finds them: a directory's
    ``pytorch_model*.bin`` (sorted), or one ``.bin`` / ``.pth`` / ``.pt``
    file that is not a checkpoint of this package; [] when there is
    none."""
    if find_pretrain(path) is not None:
        return []
    if os.path.isdir(path):
        return sorted(glob.glob(os.path.join(path, "pytorch_model*.bin")))
    if path.endswith((".bin", ".pth", ".pt")) and os.path.isfile(path):
        return [path]
    return []


def load_reference_state_dict(files: List[str]) -> Dict[str, torch.Tensor]:
    """The merged state_dict of the reference's weight files (tensors
    only, read on the host)."""
    sd: Dict[str, torch.Tensor] = {}
    for f in files:
        sd.update(torch.load(f, map_location="cpu", weights_only=True))
    return sd
