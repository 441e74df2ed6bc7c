"""Checkpoint save / resume with ``torch.save``; counterpart of the
``CheckpointManager`` in ``pq3d_tpu/train/checkpoints.py``.

Named snapshots (``latest``, ``best``, ``ckpt_N``) each hold the model's
parameters and buffers, the optimizer, the LR scheduler, the step and the
experiment tracker, in ``<ckpt_dir>/<name>/state.pt``.  A save writes a
temporary file and renames it, so an interrupted save leaves the previous
snapshot whole.  The JAX package's orbax format and its warm start from
reference ``.bin`` files are not ported.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import torch

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
