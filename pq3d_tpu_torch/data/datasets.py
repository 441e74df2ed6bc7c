"""Scene sources and the batch loader for stage-1 training; counterpart of
``SyntheticInstSeg``, ``_assemble_instseg_batch`` and ``InstSegLoader`` in
``pq3d_tpu/data/datasets.py``.

Configs are plain dicts (``pq3d_tpu_torch/config.py``).  The loader builds
batches in the calling process (``num_workers=0``): the same per-epoch
permutation, the same sequential rng and the same random mv/pc segment
features as the JAX loader, so both give identical batches.  The JAX
package's process pool and its SceneVerse reader are not ported.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Optional

import numpy as np

from pq3d_tpu_torch.data import synthetic
from pq3d_tpu_torch.data.instseg_pipeline import (InstSegPipelineConfig,
                                                  make_batch)


class SyntheticInstSeg:
    """Procedural scenes, deterministic per (split, index); sizes from
    ``cfg["data"]["synthetic"]``."""

    def __init__(self, cfg: Dict[str, Any], split: str):
        data_cfg = cfg["data"].get("synthetic") or {}
        n = {"train": 32, "val": 8, "test": 8}[split]
        debug = cfg.get("debug") or {}
        if debug.get("flag"):
            n = min(n, int(debug.get("debug_size", 4)))
        self.num_scenes = int(data_cfg.get(f"num_{split}", n))
        self.n_points = int(data_cfg.get("n_points", 4000))
        self.n_instances = int(data_cfg.get("n_instances", 8))
        self.n_segments = int(data_cfg.get("n_segments", 64))
        self.split = split
        self.seed = {"train": 0, "val": 10_000, "test": 20_000}[split]

    def __len__(self):
        return self.num_scenes

    def get_scene(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self.seed + idx)
        s = synthetic.make_scene(rng, n_points=self.n_points,
                                 n_instances=self.n_instances,
                                 n_segments=self.n_segments)
        s["inst_labels"] = np.minimum(s["inst_labels"], 199)
        s["scan_id"] = f"{self.split}_{idx:05d}"
        return s


DATASETS = {"SyntheticInstSeg": SyntheticInstSeg}


def build_dataset(cfg: Dict[str, Any], split: str):
    """The split's dataset by the config's name (``data.<split>[0]``)."""
    name = cfg["data"][split][0]
    if name not in DATASETS:
        raise NotImplementedError(
            f"dataset {name!r} is not ported; the port trains on "
            f"{sorted(DATASETS)} (set data.{split}=[SyntheticInstSeg])")
    return DATASETS[name](cfg, split)


def _assemble_instseg_batch(dataset, pipe_cfg: InstSegPipelineConfig,
                            extra_features: Dict[str, int], idxs,
                            rng: np.random.Generator,
                            train: bool) -> Dict[str, np.ndarray]:
    """One batch: scenes -> host pipeline -> fixed arrays (+ offline
    per-segment features, random-projected synthetics when the scenes
    carry none)."""
    scenes = [dataset.get_scene(int(i)) for i in idxs]
    batch = make_batch(scenes, pipe_cfg, rng, train)
    S = pipe_cfg.max_segments
    for name, dim in extra_features.items():
        key = f"{name}_seg_fts"
        feats = [s.get(key) for s in scenes]
        if feats[0] is None:
            srng = np.random.default_rng(int(idxs[0]))
            batch[key] = srng.standard_normal(
                (len(idxs), S, dim)).astype(np.float32)
        else:
            batch[key] = np.stack([
                np.pad(f[:S], ((0, max(0, S - len(f))), (0, 0)))
                for f in feats])
        batch[f"{name}_seg_pad_masks"] = batch["seg_pad_masks"]
    return batch


class InstSegLoader:
    """Batch iterator: dataset scenes -> host pipeline -> fixed batches.
    Callable(epoch) so the trainer reshuffles per epoch; eval pads the
    last batch by wrap-around and marks ``_meta['n_real']``."""

    def __init__(self, dataset, pipe_cfg: InstSegPipelineConfig,
                 batch_size: int, train: bool, seed: int = 0,
                 extra_features: Optional[Dict[str, int]] = None,
                 num_workers: int = 0):
        if num_workers > 0:
            raise NotImplementedError(
                "the process-pool loader is not ported: num_workers=0")
        self.dataset = dataset
        self.pipe_cfg = pipe_cfg
        self.batch_size = batch_size
        self.train = train
        self.seed = seed
        self.extra_features = extra_features or {"mv": 768, "pc": 768}

    def _batch_indices(self, epoch: int):
        rng = np.random.default_rng(self.seed + epoch)
        order = rng.permutation(len(self.dataset)) if self.train \
            else np.arange(len(self.dataset))
        bs = self.batch_size
        batches = [order[s:s + bs]
                   for s in range(0, len(order) - bs + 1, bs)]
        n_real = [bs] * len(batches)
        rem = len(order) - len(batches) * bs
        if rem and not self.train:
            batches.append(np.concatenate(
                [order[-rem:], np.resize(order, bs - rem)]))
            n_real.append(rem)
        return batches, n_real, rng

    def __call__(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        batches, n_real, rng = self._batch_indices(epoch)
        for idxs, nr in zip(batches, n_real):
            batch = _assemble_instseg_batch(
                self.dataset, self.pipe_cfg, self.extra_features, idxs, rng,
                self.train)
            batch["_meta"]["n_real"] = nr
            yield batch
