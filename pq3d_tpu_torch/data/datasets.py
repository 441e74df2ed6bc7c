"""Scene sources and the batch loader for stage-1 training; counterpart of
``SyntheticInstSeg``, ``SceneVerseInstSeg`` (registered as
``ScanNetInstSegSceneVerse``), ``_assemble_instseg_batch`` and
``InstSegLoader`` in ``pq3d_tpu/data/datasets.py``.

Configs are plain dicts (``pq3d_tpu_torch/config.py``).  With
``num_workers=0`` the loader builds batches in the calling process from one
sequential rng per epoch; with ``num_workers > 0`` in a spawn pool
(``data/pool.py``), each batch from its own ``SeedSequence([seed, epoch,
b])``.  Both are the JAX loader's, so either gives the JAX package's
batches.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Iterator, Optional

import numpy as np

from pq3d_tpu_torch.data import synthetic
from pq3d_tpu_torch.data.instseg_pipeline import (InstSegPipelineConfig,
                                                  make_batch)
from pq3d_tpu_torch.data.pool import BatchPool


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


def load_pth(path: str):
    """A SceneVerse ``.pth`` payload (pickled tuples, dicts, numpy arrays
    and tensors) read on the CPU."""
    import torch
    return torch.load(path, map_location="cpu", weights_only=False)


class SceneVerseInstSeg:
    """ScanNet scans in the SceneVerse layout under
    ``cfg["data"]["scene_verse_base"]`` (raises ``FileNotFoundError``
    without it).  ``get_scene`` gives per-point continuous instance ids
    (-1 = background or not an object) and each instance's ScanNet200
    class: wall and floor (``filter_out_classes``) and empty instances are
    dropped, names the tsv cannot map keep ``ignore_label``, and instances
    are ordered by their raw id.  With ``load_scan_options``'
    ``load_image_segment_feat`` / ``load_point_segment_feat`` the scene
    carries the offline per-segment features ``mv_seg_fts`` / ``pc_seg_fts``
    from ``scene_verse_aux`` (default: the base).  Holds only paths and
    plain values, so the spawn pools can pickle it."""

    def __init__(self, cfg: Dict[str, Any], split: str):
        from pq3d_tpu_torch.data.label_utils import LabelConverter
        data = cfg["data"]
        base = data.get("scene_verse_base")
        if not base or not os.path.isdir(str(base)):
            raise FileNotFoundError(
                f"SceneVerse base dir not found: {base!r} (set "
                f"data.scene_verse_base, or use SyntheticInstSeg)")
        self.base = str(base)
        self.aux = str(data.get("scene_verse_aux") or self.base)
        self.split = split
        split_file = os.path.join(
            self.base, "ScanNet", "annotations", "splits",
            f"scannetv2_{'val' if split != 'train' else 'train'}.txt")
        with open(split_file) as f:
            self.scan_ids = [l.strip() for l in f if l.strip()]
        debug = cfg.get("debug") or {}
        if debug.get("flag"):
            self.scan_ids = self.scan_ids[:int(debug.get("debug_size", 4))]
        iopt = data.get("instseg_options") or {}
        self.filter_out_classes = set(iopt.get("filter_out_classes", (0, 2)))
        self.ignore_label = int(iopt.get("ignore_label", -100))
        opts = data.get("load_scan_options") or {}
        self.load_image_segment_feat = bool(
            opts.get("load_image_segment_feat", False))
        self.load_point_segment_feat = bool(
            opts.get("load_point_segment_feat", False))
        self.converter = LabelConverter(os.path.join(
            self.base, "ScanNet", "annotations", "meta_data",
            "scannetv2-labels.combined.tsv"))

    def __len__(self):
        return len(self.scan_ids)

    def get_scene(self, idx: int) -> Dict[str, np.ndarray]:
        scan_id = self.scan_ids[idx]
        sd = os.path.join(self.base, "ScanNet", "scan_data")
        pcds, colors, _, instance_labels = load_pth(os.path.join(
            sd, "pcd_with_global_alignment", f"{scan_id}.pth"))
        segment_id = load_pth(os.path.join(sd, "segment_id",
                                           f"{scan_id}.pth"))
        inst_to_label = load_pth(os.path.join(sd, "instance_id_to_label",
                                              f"{scan_id}.pth"))
        instance_labels = np.asarray(instance_labels)
        keep_ids, keep_labels = [], []
        for inst_id, name in inst_to_label.items():
            sem = self.converter.name_to_scannet200(str(name),
                                                    self.ignore_label)
            if sem in self.filter_out_classes:
                continue
            if not np.any(instance_labels == inst_id):
                continue
            keep_ids.append(int(inst_id))
            keep_labels.append(sem)
        remap = {v: i for i, v in enumerate(sorted(keep_ids))}
        order = np.argsort(keep_ids)
        inst = np.vectorize(lambda x: remap.get(int(x), -1))(instance_labels)
        scene = {
            "points": np.asarray(pcds, np.float32),
            "colors": np.asarray(colors, np.float32) / 127.5 - 1.0,
            "instance_labels": inst.astype(np.int64),
            "segment_id": np.asarray(segment_id, np.int64),
            "inst_labels": np.asarray(keep_labels, np.int64)[order],
            "scan_id": scan_id,
        }
        for flag, stem, key, out in (
                (self.load_image_segment_feat, "image_seg_feat",
                 "image_seg_feature", "mv_seg_fts"),
                (self.load_point_segment_feat, "point_seg_feat",
                 "point_seg_feature", "pc_seg_fts")):
            if flag:
                d = load_pth(os.path.join(self.aux, "ScanNet", stem,
                                          f"{scan_id}.pth"))
                scene[out] = np.asarray(d[key], np.float32)
        return scene


DATASETS = {"SyntheticInstSeg": SyntheticInstSeg,
            "ScanNetInstSegSceneVerse": SceneVerseInstSeg}


def build_dataset(cfg: Dict[str, Any], split: str):
    """The split's dataset by the config's name (``data.<split>[0]``)."""
    name = cfg["data"][split][0]
    if name not in DATASETS:
        raise NotImplementedError(
            f"dataset {name!r} is not ported; the port trains on "
            f"{sorted(DATASETS)}")
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


# worker-process state (set by the spawn initializer: the dataset is
# pickled once per worker, not once per batch)
_WORKER: Dict[str, Any] = {}


def _init_instseg_worker(dataset, pipe_cfg, extra_features):
    _WORKER["args"] = (dataset, pipe_cfg, extra_features)


def _instseg_worker_batch(idxs, seed_key, train):
    dataset, pipe_cfg, extra = _WORKER["args"]
    rng = np.random.default_rng(np.random.SeedSequence(seed_key))
    return _assemble_instseg_batch(dataset, pipe_cfg, extra, idxs, rng, train)


class InstSegLoader:
    """Batch iterator: dataset scenes -> host pipeline -> fixed batches.
    Callable(epoch) so the trainer reshuffles per epoch; eval pads the
    last batch by wrap-around and marks ``_meta['n_real']``.
    ``num_workers > 0`` builds the batches in an epoch-persistent spawn
    pool, each from ``SeedSequence([seed, epoch, b])``, in order; release
    it with ``close()``."""

    def __init__(self, dataset, pipe_cfg: InstSegPipelineConfig,
                 batch_size: int, train: bool, seed: int = 0,
                 extra_features: Optional[Dict[str, int]] = None,
                 num_workers: int = 0):
        self.dataset = dataset
        self.pipe_cfg = pipe_cfg
        self.batch_size = batch_size
        self.train = train
        self.seed = seed
        self.num_workers = num_workers
        self._pool = None
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
        if self.num_workers <= 0:
            for idxs, nr in zip(batches, n_real):
                batch = _assemble_instseg_batch(
                    self.dataset, self.pipe_cfg, self.extra_features, idxs,
                    rng, self.train)
                batch["_meta"]["n_real"] = nr
                yield batch
            return
        if self._pool is None:
            self._pool = BatchPool(self.num_workers, _init_instseg_worker,
                                   (self.dataset, self.pipe_cfg,
                                    self.extra_features))
        for batch, nr in zip(self._pool.run(
                _instseg_worker_batch,
                ((idxs, [self.seed, epoch, b], self.train)
                 for b, idxs in enumerate(batches))), n_real):
            batch["_meta"]["n_real"] = nr
            yield batch

    def close(self) -> None:
        """Shut the worker pool down (each worker holds a copy of the
        dataset)."""
        if self._pool is not None:
            self._pool.close()
            self._pool = None
