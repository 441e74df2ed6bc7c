"""Instance-segmentation host pipeline: scene dict -> fixed-shape batch.

Counterpart of ``pq3d_tpu/data/instseg_pipeline.py``, trimmed to the
serving slice: color normalization, voxelization, FPS query sampling,
sparse kernel maps and the dense-block stem pack, collated into the
rectangular (B, ...) layout with host-built maps.  Augmentation and the
flat, compact, swin and device-maps layouts of the JAX package are not
ported.  Everything here is numpy; the batch it returns is bit-identical
to the JAX package's on the same scenes.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np

from pq3d_tpu_torch.ops import kernel_maps, sampling, voxelize, window_maps

COLOR_MEAN = np.array([0.47793125906962, 0.4303257521323044,
                       0.3749598901421883], np.float32)
COLOR_STD = np.array([0.2834475483823543, 0.27566157565723015,
                      0.27018971370874995], np.float32)


@dataclasses.dataclass
class InstSegPipelineConfig:
    voxel_size: float = 0.02
    num_queries: int = 120
    query_sample_strategy: str = "fps"      # the only one ported
    max_segments: int = 512
    max_instances: int = 120
    use_aug: bool = True                    # train-time only; not ported
    fps_subsample: int = 16384   # 0 = exact FPS
    voxel_bucket: int = 4096
    # hard per-level pads (static shapes across every batch)
    level_caps: Optional[Sequence[int]] = None
    filter_out_classes: Sequence[int] = (0, 2)
    ignore_label: int = -100
    # 'dense_block' packs level-0 voxels + features into dense 8^3 blocks so
    # conv0 runs as a dense conv (ops/sparse.conv0_dense_block); the only
    # stem the port ships
    stem_mode: str = "dense_block"
    stem_block: int = 8
    # fixed pad (in blocks) for the dense-block stem pack; with level_caps
    # and no explicit cap, level_caps[0] // 16 (bucketed) is used
    stem_block_cap: Optional[int] = None

    def __post_init__(self):
        if self.query_sample_strategy != "fps":
            raise ValueError(
                f"query_sample_strategy {self.query_sample_strategy!r} is not "
                "ported; the PyTorch pipeline samples queries by FPS")
        if self.stem_mode != "dense_block":
            raise ValueError(
                f"stem_mode {self.stem_mode!r} is not ported; the PyTorch "
                "pipeline ships the 'dense_block' stem only")

    def stem_pad_blocks(self, n_win_max: int) -> int:
        """Static block-pad for the dense stem pack (see stem_block_cap)."""
        cap = self.stem_block_cap
        if cap is None and self.level_caps:
            cap = window_maps.bucket(int(self.level_caps[0]) // 16)
        if cap is not None:
            if n_win_max <= cap:
                return cap
            warnings.warn(
                f"dense-block stem pack overflows stem_block_cap "
                f"({n_win_max} > {cap} occupied {self.stem_block}^3 "
                f"blocks); falling back to a bucketed pad for this batch",
                stacklevel=2)
        return window_maps.bucket(n_win_max)


def pipeline_config(options: Dict) -> InstSegPipelineConfig:
    """Pipeline config from a YAML ``data.instseg_options`` dict; keys the
    pipeline does not read (e.g. ``num_labels``) are ignored."""
    names = {f.name for f in dataclasses.fields(InstSegPipelineConfig)}
    return InstSegPipelineConfig(
        **{k: v for k, v in options.items() if k in names})


def _segment_centers(points, segment_id, num_segments):
    cnt = np.maximum(np.bincount(segment_id, minlength=num_segments), 1)
    sums = np.stack([np.bincount(segment_id, weights=points[:, c],
                                 minlength=num_segments) for c in range(3)],
                    axis=1)
    return (sums / cnt[:, None]).astype(np.float32)


def process_scene(scene: Dict[str, np.ndarray], cfg: InstSegPipelineConfig,
                  rng: np.random.Generator, train: bool = False
                  ) -> Dict[str, np.ndarray]:
    """One scene -> unpadded host arrays + sparse hierarchy (eval mode)."""
    if train and cfg.use_aug:
        raise NotImplementedError(
            "train-time augmentation is not ported; the PyTorch pipeline "
            "serves (train=False)")
    points = scene["points"].astype(np.float32)
    colors = scene["colors"].astype(np.float32)
    segment_id = scene["segment_id"]
    inst_point = scene["instance_labels"]
    inst_labels = scene["inst_labels"]

    # normalize color ((x+1)/2 maps [-1,1] -> [0,1] like the /255 path)
    color_n = ((colors + 1) / 2 - COLOR_MEAN) / COLOR_STD

    n_seg = int(segment_id.max()) + 1
    seg_center = _segment_centers(points, segment_id, n_seg)
    seg_sizes = np.bincount(segment_id, minlength=n_seg).astype(np.float32)

    n_inst = len(inst_labels)
    obj_center = np.zeros((n_inst, 3), np.float32)
    segment_masks = np.zeros((n_inst, n_seg), bool)
    own = (inst_point >= 0) & (inst_point < n_inst)
    if own.any():
        ip = inst_point[own]
        cnt = np.bincount(ip, minlength=n_inst).astype(np.float32)
        nz = cnt > 0
        for c in range(3):
            sums = np.bincount(ip, weights=points[own, c], minlength=n_inst)
            obj_center[nz, c] = (sums[nz] / cnt[nz]).astype(np.float32)
        pair = ip.astype(np.int64) * n_seg + segment_id[own]
        up = np.unique(pair)
        segment_masks[up // n_seg, up % n_seg] = True

    vox_coords, unique_map, inverse_map = voxelize.quantize(
        points, cfg.voxel_size)
    voxel_feats = color_n[unique_map]
    voxel2segment = segment_id[unique_map].astype(np.int32)

    fps_idx = sampling.fps_numpy(vox_coords.astype(np.float32),
                                 cfg.num_queries,
                                 subsample=cfg.fps_subsample, rng=rng)
    query_locs = points[unique_map][fps_idx]
    query_valid = np.ones(cfg.num_queries, bool)

    hierarchy = kernel_maps.build_hierarchy(
        vox_coords,
        pad_sizes=list(cfg.level_caps) if cfg.level_caps else None,
        bucket=cfg.voxel_bucket)

    full_instance_masks = np.stack(
        [inst_point == i for i in range(n_inst)]) if n_inst else \
        np.zeros((0, len(points)), bool)

    return {
        "points": points,
        "vox_coords": vox_coords,
        "voxel_feats": voxel_feats,
        "voxel2segment": voxel2segment,
        "voxel_to_full": inverse_map.astype(np.int32),
        "segment_to_full": segment_id.astype(np.int32),
        "full_instance_masks": full_instance_masks,
        "scan_id": scene.get("scan_id", ""),
        "hierarchy": hierarchy,
        "seg_center": seg_center,
        "seg_sizes": seg_sizes,
        "obj_center": obj_center,
        "query_locs": query_locs.astype(np.float32),
        "query_valid": query_valid,
        "coord_min": points.min(0),
        "coord_max": points.max(0),
        "instance_labels": inst_labels.astype(np.int32),
        "segment_masks": segment_masks,
    }


def collate(scenes: List[Dict[str, np.ndarray]],
            cfg: InstSegPipelineConfig) -> Dict[str, np.ndarray]:
    """Stack processed scenes into one fixed-shape rectangular batch with
    host-built maps (per-level pads: ``level_caps`` or the bucketed batch
    maximum) and the dense-block stem pack."""
    b = len(scenes)
    n_levels = kernel_maps.NUM_LEVELS
    if cfg.level_caps:
        # a scene that overflowed a cap was bucket-padded by build_hierarchy;
        # follow its pad so the batch buffers fit
        pad = [max(int(c), max(s["hierarchy"].pad_sizes[l] for s in scenes))
               for l, c in enumerate(cfg.level_caps)]
    else:
        pad = [max(s["hierarchy"].pad_sizes[l] for s in scenes)
               for l in range(n_levels)]
    S, M, Q = cfg.max_segments, cfg.max_instances, cfg.num_queries

    maps: Dict[str, np.ndarray] = {}
    for l in range(n_levels):
        maps[f"valid_{l}"] = np.zeros((b, pad[l]), bool)
        maps[f"nbr3_{l}"] = np.full((b, pad[l], 27), -1, np.int32)
    for l in range(n_levels - 1):
        maps[f"child_{l}"] = np.full((b, pad[l + 1], 8), -1, np.int32)
        maps[f"parent_{l}"] = np.full((b, pad[l]), -1, np.int32)
        maps[f"parent_off_{l}"] = np.zeros((b, pad[l]), np.int32)
    maps["ancestor"] = np.zeros((b, n_levels, pad[0]), np.int32)

    batch: Dict[str, List[np.ndarray]] = {k: [] for k in [
        "voxel_feats", "voxel2segment", "seg_center", "seg_pad_masks",
        "segment_sizes", "query_locs", "query_pad_masks", "coord_min",
        "coord_max", "instance_labels", "segment_masks", "instance_valid",
        "obj_center", "obj_pad_masks",
    ]}

    for i, s in enumerate(scenes):
        h: kernel_maps.SparseHierarchy = s["hierarchy"]
        nv = [min(n, p) for n, p in zip(h.num_voxels, pad)]
        for l in range(n_levels):
            maps[f"valid_{l}"][i, :nv[l]] = h.valid[l][:nv[l]]
            maps[f"nbr3_{l}"][i, :nv[l]] = h.nbr3[l][:nv[l]]
        for l in range(n_levels - 1):
            maps[f"child_{l}"][i, :nv[l + 1]] = h.child[l][:nv[l + 1]]
            maps[f"parent_{l}"][i, :nv[l]] = h.parent[l][:nv[l]]
            maps[f"parent_off_{l}"][i, :nv[l]] = h.parent_off[l][:nv[l]]
        maps["ancestor"][i, :, :nv[0]] = h.ancestor[:, :nv[0]]
        n0 = h.num_voxels[0]
        batch["voxel_feats"].append(
            kernel_maps.pad_rows(s["voxel_feats"], pad[0]))
        v2s = kernel_maps.pad_rows(s["voxel2segment"], pad[0], S)
        v2s[n0:] = S  # trash bucket
        batch["voxel2segment"].append(np.minimum(v2s, S))
        ns = len(s["seg_center"])
        batch["seg_center"].append(
            kernel_maps.pad_rows(s["seg_center"][:S], S))
        batch["seg_pad_masks"].append(
            kernel_maps.pad_rows(np.ones(min(ns, S), bool), S, False))
        batch["segment_sizes"].append(
            kernel_maps.pad_rows(s["seg_sizes"][:S], S, 0.0))
        batch["query_locs"].append(
            kernel_maps.pad_rows(s["query_locs"][:Q], Q))
        batch["query_pad_masks"].append(
            kernel_maps.pad_rows(s["query_valid"][:Q], Q, False))
        batch["coord_min"].append(s["coord_min"])
        batch["coord_max"].append(s["coord_max"])
        m = len(s["instance_labels"])
        batch["instance_labels"].append(
            kernel_maps.pad_rows(s["instance_labels"][:M], M, 0))
        sm = s["segment_masks"][:M, :S]
        sm = np.pad(sm, ((0, M - sm.shape[0]), (0, S - sm.shape[1])))
        batch["segment_masks"].append(sm)
        batch["instance_valid"].append(
            kernel_maps.pad_rows(np.ones(min(m, M), bool), M, False))
        no = len(s["obj_center"])
        batch["obj_center"].append(
            kernel_maps.pad_rows(s["obj_center"][:M], M))
        batch["obj_pad_masks"].append(
            kernel_maps.pad_rows(np.ones(min(no, M), bool), M, False))

    out = {k: np.stack(v) for k, v in batch.items()}
    out["maps"] = maps

    blk = cfg.stem_block
    b3 = blk ** 3
    packs = [window_maps.build_window_pack(
        s["vox_coords"], blk, 0, with_neighbors=True) for s in scenes]
    nb_pad = cfg.stem_pad_blocks(max(p["n_win"] for p in packs))
    cin = scenes[0]["voxel_feats"].shape[1]
    dense = np.zeros((b, nb_pad * b3, cin), np.float32)
    c2v = np.full((b, nb_pad * b3), -1, np.int32)
    slot = np.full((b, pad[0]), -1, np.int32)
    nbrblk = np.full((b, nb_pad, 27), -1, np.int32)
    for i, (s, p) in enumerate(zip(scenes, packs)):
        dense[i, p["vox_slot"]] = s["voxel_feats"]
        c2v[i, :len(p["cell_to_vox"])] = p["cell_to_vox"]
        slot[i, :len(p["vox_slot"])] = p["vox_slot"]
        nbrblk[i, :p["n_win"]] = p["nbr_win"]
    maps["stem_dense"] = dense.reshape(b, nb_pad, b3 * cin)
    maps["stem_c2v"] = c2v
    maps["stem_slot"] = slot
    maps["stem_nbrblk"] = nbrblk

    # host-only side channel: full-resolution reconstruction maps
    out["_meta"] = {
        "segment_to_full": [s["segment_to_full"] for s in scenes],
        "full_instance_masks": [s.get("full_instance_masks")
                                for s in scenes],
        "points": [s["points"] for s in scenes],
        "scan_id": [s.get("scan_id", "") for s in scenes],
    }
    return out


def collate_processed(processed: List[Dict[str, np.ndarray]],
                      cfg: InstSegPipelineConfig) -> Dict[str, np.ndarray]:
    """Single dispatch point for batching pre-processed scenes (the JAX
    package's layout switch; the port ships the rectangular layout)."""
    return collate(processed, cfg)


def make_batch(scenes: List[Dict[str, np.ndarray]],
               cfg: InstSegPipelineConfig,
               rng: np.random.Generator) -> Dict[str, np.ndarray]:
    processed = [process_scene(s, cfg, rng) for s in scenes]
    return collate_processed(processed, cfg)
