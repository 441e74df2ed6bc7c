"""Instance-segmentation host pipeline: scene dict -> fixed-shape batch.

Counterpart of ``pq3d_tpu/data/instseg_pipeline.py``: train-time
augmentation, color normalization, voxelization, query sampling (FPS, or
the GT object centres), sparse kernel maps, the stem's map (``stem_mode``:
the 125-tap ``nbr5_0`` of ``'gather'``, the JAX package's default, the
dense-block stem pack of ``'dense_block'``, or none, ``'none'``: the
Swin3D backbone's stem reads ``nbr3_0`` alone), the Swin3D window packs of
levels 1-4 (``swin_window``), and in GT-query mode the GT segment masks as
the decoder's offline attention masks.  Four layouts:

- rectangular (B, ...) with host-built maps (``collate``), optionally
  with the z-run plans of levels 1-3 (``ztriple_conv``);
- rectangular with maps built on the device (``device_maps``): the batch
  ships each scene's biased voxel coords and count, and the model's
  forward builds the maps (``ops/device_maps``) at the static level caps;
  ``process_scene`` then skips the hierarchy, and ``collate`` refuses a
  scene that outgrows a cap;
- the flat pack (``flat_pack``, ``collate_flat``): voxel-level arrays
  concatenate the scenes' true rows into one bucketed total per level,
  with the maps pre-offset, for single-device serving and training;
- the flat pack with maps built on the device (``device_maps`` +
  ``flat_pack``, ``collate_flat_device``): the batch ships the
  concatenated biased coords and the counts, the model builds the flat
  maps (``ops/device_flat_maps``) at a complete ``flat_shape_caps`` lock,
  and a batch that overflows the lock is refused here.

Two options shape the maps: ``level_cap_ladder`` (rectangular host maps
only) pads each batch to the first rung that holds its true per-level
maxima, one shape per rung; ``compact_conv`` (the flat pack only) adds
the tap-compacted conv plans ``cmp{l}_{in,out,sa,sb,src}`` of every
level (``ops/kernel_maps.build_compact_conv``).  Everything here is
numpy; the batch it returns is bit-identical to the JAX package's on the
same scenes and rng, with or without augmentation.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from pq3d_tpu_torch.ops import (device_flat_maps, kernel_maps, sampling,
                                voxelize, window_maps)
from pq3d_tpu_torch.ops.device_maps import (ZTRIPLE_LEVELS, bias_coords_16,
                                            stem_cap, swin_bias_align)

# hierarchy levels with Swin3D window packs
SWIN_LEVELS = (1, 2, 3, 4)
STEM_MODES = ("gather", "dense_block", "none")

COLOR_MEAN = np.array([0.47793125906962, 0.4303257521323044,
                       0.3749598901421883], np.float32)
COLOR_STD = np.array([0.2834475483823543, 0.27566157565723015,
                      0.27018971370874995], np.float32)


@dataclasses.dataclass
class InstSegPipelineConfig:
    voxel_size: float = 0.02
    num_queries: int = 120
    # 'fps' samples queries over the voxels; 'gt' puts query i at GT
    # object i's centre (valid only for the scene's instances)
    query_sample_strategy: str = "fps"
    max_segments: int = 512
    max_instances: int = 120
    use_aug: bool = True                    # train-time only
    # the gather stem's kernel: its nbr5_0 map has conv0_kernel^3 taps
    # (5, the reference Res16UNet34C's conv1_kernel_size; 3 is the JAX
    # package's faster deviation, 27 taps)
    conv0_kernel: int = 5
    fps_subsample: int = 16384   # 0 = exact FPS
    voxel_bucket: int = 4096
    # hard per-level pads (static shapes across every batch)
    level_caps: Optional[Sequence[int]] = None
    # rectangular host maps: ascending rungs of per-level pads; a batch
    # takes the first rung that holds its true per-level maxima (one shape
    # per rung), and a batch that fits none raises.  Overrides level_caps'
    # pads (the stem's block cap still derives from level_caps)
    level_cap_ladder: Optional[Sequence[Sequence[int]]] = None
    filter_out_classes: Sequence[int] = (0, 2)
    ignore_label: int = -100
    # 'gt' collates each scene's GT segment masks as ``offline_attn_mask``
    # (B, Q, S), True = attend: query i attends instance i's segments
    offline_mask_source: Optional[str] = None
    # 'gather' ships the 125-tap map nbr5_0 for conv0; 'dense_block' packs
    # level-0 voxels + features into dense 8^3 blocks so conv0 runs as a
    # dense conv (ops/sparse.conv0_dense_block); 'none' ships neither (the
    # swin3d backbone's stem reads nbr3_0 alone).  Under device_maps the
    # device builds the stem's maps (the model's device_stem, which must
    # equal this) and the host only counts a dense_block pack's blocks
    stem_mode: str = "gather"
    stem_block: int = 8
    # fixed pad (in blocks) for the host-built dense-block stem pack; with
    # level_caps and no explicit cap, level_caps[0] // 16 (bucketed) is
    # used, which is also the cap of the stem pack built on the device
    stem_block_cap: Optional[int] = None
    # flat layout: voxel-level arrays concatenate the scenes' true rows
    # (one bucketed total per level instead of B x the largest scene) and
    # the maps ship pre-offset with no batch dim, plus 'voxel_scene',
    # 'anc_local' and 'rect_{l}'; single device only
    flat_pack: bool = False
    # ship z-run plans (kernel_maps.build_ztriple_plan) for ZTRIPLE_LEVELS,
    # so the 3^3 convs that ops/sparse.ztriple_applicable claims run as 9
    # wide gathers instead of 27 (ops/sparse.sparse_conv_ztriple)
    ztriple_conv: bool = False
    # with flat_pack: also ship tap-compacted conv plans of every level's
    # 3^3 map (ops/kernel_maps.build_compact_conv), which the U-Net's
    # stride-1 convs then run (ops/sparse.sparse_conv_compact[_sym])
    compact_conv: bool = False
    # kernel maps built on the device (ops/device_maps): the batch ships
    # only biased voxel coords and counts beside the features, and
    # process_scene skips the hierarchy; needs static level_caps, and the
    # model built with voxel_enc.device_maps equal to them; collate refuses
    # a scene that outgrows them
    device_maps: bool = False
    # flat-pack shape lock: the least size of each batch-varying flat dim
    # ('tot_{l}', 'rect_{l}', 'win{l}s{j}_nw', 'stem_nb'), so batches
    # collate to one shape set; a batch that overflows a cap takes its
    # bucketed size (with a warning).  Under device_maps + flat_pack it is
    # the device maps' static shapes: it must name every dim, and a batch
    # that overflows it is refused.  Derive with flat_shape_caps_from
    flat_shape_caps: Optional[Dict[str, int]] = None
    # > 0 builds the Swin3D window packs (regular and shifted) of levels
    # 1-4 at this window (ops/window_maps), which the swin3d backbone needs
    swin_window: int = 0
    # under device_maps + flat_pack: count each batch's true flat dims on
    # the host (a ravel-key np.unique per scene and level) and refuse a
    # batch that overflows the lock, which the device build would drop
    # silently; turn off only for traffic known to fit
    device_flat_check: bool = True

    def __post_init__(self):
        if self.query_sample_strategy not in ("fps", "gt"):
            raise ValueError(
                f"query_sample_strategy {self.query_sample_strategy!r} is not "
                "'fps' or 'gt'")
        if self.offline_mask_source not in (None, "gt"):
            raise ValueError(
                f"offline_mask_source {self.offline_mask_source!r} is not "
                "None or 'gt'")
        if self.stem_mode not in STEM_MODES:
            raise ValueError(
                f"stem_mode {self.stem_mode!r} is not one of {STEM_MODES}")
        if self.device_maps and self.stem_block_cap is not None:
            raise ValueError(
                "device_maps builds the stem pack at static caps; "
                "stem_block_cap is for host maps only")
        if (self.device_maps and self.stem_mode == "dense_block"
                and self.stem_block != 8):
            # the device builds pack 8^3 blocks, and the host's overflow
            # count must count the blocks the device packs
            raise ValueError(
                f"device_maps packs the dense-block stem in 8^3 blocks; "
                f"stem_block {self.stem_block} is for host maps only")
        if self.device_maps and self.flat_pack:
            # the flat device maps' shapes are the lock: nothing to bucket
            # or grow against, so every flat dim must be named up front
            if self.compact_conv or self.level_cap_ladder:
                raise ValueError(
                    "device_maps + flat_pack supports neither compact_conv "
                    "nor level_cap_ladder (device shapes are compile-time)")
            if self.stem_mode not in ("none", "dense_block"):
                raise ValueError(
                    "device_maps + flat_pack needs stem_mode 'none' "
                    "(swin3d backbone) or 'dense_block' (res16unet); the "
                    "125-tap 'gather' stem has no flat device build")
            missing = device_flat_maps.flat_caps_complete(
                self.flat_shape_caps or {}, self.swin_window, SWIN_LEVELS,
                self.stem_mode)
            if missing:
                raise ValueError(
                    "device_maps + flat_pack needs a COMPLETE "
                    f"flat_shape_caps lock; missing {missing}: derive one "
                    "from a representative host-collated batch with "
                    "flat_shape_caps_from(batch['_meta']['flat_dims'], cfg)")
        elif self.device_maps:
            if not self.level_caps:
                raise ValueError(
                    "device_maps needs static level_caps (the device builds "
                    "every level at its cap)")
            if self.compact_conv or self.level_cap_ladder:
                raise ValueError(
                    "device_maps is a static-shape layout; unset "
                    "compact_conv / level_cap_ladder")
            if self.swin_window:
                raise ValueError(
                    "rectangular device_maps has no device swin-pack "
                    "builder; swin3d serves device maps in the flat layout "
                    "(flat_pack=True + flat_shape_caps)")

        if self.level_cap_ladder:
            if self.flat_pack:
                raise ValueError(
                    "level_cap_ladder is a rectangular-layout option; "
                    "collate_flat never pads to caps: unset one of "
                    "flat_pack / level_cap_ladder")
            # a short rung would pass the fit check on the levels it has
            for rung in self.level_cap_ladder:
                if len(rung) != kernel_maps.NUM_LEVELS:
                    raise ValueError(
                        f"level_cap_ladder rung {list(rung)} has "
                        f"{len(rung)} entries; expected "
                        f"{kernel_maps.NUM_LEVELS} (one per level)")
            # collate takes the first rung that fits, so a descending
            # ladder would pad every batch to rung 0
            for lo, hi in zip(self.level_cap_ladder,
                              self.level_cap_ladder[1:]):
                if any(a > b for a, b in zip(lo, hi)):
                    raise ValueError(
                        "level_cap_ladder rungs must be elementwise "
                        f"non-decreasing; got {list(lo)} before {list(hi)}")

    def flat_dim(self, name: str, computed: int) -> int:
        """Apply the flat shape lock to one batch-varying dimension."""
        cap = (self.flat_shape_caps or {}).get(name)
        if cap is None:
            return computed
        if computed > cap:
            warnings.warn(
                f"flat dim {name} overflows its shape cap ({computed} > "
                f"{cap}); taking the bucketed size for this batch. Raise "
                f"flat_shape_caps['{name}'].", stacklevel=2)
            return computed
        return int(cap)

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
    """Pipeline config from a YAML ``data.instseg_options`` dict, read as
    the JAX runner reads it (``level_cap_ladder`` as lists of ints); keys
    neither package reads (e.g. ``num_labels``) are ignored."""
    names = {f.name for f in dataclasses.fields(InstSegPipelineConfig)}
    kw = {k: v for k, v in options.items() if k in names}
    if kw.get("level_cap_ladder"):
        kw["level_cap_ladder"] = [[int(x) for x in rung]
                                  for rung in kw["level_cap_ladder"]]
    return InstSegPipelineConfig(**kw)


def _augment(points, colors, rng: np.random.Generator):
    """Train-time augmentation, the JAX package's ``_augment`` with the
    same rng calls in the same order: mean-center + random shift, x/y
    flips (p=0.5 each), per-axis scale +-10%, rotation around z +-pi and
    tilts around y/x +-pi/24, then brightness/contrast +-0.2 and RGB shift
    +-20/255 in the [0, 1] color domain (clipped after each)."""
    points = points - points.mean(0)
    points = points + rng.uniform(points.min(0), points.max(0)) / 2
    for i in (0, 1):
        if rng.random() < 0.5:
            points[:, i] = points[:, i].max() - points[:, i]
    points = points * rng.uniform(0.9, 1.1, size=3)
    for axis, lim in ((2, np.pi), (1, np.pi / 24), (0, np.pi / 24)):
        t = rng.uniform(-lim, lim)
        c, s = np.cos(t), np.sin(t)
        rot = {2: [[c, -s, 0], [s, c, 0], [0, 0, 1]],
               1: [[c, 0, s], [0, 1, 0], [-s, 0, c]],
               0: [[1, 0, 0], [0, c, -s], [0, s, c]]}[axis]
        points = points @ np.asarray(rot, np.float32).T
    x = (colors + 1) / 2
    x = np.clip(x * (1 + rng.uniform(-0.2, 0.2)) + rng.uniform(-0.2, 0.2),
                0, 1)
    x = np.clip(x + rng.uniform(-20 / 255, 20 / 255, size=3), 0, 1)
    colors = x * 2 - 1
    return points.astype(np.float32), colors.astype(np.float32)


def _segment_centers(points, segment_id, num_segments):
    cnt = np.maximum(np.bincount(segment_id, minlength=num_segments), 1)
    sums = np.stack([np.bincount(segment_id, weights=points[:, c],
                                 minlength=num_segments) for c in range(3)],
                    axis=1)
    return (sums / cnt[:, None]).astype(np.float32)


def process_scene(scene: Dict[str, np.ndarray], cfg: InstSegPipelineConfig,
                  rng: np.random.Generator, train: bool = False
                  ) -> Dict[str, np.ndarray]:
    """One scene -> unpadded host arrays + sparse hierarchy; ``train``
    augments (when ``cfg.use_aug``) and skips the full-resolution GT
    masks, which only evaluation reads."""
    points = scene["points"].astype(np.float32)
    colors = scene["colors"].astype(np.float32)
    segment_id = scene["segment_id"]
    inst_point = scene["instance_labels"]
    inst_labels = scene["inst_labels"]

    if train and cfg.use_aug:
        points, colors = _augment(points, colors, rng)

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

    if cfg.query_sample_strategy == "fps":
        fps_idx = sampling.fps_numpy(vox_coords.astype(np.float32),
                                     cfg.num_queries,
                                     subsample=cfg.fps_subsample, rng=rng)
        query_locs = points[unique_map][fps_idx]
        query_valid = np.ones(cfg.num_queries, bool)
    else:
        query_locs = obj_center
        query_valid = np.ones(len(obj_center), bool)

    # under a ladder the scene pads to buckets; collate picks the rung
    hierarchy = None
    if not cfg.device_maps:
        use_caps = cfg.level_caps and not cfg.level_cap_ladder
        hierarchy = kernel_maps.build_hierarchy(
            vox_coords,
            pad_sizes=list(cfg.level_caps) if use_caps else None,
            bucket=cfg.voxel_bucket)

    swin_packs = None
    if cfg.swin_window and not cfg.device_maps:
        swin_packs = window_maps.build_swin_packs(
            hierarchy.coords, cfg.swin_window, SWIN_LEVELS)

    full_instance_masks = None
    if not train:
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
        "swin_packs": swin_packs,
    }


def _scene_arrays(scenes: List[Dict[str, np.ndarray]],
                  cfg: InstSegPipelineConfig) -> Dict[str, np.ndarray]:
    """The arrays every layout ships rectangular (B, ...): segments,
    queries and instances, the GT-query ``offline_attn_mask``, and the
    host-only ``_meta`` side channel (full-resolution reconstruction)."""
    S, M, Q = cfg.max_segments, cfg.max_instances, cfg.num_queries
    batch: Dict[str, List[np.ndarray]] = {k: [] for k in [
        "seg_center", "seg_pad_masks", "segment_sizes", "query_locs",
        "query_pad_masks", "coord_min", "coord_max", "instance_labels",
        "segment_masks", "instance_valid", "obj_center", "obj_pad_masks",
    ]}
    for s in scenes:
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
    if cfg.offline_mask_source == "gt":
        oam = np.zeros((len(scenes), Q, S), bool)
        for i, s in enumerate(scenes):
            sm = s["segment_masks"][:Q, :S]
            oam[i, :sm.shape[0], :sm.shape[1]] = sm
        out["offline_attn_mask"] = oam
    out["_meta"] = {
        "segment_to_full": [s["segment_to_full"] for s in scenes],
        "full_instance_masks": [s.get("full_instance_masks")
                                for s in scenes],
        "points": [s["points"] for s in scenes],
        "scan_id": [s.get("scan_id", "") for s in scenes],
    }
    return out


def _unique_rows(c: np.ndarray) -> np.ndarray:
    """The distinct rows of non-negative (N, 3) int64 coords, in
    ascending lexicographic order."""
    d = c.max(0) + 1
    u = np.unique((c[:, 0] * d[1] + c[:, 1]) * d[2] + c[:, 2])
    return np.stack([u // (d[1] * d[2]), u // d[2] % d[1], u % d[2]], 1)


def device_map_counts(biased: np.ndarray, block: int = 8
                      ) -> Tuple[List[int], int]:
    """What the device build (``ops/device_maps``) finds in one scene's
    biased coords: its voxels per hierarchy level and its occupied
    ``block^3`` stem blocks (level log2(block)'s voxels when that is a
    level: the 8^3 blocks are level 3's)."""
    c = biased.astype(np.int64)
    counts = [len(c)]
    for _ in range(1, kernel_maps.NUM_LEVELS):
        c = _unique_rows(c >> 1)
        counts.append(len(c))
    lvl = block.bit_length() - 1
    if block == 1 << lvl and lvl < len(counts):
        return counts, counts[lvl]
    return counts, len(_unique_rows(biased.astype(np.int64) // block))


def _device_map_inputs(scenes: List[Dict[str, np.ndarray]],
                       cfg: InstSegPipelineConfig) -> Dict[str, np.ndarray]:
    """``vox_coords`` (B, cap0, 3) biased and ``n_voxels`` (B,) for the
    maps the model builds on the device.  Those maps have the caps' static
    shapes, so a scene that outgrew a level cap or the stem's block cap
    would lose rows there and its children would index the next scene's
    rows: such a scene is refused here (the rectangular layout with host
    maps bucket-pads it instead)."""
    caps = [int(c) for c in cfg.level_caps]
    nb_cap = stem_cap(caps)
    vox_coords = np.zeros((len(scenes), caps[0], 3), np.int32)
    n_voxels = np.zeros((len(scenes),), np.int32)
    for i, s in enumerate(scenes):
        biased = bias_coords_16(s["vox_coords"])[0]
        counts, nw = device_map_counts(biased, cfg.stem_block)
        if cfg.stem_mode != "dense_block":
            nw = 0                        # the device packs no stem blocks
        if any(n > c for n, c in zip(counts, caps)) or nw > nb_cap:
            raise ValueError(
                f"scene {s.get('scan_id', '')!r} outgrows the device maps' "
                f"static caps: {counts} voxels per level against level_caps "
                f"{caps}, {nw} stem blocks against {nb_cap}; raise "
                "level_caps or serve it with host maps")
        vox_coords[i, :counts[0]] = biased
        n_voxels[i] = counts[0]
    return {"vox_coords": vox_coords, "n_voxels": n_voxels}


def _host_maps(scenes: List[Dict[str, np.ndarray]],
               cfg: InstSegPipelineConfig, pad: List[int]
               ) -> Dict[str, np.ndarray]:
    """The scenes' host-built hierarchies at the per-level ``pad``, the
    stem's map (``stem_mode``: ``nbr5_0`` for 'gather', the dense-block
    stem pack for 'dense_block'), the swin packs
    (``swin_window``; each padded to the batch's bucketed window count)
    and, with ``ztriple_conv``, the z-run plans of ZTRIPLE_LEVELS, as (B,
    ...) maps."""
    b = len(scenes)
    n_levels = kernel_maps.NUM_LEVELS
    maps: Dict[str, np.ndarray] = {}
    for l in range(n_levels):
        maps[f"valid_{l}"] = np.zeros((b, pad[l]), bool)
        maps[f"nbr3_{l}"] = np.full((b, pad[l], 27), -1, np.int32)
    for l in range(n_levels - 1):
        maps[f"child_{l}"] = np.full((b, pad[l + 1], 8), -1, np.int32)
        maps[f"parent_{l}"] = np.full((b, pad[l]), -1, np.int32)
        maps[f"parent_off_{l}"] = np.zeros((b, pad[l]), np.int32)
    maps["ancestor"] = np.zeros((b, n_levels, pad[0]), np.int32)
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
    if cfg.ztriple_conv:
        for l in ZTRIPLE_LEVELS:
            base, codes = kernel_maps.build_ztriple_plan(
                maps[f"nbr3_{l}"].reshape(-1, 27), n_pad=pad[l])
            maps[f"zt{l}_base"] = base.reshape(b, pad[l], 9)
            maps[f"zt{l}_code"] = codes.reshape(b, pad[l], 9, 3)
    if cfg.swin_window:
        for l in SWIN_LEVELS:
            for j in (0, 1):
                key = f"win{l}s{j}"
                n_win_pad = window_maps.bucket(
                    max(s["swin_packs"][f"{key}_nwin"] for s in scenes))
                padded = [window_maps.pad_pack(
                    {"cell_to_vox": s["swin_packs"][f"{key}_c2v"],
                     "vox_slot": s["swin_packs"][f"{key}_slot"],
                     "n_win": s["swin_packs"][f"{key}_nwin"]},
                    cfg.swin_window, n_win_pad, pad[l]) for s in scenes]
                maps[f"{key}_c2v"] = np.stack(
                    [p["cell_to_vox"] for p in padded])
                maps[f"{key}_slot"] = np.stack(
                    [p["vox_slot"] for p in padded])
    if cfg.stem_mode == "gather":
        k = len(kernel_maps.kernel_offsets(cfg.conv0_kernel))
        nbr5 = np.empty((b, pad[0], k), np.int32)
        for i, s in enumerate(scenes):
            nbr5[i] = kernel_maps.build_neighbor_map(
                s["vox_coords"], cfg.conv0_kernel, n_pad=pad[0])
        maps["nbr5_0"] = nbr5
    if cfg.stem_mode != "dense_block":
        return maps

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
    return maps


def collate(scenes: List[Dict[str, np.ndarray]],
            cfg: InstSegPipelineConfig) -> Dict[str, np.ndarray]:
    """Stack processed scenes into one fixed-shape rectangular batch with
    host-built maps (per-level pads: the first ``level_cap_ladder`` rung
    that holds the batch's true per-level maxima, else ``level_caps``,
    else the bucketed batch maximum; ``_host_maps``).  A batch that fits
    no rung raises ``ValueError``.  Under ``device_maps`` the voxel
    arrays are padded to ``level_caps[0]`` and the batch ships each
    scene's biased coords (``vox_coords``, B x cap0 x 3) and count
    (``n_voxels``) with an empty ``maps``; a scene that outgrows the caps
    raises ``ValueError``."""
    out = _scene_arrays(scenes, cfg)
    if cfg.device_maps:
        out.update(_device_map_inputs(scenes, cfg))
        out["maps"] = {}
        pad0 = int(cfg.level_caps[0])
    else:
        if cfg.level_cap_ladder:
            true_max = [max(s["hierarchy"].num_voxels[l] for s in scenes)
                        for l in range(kernel_maps.NUM_LEVELS)]
            pad = next(([int(r) for r in rung]
                        for rung in cfg.level_cap_ladder
                        if all(t <= r for t, r in zip(true_max, rung))),
                       None)
            if pad is None:
                raise ValueError(
                    f"no level_cap_ladder rung fits batch voxel counts "
                    f"{true_max}; largest rung "
                    f"{list(cfg.level_cap_ladder[-1])}")
        elif cfg.level_caps:
            # a scene that overflowed a cap was bucket-padded by
            # build_hierarchy; follow its pad so the batch buffers fit
            pad = [max(int(c), max(s["hierarchy"].pad_sizes[l]
                                   for s in scenes))
                   for l, c in enumerate(cfg.level_caps)]
        else:
            pad = [max(s["hierarchy"].pad_sizes[l] for s in scenes)
                   for l in range(kernel_maps.NUM_LEVELS)]
        out["maps"] = _host_maps(scenes, cfg, pad)
        pad0 = pad[0]
    S = cfg.max_segments
    out["voxel_feats"] = np.stack([
        kernel_maps.pad_rows(s["voxel_feats"], pad0) for s in scenes])
    v2s = np.full((len(scenes), pad0), S, np.int32)  # pads: trash bucket
    for i, s in enumerate(scenes):
        v2s[i, :len(s["voxel2segment"])] = np.minimum(s["voxel2segment"], S)
    out["voxel2segment"] = v2s
    return out


def collate_flat(scenes: List[Dict[str, np.ndarray]],
                 cfg: InstSegPipelineConfig) -> Dict[str, np.ndarray]:
    """Flat-pack variant of :func:`collate` (``cfg.flat_pack``): voxel-level
    arrays concatenate the scenes' true rows, one total per level bucketed
    by ``voxel_bucket`` (then raised to ``flat_shape_caps``), with the maps
    offset into the flat rows; segment, query and instance arrays stay
    rectangular (B, ...).  Side arrays: ``voxel_scene`` (the scene of each
    level-0 row), ``anc_local`` (scene-local ancestors, 5 x N0) and
    ``rect_{l}`` (B, Pmax_l: each scene's flat rows of level l, -1 pad).
    The swin packs (``swin_window``) and the dense-block stem pack
    concatenate the scenes' packs, cells offset by the running window
    count and voxel ids by the level's starts; the gather stem's
    ``nbr5_0`` is offset as the ``nbr3`` maps are.  With ``compact_conv`` the
    maps add each level's compact conv plan (``cmp{l}_*``).
    ``_meta['flat_dims']`` holds each flat dim before the lock."""
    b = len(scenes)
    n_levels = kernel_maps.NUM_LEVELS
    hs = [s["hierarchy"] for s in scenes]
    counts = [[h.num_voxels[l] for h in hs] for l in range(n_levels)]
    starts = [np.concatenate([[0], np.cumsum(c)]).astype(np.int64)
              for c in counts]
    flat_dims: Dict[str, int] = {}

    def _dim(name: str, computed: int) -> int:
        flat_dims[name] = int(computed)
        return cfg.flat_dim(name, computed)

    tot = [_dim(f"tot_{l}", window_maps.bucket(int(starts[l][-1]),
                                               cfg.voxel_bucket))
           for l in range(n_levels)]

    maps: Dict[str, np.ndarray] = {}
    for l in range(n_levels):
        valid = np.zeros(tot[l], bool)
        valid[:starts[l][-1]] = True
        nbr = np.full((tot[l], 27), -1, np.int32)
        for i, h in enumerate(hs):
            n = counts[l][i]
            src = h.nbr3[l][:n]
            nbr[starts[l][i]:starts[l][i] + n] = np.where(
                src >= 0, src + starts[l][i], -1)
        maps[f"valid_{l}"] = valid
        maps[f"nbr3_{l}"] = nbr
    for l in range(n_levels - 1):
        child = np.full((tot[l + 1], 8), -1, np.int32)
        parent = np.full(tot[l], -1, np.int32)
        poff = np.zeros(tot[l], np.int32)
        for i, h in enumerate(hs):
            nf, nc = counts[l][i], counts[l + 1][i]
            cs = h.child[l][:nc]
            child[starts[l + 1][i]:starts[l + 1][i] + nc] = np.where(
                cs >= 0, cs + starts[l][i], -1)
            ps = h.parent[l][:nf]
            parent[starts[l][i]:starts[l][i] + nf] = np.where(
                ps >= 0, ps + starts[l + 1][i], -1)
            poff[starts[l][i]:starts[l][i] + nf] = h.parent_off[l][:nf]
        maps[f"child_{l}"] = child
        maps[f"parent_{l}"] = parent
        maps[f"parent_off_{l}"] = poff
    anc = np.zeros((n_levels, tot[0]), np.int32)
    anc_local = np.zeros((n_levels, tot[0]), np.int32)
    scene_id = np.zeros(tot[0], np.int32)
    for i, h in enumerate(hs):
        n0 = counts[0][i]
        sl = slice(starts[0][i], starts[0][i] + n0)
        scene_id[sl] = i
        for l in range(n_levels):
            a = h.ancestor[l, :n0]
            anc[l, sl] = a + starts[l][i]
            anc_local[l, sl] = a
    maps["ancestor"] = anc
    maps["anc_local"] = anc_local
    maps["voxel_scene"] = scene_id
    for l in range(n_levels):
        pmax = _dim(f"rect_{l}",
                    window_maps.bucket(max(counts[l]) if counts[l] else 1))
        rect = np.full((b, pmax), -1, np.int32)
        for i in range(b):
            rect[i, :counts[l][i]] = np.arange(
                starts[l][i], starts[l][i] + counts[l][i], dtype=np.int32)
        maps[f"rect_{l}"] = rect

    if cfg.swin_window:
        w3 = cfg.swin_window ** 3
        for l in SWIN_LEVELS:
            for j in (0, 1):
                key = f"win{l}s{j}"
                nwin = [int(s["swin_packs"][f"{key}_nwin"]) for s in scenes]
                wstart = np.concatenate([[0], np.cumsum(nwin)]).astype(
                    np.int64)
                nw_tot = _dim(f"{key}_nw",
                              window_maps.bucket(int(wstart[-1])))
                c2v = np.full(nw_tot * w3, -1, np.int32)
                slot = np.full(tot[l], -1, np.int32)
                for i, s in enumerate(scenes):
                    sc = s["swin_packs"][f"{key}_c2v"]
                    cell0 = wstart[i] * w3
                    c2v[cell0:cell0 + len(sc)] = np.where(
                        sc >= 0, sc + starts[l][i], -1)
                    slot[starts[l][i]:starts[l][i] + counts[l][i]] = \
                        s["swin_packs"][f"{key}_slot"] + cell0
                maps[f"{key}_c2v"] = c2v
                maps[f"{key}_slot"] = slot

    cin = scenes[0]["voxel_feats"].shape[1]
    if cfg.stem_mode == "dense_block":
        blk = cfg.stem_block
        b3 = blk ** 3
        packs = [window_maps.build_window_pack(
            s["vox_coords"], blk, 0, with_neighbors=True) for s in scenes]
        nwin = [p["n_win"] for p in packs]
        wstart = np.concatenate([[0], np.cumsum(nwin)]).astype(np.int64)
        nb_tot = _dim("stem_nb", window_maps.bucket(int(wstart[-1])))
        dense = np.zeros((nb_tot * b3, cin), np.float32)
        c2v = np.full(nb_tot * b3, -1, np.int32)
        slot = np.full(tot[0], -1, np.int32)
        nbrblk = np.full((nb_tot, 27), -1, np.int32)
        for i, (sc, pk) in enumerate(zip(scenes, packs)):
            cell0 = wstart[i] * b3
            dense[cell0 + pk["vox_slot"]] = sc["voxel_feats"]
            cv = pk["cell_to_vox"]
            c2v[cell0:cell0 + len(cv)] = np.where(cv >= 0,
                                                  cv + starts[0][i], -1)
            slot[starts[0][i]:starts[0][i] + counts[0][i]] = \
                pk["vox_slot"] + cell0
            nb = pk["nbr_win"]
            nbrblk[wstart[i]:wstart[i] + nwin[i]] = np.where(
                nb >= 0, nb + wstart[i], -1)
        maps["stem_dense"] = dense.reshape(nb_tot, b3 * cin)
        maps["stem_c2v"] = c2v
        maps["stem_slot"] = slot
        maps["stem_nbrblk"] = nbrblk
    elif cfg.stem_mode == "gather":
        nbr5 = np.full((tot[0], len(kernel_maps.kernel_offsets(
            cfg.conv0_kernel))), -1, np.int32)
        for i, s in enumerate(scenes):
            n0 = counts[0][i]
            m = kernel_maps.build_neighbor_map(s["vox_coords"],
                                               cfg.conv0_kernel)
            nbr5[starts[0][i]:starts[0][i] + n0] = np.where(
                m >= 0, m + starts[0][i], -1)
        maps["nbr5_0"] = nbr5

    S = cfg.max_segments
    vf = np.zeros((tot[0], cin), np.float32)
    v2s = np.full(tot[0], S, np.int32)
    for i, s in enumerate(scenes):
        sl = slice(starts[0][i], starts[0][i] + counts[0][i])
        vf[sl] = s["voxel_feats"]
        v2s[sl] = np.minimum(s["voxel2segment"], S)

    if cfg.ztriple_conv:
        for l in ZTRIPLE_LEVELS:
            maps[f"zt{l}_base"], maps[f"zt{l}_code"] = \
                kernel_maps.build_ztriple_plan(maps[f"nbr3_{l}"],
                                               n_pad=tot[l])
    if cfg.compact_conv:
        for l in range(n_levels):
            plan = kernel_maps.build_compact_conv(maps[f"nbr3_{l}"])
            for short, key in kernel_maps.COMPACT_MAP_KEYS:
                maps[f"cmp{l}_{short}"] = plan[key]

    out = _scene_arrays(scenes, cfg)
    out["maps"] = maps
    out["voxel_feats"] = vf
    out["voxel2segment"] = v2s
    out["_meta"]["flat_dims"] = flat_dims
    return out


def flat_shape_caps_from(dims: Dict[str, int], cfg: InstSegPipelineConfig,
                         margin: float = 1.3) -> Dict[str, int]:
    """A ``flat_shape_caps`` lock from one batch's flat dims
    (``batch['_meta']['flat_dims']``), scaled by ``margin`` and bucketed
    again (voxel totals by ``voxel_bucket``, the rest by 256)."""
    return {name: window_maps.bucket(
                int(n * margin),
                cfg.voxel_bucket if name.startswith("tot_") else 256)
            for name, n in dims.items()}


def collate_flat_device(scenes: List[Dict[str, np.ndarray]],
                        cfg: InstSegPipelineConfig
                        ) -> Dict[str, np.ndarray]:
    """The flat layout with maps built on the device
    (``ops/device_flat_maps``): the batch ships the concatenated biased
    voxel coords ``vox_coords`` (tot_0, 3), the per-scene counts
    ``n_voxels`` (B,) and the flat features, with an empty ``maps``; the
    model's forward builds the flat maps at ``cfg.flat_shape_caps`` (a
    complete lock, which ``__post_init__`` demands).

    Raises ``ValueError`` for a batch past the lock's ``tot_0``, for one
    whose scene-augmented key space would pass 2^32 (the JAX package's
    uint32 contract, kept although the port's keys are int64) and, with
    ``device_flat_check``, for one whose true flat dims overflow any cap:
    the device build would drop those rows into trash slots silently.
    ``_meta['flat_dims']`` holds the true dims."""
    caps = cfg.flat_shape_caps
    b = len(scenes)
    tot0 = int(caps["tot_0"])
    counts = np.array([len(s["vox_coords"]) for s in scenes], np.int32)
    total0 = int(counts.sum())
    if total0 > tot0:
        raise ValueError(
            f"batch has {total0} voxels > flat_shape_caps['tot_0'] {tot0}; "
            "the device flat shapes cannot grow: raise the lock (and "
            "rebuild the model with the same voxel_enc.device_flat_caps)")
    align = swin_bias_align(cfg.swin_window)
    cin = scenes[0]["voxel_feats"].shape[1]
    vox_coords = np.zeros((tot0, 3), np.int32)
    voxel_feats = np.zeros((tot0, cin), scenes[0]["voxel_feats"].dtype)
    v2s = np.full(tot0, cfg.max_segments, np.int32)
    r = 0
    for s in scenes:
        n = len(s["vox_coords"])
        vox_coords[r:r + n] = bias_coords_16(s["vox_coords"], align=align)[0]
        voxel_feats[r:r + n] = s["voxel_feats"]
        v2s[r:r + n] = np.minimum(s["voxel2segment"], cfg.max_segments)
        r += n
    dims = (vox_coords[:total0].max(0).astype(np.int64) + 3 if total0
            else np.array([3, 3, 3], np.int64))
    vol = int(dims[0] * dims[1] * dims[2])
    if (b + 1) * vol >= 2 ** 32:
        raise ValueError(
            f"scene-augmented key space overflow: {b} scenes x field "
            f"volume {vol} >= 2^32; split the batch or coarsen voxel_size")

    true_dims = {"tot_0": total0, "rect_0": int(counts.max())}
    if cfg.device_flat_check:
        bounds = np.concatenate([[0], np.cumsum(counts)])
        true_dims = _flat_device_true_dims(
            [vox_coords[a:z] for a, z in zip(bounds[:-1], bounds[1:])], cfg)
        over = {k: (v, caps[k]) for k, v in true_dims.items()
                if v > caps.get(k, 1 << 30)}
        if over:
            raise ValueError(
                "batch overflows the device flat shape lock: {name: (true, "
                f"cap)}} = {over}; the device build would drop rows "
                "silently: raise flat_shape_caps (and rebuild the model with "
                "the same device_flat_caps) or split the batch")

    out = _scene_arrays(scenes, cfg)
    out["maps"] = {}
    out["vox_coords"] = vox_coords
    out["n_voxels"] = counts
    out["voxel_feats"] = voxel_feats
    out["voxel2segment"] = v2s
    out["_meta"]["flat_dims"] = true_dims
    return out


def _flat_device_true_dims(scene_coords: List[np.ndarray],
                           cfg: InstSegPipelineConfig) -> Dict[str, int]:
    """True flat dims of a batch from its biased per-scene coords alone,
    as the device build finds them: one int64 ravel-key ``np.unique`` per
    (scene, level[, window shift]), no maps."""
    def _keys(c: np.ndarray) -> np.ndarray:
        if not len(c):
            return np.zeros(0, np.int64)
        d = c.max(0).astype(np.int64) + 1
        return (c[:, 0].astype(np.int64) * d[1] + c[:, 1]) * d[2] + c[:, 2]

    dims: Dict[str, int] = {}
    lvl = [np.asarray(c, np.int64) for c in scene_coords]
    for l in range(kernel_maps.NUM_LEVELS):
        dims[f"tot_{l}"] = sum(len(c) for c in lvl)
        dims[f"rect_{l}"] = max((len(c) for c in lvl), default=1)
        if cfg.swin_window and l in SWIN_LEVELS:
            w = cfg.swin_window
            for j, sh in enumerate((0, w // 2)):
                dims[f"win{l}s{j}_nw"] = sum(
                    len(np.unique(_keys((c + sh) // w))) for c in lvl)
        if l == 0 and cfg.stem_mode == "dense_block":
            dims["stem_nb"] = sum(
                len(np.unique(_keys(c // cfg.stem_block))) for c in lvl)
        if l < kernel_maps.NUM_LEVELS - 1:
            lvl = [_unique_rows(c >> 1) if len(c) else c for c in lvl]
    return dims


def device_flat_lock(scenes: List[Dict[str, np.ndarray]],
                     cfg: InstSegPipelineConfig, batch_size: int,
                     margin: float = 1.3) -> Dict[str, int]:
    """A device flat layout's lock, as the JAX package's serving bench
    derives it: ``collate_flat`` (``cfg``: the layout's host-maps twin) of
    the largest raw scene of ``scenes`` repeated ``batch_size`` times, then
    ``flat_shape_caps_from`` with ``margin``."""
    big = max(scenes, key=lambda s: len(s["points"]))
    probe = make_batch([dict(big) for _ in range(batch_size)], cfg,
                       np.random.default_rng(0))
    return flat_shape_caps_from(probe["_meta"]["flat_dims"], cfg, margin)


def collate_processed(processed: List[Dict[str, np.ndarray]],
                      cfg: InstSegPipelineConfig) -> Dict[str, np.ndarray]:
    """Single dispatch point for batching pre-processed scenes: the flat
    pack with host maps (``collate_flat``) or device maps
    (``collate_flat_device``), or the rectangular layout (``collate``,
    host or device maps)."""
    if cfg.flat_pack:
        if cfg.device_maps:
            return collate_flat_device(processed, cfg)
        return collate_flat(processed, cfg)
    return collate(processed, cfg)


def make_batch(scenes: List[Dict[str, np.ndarray]],
               cfg: InstSegPipelineConfig,
               rng: np.random.Generator,
               train: bool = False) -> Dict[str, np.ndarray]:
    processed = [process_scene(s, cfg, rng, train) for s in scenes]
    return collate_processed(processed, cfg)
