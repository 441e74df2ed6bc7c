"""Unified-task (stage-2) host pipeline: object-centric batches for
grounding / QA / captioning; copy of ``pq3d_tpu/data/unified_pipeline.py``
in both object layouts: padded, and flat (``flat_obj``: the batch's real
object clouds concatenated, with a slot map).

Per-object point sampling and normalization, the object crop that keeps
targets first, prompt/response assembly, BCE labels, fixed-shape padding.
The random draws are the JAX pipeline's, in the same order, so the same
rng gives bit-identical batches.  Task ids: 0 = refer, 1 = QA,
2 = caption.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from pq3d_tpu_torch.utils.box_utils import aabb_iou

# prompt type ids (the model reads them from here)
PROMPT_TXT = 1
PROMPT_IMAGE = 2
PROMPT_LOC = 3

TASK_REFER, TASK_QA, TASK_CAPTION = 0, 1, 2


@dataclasses.dataclass
class UnifiedPipelineConfig:
    max_obj_len: int = 80
    num_points: int = 1024
    prompt_len: int = 32
    response_len: int = 32
    rot_aug: bool = True
    dim_loc: int = 6
    # drop objects whose category is not mentioned in the sentence
    # (GT mode only)
    filter_lang: bool = False
    # flat-object layout: the pc memory ships as the concatenated real
    # object clouds (F, P, 6) with a (B, O) slot map instead of the padded
    # (B, O, P, 6) block, so PointNet++ runs on real objects only.  F is
    # rounded up to a rung of max(flat_obj_bucket, B*O/8) and capped at
    # B*O: at most about 9 distinct shapes at any batch size
    flat_obj: bool = False
    flat_obj_bucket: int = 64


def build_rotate_mat(rng: np.random.Generator) -> Optional[np.ndarray]:
    """Random z-rotation by multiples of 90 deg."""
    theta = rng.integers(0, 4) * np.pi / 2
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


def process_objects(obj_pcds: np.ndarray, rot: Optional[np.ndarray]):
    """Per-object center/size + unit-ball normalization.

    All xyz reductions run on a contiguous (n, P, 3) buffer — reducing the
    strided ``pcds[:, :, :3]`` view was a measured host hot spot (strided
    reductions defeat numpy's fast paths), as were the full-cloud ``copy``
    and the duplicated mean.
    """
    xyz = np.ascontiguousarray(obj_pcds[:, :, :3], dtype=np.float32)
    if rot is not None:
        xyz = xyz @ rot.T
    center = xyz.mean(1)
    mn, mx = xyz.min(1), xyz.max(1)
    size = mx - mn
    obj_locs = np.concatenate([center, size], axis=1)
    obj_boxes = np.concatenate([(mn + mx) / 2, size], axis=1)
    xyz -= center[:, None, :]
    max_dist = np.maximum(
        np.sqrt(np.einsum("opk,opk->op", xyz, xyz).max(1)), 1e-6)
    xyz /= max_dist[:, None, None]
    pcds = np.empty(obj_pcds.shape, np.float32)
    pcds[:, :, :3] = xyz
    pcds[:, :, 3:] = obj_pcds[:, :, 3:]
    return (pcds,
            obj_locs.astype(np.float32, copy=False),
            obj_boxes.astype(np.float32, copy=False))


def sample_object_points(scene: Dict[str, np.ndarray], num_points: int,
                         rng: np.random.Generator,
                         use_pred: bool = False) -> np.ndarray:
    """(n_obj, num_points, 6) xyz+rgb per object.  With ``use_pred`` the
    objects are the scene's predicted proposals (point-index lists, possibly
    overlapping) instead of the GT instance partition."""
    if use_pred:
        idx_lists = scene["pred_point_idx"]
        out = np.zeros((len(idx_lists), num_points, 6), np.float32)
        for i, m in enumerate(idx_lists):
            if len(m) == 0:
                continue
            pick = rng.choice(m, size=num_points,
                              replace=len(m) < num_points)
            out[i, :, :3] = scene["points"][pick]
            out[i, :, 3:] = scene["colors"][pick]
        return out
    n_inst = len(scene["inst_labels"])
    # one stable argsort (adaptive: ~free on the already-sorted labels real
    # scans have) + per-group permutation/fill, then ONE fancy-index gather
    # per channel block instead of per-object gathers.  Undersized groups
    # fall back to with-replacement fill (``replace=len<P``).
    inst = scene["instance_labels"]
    order = np.argsort(inst, kind="stable")
    bounds = np.searchsorted(inst[order], np.arange(n_inst + 1))
    cnt = np.diff(bounds)
    sel = np.zeros((n_inst, num_points), np.int64)
    for i in range(n_inst):
        c = cnt[i]
        if c == 0:
            continue
        g = order[bounds[i]:bounds[i + 1]]
        if c >= num_points:
            sel[i] = g[rng.permutation(c)[:num_points]]
        else:
            sel[i] = g[rng.integers(0, c, num_points)]
    out = np.empty((n_inst, num_points, 6), np.float32)
    out[:, :, :3] = scene["points"][sel]
    out[:, :, 3:] = scene["colors"][sel]
    out[cnt == 0] = 0.0
    return out


def make_bce_label(indices: Sequence[int], num_classes: int) -> np.ndarray:
    v = np.zeros(num_classes, np.float32)
    for i in indices:
        if 0 <= i < num_classes:
            v[i] = 1.0
    return v


def match_gt_to_pred(gt_boxes: np.ndarray, pred_boxes: np.ndarray,
                     thresholds: Sequence[float] = (0.25, 0.5)
                     ) -> List[np.ndarray]:
    """Per-threshold BCE vectors marking proposals that overlap ANY GT
    target box at >= threshold 3D IoU.

    gt_boxes (G, 6), pred_boxes (P, 6) as (center xyz, size whd).
    """
    p = len(pred_boxes)
    best = np.zeros(p, np.float32)
    for g in np.atleast_2d(gt_boxes):
        for j in range(p):
            best[j] = max(best[j], aabb_iou(np.asarray(g, np.float32),
                                            pred_boxes[j]))
    return [(best >= t).astype(np.float32) for t in thresholds]


def process_item(scene: Dict[str, np.ndarray], lang: Dict,
                 cfg: UnifiedPipelineConfig, rng: np.random.Generator,
                 train: bool, feature_dims: Dict[str, int]) -> Dict:
    """One (scene, language) item -> unpadded arrays.

    ``lang``: {task_id, prompt_tokens (TXT) , tgt_object_ids (list[int]),
               response_tokens, answers/captions metadata...}
    """
    O = cfg.max_obj_len
    task_id = lang["task_id"]
    tgt_ids = list(lang.get("tgt_object_ids", []))
    use_pred = bool(lang.get("use_pred")) and "pred_point_idx" in scene
    iou25_ids = list(lang.get("iou25_ids", tgt_ids))
    iou50_ids = list(lang.get("iou50_ids", tgt_ids))

    obj_pcds = sample_object_points(scene, cfg.num_points, rng, use_pred)
    all_labels = (scene["pred_inst_labels"] if use_pred
                  else scene["inst_labels"])
    n_obj = len(obj_pcds)

    # GT-mode object filter:
    # background categories (wall/floor/ceiling) and — with filter_lang —
    # categories not mentioned in the sentence are dropped, targets kept.
    # Predicted labels are never filtered (they are not reliable).
    bg_ids = scene.get("bg_label_ids")
    names = scene.get("inst_label_names")
    sentence = lang.get("meta_sentence", "")
    if not use_pred and (bg_ids or (cfg.filter_lang and names)):
        tgt_set = set(tgt_ids)
        keep0 = []
        for i in range(n_obj):
            if i in tgt_set:
                keep0.append(i)
                continue
            if bg_ids and int(all_labels[i]) in bg_ids:
                continue
            if cfg.filter_lang and names and names[i] not in sentence:
                continue
            keep0.append(i)
        if len(keep0) != n_obj:
            remap0 = {old: new for new, old in enumerate(keep0)}
            obj_pcds = obj_pcds[keep0]
            all_labels = np.asarray(all_labels)[keep0]
            tgt_ids = [remap0[t] for t in tgt_ids if t in remap0]
            iou25_ids = [remap0[t] for t in iou25_ids if t in remap0]
            iou50_ids = [remap0[t] for t in iou50_ids if t in remap0]
            n_obj = len(keep0)
            orig_idx = keep0
        else:
            orig_idx = list(range(n_obj))
    else:
        orig_idx = list(range(n_obj))

    # crop: targets + IoU-matched proposals first, then same-class objects,
    # then random fill
    if n_obj > O:
        keep = list(dict.fromkeys(tgt_ids + iou25_ids + iou50_ids))
        tgt_classes = {int(all_labels[t]) for t in tgt_ids
                       if t < len(all_labels)}
        rest = [i for i in range(n_obj) if i not in set(keep)]
        same = [i for i in rest if int(all_labels[i]) in tgt_classes]
        other = [i for i in rest if int(all_labels[i]) not in tgt_classes]
        rng.shuffle(other)
        keep = (keep + same + other)[:O]
        remap = {old: new for new, old in enumerate(keep)}
        obj_pcds = obj_pcds[keep]
        tgt_ids = [remap[t] for t in tgt_ids if t in remap]
        iou25_ids = [remap[t] for t in iou25_ids if t in remap]
        iou50_ids = [remap[t] for t in iou50_ids if t in remap]
        labels = np.asarray(all_labels)[keep]
        n_obj = O
    else:
        keep = list(range(n_obj))
        labels = np.asarray(all_labels)

    rot = build_rotate_mat(rng) if (train and cfg.rot_aug) else None
    obj_fts, obj_locs, obj_boxes = process_objects(obj_pcds, rot)

    item = {
        "obj_fts": obj_fts,
        "obj_locs": obj_locs,
        "obj_boxes": obj_boxes,
        "obj_labels": labels.astype(np.int32),
        "n_obj": n_obj,
        "task_id": task_id,
        "tgt_object_ids": tgt_ids,
        "iou25_ids": iou25_ids,
        "iou50_ids": iou50_ids,
        # GT target boxes for box-matched evaluation; meta_ keys travel
        # host-only beside the batch, never to the device
        "meta_tgt_obj_boxes": (obj_boxes[np.asarray(tgt_ids, np.int64)]
                               if tgt_ids else np.zeros((0, 6), np.float32)),
    }
    # offline per-object features, cropped consistently with the object list
    kind = "pred" if use_pred else "gt"
    keep_orig = [orig_idx[i] for i in keep]   # back to scene object space
    for mem in ("mv", "voxel"):
        feats = scene.get(f"{mem}_obj_feat_{kind}")
        if feats is not None:
            item[f"{mem}_fts"] = np.asarray(feats, np.float32)[keep_orig]

    # prompt
    if task_id == TASK_CAPTION:
        prompt = np.zeros(cfg.prompt_len, np.float32)
        tgt = tgt_ids[0] if tgt_ids else 0
        prompt[:cfg.dim_loc] = obj_locs[tgt, :cfg.dim_loc]
        prompt_valid = np.ones(cfg.prompt_len, bool)
        item["prompt_type"] = PROMPT_LOC
    else:
        toks = np.asarray(lang["prompt_tokens"], np.float32)[:cfg.prompt_len]
        prompt = np.zeros(cfg.prompt_len, np.float32)
        prompt[:len(toks)] = toks
        prompt_valid = np.zeros(cfg.prompt_len, bool)
        prompt_valid[:len(toks)] = True
        item["prompt_type"] = PROMPT_TXT
    item["prompt"] = prompt
    item["prompt_pad_masks"] = prompt_valid

    resp = np.asarray(lang.get("response_tokens", []), np.int32)
    resp = resp[:cfg.response_len]
    response = np.zeros(cfg.response_len, np.int32)
    response[:len(resp)] = resp
    item["response"] = response
    item["response_valid"] = response != 0

    # classifier-QA multihot
    if lang.get("answer_label") is not None:
        item["answer_label"] = np.asarray(lang["answer_label"], np.float32)

    # detected-proposal eval labels (legacy path): a language item may carry
    # raw GT target boxes instead of precomputed match lists
    gt_boxes = lang.get("gt_target_boxes")
    if gt_boxes is not None and len(gt_boxes):
        i25, i50 = match_gt_to_pred(np.asarray(gt_boxes, np.float32),
                                    obj_boxes)
        item["tgt_object_id_iou25"] = i25
        item["tgt_object_id_iou50"] = i50

    for k, v in lang.items():
        if k.startswith("meta_"):
            item[k] = v
    return item


def flat_obj_rows(total: int, b: int, max_obj: int, bucket_min: int) -> int:
    """Bucketed flat-object row count F for ``total`` real objects: the
    rung grows with the batch capacity (B*O/8, so at most 8 rungs) and F
    never exceeds the padded capacity B*O."""
    bucket = max(bucket_min, (b * max_obj + 7) // 8)
    return min(-(-max(total, 1) // bucket) * bucket, b * max_obj)


def collate_unified(items: List[Dict], cfg: UnifiedPipelineConfig,
                    feature_dims: Dict[str, int],
                    feature_fn=None, train: bool = True
                    ) -> Dict[str, np.ndarray]:
    """Pad + stack items into the stage-2 batch.  Queries = objects;
    seg_center = obj_locs.  Padded layout: ``obj_fts`` = ``pc_seg_fts``
    (B, O, P, 6); flat layout: ``pc_obj_flat`` (F, P, 6), zero past the
    real objects, and ``pc_flat_slot`` (B, O), each slot's row, F where it
    is padding."""
    b = len(items)
    O, P = cfg.max_obj_len, cfg.num_points
    batch: Dict[str, np.ndarray] = {
        "query_locs": np.zeros((b, O, 6), np.float32),
        "seg_center": np.zeros((b, O, 6), np.float32),
        "query_pad_masks": np.zeros((b, O), bool),
        "seg_pad_masks": np.zeros((b, O), bool),
        "obj_boxes": np.zeros((b, O, 6), np.float32),
        "obj_labels": np.full((b, O), -100, np.int32),
        "coord_min": np.zeros((b, 3), np.float32),
        "coord_max": np.zeros((b, 3), np.float32),
        "prompt": np.stack([it["prompt"] for it in items]),
        "prompt_pad_masks": np.stack([it["prompt_pad_masks"] for it in items]),
        "prompt_type": np.array([it["prompt_type"] for it in items]),
        "response": np.stack([it["response"] for it in items]),
        "response_valid": np.stack([it["response_valid"] for it in items]),
        "task_id": np.array([it["task_id"] for it in items]),
        "tgt_object_id": np.zeros((b, O), np.float32),
    }
    batch["tgt_object_id_iou25"] = np.zeros((b, O), np.float32)
    batch["tgt_object_id_iou50"] = np.zeros((b, O), np.float32)
    tgt_int = np.zeros(b, np.int32)
    # the padded point block is most of the batch's bytes: allocated
    # uninitialized, each item's pad tail zeroed
    if cfg.flat_obj:
        # n_obj <= O is guaranteed by process_item's truncation
        total = sum(it["n_obj"] for it in items)
        F = flat_obj_rows(total, b, O, cfg.flat_obj_bucket)
        batch["pc_obj_flat"] = np.empty((F, P, 6), np.float32)
        batch["pc_obj_flat"][total:] = 0.0
        # pad slots index the zero row the model appends at F
        batch["pc_flat_slot"] = np.full((b, O), F, np.int32)
        flat_row = 0
    else:
        batch["obj_fts"] = np.empty((b, O, P, 6), np.float32)
    for i, it in enumerate(items):
        n = it["n_obj"]
        if cfg.flat_obj:
            batch["pc_obj_flat"][flat_row:flat_row + n] = it["obj_fts"]
            batch["pc_flat_slot"][i, :n] = np.arange(
                flat_row, flat_row + n, dtype=np.int32)
            flat_row += n
        else:
            batch["obj_fts"][i, :n] = it["obj_fts"]
            batch["obj_fts"][i, n:] = 0.0
        batch["query_locs"][i, :n] = it["obj_locs"]
        batch["seg_center"][i, :n] = it["obj_locs"]
        batch["query_pad_masks"][i, :n] = True
        batch["seg_pad_masks"][i, :n] = True
        batch["obj_boxes"][i, :n] = it["obj_boxes"]
        batch["obj_labels"][i, :n] = it["obj_labels"][:n]
        batch["coord_min"][i] = it["obj_locs"][:, :3].min(0)
        batch["coord_max"][i] = it["obj_locs"][:, :3].max(0)
        batch["tgt_object_id"][i] = make_bce_label(it["tgt_object_ids"], O)
        batch["tgt_object_id_iou25"][i] = make_bce_label(
            it.get("iou25_ids", it["tgt_object_ids"]), O)
        batch["tgt_object_id_iou50"][i] = make_bce_label(
            it.get("iou50_ids", it["tgt_object_ids"]), O)
        tgt_int[i] = it["tgt_object_ids"][0] if it["tgt_object_ids"] else 0
        # legacy box-matched labels override the id-list ones when present
        for key in ("tgt_object_id_iou25", "tgt_object_id_iou50"):
            if key in it:
                batch[key][i, :len(it[key])] = it[key][:O]
    if not train:
        batch["tgt_object_id_int"] = tgt_int
    if all("answer_label" in it for it in items):
        batch["answer_label"] = np.stack([it["answer_label"]
                                          for it in items])
    # memories: pc = raw object points (PointNet++ on device); mv/voxel =
    # offline per-object features.  Real
    # per-item features (mv_fts/voxel_fts from the scan payloads) win over
    # the feature_fn hook / synthetic fallback.
    if not cfg.flat_obj:
        batch["pc_seg_fts"] = batch["obj_fts"]
    batch["pc_seg_pad_masks"] = batch["seg_pad_masks"]
    for name in ("mv", "voxel"):
        dim = feature_dims.get(name, 0)
        if not dim:
            continue
        if all(f"{name}_fts" in it for it in items):
            fts = np.zeros((b, O, items[0][f"{name}_fts"].shape[-1]),
                           np.float32)
            for i, it in enumerate(items):
                fts[i, :it["n_obj"]] = it[f"{name}_fts"][:O]
            batch[f"{name}_seg_fts"] = fts
        elif feature_fn is not None:
            batch[f"{name}_seg_fts"] = feature_fn(name, items, O, dim)
        else:
            # str hash() is salted per process — crc32 keeps the synthetic
            # fallback features identical across spawn-pool workers
            import zlib
            rng = np.random.default_rng(zlib.crc32(name.encode()))
            batch[f"{name}_seg_fts"] = rng.standard_normal(
                (b, O, dim)).astype(np.float32)
        batch[f"{name}_seg_pad_masks"] = batch["seg_pad_masks"]
    return batch
