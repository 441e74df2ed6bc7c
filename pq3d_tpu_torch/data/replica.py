"""SceneVerse on-disk replica at real-scan statistics; copy of
``pq3d_tpu/data/replica.py``.

Writes the file formats of the SceneVerse/ScanNet distribution at
configurable scale, so the two-stage recipe runs end to end through
``python -m pq3d_tpu_torch.run`` without the real dataset.  The default
statistics are real ScanNet scans': about 150k surface points a scan,
0.02 m voxels giving about 60k voxels, 600+ segments, instances drawn from
the whole ScanNet200 label space, and 10-35-word captions.  From the same
``ReplicaSpec`` it writes the same files as the JAX writer.

Layout written (read by ``data/datasets.py`` and ``data/sceneverse.py``):

  <base>/ScanNet/scan_data/{pcd_with_global_alignment,segment_id,
                            instance_id_to_label}/<scan>.pth
  <base>/ScanNet/annotations/splits/scannetv2_{train,val}.txt
  <base>/ScanNet/annotations/meta_data/{scannetv2-labels.combined.tsv,
                                        scannetv2_raw_categories.json}
  <base>/ScanNet/annotations/refer/{scanrefer,sr3d,sr3d+,nr3d}.jsonl
  <base>/ScanNet/annotations/refer/multi3drefer_{train,val}.json
  <base>/ScanNet/annotations/qa/ScanQA_v1.0_{train,val}.json
  <base>/ScanNet/annotations/sqa_task/balanced/v1_balanced_*_scannetv2.json
  <pred>/ScanNet/mask/<scan>.mask.npz + <scan>.label.npy   (top-k proposals)
  <pred>/ScanNet/{image_obj_feat,voxel_obj_feat}_{gt,pred}/<scan>.pth
  <aux>/ScanNet/{image_seg_feat,point_seg_feat}/<scan>.pth
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional

import numpy as np

from pq3d_tpu_torch.data.scannet200_constants import (CLASS_LABELS_200,
                                                      HEAD_CATS_200,
                                                      RAW_ID_TO_200_ID,
                                                      VALID_CLASS_IDS_200)

# inverse of the benchmark's raw->200 map: one representative ScanNet raw
# id per ScanNet200 class (used to build a full-label-space tsv)
_ID200_TO_RAW = {}
for _raw, _k in RAW_ID_TO_200_ID.items():
    _ID200_TO_RAW.setdefault(_k, _raw)

_RELATIONS = ("next to", "near", "beside", "in front of", "behind",
              "to the left of", "to the right of", "across from", "under",
              "close to")
_ADJ = ("small", "large", "wooden", "red", "blue", "dark", "round",
        "square", "tall", "short", "white", "black", "modern", "old")
_FILLER = ("in the corner of the room", "against the far wall",
           "in the middle of the room", "when you enter the room",
           "on the side of the room closest to the door",
           "between the window and the door")


@dataclasses.dataclass
class ReplicaSpec:
    """Scale knobs; the defaults are real-scan statistics."""
    n_train: int = 6
    n_val: int = 3
    n_points: int = 150_000
    n_objects: int = 28          # plus wall/floor/ceiling instances
    extent: float = 4.6          # room side, meters (~21 m^2, ScanNet-typical)
    height: float = 2.7
    segment_size: float = 0.5    # supervoxel quantization -> ~600-1000
                                 # segments (per-instance split, real-scan
                                 # statistics; config max_segments=512 crops)
    n_anno_per_scan: int = 8     # per task
    mv_dim: int = 768            # image feature dims (configs expect 768)
    voxel_dim: int = 128
    seg_dim: int = 768
    seed: int = 0


def _box_surface(rng, center, size, n):
    p = (rng.random((n, 3)) - 0.5)
    face = rng.integers(0, 3, n)
    p[np.arange(n), face] = np.sign(p[np.arange(n), face]) * 0.5
    return (center + p * size).astype(np.float32)


_VOX = 0.02     # replica surfaces are dense at the instseg voxel size


def _lattice_patch(rng, axis, value, lo, hi, n_cells):
    """Contiguous axis-aligned surface patch: one point per 0.02 m lattice
    cell, rows packed in-order — so the occupied voxels are CONTIGUOUS and
    the stride-2 hierarchy collapses at real-scan ratios (L1 ~= L0/4 on
    surfaces; isolated-point sampling gives L1 ~= L0 and blows the shipped
    level_caps).  axis = the fixed dim; (lo, hi) bound the two free dims."""
    dims = [d for d in range(3) if d != axis]
    w = max(int((hi[0] - lo[0]) / _VOX), 1)
    h = max(int((hi[1] - lo[1]) / _VOX), 1)
    n_cells = min(n_cells, w * h)
    if n_cells <= 0:
        return np.zeros((0, 3), np.float32)
    idx = np.arange(n_cells)
    p = np.empty((n_cells, 3), np.float32)
    p[:, dims[0]] = lo[0] + (idx % w) * _VOX + rng.random(n_cells) * _VOX
    p[:, dims[1]] = lo[1] + (idx // w) * _VOX + rng.random(n_cells) * _VOX
    p[:, axis] = value + rng.standard_normal(n_cells).astype(np.float32) \
        * 0.003
    return p


def make_room_scan(rng: np.random.Generator, spec: ReplicaSpec) -> Dict:
    """One room: floor/ceiling/4 walls + box-surface furniture.

    Returns points (N,3) f32, colors (N,3) in [0,255], per-point instance
    ids (N,) with -100 clutter, segment ids (N,), and inst_to_label
    ({inst_id: raw category name}) — the exact payloads of the three
    scan_data .pth files."""
    E, H = spec.extent, spec.height
    n = spec.n_points
    # CELL budget (one lattice point per occupied 0.02 m voxel), scaled so
    # the default spec lands at real-scan voxel counts (~55-62k at 0.02 m,
    # under the shipped level_caps[0]=65536); points are then duplicated up
    # to n_points like real oversampled mesh vertices
    cell_budget = min(max(n // 3, 2000), 58_000)
    n_clut = int(cell_budget * 0.005)   # isolated noise never merges
                                        # down the hierarchy - keep rare
    c_floor = int(cell_budget * 0.25)
    c_ceil = int(cell_budget * 0.10)
    c_wall = int(cell_budget * 0.05)          # per wall
    pts: List[np.ndarray] = []
    inst: List[np.ndarray] = []
    inst_to_label: Dict[int, str] = {}

    def add(p, iid):
        pts.append(p.astype(np.float32))
        inst.append(np.full(len(p), iid, np.int64))

    def patch(axis, value, cells, iid):
        # random contiguous patch on a room plane
        lo_all = [0.0, 0.0, 0.0]
        hi_all = [E, E, H]
        dims = [d for d in range(3) if d != axis]
        lo = [lo_all[dims[0]], lo_all[dims[1]]]
        hi = [hi_all[dims[0]], hi_all[dims[1]]]
        add(_lattice_patch(rng, axis, value, lo, hi, cells), iid)

    iid = 0
    patch(2, 0.0, c_floor, iid)
    inst_to_label[iid] = "floor"
    iid += 1
    patch(2, H, c_ceil, iid)
    inst_to_label[iid] = "ceiling"
    iid += 1
    for axis, value in ((0, 0.0), (0, E), (1, 0.0), (1, E)):
        patch(axis, value, c_wall, iid)
        inst_to_label[iid] = "wall"
        iid += 1

    n_obj_pts = cell_budget - c_floor - c_ceil - 4 * c_wall - n_clut
    # head-heavy class draw over the FULL ScanNet200 space: common
    # furniture large and frequent, tail classes small and rare
    head_idx = [CLASS_LABELS_200.index(c) for c in HEAD_CATS_200
                if c in CLASS_LABELS_200 and c not in
                ("wall", "floor", "ceiling")]
    all_idx = [i for i, c in enumerate(CLASS_LABELS_200)
               if c not in ("wall", "floor", "ceiling")]
    centers = []
    specs = []
    for k in range(spec.n_objects):
        cls = (int(rng.choice(head_idx)) if rng.random() < 0.7
               else int(rng.choice(all_idx)))
        size = rng.random(3) * np.array([1.2, 1.2, 1.0]) + 0.25
        center = np.array([rng.random() * (E - 1.5) + 0.75,
                           rng.random() * (E - 1.5) + 0.75,
                           size[2] / 2 + 0.02])
        specs.append((cls, center, size))
    # cell shares proportional to surface area, normalized so every object
    # fits inside the cell budget (no object starves)
    weights = np.array([float(s.prod()) ** 0.5 for _, _, s in specs])
    shares = np.maximum(
        (weights / weights.sum() * n_obj_pts).astype(int), 400)
    for (cls, center, size), share in zip(specs, shares):
        centers.append((center, size))
        # dense lattice patches over the box's side faces + top
        faces = [(0, center[0] - size[0] / 2), (0, center[0] + size[0] / 2),
                 (1, center[1] - size[1] / 2), (1, center[1] + size[1] / 2),
                 (2, center[2] + size[2] / 2)]
        per_face = int(share) // len(faces)
        ps = []
        for axis, value in faces:
            dims = [d for d in range(3) if d != axis]
            lo = [center[dims[0]] - size[dims[0]] / 2,
                  center[dims[1]] - size[dims[1]] / 2]
            hi = [center[dims[0]] + size[dims[0]] / 2,
                  center[dims[1]] + size[dims[1]] / 2]
            ps.append(_lattice_patch(rng, axis, value, lo, hi, per_face))
        add(np.concatenate(ps), iid)
        inst_to_label[iid] = CLASS_LABELS_200[cls]
        iid += 1
    clut = rng.random((n_clut, 3)).astype(np.float32) * \
        np.array([E, E, H], np.float32)
    pts.append(clut)
    inst.append(np.full(n_clut, -100, np.int64))

    points = np.concatenate(pts)
    instance = np.concatenate(inst)
    # real scans oversample surfaces (mesh vertices cluster): duplicate
    # lattice points with sub-voxel jitter up to n_points — voxel count
    # stays ~= the cell budget while the point count matches real scans
    extra = max(n - len(points), 0)
    dup = rng.integers(0, len(points), extra)
    jit = rng.standard_normal((extra, 3)).astype(np.float32) * 0.002
    points = np.concatenate([points, points[dup] + jit])[:n]
    instance = np.concatenate([instance, instance[dup]])[:n]
    perm = rng.permutation(len(points))
    points, instance = points[perm], instance[perm]
    # colors keyed to instance for realistic segment/color correlation
    colors = (np.abs(np.sin(instance[:, None] * np.array([1.7, 2.3, 3.1])))
              * 200 + 27 + rng.standard_normal((len(points), 3)) * 8)
    colors = np.clip(colors, 0, 255).astype(np.float32)
    # supervoxel-ish segments: spatial quantization, split per instance —
    # ~(E/seg)^2 floor segments + per-object shells -> 500-1500 total
    q = np.floor(points / spec.segment_size).astype(np.int64)
    key = (q[:, 0] * 73856093 ^ q[:, 1] * 19349663 ^ q[:, 2] * 83492791
           ^ (instance + 7) * 2654435761) & 0x7FFFFFFF
    _, segment = np.unique(key, return_inverse=True)
    return {"points": points, "colors": colors, "instance": instance,
            "segment": segment.astype(np.int64),
            "inst_to_label": inst_to_label,
            "centers": centers}


# ---------------------------------------------------------------------------
# caption / question generators (10-35 word sentences over GT objects)
# ---------------------------------------------------------------------------


def _caption(rng, name, other_names) -> str:
    adj = rng.choice(_ADJ)
    rel = rng.choice(_RELATIONS)
    other = rng.choice(other_names) if len(other_names) else "wall"
    s = (f"this is a {adj} {name} . it is {rel} the {other} "
         f"{rng.choice(_FILLER)}")
    while len(s.split()) < 10:
        s += f" and {rng.choice(_RELATIONS)} the {rng.choice(other_names) if len(other_names) else 'door'}"
    return " ".join(s.split()[:35])


def _question(rng, name, other_names):
    other = rng.choice(other_names) if len(other_names) else "wall"
    kind = rng.integers(0, 3)
    if kind == 0:
        return f"what color is the {name} {rng.choice(_RELATIONS)} the {other} ?", [str(rng.choice(_ADJ))]
    if kind == 1:
        return f"what is {rng.choice(_RELATIONS)} the {other} ?", [name]
    return f"how many {name}s are in the room ?", [str(int(rng.integers(1, 4)))]


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------


def _write_tsv(meta_dir: str) -> List[str]:
    """Full ScanNet200 label space tsv + raw-categories json.

    Row-index order follows CLASS_LABELS_200 so cat2int(label.npy) indices
    equal ScanNet200 class ids; raw ids are the benchmark's
    VALID_CLASS_IDS_200 (RAW_ID_TO_200_ID inverse)."""
    cats = list(CLASS_LABELS_200) + ["ceiling"]
    with open(os.path.join(meta_dir, "scannetv2-labels.combined.tsv"),
              "w") as f:
        cols = ["id", "raw_category", "category", "count", "nyu40id",
                "eigen13id", "nyuClass", "nyu40class"]
        f.write("\t".join(cols) + "\n")
        for k, name in enumerate(CLASS_LABELS_200):
            raw = _ID200_TO_RAW.get(k, VALID_CLASS_IDS_200[k])
            f.write(f"{raw}\t{name}\t{name}\t10\t{min(k + 1, 40)}\t0\t"
                    f"{name}\t{name if k < 20 else 'otherprop'}\n")
        # ceiling exists in scans but is outside the 200 benchmark space
        f.write(f"41\tceiling\tceiling\t10\t22\t0\tceiling\tceiling\n")
    with open(os.path.join(meta_dir, "scannetv2_raw_categories.json"),
              "w") as f:
        json.dump(cats, f)
    return cats


def write_replica(base: str, pred: Optional[str] = None,
                  aux: Optional[str] = None,
                  spec: ReplicaSpec = ReplicaSpec()) -> List[str]:
    """Write the full replica; returns the scan ids."""
    import torch

    ann = os.path.join(base, "ScanNet", "annotations")
    sd = os.path.join(base, "ScanNet", "scan_data")
    for d in ("splits", "meta_data", "refer", "qa",
              os.path.join("sqa_task", "balanced")):
        os.makedirs(os.path.join(ann, d), exist_ok=True)
    for d in ("pcd_with_global_alignment", "segment_id",
              "instance_id_to_label"):
        os.makedirs(os.path.join(sd, d), exist_ok=True)

    cats = _write_tsv(os.path.join(ann, "meta_data"))
    cat2int = {c: i for i, c in enumerate(cats)}

    rng = np.random.default_rng(spec.seed)
    splits = {"train": [f"scene{i:04d}_00" for i in range(spec.n_train)],
              "val": [f"scene{i:04d}_00" for i in
                      range(spec.n_train, spec.n_train + spec.n_val)]}
    for split, ids in splits.items():
        with open(os.path.join(ann, "splits", f"scannetv2_{split}.txt"),
                  "w") as f:
            f.write("\n".join(ids) + "\n")

    refer, sr3d, nr3d = [], [], []
    multi = {"train": [], "val": []}
    qa = {"train": [], "val": []}
    sqa_q = {"train": [], "val": []}
    sqa_a = {"train": [], "val": []}
    qid = 0

    for split, ids in splits.items():
        for scan_id in ids:
            scan = make_room_scan(rng, spec)
            torch.save((scan["points"], scan["colors"], None,
                        scan["instance"].astype(np.float64)),
                       os.path.join(sd, "pcd_with_global_alignment",
                                    f"{scan_id}.pth"))
            torch.save(scan["segment"],
                       os.path.join(sd, "segment_id", f"{scan_id}.pth"))
            torch.save(scan["inst_to_label"],
                       os.path.join(sd, "instance_id_to_label",
                                    f"{scan_id}.pth"))
            i2l = scan["inst_to_label"]
            objs = [i for i, nm in i2l.items()
                    if nm not in ("wall", "floor", "ceiling")]
            names = {i: i2l[i] for i in objs}

            def others(i):
                return [names[j] for j in objs if j != i][:6]

            picks = rng.choice(objs, size=min(spec.n_anno_per_scan,
                                              len(objs)), replace=False)
            for t in picks:
                t = int(t)
                utt = _caption(rng, names[t], others(t))
                refer.append({"item_id": f"sr_{scan_id}_{t}",
                              "scan_id": scan_id, "target_id": t,
                              "instance_type": names[t], "utterance": utt})
                toks = utt.split()[:20]
                sr3d.append({"item_id": f"s3_{scan_id}_{t}",
                             "scan_id": scan_id, "target_id": t,
                             "utterance": utt, "tokens": toks})
                nr3d.append({"item_id": f"n3_{scan_id}_{t}",
                             "scan_id": scan_id, "target_id": t,
                             "utterance": "looking at the door , " + utt,
                             "tokens": ["looking", "at", "the", "door"]
                             + toks[:16]})
                # multi3drefer: mt (all same-class), st with/without
                # distractors, zt (no target)
                same = [j for j in objs if names[j] == names[t]]
                r = rng.random()
                if r < 0.2:
                    entry = {"scene_id": scan_id, "object_ids": [],
                             "description":
                                 f"the purple {names[t]} floating in the "
                                 f"air {rng.choice(_FILLER)}",
                             "eval_type": "zt_wo_d" if len(same) == 1
                             else "zt_w_d"}
                elif len(same) > 1 and r < 0.6:
                    entry = {"scene_id": scan_id,
                             "object_ids": [int(j) for j in same],
                             "description":
                                 f"all of the {names[t]}s in the room",
                             "eval_type": "mt"}
                else:
                    entry = {"scene_id": scan_id, "object_ids": [t],
                             "description": utt,
                             "eval_type": "st_w_d" if len(same) > 1
                             else "st_wo_d"}
                multi[split].append(entry)
                q, ans = _question(rng, names[t], others(t))
                qa[split].append({"scene_id": scan_id,
                                  "question_id": f"q{qid}", "question": q,
                                  "answers": ans, "object_ids": [t],
                                  "object_names": [names[t]]})
                sqa_q[split].append({
                    "scene_id": scan_id, "question_id": qid,
                    "situation": f"I am standing {rng.choice(_FILLER)} "
                                 f"facing the {rng.choice(others(t))}.",
                    "question": q})
                sqa_a[split].append({
                    "question_id": qid,
                    "answers": [{"answer": ans[0]}]})
                qid += 1

            if pred:
                _write_pred(pred, scan_id, scan, cat2int, rng, spec)
            if aux:
                _write_aux(aux, scan_id, scan, rng, spec)

    def _jsonl(path, rows):
        with open(path, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")

    _jsonl(os.path.join(ann, "refer", "scanrefer.jsonl"), refer)
    _jsonl(os.path.join(ann, "refer", "sr3d.jsonl"), sr3d)
    _jsonl(os.path.join(ann, "refer", "sr3d+.jsonl"), sr3d[:4])
    _jsonl(os.path.join(ann, "refer", "nr3d.jsonl"), nr3d)
    for split in ("train", "val"):
        with open(os.path.join(ann, "refer",
                               f"multi3drefer_{split}.json"), "w") as f:
            json.dump(multi[split], f)
        with open(os.path.join(ann, "qa",
                               f"ScanQA_v1.0_{split}.json"), "w") as f:
            json.dump(qa[split], f)
        with open(os.path.join(
                ann, "sqa_task", "balanced",
                f"v1_balanced_questions_{split}_scannetv2.json"), "w") as f:
            json.dump({"questions": sqa_q[split]}, f)
        with open(os.path.join(
                ann, "sqa_task", "balanced",
                f"v1_balanced_sqa_annotations_{split}_scannetv2.json"),
                "w") as f:
            json.dump({"annotations": sqa_a[split]}, f)
    return splits["train"] + splits["val"]


def _write_pred(pred: str, scan_id: str, scan: Dict, cat2int: Dict,
                rng, spec: ReplicaSpec) -> None:
    """Mask3D-style top-k proposals: perturbed GT masks + junk, and the
    per-object offline feature dicts."""
    import torch
    from scipy import sparse as sp

    mdir = os.path.join(pred, "ScanNet", "mask")
    os.makedirs(mdir, exist_ok=True)
    inst = scan["instance"]
    i2l = scan["inst_to_label"]
    objs = [i for i, nm in i2l.items()
            if nm not in ("wall", "floor", "ceiling")]
    masks, labels = [], []
    for i in objs:
        m = inst == i
        drop = rng.random(int(m.sum())) < 0.1      # 90% IoU-ish proposals
        mm = m.copy()
        mm[np.where(m)[0][drop]] = False
        masks.append(mm)
        labels.append(cat2int.get(i2l[i], 0))
    for _ in range(4):                              # junk proposals
        m = np.zeros(len(inst), bool)
        s = rng.integers(0, len(inst) - 600)
        m[s:s + 500] = True
        masks.append(m)
        labels.append(int(rng.integers(0, 20)))
    masks_a = np.stack(masks)
    sp.save_npz(os.path.join(mdir, f"{scan_id}.mask.npz"),
                sp.csr_matrix(masks_a))
    np.save(os.path.join(mdir, f"{scan_id}.label.npy"),
            np.asarray(labels, np.int64))

    n_pred = len(masks)
    for stem, dim in (("image_obj_feat", spec.mv_dim),
                      ("voxel_obj_feat", spec.voxel_dim)):
        for kind, keys in (("gt", objs), ("pred", list(range(n_pred)))):
            d = os.path.join(pred, "ScanNet", f"{stem}_{kind}")
            os.makedirs(d, exist_ok=True)
            torch.save({int(k): torch.from_numpy(
                rng.standard_normal(dim).astype(np.float32)) for k in keys},
                os.path.join(d, f"{scan_id}.pth"))


def _write_aux(aux: str, scan_id: str, scan: Dict, rng,
               spec: ReplicaSpec) -> None:
    import torch
    n_seg = int(scan["segment"].max()) + 1
    for stem, key in (("image_seg_feat", "image_seg_feature"),
                      ("point_seg_feat", "point_seg_feature")):
        d = os.path.join(aux, "ScanNet", stem)
        os.makedirs(d, exist_ok=True)
        torch.save({key: torch.from_numpy(rng.standard_normal(
            (n_seg, spec.seg_dim)).astype(np.float32))},
            os.path.join(d, f"{scan_id}.pth"))
