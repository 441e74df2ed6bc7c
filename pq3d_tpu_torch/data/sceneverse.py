"""SceneVerse task datasets over files in the SceneVerse layout; copy of
``pq3d_tpu/data/sceneverse.py``.

``SceneVerseScans`` loads a scan's ``.pth`` payloads (points, colors,
instances, segments), its GT objects with their boxes and category ids,
the top-k predicted proposals (sparse npz) with the GT -> proposal IoU
match lists, and the offline per-object ``mv`` / ``voxel`` features (gt
and pred).  The seven task datasets read their jsonl / json annotations
under ``<base>/ScanNet/annotations`` and follow the unified-loader
protocol: ``__len__`` and ``get_item(idx) -> (scene, lang)``, with the
prompt and response tokenizers the caller passes (``tokenizer=`` and
``gen_tokenizer=``; the synthetic tokenizer when none is given), and name
their evaluator as the synthetic datasets do.  Construction raises
``FileNotFoundError`` without the files.  Configs are plain dicts
(``pq3d_tpu_torch/config.py``).
"""
from __future__ import annotations

import json
import os
from collections import Counter
from functools import lru_cache
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from pq3d_tpu_torch.data.datasets import load_pth
from pq3d_tpu_torch.data.label_utils import AnswerVocab, LabelConverter
from pq3d_tpu_torch.data.tokenizers import SyntheticTokenize
from pq3d_tpu_torch.data.unified_pipeline import (TASK_CAPTION, TASK_QA,
                                                  TASK_REFER)
from pq3d_tpu_torch.utils.box_utils import aabb_iou

VIEW_DEP_WORDS = {
    "front", "behind", "back", "right", "left", "facing", "leftmost",
    "rightmost", "looking", "across"}


def is_explicitly_view_dependent(tokens: List[str]) -> bool:
    """Whether the utterance's tokens name a view-dependent relation."""
    return len(set(tokens).intersection(VIEW_DEP_WORDS)) > 0


def _read_jsonl(path: str) -> List[Dict]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


class SceneVerseScans:
    """Shared scan payload cache: points/colors/instances/segments per
    scan, loaded once per process.

    Carries what the unified tasks need: 607-class semantic ids per GT
    instance (raw-categories json), 18-class label counts for the
    unique/multiple split, GT axis-aligned boxes, optional top-50
    predicted proposals with GT<->pred IoU match lists and optional
    offline per-object mv/voxel features.
    """

    _cache: Dict[str, Dict] = {}

    def __init__(self, base_dir: str, pred_dir: Optional[str] = None,
                 load_options: Optional[Dict] = None):
        if not os.path.isdir(base_dir):
            raise FileNotFoundError(f"SceneVerse base not found: {base_dir}")
        self.base_dir = base_dir
        self.pred_dir = pred_dir
        self.load_options = dict(load_options or {})
        meta = os.path.join(base_dir, "ScanNet", "annotations", "meta_data")
        self.converter = LabelConverter(
            os.path.join(meta, "scannetv2-labels.combined.tsv"))
        cat_path = os.path.join(meta, "scannetv2_raw_categories.json")
        if os.path.exists(cat_path):
            with open(cat_path, encoding="utf-8") as f:
                self.int2cat: List[str] = json.load(f)
        else:
            self.int2cat = []
        self.cat2int = {w: i for i, w in enumerate(self.int2cat)}

    def split_scan_ids(self, split: str) -> List[str]:
        name = "val" if split != "train" else "train"
        path = os.path.join(self.base_dir, "ScanNet", "annotations", "splits",
                            f"scannetv2_{name}.txt")
        with open(path) as f:
            return [l.strip() for l in f if l.strip()]

    def _label_id(self, name: str) -> int:
        """607-class raw-category id; ScanNet200 id fallback without the
        categories json."""
        if self.cat2int:
            return self.cat2int.get(name, -1)
        return self.converter.name_to_scannet200(name, -1)

    def _count_key(self, label_id: int):
        """label_count key: 18-class benchmark id when the tsv is present,
        else the raw id."""
        if self.converter.has_tsv and self.converter.id_to_scannetid:
            return self.converter.id_to_scannetid.get(int(label_id), -1)
        return int(label_id)

    def load(self, scan_id: str) -> Dict:
        if scan_id in self._cache:
            return self._cache[scan_id]
        sd = os.path.join(self.base_dir, "ScanNet", "scan_data")
        pcds, colors, _, instance_labels = load_pth(os.path.join(
            sd, "pcd_with_global_alignment", f"{scan_id}.pth"))
        segment_id = load_pth(os.path.join(sd, "segment_id",
                                           f"{scan_id}.pth"))
        inst_to_label = load_pth(os.path.join(sd, "instance_id_to_label",
                                              f"{scan_id}.pth"))
        instance_labels = np.asarray(instance_labels)
        points = np.asarray(pcds, np.float32)
        # GT objects: only instances whose name is a known category and that
        # have points
        inst_ids = sorted(
            int(i) for i in inst_to_label
            if self._label_id(str(inst_to_label[i])) >= 0
            and np.any(instance_labels == int(i)))
        remap = {v: i for i, v in enumerate(inst_ids)}
        inst = np.vectorize(lambda x: remap.get(int(x), -1))(instance_labels)
        names = [str(inst_to_label[i]) for i in inst_ids]
        labels = np.array([self._label_id(n) for n in names], np.int64)
        # GT axis-aligned boxes
        n = len(inst_ids)
        center = np.zeros((n, 3), np.float32)
        size = np.zeros((n, 3), np.float32)
        for i in range(n):
            m = inst == i
            if m.any():
                p = points[m]
                mn, mx = p.min(0), p.max(0)
                center[i] = (mn + mx) / 2
                size[i] = mx - mn
        scene = {
            "points": points,
            "colors": np.asarray(colors, np.float32) / 127.5 - 1.0,
            "instance_labels": inst.astype(np.int64),
            "segment_id": np.asarray(segment_id, np.int64),
            "inst_labels": labels,
            "inst_label_names": names,
            "inst_raw_ids": inst_ids,
            "label_count": Counter(self._count_key(l) for l in labels),
            "gt_center": center,
            "gt_size": size,
            # background categories excluded from the GT object list unless
            # targeted
            "bg_label_ids": {self._label_id(n)
                             for n in ("wall", "floor", "ceiling")
                             if self._label_id(n) >= 0},
            "scan_id": scan_id,
        }
        self._load_pred_proposals(scene, scan_id)
        self._load_offline_obj_feats(scene, scan_id)
        self._cache[scan_id] = scene
        return scene

    def _load_pred_proposals(self, scene: Dict, scan_id: str) -> None:
        """Top-50 Mask3D proposals from sparse npz + labels npy, plus
        GT->pred IoU match lists."""
        if not self.pred_dir:
            return
        mask_path = os.path.join(self.pred_dir, "ScanNet", "mask",
                                 f"{scan_id}.mask.npz")
        if not os.path.exists(mask_path):
            return
        from scipy import sparse as sp
        topk = int(self.load_options.get("pred_topk", 50))
        masks = np.asarray(sp.load_npz(mask_path).todense(),
                           dtype=bool)[:topk]
        plabels = np.load(os.path.join(self.pred_dir, "ScanNet", "mask",
                                       f"{scan_id}.label.npy"))[:topk]
        points = scene["points"]
        idx_lists, keep_labels = [], []
        for i in range(masks.shape[0]):
            idx = np.nonzero(masks[i])[0]
            if len(idx) == 0:
                continue
            idx_lists.append(idx.astype(np.int64))
            keep_labels.append(int(plabels[i]))
        p = len(idx_lists)
        center = np.zeros((p, 3), np.float32)
        size = np.zeros((p, 3), np.float32)
        for i, idx in enumerate(idx_lists):
            pt = points[idx]
            mn, mx = pt.min(0), pt.max(0)
            center[i] = (mn + mx) / 2
            size[i] = mx - mn
        scene["pred_point_idx"] = idx_lists
        scene["pred_inst_labels"] = np.asarray(keep_labels, np.int64)
        scene["pred_center"] = center
        scene["pred_size"] = size
        # per-GT best match + IoU>=0.25/0.5 lists
        matched, iou25, iou50 = [], [], []
        for g in range(len(scene["gt_center"])):
            gt_box = np.concatenate([scene["gt_center"][g],
                                     scene["gt_size"][g]])
            best, best_i, l25, l50 = -1.0, 0, [], []
            for j in range(p):
                pb = np.concatenate([center[j], size[j]])
                iou = aabb_iou(gt_box, pb)
                if iou > best:
                    best, best_i = iou, j
                if iou >= 0.25:
                    l25.append(j)
                if iou >= 0.5:
                    l50.append(j)
            matched.append(best_i)
            iou25.append(l25)
            iou50.append(l50)
        scene["matched_list"] = matched
        scene["iou25_list"] = iou25
        scene["iou50_list"] = iou50

    def _load_offline_obj_feats(self, scene: Dict, scan_id: str) -> None:
        """Per-object mv (image) / voxel features, gt + pred variants."""
        if not self.pred_dir:
            return
        for mem, stem in (("mv", "image_obj_feat"), ("voxel",
                                                     "voxel_obj_feat")):
            if not self.load_options.get(f"load_{stem}", False):
                continue
            for kind in ("gt", "pred"):
                path = os.path.join(self.pred_dir, "ScanNet",
                                    f"{stem}_{kind}", f"{scan_id}.pth")
                if not os.path.exists(path):
                    continue
                feat_dict = load_pth(path)
                dim = int(next(iter(feat_dict.values())).shape[0])
                if kind == "gt":
                    n_obj = len(scene["inst_raw_ids"])
                    keys = scene["inst_raw_ids"]
                else:
                    n_obj = len(scene.get("pred_point_idx", []))
                    keys = list(range(n_obj))
                feat = np.zeros((n_obj, dim), np.float32)
                for i, cid in enumerate(keys):
                    if cid in feat_dict:
                        feat[i] = np.asarray(feat_dict[cid], np.float32)
                scene[f"{mem}_obj_feat_{kind}"] = feat


class _SceneVerseTask:
    task_id = TASK_REFER
    evaluator = "ScanReferEval"

    def __init__(self, cfg, split: str, tokenizer: Optional[Callable] = None,
                 gen_tokenizer: Optional[Callable] = None):
        if split == "test":
            split = "val"
        self.split = split
        self.cfg = cfg
        node = cfg["data"].get(type(self).__name__) or {}
        self.pc_type = str(node.get("pc_type",
                                    cfg["data"].get("pc_type", "gt")))
        # training uses GT boxes even in pred configs: a dataset's
        # pc_type applies at val/test only
        if self.split == "train":
            self.pc_type = "gt"
        self.scans = SceneVerseScans(
            str(cfg["data"]["scene_verse_base"]),
            pred_dir=(str(cfg["data"]["scene_verse_pred"])
                      if cfg["data"].get("scene_verse_pred") else None),
            load_options=dict(cfg["data"].get("load_scan_options") or {}))
        self.tokenizer = tokenizer or SyntheticTokenize(32)
        self.gen_tokenizer = gen_tokenizer or self.tokenizer
        self.lang_data = self._load_lang()

    def _resolve_targets(self, scene: Dict, gt_tgt_ids: List[int]) -> Dict:
        """GT target ids -> object-group-local ids + IoU25/50 eval id
        lists.  In pred mode the targets become
        the best-IoU-matched proposals and the IoU lists mark every
        proposal overlapping any GT target at >= threshold."""
        if self.pc_type == "pred" and "matched_list" in scene:
            iou25 = sorted({j for i in gt_tgt_ids
                            for j in scene["iou25_list"][i]})
            iou50 = sorted({j for i in gt_tgt_ids
                            for j in scene["iou50_list"][i]})
            tgts = [scene["matched_list"][i] for i in gt_tgt_ids]
            out = {"tgt_object_ids": tgts, "iou25_ids": iou25,
                   "iou50_ids": iou50, "use_pred": True}
            if gt_tgt_ids:
                g, m = gt_tgt_ids[0], tgts[0]
                out["meta_iou"] = float(aabb_iou(
                    np.concatenate([scene["gt_center"][g],
                                    scene["gt_size"][g]]),
                    np.concatenate([scene["pred_center"][m],
                                    scene["pred_size"][m]])))
            return out
        return {"tgt_object_ids": list(gt_tgt_ids),
                "iou25_ids": list(gt_tgt_ids),
                "iou50_ids": list(gt_tgt_ids), "use_pred": False}

    def _anno(self, *parts) -> str:
        return os.path.join(self.scans.base_dir, "ScanNet", "annotations",
                            *parts)

    def _load_lang(self) -> List[Dict]:
        raise NotImplementedError

    def __len__(self):
        return len(self.lang_data)

    def _target_local_id(self, scene: Dict, raw_target_id: int) -> int:
        try:
            return scene["inst_raw_ids"].index(int(raw_target_id))
        except ValueError:
            return 0

    def _same_class_count(self, scene: Dict, gt_tgt_ids: List[int]) -> int:
        """Count of scene objects sharing any target's (benchmark-space)
        class."""
        return sum(scene["label_count"][
            self.scans._count_key(int(scene["inst_labels"][t]))]
            for t in gt_tgt_ids if t < len(scene["inst_labels"]))

    def get_item(self, idx: int) -> Tuple[Dict, Dict]:
        raise NotImplementedError


class ScanReferSceneVerse(_SceneVerseTask):
    """ScanRefer: one referred object per utterance."""
    task_id = TASK_REFER
    evaluator = "ScanReferEval"

    def _load_lang(self):
        ids = set(self.scans.split_scan_ids(self.split))
        return [x for x in _read_jsonl(self._anno("refer", "scanrefer.jsonl"))
                if x["scan_id"] in ids]

    def get_item(self, idx):
        item = self.lang_data[idx]
        scene = self.scans.load(item["scan_id"])
        tgt = self._target_local_id(scene, item["target_id"])
        same = self._same_class_count(scene, [tgt])
        lang = {
            "task_id": TASK_REFER,
            "prompt_tokens": self.tokenizer(item["utterance"]),
            "response_tokens": [],
            "meta_is_multiple": bool(same > 1),
            "meta_sentence": item["utterance"],
        }
        lang.update(self._resolve_targets(scene, [tgt]))
        return scene, lang


class _ReferIt3D(_SceneVerseTask):
    """ReferIt3D (Sr3D / Nr3D): utterances of at most 24 tokens; Nr3D
    with ``sr3d_plus_aug`` adds the Sr3D+ annotations to its train split."""
    anno_name = "sr3d"
    task_id = TASK_REFER
    evaluator = "ReferIt3DEval"

    def _load_lang(self):
        ids = set(self.scans.split_scan_ids(self.split))
        data = [x for x in _read_jsonl(
                    self._anno("refer", f"{self.anno_name}.jsonl"))
                if x["scan_id"] in ids and len(x.get("tokens", [])) <= 24]
        node = self.cfg["data"].get(type(self).__name__) or {}
        if node.get("sr3d_plus_aug") and self.split == "train":
            data += [x for x in _read_jsonl(self._anno("refer", "sr3d+.jsonl"))
                     if x["scan_id"] in ids and len(x.get("tokens", [])) <= 24]
        return data

    def get_item(self, idx):
        item = self.lang_data[idx]
        scene = self.scans.load(item["scan_id"])
        tgt = self._target_local_id(scene, item["target_id"])
        count = self._same_class_count(scene, [tgt])
        lang = {
            "task_id": TASK_REFER,
            "prompt_tokens": self.tokenizer(item["utterance"]),
            "response_tokens": [],
            "meta_is_hard": bool(count > 2),
            "meta_is_view_dependent":
                is_explicitly_view_dependent(item.get("tokens", [])),
            "meta_sentence": item["utterance"],
        }
        lang.update(self._resolve_targets(scene, [tgt]))
        return scene, lang


class Sr3DSceneVerse(_ReferIt3D):
    anno_name = "sr3d"


class Nr3DSceneVerse(_ReferIt3D):
    anno_name = "nr3d"


class Multi3DReferSceneVerse(_SceneVerseTask):
    """Multi3DRefer: zero, one or several referred objects."""
    task_id = TASK_REFER
    evaluator = "Multi3DReferEval"

    def _load_lang(self):
        ids = set(self.scans.split_scan_ids(self.split))
        path = self._anno("refer", f"multi3drefer_{self.split}.json")
        with open(path) as f:
            data = json.load(f)
        return [x for x in data if x["scene_id"] in ids]

    def get_item(self, idx):
        item = self.lang_data[idx]
        scene = self.scans.load(item["scene_id"])
        tgts = [self._target_local_id(scene, t)
                for t in item.get("object_ids", [])]
        lang = {
            "task_id": TASK_REFER,
            "prompt_tokens": self.tokenizer(item["description"]),
            "response_tokens": [],
            "meta_eval_type": item.get("eval_type", "mt"),
            "meta_sentence": item["description"],
        }
        lang.update(self._resolve_targets(scene, tgts))
        return scene, lang


class ScanQASceneVerse(_SceneVerseTask):
    """ScanQA.  With a 'qa' classifier head configured items carry a
    multi-hot
    ``answer_label`` over the train-split answer vocab and the classifier
    evaluator is used."""
    task_id = TASK_QA
    evaluator = "ScanQAGenEval"

    def __init__(self, cfg, split, tokenizer=None, gen_tokenizer=None):
        super().__init__(cfg, split, tokenizer, gen_tokenizer)
        self.answer_vocab = None
        node = cfg["data"].get(type(self).__name__) or {}
        has_qa_head = "qa" in tuple((cfg.get("model") or {}).get("heads")
                                    or ())
        use_unanswer = bool(node.get("use_unanswer", True))
        if has_qa_head or not use_unanswer:
            vocab = AnswerVocab.from_scanqa_train(self.scans.base_dir)
            if has_qa_head:
                self.answer_vocab = vocab
                self.evaluator = "ScanQAEval"
            if not use_unanswer:
                # keep only questions answerable from the train vocab,
                # whatever the head config
                self.lang_data = [
                    x for x in self.lang_data
                    if any(vocab.stoi(a) >= 0
                           for a in x.get("answers", []))]

    def _load_lang(self):
        node = self.cfg["data"].get(type(self).__name__) or {}
        name = f"ScanQA_v1.0_{'train' if self.split == 'train' else 'val'}.json"
        with open(self._anno("qa", name)) as f:
            data = json.load(f)
        ids = set(self.scans.split_scan_ids(self.split))
        if self.split == "train" and node.get("use_val_for_train"):
            # merge the val annotations (and their scans) into train
            with open(self._anno("qa", "ScanQA_v1.0_val.json")) as f:
                data += json.load(f)
            ids |= set(self.scans.split_scan_ids("val"))
        return [x for x in data if x["scene_id"] in ids]

    def get_item(self, idx):
        item = self.lang_data[idx]
        scene = self.scans.load(item["scene_id"])
        tgts = [self._target_local_id(scene, t)
                for t in item.get("object_ids", [])]
        answers = item.get("answers", [""])
        lang = {
            "task_id": TASK_QA,
            "prompt_tokens": self.tokenizer(item["question"]),
            "response_tokens": self.gen_tokenizer(answers[0]),
            "meta_answers": answers,
            "meta_sentence": item["question"],
        }
        if self.answer_vocab is not None:
            lang["answer_label"] = self.answer_vocab.multihot(answers)
        lang.update(self._resolve_targets(scene, tgts))
        return scene, lang


class SQA3DSceneVerse(_SceneVerseTask):
    """SQA3D: situated questions, prompt = situation + question."""
    task_id = TASK_QA
    evaluator = "SQA3DGenEval"
    TYPES = ["what", "is", "how", "can", "which", "others"]

    def __init__(self, cfg, split, tokenizer=None, gen_tokenizer=None):
        super().__init__(cfg, split, tokenizer, gen_tokenizer)
        self.answer_vocab = None
        if "qa" in tuple((cfg.get("model") or {}).get("heads") or ()):
            try:
                self.answer_vocab = AnswerVocab.from_sqa3d_dict(
                    self.scans.base_dir)
                self.evaluator = "SQA3DEval"
            except FileNotFoundError:
                pass

    def _load_lang(self):
        split = "train" if self.split == "train" else "val"
        with open(self._anno("sqa_task", "balanced",
                             f"v1_balanced_questions_{split}_scannetv2.json")) as f:
            questions = json.load(f)["questions"]
        with open(self._anno("sqa_task", "balanced",
                             f"v1_balanced_sqa_annotations_{split}_scannetv2.json")) as f:
            annos = {a["question_id"]: a
                     for a in json.load(f)["annotations"]}
        ids = set(self.scans.split_scan_ids(self.split))
        out = []
        for q in questions:
            if q["scene_id"] in ids and q["question_id"] in annos:
                q = dict(q)
                q["answers"] = [a["answer"]
                                for a in annos[q["question_id"]]["answers"]]
                out.append(q)
        return out

    def _qtype(self, question: str) -> int:
        first = question.lower().split()[0] if question else ""
        for i, t in enumerate(self.TYPES[:-1]):
            if first.startswith(t):
                return i
        return len(self.TYPES) - 1

    def get_item(self, idx):
        item = self.lang_data[idx]
        scene = self.scans.load(item["scene_id"])
        situation = item.get("situation", "")
        question = item["question"]
        prompt = f"{situation} {question}".strip()
        answers = item.get("answers", [""])
        lang = {
            "task_id": TASK_QA,
            "prompt_tokens": self.tokenizer(prompt),
            "response_tokens": self.gen_tokenizer(answers[0]),
            "meta_answers": answers,
            "meta_sqa_type": self._qtype(question),
            "meta_sentence": prompt,
        }
        if self.answer_vocab is not None:
            lang["answer_label"] = self.answer_vocab.multihot(answers)
        lang.update(self._resolve_targets(scene, []))
        return scene, lang


class Scan2CapSceneVerse(ScanReferSceneVerse):
    """Dense captioning over the ScanRefer corpus."""
    task_id = TASK_CAPTION
    evaluator = "Scan2CapEval"

    def _load_lang(self):
        data = super()._load_lang()
        if self.split != "train":
            # dedup to unique objects for eval
            seen = set()
            uniq = []
            for x in data:
                key = f"{x['scan_id']}|{x['target_id']}"
                if key not in seen:
                    seen.add(key)
                    uniq.append(x)
            data = uniq
        # captions truncated to txt_max_len tokens
        node = self.cfg["data"].get(type(self).__name__) or {}
        max_len = int(node.get("txt_max_len", 35))
        for x in data:
            toks = x.get("tokens") or x["utterance"].split()
            x["utterance"] = " ".join(toks[:max_len])
        return data

    @lru_cache(maxsize=None)
    def _refs_for(self, scan_id: str, target_id: int) -> tuple:
        return tuple(x["utterance"] for x in self.lang_data
                     if x["scan_id"] == scan_id
                     and int(x["target_id"]) == int(target_id))

    def get_item(self, idx):
        item = self.lang_data[idx]
        scene = self.scans.load(item["scan_id"])
        tgt = self._target_local_id(scene, item["target_id"])
        lang = {
            "task_id": TASK_CAPTION,
            "prompt_tokens": [],
            "response_tokens": self.gen_tokenizer(item["utterance"]),
            "meta_caption": item["utterance"],
            "meta_corpus_key": f"{item['scan_id']}|{item['target_id']}",
            "meta_ref_captions": list(
                self._refs_for(item["scan_id"], int(item["target_id"]))),
        }
        lang.update(self._resolve_targets(scene, [tgt]))
        return scene, lang
