"""Synthetic unified-task datasets: language-annotated scene items;
counterpart of ``SyntheticRefer``, ``SyntheticQA``, ``SyntheticCaption``
and ``detokenize`` in ``pq3d_tpu/data/unified_datasets.py``.

Protocol: ``__len__`` and ``get_item(idx) -> (scene, lang)``, where
``lang`` feeds ``data/unified_pipeline.process_item``.  Items are
procedural token-id sequences over a small closed vocabulary,
deterministic per (split, index), equal to the JAX package's.  Configs are
plain dicts (``pq3d_tpu_torch/config.py``).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from pq3d_tpu_torch.data import synthetic
from pq3d_tpu_torch.data.unified_pipeline import (TASK_CAPTION, TASK_QA,
                                                  TASK_REFER)

# tiny closed vocabulary for synthetic language (id 0 = pad, 1 = eos)
VOCAB = ["<pad>", "</s>", "the", "a", "find", "object", "near", "left",
         "right", "chair", "table", "sofa", "lamp", "desk", "bed", "what",
         "color", "is", "red", "blue", "green", "small", "large", "it",
         "describe", "this", "one", "two", "three", "room"]
WORD2ID = {w: i for i, w in enumerate(VOCAB)}


def _tok(words: List[str]) -> List[int]:
    return [WORD2ID[w] for w in words] + [1]  # + eos


class _SyntheticUnifiedBase:
    """Scenes + procedural annotations, deterministic per (split, index)."""
    task_id = TASK_REFER
    evaluator = "ScanReferEval"

    def __init__(self, cfg: Dict, split: str):
        node = cfg["data"].get("synthetic") or {}
        n = {"train": 64, "val": 16, "test": 16}[split]
        debug = cfg.get("debug") or {}
        if debug.get("flag"):
            n = min(n, int(debug.get("debug_size", 4)))
        self.num_items = int(node.get(f"num_{split}", n))
        self.n_points = int(node.get("n_points", 3000))
        self.n_instances = int(node.get("n_instances", 8))
        self.split = split
        self.seed = {"train": 0, "val": 50_000, "test": 90_000}[split]

    def __len__(self):
        return self.num_items

    def _scene(self, rng) -> Dict[str, np.ndarray]:
        s = synthetic.make_scene(rng, n_points=self.n_points,
                                 n_instances=self.n_instances, n_segments=48)
        s["inst_labels"] = 9 + (s["inst_labels"] % 6)  # chair..bed word ids
        return s

    def get_item(self, idx: int) -> Tuple[Dict, Dict]:
        rng = np.random.default_rng(self.seed + idx)
        scene = self._scene(rng)
        lang = self._lang(scene, rng, idx)
        lang["task_id"] = self.task_id
        return scene, lang

    def _lang(self, scene, rng, idx) -> Dict:
        raise NotImplementedError


class SyntheticRefer(_SyntheticUnifiedBase):
    """Grounding: 'find the <label> near the <other>' -> target object."""
    task_id = TASK_REFER
    evaluator = "ScanReferEval"

    def _lang(self, scene, rng, idx):
        tgt = int(rng.integers(0, len(scene["inst_labels"])))
        label_word = int(scene["inst_labels"][tgt])
        same = (scene["inst_labels"] == scene["inst_labels"][tgt]).sum()
        return {
            "prompt_tokens": _tok(["find", "the", VOCAB[label_word],
                                   "near", "the", "room"]),
            "tgt_object_ids": [tgt],
            "response_tokens": [],
            "meta_is_multiple": bool(same > 1),
        }


class SyntheticQA(_SyntheticUnifiedBase):
    """QA: 'what color is the <label>' -> a color word answer.  When the
    model has a 'qa' classifier head, items also carry the multi-hot
    ``answer_label`` over the color vocab and the classifier evaluator is
    named."""
    task_id = TASK_QA
    evaluator = "ScanQAGenEval"

    COLORS = ["red", "blue", "green"]

    def __init__(self, cfg, split):
        super().__init__(cfg, split)
        self.answer_vocab = None
        if "qa" in tuple((cfg.get("model") or {}).get("heads") or ()):
            from pq3d_tpu_torch.data.label_utils import AnswerVocab
            self.answer_vocab = AnswerVocab(list(self.COLORS))
            self.evaluator = "ScanQAEval"

    def _lang(self, scene, rng, idx):
        tgt = int(rng.integers(0, len(scene["inst_labels"])))
        label_word = int(scene["inst_labels"][tgt])
        color = self.COLORS[(label_word + idx) % 3]
        lang = {
            "prompt_tokens": _tok(["what", "color", "is", "the",
                                   VOCAB[label_word]]),
            "tgt_object_ids": [tgt],
            "response_tokens": _tok([color]),
            "meta_answers": [color],
        }
        if self.answer_vocab is not None:
            lang["answer_label"] = self.answer_vocab.multihot([color])
        return lang


class SyntheticCaption(_SyntheticUnifiedBase):
    """Captioning: LOC prompt -> 'the <size> <label>' caption."""
    task_id = TASK_CAPTION
    evaluator = "Scan2CapEval"

    def _lang(self, scene, rng, idx):
        tgt = int(rng.integers(0, len(scene["inst_labels"])))
        label_word = int(scene["inst_labels"][tgt])
        size = "small" if (label_word + idx) % 2 else "large"
        caption = ["the", size, VOCAB[label_word]]
        return {
            "prompt_tokens": [],
            "tgt_object_ids": [tgt],
            "response_tokens": _tok(caption),
            "meta_caption": " ".join(caption),
            "meta_corpus_key": f"{self.split}_{idx}",
        }


def detokenize(tokens: np.ndarray) -> str:
    """Token ids -> words (stops at eos/pad): generation output as text."""
    words = []
    for t in np.asarray(tokens).tolist():
        if t in (0, 1):
            break
        if 0 <= t < len(VOCAB):
            words.append(VOCAB[t])
    return " ".join(words)
