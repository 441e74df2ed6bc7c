"""Evaluator base; counterpart of ``pq3d_tpu/eval/base.py``:
``truncate_batch_rows`` (the wrap-padding rows of a final eval batch
dropped before an evaluator sees them), ``take_rows`` and ``rank_share``
(a data-parallel rank's rows of a global batch) and ``BaseEvaluator``
(update -> record, metrics accumulated as (value, count) pairs, merged
over the ranks of a process group as the JAX package merges them over its
processes).

This module imports numpy only (the loaders' spawned workers import it):
``record`` imports the process-group helpers when it runs.
"""
from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Any, Dict, Iterator, Optional

import numpy as np


# the per-row lists that stand outside ``_meta``: the stage-2 trainer's
# decoded texts (``MultitaskTrainer.postprocess_for_eval``); a caller adds
# its own (the trainer: the meta keys it merges into the evaluators' batch)
ROW_LISTS = frozenset({"answer_pred", "caption_pred"})


def truncate_batch_rows(tree: Any, n_real: int, batch_rows: int,
                        row_lists=ROW_LISTS) -> Any:
    """Cut the evaluator-facing copies of a wrap-padded batch to its
    ``n_real`` rows (``slice_batch_rows``)."""
    if n_real >= batch_rows:
        return tree
    return slice_batch_rows(tree, 0, n_real, batch_rows, row_lists)


def slice_batch_rows(tree: Any, lo: int, hi: int, batch_rows: int,
                     row_lists=ROW_LISTS) -> Any:
    """Rows ``[lo, hi)`` of every per-row entry of a batch tree: numpy
    arrays whose leading dim is ``batch_rows`` (anywhere in the tree; a
    list of such arrays, per round or layer, is cut elementwise), and the
    per-row lists: those of ``_meta`` (one entry a row, as the pipelines
    collect them) and those at a key of ``row_lists``.  Any other list
    keeps its length, whatever it is.  Lists and tuples come back as
    plain lists."""
    def cut(x, row):
        if isinstance(x, dict):
            return {k: cut(v, row or k == "_meta" or k in row_lists)
                    for k, v in x.items()}
        if isinstance(x, np.ndarray):
            return x[lo:hi] if (x.ndim >= 1
                                and x.shape[0] == batch_rows) else x
        if isinstance(x, (list, tuple)):
            if row and len(x) == batch_rows:
                return list(x[lo:hi])
            if x and all(isinstance(v, np.ndarray) and v.ndim >= 1
                         and v.shape[0] == batch_rows for v in x):
                return [v[lo:hi] for v in x]
            return [cut(v, False) for v in x]
        return x
    return cut(tree, False)


def take_rows(batch: Dict[str, Any], lo: int, hi: int) -> Dict[str, Any]:
    """Rows ``[lo, hi)`` of a collated batch (its rows: the leading dim of
    ``query_pad_masks``), ``_meta`` lists included; ``_meta['n_real']``
    becomes the real rows among them (0 for a rank whose rows are all
    wrap padding)."""
    rows = int(batch["query_pad_masks"].shape[0])
    out = slice_batch_rows(batch, lo, hi, rows)
    meta = out.get("_meta")
    if isinstance(meta, dict) and "n_real" in meta:
        meta["n_real"] = min(max(int(meta["n_real"]) - lo, 0), hi - lo)
    return out


def rank_share(batches: Iterator[Dict[str, Any]], batch_size: int,
               rank: int, world: int) -> Iterator[Dict[str, Any]]:
    """Rank ``rank``'s rows ``[rank * b, (rank + 1) * b)`` of each global
    batch, ``b = batch_size / world``; the batches themselves with one
    rank."""
    if world == 1:
        yield from batches
        return
    if batch_size % world:
        raise ValueError(f"a global batch of {batch_size} does not split "
                         f"over {world} ranks")
    b = batch_size // world
    for batch in batches:
        yield take_rows(batch, rank * b, (rank + 1) * b)


class BaseEvaluator:
    def __init__(self, save_dir: Optional[str] = None):
        self.save_dir = save_dir
        self.eval_dict: Dict[str, list] = defaultdict(list)
        self.total_count = 0
        self.best_result = -np.inf
        self.target_metric = "target_metric"

    def reset(self):
        self.eval_dict = defaultdict(list)
        self.total_count = 0

    def update(self, out: Dict[str, Any], batch: Dict[str, Any]) -> None:
        raise NotImplementedError

    def record(self) -> Dict[str, float]:
        """Count-weighted means of the accumulated (value, count) pairs of
        every rank, ``target_metric`` set from the evaluator's target;
        written to ``save_dir/results.json`` (by rank 0) when a directory
        is given."""
        from pq3d_tpu_torch.parallel.dist import merge_eval_dicts, rank
        results = {}
        for k, pairs in merge_eval_dicts(dict(self.eval_dict)).items():
            v = sum(x * c for x, c in pairs)
            c = sum(c for _, c in pairs)
            results[k] = v / max(c, 1)
        if self.target_metric in results:
            results["target_metric"] = results[self.target_metric]
        if self.save_dir and rank() == 0:
            os.makedirs(self.save_dir, exist_ok=True)
            with open(os.path.join(self.save_dir, "results.json"), "w") as f:
                json.dump(results, f, indent=2)
        return results
