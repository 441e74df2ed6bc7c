"""Unified-task batch loaders: one loader per task dataset and the train
mixture over them; counterpart of ``pq3d_tpu/data/unified_loader.py``.

A batch is ``collate_unified`` of ``process_item`` over the dataset's items,
plus ``_meta``: the items' ``meta_*`` fields collected per key (Python
lists and strings the evaluators read, never sent to the card) and
``n_real``.  Train batches drop the remainder of a shuffled epoch; eval
batches cover every item, the last one padded by wrap-around with
``n_real`` marking its real rows.

``num_workers=0`` draws every batch from one rng seeded with ``seed +
epoch``; ``num_workers > 0`` builds the batches in a spawn pool
(``data/pool.py``), each from ``SeedSequence([seed, epoch, b])``, in
order.  Both are the JAX loader's, so either gives the JAX package's
batches; the two do not give each other's.  ``MixedTaskLoader`` runs the
jobs of all its loaders in one pool of ``num_workers`` processes, where
the JAX package starts one pool per loader (three times the processes on
the same cores); the batches are the same.

Under data parallelism every rank draws the same global batches (and the
same mixture schedule) and yields its own contiguous rows of each
(``eval/base.rank_share``); each rank runs its own pool.  Under a mesh the
rows are those of the rank's row index (``parallel/dist.row_index``), so
tp peers yield the same rows.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np

from pq3d_tpu_torch.data.pool import BatchPool
from pq3d_tpu_torch.data.unified_pipeline import (UnifiedPipelineConfig,
                                                  collate_unified,
                                                  process_item)
from pq3d_tpu_torch.eval.base import rank_share


def _assemble_unified_batch(dataset, cfg: UnifiedPipelineConfig,
                            feature_dims: Dict[str, int], idxs,
                            rng: np.random.Generator,
                            train: bool) -> Dict[str, np.ndarray]:
    items = []
    metas: Dict[str, List] = {}
    for i in idxs:
        scene, lang = dataset.get_item(int(i))
        item = process_item(scene, lang, cfg, rng, train, feature_dims)
        for k in list(item.keys()):
            if k.startswith("meta_"):
                metas.setdefault(k[5:], []).append(item.pop(k))
        items.append(item)
    batch = collate_unified(items, cfg, feature_dims, train=train)
    batch["_meta"] = metas
    return batch


# worker-process state (set by the spawn initializer: each loader's
# dataset is pickled once per worker), keyed by the loader's place in the
# pool's list
_WORKER: Dict[str, object] = {}


def _init_unified_worker(sources):
    """``sources``: a list of (dataset, cfg, feature_dims), one per loader
    that the pool serves."""
    _WORKER["sources"] = sources


def _unified_worker_batch(source, idxs, seed_key, train):
    dataset, cfg, feature_dims = _WORKER["sources"][source]
    rng = np.random.default_rng(np.random.SeedSequence(seed_key))
    return _assemble_unified_batch(dataset, cfg, feature_dims, idxs, rng,
                                   train)


def _shared_pool(loaders: List["UnifiedTaskLoader"], num_workers: int
                 ) -> BatchPool:
    """One pool for ``loaders``: each loader's jobs name its place."""
    pool = BatchPool(num_workers, _init_unified_worker,
                     ([(lo.dataset, lo.cfg, lo.feature_dims)
                       for lo in loaders],))
    for i, lo in enumerate(loaders):
        lo._pool, lo._source = pool, i
    return pool


def _with_n_real(batches, n_real):
    for batch, nr in zip(batches, n_real):
        batch["_meta"]["n_real"] = nr
        yield batch


class UnifiedTaskLoader:
    """Batches from one task dataset; ``loader(epoch)`` iterates one
    epoch (rank ``rank``'s rows of each global batch of ``batch_size``).
    The pool path needs a picklable dataset (the synthetic datasets and
    tokenizer are)."""

    def __init__(self, dataset, cfg: UnifiedPipelineConfig, batch_size: int,
                 train: bool, seed: int = 0,
                 feature_dims: Optional[Dict[str, int]] = None,
                 num_workers: int = 0, rank: int = 0, world: int = 1):
        self.dataset = dataset
        self.cfg = cfg
        self.batch_size = batch_size
        self.train = train
        self.seed = seed
        self.num_workers = num_workers
        self._pool = None       # own or shared (MixedTaskLoader), lazy
        self._source = 0
        self.feature_dims = feature_dims or {"mv": 768, "voxel": 128}
        self.rank, self.world = rank, world

    def __call__(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        """The epoch's batches; with workers, its first jobs are submitted
        now."""
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
        if self.num_workers <= 0:
            built = (_assemble_unified_batch(self.dataset, self.cfg,
                                             self.feature_dims, idxs, rng,
                                             self.train)
                     for idxs in batches)
        else:
            if self._pool is None:
                _shared_pool([self], self.num_workers)
            built = self._pool.run(
                _unified_worker_batch,
                ((self._source, idxs, [self.seed, epoch, b], self.train)
                 for b, idxs in enumerate(batches)))
        return rank_share(_with_n_real(built, n_real), bs, self.rank,
                          self.world)

    def close(self) -> None:
        """Shut the worker pool down (each worker holds a copy of the
        dataset)."""
        if self._pool is not None:
            self._pool.close()
            self._pool = None


def _scheduled(iters, schedule):
    for i in schedule:
        try:
            yield next(iters[i])
        except StopIteration:
            continue


class MixedTaskLoader:
    """The train mixture over several task loaders: each loader's full
    batches, in a schedule that a rng seeded with ``seed + epoch``
    shuffles.  Loaders with ``num_workers > 0`` share one pool of the
    largest of their counts."""

    def __init__(self, loaders: List[UnifiedTaskLoader], seed: int = 0):
        self.loaders = loaders
        self.seed = seed
        pooled = [lo for lo in loaders if lo.num_workers > 0]
        if pooled:
            _shared_pool(pooled, max(lo.num_workers for lo in pooled))

    def __call__(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        """The epoch's batches; every loader's epoch is opened now (with
        workers, all their first jobs are submitted at once)."""
        iters = [lo(epoch) for lo in self.loaders]
        counts = [len(lo.dataset) // lo.batch_size for lo in self.loaders]
        schedule = np.concatenate([np.full(c, i)
                                   for i, c in enumerate(counts)])
        rng = np.random.default_rng(self.seed + epoch)
        rng.shuffle(schedule)
        return _scheduled(iters, schedule)

    def close(self) -> None:
        for lo in self.loaders:
            lo.close()
