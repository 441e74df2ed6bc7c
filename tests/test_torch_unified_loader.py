"""The port's stage-2 loaders and spawn pools against the JAX package's, on
the CPU:

- ``UnifiedTaskLoader(num_workers=0)`` bit-identical to JAX's for two
  epochs, train (shuffled, drop-last) and eval (every item, the last batch
  wrap-padded with ``_meta['n_real']``), the ``_meta`` side channel
  included; ``MixedTaskLoader``'s schedule and batches likewise;
- the pool path: a real 2-worker spawn pool yields, in order, what the
  worker function run in-process with ``SeedSequence([seed, epoch, b])``
  yields, for ``UnifiedTaskLoader`` (and that is JAX's worker function's
  batch) and for ``InstSegLoader``; the pool lives across epochs until
  ``close()``.  The pool's contract is the per-batch seeds, not
  ``num_workers=0``'s sequential rng (so are JAX's,
  tests/test_loader_workers.py);
- the datasets and tokenizers a worker receives survive pickling.
"""
import pickle

import numpy as np
import pytest
import torch

from pq3d_tpu.config import Config
from pq3d_tpu.data import unified_datasets as jds
from pq3d_tpu.data import unified_loader as jul
from pq3d_tpu.data import unified_pipeline as jup
from pq3d_tpu_torch.data import datasets as tdatasets
from pq3d_tpu_torch.data import tokenizers as ttok
from pq3d_tpu_torch.data import unified_datasets as tds
from pq3d_tpu_torch.data import unified_loader as tul
from pq3d_tpu_torch.data import unified_pipeline as tup
from pq3d_tpu_torch.data.instseg_pipeline import InstSegPipelineConfig

torch.set_num_threads(1)
CFG = {"data": {"synthetic": {"num_train": 7, "num_val": 5, "n_points": 400,
                              "n_instances": 5}},
       "debug": {"flag": False}}
PIPE = dict(max_obj_len=6, num_points=32, prompt_len=8, response_len=6)
DIMS = {"mv": 16, "voxel": 8}
DATASETS = ("SyntheticRefer", "SyntheticQA", "SyntheticCaption")


def _assert_batches_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if k == "_meta":
            assert set(a[k]) == set(b[k])
            for mk in a[k]:
                assert np.array_equal(np.asarray(a[k][mk], object),
                                      np.asarray(b[k][mk], object)), mk
        elif isinstance(a[k], dict):
            _assert_batches_equal(a[k], b[k])
        else:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _loaders(name, train, num_workers=0, split="train", bs=2, seed=3):
    t = tul.UnifiedTaskLoader(getattr(tds, name)(CFG, split),
                              tup.UnifiedPipelineConfig(**PIPE), bs, train,
                              seed=seed, feature_dims=DIMS,
                              num_workers=num_workers)
    j = jul.UnifiedTaskLoader(getattr(jds, name)(Config(CFG), split),
                              jup.UnifiedPipelineConfig(**PIPE), bs, train,
                              seed=seed, feature_dims=DIMS)
    return t, j


@pytest.mark.parametrize("name", DATASETS)
@pytest.mark.parametrize("train", [True, False])
def test_unified_task_loader_matches_jax(name, train):
    split = "train" if train else "val"
    t, j = _loaders(name, train, split=split)
    for epoch in (0, 1):
        got, want = list(t(epoch)), list(j(epoch))
        # 7 items at batch 2: 3 train batches (drop-last); 5 val items:
        # 3 batches, the last wrap-padded with 1 real row
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            _assert_batches_equal(g, w)
        if not train:
            assert [b["_meta"]["n_real"] for b in got] == [2, 2, 1]


def test_mixed_task_loader_matches_jax():
    ts, js = zip(*[_loaders(name, True) for name in DATASETS])
    t = tul.MixedTaskLoader(list(ts), seed=5)
    j = jul.MixedTaskLoader(list(js), seed=5)
    for epoch in (0, 1):
        got, want = list(t(epoch)), list(j(epoch))
        assert len(got) == len(want) == 9
        for g, w in zip(got, want):
            _assert_batches_equal(g, w)
        assert sorted(int(b["task_id"][0]) for b in got) == \
            [0, 0, 0, 1, 1, 1, 2, 2, 2]


def test_unified_pool_matches_worker_path_and_jax():
    """2 spawned workers, two epochs from one pool, against the worker
    function in-process (and JAX's worker function) with per-batch
    seeds."""
    t, j = _loaders("SyntheticCaption", True, num_workers=2)
    jul._init_unified_worker(j.dataset, j.cfg, j.feature_dims)
    tul._init_unified_worker([(t.dataset, t.cfg, t.feature_dims)])
    try:
        for epoch in (0, 1):
            order = np.random.default_rng(t.seed + epoch).permutation(7)
            batches = [order[s:s + 2] for s in range(0, 6, 2)]
            got = list(t(epoch))
            pool = t._pool
            assert len(got) == 3
            for b, (g, idxs) in enumerate(zip(got, batches)):
                ref = tul._unified_worker_batch(0, idxs,
                                                [t.seed, epoch, b], True)
                ref["_meta"]["n_real"] = 2
                _assert_batches_equal(g, ref)
                want = jul._unified_worker_batch(idxs, [t.seed, epoch, b],
                                                 True)
                want["_meta"]["n_real"] = 2
                _assert_batches_equal(g, want)
        assert t._pool is pool           # epoch-persistent
    finally:
        t.close()
    assert t._pool is None


def test_mixed_loader_shares_one_pool_and_matches_worker_path():
    """The three loaders' jobs run in one 2-worker pool (the JAX package
    starts one pool per loader); each scheduled batch equals its loader's
    worker function in-process with ``[seed, epoch, b]``, and the epoch's
    first jobs of every loader are in flight before the first batch is
    taken."""
    ts = [_loaders(name, True, num_workers=2)[0] for name in DATASETS]
    mix = tul.MixedTaskLoader(ts, seed=5)
    assert len({id(lo._pool) for lo in ts}) == 1
    tul._init_unified_worker([(lo.dataset, lo.cfg, lo.feature_dims)
                              for lo in ts])
    try:
        it = mix(1)
        executor = ts[0]._pool._pool
        assert len(executor._pending_work_items) >= 3
        got = list(it)
    finally:
        mix.close()
    schedule = np.concatenate([np.full(3, i) for i in range(3)])
    np.random.default_rng(5 + 1).shuffle(schedule)
    seen = [0, 0, 0]
    assert len(got) == 9
    for g, i in zip(got, schedule):
        lo = ts[i]
        order = np.random.default_rng(lo.seed + 1).permutation(7)
        b = seen[i]
        seen[i] += 1
        ref = tul._unified_worker_batch(int(i), order[2 * b:2 * b + 2],
                                        [lo.seed, 1, b], True)
        ref["_meta"]["n_real"] = 2
        _assert_batches_equal(g, ref)
    assert all(lo._pool is None for lo in ts)


def test_instseg_pool_matches_worker_path():
    cfg = {"data": {"synthetic": {"num_train": 6, "n_points": 500,
                                  "n_instances": 3, "n_segments": 12}},
           "debug": {"flag": False}}
    pipe = InstSegPipelineConfig(voxel_size=0.15, num_queries=8,
                                 max_segments=32, max_instances=8,
                                 voxel_bucket=128, use_aug=True,
                                 stem_mode="dense_block")
    mk = lambda nw: tdatasets.InstSegLoader(  # noqa: E731
        tdatasets.SyntheticInstSeg(cfg, "train"), pipe, batch_size=2,
        train=True, seed=3, extra_features={"mv": 8}, num_workers=nw)
    lo0 = mk(0)
    batches, _, _ = lo0._batch_indices(epoch=0)
    tdatasets._init_instseg_worker(lo0.dataset, lo0.pipe_cfg,
                                   lo0.extra_features)
    refs = [tdatasets._instseg_worker_batch(idxs, [lo0.seed, 0, b], True)
            for b, idxs in enumerate(batches)]
    lo2 = mk(2)
    try:
        got = list(lo2(0))
    finally:
        lo2.close()
    assert len(got) == len(refs) == 3
    for g, r in zip(got, refs):
        r["_meta"]["n_real"] = 2
        _assert_batches_equal(g, r)


def test_worker_payloads_pickle():
    """A spawned worker receives the dataset through pickle: the synthetic
    datasets (and the tokenizer bundle) round-trip."""
    for name in DATASETS:
        ds = getattr(tds, name)(CFG, "train")
        ds2 = pickle.loads(pickle.dumps(ds))
        s1, l1 = ds.get_item(2)
        s2, l2 = ds2.get_item(2)
        np.testing.assert_array_equal(s1["points"], s2["points"])
        assert l1 == l2 or all(np.array_equal(l1[k], l2[k]) for k in l1)
    bundle = ttok.build_tokenizers({"data_wrapper": {}})
    b2 = pickle.loads(pickle.dumps(bundle))
    assert b2.tokenize("find it") == bundle.tokenize("find it")
    assert b2.detokenize(np.array([4, 2, 9, 1])) == "find the chair"
