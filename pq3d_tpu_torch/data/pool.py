"""Spawn pool of the multi-worker batch loaders; counterpart of ``BatchPool``
in ``pq3d_tpu/data/pool.py``.

One place for the process-pool protocol of ``InstSegLoader`` and
``UnifiedTaskLoader``: a lazily created, epoch-persistent spawn pool (a
spawned worker imports the modules its jobs need, so its start is paid
once per loader, not once per epoch), the dataset pickled once per worker
through the initializer, and an order-preserving window of
``num_workers + 2`` jobs in flight, so a slow consumer caps host memory.

Workers run numpy host code only: the worker functions are module-level
and never touch CUDA (a forked CUDA context is unusable, and a spawned
one would take card memory per worker).  ``run`` submits its first window
when it is called, not when its first result is asked for, so a consumer
that opens several loaders' epochs at once (``MixedTaskLoader``) has all
their first batches in flight together.

A batch's large arrays (1 MiB and up) do not travel back through the
executor's result pipe (through it, the first 290 MB stage-2 batch of a
7-worker epoch arrived after 31 s on an 8-core H100 host, in
``chip_smoke.py``'s phase ``unified_train``): the worker writes each
into a file of its own under ``tempfile.gettempdir()`` and sends its
path, shape and dtype; the consumer maps the file, unlinks it, and gets a
numpy array on the mapping (no copy).  Arrays inside dicts, lists,
tuples and dataclasses (a stage-1 scene's ``SparseHierarchy``) go so;
small arrays and other values are pickled as before.
"""
from __future__ import annotations

import dataclasses
import itertools
import mmap
import os
import tempfile
import uuid
from collections import deque
from typing import Any, Callable, Iterable, Iterator, NamedTuple, Tuple

import numpy as np

MIN_MAPPED_BYTES = 1 << 20


class _Mapped(NamedTuple):
    """A worker's array, left in a file for the consumer to map."""
    path: str
    shape: Tuple[int, ...]
    dtype: str


class _Fields(NamedTuple):
    """A dataclass instance, its fields exported one by one."""
    cls: type
    fields: dict


def _export(x: Any, prefix: str, count: Iterator[int]) -> Any:
    if isinstance(x, dict):
        return {k: _export(v, prefix, count) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return type(x)(_export(v, prefix, count) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return _Fields(type(x), {f.name: _export(getattr(x, f.name), prefix,
                                                 count)
                                 for f in dataclasses.fields(x)})
    if isinstance(x, np.ndarray) and x.nbytes >= MIN_MAPPED_BYTES \
            and not x.dtype.hasobject:
        path = f"{prefix}_{next(count)}"
        with open(path, "w+b") as f:
            f.truncate(x.nbytes)
            mm = mmap.mmap(f.fileno(), x.nbytes)
        np.ndarray(x.shape, x.dtype, buffer=mm)[...] = x
        mm.close()
        return _Mapped(path, x.shape, x.dtype.str)
    return x


def _import(x: Any) -> Any:
    if isinstance(x, dict):
        return {k: _import(v) for k, v in x.items()}
    if isinstance(x, _Fields):
        return x.cls(**{k: _import(v) for k, v in x.fields.items()})
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return type(x)(_import(v) for v in x)
    if isinstance(x, _Mapped):
        dtype = np.dtype(x.dtype)
        nbytes = int(np.prod(x.shape)) * dtype.itemsize
        with open(x.path, "r+b") as f:
            mm = mmap.mmap(f.fileno(), nbytes)
        os.unlink(x.path)
        return np.frombuffer(mm, dtype).reshape(x.shape)
    return x


def _discard(x: Any) -> None:
    """Unlink the files of a result nobody will take."""
    if isinstance(x, _Fields):
        _discard(x.fields)
    elif isinstance(x, dict):
        for v in x.values():
            _discard(v)
    elif isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        for v in x:
            _discard(v)
    elif isinstance(x, _Mapped) and os.path.exists(x.path):
        os.unlink(x.path)


def _run_exported(worker_fn: Callable, job: Tuple) -> Any:
    """In the worker: ``worker_fn(*job)`` with its large arrays left in
    files."""
    prefix = os.path.join(tempfile.gettempdir(),
                          f"pq3d_batch_{uuid.uuid4().hex}")
    return _export(worker_fn(*job), prefix, itertools.count())


class BatchPool:
    """Reusable spawn pool yielding ``worker_fn(*job)`` results in order."""

    def __init__(self, num_workers: int, initializer: Callable,
                 initargs: Tuple):
        self.num_workers = num_workers
        self._initializer = initializer
        self._initargs = initargs
        self._pool = None

    def _ensure(self):
        if self._pool is None:
            import concurrent.futures as cf
            import multiprocessing as mp
            self._pool = cf.ProcessPoolExecutor(
                self.num_workers, mp_context=mp.get_context("spawn"),
                initializer=self._initializer, initargs=self._initargs)
        return self._pool

    def run(self, worker_fn: Callable, jobs: Iterable[Tuple]) -> Iterator:
        """Submit the first ``num_workers + 2`` jobs now and return an
        iterator over the results in job order, which submits the next job
        as each result is taken."""
        pool = self._ensure()
        jobs = iter(jobs)
        pending: deque = deque(
            pool.submit(_run_exported, worker_fn, job)
            for job in itertools.islice(jobs, self.num_workers + 2))

        def results():
            try:
                while pending:
                    out = _import(pending.popleft().result())
                    job = next(jobs, None)
                    if job is not None:
                        pending.append(
                            pool.submit(_run_exported, worker_fn, job))
                    yield out
            finally:        # an epoch left early: drop what is in flight
                for fut in pending:
                    if not fut.cancel() and fut.exception() is None:
                        _discard(fut.result())
        return results()

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None

    def __del__(self):  # best effort; close() is the way to release it
        try:
            self.close()
        except Exception:
            pass
