"""Serving loop: queued requests -> batches -> one forward on the card ->
per-request answers.

Counterpart of ``pq3d_tpu/serve.py`` (``ServerStats``, ``_MicroBatchServer``,
``InstSegServer``, ``UnifiedServer``, their sharded-batch mesh form and
``ReplicatedServer``, one server per device):

- a submit() queue with futures, so callers get per-scene results;
- micro-batching: up to ``batch_size`` scenes per step, waiting at most
  ``max_delay_s`` for stragglers, padding short batches by repeating the
  last processed scene (results for the padding rows are dropped);
- a depth-1 pipeline: while batch N's forward runs on the card (kernels
  are queued asynchronously), batch N+1's host work runs;
- stage 1 (``InstSegServer``): the rectangular layout with host-built or
  device-built maps, or the flat pack with host-built or device-built
  maps, for the Res16UNet or the Swin3D backbone; per-scene host
  preprocessing in process or on a spawn pool (``num_workers``); an
  optional batch transform (``cast``, as below); per-scene ranking
  (eval/instseg_eval.rank_instances) at full point resolution;
- stage 2 (``UnifiedServer``): per-request grounding scores and object,
  and greedy-decoded generation tokens and text, in the padded or the flat
  object layout (``pipe_cfg.flat_obj``), with an optional batch transform
  (``cast``: ``utils/inference.cast_batch_bf16`` beside a model cast by
  ``cast_model_bf16``) and the two-phase decode of a ``two_phase``
  generation head.

- the mesh server (``mesh=``, a list of devices that forms the mesh's
  ``data`` axis; ``serving_mesh()`` lists every visible card): one model
  replica a device (``parallel/mesh.replicate``), each collated
  rectangular batch split by rows into ``len(mesh)`` equal parts, one
  thread a device running its part's forward, the answers joined in
  request order.  A part routes each sparse conv by its own rows, as a
  data-parallel training rank does.  One process drives every
  device, as the JAX package's one controller does.  It refuses what
  JAX's refuses: a ``batch_size`` the mesh does not divide, the flat
  layouts (``flat_pack``, ``compact_conv``, ``flat_obj``: no batch dim
  to split) and ``mesh`` together with ``device``.

The forward runs under ``torch.inference_mode()`` on the server's device
(the mesh's devices); device results are read back in ``_finish``.

While a ``torch.profiler`` runs, the stage-1 server records its stages
as spans of ``utils/profiling`` (each with the batch id and the ids of
the requests it holds): ``server.preprocess``, ``server.collate``,
``server.dispatch`` (host-to-device copy and forward enqueue),
``server.readback`` and ``server.rank``; and both servers record as
counters each request's ``server.queue_wait`` (submit to the start of
its batch's host work) and each batch's ``server.hold`` (the end of its
dispatch to the start of its readback: its answers' wait for the server
thread), in seconds.  ``ServerStats.stage_s`` sums the stages always.
"""
from __future__ import annotations

import concurrent.futures as _futures
import contextlib
import dataclasses
import itertools
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from pq3d_tpu_torch.data.instseg_pipeline import (InstSegPipelineConfig,
                                                  collate_processed,
                                                  flat_shape_caps_from,
                                                  process_scene)
from pq3d_tpu_torch.data.pool import BatchPool
from pq3d_tpu_torch.data.unified_pipeline import (UnifiedPipelineConfig,
                                                  collate_unified,
                                                  process_item)
from pq3d_tpu_torch.device import resolve_device
from pq3d_tpu_torch.eval.instseg_eval import rank_instances
from pq3d_tpu_torch.models.encoders import check_swin_window
from pq3d_tpu_torch.parallel.mesh import replicate
from pq3d_tpu_torch.utils import profiling

# spawn-pool worker protocol for the stage-1 host preprocessing: module
# level, so spawned workers find the functions by name; a worker runs numpy
# host code only and never touches the card
_SERVE_WORKER: Dict[str, Any] = {}


def _init_serve_worker(pipe_cfg: InstSegPipelineConfig) -> None:
    _SERVE_WORKER["cfg"] = pipe_cfg


def _serve_process_scene(scene, seed: int):
    """``process_scene`` of one served scene with its own rng,
    ``default_rng(SeedSequence(seed))`` (the JAX package's
    ``default_rng(seed)``: the same stream)."""
    rng = np.random.default_rng(np.random.SeedSequence(seed))
    return process_scene(scene, _SERVE_WORKER["cfg"], rng)


@dataclass
class ServerStats:
    scenes: int = 0
    steps: int = 0
    # wall-clock span of processed batches (per-batch times overlap under
    # the pipelined worker, so throughput comes from the span)
    t_first: float = 0.0
    t_last: float = 0.0
    latencies_s: "deque" = field(
        default_factory=lambda: deque(maxlen=100_000))
    # per-stage host decomposition (summed seconds across batches):
    # preprocess, collate, put_dispatch (host->device copy + forward
    # enqueue), readback (waits for the device), rank; stage 2's
    # forward_decode and finish in place of the last three
    stage_s: Dict[str, float] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def record_latency(self, seconds: float) -> None:
        with self._lock:
            self.latencies_s.append(seconds)

    def add_stage(self, name: str, seconds: float) -> None:
        self.stage_s[name] = self.stage_s.get(name, 0.0) + seconds

    @contextlib.contextmanager
    def stage(self, name: str, sp=None):
        """The block's host seconds into ``stage_s[name]``, always, with
        the block inside ``sp`` (a recorder span, or its no-op) if given."""
        t0 = time.time()
        with sp if sp is not None else contextlib.nullcontext():
            yield
        self.add_stage(name, time.time() - t0)

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            lat = np.asarray(self.latencies_s) if self.latencies_s else \
                np.zeros(1)
        span = self.t_last - self.t_first
        return {"scenes": self.scenes, "steps": self.steps,
                "scenes_per_sec": self.scenes / max(span, 1e-9),
                "p50_latency_s": float(np.quantile(lat, 0.5)),
                "p99_latency_s": float(np.quantile(lat, 0.99)),
                "stage_s": dict(self.stage_s)}


class _MicroBatchServer:
    """Micro-batching machinery: a submit() queue with futures, a collector
    that waits at most ``max_delay_s`` for stragglers after the first
    request, and a worker loop that reports per-batch failures into the
    affected futures instead of dying.  Subclasses implement ``_dispatch``
    (host work + asynchronous device enqueue) and ``_finish`` (readback +
    host postprocess) over the real requests.  ``cast``, when given, maps
    each batch of tensors on the device before the forward."""

    def __init__(self, batch_size: int, max_delay_s: float = 0.05,
                 cast=None):
        self.batch_size = batch_size
        self.max_delay_s = max_delay_s
        self.cast = cast
        self.stats = ServerStats()
        # one thread a mesh device runs its part of each batch, in order
        self._parts = [_futures.ThreadPoolExecutor(1)
                       for _ in getattr(self, "mesh", None) or ()]
        self._q: "queue.Queue" = queue.Queue()
        self._closed = False
        self._close_lock = threading.Lock()
        self._rng = np.random.default_rng(0)
        self._request_ids = itertools.count()
        self._batch_ids = itertools.count()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, request) -> Future:
        fut: Future = Future()
        with self._close_lock:
            if self._closed:
                raise RuntimeError("server closed")
            self._q.put((request, fut, time.time_ns(),
                         next(self._request_ids)))
        return fut

    def close(self) -> None:
        with self._close_lock:
            if not self._closed:
                self._closed = True
                self._q.put(None)
        self._thread.join()
        for pool in self._parts:
            pool.shutdown()

    def _collect(self, first_timeout=None):
        """``None`` blocks until a request; ``0.0`` drains what is queued
        now.  Returns ``None`` on the shutdown sentinel, ``[]`` when a
        bounded wait found nothing."""
        nonblocking = first_timeout == 0.0
        try:
            if nonblocking:
                first = self._q.get_nowait()
            elif first_timeout is not None:
                first = self._q.get(timeout=first_timeout)
            else:
                first = self._q.get()
        except queue.Empty:
            return []
        if first is None:
            return None
        items = [first]
        deadline = time.time() + self.max_delay_s
        while len(items) < self.batch_size:
            try:
                nxt = self._q.get_nowait() if nonblocking else \
                    self._q.get(timeout=max(deadline - time.time(), 0))
            except queue.Empty:
                break
            if nxt is None:
                self._q.put(None)   # re-post sentinel for the outer loop
                break
            items.append(nxt)
        return items

    def _loop(self):
        # a queued item is (request, future, submit ns, request id); a
        # batch in flight (items, state, ids, dispatch start ns, dispatch
        # end ns), ids its batch id and request ids
        inflight = None
        shutdown = False
        while True:
            items = None
            if not shutdown:
                items = self._collect(
                    first_timeout=0.0 if inflight is not None else None)
            if items is None and not shutdown:
                shutdown = True
                items = []
            nxt = None
            if items:
                t0 = time.time_ns()
                ids = {"batch": next(self._batch_ids),
                       "requests": tuple(it[3] for it in items)}
                for _, _, t_sub, rid in items:
                    # submit to the start of the batch's host work
                    profiling.count("server.queue_wait", (t0 - t_sub) * 1e-9,
                                    batch=ids["batch"], request=rid)
                try:
                    state = self._dispatch([it[0] for it in items], ids)
                    nxt = (items, state, ids, t0, time.time_ns())
                except Exception as e:
                    self._fail(items, e)
            if inflight is not None:
                self._resolve(inflight)
            inflight = nxt
            if shutdown and inflight is None:
                return

    def _resolve(self, inflight):
        items, state, ids, t0, t_dispatched = inflight
        try:
            # the answers' wait for the server thread: the end of the
            # batch's dispatch to the start of its readback
            profiling.count("server.hold",
                            (time.time_ns() - t_dispatched) * 1e-9,
                            batch=ids["batch"])
            results = self._finish(state, ids)
            for (_, fut, t_sub, _), res in zip(items, results):
                try:
                    fut.set_result(res)
                except _futures.InvalidStateError:
                    continue    # the client cancelled this request
                self.stats.record_latency((time.time_ns() - t_sub) * 1e-9)
            self.stats.scenes += len(items)
            self.stats.steps += 1
            if self.stats.t_first == 0.0:
                self.stats.t_first = t0 * 1e-9
            self.stats.t_last = time.time()
        except Exception as e:
            self._fail(items, e)

    @staticmethod
    def _fail(items, e):
        for it in items:
            try:
                if not it[1].done():
                    it[1].set_exception(e)
            except _futures.InvalidStateError:
                pass

    def _dispatch(self, reqs, ids):
        """Host work and the asynchronous device enqueue of ``reqs``;
        ``ids`` (``batch``, ``requests``) name its spans."""
        raise NotImplementedError

    def _finish(self, state, ids):
        """Readback and host postprocess: one answer a real request."""
        raise NotImplementedError

    def _place(self, model, mesh, device, batch_size: int) -> None:
        """``self.device``, ``self.mesh`` and ``self.model`` (with
        ``self.mesh_models``, one replica a mesh device) from the
        constructor's arguments; the refusals both servers share."""
        if mesh is not None and device is not None:
            raise ValueError("mesh and device pinning are exclusive: a "
                             "sharded server spans devices, a pinned one "
                             "owns exactly one")
        self.mesh = None
        self.mesh_models: List[Any] = []
        if mesh is None:
            self.device = resolve_device("cuda" if device is None
                                         else device)
            self.model = model
            return
        self.mesh = [resolve_device(d) for d in mesh]
        if not self.mesh:
            raise ValueError("mesh serving needs at least one device")
        if batch_size % len(self.mesh):
            raise ValueError(
                f"batch_size {batch_size} not divisible by the mesh's "
                f"data axis ({len(self.mesh)}); the sharded forward would "
                f"be ragged")
        self.device = self.mesh[0]
        self.mesh_models = replicate(model, self.mesh)
        self.model = self.mesh_models[0]

    def _run_parts(self, np_batch: Dict[str, Any], forward) -> List[Any]:
        """``forward(model, batch on its device)`` of each mesh part of
        ``np_batch`` (its rows split into ``len(mesh)`` equal parts), each
        on its device's thread; returns the parts' futures, in row
        order."""
        n = len(self.mesh)
        b = self.batch_size // n
        parts = [split_rows(np_batch, i * b, (i + 1) * b, self.batch_size)
                 for i in range(n)]

        def run(model, device, part):
            return forward(model, to_device(part, device))
        return [pool.submit(run, m, d, part)
                for pool, m, d, part in zip(self._parts, self.mesh_models,
                                            self.mesh, parts)]


def serving_mesh(devices=None) -> List[torch.device]:
    """The ``data`` axis of a mesh server: ``devices``, or every visible
    card (raises without CUDA: pass ``["cpu", "cpu"]`` to split batches
    on the host)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass devices= to "
                               "serve a mesh on the host")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(d) for d in devices]


def split_rows(tree: Any, lo: int, hi: int, rows: int) -> Any:
    """Rows ``[lo, hi)`` of every array of a collated batch (nested dicts
    included).  Every array of a rectangular batch has the batch's
    ``rows`` leading (JAX's ``shard_batch`` splits each on its dim 0);
    one that has not raises."""
    if isinstance(tree, dict):
        return {k: split_rows(v, lo, hi, rows) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.ndim >= 1:
        if tree.shape[0] != rows:
            raise ValueError(f"a batch array of shape {tree.shape} has no "
                             f"leading dim of {rows} rows to split")
        return tree[lo:hi]
    return tree


def _cat_parts(futs: List[Any]) -> Any:
    """The mesh parts' outputs (tuples or dicts of tensors) read back to
    the host and joined along the rows."""
    parts = [f.result() for f in futs]

    def cat(tensors):
        return torch.cat([t.cpu() for t in tensors])
    if isinstance(parts[0], dict):
        return {k: cat([p[k] for p in parts]) for k in parts[0]}
    return tuple(cat([p[i] for p in parts]) for i in range(len(parts[0])))


def to_device(np_batch: Dict[str, Any], device: torch.device
              ) -> Dict[str, Any]:
    """Numpy batch (with a nested ``maps`` dict) -> tensors on ``device``."""
    def put(v):
        t = torch.from_numpy(np.ascontiguousarray(v))
        return t.to(device, non_blocking=True) if device.type == "cuda" \
            else t
    return {k: ({kk: put(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else put(v))
            for k, v in np_batch.items()}


class InstSegServer(_MicroBatchServer):
    """Micro-batching inference server for the stage-1 instseg model:
    submit one raw scene dict (points/colors/segment_id/...), receive a
    list of {"class", "score", "mask"} instance predictions at full point
    resolution.  ``model`` must already live on ``device``.

    Layouts (from ``pipe_cfg``): rectangular with host maps (needs
    ``level_caps``), rectangular with device-built maps (``device_maps``:
    the model must be built with ``voxel_enc.device_maps == level_caps``
    and ``voxel_enc.device_stem == stem_mode``;
    the server refuses a mismatch either way), the flat pack with host
    maps (``flat_pack``: no ``level_caps`` needed; the first batch, and
    any that overflows it, sets ``pipe_cfg.flat_shape_caps``), or the flat
    pack with device-built maps (``device_maps`` + ``flat_pack``: the
    model's ``voxel_enc.device_flat_caps`` must equal the pipeline's
    complete ``flat_shape_caps``, which never grows; a batch that
    overflows it is refused); ``compact_conv`` adds the compact conv plans
    to the flat pack, and ``level_cap_ladder`` is refused (one shape per
    rung).  A swin3d model's window must equal the
    pipeline's ``swin_window``.  ``cast`` (``utils/inference.
    cast_batch_bf16`` beside a model cast by ``cast_model_bf16``) maps
    each batch on the device before the forward.  With ``num_workers >
    0`` each real scene's ``process_scene`` runs on a spawn pool
    (``data/pool.BatchPool``) with its own seed, the scenes' running
    count; otherwise in process from the server's rng.

    ``mesh`` (a list of devices, ``serving_mesh()``) in place of ``device``
    makes it the mesh server (module docstring): the rectangular layouts
    only, with or without device-built maps, ``batch_size`` a multiple of
    the mesh's length; ``model`` may live anywhere, each device gets its
    replica."""

    def __init__(self, model, pipe_cfg: InstSegPipelineConfig,
                 batch_size: int, num_classes: int, topk: int = 100,
                 score_threshold: float = 0.0, max_delay_s: float = 0.05,
                 extra_features: Optional[Dict[str, int]] = None,
                 device=None, num_workers: int = 0, cast=None, mesh=None):
        if mesh is not None and (pipe_cfg.flat_pack
                                 or pipe_cfg.compact_conv):
            raise ValueError(
                "mesh serving needs the rectangular layout: flat_pack/"
                "compact_conv arrays have no batch dim to shard")
        self._place(model, mesh, device, batch_size)
        if not pipe_cfg.level_caps and not pipe_cfg.flat_pack:
            raise ValueError(
                "serving requires pipe_cfg.level_caps: fixed level pads "
                "keep every batch at one shape (the flat pack buckets its "
                "totals instead)")
        if pipe_cfg.level_cap_ladder and not pipe_cfg.flat_pack:
            raise ValueError(
                "unset pipe_cfg.level_cap_ladder for serving: it overrides "
                "level_caps with one batch shape per rung")
        check_swin_window(model, pipe_cfg)
        ve = getattr(model, "voxel_enc", None)
        caps = tuple(getattr(ve, "device_maps", None) or ())
        flat_caps = dict(getattr(ve, "device_flat_caps", None) or ())
        if pipe_cfg.device_maps and pipe_cfg.flat_pack:
            pcaps = dict(pipe_cfg.flat_shape_caps or {})
            if flat_caps != pcaps:
                diff = {k: (flat_caps.get(k), pcaps.get(k))
                        for k in sorted(set(flat_caps) | set(pcaps))
                        if flat_caps.get(k) != pcaps.get(k)}
                raise ValueError(
                    "pipe_cfg.device_maps + flat_pack needs the model built "
                    "with voxel_enc.device_flat_caps == flat_shape_caps; "
                    f"differing keys (model, pipe): {diff}")
        elif pipe_cfg.device_maps:
            if caps != tuple(pipe_cfg.level_caps):
                raise ValueError(
                    "pipe_cfg.device_maps=True needs the model built with "
                    f"voxel_enc.device_maps == level_caps (model: "
                    f"{caps or None}, pipe: {tuple(pipe_cfg.level_caps)})")
            # the host counts the stem blocks of its stem_mode
            if ve.device_stem != pipe_cfg.stem_mode:
                raise ValueError(
                    "pipe_cfg.device_maps=True needs the model's device "
                    "stem to be the pipeline's: voxel_enc.device_stem == "
                    f"stem_mode; model {ve.device_stem!r}, pipe "
                    f"{pipe_cfg.stem_mode!r}")
        elif caps or flat_caps:
            raise ValueError(
                "the model's voxel_enc.device_maps or device_flat_caps is "
                "set but the pipeline ships host maps: set "
                "pipe_cfg.device_maps=True (the model would look for "
                "'vox_coords' the batch does not carry)")
        self.pipe_cfg = pipe_cfg
        self.num_classes = num_classes
        self.topk = topk
        self.score_threshold = score_threshold
        self.extra_features = extra_features or {}
        self._pool = None
        self._pool_seed = 0
        if num_workers > 0:
            self._pool = BatchPool(num_workers, _init_serve_worker,
                                   (pipe_cfg,))
        super().__init__(batch_size, max_delay_s, cast=cast)

    def close(self) -> None:
        super().close()
        if self._pool is not None:
            self._pool.close()
            self._pool = None

    def _update_flat_lock(self, dims) -> None:
        """Flat-pack shape lock from the traffic: the first batch, and any
        batch that overflows the lock, grows ``pipe_cfg.flat_shape_caps``
        (margin-scaled), so later batches collate to one shape set."""
        if not dims:
            return
        caps = self.pipe_cfg.flat_shape_caps
        if caps is not None and all(v <= caps.get(k, 0)
                                    for k, v in dims.items()):
            return
        new = flat_shape_caps_from(dims, self.pipe_cfg)
        if caps:
            new = {k: max(new.get(k, 0), caps.get(k, 0))
                   for k in set(new) | set(caps)}
        self.pipe_cfg = dataclasses.replace(self.pipe_cfg,
                                            flat_shape_caps=new)

    def _forward(self, batch):
        return self._forward_on(self.model, batch)

    def _forward_on(self, model, batch):
        """The final round's class and mask logits of ``model`` (the
        server's, or a mesh replica) on ``batch``, on its device."""
        if self.cast is not None:
            batch = self.cast(batch)
        with torch.inference_mode():
            out = model(batch)
        return out["predictions_class"][-1], out["predictions_mask"][-1]

    def _preprocess(self, scenes):
        if self._pool is None:
            return [process_scene(s, self.pipe_cfg, self._rng)
                    for s in scenes]
        seeds = range(self._pool_seed, self._pool_seed + len(scenes))
        self._pool_seed += len(scenes)
        return list(self._pool.run(_serve_process_scene,
                                   zip(scenes, seeds)))

    def _dispatch(self, scenes, ids):
        n_real = len(scenes)
        st = self.stats
        with st.stage("preprocess", profiling.span("server.preprocess",
                                                   **ids)):
            processed = self._preprocess(scenes)
        with st.stage("collate", profiling.span("server.collate", **ids)):
            processed += [processed[-1]] * (self.batch_size - n_real)
            np_batch = collate_processed(processed, self.pipe_cfg)
        meta = np_batch.pop("_meta")
        if self.pipe_cfg.flat_pack and not self.pipe_cfg.device_maps:
            # the device flat maps' lock is the model's: it cannot grow,
            # and collate_flat_device refuses a batch that overflows it
            self._update_flat_lock(meta.get("flat_dims"))
        S = self.pipe_cfg.max_segments
        for name, dim in self.extra_features.items():
            # offline per-segment features are not served yet: zero-filled
            np_batch[f"{name}_seg_fts"] = np.zeros(
                (self.batch_size, S, dim), np.float32)
            np_batch[f"{name}_seg_pad_masks"] = np_batch["seg_pad_masks"]
        with st.stage("put_dispatch", profiling.device_span(
                "server.dispatch", **ids)):
            if self.mesh is not None:
                cls_l = self._run_parts(np_batch, self._forward_on)
                mask_l = None
            else:
                cls_l, mask_l = self._forward(to_device(np_batch,
                                                        self.device))
        return (n_real, cls_l, mask_l, np_batch["seg_pad_masks"], meta)

    def _finish(self, state, ids):
        n_real, cls_l, mask_l, seg_valid, meta = state
        st = self.stats
        with st.stage("readback", profiling.device_span(
                "server.readback", **ids)):
            if mask_l is None:          # the mesh parts' futures
                cls_l, mask_l = _cat_parts(cls_l)
            cls_l = cls_l.float().cpu().numpy()
            mask_l = mask_l.float().cpu().numpy()
        with st.stage("rank", profiling.span("server.rank", **ids)):
            return [rank_instances(cls_l[i], mask_l[i], seg_valid[i],
                                   num_classes=self.num_classes,
                                   topk=self.topk,
                                   score_threshold=self.score_threshold,
                                   seg_to_full=meta["segment_to_full"][i])
                    for i in range(n_real)]


class UnifiedServer(_MicroBatchServer):
    """Micro-batching server for the stage-2 unified model: submit
    ``(scene, lang)`` request pairs (the payloads the unified task datasets
    produce: object points, offline features, a tokenized prompt), receive
    ``{"ground_obj", "ground_scores", "generation_tokens", "generation"}``
    per request (the last only with a ``detokenize``).  ``model`` must
    already live on ``device``.

    Stage seconds (``stats.stage_s``): preprocess (``process_item``),
    collate, forward_decode (host-to-device copy, ``cast`` and the enqueue
    of the forward and the greedy decode) and finish (waiting for the
    device, readback, the per-request answers).  With a ``two_phase``
    generation head the forward returns the decoder's input states and
    ``model.decode_states`` is enqueued on them right after, with nothing
    read back between the two.  ``mesh`` (a list of devices) in place of
    ``device`` makes it the mesh server (module docstring), in the padded
    object layout only."""

    def __init__(self, model, pipe_cfg: UnifiedPipelineConfig,
                 batch_size: int, feature_dims: Dict[str, int],
                 detokenize=None, max_delay_s: float = 0.05,
                 device=None, cast=None, mesh=None):
        if mesh is not None and getattr(pipe_cfg, "flat_obj", False):
            raise ValueError(
                "mesh serving needs the padded object layout: flat_obj "
                "arrays have no batch dim to shard")
        self._place(model, mesh, device, batch_size)
        self.pipe_cfg = pipe_cfg
        self.feature_dims = feature_dims
        self.detokenize = detokenize
        super().__init__(batch_size, max_delay_s, cast=cast)

    def _forward(self, batch):
        return self._forward_on(self.model, batch)

    def _forward_on(self, model, batch):
        """``ground_logits`` and ``generation_tokens`` of ``model`` (the
        server's, or a mesh replica) on ``batch``, on its device."""
        if self.cast is not None:
            batch = self.cast(batch)
        with torch.inference_mode():
            out = model(batch)
            if "generation_enc" in out:
                out["generation_tokens"] = model.decode_states(
                    out["generation_enc"], out["generation_enc_mask"])
        return {k: out[k] for k in ("ground_logits", "generation_tokens")
                if k in out}

    def _dispatch(self, reqs, ids):
        n_real = len(reqs)
        st = self.stats
        with st.stage("preprocess"):
            processed = []
            for scene, lang in reqs:
                item = process_item(scene, lang, self.pipe_cfg, self._rng,
                                    False, self.feature_dims)
                processed.append({k: v for k, v in item.items()
                                  if not k.startswith("meta_")})
        with st.stage("collate"):
            processed += [processed[-1]] * (self.batch_size - n_real)
            np_batch = collate_unified(processed, self.pipe_cfg,
                                       self.feature_dims, train=False)
            # obj_fts is the array pc_seg_fts holds; without a response
            # the model skips the teacher-forced logits, which serving
            # does not use
            np_batch = {k: v for k, v in np_batch.items()
                        if k not in ("obj_fts", "response")}
        with st.stage("forward_decode"):
            if self.mesh is not None:
                out = self._run_parts(np_batch, self._forward_on)
            else:
                out = self._forward(to_device(np_batch, self.device))
        return (n_real, out, np_batch["query_pad_masks"])

    def _finish(self, state, ids):
        n_real, out, obj_valid = state
        with self.stats.stage("finish"):
            if isinstance(out, list):   # the mesh parts' futures
                out = _cat_parts(out)
            out = {k: v.float().cpu().numpy() if v.is_floating_point()
                   else v.cpu().numpy() for k, v in out.items()}
            # object slots are query slots in the unified batch (one
            # query per candidate object)
            results = []
            for i in range(n_real):
                r: Dict[str, Any] = {}
                if "ground_logits" in out:
                    scores = np.where(obj_valid[i], out["ground_logits"][i],
                                      -np.inf)
                    r["ground_scores"] = scores
                    # no valid candidate: None, not an argmax over padding
                    r["ground_obj"] = (int(np.argmax(scores))
                                       if obj_valid[i].any() else None)
                if "generation_tokens" in out:
                    toks = out["generation_tokens"][i]
                    r["generation_tokens"] = toks
                    if self.detokenize is not None:
                        r["generation"] = self.detokenize(toks.tolist())
                results.append(r)
        return results


class ReplicatedServer:
    """One server replica per device in one process: ``factory(device)``
    is called once per device and returns a started server pinned to it
    (``InstSegServer`` or ``UnifiedServer`` with ``device=device``; the
    model on that device).  A request goes to the replica with the
    shallowest queue, ties broken round-robin, so partial batches spread
    evenly; each replica owns its device, so the single-device layouts
    (the flat pack, device-built maps) serve on every card unchanged.
    ``devices`` defaults to every visible card and raises without CUDA
    (pass ``["cpu", "cpu"]`` to replicate on the host)."""

    def __init__(self, factory, devices=None):
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError("CUDA is not available; pass devices= "
                                   "to replicate on the host")
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        devices = list(devices)
        if not devices:
            raise ValueError("no devices to replicate over")
        self.replicas = [factory(d) for d in devices]
        self._rr = 0
        self._lock = threading.Lock()

    def submit(self, request) -> Future:
        with self._lock:
            depths = [r._q.qsize() for r in self.replicas]
            n = len(depths)
            best = min(range(n),
                       key=lambda i: (depths[i], (i - self._rr) % n))
            self._rr = (best + 1) % n
        return self.replicas[best].submit(request)

    def close(self) -> None:
        for r in self.replicas:
            r.close()

    def stats_summary(self) -> Dict[str, Any]:
        per = [r.stats.summary() for r in self.replicas]
        return {"replicas": per,
                "scenes": sum(p["scenes"] for p in per),
                "scenes_per_sec": sum(p["scenes_per_sec"] for p in per)}
