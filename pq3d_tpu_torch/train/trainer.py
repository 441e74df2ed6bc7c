"""Trainers: config-driven host orchestration of the train and eval steps;
counterpart of ``prefetch_batches``, ``Query3DTrainer`` (stage 1) and
``MultitaskTrainer`` (stage 2) in ``pq3d_tpu/train/trainer.py``.

The host pipeline runs in a background thread (``prefetch_batches``) so
it overlaps the step on the card.  The optimizer and schedule are built once
(``_lazy_init``, at the start of ``run`` or on the first batch), where
``resume`` also restores ``latest`` and the epoch to continue from; without
a resume, ``pretrain_ckpt_path`` warm-starts the model non-strictly from
another run's checkpoint (same name and shape) or from the reference's
torch weights (``pytorch_model*.bin``, ``utils/hf_import``).  Each epoch saves
``latest``, every ``epochs_per_save`` epochs ``ckpt_N``, and every
improvement of the evaluator's target metric ``best``.  SIGUSR1 or
SIGTERM saves ``latest`` after the current step and ends the run, so a
requeued job resumes.  Randomness is seeded and checkpointed: before
the first step ``_lazy_init`` seeds torch's default generators (the CPU's
and the cards'), which every dropout draws from, and the generator on the
model's device that train-mode memory dropout draws from, all from
``rng_seed``; each checkpoint holds their states, and a resume restores
them over the seeding, so a resumed run takes the masks an unbroken one
would.  Under ``gradient_accumulation_steps`` k a batch is a micro-step:
``step`` counts optimizer steps, one every k batches, and the window in
progress is checkpointed too.  Loaders with worker pools are closed when
``run`` ends.

Data parallel: under a process group (``parallel/dist.py``; the launcher,
``pq3d_tpu_torch.launch``, makes one) each rank trains on its rows of the
global batch ``dataloader.batchsize`` (the loaders split it; ``run.py``
holds the world size to dividing it), as the JAX package's sharded step
does.
The model is wrapped in ``DistributedDataParallel`` after ``_lazy_init``
has restored or warm-started it, so every rank starts from the same
weights.  Dropout on rank r draws from generators seeded ``rng_seed + r``;
a checkpoint gathers every rank's generator states (and open accumulation
window) and a resume restores each rank's own; it holds the unwrapped
module's state dict, so one process and a group load each other's
checkpoints.  Only rank 0 writes checkpoints, the metrics log and
``results.json``; before each save the ranks' weight checksums must agree.
A preemption signal on any rank stops every rank (an all-reduce of the
flag after each step), so no rank leaves the others waiting in a
collective.

On a sharded mesh (``parallel.fsdp`` or ``parallel.tp`` above 1; ``run.py``
makes the mesh, ``parallel/mesh.py``) the rows split over the row group
(``dist.rows`` ranks; tp peers share theirs) and ``_lazy_init`` places the
restored or warm-started model on the mesh (``mesh.shard_params``) in
place of the DDP wrap: each rank keeps its blocks of the parameters and,
as AdamW makes them, of the moments; a full optimizer state restored from
a checkpoint is cut to the blocks.  Dropout seeds take the row index
(``rng_seed + dist.row_index()``), so tp peers draw the same masks.  A
checkpoint holds the gathered model and optimizer state in one process's
format (every rank gathers it, rank 0 writes it), so one process and any
mesh resume each other's checkpoints; its ``rank_checksums`` are those of
the gathered state, which must agree.
"""
from __future__ import annotations

import os
import queue
import threading
import time
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch

from pq3d_tpu_torch.device import resolve_device
from pq3d_tpu_torch.parallel import dist
from pq3d_tpu_torch.eval.base import ROW_LISTS, truncate_batch_rows
from pq3d_tpu_torch.serve import to_device
from pq3d_tpu_torch.train.checkpoints import (CheckpointManager,
                                              find_pretrain,
                                              load_pretrain,
                                              load_reference_state_dict,
                                              reference_weights)
from pq3d_tpu_torch.train.metrics import ExpTracker, MetricsLogger
from pq3d_tpu_torch.train.state import make_eval_step, make_train_step
from pq3d_tpu_torch.utils.hf_import import import_query3d
from pq3d_tpu_torch.utils.profiling import StepProfiler


def prefetch_batches(batch_iter: Iterable, n_prefetch: int = 2):
    """Background-thread prefetch so host preprocessing (voxelize, kernel
    maps, FPS) overlaps the step on the card; a failing loader raises in
    the consumer instead of ending the epoch early."""
    q: "queue.Queue" = queue.Queue(maxsize=n_prefetch)
    sentinel = object()
    err: list = []

    def worker():
        try:
            for b in batch_iter:
                q.put(b)
        except BaseException as e:
            err.append(e)
        finally:
            q.put(sentinel)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        b = q.get()
        if b is sentinel:
            if err:
                raise RuntimeError("data loader thread failed") from err[0]
            break
        yield b


def _to_numpy(out: Dict[str, Any]) -> Dict[str, Any]:
    def conv(v):
        if isinstance(v, torch.Tensor):
            return v.float().cpu().numpy()
        if isinstance(v, (list, tuple)):
            return [conv(x) for x in v]
        return v
    return {k: conv(v) for k, v in out.items()}


def _mean_window(states: List[Dict[str, Any]]) -> Dict[str, Any]:
    """The mean of several ranks' accumulation windows (same step)."""
    accs = [st["acc"] for st in states]
    return {"mini_step": states[0]["mini_step"],
            "acc": None if accs[0] is None else
            [sum(parts) / len(parts) for parts in zip(*accs)]}


class Query3DTrainer:
    """Stage-1 (instseg) trainer.  ``train_data`` / ``val_data`` are
    callables ``epoch -> iterable of numpy batches``."""

    def __init__(self, cfg: Dict[str, Any], model, loss_fn, train_data,
                 val_data=None, evaluator=None,
                 total_steps: Optional[int] = None, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.loss_fn = loss_fn
        self.train_data = train_data
        self.val_data = val_data
        self.evaluator = evaluator
        solver = cfg["solver"]
        self.epochs = int(solver["epochs"])
        self.epochs_per_eval = int(solver.get("epochs_per_eval", 0) or 0)
        self.epochs_per_save = int(solver.get("epochs_per_save", 0) or 0)
        self.exp_dir = cfg.get("exp_dir") or os.path.join(
            cfg.get("base_dir", "outputs"), cfg.get("name", "exp"))
        self.rank, self.world = dist.rank(), dist.world()
        self.logger = MetricsLogger(self.exp_dir) if self.rank == 0 else None
        self.tracker = ExpTracker()
        self.ckpt = CheckpointManager(os.path.join(self.exp_dir, "ckpt"))
        # opt-in trace of train steps profile_wait .. + profile_active
        self.profiler = StepProfiler(
            os.path.join(self.exp_dir, "trace"),
            wait=int(cfg.get("profile_wait", 10)),
            active=int(cfg.get("profile_active", 10)),
            enabled=bool(cfg.get("profile", False)), rank=self.rank)
        self.step = 0                       # optimizer steps
        self._total_steps = total_steps
        self._optimizer = self._scheduler = self._grad_norm = None
        self._accumulator = self._memory_generator = None
        self._train_step = self._eval_step = None
        self.ddp: Optional[torch.nn.Module] = None
        self.sharding = None                # parallel/mesh.Sharding
        self._preempted = False
        self.warm_started: List[str] = []   # names a warm start loaded
        # a reference-weights warm start's report (utils/hf_import)
        self.warm_start_report: Optional[Dict[str, list]] = None

    def _lazy_init(self):
        from pq3d_tpu_torch.optim.optimizers import (GradientAccumulator,
                                                     accumulation_steps,
                                                     build_from_config)
        seed = int(self.cfg.get("rng_seed", 42)) + dist.row_index()
        torch.manual_seed(seed)
        self._memory_generator = torch.Generator(
            device=self.device).manual_seed(seed)
        self.model.unified_encoder.set_memory_generator(
            self._memory_generator)
        total = self._total_steps or (self.epochs * 1000)
        self._optimizer, self._scheduler, self._grad_norm = \
            build_from_config(self.cfg, self.model, total)
        k = accumulation_steps(self.cfg)
        self._accumulator = GradientAccumulator(k) if k > 1 else None
        n_params = sum(p.numel() for p in self.model.parameters())
        print(f"[trainer] initialized: {n_params / 1e6:.2f}M params, "
              f"exp_dir={self.exp_dir}")
        if self.cfg.get("resume") and self.ckpt.exists("latest"):
            self.step, tr, extra = self.ckpt.restore(
                "latest", self.model, self._optimizer, self._scheduler)
            self.tracker.load_state_dict(tr)
            self._restore_rank_state(extra)
            print(f"[trainer] resumed from epoch {self.tracker.epoch}")
        elif self.cfg.get("pretrain_ckpt_path"):
            self.warm_started = self._warm_start(
                str(self.cfg["pretrain_ckpt_path"]))
        mesh = dist.get_mesh()
        if mesh is not None and mesh.cfg.sharded:
            from pq3d_tpu_torch.parallel.mesh import shard_params
            self.sharding = shard_params(self.model, mesh)
            self.sharding.shard_optimizer_state(self._optimizer)
        elif dist.is_initialized():
            from torch.nn.parallel import DistributedDataParallel
            ids = [self.device.index if self.device.index is not None
                   else torch.cuda.current_device()] \
                if self.device.type == "cuda" else None
            # BatchNorm statistics are global, so every rank's buffers are
            # already equal; parameters a step does not reach (the U-Net's
            # final layer, frozen towers) keep no gradient
            self.ddp = DistributedDataParallel(
                self.model, device_ids=ids, broadcast_buffers=False,
                find_unused_parameters=True)
        self._train_step = make_train_step(self.model, self._optimizer,
                                           self._scheduler, self.loss_fn,
                                           self._grad_norm,
                                           accumulator=self._accumulator,
                                           ddp=self.ddp,
                                           sharding=self.sharding)
        self._eval_step = make_eval_step(self.model, self.loss_fn,
                                         self.sharding)

    def _warm_start(self, path: str) -> List[str]:
        """Non-strict warm start: from another run's checkpoint (stage 2
        from stage 1: same-named, same-shaped parameters and BatchNorm
        statistics), or from the reference's torch weights
        (``pytorch_model*.bin``, through ``utils/hf_import.import_query3d``
        with the config's memories, as the JAX trainer); returns the
        loaded names (flax paths for reference weights)."""
        ckpt = find_pretrain(path)
        if ckpt is not None:
            state = torch.load(ckpt, map_location="cpu",
                               weights_only=False)["model"]
            loaded = load_pretrain(self.model, state)
            print(f"[trainer] warm start from {ckpt}: {len(loaded)} tensors "
                  f"loaded")
            return loaded
        files = reference_weights(path)
        if not files:
            print(f"[trainer] warm start: nothing loadable at {path!r}")
            return []
        memories = tuple(self.cfg["model"].get(
            "memories", ("mv", "pc", "voxel", "prompt")))
        report = import_query3d(load_reference_state_dict(files),
                                self.model, memories=memories)
        self.warm_start_report = report
        print(f"[trainer] warm start from {len(files)} torch file(s): "
              f"{len(report['loaded'])} loaded, "
              f"{len(report['missing'])} missing, "
              f"{len(report['mismatched'])} mismatched, "
              f"{len(report['unused'])} unused")
        return report["loaded"]

    def _put(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        return to_device({k: v for k, v in batch.items()
                          if not k.startswith("_")}, self.device)

    def _rng_state(self) -> Dict[str, torch.Tensor]:
        """The states of the generators the train step draws from."""
        state = {"cpu": torch.get_rng_state(),
                 "memory": self._memory_generator.get_state()}
        if self.device.type == "cuda":
            state["cuda"] = torch.cuda.get_rng_state(self.device)
        return state

    def _set_rng_state(self, state: Dict[str, torch.Tensor]) -> None:
        torch.set_rng_state(state["cpu"])
        self._memory_generator.set_state(state["memory"])
        if self.device.type == "cuda":
            torch.cuda.set_rng_state(state["cuda"], self.device)

    def _rank_state(self) -> Dict[str, Any]:
        """What differs between ranks: the generators' states and an open
        accumulation window."""
        state: Dict[str, Any] = {"rng": self._rng_state()}
        if self._accumulator is not None:
            state["accumulator"] = self._accumulator.state_dict()
        return state

    def _restore_rank_state(self, extra: Dict[str, Any]) -> None:
        """This rank's entry of a checkpoint's ``ranks`` when the world
        matches the one that saved it.  Across worlds: generators from the
        top-level entry in one process (rank 0's), else fresh ones (the
        dropout draws differ anyway); the open accumulation window as the
        mean of the saver's ranks' windows (what one process holds, up to
        rounding: the window is linear in the gradients) for every rank."""
        ranks = extra.get("ranks")
        if ranks is not None and len(ranks) == self.world:
            state = ranks[self.rank]
        else:
            state = {}
            if self.world == 1:
                state["rng"] = extra.get("rng")
            else:
                print(f"[trainer] checkpoint saved by "
                      f"{len(ranks) if ranks else 1} rank(s), resumed by "
                      f"{self.world}: fresh generators")
            if ranks is not None and "accumulator" in ranks[0]:
                state["accumulator"] = _mean_window(
                    [r["accumulator"] for r in ranks])
            elif "accumulator" in extra:
                state["accumulator"] = extra["accumulator"]
        if state.get("rng") is not None:    # absent from older checkpoints
            self._set_rng_state(state["rng"])
        if self._accumulator is not None and "accumulator" in state:
            self._accumulator.load_state_dict(state["accumulator"],
                                              self.device)

    def _save(self, name: str) -> None:
        """Every rank calls it; rank 0 writes.  One process keeps its
        ``rng`` / ``accumulator`` at the top level; under a process group
        ``ranks`` holds every rank's (the top-level ``rng`` is rank 0's),
        and ``rank_checksums`` the weights' checksums, which must
        agree."""
        extra = self._rank_state()
        model_state = optimizer_state = None
        if self.sharding is not None:
            from pq3d_tpu_torch.parallel.mesh import full_state_dict
            model_state = full_state_dict(self.model)
            optimizer_state = self.sharding.full_optimizer_state(
                self._optimizer)
        if dist.is_initialized():
            sums = dist.all_gather_object(
                dist.param_checksum(self.model) if model_state is None
                else dist.tensor_checksum(list(model_state.values())))
            if len(set(sums)) != 1:
                raise RuntimeError(f"the ranks' weights differ before "
                                   f"saving {name!r}: checksums {sums}")
            extra = {"rng": extra["rng"], "rank_checksums": sums,
                     "ranks": dist.gather_object(extra)}
        if self.rank == 0:
            self.ckpt.save(name, self.model, self._optimizer,
                           self._scheduler, self.step,
                           self.tracker.state_dict(), extra,
                           model_state=model_state,
                           optimizer_state=optimizer_state)

    def _log(self, metrics: Dict[str, Any], prefix: str) -> None:
        if self.logger is not None:
            self.logger.log(metrics, self.step, prefix=prefix)

    def train_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """One train step (under accumulation, one micro-step) on a numpy
        batch; logs every ``log_every`` optimizer steps."""
        dev_batch = self._put(batch)
        if self._train_step is None:
            self._lazy_init()
        metrics = self._train_step(dev_batch)
        self.profiler.step()
        if self._accumulator is not None and self._accumulator.mini_step:
            return metrics              # inside an accumulation window
        self.step += 1
        if self.step % int(self.cfg.get("log_every", 10)) == 0:
            host = {k: float(v) for k, v in metrics.items()}
            host["lr"] = self._scheduler.get_last_lr()[0]
            self._log(host, "train")
        return metrics

    def install_preemption_handler(self, signals=None) -> None:
        import signal as _signal
        signals = signals or (_signal.SIGUSR1, _signal.SIGTERM)

        def _handler(signum, frame):
            print(f"[trainer] signal {signum}: checkpointing for requeue")
            self._preempted = True

        for s in signals:
            try:
                _signal.signal(s, _handler)
            except (ValueError, OSError):   # not the main thread
                pass

    def _handle_preemption(self) -> bool:
        self._preempted = dist.any_rank(self._preempted)
        if not self._preempted:
            return False
        if self._train_step is not None:
            self._save("latest")
        print("[trainer] latest checkpoint saved; exiting for requeue")
        return True

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        t0 = time.time()
        last: Dict[str, torch.Tensor] = {}
        n = 0
        for batch in prefetch_batches(self.train_data(epoch)):
            last = self.train_batch(batch)
            n += 1
            if dist.any_rank(self._preempted):
                break
        out = {k: float(v) for k, v in last.items()}
        out["epoch_time_s"] = time.time() - t0
        out["batches"] = n
        return out

    def eval_epoch(self, epoch: int) -> Dict[str, float]:
        if self.val_data is None or self.evaluator is None:
            return {}
        self.evaluator.reset()
        for batch in prefetch_batches(self.val_data(epoch)):
            n_real = (batch.get("_meta") or {}).get("n_real")
            if self._eval_step is None:     # eval before any training
                self._lazy_init()
            # every rank runs the forward (its loss sums counts over the
            # ranks); a rank whose rows are all wrap padding scores none
            out_np = _to_numpy(self._eval_step(self._put(batch)))
            if n_real == 0:
                continue
            bat_np = {k: v for k, v in batch.items()
                      if not k.startswith("_")}
            if n_real:
                rows = int(bat_np["query_pad_masks"].shape[0])
                out_np = truncate_batch_rows(out_np, n_real, rows)
                bat_np = truncate_batch_rows(bat_np, n_real, rows)
            self.evaluator.update(out_np, bat_np)
        results = self.evaluator.record()
        self._log(results, "val")
        if self.rank == 0:
            print(f"[eval {epoch}] " + " ".join(
                f"{k}={v:.4f}" for k, v in results.items()
                if isinstance(v, float)))
        return results

    def _save_epoch_ckpts(self, epoch: int) -> None:
        self._save("latest")
        if self.epochs_per_save and (epoch + 1) % self.epochs_per_save == 0:
            self._save(f"ckpt_{epoch + 1}")

    def _close_loaders(self) -> None:
        """Release the loaders' worker pools (each worker holds a copy of
        its dataset)."""
        for ld in (self.train_data, self.val_data):
            if hasattr(ld, "close"):
                ld.close()

    def run(self):
        self.install_preemption_handler()
        if self._train_step is None:
            # restores the tracker on resume before the epoch range is set
            self._lazy_init()
        try:
            for epoch in range(self.tracker.epoch, self.epochs):
                metrics = self.train_epoch(epoch)
                if self._handle_preemption():
                    return
                print(f"[epoch {epoch}] loss="
                      f"{metrics.get('loss', float('nan')):.4f} "
                      f"({metrics.get('batches', 0)} steps, "
                      f"{metrics.get('epoch_time_s', 0):.1f}s)")
                self.tracker.epoch = epoch + 1
                if self.epochs_per_eval and \
                        (epoch + 1) % self.epochs_per_eval == 0:
                    results = self.eval_epoch(epoch)
                    if self.tracker.is_better(
                            results.get("target_metric", 0.0)):
                        self._save("best")
                self._save_epoch_ckpts(epoch)
        finally:
            self.profiler.close()
            self._close_loaders()


class DefaultTrainer(Query3DTrainer):
    """The generic epoch-loop trainer: Query3DTrainer under the second name
    the JAX package registers (configs select either)."""


class MultitaskTrainer(Query3DTrainer):
    """Stage-2 trainer: ``train_data`` is the mixed task loader,
    ``val_sets`` a list of ``(name, loader, evaluator)``.  Evaluation
    detokenizes the greedy tokens into ``answer_pred`` / ``caption_pred``
    (with each row's ``task_id``), gives the evaluators the batch with its
    ``_meta`` fields and the integer ``tgt_object_id``, scores only the
    real rows of a wrap-padded batch, prefixes every metric with its
    dataset's name and sums the datasets' ``target_metric``."""

    def __init__(self, cfg: Dict[str, Any], model, loss_fn, train_data,
                 val_sets=None, detokenize=None,
                 total_steps: Optional[int] = None, device="cuda"):
        super().__init__(cfg, model, loss_fn, train_data, None, None,
                         total_steps=total_steps, device=device)
        self.val_sets = list(val_sets or [])
        self.detokenize = detokenize or (lambda toks: "")

    def postprocess_for_eval(self, out: Dict[str, Any],
                             batch: Dict[str, Any]) -> Dict[str, Any]:
        host_out: Dict[str, Any] = {
            k: v.float().cpu().numpy() for k, v in out.items()
            if k in ("og3d_logits", "ground_logits", "generation_logits",
                     "answer_scores")}
        if "generation_tokens" in out:
            texts = [self.detokenize(t)
                     for t in out["generation_tokens"].cpu().numpy()]
            host_out["answer_pred"] = texts
            host_out["caption_pred"] = texts
            host_out["task_id"] = np.asarray(batch["task_id"])
        return host_out

    def eval_epoch(self, epoch: int) -> Dict[str, float]:
        all_results: Dict[str, float] = {}
        target = 0.0
        for name, loader, evaluator in self.val_sets:
            evaluator.reset()
            for batch in prefetch_batches(loader(epoch)):
                meta = batch.get("_meta") or {}
                n_real = meta.get("n_real")
                if self._eval_step is None:     # eval before any training
                    self._lazy_init()
                out = self._eval_step(self._put(batch))
                if n_real == 0:         # this rank's rows: all padding
                    continue
                host_out = self.postprocess_for_eval(out, batch)
                eval_batch = {k: np.asarray(v) for k, v in batch.items()
                              if not k.startswith("_")}
                eval_batch.update({k: v for k, v in meta.items()
                                   if k != "n_real"})
                if "tgt_object_id_int" in eval_batch:
                    eval_batch["tgt_object_id"] = \
                        eval_batch["tgt_object_id_int"]
                if n_real:
                    rows = int(eval_batch["query_pad_masks"].shape[0])
                    host_out = truncate_batch_rows(host_out, n_real, rows)
                    # the meta lists, merged in above, are per row
                    eval_batch = truncate_batch_rows(
                        eval_batch, n_real, rows, ROW_LISTS | set(meta))
                evaluator.update(host_out, eval_batch)
            results = evaluator.record()
            for k, v in results.items():
                all_results[f"{name}/{k}"] = v
            target += results.get("target_metric", 0.0)
            self._log(results, f"val-{name}")
        all_results["target_metric"] = target
        if self.rank == 0:
            print(f"[eval {epoch}] " + " ".join(
                f"{k}={v:.4f}" for k, v in all_results.items()))
        return all_results
