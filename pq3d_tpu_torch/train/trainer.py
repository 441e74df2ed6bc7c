"""Trainers: config-driven host orchestration of the train and eval steps;
counterpart of ``prefetch_batches``, ``Query3DTrainer`` (stage 1) and
``MultitaskTrainer`` (stage 2) in ``pq3d_tpu/train/trainer.py``.

One card, no mesh (multi-GPU data parallelism is a later slice).  The host
pipeline runs in a background thread (``prefetch_batches``) so it overlaps
the step on the card.  The optimizer and schedule are built once
(``_lazy_init``, at the start of ``run`` or on the first batch), where
``resume`` also restores ``latest`` and the epoch to continue from; without
a resume, ``pretrain_ckpt_path`` warm-starts the model non-strictly (same
name and shape) from another run's checkpoint.  Each epoch saves
``latest``, every ``epochs_per_save`` epochs ``ckpt_N``, and every
improvement of the evaluator's target metric ``best``.  SIGUSR1 or
SIGTERM saves ``latest`` after the current step and ends the run, so a
requeued job resumes.  Train-mode memory dropout draws from a generator
on the model's device that ``_lazy_init`` seeds from ``rng_seed`` (a resume
seeds it afresh; its state is not checkpointed).  Loaders with worker
pools are closed when ``run`` ends.
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
from pq3d_tpu_torch.eval.base import truncate_batch_rows
from pq3d_tpu_torch.serve import to_device
from pq3d_tpu_torch.train.checkpoints import (CheckpointManager,
                                              find_pretrain, load_pretrain)
from pq3d_tpu_torch.train.metrics import ExpTracker, MetricsLogger
from pq3d_tpu_torch.train.state import make_eval_step, make_train_step


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
        self.logger = MetricsLogger(self.exp_dir)
        self.tracker = ExpTracker()
        self.ckpt = CheckpointManager(os.path.join(self.exp_dir, "ckpt"))
        self.step = 0
        self._total_steps = total_steps
        self._optimizer = self._scheduler = self._grad_norm = None
        self._train_step = self._eval_step = None
        self._preempted = False
        self.warm_started: List[str] = []   # names a warm start loaded

    def _lazy_init(self):
        from pq3d_tpu_torch.optim.optimizers import build_from_config
        self.model.unified_encoder.set_memory_generator(torch.Generator(
            device=self.device).manual_seed(int(self.cfg.get("rng_seed",
                                                             42))))
        total = self._total_steps or (self.epochs * 1000)
        self._optimizer, self._scheduler, self._grad_norm = \
            build_from_config(self.cfg, self.model, total)
        self._train_step = make_train_step(self.model, self._optimizer,
                                           self._scheduler, self.loss_fn,
                                           self._grad_norm)
        self._eval_step = make_eval_step(self.model, self.loss_fn)
        n_params = sum(p.numel() for p in self.model.parameters())
        print(f"[trainer] initialized: {n_params / 1e6:.2f}M params, "
              f"exp_dir={self.exp_dir}")
        if self.cfg.get("resume") and self.ckpt.exists("latest"):
            self.step, tr = self.ckpt.restore(
                "latest", self.model, self._optimizer, self._scheduler)
            self.tracker.load_state_dict(tr)
            print(f"[trainer] resumed from epoch {self.tracker.epoch}")
        elif self.cfg.get("pretrain_ckpt_path"):
            self.warm_started = self._warm_start(
                str(self.cfg["pretrain_ckpt_path"]))

    def _warm_start(self, path: str) -> List[str]:
        """Non-strict warm start from another run's checkpoint (stage 2
        from stage 1): same-named, same-shaped parameters and BatchNorm
        statistics; returns the loaded names."""
        ckpt = find_pretrain(path)
        if ckpt is None:
            print(f"[trainer] warm start: nothing loadable at {path!r}")
            return []
        state = torch.load(ckpt, map_location="cpu",
                           weights_only=False)["model"]
        loaded = load_pretrain(self.model, state)
        print(f"[trainer] warm start from {ckpt}: {len(loaded)} tensors "
              f"loaded")
        return loaded

    def _put(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        return to_device({k: v for k, v in batch.items()
                          if not k.startswith("_")}, self.device)

    def _save(self, name: str) -> None:
        self.ckpt.save(name, self.model, self._optimizer, self._scheduler,
                       self.step, self.tracker.state_dict())

    def train_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """One train step on a numpy batch; logs every ``log_every``."""
        dev_batch = self._put(batch)
        if self._train_step is None:
            self._lazy_init()
        metrics = self._train_step(dev_batch)
        self.step += 1
        if self.step % int(self.cfg.get("log_every", 10)) == 0:
            host = {k: float(v) for k, v in metrics.items()}
            host["lr"] = self._scheduler.get_last_lr()[0]
            self.logger.log(host, self.step)
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
            if self._preempted:
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
            n_real = int((batch.get("_meta") or {}).get("n_real", 0))
            if self._eval_step is None:     # eval before any training
                self._lazy_init()
            out_np = _to_numpy(self._eval_step(self._put(batch)))
            bat_np = {k: v for k, v in batch.items()
                      if not k.startswith("_")}
            if n_real:
                rows = int(bat_np["query_pad_masks"].shape[0])
                out_np = truncate_batch_rows(out_np, n_real, rows)
                bat_np = truncate_batch_rows(bat_np, n_real, rows)
            self.evaluator.update(out_np, bat_np)
        results = self.evaluator.record()
        self.logger.log(results, self.step, prefix="val")
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
            self._close_loaders()


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
                n_real = int(meta.get("n_real", 0))
                if self._eval_step is None:     # eval before any training
                    self._lazy_init()
                out = self._eval_step(self._put(batch))
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
                    eval_batch = truncate_batch_rows(eval_batch, n_real,
                                                     rows)
                evaluator.update(host_out, eval_batch)
            results = evaluator.record()
            for k, v in results.items():
                all_results[f"{name}/{k}"] = v
            target += results.get("target_metric", 0.0)
            self.logger.log(results, self.step, prefix=f"val-{name}")
        all_results["target_metric"] = target
        print(f"[eval {epoch}] " + " ".join(
            f"{k}={v:.4f}" for k, v in all_results.items()))
        return all_results
