"""The runner's remaining options in the port against the JAX package's,
on the CPU.

- ``run.experiment_name`` with ``naming_keywords`` equal to
  ``pq3d_tpu.run.experiment_name`` on the same config
  (``tests/test_config.py:55``), ``b<batchsize x N>`` with JAX's device
  count and the port's world size both N (1 and 2), ``Debug_test`` under
  ``debug.flag``.
- The DBSCAN split (``InstSegEval(use_dbscan=True)``): the same masks in
  the same order as JAX's scikit-learn split, on random masks at the
  default eps and on clusters exactly eps apart (linked: eps is
  inclusive), and ``dbscan_labels`` equal to scikit-learn's labels.
- ``StepProfiler``: the trace starts and stops at the same step calls as
  JAX's (``jax.profiler.start_trace`` / ``stop_trace`` patched to count
  them), and ``close()`` stops an open trace in both.
- ``python -m pq3d_tpu_torch.run`` trains 2 steps of the tiny stage-1
  config with each new option: ``grad_mode: native`` with
  ``remat_policy: dots``, ``sorted_gather`` and ``int8_gather`` (off in
  training, as in JAX); ``level_cap_ladder``; the flat pack with
  ``compact_conv``; and ``profile: true`` writes a torch.profiler trace of
  step 2 into ``exp_dir/trace``.
"""
import json
import os
import shutil

import numpy as np
import pytest
import torch

from pq3d_tpu.config import Config
from pq3d_tpu.eval import instseg_eval as jeval
from pq3d_tpu.run import experiment_name as jname
from pq3d_tpu.utils import profiling as jprof
from pq3d_tpu_torch import run as trun
from pq3d_tpu_torch.eval import instseg_eval as teval
from pq3d_tpu_torch.utils import profiling as tprof

from test_torch_trainer import TINY

torch.set_num_threads(1)


@pytest.mark.parametrize("cfg", [
    {"name": "pq3d", "task": "Query3D",
     "naming_keywords": ["task", "dataloader.batchsize", "solver.lr"],
     "data": {"train": ["A", "B"]}, "dataloader": {"batchsize": 4},
     "solver": {"lr": 0.0001}, "debug": {"flag": False}},
    {"name": "inst", "task": "InstSeg",
     "naming_keywords": ["time", "task", "model.hidden_size", "missing.key",
                         "dataloader.batchsize"],
     "data": {"note": "sv", "train": ["X"]}, "model": {"hidden_size": 768},
     "dataloader": {"batchsize": 2}},
    {"name": "plain"},
    {"name": "dbg", "naming_keywords": ["task"], "debug": {"flag": True}},
], ids=["task_bs_lr", "note_time_missing", "no_keywords", "debug"])
@pytest.mark.parametrize("world", [1, 2])
def test_experiment_name_matches_jax(monkeypatch, cfg, world):
    """The JAX runner's device count and the port's world size set alike
    (the port's ranks are the JAX package's devices)."""
    import jax
    from pq3d_tpu_torch.parallel import dist
    monkeypatch.setattr(jax, "devices", lambda *a: [None] * world)
    monkeypatch.setattr(dist, "world", lambda: world)
    got = trun.experiment_name(json.loads(json.dumps(cfg)))
    assert got == jname(Config(cfg))
    if cfg["name"] == "pq3d":
        assert got == f"pq3d_Query3D_A+B_b{4 * world}_0.0001"


def _pred_sets(seed):
    """Random predictions over a scene of clustered points."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, 8, (6, 3))
    pts = np.concatenate([c + rng.normal(0, 0.3, (300, 3))
                          for c in centers]).astype(np.float32)
    preds = []
    for k in range(8):
        mask = rng.random(len(pts)) < rng.uniform(0.05, 0.6)
        preds.append({"class": int(k % 5), "score": float(rng.random()),
                      "mask": mask})
    preds.append({"class": 1, "score": 0.5,
                  "mask": np.eye(1, len(pts), 7, dtype=bool)[0]})
    return preds, pts


def _same_preds(a, b):
    assert len(a) == len(b)
    for p, q in zip(a, b):
        assert p["class"] == q["class"] and p["score"] == q["score"]
        np.testing.assert_array_equal(p["mask"], q["mask"])


@pytest.mark.parametrize("seed", [0, 1])
def test_dbscan_split_matches_jax(seed):
    preds, pts = _pred_sets(seed)
    ref = jeval.InstSegEval(use_dbscan=True)._dbscan_split(preds, pts)
    got = teval.InstSegEval(use_dbscan=True)._dbscan_split(preds, pts)
    assert len(got) > len(preds)
    _same_preds(ref, got)


def test_dbscan_split_links_points_exactly_eps_apart():
    """Points on a line 0.5 apart at eps 0.5 are one cluster; 0.5 plus a
    little apart they are two (float32 coordinates exact in f64)."""
    from sklearn.cluster import DBSCAN
    line = np.array([[0, 0, 0], [0.5, 0, 0], [1.0, 0, 0], [1.5, 0, 0],
                     [2.0625, 0, 0], [2.5625, 0, 0], [9, 9, 9], [9, 9, 9.5],
                     [9, 9.5, 9.5], [3, 3, 3], [0.25, 0.25, 0],
                     [1.25, 0, 0.5], [5, 5, 5], [5.5, 5, 5]], np.float32)
    for order in (np.arange(len(line)), np.random.default_rng(0).permutation(
            len(line))):
        pts = line[order]
        want = DBSCAN(eps=0.5, min_samples=1).fit(pts).labels_
        np.testing.assert_array_equal(teval.dbscan_labels(pts, 0.5), want)
        preds = [{"class": 0, "score": 1.0,
                  "mask": np.ones(len(pts), bool)}]
        ref = jeval.InstSegEval(use_dbscan=True, dbscan_eps=0.5
                                )._dbscan_split(preds, pts)
        got = teval.InstSegEval(use_dbscan=True, dbscan_eps=0.5
                                )._dbscan_split(preds, pts)
        assert len(got) == 6
        _same_preds(ref, got)


def test_dbscan_update_matches_jax():
    """The whole update path at full resolution with the split on."""
    rng = np.random.default_rng(3)
    n_pts, s, q = 600, 12, 6
    pts = (rng.random((n_pts, 3)) * [6, 6, 2]).astype(np.float32)
    seg = rng.integers(0, s, n_pts).astype(np.int32)
    inst = rng.integers(-1, 3, n_pts)
    out = {"predictions_class": [rng.standard_normal((1, q, 21)).astype(
               np.float32)],
           "predictions_mask": [rng.standard_normal((1, s, q)).astype(
               np.float32) * 3]}
    batch = {"seg_pad_masks": np.ones((1, s), bool),
             "segment_masks": rng.random((1, 3, s)) < 0.4,
             "instance_labels": np.array([[3, 4, 5]]),
             "instance_valid": np.ones((1, 3), bool),
             "_meta": {"segment_to_full": [seg],
                       "full_instance_masks": [np.stack(
                           [inst == i for i in range(3)])],
                       "points": [pts]}}
    res = []
    for pkg in (jeval, teval):
        ev = pkg.InstSegEval(num_classes=20, full_resolution=True,
                             use_dbscan=True, official_protocol=False)
        ev.update(out, batch)
        res.append((ev._preds, ev.record()))
    _same_preds(res[0][0][0], res[1][0][0])
    assert res[0][1].keys() == res[1][1].keys()
    for k, v in res[0][1].items():
        np.testing.assert_allclose(res[1][1][k], v, err_msg=k)


def _schedule(pkg, monkeypatch, wait, active, steps, close):
    """The step calls at which ``pkg``'s StepProfiler starts and stops."""
    events, prof = [], None
    if pkg is jprof:
        import jax
        monkeypatch.setattr(jax.profiler, "start_trace",
                            lambda d: events.append(("start", prof._step)))
        monkeypatch.setattr(jax.profiler, "stop_trace",
                            lambda: events.append(("stop", prof._step)))
    else:
        monkeypatch.setattr(tprof, "start_trace",
                            lambda: events.append(("start", prof._step))
                            or object())
        monkeypatch.setattr(tprof, "stop_trace",
                            lambda p, path: events.append(
                                ("stop", prof._step)))
    prof = pkg.StepProfiler("/nonexistent/trace", wait=wait, active=active,
                            enabled=True)
    monkeypatch.setattr(os, "makedirs", lambda *a, **k: None)
    for _ in range(steps):
        prof.step()
    if close:
        prof.close()
    monkeypatch.undo()
    return events


@pytest.mark.parametrize("wait,active,steps,close", [
    (10, 10, 25, False), (1, 1, 3, True), (0, 3, 2, True), (2, 2, 2, True),
    (3, 5, 30, True)])
def test_step_profiler_schedule_matches_jax(monkeypatch, wait, active,
                                            steps, close):
    ref = _schedule(jprof, monkeypatch, wait, active, steps, close)
    got = _schedule(tprof, monkeypatch, wait, active, steps, close)
    assert got == ref
    disabled = tprof.StepProfiler("/nonexistent", 0, 1, enabled=False)
    disabled.step()
    disabled.close()


@pytest.mark.parametrize("name,extra", [
    ("native_dots_int8", ["model.voxel_encoder.args.grad_mode=native",
                          "model.voxel_encoder.args.remat_policy=dots",
                          "model.voxel_encoder.args.sorted_gather=true",
                          "model.voxel_encoder.args.int8_gather=true",
                          "profile=true", "profile_wait=0",
                          "profile_active=1"]),
    ("ladder", ["data.instseg_options.level_cap_ladder="
                "[[1024, 512, 256, 128, 64], [4096, 2048, 1024, 512, 256]]"]),
    ("flat_compact", ["data.instseg_options.flat_pack=true",
                      "data.instseg_options.compact_conv=true"]),
])
def test_run_trains_with_option(tmp_path, monkeypatch, name, extra):
    from pq3d_tpu_torch.train.trainer import Query3DTrainer
    monkeypatch.setattr(Query3DTrainer, "install_preemption_handler",
                        lambda self, signals=None: None)
    exp = tmp_path / name
    trainer = trun.main(["--config-name", "instseg_sceneverse", *TINY,
                         "solver.epochs=2", "solver.epochs_per_eval=0",
                         "solver.epochs_per_save=0", f"exp_dir={exp}",
                         *extra])
    backbone = trainer.model.voxel_encoder.backbone
    assert trainer.step == 2
    with open(exp / "metrics.jsonl") as f:
        losses = [json.loads(l)["loss"] for l in f]
    assert len(losses) == 2 and np.isfinite(losses).all()
    if name == "native_dots_int8":
        assert (backbone.grad_mode, backbone.remat_policy,
                backbone.sorted_gather, backbone.int8_gather) == \
            ("native", "dots", True, True)
        with open(exp / "trace" / "trace_rank0.json") as f:
            events = json.load(f)["traceEvents"]
        assert any(e.get("name", "").startswith("aten::index_select")
                   for e in events)
    if name == "ladder":
        assert trainer.train_data.pipe_cfg.level_cap_ladder[0][0] == 1024
    shutil.rmtree(exp)
