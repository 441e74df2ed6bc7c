"""``python -m pq3d_tpu_torch.run`` under two gloo ranks on the CPU
(through ``python -m pq3d_tpu_torch.launch``), at the tiny stage-1 widths
of ``tests/test_torch_trainer.py`` with dropout on:

- checkpoints and resume: a 2-rank run cut after its first epoch and
  resumed ends bit for bit where an unbroken 2-rank run ends (weights,
  optimizer, schedule, every rank's generator states, the accumulation
  window that k = 2 leaves open across the epoch boundary, the metrics
  log), the ranks' weight checksums agree in each checkpoint, the
  2-rank checkpoint loads in one process (weights, rank 0's generators
  and window; an open window saved by two ranks as their mean) and a
  one-process checkpoint resumes in two ranks, its open window closing
  there.
"""
import json
import os
import shutil

import torch

import _torch_ddp_worker as w
from pq3d_tpu_torch import run as trun
from pq3d_tpu_torch.train.trainer import Query3DTrainer
from test_torch_train_rng import (_assert_equal_states, _first_epoch_only,
                                  _state, _train_records)
from test_torch_trainer import TINY

torch.set_num_threads(1)
ARGS = ["--config-name", "instseg_sceneverse",
        *[a for a in TINY if not a.startswith("device=")],
        "solver.epochs_per_eval=0", "solver.epochs_per_save=0"]


def test_resumed_two_rank_run_equals_an_unbroken_one(tmp_path,
                                                    monkeypatch):
    """Each snapshot of the tiny config is about 0.7 GB (the U-Net keeps
    its full widths): the runs' directories go when the test ends."""
    try:
        _resume_checks(tmp_path, monkeypatch)
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)


def _resume_checks(tmp_path, monkeypatch):
    # a one-process run cut after its first epoch, for the ranks to resume
    monkeypatch.setattr(Query3DTrainer, "install_preemption_handler",
                        lambda self, signals=None: None)
    with monkeypatch.context() as m:
        _first_epoch_only(m, Query3DTrainer)
        trun.main([*ARGS, "solver.epochs=2",
                   "solver.gradient_accumulation_steps=2", "device=cpu",
                   f"exp_dir={tmp_path / 'one'}"])
    saved_by_one = _state(str(tmp_path / "one"), "latest")
    ranks = w.spawn("resume", tmp_path, *ARGS, "solver.epochs=2",
                    "solver.gradient_accumulation_steps=2")
    for rk in ranks:
        # a micro-step an epoch, two to an optimizer step: the window is
        # open when the cut run saves
        assert rk["first_epoch"] == 1 and rk["mini_step"] == 1
        assert rk["steps"] == (1, 1)
    assert ranks[0]["checksum"] == ranks[1]["checksum"]
    cut, whole = str(tmp_path / "cut"), str(tmp_path / "whole")
    ended = _state(cut, "latest")
    _assert_equal_states(_state(whole, "latest"), ended)
    assert _train_records(whole) == _train_records(cut)
    assert len(ended["ranks"]) == 2
    assert ended["rank_checksums"] == [ranks[0]["checksum"]] * 2
    # rank 1's dropout drew from its own generator
    assert not torch.equal(ended["ranks"][0]["rng"]["cpu"],
                           ended["ranks"][1]["rng"]["cpu"])

    # the 2-rank checkpoint in one process
    with open(os.path.join(cut, "config.json")) as f:
        cfg = json.load(f)
    cfg["resume"] = True
    trainer = trun.build_instseg_trainer(cfg)
    trainer._lazy_init()
    assert trainer.ddp is None and trainer.world == 1
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, ended["model"][k]), k
    assert torch.equal(torch.get_rng_state(), ended["rng"]["cpu"])
    assert trainer._accumulator.mini_step == \
        ended["ranks"][0]["accumulator"]["mini_step"] == 0
    assert trainer.step == ended["step"] == 1
    # an open window saved by two ranks: one process takes their mean
    acc = [[torch.randn(p.shape) for p in trainer._accumulator.acc]
           for _ in range(2)]
    trainer._restore_rank_state({"rng": ended["rng"], "ranks": [
        {"rng": r["rng"], "accumulator": {"mini_step": 1, "acc": a}}
        for r, a in zip(ended["ranks"], acc)]})
    assert trainer._accumulator.mini_step == 1
    for got, a0, a1 in zip(trainer._accumulator.acc, *acc):
        assert torch.equal(got, (a0 + a1) / 2)
    del trainer

    # and a one-process checkpoint in two ranks: the weights load, the
    # ranks start fresh generators (the saver had one) and finish the run
    assert "ranks" not in saved_by_one
    for rk in ranks:
        assert rk["from_one"] == (2, 1, 2)
    resumed = _state(str(tmp_path / "one"), "latest")
    assert resumed["rank_checksums"][0] == resumed["rank_checksums"][1]
    # the window the one process left open closed in the ranks: a step
    assert resumed["step"] == 1 and any(
        not torch.equal(v, saved_by_one["model"][k])
        for k, v in resumed["model"].items())
