"""Seeded, resumable training randomness and the optimizer leftovers, on
the CPU.

- Gradient accumulation (``solver.gradient_accumulation_steps``) against
  ``optax.MultiSteps`` on the same gradients: k = 2, the clip on the mean,
  the schedule advanced once per optimizer step; parameters within 1e-6
  of the largest after every micro-step.
- Adam, SGD (momentum 0.9) and Lion (decay mask, per-module rate) against
  optax's through ``build_optimizer``, and the ``warmup_exp`` and
  ``constant`` curves against ``make_schedule``: within 1e-6 relative.
- Determinism (ROADMAP C.1): with dropout on, two runs of one config
  through ``python -m pq3d_tpu_torch.run`` end bit for bit equal, and a
  run cut after its first epoch and resumed ends bit for bit where the
  unbroken run ends: stage 1 (dropout, accumulation k = 2 across the epoch
  boundary) and stage 2 (dropout and memory dropout).  The port's masks
  are not JAX's (the generators differ), so this holds the port to
  itself.
- ``instseg_synthetic`` equals ``yaml.safe_load`` of its YAML file.
"""
import os
import shutil

import jax
import numpy as np
import optax
import pytest
import torch
import yaml

from pq3d_tpu.optim import optimizers as joptim
from pq3d_tpu_torch import config as tconfig
from pq3d_tpu_torch import run as trun
from pq3d_tpu_torch.optim import optimizers as toptim
from pq3d_tpu_torch.train.state import make_train_step
from pq3d_tpu_torch.train.trainer import MultitaskTrainer, Query3DTrainer

from test_torch_trainer import TINY
from test_torch_unified_train import TINY as UNIFIED_TINY

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"body": {"kernel": (5, 4), "bias": (4,)},
          "norm": {"scale": (4,)}, "head": {"kernel": (4, 3)}}


class _Toy(torch.nn.Module):
    def forward(self, batch):
        return None


def _toy():
    """(flax-style params of numpy arrays, the same as a torch module whose
    parameter names read ``body.kernel`` etc.)."""
    rng = np.random.default_rng(0)
    params = {m: {n: rng.standard_normal(s).astype(np.float32)
                  for n, s in leaves.items()}
              for m, leaves in SHAPES.items()}
    model = _Toy()
    for m, leaves in params.items():
        sub = torch.nn.Module()
        for n, a in leaves.items():
            setattr(sub, n, torch.nn.Parameter(torch.from_numpy(a.copy())))
        setattr(model, m, sub)
    return params, model


def _grads(n, seed=1, scales=(0.05, 3.0, 0.1, 2.0, 0.02, 0.5)):
    rng = np.random.default_rng(seed)
    return [{m: {k: (rng.standard_normal(s) * scales[i % len(scales)])
                 .astype(np.float32) for k, s in leaves.items()}
             for m, leaves in SHAPES.items()} for i in range(n)]


def _check(model, params, tol):
    for m, leaves in params.items():
        for n, ref in leaves.items():
            got = getattr(getattr(model, m), n).detach().numpy()
            ref = np.asarray(ref)
            assert np.abs(got - ref).max() <= tol * np.abs(ref).max(), (m, n)


def test_gradient_accumulation_matches_multisteps():
    params, model = _toy()
    grads = _grads(6)
    tx, _ = joptim.build_optimizer(params, "AdamW", lr=1e-2, total_steps=3,
                                   grad_norm=1.0, accumulation_steps=2)
    state = tx.init(params)
    update = jax.jit(tx.update)

    opt, sched = toptim.build_optimizer(model, "AdamW", lr=1e-2,
                                        total_steps=3)
    acc = toptim.GradientAccumulator(2)
    names = [(m, n) for m, leaves in SHAPES.items() for n in leaves]
    step = make_train_step(
        model, opt, sched,
        lambda out, b: (sum((getattr(getattr(model, m), n) * b[m][n]).sum()
                            for m, n in names), {}),
        grad_norm_max=1.0, accumulator=acc)
    p_j = params
    for i, g in enumerate(grads):
        upd, state = update(g, state, p_j)
        p_j = optax.apply_updates(p_j, upd)
        before = [p.detach().clone() for p in model.parameters()]
        metrics = step({m: {n: torch.from_numpy(a) for n, a in leaves.items()}
                        for m, leaves in g.items()})
        np.testing.assert_allclose(metrics["grad_norm"].item(),
                                   float(optax.global_norm(g)), rtol=1e-6)
        moved = any(not torch.equal(a, p) for a, p in
                    zip(before, model.parameters()))
        assert moved == (i % 2 == 1) and acc.mini_step == (i + 1) % 2
        assert sched.last_epoch == (i + 1) // 2
        _check(model, p_j, 1e-6)
    # the clip acted on a mean (the second window's norm is over 1)
    assert float(optax.global_norm(jax.tree_util.tree_map(
        lambda a, b: (a + b) / 2, grads[2], grads[3]))) > 1.0


@pytest.mark.parametrize("name", ["Adam", "SGD", "Lion"])
def test_optimizers_match_optax(name):
    params, model = _toy()
    kw = dict(lr=1e-2, total_steps=4, warmup_steps=1, sched_name="warmup_exp",
              betas=(0.9, 0.99), weight_decay=0.1,
              module_lrs={"head": 1e-3}, gamma=0.1)
    tx, _ = joptim.build_optimizer(params, name, **kw)
    state = tx.init(params)
    update = jax.jit(tx.update)
    opt, sched = toptim.build_optimizer(model, name, **kw)
    p_j = params
    for g in _grads(3, seed=2):
        upd, state = update(g, state, p_j)
        p_j = optax.apply_updates(p_j, upd)
        for m, leaves in g.items():
            for n, a in leaves.items():
                getattr(getattr(model, m), n).grad = torch.from_numpy(a)
        opt.step()
        sched.step()
        _check(model, p_j, 1e-6)


def test_schedule_curves_match_make_schedule():
    for name in ("warmup_exp", "constant", None):
        for total, warm in ((12, 3), (12, 0), (7, 7)):
            sj = joptim.make_schedule(name, 1e-3, total, warm, gamma=0.1)
            ft = toptim.lr_lambda(name, total, warm, gamma=0.1)
            for step in range(15):
                np.testing.assert_allclose(
                    1e-3 * ft(step), float(sj(step)), rtol=1e-6, atol=1e-12,
                    err_msg=f"{name} {total} {warm} {step}")
    with pytest.raises(NotImplementedError):
        toptim.lr_lambda("linear", 10)


def _state(exp, name):
    return torch.load(os.path.join(exp, "ckpt", name, "state.pt"),
                      weights_only=False)


def _train_records(exp):
    import json
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [{k: v for k, v in r.items() if k != "time"} for r in recs
            if r["prefix"] == "train"]


def _assert_equal_states(a, b):
    assert set(a) == set(b)
    for key in set(a) - {"tracker"}:
        _equal(a[key], b[key], key)


def _equal(a, b, path):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    else:
        assert a == b, path


def _first_epoch_only(monkeypatch, cls):
    """Run the trainer's first epoch of its config's schedule and stop
    there, as a job killed after its first checkpoint does."""
    run = cls.run

    def one_epoch(self):
        self.epochs = 1
        return run(self)
    monkeypatch.setattr(cls, "run", one_epoch)


STAGES = {
    "stage1": ("instseg_sceneverse", Query3DTrainer, TINY + [
        "solver.gradient_accumulation_steps=2"]),
    "stage2": ("unified_tasks_synthetic", MultitaskTrainer, UNIFIED_TINY + [
        "data.synthetic.num_train=4"]),
}


@pytest.mark.parametrize("stage", sorted(STAGES))
def test_runs_repeat_and_resume_bit_for_bit(tmp_path, monkeypatch, stage):
    """Each run keeps only ``latest`` (a stage-1 snapshot of the tiny
    config is about 0.46 GB: the U-Net has its full widths), read into
    memory and deleted as soon as it is compared."""
    name, cls, args = STAGES[stage]
    monkeypatch.setattr(cls, "install_preemption_handler",
                        lambda self, signals=None: None)
    argv = ["--config-name", name, *args, "solver.epochs=2",
            "solver.epochs_per_eval=0", "solver.epochs_per_save=0"]

    def first_epoch(exp):
        with monkeypatch.context() as m:
            _first_epoch_only(m, cls)
            return trun.main([*argv, f"exp_dir={exp}"])

    # two runs of one config agree after their first epoch
    cut, again = str(tmp_path / "cut"), str(tmp_path / "again")
    first = first_epoch(cut)
    assert first.tracker.epoch == 1
    if stage == "stage1":             # a window open across the boundary
        assert first.step == 0 and first._accumulator.mini_step == 1
        assert _state(cut, "latest")["accumulator"]["mini_step"] == 1
    first_epoch(again)
    _assert_equal_states(_state(cut, "latest"), _state(again, "latest"))
    shutil.rmtree(again)

    # the cut run resumed ends where an unbroken run ends
    resumed = trun.main(["--config-name", name, "resume=True",
                         f"exp_dir={cut}"])
    assert resumed.tracker.epoch == 2
    ended, cut_records = _state(cut, "latest"), _train_records(cut)
    shutil.rmtree(cut)
    whole = str(tmp_path / "whole")
    trainer = trun.main([*argv, f"exp_dir={whole}"])
    # stage 1: a micro-step an epoch, 2 to an optimizer step; stage 2: 3
    # steps an epoch
    assert trainer.step == resumed.step == (1 if stage == "stage1" else 6)
    saved = _state(whole, "latest")
    _assert_equal_states(saved, ended)
    assert _train_records(whole) == cut_records
    shutil.rmtree(whole)

    # dropout was on and drew from the generators the checkpoints hold
    drops = [m.p for m in trainer.model.modules()
             if isinstance(m, torch.nn.Dropout)]
    assert drops and max(drops) > 0
    seed = int(tconfig.load_config(name)["rng_seed"])
    fresh = torch.Generator().manual_seed(seed).get_state()
    assert not torch.equal(saved["rng"]["cpu"], fresh)
    if stage == "stage2":
        assert trainer.model.unified_encoder.layer0.memory_dropout > 0
        assert not torch.equal(saved["rng"]["memory"], fresh)


def test_instseg_synthetic_equals_yaml():
    path = os.path.join(REPO, "pq3d_tpu", "config", "configs",
                        "instseg_synthetic.yaml")
    with open(path) as f:
        assert tconfig.INSTSEG_SYNTHETIC == yaml.safe_load(f)
    assert tconfig.CONFIGS["instseg_synthetic"] is tconfig.INSTSEG_SYNTHETIC
    cfg = tconfig.load_config("instseg_synthetic.yaml", ["solver.epochs=5"])
    assert cfg["solver"]["epochs"] == 5
    assert cfg["model"]["unified_encoder"]["args"]["hidden_size"] == 128
    assert cfg["data"]["train"] == ["SyntheticInstSeg"]
