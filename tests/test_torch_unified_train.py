"""The port's stage-2 training against the JAX package's, on the CPU at
small widths (the overrides of tests/test_multitask_trainer.py):

- one train step of the whole unified model (``make_train_step`` with
  ``build_from_config``'s AdamW, the generation head at its own rate 1e-5,
  ``Loss(ground_loss x10, generation_loss)``) against JAX's jitted step,
  from the same moved weights, with every dropout and memory dropout off:
  loss parts and gradient norm within rel 1e-5, updated parameters within
  max|diff| / max|ref| <= 1e-4, a frozen CLIP-tower weight decayed as
  optax decays it and a generation-head weight moved at the head's rate;
- the stage-2 losses and ``Loss`` against JAX within 1e-6;
- per-module rates: AdamW groups and three updates against optax;
- memory dropout: the keep-and-renormalise against a numpy transcription
  of ``pq3d_tpu/models/query_encoder.py:79-90``, and its seeded generator;
- PointNet++'s train-mode gradients against finite differences (why the
  step above freezes it: see ``test_pointnet_train_gradient_...``);
- ``python -m pq3d_tpu_torch.run --config-name unified_tasks_synthetic
  device=cpu``: one epoch, every val set evaluated, then a resume;
- the entry points this slice adds refuse CUDA without a card.
"""
import json
import math
import os
import subprocess
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pq3d_tpu.config import default_config_dir
from pq3d_tpu.config import load_config as jload
from pq3d_tpu.models import query3d as jq3d
from pq3d_tpu.optim import losses as jlosses
from pq3d_tpu.optim import optimizers as joptim
from pq3d_tpu.optim.loss_aggregator import Loss as JLoss
from pq3d_tpu.train.state import TrainState
from pq3d_tpu.train.state import make_train_step as jmake_train_step
from pq3d_tpu_torch import config as tconfig
from pq3d_tpu_torch import run as trun
from pq3d_tpu_torch.data import unified_datasets as tds
from pq3d_tpu_torch.data import unified_pipeline as tup
from pq3d_tpu_torch.models import query3d as tq3d
from pq3d_tpu_torch.models import query_encoder as tqe
from pq3d_tpu_torch.models.pointnet import PointNetPP
from pq3d_tpu_torch.optim import losses as tlosses
from pq3d_tpu_torch.optim import optimizers as toptim
from pq3d_tpu_torch.optim.loss_aggregator import Loss as TLoss
from pq3d_tpu_torch.serve import to_device
from pq3d_tpu_torch.train.state import make_train_step
from pq3d_tpu_torch.utils.weights import load_flax_variables, torch_name
from test_torch_pointnet import random_variables

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["data.synthetic.n_points=400", "data.synthetic.n_instances=4",
         "data.unified_options.max_obj_len=6",
         "data.unified_options.num_points=32",
         "data.unified_options.prompt_len=8",
         "data.unified_options.response_len=6",
         "model.hidden_size=32", "model.txt_tower.width=16",
         "model.txt_tower.layers=1", "model.txt_tower.heads=2",
         "model.unified_encoder.args.num_attention_heads=4",
         "model.unified_encoder.args.num_layers=1",
         "model.generation_head.args.d_model=16",
         "model.generation_head.args.d_kv=4",
         "model.generation_head.args.d_ff=32",
         "model.generation_head.args.num_layers=1",
         "model.generation_head.args.num_heads=2",
         "model.generation_head.args.max_new_tokens=4",
         "model.ground_head.args.hidden_size=16"]
# the step comparison: memory dropout off, the schedule at its full rate on
# step 0 (a warmup would make the first update 0), PointNet++ frozen as in
# unified_tasks_sceneverse.yaml
STEP = SMALL + ["model.unified_encoder.args.memory_dropout=0.0",
                "solver.sched.args.warmup_steps=0",
                "model.pc_encoder.args.freeze_backbone=True"]
LOSSES = (["ground_loss", "generation_loss"], {"ground_loss": 10})
FEATURE_DIMS = {"mv": 768, "voxel": 128}
DATASETS = ("SyntheticRefer", "SyntheticQA", "SyntheticCaption")
TOTAL_STEPS = 100


def _rel(ref, got):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert ref.shape == got.shape
    return float(np.abs(ref - got).max() / (np.abs(ref).max() + 1e-30))


def _train_batch(cfg, n=6, seed=0):
    """A train-mode batch of ``n`` items cycling through the three
    synthetic datasets (TXT and LOC prompts, every task)."""
    pipe = tup.UnifiedPipelineConfig(
        **{k: cfg["data"]["unified_options"][k] for k in
           ("max_obj_len", "num_points", "prompt_len", "response_len")})
    sets = [getattr(tds, name)(cfg, "train") for name in DATASETS]
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        scene, lang = sets[i % 3].get_item(i // 3)
        item = tup.process_item(scene, lang, pipe, rng, True, FEATURE_DIMS)
        items.append({k: v for k, v in item.items()
                      if not k.startswith("meta_")})
    return tup.collate_unified(items, pipe, FEATURE_DIMS, train=True)


@pytest.fixture(scope="module")
def step_pair():
    """One train step on each side from the same moved weights.  JAX's
    decoder and T5 dropouts are fixed at 0.1, so flax's Dropout is made
    the identity; the port's dropouts are set to 0."""
    jcfg = jload(os.path.join(default_config_dir(),
                              "unified_tasks_synthetic.yaml"),
                 overrides=STEP)
    tcfg = tconfig.load_config("unified_tasks_synthetic", STEP)
    batch = _train_batch(tcfg)
    bj = jax.tree_util.tree_map(jnp.asarray, batch)
    jm = jq3d.build_model(jcfg)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, bj,
        train=False))
    variables = random_variables(shapes, 3)

    mp = pytest.MonkeyPatch()
    mp.setattr(fnn.Dropout, "__call__",
               lambda self, x, deterministic=None, rng=None: x)
    try:
        tx, _ = joptim.build_from_config(jcfg, variables["params"],
                                         TOTAL_STEPS)
        state = TrainState.create(variables, tx, jax.random.key(5))
        new_state, jmetrics = jmake_train_step(
            jm, tx, JLoss(*LOSSES), donate=False)(state, bj)
        jmetrics = {k: float(v) for k, v in jmetrics.items()}
        jnew = jax.tree_util.tree_map(np.asarray, new_state.params)
        # the step's gradient (before the clip), to tell noise from signal
        rest = {k: v for k, v in variables.items() if k != "params"}

        def total(p):
            out, _ = jm.apply({"params": p, **rest}, bj, train=True,
                              rngs={"dropout": jax.random.key(1)},
                              mutable=["batch_stats"])
            return JLoss(*LOSSES)(out, bj)[0]
        grads = jax.jit(jax.grad(total))(variables["params"])
    finally:
        mp.undo()

    tm = tq3d.build_model(tcfg, device="cpu")
    load_flax_variables(tm, variables)
    for m in tm.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    opt, sched, grad_norm = toptim.build_from_config(tcfg, tm, TOTAL_STEPS)
    step = make_train_step(tm, opt, sched, TLoss(*LOSSES), grad_norm)
    tmetrics = {k: float(v) for k, v in step(
        to_device(batch, torch.device("cpu"))).items()}

    # (torch name, old value, JAX's new, the port's new, JAX's gradient)
    tparams = dict(tm.named_parameters())
    leaves = []
    for path, new in jax.tree_util.tree_flatten_with_path(jnew)[0]:
        keys = tuple(p.key for p in path)
        name, new_ref = torch_name(tm, keys, new)
        _, old = torch_name(tm, keys, np.asarray(
            _at(variables["params"], keys)))
        _, g = torch_name(tm, keys, np.asarray(_at(grads, keys)))
        leaves.append((name, old, new_ref,
                       tparams[name].detach().numpy(), g))
    return {"jmetrics": jmetrics, "tmetrics": tmetrics, "leaves": leaves,
            "opt": opt, "cfg": tcfg, "model": tm}


def _at(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("key", ["loss", "ground_loss", "generation_loss",
                                 "grad_norm"])
def test_train_step_loss_parts_match_jax(step_pair, key):
    ref, got = step_pair["jmetrics"][key], step_pair["tmetrics"][key]
    assert math.isfinite(got) and abs(got - ref) <= 1e-5 * abs(ref), \
        (key, ref, got)


def test_train_step_updated_parameters_match_jax(step_pair):
    """Every updated parameter within max|diff| / max|ref| <= 1e-4.  A
    tensor whose gradient is 0 in exact arithmetic (the spatial
    attention's key bias shifts every logit of a query alike, so softmax
    cancels it) carries f32 noise of 1e-8 on both sides, which AdamW's
    first step turns into an update of up to the rate: there the update is
    held to the rate instead.  Frozen weights (gradient exactly 0) are
    held like the rest."""
    leaves = step_pair["leaves"]
    lr = float(step_pair["cfg"]["solver"]["lr"])
    gmax = max(np.abs(g).max() for *_, g in leaves)
    checked, noise = 0, []
    for name, old, ref, got, g in leaves:
        if 0 < np.abs(g).max() <= 1e-6 * gmax:
            noise.append(name)
            assert np.abs(got - old).max() <= 1.01 * lr * (
                1 + 0.01 * np.abs(old).max()), name
            continue
        assert _rel(ref, got) <= 1e-4, (name, _rel(ref, got))
        checked += 1
    assert checked > 100 and len(noise) <= 2, noise


def test_train_step_frozen_tower_decays_as_optax(step_pair):
    """The CLIP tower runs without autograd, so its gradient is 0 and
    AdamW's update is the decay alone: -lr * wd * p, as optax's adamw
    applies it to every weight its mask selects."""
    lr = float(step_pair["cfg"]["solver"]["lr"])
    name, old, ref, got, g = next(
        leaf for leaf in step_pair["leaves"]
        if leaf[0] == "txt_encoder.tower.token_embedding.weight")
    assert not np.any(g)
    # the decay moves each weight by 1e-6 of itself, about 8 float32 ulps;
    # the two sides round p - lr*wd*p and p*(1 - lr*wd): one ulp apart
    ulp = np.spacing(np.abs(old))
    want = old.astype(np.float64) * (1 - lr * 0.01)
    assert np.all(np.abs(got - want) <= ulp)
    assert np.all(np.abs(got - ref) <= ulp)
    assert (got != old).mean() > 0.9


def test_train_step_generation_head_at_its_rate(step_pair):
    """The T5 head's AdamW groups run at 1e-5 (the YAML's
    ``generation_head.lr``) beside 1e-4: four groups, and the head's first
    update is about its rate, not the base rate, equal to JAX's."""
    opt = step_pair["opt"]
    rates = sorted({(g["initial_lr"], g["weight_decay"])
                    for g in opt.param_groups})
    assert rates == [(1e-5, 0.0), (1e-5, 0.01), (1e-4, 0.0), (1e-4, 0.01)]
    name, old, ref, got, g = next(
        leaf for leaf in step_pair["leaves"]
        if leaf[0] == "generation_head.input_proj.weight")
    upd = np.abs(got - old).max()
    assert 0.5e-5 < upd < 1.5e-5, upd
    assert _rel(ref - old, got - old) <= 1e-2


def _loss_inputs(seed=0, b=3, o=7, l=5, v=11):
    rng = np.random.default_rng(seed)
    ground = rng.standard_normal((b, o)).astype(np.float32) * 3
    ground[:, 5:] = -1e9                       # padded slots (NEG_INF)
    tgt = np.zeros((b, o), np.float32)
    tgt[np.arange(b), rng.integers(0, 5, b)] = 1
    gen = rng.standard_normal((b, l, v)).astype(np.float32)
    response = rng.integers(1, v, (b, l)).astype(np.int32)
    response[:, 3:] = 0
    valid = response != 0
    return ({"ground_logits": ground, "og3d_logits": ground,
             "generation_logits": gen},
            {"tgt_object_id": tgt, "response": response,
             "response_valid": valid,
             "labels_int": rng.integers(0, o, (b,)).astype(np.int32)})


def _both(fn_j, fn_t, out, batch):
    ref = float(fn_j(jax.tree_util.tree_map(jnp.asarray, out),
                     jax.tree_util.tree_map(jnp.asarray, batch)))
    got = float(fn_t({k: torch.from_numpy(v) for k, v in out.items()},
                     {k: torch.from_numpy(np.asarray(v))
                      for k, v in batch.items()}))
    return ref, got


@pytest.mark.parametrize("which", ["bce_neg_inf", "class_index", "ground",
                                   "generation", "generation_no_valid"])
def test_stage2_losses_match_jax(which):
    out, batch = _loss_inputs()
    fns = {
        "bce_neg_inf": (
            lambda o, b: jlosses.cross_entropy(o["ground_logits"],
                                               b["tgt_object_id"]),
            lambda o, b: tlosses.cross_entropy(o["ground_logits"],
                                               b["tgt_object_id"])),
        "class_index": (
            lambda o, b: jlosses.cross_entropy(o["ground_logits"],
                                               b["labels_int"]),
            lambda o, b: tlosses.cross_entropy(o["ground_logits"],
                                               b["labels_int"])),
        "ground": (jlosses.ground_loss, tlosses.ground_loss),
        "generation": (jlosses.generation_loss, tlosses.generation_loss),
    }
    if which == "generation_no_valid":
        batch.pop("response_valid")
        fns[which] = fns["generation"]
    ref, got = _both(*fns[which], out, batch)
    assert math.isfinite(got) and abs(got - ref) <= 1e-6 * max(abs(ref), 1)


@pytest.mark.parametrize("absent", [None, "response", "ground_logits"])
def test_loss_aggregator_matches_jax(absent):
    """The weighted sum and its parts, ``answer_loss`` and
    ``query3d_mask_loss`` among them; an entry
    whose inputs are absent contributes nothing; an unknown name
    raises."""
    from test_torch_qa_losses import _qa_mask_inputs
    out, batch = _loss_inputs(seed=1)
    qa_out, qa_batch = _qa_mask_inputs(seed=1)
    out.update(qa_out)
    batch.update(qa_batch)
    if absent in out:
        out.pop(absent)
    if absent in batch:
        batch.pop(absent)
    names = ["ground_loss", "og3d_loss", "generation_loss", "answer_loss",
             "query3d_mask_loss"]
    weights = {"ground_loss": 10, "og3d_loss": 0.5, "answer_loss": 2}
    jt, jp = JLoss(names, weights)(
        jax.tree_util.tree_map(jnp.asarray, out),
        jax.tree_util.tree_map(jnp.asarray, batch))
    tt, tp = TLoss(names, weights)(
        jax.tree_util.tree_map(lambda v: torch.from_numpy(np.asarray(v)),
                               out),
        {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
    assert set(tp) == set(jp)
    assert {"answer_loss", "query3d_mask_loss"} <= set(tp)
    assert abs(float(tt) - float(jt)) <= 1e-6 * abs(float(jt))
    for k in jp:
        assert abs(float(tp[k]) - float(jp[k])) <= 1e-6 * abs(float(jp[k]))
    with pytest.raises(KeyError, match="no_such_loss"):
        TLoss(["no_such_loss"])


def test_per_module_rate_matches_optax():
    """Three AdamW steps (warmup 2 of 6, clip 1.0) on identical gradients
    through a module at the base rate and a ``generation_head`` at a tenth
    of it: optax with ``module_lrs`` against the port's parameter groups
    under one LambdaLR; decay, clip and schedule included."""
    rng = np.random.default_rng(0)
    shapes = {"body": {"kernel": (5, 4), "bias": (4,)},
              "generation_head": {"kernel": (4, 3), "bias": (3,)}}
    params = {m: {k: rng.standard_normal(s).astype(np.float32)
                  for k, s in d.items()} for m, d in shapes.items()}
    grads = [{m: {k: rng.standard_normal(s).astype(np.float32)
                  for k, s in d.items()} for m, d in shapes.items()}
             for _ in range(3)]
    module_lrs = {"generation_head": 1e-3}
    tx, _ = joptim.build_optimizer(params, "AdamW", lr=1e-2, total_steps=6,
                                   warmup_steps=2, grad_norm=1.0,
                                   module_lrs=module_lrs)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)
    for g in grads:
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                               state, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, upd)

    model = torch.nn.Module()
    for m, d in shapes.items():
        lin = torch.nn.Linear(*d["kernel"])
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(params[m]["kernel"].T))
            lin.bias.copy_(torch.from_numpy(params[m]["bias"]))
        model.add_module(m, lin)
    opt, sched = toptim.build_optimizer(model, "AdamW", lr=1e-2,
                                        total_steps=6, warmup_steps=2,
                                        module_lrs=module_lrs)
    assert [(g["initial_lr"], g["weight_decay"])
            for g in opt.param_groups] == \
        [(1e-2, 0.01), (1e-2, 0.0), (1e-3, 0.01), (1e-3, 0.0)]
    ps = [model.body.weight, model.body.bias, model.generation_head.weight,
          model.generation_head.bias]
    for g in grads:
        for p, gv in zip(ps, (g["body"]["kernel"].T, g["body"]["bias"],
                              g["generation_head"]["kernel"].T,
                              g["generation_head"]["bias"])):
            p.grad = torch.from_numpy(np.ascontiguousarray(gv))
        norm = toptim.global_norm([p.grad for p in ps])
        toptim.clip_by_global_norm_([p.grad for p in ps], 1.0, norm)
        opt.step()
        sched.step()
    lrs = [g["lr"] for g in opt.param_groups]
    assert lrs[0] == lrs[1] and lrs[2] == lrs[3]
    assert lrs[2] == pytest.approx(lrs[0] / 10)
    for m in shapes:
        lin = getattr(model, m)
        assert _rel(np.asarray(jp[m]["kernel"]),
                    lin.weight.detach().numpy().T) <= 1e-6, m
        assert _rel(np.asarray(jp[m]["bias"]),
                    lin.bias.detach().numpy()) <= 1e-6, m


def _memory_dropout_numpy(stacked, u, p):
    """``pq3d_tpu/models/query_encoder.py:79-90`` in numpy."""
    keep = u > p
    keep = np.logical_or(keep, keep.sum(1, keepdims=True) == 0)
    n_keep = keep.sum(axis=1).astype(stacked.dtype)
    w = keep[..., None, None].astype(stacked.dtype)
    return (stacked * w).sum(axis=1) / n_keep[:, None, None]


def test_memory_dropout_matches_numpy_transcription():
    rng = np.random.default_rng(0)
    stacked = rng.standard_normal((5, 3, 4, 8)).astype(np.float32)
    u = rng.random((5, 3)).astype(np.float32)
    u[0] = [0.1, 0.2, 0.3]          # all dropped at p=0.6: every one kept
    u[1] = [0.9, 0.1, 0.2]          # one survivor
    got = tqe.memory_keep_mean(torch.from_numpy(stacked),
                               torch.from_numpy(u), 0.6).numpy()
    want = _memory_dropout_numpy(stacked, u, 0.6)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[0], stacked[0].mean(0), rtol=1e-6)
    np.testing.assert_allclose(got[1], stacked[1, 0], rtol=1e-6)


def test_memory_dropout_draws_from_its_seeded_generator():
    """In train mode the layer's draws come from the generator the
    trainer seeds, not from the global RNG: the same seed gives the same
    output whatever the global state, another seed another output; eval
    mode averages every memory; train mode without a generator raises."""
    torch.manual_seed(0)
    layer = tqe.QueryEncoderLayer(16, 2, ["mv", "pc", "voxel", "prompt"],
                                  dim_feedforward=32, dropout=0.0,
                                  spatial_selfattn=False, structure="mixed",
                                  memory_dropout=0.6)
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((6, 5, 16)).astype(np.float32))
    inputs = {"query": (q, torch.ones(6, 5, dtype=torch.bool), None)}
    for m in ("mv", "pc", "voxel", "prompt"):
        inputs[m] = (torch.from_numpy(
            rng.standard_normal((6, 7, 16)).astype(np.float32)),
            torch.ones(6, 7, dtype=torch.bool), None)
    layer.train()
    with pytest.raises(RuntimeError, match="generator"):
        layer(q, inputs)

    def run(seed, global_seed):
        torch.manual_seed(global_seed)
        layer.memory_generator = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return layer(q, inputs)
    a, b, c = run(3, 0), run(3, 99), run(4, 0)
    assert torch.equal(a, b) and not torch.equal(a, c)
    layer.eval()
    with torch.no_grad():
        mean = layer(q, inputs)
        layer.memory_dropout = 0.0
        layer.train()
        assert torch.allclose(layer(q, inputs), mean, atol=1e-6)


def test_pointnet_train_gradient_matches_finite_differences():
    """PointNet++ trained unfrozen (the synthetic config's
    ``freeze_backbone: False``): the port's train-mode gradients against
    central differences of its own forward in float64.  The JAX package's
    jitted gradient of the same train-mode forward disagrees with its own
    finite differences on the CPU (ROADMAP C.4), so the step
    comparison above freezes the backbone, as the sceneverse YAML does."""
    small = dict(sa_n_points=(16, 8, None), sa_n_samples=(8, 8, 8),
                 sa_mlps=((16, 16, 32), (32, 32, 48), (48, 64, 96)))
    torch.manual_seed(0)
    net = PointNetPP(in_feats=3, **small).double().train()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=gen,
                                    dtype=torch.float64) * 0.1)
            elif ".bn" in name:
                p.copy_(1 + torch.randn(p.shape, generator=gen,
                                        dtype=torch.float64) * 0.1)
    rng = np.random.default_rng(0)
    pts = torch.from_numpy(np.concatenate(
        [rng.random((6, 48, 3)) * 0.8 - 0.4, rng.random((6, 48, 3)) * 2 - 1],
        -1))
    w = torch.from_numpy(rng.standard_normal((6, 96)))
    (net(pts) * w).sum().backward()
    checked = 0
    for name in ("sa0.mlp.bn1.weight", "sa1.mlp.dense0.weight",
                 "sa2.mlp.bn1.bias"):
        p = dict(net.named_parameters())[name]
        flat = p.detach().reshape(-1)
        for i in rng.choice(flat.numel(), 4, replace=False):
            vals = []
            for s in (1.0, -1.0):
                with torch.no_grad():
                    p.view(-1)[i] += s * 1e-6
                    vals.append(float((net(pts) * w).sum()))
                    p.view(-1)[i] -= s * 1e-6
            fd = (vals[0] - vals[1]) / 2e-6
            got = float(p.grad.reshape(-1)[i])
            assert abs(fd - got) <= 1e-5 * max(1.0, abs(fd)), (name, i)
            checked += 1
    assert checked == 12


TINY = ["device=cpu", "data.synthetic.num_train=8",
        "data.synthetic.num_val=5", "dataloader.batchsize=4",
        "dataloader.batchsize_eval=4", "solver.epochs_per_eval=1",
        "log_every=1"] + SMALL


def test_run_trains_evaluates_and_resumes(tmp_path, monkeypatch):
    """One epoch (2 batches from each of the three datasets, mixed), every
    val set evaluated (5 items each: one full batch and one wrap-padded
    batch of 1 real row), ``latest`` and ``best`` saved; then
    ``resume=True`` continues from ``latest`` for a second epoch."""
    from pq3d_tpu_torch.train.trainer import MultitaskTrainer
    monkeypatch.setattr(MultitaskTrainer, "install_preemption_handler",
                        lambda self, signals=None: None)
    exp = str(tmp_path / "run")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "pq3d_tpu_torch.run", "--config-name",
         "unified_tasks_synthetic", *TINY, "solver.epochs=1",
         f"exp_dir={exp}"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    train = [r for r in recs if r["prefix"] == "train"]
    assert [r["step"] for r in train] == list(range(1, 7))
    assert all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
               for r in train)
    assert any("ground_loss" in r for r in train)
    assert any("generation_loss" in r for r in train)
    assert {r["prefix"] for r in recs} == {
        "train", "val-SyntheticRefer", "val-SyntheticQA",
        "val-SyntheticCaption"}
    for name in ("latest", "best"):
        assert os.path.exists(os.path.join(exp, "ckpt", name, "state.pt"))

    trainer = trun.main(["--config-name", "unified_tasks_synthetic", *TINY,
                         "resume=True", "solver.epochs=2", f"exp_dir={exp}"])
    assert trainer.tracker.epoch == 2 and trainer.step == 12
    results = trainer.eval_epoch(0)
    assert {"SyntheticRefer/og_acc", "SyntheticQA/ans1_acc",
            "SyntheticCaption/cider@0.5", "target_metric"} <= set(results)
    assert all(math.isfinite(v) for v in results.values())
    counts = [ev.total_count for _, _, ev in trainer.val_sets]
    assert counts == [5, 5, 5]


def test_stage2_entry_points_refuse_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal path is moot")
    from pq3d_tpu_torch.train.trainer import MultitaskTrainer
    cfg = tconfig.load_config("unified_tasks_synthetic",
                              [f"exp_dir={tmp_path}"])
    with pytest.raises(RuntimeError, match="CUDA"):
        trun.build_multitask_trainer(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        MultitaskTrainer(cfg, torch.nn.Linear(2, 2), None, None)
    with pytest.raises(RuntimeError, match="CUDA"):
        trun.main(["--config-name", "unified_tasks_sceneverse",
                   "data.train=[SyntheticRefer,SyntheticQA,SyntheticCaption]",
                   f"exp_dir={tmp_path}"])
    cfg["device"] = "cpu"
    trainer = trun.build_multitask_trainer(cfg)
    assert isinstance(trainer, MultitaskTrainer)
    assert [name for name, _, _ in trainer.val_sets] == list(DATASETS)
