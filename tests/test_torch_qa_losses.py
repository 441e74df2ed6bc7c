"""The classifier-QA head, ``GroundHeadV1`` and the two stage-2 losses
this slice ports, against the JAX package on the CPU:

- ``ClsHead`` and ``GroundHeadV1`` (eval mode) with moved weights, within
  max|diff| / max|ref| <= 1e-5; ``detach_all_aux_loss`` cuts the
  classifiers' gradient into the embeddings, and only theirs;
- ``answer_loss`` (sigmoid BCE summed over classes, divided by B) and
  ``query3d_mask_loss`` (BCE x5 + dice x2 per round against
  ``gt_attn_mask``, CE x2 on ``instance_labels`` under ``obj_masks``)
  within 1e-6 relative, alone and through ``Loss``, each absent when its
  inputs are;
- ``build_multitask_trainer`` with ``heads=[ground, generation, qa]``
  from tests/test_qa_classifier.py's overrides: ``answer_label`` in the
  batch, ``answer_loss`` appended to the losses and finite after a train
  step, ScanQAEval's acc@1 / acc@10 finite."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pq3d_tpu.models import heads as jheads
from pq3d_tpu.optim import losses as jlosses
from pq3d_tpu.optim.loss_aggregator import Loss as JLoss
from pq3d_tpu_torch import config as tconfig
from pq3d_tpu_torch import run as trun
from pq3d_tpu_torch.models import heads as theads
from pq3d_tpu_torch.optim import losses as tlosses
from pq3d_tpu_torch.optim.loss_aggregator import Loss as TLoss
from pq3d_tpu_torch.utils.weights import load_flax_variables
from test_torch_pointnet import random_variables

torch.set_num_threads(1)


def _rel(ref, got):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert ref.shape == got.shape
    return float(np.abs(ref - got).max() / np.abs(ref).max())


def _moved(jmod, tmod, *inputs, seed=0):
    shapes = jax.eval_shape(lambda: jmod.init(
        jax.random.key(0), *[jnp.asarray(x) for x in inputs]))
    variables = random_variables(shapes, seed)
    load_flax_variables(tmod, variables)
    return variables, tmod.eval()


def test_cls_head_matches_jax():
    x = np.random.default_rng(0).standard_normal((3, 24)).astype(np.float32)
    variables, tm = _moved(jheads.ClsHead(hidden_size=24, num_classes=7),
                           theads.ClsHead(24, 7), x)
    ref = jheads.ClsHead(hidden_size=24, num_classes=7).apply(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert _rel(ref, got.numpy()) <= 1e-5


@pytest.mark.parametrize("detach", [False, True])
def test_ground_head_v1_matches_jax(detach):
    rng = np.random.default_rng(1)
    txt = rng.standard_normal((2, 5, 16)).astype(np.float32)
    obj = rng.standard_normal((2, 6, 16)).astype(np.float32)
    pre = rng.standard_normal((2, 6, 16)).astype(np.float32)
    valid = rng.random((2, 6)) < 0.7
    kw = dict(input_size=16, hidden_size=12, sem_cls_size=9)
    jm = jheads.GroundHeadV1(hidden_size=12, sem_cls_size=9,
                             detach_all_aux_loss=detach)
    variables, tm = _moved(jm, theads.GroundHeadV1(
        detach_all_aux_loss=detach, **kw), txt, obj, pre, valid)
    ref = jm.apply(variables, *map(jnp.asarray, (txt, obj, pre, valid)))
    tin = [torch.from_numpy(a).requires_grad_(a.dtype != bool)
           for a in (txt, obj, pre)] + [torch.from_numpy(valid)]
    got = tm(*tin)
    assert [g.shape for g in got] == [(2, 9), (2, 6, 9), (2, 6, 9), (2, 6)]
    for r, g in zip(ref, got):
        assert _rel(r, g.detach().numpy()) <= 1e-5
    # the aux classifiers' gradient reaches the embeddings unless detached
    sum(g.sum() for g in got[:3]).backward()
    for t in tin[:3]:
        assert (t.grad is None) == detach
    # the grounding logit keeps its gradient either way
    obj_t = torch.from_numpy(obj).requires_grad_()
    tm(tin[0].detach(), obj_t, tin[2].detach(), tin[3])[3][
        torch.from_numpy(valid)].sum().backward()
    assert obj_t.grad is not None and obj_t.grad.abs().sum() > 0


def _qa_mask_inputs(seed=0, b=3, q=5, s=9, c=6, v=7, rounds=2):
    rng = np.random.default_rng(seed)
    out = {"answer_scores": rng.standard_normal((b, v)).astype(np.float32),
           "predictions_mask": [rng.standard_normal((b, s, q)).astype(
               np.float32) * 3 for _ in range(rounds)],
           "predictions_class": [rng.standard_normal((b, q, c)).astype(
               np.float32) for _ in range(rounds)]}
    label = (rng.random((b, v)) < 0.3).astype(np.float32)
    label[:, 0] = 1
    batch = {"answer_label": label,
             "gt_attn_mask": rng.random((b, q, s)) < 0.4,
             "instance_labels": rng.integers(-1, c, (b, q)).astype(np.int32),
             "obj_masks": rng.random((b, q)) < 0.7,
             "padding_mask": rng.random((b, q, s)) < 0.8}
    batch["padding_mask"][0, 0] = False       # an instance with no segment
    return out, batch


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _to_torch(tree):
    return jax.tree_util.tree_map(lambda x: torch.from_numpy(np.asarray(x)),
                                  tree)


def test_answer_and_query3d_mask_losses_match_jax():
    out, batch = _qa_mask_inputs()
    ref = float(jlosses.query3d_mask_loss(
        *map(_to_jax, (out["predictions_mask"], out["predictions_class"])),
        _to_jax(batch)))
    got = float(tlosses.query3d_mask_loss(
        *map(_to_torch, (out["predictions_mask"],
                         out["predictions_class"])), _to_torch(batch)))
    assert math.isfinite(got) and abs(got - ref) <= 1e-6 * abs(ref)
    names = ["answer_loss", "query3d_mask_loss"]
    weights = {"answer_loss": 2.0}
    jt, jp = JLoss(names, weights)(_to_jax(out), _to_jax(batch))
    tt, tp = TLoss(names, weights)(_to_torch(out), _to_torch(batch))
    assert set(tp) == set(jp) == set(names)
    assert abs(float(tt) - float(jt)) <= 1e-6 * abs(float(jt))
    for k in jp:
        assert abs(float(tp[k]) - float(jp[k])) <= 1e-6 * abs(float(jp[k]))
    # absent inputs: the entry contributes nothing, as in JAX
    for key in ("answer_label", "gt_attn_mask"):
        b2 = {k: v for k, v in batch.items() if k != key}
        _, jp = JLoss(names)(_to_jax(out), _to_jax(b2))
        _, tp = TLoss(names)(_to_torch(out), _to_torch(b2))
        assert set(tp) == set(jp) and len(tp) == 1


QA_OVERRIDES = [
    "data.train=[SyntheticQA]",
    "data.synthetic.num_train=4", "data.synthetic.num_val=4",
    "data.synthetic.n_points=400", "data.synthetic.n_instances=4",
    "data.unified_options.max_obj_len=6",
    "data.unified_options.num_points=32",
    "data.unified_options.prompt_len=8",
    "data.unified_options.response_len=6",
    "dataloader.batchsize=4", "dataloader.batchsize_eval=4",
    "dataloader.allow_single_device=True",
    "model.hidden_size=32",
    "model.heads=[ground, generation, qa]",
    "model.qa_num_answers=3",  # the SyntheticQA answer vocabulary
    "model.txt_tower.width=16", "model.txt_tower.layers=1",
    "model.txt_tower.heads=2",
    "model.unified_encoder.args.num_attention_heads=4",
    "model.unified_encoder.args.num_layers=1",
    "model.generation_head.args.d_model=16",
    "model.generation_head.args.d_kv=4",
    "model.generation_head.args.d_ff=32",
    "model.generation_head.args.num_layers=1",
    "model.generation_head.args.num_heads=2",
    "model.generation_head.args.max_new_tokens=4",
    "model.ground_head.args.hidden_size=16",
    "solver.epochs=1", "solver.epochs_per_eval=1", "device=cpu"]


def test_qa_trainer_trains_and_evaluates(tmp_path):
    cfg = tconfig.load_config("unified_tasks_synthetic", QA_OVERRIDES + [
        f"base_dir={tmp_path}", f"exp_dir={tmp_path / 'run'}"])
    trainer = trun.build_multitask_trainer(cfg)
    assert [n for n, _ in trainer.loss_fn.entries] == [
        "ground_loss", "generation_loss", "answer_loss"]
    assert trainer.model.qa_head.MLPHead_0.Dense_1.out_features == 3
    batch = next(iter(trainer.train_data(0)))
    assert batch["answer_label"].shape == (4, 3)
    assert (batch["answer_label"].sum(-1) >= 1).all()
    metrics = trainer.train_batch(batch)
    assert "answer_loss" in metrics
    assert math.isfinite(float(metrics["answer_loss"]))
    results = trainer.eval_epoch(0)
    acc = {k: v for k, v in results.items() if "acc" in k.lower()}
    assert acc and all(math.isfinite(v) for v in results.values()), results
    trainer._close_loaders()


def test_qa_num_answers_from_the_config():
    """``qa_head.args.num_answers`` wins over ``qa_num_answers``; 8864
    without either, as in JAX's ``build_model``."""
    base = tconfig.load_config("unified_tasks_synthetic", [
        "model.heads=[ground, qa]", "model.hidden_size=32",
        "model.txt_tower.width=16", "model.txt_tower.layers=1",
        "model.txt_tower.heads=2",
        "model.unified_encoder.args.num_attention_heads=4",
        "model.unified_encoder.args.num_layers=1"])
    from pq3d_tpu_torch.models.query3d import build_model
    m = build_model(base, device="cpu")
    assert m.qa_head.MLPHead_0.Dense_1.out_features == 8864
    base["model"]["qa_num_answers"] = 11
    assert build_model(base, device="cpu").qa_head.MLPHead_0.Dense_1 \
        .out_features == 11
    base["model"]["qa_head"] = {"args": {"num_answers": 13}}
    assert build_model(base, device="cpu").qa_head.MLPHead_0.Dense_1 \
        .out_features == 13
