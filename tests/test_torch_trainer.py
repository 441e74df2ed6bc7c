"""The port's training path against the JAX package's, at small width:
one train step of the whole stage-1 model (loss, every gradient, the BN
running statistics), the evaluator's AP dict, and the trainer end to end
through ``python -m pq3d_tpu_torch.run`` on the CPU with a resume.

The train step runs both models in train mode with dropout 0 (the JAX
decoder's fixed 0.1 is switched off by making flax's Dropout the
identity), so nothing random differs; BN uses batch statistics and the
port's routed convs go through kernel B1's Function (on its plain
version here).  Both packages' sparse convs compute in f32 for this
comparison: with bf16 operands a random-init U-Net in train mode is too
ill-conditioned to compare gradients (the JAX model's own gradients move
by 20-70% per tensor when its input moves by 1e-4), so where each conv
rounds to bf16 is held per op in test_torch_train_ops.py and the whole
step here.  Tolerances: loss 5e-3 relative; gradients max|diff| /
max|ref| <= 3e-2; running statistics 1e-3.
"""
import functools
import json
import math
import os
import subprocess
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import torch

from pq3d_tpu.eval.instseg_eval import InstSegEval as JInstSegEval
from pq3d_tpu.models import query3d as jq3d
from pq3d_tpu.ops import hungarian
from pq3d_tpu.ops import sparse as jsparse
from pq3d_tpu.optim import losses as jlosses
from pq3d_tpu_torch import run as trun
from pq3d_tpu_torch.eval.instseg_eval import InstSegEval as TInstSegEval
from pq3d_tpu_torch.models import query3d as tq3d
from pq3d_tpu_torch.ops import sparse as tsparse
from pq3d_tpu_torch.ops import zrun_conv as tzr
from pq3d_tpu_torch.optim import losses as tlosses
from pq3d_tpu_torch.serve import to_device
from pq3d_tpu_torch.utils.weights import load_flax_variables, torch_name
from test_torch_model import _batch, _random_variables, _route_small

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rel(ref, got):
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    return float(np.abs(ref - got).max() / (np.abs(ref).max() + 1e-12))


def _train_models():
    kw = dict(memories=("voxel", "mv", "pc"), heads=("mask",),
              hidden_size=32, dim_loc=3)
    jm = jq3d.Query3DUnified(
        unified=jq3d.UnifiedEncoderCfg(
            num_layers=2, num_blocks=2, num_attention_heads=4,
            structure="parallel", spatial_selfattn=True, use_self_mask=True),
        mv_enc=jq3d.EncoderCfg(input_feat_size=16, dropout=0.0),
        pc_enc=jq3d.EncoderCfg(input_feat_size=16, dropout=0.0),
        voxel_enc=jq3d.VoxelEncoderCfg(hlevels=(0, 1), out_channels=20,
                                       dropout=0.0, remat_policy="none",
                                       grad_mode="scatter_free"),
        mask_head_cfg=jq3d.MaskHeadCfg(num_targets=21,
                                       filter_out_classes=(0, 2)), **kw)
    tm = tq3d.Query3DUnified(
        unified=tq3d.UnifiedEncoderCfg(
            num_layers=2, num_blocks=2, num_attention_heads=4,
            structure="parallel", spatial_selfattn=True, use_self_mask=True),
        mv_enc=tq3d.EncoderCfg(16, dropout=0.0),
        pc_enc=tq3d.EncoderCfg(16, dropout=0.0),
        voxel_enc=tq3d.VoxelEncoderCfg(hlevels=(0, 1), out_channels=20,
                                       dropout=0.0, pallas_conv=True),
        mask_head_cfg=tq3d.MaskHeadCfg(21, (0, 2)), **kw)
    return jm, tm


def _jax_assignment(out, bj, cfg):
    costs = []
    for cl, mk in zip(out["predictions_class"], out["predictions_mask"]):
        cost = (cfg.cost_class * jlosses.batch_class_cost(
                    cl, bj["instance_labels"])
                + sum(w * c for w, c in zip(
                    (cfg.cost_mask, cfg.cost_dice), jlosses.batch_mask_cost(
                        mk, bj["segment_masks"], bj["seg_pad_masks"]))))
        cost = jnp.where(bj["instance_valid"][:, None, :], cost,
                         jlosses.PAD_COST)
        costs.append(jnp.swapaxes(cost, 1, 2))
    costs = jnp.stack(costs)
    col = hungarian.solve_batch(costs.reshape((-1,) + costs.shape[2:]))
    return np.asarray(col).reshape(costs.shape[:3])


def test_train_step_matches_jax(monkeypatch):
    b = _batch()
    b["instance_labels"] = (b["instance_labels"] % 17 + 3).astype(np.int32)
    jm, tm = _train_models()
    bj = jax.tree_util.tree_map(jnp.asarray, b)
    variables = _random_variables(lambda: jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, bj,
        train=False))
    cfg_j = jlosses.InstSegLossConfig(num_classes=20)
    cfg_t = tlosses.InstSegLossConfig(num_classes=20)

    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)
    for fn in ("sparse_conv_sym", "sparse_conv_down",
               "sparse_conv_transpose_gf", "conv0_dense_block"):
        monkeypatch.setattr(jsparse, fn, functools.partial(
            getattr(jsparse, fn), compute_dtype=jnp.float32))
    monkeypatch.setattr(tsparse, "_round", lambda t, dtype: t.float())

    def loss_j(params):
        out, upd = jm.apply(
            {"params": params, "batch_stats": variables["batch_stats"],
             "buffers": variables["buffers"]}, bj, train=True,
            mutable=["batch_stats"])
        total, _ = jlosses.instseg_set_loss(
            out["predictions_class"], out["predictions_mask"], bj, cfg_j)
        return total, (upd["batch_stats"], out)
    (total_j, (stats_j, out_j)), grads_j = jax.jit(
        jax.value_and_grad(loss_j, has_aux=True))(variables["params"])

    _route_small(monkeypatch, 128)
    load_flax_variables(tm, variables)
    tm.train()
    for m in tm.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    routed = []
    orig = tzr.zrun_conv_sym
    monkeypatch.setattr(tzr, "zrun_conv_sym",
                        lambda *a, **k: routed.append(1) or orig(*a, **k))
    bt = to_device(b, torch.device("cpu"))
    out_t = tm(bt)
    total_t, _ = tlosses.instseg_set_loss(
        out_t["predictions_class"], out_t["predictions_mask"], bt, cfg_t)
    total_t.backward()
    assert routed

    costs_t = tlosses.round_costs(
        out_t["predictions_class"], out_t["predictions_mask"], bt,
        cfg_t).numpy()
    col_t = tlosses.assign(costs_t)
    col_j = _jax_assignment(out_j, bj, cfg_j)
    # the same assignment of every real target, except among queries that
    # are identical: round 0 predicts from the all-zero initial query, so
    # every query's cost column is the same there and any permutation is
    # optimal (and gives the same loss and gradients)
    for r in range(col_t.shape[0]):
        for i in range(col_t.shape[1]):
            v = b["instance_valid"][i]
            if np.array_equal(col_t[r, i, v], col_j[r, i, v]):
                continue
            c = costs_t[r, i][v]
            assert np.array_equal(c[:, col_t[r, i, v]],
                                  c[:, col_j[r, i, v]]), (r, i)
            assert r == 0, r
    assert abs(total_t.item() - float(total_j)) <= 5e-3 * abs(float(total_j))

    tparams = dict(tm.named_parameters())
    # a gradient below 1e-6 of the largest one is f32 noise on an exact
    # zero: the spatial self-attention's key bias shifts every logit of a
    # query alike, so softmax cancels it
    floor = 1e-6 * max(float(np.abs(np.asarray(g)).max())
                       for g in jax.tree_util.tree_leaves(grads_j))
    checked = 0
    for path, g in jax.tree_util.tree_flatten_with_path(grads_j)[0]:
        keys = tuple(p.key for p in path)
        name, ref = torch_name(tm, keys, np.asarray(g))
        got = tparams[name].grad
        if not np.abs(ref).max() > floor:
            # unreached by the loss (the backbone's `final`): no gradient
            assert got is None or np.abs(got.numpy()).max() <= floor, name
            continue
        assert _rel(ref, got.numpy()) <= 3e-2, (name, _rel(ref, got.numpy()))
        checked += 1
    assert checked > 100
    assert tm.voxel_encoder.backbone.final.weight.grad is None
    for path, v in jax.tree_util.tree_flatten_with_path(stats_j)[0]:
        keys = tuple(p.key for p in path)
        name, ref = torch_name(tm, keys, np.asarray(v))
        np.testing.assert_allclose(dict(tm.named_buffers())[name].numpy(),
                                   ref, rtol=1e-3, atol=1e-3, err_msg=name)


def _eval_inputs(seed=0, b=2, q=8, s=24, m=5):
    rng = np.random.default_rng(seed)
    gt = rng.random((b, m, s)) < 0.3
    labels = rng.integers(3, 40, (b, m)).astype(np.int32)
    labels[:, :2] = 5                       # shared classes across scenes
    inst_valid = np.arange(m)[None] < np.array([[4], [5]])
    seg_valid = np.arange(s)[None] < np.array([[20], [24]])
    sizes = rng.integers(20, 200, (b, s)).astype(np.float32)
    cls = rng.standard_normal((b, q, 201)).astype(np.float32)
    mask = rng.standard_normal((b, s, q)).astype(np.float32)
    for i in range(b):                      # some queries find a target
        for j in range(min(q, m)):
            cls[i, j, labels[i, j]] += 6
            mask[i, :, j] += np.where(gt[i, j], 4.0, -4.0)
    out = {"predictions_class": [cls], "predictions_mask": [mask]}
    batch = {"seg_pad_masks": seg_valid, "segment_masks": gt,
             "instance_labels": labels, "instance_valid": inst_valid,
             "segment_sizes": sizes}
    return out, batch


def test_instseg_eval_matches_jax():
    results = []
    for ev in (JInstSegEval(num_classes=200), TInstSegEval(num_classes=200)):
        for seed in (0, 1):
            ev.update(*_eval_inputs(seed))
        results.append(ev.record())
    ref, got = results
    assert set(got) == set(ref) and ref["all_ap_50%"] > 0
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-9, err_msg=k)


TINY = ["device=cpu", "data.train=[SyntheticInstSeg]",
        "data.val=[SyntheticInstSeg]", "data.synthetic.num_train=2",
        "data.synthetic.num_val=2", "data.synthetic.n_points=1200",
        "data.synthetic.n_instances=4", "data.synthetic.n_segments=24",
        "data.instseg_options.voxel_size=0.05",
        "data.instseg_options.num_queries=8",
        "data.instseg_options.max_segments=32",
        "data.instseg_options.max_instances=8",
        "data.instseg_options.voxel_bucket=256",
        "data.instseg_options.level_caps=[2048, 1024, 512, 256, 128]",
        "model.hidden_size=32",
        "model.unified_encoder.args.num_attention_heads=4",
        "model.unified_encoder.args.num_layers=1",
        "model.unified_encoder.args.num_blocks=1",
        "model.voxel_encoder.args.hlevels=[0]",
        "dataloader.batchsize=2", "dataloader.batchsize_eval=2",
        "solver.epochs_per_eval=1", "solver.epochs_per_save=1",
        "log_every=1"]


def test_run_trains_resumes_and_evaluates(tmp_path, monkeypatch):
    from pq3d_tpu_torch.train.trainer import Query3DTrainer
    # the in-process resume must not leave signal handlers in this process
    monkeypatch.setattr(Query3DTrainer, "install_preemption_handler",
                        lambda self, signals=None: None)
    exp = str(tmp_path / "run")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "pq3d_tpu_torch.run", "--config-name",
         "instseg_sceneverse", *TINY, "solver.epochs=2", f"exp_dir={exp}"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        recs = [json.loads(l) for l in f]
    train = [r for r in recs if r["prefix"] == "train"]
    assert [r["step"] for r in train] == [1, 2]
    assert all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
               for r in train)
    assert sum(r["prefix"] == "val" for r in recs) == 2
    for name in ("latest", "best", "ckpt_1", "ckpt_2"):
        assert os.path.exists(os.path.join(exp, "ckpt", name, "state.pt"))
    saved = torch.load(os.path.join(exp, "ckpt", "latest", "state.pt"),
                       weights_only=False)
    assert saved["step"] == 2 and saved["tracker"]["epoch"] == 2

    trainer = trun.main(["--config-name", "instseg_sceneverse", *TINY,
                         "resume=True", "solver.epochs=3", f"exp_dir={exp}"])
    assert trainer.tracker.epoch == 3 and trainer.step == 3
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        steps = [json.loads(l)["step"] for l in f
                 if '"train"' in l]
    assert steps == [1, 2, 3]
    results = trainer.eval_epoch(0)
    assert {"all_ap", "all_ap_50%", "all_ap_25%", "target_metric"} \
        <= set(results)
