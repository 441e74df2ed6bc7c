"""The port's data parallelism (``pq3d_tpu_torch/parallel/dist.py``) on
the CPU: two gloo ranks, started by ``python -m pq3d_tpu_torch.launch``,
against one process at the global batch and against the JAX package,
whose batch is one array under ``jit`` (so its reductions over the batch
are global).

- The synced ``MaskedBatchNorm``: output, the input's and parameters'
  gradients (summed over the ranks) and the running statistics against
  JAX's ``MaskedBatchNorm`` on the concatenated batch (rel 1e-5) and
  against one process (rel 1e-6); the unmasked ``BatchNorm`` against one
  process.
- The loss normalisers: ``instseg_set_loss``, ``generation_loss`` and
  ``ground_loss``, the ranks' shares summed against one process (rel
  1e-6), and each rank's input gradients against one process's rows.
- The evaluators over 5 items at a global batch of 2 (the last batch
  wrap-padded, rank 1's row of it all padding): ``ScanReferEval``'s
  (value, count) merge, ``InstSegEval`` and ``Scan2CapEval`` gathered to
  rank 0, each equal to one process exactly and the same on both ranks
  (JAX's ``tests/test_multihost_2proc.py`` holds its merge so, slow).
- Gradient accumulation (k = 2, ``no_sync`` on the micro-step that does
  not update): the weights after each micro-step against one process
  (rel 1e-6).
- One stage-1 train step (the whole small model of
  ``tests/test_torch_trainer.py``, the set loss, every sparse conv in f32,
  dropout 0) at a global batch of 4: the two ranks end with bit-identical
  gradients and statistics; against one process at batch 4 the loss
  within 1e-6 and every gradient within 1e-5 of its own largest entry;
  against the JAX trainer's jitted step on a 2-device mesh from the same
  weights (``utils/weights.py``) the loss within 5e-3 and gradients within
  3e-2 of their largest entry, the tolerances of
  ``test_torch_trainer.py``'s one-process comparison, and the BN running
  statistics within 1e-3.
"""
import functools
import os
import pickle
import shutil

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_ddp_worker as w
from pq3d_tpu.models import layers as jlayers
from pq3d_tpu.models import query3d as jq3d
from pq3d_tpu.ops import sparse as jsparse
from pq3d_tpu.optim import losses as jlosses
from pq3d_tpu.parallel.mesh import MeshConfig, make_mesh, shard_batch
from pq3d_tpu.train.state import TrainState
from pq3d_tpu.train.state import make_train_step as jmake_train_step
from pq3d_tpu_torch.ops import sparse as tsparse
from pq3d_tpu_torch.utils.weights import load_flax_variables, torch_name
from test_torch_model import _random_variables

torch.set_num_threads(1)


def _rel(ref, got):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    return float(np.abs(ref - got).max() / (np.abs(ref).max() + 1e-30))


@pytest.fixture(scope="module")
def units(tmp_path_factory):
    d = tmp_path_factory.mktemp("units")
    ranks = w.spawn("units", d)
    x, valid, r, scale, bias = w.bn_inputs()
    one = {"masked_bn": w.masked_bn(x, valid, r, scale, bias),
           "plain_bn": w.plain_bn(x, r),
           "losses": w.losses(w.loss_inputs()),
           "eval": w.run_evaluators(w.eval_batches(), split=False)}
    return ranks, one


def _join(ranks, part, key):
    """A per-row result of both ranks: concatenated; a parameter's
    gradient: summed (each rank holds its rows' part); a running
    statistic: rank 0's, after checking that both ranks hold it."""
    a, b = ranks[0][part][key], ranks[1][part][key]
    if key in ("y", "dx"):
        return torch.cat([a, b])
    if key in ("mean", "var"):
        assert torch.equal(a, b), key
        return a
    return a + b


def test_masked_batch_norm_matches_jax_on_the_whole_batch(units):
    ranks, one = units
    x, valid, r, scale, bias = w.bn_inputs()
    bn = jlayers.MaskedBatchNorm(momentum=0.02)
    variables = bn.init(jax.random.key(0), x, valid)
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}

    def loss(p, xx):
        y, upd = bn.apply({"params": p,
                           "batch_stats": variables["batch_stats"]},
                          xx, valid, mutable=["batch_stats"])
        return (y * r).sum(), (y, upd["batch_stats"])
    (_, (y, stats)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    c = x.shape[-1]
    ref = {"y": np.asarray(y).reshape(-1, c),
           "dx": np.asarray(gx).reshape(-1, c),
           "dscale": gp["scale"], "dbias": gp["bias"],
           "mean": stats["mean"], "var": stats["var"]}
    for key, want in ref.items():
        got = _join(ranks, "masked_bn", key).numpy()
        assert _rel(want, got) <= 1e-5, (key, _rel(want, got))
        assert _rel(one["masked_bn"][key].numpy(), got) <= 1e-6, key


def test_batch_norm_two_ranks_match_one_process(units):
    ranks, one = units
    for key in ("y", "dx", "dw", "db", "mean", "var"):
        got = _join(ranks, "plain_bn", key).numpy()
        want = one["plain_bn"][key].numpy()
        assert _rel(want, got) <= 1e-6, (key, _rel(want, got))


@pytest.mark.parametrize("name", ["set", "generation", "ground"])
def test_loss_normalisers_sum_to_one_process(units, name):
    """Each rank's loss is its rows' share of the global loss: the shares
    sum to one process's loss (and parts), and each rank's gradient of
    its share is one process's gradient on its rows."""
    ranks, one = units
    total, parts, grads = one["losses"][name]
    shares = [rk["losses"][name] for rk in ranks]
    assert abs(sum(s[0] for s in shares) - total) <= 1e-6 * abs(total)
    for k, v in parts.items():
        assert abs(sum(s[1][k] for s in shares) - v) <= 1e-6 * abs(v), k
    for i, g in enumerate(grads):
        got = torch.cat([s[2][i] for s in shares]).numpy()
        assert _rel(g.numpy(), got) <= 1e-6, (name, i, _rel(g, got))


@pytest.mark.parametrize("name", ["refer", "caption", "instseg"])
def test_evaluators_merge_to_one_process_exactly(units, name):
    ranks, one = units
    want = one["eval"][name]
    assert want and ranks[0]["eval"][name] == want, \
        (ranks[0]["eval"][name], want)
    assert ranks[1]["eval"][name] == want


def test_accumulation_two_ranks_match_one_process(units):
    """Gradient accumulation (k = 2) under DDP: the micro-step that does
    not update skips the all-reduce, the next carries the window's sum;
    the weights after every micro-step equal one process's at the global
    batch within 1e-6 (SGD, which moves by the window's mean)."""
    ranks, one = units
    want = w.accumulate(*w.accum_inputs())
    for rk in ranks:
        for got_step, want_step in zip(rk["accumulate"], want):
            for g, ref in zip(got_step, want_step):
                assert _rel(ref.numpy(), g.numpy()) <= 1e-6
    # the optimizer stepped on micro-steps 2 and 4 only
    assert [not torch.equal(a[0], b[0]) for a, b in zip(want, want[1:])] \
        == [False, True, False, True]


def test_flag_agreement_and_object_gather(units):
    ranks, _ = units
    for rk in ranks:
        assert rk["any_rank"] == (True, False)
        assert rk["all_gather"] == [("r", 0), ("r", 1)]


# ------------------------------------------------------------ stage 1 step

def _capture_grads():
    """An optax transformation that leaves the parameters and keeps the
    step's gradients as its state."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


def _jax_stage1_model():
    return jq3d.Query3DUnified(
        unified=jq3d.UnifiedEncoderCfg(
            num_layers=2, num_blocks=2, num_attention_heads=4,
            structure="parallel", spatial_selfattn=True, use_self_mask=True),
        mv_enc=jq3d.EncoderCfg(input_feat_size=16, dropout=0.0),
        pc_enc=jq3d.EncoderCfg(input_feat_size=16, dropout=0.0),
        voxel_enc=jq3d.VoxelEncoderCfg(hlevels=(0, 1), out_channels=20,
                                       dropout=0.0, remat_policy="none",
                                       grad_mode="scatter_free"),
        mask_head_cfg=jq3d.MaskHeadCfg(num_targets=21,
                                       filter_out_classes=(0, 2)),
        memories=("voxel", "mv", "pc"), heads=("mask",), hidden_size=32,
        dim_loc=3)


@pytest.fixture(scope="module")
def stage1(tmp_path_factory):
    d = tmp_path_factory.mktemp("step1")
    batch = w.stage1_batch()
    with open(d / "batch.pkl", "wb") as f:
        pickle.dump(batch, f)
    jm = _jax_stage1_model()
    bj = jax.tree_util.tree_map(jnp.asarray, batch)
    variables = _random_variables(lambda: jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, bj,
        train=False))
    tm = w.stage1_model()
    load_flax_variables(tm, variables)
    torch.save(tm.state_dict(), d / "model.pt")
    ranks = w.spawn("step1", d)
    shutil.rmtree(d)            # the ranks' results are in memory

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(tsparse, "_round", lambda t, dtype: t.float())
        one = w.train_step(tm, batch, w.stage1_loss)
        mp.setattr(fnn.Dropout, "__call__",
                   lambda self, x, deterministic=None, rng=None: x)
        for fn in ("sparse_conv_sym", "sparse_conv_down",
                   "sparse_conv_transpose_gf", "conv0_dense_block"):
            mp.setattr(jsparse, fn, functools.partial(
                getattr(jsparse, fn), compute_dtype=jnp.float32))
        cfg = jlosses.InstSegLossConfig(num_classes=20)
        tx = _capture_grads()
        state = TrainState.create(variables, tx, jax.random.key(5))
        mesh = make_mesh(MeshConfig(data=2), devices=jax.devices()[:2])
        new_state, jmetrics = jmake_train_step(
            jm, tx, lambda out, b: jlosses.instseg_set_loss(
                out["predictions_class"], out["predictions_mask"], b, cfg),
            donate=False)(state, shard_batch(bj, mesh))
    finally:
        mp.undo()
    ref = {"metrics": {k: float(v) for k, v in jmetrics.items()},
           "grads": jax.tree_util.tree_map(np.asarray, new_state.opt_state),
           "stats": jax.tree_util.tree_map(np.asarray,
                                           new_state.batch_stats)}
    return ranks, one, ref, tm


def test_stage1_step_ranks_agree_bit_for_bit(stage1):
    ranks = stage1[0]
    (m0, g0, s0), (m1, g1, s1) = ranks
    assert m0 == m1
    assert g0.keys() == g1.keys() and s0.keys() == s1.keys()
    assert all(torch.equal(g0[k], g1[k]) for k in g0)
    assert all(torch.equal(s0[k], s1[k]) for k in s0)


def test_stage1_step_matches_one_process_at_the_global_batch(stage1):
    (m, grads, stats), (m1, grads1, stats1) = stage1[0][0], stage1[1]
    for k, v in m1.items():
        assert abs(m[k] - v) <= 1e-6 * max(abs(v), 1e-12), (k, m[k], v)
    assert grads.keys() == grads1.keys()
    # a gradient below 1e-6 of the largest is f32 noise on an exact zero
    # (the spatial attention's key bias: softmax cancels it)
    top = max(g.abs().max().item() for g in grads1.values())
    checked = 0
    for k, g in grads1.items():
        if g.abs().max().item() <= 1e-6 * top:
            continue
        assert _rel(g.numpy(), grads[k].numpy()) <= 1e-5, \
            (k, _rel(g.numpy(), grads[k].numpy()))
        checked += 1
    assert checked > 100
    for k, v in stats1.items():
        assert _rel(v.numpy(), stats[k].numpy()) <= 1e-6, k


def test_stage1_step_matches_jax_on_a_two_device_mesh(stage1):
    (m, grads, stats), ref, tm = stage1[0][0], stage1[2], stage1[3]
    loss_j = ref["metrics"]["loss"]
    assert abs(m["loss"] - loss_j) <= 5e-3 * abs(loss_j), (m["loss"], loss_j)
    leaves = jax.tree_util.tree_flatten_with_path(ref["grads"])[0]
    top = max(np.abs(g).max() for _, g in leaves)
    checked = 0
    for path, g in leaves:
        name, want = torch_name(tm, tuple(p.key for p in path), g)
        got = grads.get(name)
        if np.abs(want).max() <= 1e-6 * top:
            assert got is None or got.abs().max() <= 1e-6 * top, name
            continue
        diff = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert diff <= 3e-2, (name, diff)
        checked += 1
    assert checked > 100
    for path, v in jax.tree_util.tree_flatten_with_path(ref["stats"])[0]:
        name, want = torch_name(tm, tuple(p.key for p in path), v)
        np.testing.assert_allclose(stats[name].numpy(), want, rtol=1e-3,
                                   atol=1e-3, err_msg=name)
