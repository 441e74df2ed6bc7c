"""The port's ``data x fsdp x tp`` mesh (``pq3d_tpu_torch/parallel/mesh.py``,
``parallel/tp.py``) on the CPU, on gloo ranks started by ``python -m
pq3d_tpu_torch.launch``, against one process and against the JAX
package's mesh (``pq3d_tpu/parallel/mesh.py``) on the 8 virtual devices:

- placement: for every parameter of the small stage-1 model of
  ``tests/test_torch_trainer.py`` and of the small unified model of
  ``tests/test_torch_unified.py`` at ``data=2, fsdp=2, tp=2`` with
  ``fsdp_min_size`` 64 and 512, the port's placement equals JAX's
  ``param_spec`` on the same flax path and shape, in the torch layout;
  the cases of ``tests/test_parallel.py``'s rule tests;
- the sharded forward on 4 ranks (``fsdp=2, tp=2`` and ``data=2, tp=2``):
  ``MultiHeadAttention(64, 4)`` against one process and JAX's sharded
  forward at rtol and atol 2e-5; the unified model's ``ground_logits``
  within 1e-4 of the largest and its greedy tokens equal;
- one train step (AdamW, a gradient clip that acts, dropout 0): stage 1
  at a global batch of 4 under ``fsdp=2`` (2 ranks, every sparse conv in
  f32) and stage 2 at 6 under ``fsdp=2, tp=2`` (4 ranks); against one
  process the loss within 1e-6, the gathered gradients within 1e-5 of
  their largest entry and the weights after AdamW within 1e-6; against
  JAX's step on the ``data=2, fsdp=2, tp=2`` mesh from the same weights
  the loss within 5e-3 and the gradients within 3e-2 (the tolerances of
  ``tests/test_torch_ddp.py``); each rank holds exactly its blocks of the
  fsdp-placed bytes, and tp peers end with equal replicated weights;
- checkpoints: ``run.main`` under ``fsdp=2, tp=2`` saves the gathered
  state, which one process loads bit for bit and evaluates as the ranks
  did; a one-process checkpoint resumes under the mesh bit for bit;
- the refusals: axes that do not make the world, a batch that does not
  split over ``data x fsdp``.
"""
import functools
import os
import shutil
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ddp_worker as w
import _torch_mesh_worker as mw
from pq3d_tpu.config import default_config_dir
from pq3d_tpu.config import load_config as jload
from pq3d_tpu.models import query3d as jq3d
from pq3d_tpu.ops import sparse as jsparse
from pq3d_tpu.optim import losses as jlosses
from pq3d_tpu.optim.loss_aggregator import Loss as JLoss
from pq3d_tpu.parallel import mesh as jmesh
from pq3d_tpu.train.state import TrainState
from pq3d_tpu.train.state import make_train_step as jmake_train_step
from pq3d_tpu_torch import run as trun
from pq3d_tpu_torch.data import unified_pipeline as tup
from pq3d_tpu_torch.models import query3d as tq3d
from pq3d_tpu_torch.models.layers import FFNLayer, MultiHeadAttention
from pq3d_tpu_torch.models.t5 import T5Decoder
from pq3d_tpu_torch.optim.loss_aggregator import Loss as TLoss
from pq3d_tpu_torch.ops import sparse as tsparse
from pq3d_tpu_torch.parallel import dist
from pq3d_tpu_torch.parallel import mesh as tmesh
from pq3d_tpu_torch.serve import to_device
from pq3d_tpu_torch.train.trainer import Query3DTrainer
from pq3d_tpu_torch.utils.weights import (load_flax_variables, param_paths,
                                          torch_name)
from test_torch_ddp import _capture_grads, _jax_stage1_model, _rel
from test_torch_pointnet import random_variables
from test_torch_unified import FEATURE_DIMS, PIPE, _models, _requests
from test_torch_unified_train import STEP

torch.set_num_threads(1)
JAX_MESH = jmesh.MeshConfig(data=2, fsdp=2, tp=2)
CPU = torch.device("cpu")


def _jax_mesh(cfg):
    return jmesh.make_mesh(cfg, devices=jax.devices()[:8])


def _want_spec(spec, ndim, flip):
    """A JAX ``PartitionSpec`` as the port's placement: one entry a dim,
    reversed for a Linear's kernel."""
    spec = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    return spec[::-1] if flip else spec


# ------------------------------------------------------------ placement

def _stage1_pair():
    batch = w.stage1_batch()
    jm = _jax_stage1_model()
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        jax.tree.map(jnp.asarray, batch), train=False))
    return shapes["params"], w.stage1_model()


def _unified_pair():
    jm, tm = _models()
    pipe = tup.UnifiedPipelineConfig(**PIPE)
    rng = np.random.default_rng(0)
    items = [tup.process_item(s, l, pipe, rng, False, FEATURE_DIMS)
             for s, l in _requests(6)]
    batch = tup.collate_unified(items, pipe, FEATURE_DIMS, train=False)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        jax.tree.map(jnp.asarray, batch), train=False))
    return shapes["params"], tm


@pytest.mark.parametrize("min_size", [64, 512])
@pytest.mark.parametrize("which", ["stage1", "unified"])
def test_placement_matches_jax_param_spec(which, min_size):
    params, tm = (_stage1_pair if which == "stage1" else _unified_pair)()
    cfg = dict(data=2, fsdp=2, tp=2, fsdp_min_size=min_size)
    got = tmesh.placements(tm, tmesh.MeshConfig(**cfg))
    flips = {path: (name, flip) for name, path, _, flip in param_paths(tm)}
    seen, kinds = set(), set()
    for path, x in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = tuple(p.key for p in path)
        name, flip = flips[keys]
        spec = jmesh.param_spec(jmesh.path_name(path) + "/", x,
                                jmesh.MeshConfig(**cfg))
        assert got[name] == _want_spec(spec, x.ndim, flip), \
            (name, got[name], spec)
        seen.add(name)
        kinds.update(a for a in got[name] if a)
    assert seen == set(got) and kinds == {"fsdp", "tp"}


def _rule_case(case):
    """(port placements, JAX specs by flax path) of one rule test of
    ``tests/test_parallel.py``."""
    from pq3d_tpu.models.layers import FFNLayer as JFFN
    from pq3d_tpu.models.layers import MultiHeadAttention as JMHA
    from pq3d_tpu.models.t5 import T5Decoder as JT5
    cfg = dict(data=2, fsdp=1, tp=2)
    x = jnp.zeros((1, 8, 64))
    if case == "attention":
        jm, tm, args = JMHA(d_model=64, n_head=4), MultiHeadAttention(64, 4), \
            (x, x, x)
    elif case == "ffn":
        jm, tm, args = JFFN(d_model=64, dim_feedforward=128), \
            FFNLayer(64, 128), (x,)
    else:
        jm = JT5(vocab_size=64, d_model=32, d_kv=8, d_ff=64, heads=4,
                 num_layers=1)
        tm = T5Decoder(vocab_size=64, d_model=32, d_kv=8, d_ff=64, heads=4,
                       num_layers=1)
        args = (jnp.zeros((1, 3), jnp.int32), jnp.zeros((1, 4, 32)),
                jnp.ones((1, 4), bool))
    params = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args))
    specs = {tuple(p.key for p in path)[1:]:
             jmesh.tp_spec(jmesh.path_name(path) + "/", v,
                           jmesh.MeshConfig(**cfg))
             for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    return tmesh.placements(tm, tmesh.MeshConfig(**cfg)), specs, tm


@pytest.mark.parametrize("case", ["attention", "ffn", "t5"])
def test_tp_rules_match_jax(case):
    """``test_tp_rules_match_attention_params`` and
    ``test_tp_rules_match_t5_params``: the port's ``tp_spec`` on each flax
    path equals JAX's, and the column / row products land on the torch
    weight's dim 0 / dim 1."""
    got, specs, tm = _rule_case(case)
    flips = {path: (name, flip) for name, path, _, flip in param_paths(tm)}
    for path, spec in specs.items():
        name, flip = flips[path]
        shape = tuple(dict(tm.named_parameters())[name].shape)
        ours = tmesh.tp_spec("params/" + "/".join(path) + "/",
                             shape[::-1] if flip else shape,
                             tmesh.MeshConfig(tp=2))
        assert ours == (None if spec is None else tuple(spec)), path
    col, row = {"attention": ("q_proj", "out_proj"),
                "ffn": ("Dense_0", "Dense_1"),
                "t5": ("block0.wi", "block0.wo")}[case]
    assert got[f"{col}.weight"] == ("tp", None)
    assert got[f"{row}.weight"] == (None, "tp")


@pytest.mark.parametrize("path,want", [
    ("layer/q_proj/kernel/", ("fsdp", "tp")),
    ("layer/some_embed/", (None, "fsdp"))])
def test_param_spec_fsdp_combines_with_tp(path, want):
    cfg = dict(data=2, fsdp=2, tp=2, fsdp_min_size=1)
    assert tmesh.param_spec(path, (64, 128), tmesh.MeshConfig(**cfg)) \
        == want == tuple(jmesh.param_spec(path, jnp.zeros((64, 128)),
                                          jmesh.MeshConfig(**cfg)))


def test_mesh_config_refusals():
    with pytest.raises(ValueError, match=r"data=2 x fsdp=2 x tp=2 does not "
                                         r"make the run's 4 ranks"):
        tmesh.MeshConfig(data=2, fsdp=2, tp=2).resolve(4)
    with pytest.raises(ValueError, match=r"data=-1 x fsdp=3"):
        tmesh.MeshConfig(fsdp=3).resolve(4)
    assert tmesh.MeshConfig(tp=2).resolve(8) == tmesh.MeshConfig(
        data=4, tp=2)
    # a batch the row group (data x fsdp) does not split
    cfg = trun.load_config("instseg_sceneverse",
                           ["dataloader.batchsize=6"])
    dist.set_mesh(types.SimpleNamespace(n_rows=4, row_index=0))
    try:
        reason = trun.single_device_reason(cfg)
    finally:
        dist.set_mesh(None)
    assert "batchsize=6 does not split over 4 ranks of rows" in reason
    assert trun.single_device_reason(cfg) is None


# ------------------------------------------------------------- forward

@pytest.fixture(scope="module")
def forward(tmp_path_factory):
    from pq3d_tpu.models.layers import MultiHeadAttention as JMHA
    d = tmp_path_factory.mktemp("forward")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 64)).astype(np.float32)
    jattn = JMHA(d_model=64, n_head=4)
    jparams = jattn.init(jax.random.PRNGKey(0), *(jnp.asarray(x),) * 3)
    tattn = MultiHeadAttention(64, 4)
    load_flax_variables(tattn, jparams)
    torch.save(tattn.state_dict(), d / "mha.pt")
    torch.save(torch.from_numpy(x), d / "mha_x.pt")

    jm, tm = _models()
    pipe = tup.UnifiedPipelineConfig(**PIPE)
    items = [tup.process_item(s, l, pipe, rng, False, FEATURE_DIMS)
             for s, l in _requests(6)]
    batch = tup.collate_unified(items, pipe, FEATURE_DIMS, train=False)
    bj = jax.tree.map(jnp.asarray, batch)
    variables = random_variables(jax.eval_shape(lambda: jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, bj,
        train=False)), 3)
    load_flax_variables(tm, variables)
    torch.save(tm.state_dict(), d / "unified.pt")
    torch.save(batch, d / "unified_batch.pt")
    ranks = mw.spawn("forward", d, n=4)
    shutil.rmtree(d)

    with torch.no_grad():
        one_mha = tattn(*(torch.from_numpy(x),) * 3)
        one = tm.eval()(to_device(batch, CPU))
    # JAX: the same forwards, sharded on the 8-device mesh
    cfg = dataclass_replace(JAX_MESH, fsdp_min_size=1)
    mesh = _jax_mesh(cfg)
    xb = jmesh.shard_batch(jnp.asarray(x), mesh)
    j_mha = jax.jit(jattn.apply)(jmesh.shard_params(jparams, mesh, cfg),
                                 xb, xb, xb)
    cfg = dataclass_replace(JAX_MESH, fsdp_min_size=64)
    mesh = _jax_mesh(cfg)
    sv = {c: jmesh.shard_params(variables[c], mesh, cfg) for c in variables}
    j_out = jax.jit(lambda v, b: jm.apply(v, b, train=False))(
        sv, jmesh.shard_batch(bj, mesh))
    return ranks, {"mha": one_mha.numpy(),
                   "ground_logits": one["ground_logits"].numpy(),
                   "generation_tokens": one["generation_tokens"].numpy()}, \
        {"mha": np.asarray(j_mha),
         "ground_logits": np.asarray(j_out["ground_logits"]),
         "generation_tokens": np.asarray(j_out["generation_tokens"])}, batch


def dataclass_replace(cfg, **kw):
    import dataclasses
    return dataclasses.replace(cfg, **kw)


def _joined(ranks, axes, key):
    """A per-row output of the ranks with tp index 0, in row order; each
    tp peer's equal to its tp-rank 0's."""
    by_row = {}
    for rk in ranks:
        r = rk[axes]
        if r["coords"][2] == 0:
            by_row[r["row"]] = r[key]
    for rk in ranks:
        r = rk[axes]
        assert torch.equal(r[key], by_row[r["row"]]), (axes, key)
    return torch.cat([by_row[i] for i in sorted(by_row)]).numpy()


@pytest.mark.parametrize("axes", sorted(mw.AXES))
def test_sharded_forward_matches_replicated(forward, axes):
    ranks, one, jax_ref, _ = forward
    got = _joined(ranks, axes, "mha")
    np.testing.assert_allclose(got, one["mha"], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, jax_ref["mha"], rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("axes", sorted(mw.AXES))
def test_unified_sharded_forward_matches_replicated(forward, axes):
    ranks, one, jax_ref, batch = forward
    valid = batch["query_pad_masks"]
    got = _joined(ranks, axes, "ground_logits")
    for ref in (one, jax_ref):
        assert _rel(ref["ground_logits"][valid], got[valid]) <= 1e-4
        np.testing.assert_array_equal(
            _joined(ranks, axes, "generation_tokens"),
            ref["generation_tokens"])
    # every mode ran: the attention, FFN and T5 pairs local, the encoders'
    # and heads' products gathered and scattered
    assert ranks[0][axes]["modes"] == ["col", "col_local", "row",
                                       "row_local"]


# ---------------------------------------------------------------- steps

def _jax_mesh_step(jm, variables, batch, loss_fn):
    """JAX's train step on the ``data=2, fsdp=2, tp=2`` mesh (params and
    optimizer state placed by ``shard_params``, the batch by
    ``shard_batch``), from ``variables``: its metrics and gradients."""
    mesh = _jax_mesh(JAX_MESH)
    tx = _capture_grads()
    state = TrainState.create(variables, tx, jax.random.key(5))
    state = state.replace(
        params=jmesh.shard_params(state.params, mesh, JAX_MESH),
        opt_state=jmesh.shard_params(state.opt_state, mesh, JAX_MESH))
    new_state, metrics = jmake_train_step(jm, tx, loss_fn, donate=False)(
        state, jmesh.shard_batch(jax.tree.map(jnp.asarray, batch), mesh))
    return ({k: float(v) for k, v in metrics.items()},
            jax.tree_util.tree_map(np.asarray, new_state.opt_state))


@pytest.fixture(scope="module")
def step1(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_step1")
    batch = w.stage1_batch()
    jm = _jax_stage1_model()
    variables = random_variables(jax.eval_shape(lambda: jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        jax.tree.map(jnp.asarray, batch), train=False)), 3)
    tm = w.stage1_model()
    load_flax_variables(tm, variables)
    torch.save(tm.state_dict(), d / "model.pt")
    torch.save(batch, d / "batch.pt")
    ranks = mw.spawn("step1", d, n=2)
    shutil.rmtree(d)
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(tsparse, "_round", lambda t, dtype: t.float())
        one = mw.train_step(tm, batch, w.stage1_loss)
        mp.setattr(fnn.Dropout, "__call__",
                   lambda self, x, deterministic=None, rng=None: x)
        for fn in ("sparse_conv_sym", "sparse_conv_down",
                   "sparse_conv_transpose_gf", "conv0_dense_block"):
            mp.setattr(jsparse, fn, functools.partial(
                getattr(jsparse, fn), compute_dtype=jnp.float32))
        cfg = jlosses.InstSegLossConfig(num_classes=20)
        ref = _jax_mesh_step(jm, variables, batch, lambda out, b:
                             jlosses.instseg_set_loss(
                                 out["predictions_class"],
                                 out["predictions_mask"], b, cfg))
    finally:
        mp.undo()
    return ranks, one, ref, tm


@pytest.fixture(scope="module")
def step2(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_step2")
    tcfg = w.stage2_cfg()
    batch = w.stage2_batch(tcfg)
    jcfg = jload(os.path.join(default_config_dir(),
                              "unified_tasks_synthetic.yaml"),
                 overrides=w.STAGE2)
    jm = jq3d.build_model(jcfg)
    variables = random_variables(jax.eval_shape(lambda: jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        jax.tree.map(jnp.asarray, batch), train=False)), 3)
    tm = tq3d.build_model(tcfg, device="cpu")
    load_flax_variables(tm, variables)
    torch.save(tm.state_dict(), d / "model.pt")
    torch.save(batch, d / "batch.pt")
    ranks = mw.spawn("step2", d, n=4)
    shutil.rmtree(d)
    one = mw.train_step(tm, batch, TLoss(*w.STAGE2_LOSS))
    mp = pytest.MonkeyPatch()
    mp.setattr(fnn.Dropout, "__call__",
               lambda self, x, deterministic=None, rng=None: x)
    try:
        ref = _jax_mesh_step(jm, variables, batch, JLoss(*w.STAGE2_LOSS))
    finally:
        mp.undo()
    return ranks, one, ref, tm


STEPS = ["step1", "step2"]


@pytest.mark.parametrize("which", STEPS)
def test_sharded_step_matches_one_process(which, request):
    ranks, one, _, _ = request.getfixturevalue(which)
    for rk in ranks[1:]:
        assert rk["metrics"] == ranks[0]["metrics"]
        for part in ("grads", "weights"):
            assert all(torch.equal(v, ranks[0][part][k])
                       for k, v in rk[part].items()), part
    got = ranks[0]
    assert got["metrics"].keys() == one["metrics"].keys()
    for k, v in one["metrics"].items():
        # the loss and its parts; the norm reads the gradients, 1e-5
        tol = 1e-5 if k == "grad_norm" else 1e-6
        assert abs(got["metrics"][k] - v) <= tol * abs(v), (k, v)
    # the clip acted: every gradient is scaled to the clip's norm
    assert one["metrics"]["grad_norm"] > mw.CLIP
    assert got["grads"].keys() == one["grads"].keys()
    # a gradient below 1e-6 of the largest is f32 noise on an exact zero
    top = max(g.abs().max().item() for g in one["grads"].values())
    checked = 0
    for k, g in one["grads"].items():
        if g.abs().max().item() <= 1e-6 * top:
            assert got["grads"][k].abs().max().item() <= 1e-6 * top, k
            continue
        assert _rel(g.numpy(), got["grads"][k].numpy()) <= 1e-5, k
        checked += 1
    assert checked > 50
    assert got["weights"].keys() == one["weights"].keys()
    for k, v in one["weights"].items():
        diff = (v.double() - got["weights"][k].double()).abs().max()
        assert diff <= 1e-6, (k, float(diff))


@pytest.mark.parametrize("which", STEPS)
def test_sharded_step_matches_jax_mesh(which, request):
    ranks, one, (jmetrics, jgrads), tm = request.getfixturevalue(which)
    got = ranks[0]
    loss_j = jmetrics["loss"]
    assert abs(got["metrics"]["loss"] - loss_j) <= 5e-3 * abs(loss_j)
    # the port's gradients are clipped: back to the step's own
    scale = got["metrics"]["grad_norm"] / mw.CLIP
    leaves = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    top = max(np.abs(g).max() for _, g in leaves)
    checked = 0
    for path, g in leaves:
        name, want = torch_name(tm, tuple(p.key for p in path), g)
        if np.abs(want).max() <= 1e-6 * top:
            continue
        diff = np.abs(got["grads"][name].numpy() * scale - want).max() \
            / np.abs(want).max()
        assert diff <= 3e-2, (name, diff)
        checked += 1
    assert checked > 50


@pytest.mark.parametrize("which", STEPS)
def test_sharded_state_is_sharded(which, request):
    """Each rank holds exactly its block of every fsdp-placed parameter
    (a half under fsdp=2, a quarter where tp shards it too), and the tp
    peers' replicated weights are bit-identical."""
    ranks, _, _, tm = request.getfixturevalue(which)
    axes = dict(fsdp=2, fsdp_min_size=512, **(
        {"tp": 2} if which == "step2" else {}))
    places = tmesh.placements(tm, tmesh.MeshConfig(**axes))
    params = dict(tm.named_parameters())
    full = sum(params[n].nbytes for n, pl in places.items() if "fsdp" in pl)
    mine = sum(params[n].nbytes // (2 * (2 if "tp" in pl else 1))
               for n, pl in places.items() if "fsdp" in pl)
    assert full > 0 and all(rk["fsdp_bytes"] == (mine, full)
                            for rk in ranks)
    assert len({rk["replicated_checksum"] for rk in ranks}) == 1


# ---------------------------------------------------------- checkpoints

CKPT_ARGS = ["--config-name", "unified_tasks_synthetic", *STEP,
             "data.synthetic.num_train=2", "data.synthetic.num_val=2",
             "dataloader.batchsize=2", "dataloader.batchsize_eval=2",
             "solver.epochs_per_eval=1", "solver.epochs_per_save=0",
             "log_every=1"]


def test_checkpoints_cross_the_mesh(tmp_path, monkeypatch):
    """A checkpoint saved under ``fsdp=2, tp=2`` holds the ranks' gathered
    state bit for bit and evaluates in one process as the ranks evaluated
    it; a checkpoint one process saved resumes under the mesh with the
    same weights and AdamW moments bit for bit."""
    try:
        _checkpoint_checks(tmp_path, monkeypatch)
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)


def _checkpoint_checks(tmp_path, monkeypatch):
    from test_torch_train_rng import _state
    monkeypatch.setattr(Query3DTrainer, "install_preemption_handler",
                        lambda self, signals=None: None)
    one = trun.main([*CKPT_ARGS, "solver.epochs=1", "device=cpu",
                     f"exp_dir={tmp_path / 'one'}"])
    saved_by_one = _state(str(tmp_path / "one"), "latest")
    del one
    ranks = mw.spawn("ckpt", tmp_path, *CKPT_ARGS, "solver.epochs=1", n=4)
    saved = _state(str(tmp_path / "mesh"), "latest")
    assert len(set(saved["rank_checksums"])) == 1
    assert {rk["coords"] for rk in ranks} == {
        (0, f, t) for f in (0, 1) for t in (0, 1)}
    assert ranks[0]["modes"] == ["col", "col_local", "row", "row_local"]
    for rk in ranks:
        assert rk["saved"].keys() == saved["model"].keys()
        for k, v in saved["model"].items():
            assert torch.equal(rk["saved"][k], v), k
    # the checkpoint in one process: its weights, evaluated as the ranks
    # evaluated them (each row scored once)
    # (its snapshot names the mesh: one process overrides it)
    trainer = trun.main(["--config-name", "unified_tasks_synthetic",
                         "resume=True", f"exp_dir={tmp_path / 'mesh'}",
                         "device=cpu", "parallel.fsdp=1", "parallel.tp=1"])
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, saved["model"][k]), k
    results = trainer.eval_epoch(0)
    for rk in ranks:
        assert rk["eval"].keys() == results.keys()
        for k, v in results.items():
            assert abs(rk["eval"][k] - v) <= 1e-6 * max(abs(v), 1.0), k
    # a one-process checkpoint resumed under the mesh
    for rk in ranks:
        got = rk["restored"]
        assert got["step"] == saved_by_one["step"]
        for k, v in saved_by_one["model"].items():
            assert torch.equal(got["model"][k], v), k
        want = saved_by_one["optimizer"]["state"]
        assert got["optimizer"].keys() == want.keys()
        for i, st in want.items():
            for k, v in st.items():
                assert torch.equal(got["optimizer"][i][k], v), (i, k)
        assert rk["resumed_step"] > saved_by_one["step"]
