"""Stage-1 training in the flat pack with the z-run gather conv, on the CPU.

- The z-run gather conv's scatter-free backward
  (``ops/sparse.sparse_conv_ztriple_sym``): dx and dW against ``jax.grad``
  of JAX's ``sparse_conv_ztriple_sym`` and of its gather conv, f32
  compute, atol 2e-4 (``tests/test_ztriple.py``'s).
- The train-mode ``collate_flat`` batch (augmentation, instance masks,
  labels, z-run plans) bit-identical to JAX's, and ``InstSegLoader``'s
  flat batches the same in process and on a 2-worker spawn pool.
- One flat + z-run train step of a small Query3D against JAX's on the same
  weights and the same numpy batch (f32 conv compute on both sides,
  dropout off, JAX's Pallas paths off): loss within 1e-3 relative, every
  gradient max|diff| / max|ref| <= 1e-3, BN running statistics 1e-3.  The
  port routes the small levels' 96-255-channel convs to kernel B1 (its
  plain version here) and the 32-64-channel ones of levels 1-3 to the
  z-run gather conv.
- In the port, the flat step's loss and gradients equal the rectangular
  step's (direct criterion, no self-mask, f32 compute): loss rtol 1e-5,
  gradients normalised by their maximum atol 1e-4 (JAX's
  ``tests/test_flat_pack.py`` test of the same).
- ``python -m pq3d_tpu_torch.run`` trains 2 steps in flat + z-run, z-run
  alone and flat alone, and in ``dev_maps``, and ``InstSegEval``
  scores flat val batches as it scores rectangular ones.
"""
import functools
import shutil

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pq3d_tpu.data import instseg_pipeline as jpipe
from pq3d_tpu.models import query3d as jq3d
from pq3d_tpu.ops import kernel_maps as jkm
from pq3d_tpu.ops import sparse as jsparse
from pq3d_tpu.optim import losses as jlosses
from pq3d_tpu_torch import run as trun
from pq3d_tpu_torch.data import instseg_pipeline as tpipe
from pq3d_tpu_torch.data.datasets import (InstSegLoader,
                                           _assemble_instseg_batch)
from pq3d_tpu_torch.models import query3d as tq3d
from pq3d_tpu_torch.ops import sparse as tsparse
from pq3d_tpu_torch.ops import zrun_conv as tzr
from pq3d_tpu_torch.optim import losses as tlosses
from pq3d_tpu_torch.serve import to_device
from pq3d_tpu_torch.utils.weights import load_flax_variables, torch_name

from test_torch_flat_pack import _scenes
from test_torch_model import _random_variables
from test_torch_pipeline import _assert_same
from test_torch_trainer import TINY, _jax_assignment, _rel

torch.set_num_threads(1)
KW = dict(voxel_size=0.15, num_queries=8, max_segments=32, max_instances=8,
          voxel_bucket=128, stem_mode="dense_block")
FLAT_ZT = ("data.instseg_options.flat_pack=true",
           "data.instseg_options.ztriple_conv=true")


def test_ztriple_sym_grads_match_jax():
    rng = np.random.default_rng(1)
    coords = np.unique(rng.integers(0, 24, (700, 3)), axis=0).astype(
        np.int32)
    h = jkm.build_hierarchy(coords, bucket=256)
    p = h.pad_sizes[1]
    valid = np.asarray(h.valid[1])
    x = (rng.standard_normal((p, 8)) * valid[:, None]).astype(np.float32)
    w = rng.standard_normal((27, 8, 12)).astype(np.float32)
    g = rng.standard_normal((p, 12)).astype(np.float32)
    nbr = h.nbr3[1]
    zb, zc = jkm.build_ztriple_plan(nbr, n_pad=p)

    def jgrads(conv):
        return jax.grad(lambda x, w: jnp.sum(conv(x, w) * g),
                        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    ref_zt = jgrads(lambda x, w: jsparse.sparse_conv_ztriple_sym(
        x, jnp.asarray(zb), jnp.asarray(zc), w, jnp.asarray(valid),
        compute_dtype=jnp.float32))
    ref_gather = jgrads(lambda x, w: jsparse.sparse_conv(
        x, jnp.asarray(nbr), w, None, jnp.asarray(valid),
        compute_dtype=jnp.float32))

    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    orig = tsparse._round
    tsparse._round = lambda t, dtype: t.float()
    try:
        y = tsparse.sparse_conv_ztriple_sym(
            tx, torch.from_numpy(zb), torch.from_numpy(zc), tw,
            torch.from_numpy(valid))
        y.backward(torch.from_numpy(g))
    finally:
        tsparse._round = orig
    for ref in (ref_zt, ref_gather):
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(ref[0]),
                                   rtol=0, atol=2e-4)
        np.testing.assert_allclose(tw.grad.numpy(), np.asarray(ref[1]),
                                   rtol=0, atol=2e-4)


def test_ztriple_sym_bf16_backward_is_the_plain_one():
    """In bf16 the Function's dx is the z-run conv of the masked dy with
    flip_k(W)^T and its dW the re-gather, both bit for bit."""
    rng = np.random.default_rng(2)
    coords = np.unique(rng.integers(0, 20, (600, 3)), axis=0).astype(
        np.int32)
    h = jkm.build_hierarchy(coords, bucket=128)
    nbr = torch.from_numpy(h.nbr3[0])
    valid = torch.from_numpy(np.asarray(h.valid[0]))
    zb, zc = tzr.zrun_plan(nbr)
    n = nbr.shape[0]
    x = torch.randn(n, 16, generator=torch.Generator().manual_seed(0))
    w = torch.randn(27, 16, 24, generator=torch.Generator().manual_seed(1))
    dy = torch.randn(n, 24, generator=torch.Generator().manual_seed(2))
    xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    tsparse.sparse_conv_ztriple_sym(xg, zb, zc, wg, valid).backward(dy)
    dym = torch.where(valid[:, None], dy, 0)
    dx, dw = tzr.zrun_conv_backward_reference(x, w, zb, zc, valid, dy)
    assert torch.equal(xg.grad, dx) and torch.equal(wg.grad, dw)
    assert torch.equal(dw, tsparse.ztriple_weight_grad(x, zb, zc, dym))


def _train_batches(seed=4, sizes=(700, 900, 800), **kw):
    scenes = _scenes(seed, sizes)
    opts = dict(KW, use_aug=True, flat_pack=True, ztriple_conv=True, **kw)
    bj = jpipe.make_batch([dict(s) for s in scenes],
                          jpipe.InstSegPipelineConfig(**opts),
                          np.random.default_rng(seed), train=True)
    bt = tpipe.make_batch([dict(s) for s in scenes],
                          tpipe.InstSegPipelineConfig(**opts),
                          np.random.default_rng(seed), train=True)
    return bj, bt


def test_train_collate_flat_bit_identical():
    bj, bt = _train_batches()
    assert bt["maps"]["valid_0"].ndim == 1 and "zt1_base" in bt["maps"]
    assert bt["_meta"]["full_instance_masks"] == [None] * 3
    _assert_same(bj, bt)


class _Scenes:
    """A dataset of fixed synthetic scenes (picklable for the pool)."""

    def __init__(self, scenes):
        self.scenes = scenes

    def __len__(self):
        return len(self.scenes)

    def get_scene(self, i):
        return dict(self.scenes[i])


def test_flat_loader_in_process_equals_pool():
    """A 2-worker spawn pool's flat train batches against the worker's
    function called in process with the same seeds: every array, the side
    arrays and ``_meta['flat_dims']`` through the pool's mapped files."""
    ds = _Scenes(_scenes(6, (600, 700, 800, 650)))
    cfg = tpipe.InstSegPipelineConfig(**KW, flat_pack=True,
                                      ztriple_conv=True)
    extra = {"mv": 16, "pc": 16}
    loader = InstSegLoader(ds, cfg, 2, True, seed=3, extra_features=extra,
                           num_workers=2)
    idxs, n_real, _ = loader._batch_indices(1)
    local = [_assemble_instseg_batch(
        ds, cfg, extra, ix, np.random.default_rng(
            np.random.SeedSequence([3, 1, b])), True)
        for b, ix in enumerate(idxs)]
    for batch, nr in zip(local, n_real):
        batch["_meta"]["n_real"] = nr
    try:
        pooled = list(loader(1))
    finally:
        loader.close()
    assert len(local) == len(pooled) == 2
    for a, b in zip(local, pooled):
        for name in ("voxel_scene", "anc_local", "rect_1", "zt2_code"):
            assert name in b["maps"]
        assert set(b["_meta"]["flat_dims"]) >= {"tot_0", "rect_0",
                                                "stem_nb"}
        _assert_same(a, b)


def _models(use_self_mask=True):
    kw = dict(memories=("voxel", "mv", "pc"), heads=("mask",),
              hidden_size=32, dim_loc=3)
    unified = dict(num_layers=1, num_blocks=2, num_attention_heads=4,
                   structure="parallel", spatial_selfattn=True,
                   use_self_mask=use_self_mask)
    jm = jq3d.Query3DUnified(
        unified=jq3d.UnifiedEncoderCfg(**unified),
        mv_enc=jq3d.EncoderCfg(input_feat_size=16, dropout=0.0),
        pc_enc=jq3d.EncoderCfg(input_feat_size=16, dropout=0.0),
        voxel_enc=jq3d.VoxelEncoderCfg(hlevels=(0, 1), out_channels=20,
                                       dropout=0.0, remat_policy="none",
                                       grad_mode="scatter_free"),
        mask_head_cfg=jq3d.MaskHeadCfg(num_targets=21,
                                       filter_out_classes=(0, 2)), **kw)
    tm = tq3d.Query3DUnified(
        unified=tq3d.UnifiedEncoderCfg(**unified),
        mv_enc=tq3d.EncoderCfg(16, dropout=0.0),
        pc_enc=tq3d.EncoderCfg(16, dropout=0.0),
        voxel_enc=tq3d.VoxelEncoderCfg(hlevels=(0, 1), out_channels=20,
                                       dropout=0.0, pallas_conv=True),
        mask_head_cfg=tq3d.MaskHeadCfg(21, (0, 2)), **kw)
    for m in tm.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return jm, tm


def _with_features(b):
    b = {k: v for k, v in b.items() if not k.startswith("_")}
    rng = np.random.default_rng(9)
    n = b["seg_pad_masks"].shape[0]
    for name in ("mv", "pc"):
        b[f"{name}_seg_fts"] = rng.standard_normal((n, 32, 16)).astype(
            np.float32)
        b[f"{name}_seg_pad_masks"] = b["seg_pad_masks"]
    b["instance_labels"] = (b["instance_labels"] % 17 + 3).astype(np.int32)
    return b


def _f32_convs(monkeypatch):
    """Every sparse conv of both packages in f32 compute (see
    test_torch_trainer.py for why)."""
    for fn in ("sparse_conv_sym", "sparse_conv_down",
               "sparse_conv_transpose_gf", "conv0_dense_block",
               "sparse_conv_ztriple_sym"):
        monkeypatch.setattr(jsparse, fn, functools.partial(
            getattr(jsparse, fn), compute_dtype=jnp.float32))
    monkeypatch.setattr(tsparse, "_round", lambda t, dtype: t.float())


def _route(monkeypatch):
    """Kernel B1 (its plain version) on the 96-255-channel convs of the
    small levels, the z-run gather conv on the <= 64-channel ones of levels
    1-3 (the split the full-size levels make)."""
    monkeypatch.setattr(tzr, "MIN_ROWS", 128)
    monkeypatch.setattr(tsparse, "ztriple_applicable",
                        lambda n, cin, cout: max(cin, cout) <= 64)


def test_flat_zt_train_step_matches_jax(monkeypatch):
    bj_np, _ = _train_batches()
    b = _with_features(bj_np)
    jm, tm = _models()
    bj = jax.tree_util.tree_map(jnp.asarray, b)
    variables = _random_variables(lambda: jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, bj,
        train=False))
    cfg_j = jlosses.InstSegLossConfig(num_classes=20)
    cfg_t = tlosses.InstSegLossConfig(num_classes=20)
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)
    _f32_convs(monkeypatch)

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

    _route(monkeypatch)
    load_flax_variables(tm, variables)
    tm.train()
    routed = {"b1": 0, "ztriple": 0}
    sym, zsym = tzr.zrun_conv_sym, tsparse.sparse_conv_ztriple_sym
    monkeypatch.setattr(tzr, "zrun_conv_sym", lambda *a, **k: (
        routed.__setitem__("b1", routed["b1"] + 1) or sym(*a, **k)))
    monkeypatch.setattr(tsparse, "sparse_conv_ztriple_sym", lambda *a, **k: (
        routed.__setitem__("ztriple", routed["ztriple"] + 1)
        or zsym(*a, **k)))
    bt = to_device(b, torch.device("cpu"))
    out_t = tm(bt)
    total_t, _ = tlosses.instseg_set_loss(
        out_t["predictions_class"], out_t["predictions_mask"], bt, cfg_t)
    total_t.backward()
    assert routed["b1"] > 0 and routed["ztriple"] > 0, routed

    # the assignment may differ only among identical round-0 queries
    costs_t = tlosses.round_costs(
        out_t["predictions_class"], out_t["predictions_mask"], bt,
        cfg_t).numpy()
    col_t = tlosses.assign(costs_t)
    col_j = _jax_assignment(out_j, bj, cfg_j)
    for r in range(col_t.shape[0]):
        for i in range(col_t.shape[1]):
            v = b["instance_valid"][i]
            if not np.array_equal(col_t[r, i, v], col_j[r, i, v]):
                c = costs_t[r, i][v]
                assert r == 0 and np.array_equal(c[:, col_t[r, i, v]],
                                                 c[:, col_j[r, i, v]])
    assert abs(total_t.item() - float(total_j)) <= 1e-3 * abs(float(total_j))

    tparams = dict(tm.named_parameters())
    floor = 1e-6 * max(float(np.abs(np.asarray(g)).max())
                       for g in jax.tree_util.tree_leaves(grads_j))
    checked = 0
    for path, g in jax.tree_util.tree_flatten_with_path(grads_j)[0]:
        name, ref = torch_name(tm, tuple(p.key for p in path), np.asarray(g))
        got = tparams[name].grad
        if not np.abs(ref).max() > floor:
            assert got is None or np.abs(got.numpy()).max() <= floor, name
            continue
        assert _rel(ref, got.numpy()) <= 1e-3, (name, _rel(ref, got.numpy()))
        checked += 1
    assert checked > 100
    for path, v in jax.tree_util.tree_flatten_with_path(stats_j)[0]:
        name, ref = torch_name(tm, tuple(p.key for p in path), np.asarray(v))
        np.testing.assert_allclose(dict(tm.named_buffers())[name].numpy(),
                                   ref, rtol=1e-3, atol=1e-3, err_msg=name)


def test_flat_gradients_match_rectangular(monkeypatch):
    scenes = _scenes(2, (700, 1000))
    opts = dict(KW, use_aug=False)
    br = tpipe.make_batch([dict(s) for s in scenes],
                          tpipe.InstSegPipelineConfig(**opts),
                          np.random.default_rng(1), train=True)
    bf = tpipe.make_batch([dict(s) for s in scenes],
                          tpipe.InstSegPipelineConfig(
                              **opts, flat_pack=True, ztriple_conv=True),
                          np.random.default_rng(1), train=True)
    jm, tm = _models(use_self_mask=False)
    variables = _random_variables(lambda: jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        jax.tree_util.tree_map(jnp.asarray, _with_features(br)),
        train=False))
    _f32_convs(monkeypatch)
    _route(monkeypatch)
    load_flax_variables(tm, variables)
    state = {k: v.clone() for k, v in tm.state_dict().items()}
    results = []
    for b in (br, bf):
        tm.load_state_dict(state)
        tm.train()
        tm.zero_grad(set_to_none=True)
        bt = to_device(_with_features(b), torch.device("cpu"))
        out = tm(bt)
        total, _ = tlosses.instseg_direct_loss(
            out["predictions_class"], out["predictions_mask"], bt)
        total.backward()
        results.append((total.item(), {n: p.grad.clone() for n, p in
                                       tm.named_parameters()
                                       if p.grad is not None}))
    (lr, gr), (lf, gf) = results
    assert bf["maps"]["valid_0"].shape[0] < np.prod(
        br["maps"]["valid_0"].shape)
    np.testing.assert_allclose(lf, lr, rtol=1e-5)
    assert set(gr) == set(gf) and len(gr) > 100
    # below 1e-6 of the largest gradient is f32 noise on an exact zero (the
    # spatial self-attention's key bias: softmax cancels it)
    floor = 1e-6 * max(g.abs().max().item() for g in gr.values())
    for n in gr:
        if not gr[n].abs().max().item() > floor:
            assert gf[n].abs().max().item() <= 2 * floor, n
            continue
        scale = gr[n].abs().max().item() + 1e-6
        np.testing.assert_allclose(gf[n].numpy() / scale,
                                   gr[n].numpy() / scale, atol=1e-4,
                                   err_msg=n)


def _tiny(tmp_path, name, *extra):
    return ["--config-name", "instseg_sceneverse", *TINY,
            "model.voxel_encoder.args.pallas_conv=true", "solver.epochs=2",
            "solver.epochs_per_eval=0", "solver.epochs_per_save=0",
            f"exp_dir={tmp_path / name}", *extra]


@pytest.mark.parametrize("layout", ["flat_zt", "zt", "flat"])
def test_run_trains_in_each_layout(tmp_path, monkeypatch, layout):
    from pq3d_tpu_torch.train.trainer import Query3DTrainer
    monkeypatch.setattr(Query3DTrainer, "install_preemption_handler",
                        lambda self, signals=None: None)
    extra = {"flat_zt": FLAT_ZT, "zt": FLAT_ZT[1:], "flat": FLAT_ZT[:1]}
    pipe_seen = []
    orig = Query3DTrainer.train_batch

    def spy(self, batch):
        pipe_seen.append((batch["maps"]["valid_0"].ndim,
                          "zt1_base" in batch["maps"]))
        return orig(self, batch)
    monkeypatch.setattr(Query3DTrainer, "train_batch", spy)
    trainer = trun.main(_tiny(tmp_path, layout, *extra[layout]))
    # a stage-1 snapshot of the tiny config is about 0.46 GB
    shutil.rmtree(tmp_path / layout)
    assert trainer.step == 2 and trainer.tracker.epoch == 2
    want = (1 if "flat" in layout else 2, "zt" in layout)
    assert pipe_seen == [want, want]
    assert all(torch.isfinite(p).all() for p in trainer.model.parameters())


def test_run_refuses_device_maps(tmp_path, monkeypatch):
    """``device_maps`` was refused until the port trained it; ``run.py``
    now trains the ``dev_maps`` layout (2 steps, maps built in the
    forward; tests/test_torch_device_train*.py hold the step to JAX's)."""
    from test_torch_device_train import run_layout
    run_layout(tmp_path, monkeypatch, "dev_maps", epochs=2)


def test_instseg_eval_on_flat_val_batches(tmp_path):
    """The same model (same seed, before any step) evaluated on the val
    split in the flat + z-run layout and in the rectangular one: the
    evaluator reads equal per-scene arrays, logits within 1e-4 of the
    largest (the flat forward is the rectangular one with rows arranged
    otherwise), and the AP dicts are equal."""
    results, seen = [], []
    for name, extra in (("rect", ()), ("flat", FLAT_ZT)):
        cfg = trun.load_config("instseg_sceneverse", _tiny(
            tmp_path, name, *extra)[2:])
        trainer = trun.build_instseg_trainer(cfg)
        calls = []
        update = trainer.evaluator.update
        trainer.evaluator.update = lambda out, batch: (
            calls.append((out, batch)) or update(out, batch))
        results.append(trainer.eval_epoch(0))
        seen.append(calls)
    assert results[0] == results[1]
    (rect,), (flat,) = seen
    assert flat[1]["voxel_feats"].ndim == 2
    for key in ("seg_pad_masks", "segment_masks", "instance_labels",
                "instance_valid", "segment_sizes"):
        np.testing.assert_array_equal(rect[1][key], flat[1][key])
    for key in ("predictions_class", "predictions_mask"):
        for a, c in zip(rect[0][key], flat[0][key]):
            assert _rel(a, c) <= 1e-4, key
