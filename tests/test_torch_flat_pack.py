"""The flat pack and the z-run gather conv in the port, on the CPU:
``collate_flat`` bit-identical to the JAX package's (with the z-run plans,
with and without the shape lock) and its lock helper equal; the port's
``sparse_conv_ztriple`` against JAX's within 1e-5 relative (bf16 and f32
operands) and against the port's gather conv; a small Query3D in the
``flat_zt`` layout against JAX's same layout (max|diff| / max|ref| <=
2e-2, the port's model tolerance) and against the port's rectangular
forward on each scene (<= 1e-4: the same function, rows arranged
otherwise); the U-Net's kernel routing on flat levels; ``InstSegServer``
serving the flat pack (its lock) and preprocessing on a 2-worker spawn
pool, whose batches equal in-process ``process_scene`` with the same
seeds."""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pq3d_tpu.data import instseg_pipeline as jpipe
from pq3d_tpu.data import synthetic as jsyn
from pq3d_tpu.models.sparse_unet import Res16UNet as JRes16UNet
from pq3d_tpu.ops import sparse as jsparse
from pq3d_tpu_torch.data import instseg_pipeline as tpipe
from pq3d_tpu_torch.models.sparse_unet import Res16UNet as TRes16UNet
from pq3d_tpu_torch.ops import kernel_maps as tkm
from pq3d_tpu_torch.ops import voxelize as tvox
from pq3d_tpu_torch.ops import sparse as tsparse
from pq3d_tpu_torch.serve import InstSegServer, to_device
from pq3d_tpu_torch.utils.weights import load_flax_variables

from test_torch_model import (TOL, _models, _random_variables, _rel,
                              _route_small, _spy_routed)
from test_torch_pipeline import _assert_same

torch.set_num_threads(1)
CPU = torch.device("cpu")
KW = dict(voxel_size=0.15, num_queries=8, max_segments=32, max_instances=8,
          voxel_bucket=256, use_aug=False, stem_mode="dense_block")


def _scenes(seed, sizes=(700, 900, 800)):
    rng = np.random.default_rng(seed)
    scenes = [jsyn.make_scene(rng, n_points=n, n_instances=4, n_segments=20)
              for n in sizes]
    for s in scenes:
        s["inst_labels"] = np.minimum(s["inst_labels"], 19)
    return scenes


def _batches(seed=0, sizes=(700, 900, 800), **kw):
    """(JAX, port) make_batch of the same scenes under the same options."""
    scenes = _scenes(seed, sizes)
    bj = jpipe.make_batch([dict(s) for s in scenes],
                          jpipe.InstSegPipelineConfig(**KW, **kw),
                          np.random.default_rng(seed), train=False)
    bt = tpipe.make_batch([dict(s) for s in scenes],
                          tpipe.InstSegPipelineConfig(**KW, **kw),
                          np.random.default_rng(seed))
    return bj, bt


@pytest.mark.parametrize("ztriple", [False, True])
@pytest.mark.parametrize("locked", [False, True])
def test_collate_flat_bit_identical(ztriple, locked):
    caps = None
    if locked:
        rep = tpipe.make_batch(_scenes(5, (1000, 1100, 900)),
                               tpipe.InstSegPipelineConfig(flat_pack=True,
                                                           **KW),
                               np.random.default_rng(5))
        caps = tpipe.flat_shape_caps_from(rep["_meta"]["flat_dims"],
                                          tpipe.InstSegPipelineConfig(**KW))
        assert caps == jpipe.flat_shape_caps_from(
            rep["_meta"]["flat_dims"], jpipe.InstSegPipelineConfig(**KW))
    bj, bt = _batches(flat_pack=True, ztriple_conv=ztriple,
                      flat_shape_caps=caps)
    assert bt["maps"]["valid_0"].ndim == 1
    assert ("zt1_base" in bt["maps"]) == ztriple
    if locked:
        assert bt["maps"]["valid_0"].shape[0] == caps["tot_0"]
    _assert_same(bj, bt)


def test_flat_lock_overflow_takes_bucketed_size():
    cfg = tpipe.InstSegPipelineConfig(flat_pack=True, **KW)
    small = tpipe.make_batch(_scenes(1, (300, 400)), cfg,
                             np.random.default_rng(1))
    caps = tpipe.flat_shape_caps_from(small["_meta"]["flat_dims"], cfg,
                                      margin=1.0)
    locked = dataclasses.replace(cfg, flat_shape_caps=caps)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        big = tpipe.make_batch(_scenes(2, (2500, 2500)), locked,
                               np.random.default_rng(2))
    assert any("overflows its shape cap" in str(x.message) for x in w)
    assert big["maps"]["valid_0"].shape[0] == \
        big["_meta"]["flat_dims"]["tot_0"] > locked.flat_shape_caps["tot_0"]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_sparse_conv_ztriple_matches_jax(dtype):
    h = tkm.build_hierarchy(tvox.quantize(
        _scenes(3, (3000,))[0]["points"], 0.05)[0], bucket=256)
    nbr = h.nbr3[0]
    zb, zc = tkm.build_ztriple_plan(nbr)
    rng = np.random.default_rng(0)
    n = nbr.shape[0]
    x = rng.standard_normal((n, 24)).astype(np.float32)
    x[~h.valid[0]] = 0
    w = rng.standard_normal((27, 24, 40)).astype(np.float32) * 0.2
    valid = h.valid[0]
    ref = np.asarray(jsparse.sparse_conv_ztriple(
        jnp.asarray(x), jnp.asarray(zb), jnp.asarray(zc), jnp.asarray(w),
        jnp.asarray(valid), compute_dtype=getattr(jnp, dtype)))
    t = [torch.from_numpy(a) for a in (x, zb, zc, w, valid)]
    got = tsparse.sparse_conv_ztriple(t[0], t[1], t[2], t[3], t[4],
                                      compute_dtype=getattr(torch, dtype))
    assert _rel(ref, got.numpy()) <= 1e-5
    gather = tsparse.sparse_conv(t[0], torch.from_numpy(nbr), t[3], None,
                                 t[4], compute_dtype=getattr(torch, dtype))
    assert _rel(gather.numpy(), got.numpy()) <= 1e-5


def _with_features(b, n):
    b = {k: v for k, v in b.items() if k != "_meta"}
    rng = np.random.default_rng(9)
    for name in ("mv", "pc"):
        b[f"{name}_seg_fts"] = rng.standard_normal((n, 32, 16)).astype(
            np.float32)
        b[f"{name}_seg_pad_masks"] = b["seg_pad_masks"]
    return b


def test_flat_zt_forward_matches_jax_and_rect(monkeypatch):
    """flat_zt on both sides (the z-run gather conv takes the C <= 64
    convs of levels 1-3, the rest gather), and the port's flat forward
    against its rectangular one on the same scenes and queries."""
    bj, bt = _batches(flat_pack=True, ztriple_conv=True)
    _, br = _batches(level_caps=(512, 256, 128, 64, 64))
    bj, bt, br = (_with_features(b, 3) for b in (bj, bt, br))
    jm, tm = _models(num_layers=1, num_blocks=1)
    variables = _random_variables(lambda: jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        jax.tree_util.tree_map(jnp.asarray, bj), train=False))
    out_j = jax.jit(lambda v, b: jm.apply(v, b, train=False))(
        variables, jax.tree_util.tree_map(jnp.asarray, bj))
    load_flax_variables(tm, variables)
    tm.eval()
    calls = []
    orig = tsparse.sparse_conv_ztriple

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)
    monkeypatch.setattr(tsparse, "sparse_conv_ztriple", spy)
    with torch.inference_mode():
        out_t = tm(to_device(bt, CPU))
        assert calls
        out_r = tm(to_device(br, CPU))
    seg_valid = bt["seg_pad_masks"][:, :, None]
    for r in range(len(out_j["predictions_class"])):
        mj = np.asarray(out_j["predictions_mask"][r])
        valid = np.broadcast_to(seg_valid, mj.shape)
        assert _rel(np.asarray(out_j["predictions_class"][r])[..., 3:],
                    out_t["predictions_class"][r].numpy()[..., 3:]) <= TOL
        assert _rel(mj[valid], out_t["predictions_mask"][r].numpy()[valid]) \
            <= TOL
        for i in range(3):      # each real scene
            for key in ("predictions_class", "predictions_mask"):
                assert _rel(out_r[key][r][i].numpy(),
                            out_t[key][r][i].numpy()) <= 1e-4, (key, r, i)


def test_res16unet_flat_routes_b1_on_flat_levels(monkeypatch):
    """With the row bound lowered and the z-run gather predicate off, the
    kernel's plain version takes the decoder's 96-channel convs on the flat
    levels; the U-Net matches JAX's flat gather U-Net."""
    bj, bt = _batches(flat_pack=True)
    maps_j = jax.tree_util.tree_map(jnp.asarray, bj["maps"])
    x = jnp.asarray(bj["voxel_feats"])
    jmodel = JRes16UNet()
    variables = _random_variables(
        lambda: jmodel.init(jax.random.key(0), x, maps_j, train=False))
    out_j, fm_j = jax.jit(lambda v: jmodel.apply(v, x, maps_j,
                                                 train=False))(variables)
    _route_small(monkeypatch, 256)
    tmodel = TRes16UNet(pallas_conv=True).eval()
    load_flax_variables(tmodel, variables)
    routed = _spy_routed(monkeypatch, tmodel)
    rows = [bt["maps"][f"valid_{l}"].shape[0] for l in range(5)]
    with torch.inference_mode():
        out_t, fm_t = tmodel(torch.from_numpy(bt["voxel_feats"]),
                             to_device(bt["maps"], CPU))
    assert routed and len(routed) == len(tmodel.routed_convs(rows))
    assert out_t.shape == (1, rows[0], 200)
    assert _rel(out_j, out_t.numpy()) <= TOL
    for a, c in zip(fm_j, fm_t):
        assert _rel(a, c.numpy()) <= TOL


class _Recording(InstSegServer):
    """Keeps the batches it collated (before the device copy)."""

    def __init__(self, *a, **k):
        self.batches = []
        super().__init__(*a, **k)

    def _forward(self, batch):
        self.batches.append({k: (v.numpy() if not isinstance(v, dict) else
                                 {kk: vv.numpy() for kk, vv in v.items()})
                             for k, v in batch.items()})
        return super()._forward(batch)


def _serve(pipe, scenes, **kw):
    _, tm = _models(num_layers=1, num_blocks=1)
    from pq3d_tpu_torch.models.query3d import init_weights
    init_weights(tm, torch.Generator().manual_seed(0))
    srv = _Recording(tm.eval(), pipe, batch_size=2, num_classes=20, topk=10,
                     max_delay_s=10.0, extra_features={"mv": 16, "pc": 16},
                     device="cpu", **kw)
    try:
        results = [f.result(timeout=600)
                   for f in [srv.submit(dict(s)) for s in scenes]]
    finally:
        srv.close()
    return srv, results


def test_server_flat_pack_sets_its_lock():
    pipe = tpipe.InstSegPipelineConfig(flat_pack=True, ztriple_conv=True,
                                       **KW)
    scenes = _scenes(4, (900, 700, 600, 800))
    srv, results = _serve(pipe, scenes)
    assert srv.stats.summary()["scenes"] == 4 and len(srv.batches) == 2
    caps = srv.pipe_cfg.flat_shape_caps
    assert caps and caps["tot_0"] >= srv.batches[0]["maps"]["valid_0"].size
    assert srv.batches[1]["maps"]["valid_0"].size == caps["tot_0"]
    for s, preds in zip(scenes, results):
        for p in preds:
            assert p["mask"].shape == (len(s["points"]),)


def test_server_pool_matches_in_process_seeds():
    """num_workers=2: each scene is preprocessed in a spawned worker with
    seed = its running count; the served batches equal collating
    in-process process_scene with default_rng(SeedSequence(seed))."""
    pipe = tpipe.InstSegPipelineConfig(level_caps=(512, 256, 128, 64, 64),
                                       **KW)
    scenes = _scenes(6, (700, 900, 800, 650))
    srv, results = _serve(pipe, scenes, num_workers=2)
    assert len(results) == 4 and len(srv.batches) == 2
    for k, batch in enumerate(srv.batches):
        procs = [tpipe.process_scene(
            dict(s), pipe, np.random.default_rng(np.random.SeedSequence(i)))
            for i, s in enumerate(scenes[2 * k:2 * k + 2], start=2 * k)]
        want = tpipe.collate_processed(procs, pipe)
        want.pop("_meta")
        got = {k2: v for k2, v in batch.items()
               if not k2.startswith(("mv_", "pc_"))}
        _assert_same(want, got)
