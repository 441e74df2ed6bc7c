"""The port's stage-1 model (pq3d_tpu_torch/models) against the JAX model
with the same weights, moved by utils/weights.load_flax_variables.

Eval mode, random non-trivial BN statistics, and the port's z-run routing
exercised (the row threshold and the z-run-gather predicate lowered, so
the small test levels route); the JAX side runs its gather conv, the same
function.  Tolerance: max|diff| / max|ref| <= 2e-2 (bf16 conv operands
round identically on both sides; f32 sums differ in order).
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pq3d_tpu.data import synthetic
from pq3d_tpu.data.instseg_pipeline import InstSegPipelineConfig, make_batch
from pq3d_tpu.models import query3d as jq3d
from pq3d_tpu.models.sparse_unet import Res16UNet as JRes16UNet
from pq3d_tpu.models.sparse_unet import SparseConv as JSparseConv
from pq3d_tpu.ops import pallas_zt as jpallas
from pq3d_tpu.ops import sparse as jsparse
from pq3d_tpu_torch.models import query3d as tq3d
from pq3d_tpu_torch.models.sparse_unet import Res16UNet as TRes16UNet
from pq3d_tpu_torch.ops import sparse as tsparse
from pq3d_tpu_torch.ops import zrun_conv as tzr
from pq3d_tpu_torch.serve import to_device
from pq3d_tpu_torch.utils.weights import load_flax_variables

torch.set_num_threads(1)
TOL = 2e-2


def _rel(ref, got):
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    return float(np.abs(ref - got).max() / (np.abs(ref).max() + 1e-6))


def _batch(n_scenes=2, seed=0):
    rng = np.random.default_rng(seed)
    pipe = InstSegPipelineConfig(
        voxel_size=0.15, num_queries=8, max_segments=32, max_instances=8,
        voxel_bucket=128, use_aug=False, stem_mode="dense_block",
        level_caps=[512, 256, 128, 128, 128])
    scenes = [synthetic.make_scene(rng, n_points=n, n_instances=3,
                                   n_segments=16)
              for n in (600, 900, 750)[:n_scenes]]
    b = make_batch(scenes, pipe, rng, train=False)
    b.pop("_meta")
    for name in ("mv", "pc"):
        b[f"{name}_seg_fts"] = rng.standard_normal(
            (n_scenes, 32, 16)).astype(np.float32)
        b[f"{name}_seg_pad_masks"] = b["seg_pad_masks"]
    return b


def _random_variables(init_thunk, seed=1):
    """A flax variable tree of numpy arrays with the init's structure:
    fan-in scaled kernels, near-identity norms, and non-trivial BN running
    statistics (eval mode uses them).  Drawn with numpy instead of running
    the flax initializers eagerly, which is the slow part on the CPU."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        coll, name = path[0].key, path[-1].key
        shape = leaf.shape
        if coll == "batch_stats":
            if name == "mean":
                return rng.normal(0, 0.2, shape).astype(np.float32)
            return rng.uniform(0.5, 2.0, shape).astype(np.float32)
        if name == "scale":
            return (1 + rng.normal(0, 0.1, shape)).astype(np.float32)
        if name == "bias":
            return rng.normal(0, 0.02, shape).astype(np.float32)
        fan_in = int(np.prod(shape[:-1])) if name == "kernel" else 1
        return rng.normal(0, fan_in ** -0.5, shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill,
                                            jax.eval_shape(init_thunk))


def _route_small(monkeypatch, min_rows):
    """Let the small test levels route to the z-run conv in the port."""
    monkeypatch.setattr(tzr, "MIN_ROWS", min_rows)
    monkeypatch.setattr(tsparse, "ztriple_applicable", lambda *a: False)


def _spy_routed(monkeypatch, model):
    """Record the names of the port convs that run zrun_conv."""
    names = {id(m.kernel): n for n, m in model.named_modules()
             if hasattr(m, "kernel")}
    routed = []
    orig = tzr.zrun_conv

    def spy(x, w, *a, **k):
        routed.append(names[id(w)])
        return orig(x, w, *a, **k)
    monkeypatch.setattr(tzr, "zrun_conv", spy)
    return routed


def test_res16unet_matches_jax(monkeypatch):
    b = _batch()
    maps_j = jax.tree_util.tree_map(jnp.asarray, b["maps"])
    x = jnp.asarray(b["voxel_feats"])
    jmodel = JRes16UNet()
    variables = _random_variables(
        lambda: jmodel.init(jax.random.key(0), x, maps_j, train=False))
    out_j, fm_j = jax.jit(lambda v: jmodel.apply(v, x, maps_j,
                                                 train=False))(variables)

    _route_small(monkeypatch, 128)
    tmodel = TRes16UNet(pallas_conv=True).eval()
    load_flax_variables(tmodel, variables)
    routed = _spy_routed(monkeypatch, tmodel)
    with torch.inference_mode():
        out_t, fm_t = tmodel(torch.from_numpy(b["voxel_feats"]),
                             to_device(b["maps"], torch.device("cpu")))
    assert "stage8.block0.conv1" in routed and len(routed) >= 8
    assert _rel(out_j, out_t.numpy()) <= TOL
    for lvl, (a, c) in enumerate(zip(fm_j, fm_t)):
        assert _rel(a, c.numpy()) <= TOL, lvl


def test_same_convs_route_in_both_packages(monkeypatch):
    """With both packages' z-run-gather predicates off and the row bound
    at 384 (the JAX interpret-mode bound), the same conv names route: the
    JAX side traced abstractly with a recording stub for its Pallas conv."""
    b = _batch()
    monkeypatch.setenv("PQ3D_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(jsparse, "ztriple_applicable", lambda *a: False)
    calls = []

    def stub(x, w, plan, valid, **kw):
        calls.append(1)
        return jnp.zeros((x.shape[0], w.shape[-1]), x.dtype)
    monkeypatch.setattr(jpallas, "pallas_zt_conv_sym", stub)
    maps_j = jax.tree_util.tree_map(jnp.asarray, b["maps"])
    x = jnp.asarray(b["voxel_feats"])
    jmodel = JRes16UNet(pallas_conv=True)
    variables = jax.eval_shape(
        lambda: jmodel.init(jax.random.key(0), x, maps_j, train=False))
    routed_j = []

    def intercept(next_fun, args, kwargs, context):
        if isinstance(context.module, JSparseConv) \
                and context.method_name == "__call__":
            before = len(calls)
            out = next_fun(*args, **kwargs)
            if len(calls) > before:
                routed_j.append(".".join(context.module.path))
            return out
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(intercept):
        jax.eval_shape(lambda v: jmodel.apply(v, x, maps_j, train=False),
                       variables)

    _route_small(monkeypatch, 384)
    tmodel = TRes16UNet(pallas_conv=True)
    routed_t = _spy_routed(monkeypatch, tmodel)
    with torch.inference_mode():
        tmodel(torch.from_numpy(b["voxel_feats"]),
               to_device(b["maps"], torch.device("cpu")))
    assert routed_j and sorted(set(routed_j)) == sorted(set(routed_t))
    assert len(routed_t) == 8 and all(n.startswith(("stage7", "stage8"))
                                      for n in routed_t)


def _models(num_layers=2, num_blocks=2):
    kw = dict(memories=("voxel", "mv", "pc"), heads=("mask",),
              hidden_size=32, dim_loc=3)
    jm = jq3d.Query3DUnified(
        unified=jq3d.UnifiedEncoderCfg(
            num_layers=num_layers, num_blocks=num_blocks,
            num_attention_heads=4, structure="parallel",
            spatial_selfattn=True, use_self_mask=True),
        mv_enc=jq3d.EncoderCfg(input_feat_size=16),
        pc_enc=jq3d.EncoderCfg(input_feat_size=16),
        voxel_enc=jq3d.VoxelEncoderCfg(hlevels=(0, 1), out_channels=20),
        mask_head_cfg=jq3d.MaskHeadCfg(num_targets=21,
                                       filter_out_classes=(0, 2)), **kw)
    tm = tq3d.Query3DUnified(
        unified=tq3d.UnifiedEncoderCfg(
            num_layers=num_layers, num_blocks=num_blocks,
            num_attention_heads=4, structure="parallel",
            spatial_selfattn=True, use_self_mask=True),
        mv_enc=tq3d.EncoderCfg(16), pc_enc=tq3d.EncoderCfg(16),
        voxel_enc=tq3d.VoxelEncoderCfg(hlevels=(0, 1), out_channels=20,
                                       pallas_conv=True),
        mask_head_cfg=tq3d.MaskHeadCfg(21, (0, 2)), **kw)
    return jm, tm


def test_full_model_matches_jax(monkeypatch):
    b = _batch()
    jm, tm = _models()
    bj = jax.tree_util.tree_map(jnp.asarray, b)
    variables = _random_variables(lambda: jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, bj,
        train=False))
    out_j = jax.jit(lambda v: jm.apply(v, bj, train=False))(variables)

    _route_small(monkeypatch, 128)
    load_flax_variables(tm, variables)
    tm.eval()
    routed = _spy_routed(monkeypatch, tm)
    with torch.inference_mode():
        out_t = tm(to_device(b, torch.device("cpu")))
    assert routed
    n_rounds = len(out_j["predictions_class"])
    assert n_rounds == len(out_t["predictions_class"]) == 2 * 2 + 1
    seg_valid = b["seg_pad_masks"][:, :, None]
    flips = []
    for r in range(n_rounds):
        mj = np.asarray(out_j["predictions_mask"][r])
        mt = out_t["predictions_mask"][r].numpy()
        # the heads' self-mask rule, sigmoid(logit) >= 0.5, on both sides
        aj = (torch.sigmoid(torch.from_numpy(mj)).numpy() >= 0.5) & seg_valid
        at = (torch.sigmoid(torch.from_numpy(mt)).numpy() >= 0.5) & seg_valid
        flips.append(int((aj != at).sum()))
    assert flips == [0] * n_rounds, f"attend bits differing per round: " \
                                    f"{flips}"
    for r in range(n_rounds):
        cj = np.asarray(out_j["predictions_class"][r])
        ct = out_t["predictions_class"][r].numpy()
        keep = np.ones(cj.shape[-1], bool)
        keep[[0, 2]] = False       # filtered classes are -1e9 on both
        assert _rel(cj[..., keep], ct[..., keep]) <= TOL, r
        mj = np.asarray(out_j["predictions_mask"][r])
        mt = out_t["predictions_mask"][r].numpy()
        valid = np.broadcast_to(seg_valid, mj.shape)
        assert _rel(mj[valid], mt[valid]) <= TOL, r


def test_weight_move_consumes_every_leaf():
    b = _batch()
    jm, tm = _models(num_layers=1, num_blocks=1)
    bj = jax.tree_util.tree_map(jnp.asarray, b)
    variables = _random_variables(lambda: jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, bj,
        train=False))
    variables = {c: dict(t) for c, t in variables.items()}
    assert set(variables) == {"params", "batch_stats", "buffers"}
    load_flax_variables(tm, variables)       # raises unless one-to-one
    n_leaves = len(jax.tree_util.tree_leaves(variables))
    n_torch = len(list(tm.parameters())) + len(list(tm.buffers()))
    assert n_leaves == n_torch
    extra = dict(variables)
    extra["params"] = dict(extra["params"], bogus={"kernel": np.zeros(3)})
    with pytest.raises(ValueError, match="bogus"):
        load_flax_variables(tm, extra)
    missing = dict(variables)
    missing["buffers"] = {}
    with pytest.raises(ValueError, match="gauss_B"):
        load_flax_variables(tm, missing)
