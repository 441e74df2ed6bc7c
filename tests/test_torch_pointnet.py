"""The port's PointNet++ (pq3d_tpu_torch/models/pointnet.py) and its
``ObjectEncoder(backbone="pointnet++")`` against the JAX modules with the
same weights, moved one-to-one by utils/weights.load_flax_variables, on the
same seeded clouds: max|diff| / max|ref| <= 1e-5.  BatchNorm runs with
random non-trivial running statistics in eval mode, and with batch
statistics (and the running-statistics update) in train mode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pq3d_tpu.models.encoders import ObjectEncoder as JObjectEncoder
from pq3d_tpu.models.pointnet import PointnetSAModuleMSG as JMSG
from pq3d_tpu.models.pointnet import PointNetPP as JPointNetPP
from pq3d_tpu_torch.models.encoders import ObjectEncoder as TObjectEncoder
from pq3d_tpu_torch.models.pointnet import PointnetSAModuleMSG as TMSG
from pq3d_tpu_torch.models.pointnet import PointNetPP as TPointNetPP
from pq3d_tpu_torch.utils.weights import load_flax_variables

torch.set_num_threads(1)
TOL = 1e-5
SMALL = dict(sa_n_points=(16, 8, None), sa_n_samples=(8, 8, 8),
             sa_mlps=((16, 16, 32), (32, 32, 48), (48, 64, 96)))


def _rel(ref, got):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert ref.shape == got.shape
    return float(np.abs(ref - got).max() / np.abs(ref).max())


def random_variables(shapes, seed):
    """A flax variable tree of numpy arrays with ``shapes``' structure:
    fan-in scaled kernels, near-identity norms, non-trivial BN running
    statistics."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        coll, name = path[0].key, path[-1].key
        shape = leaf.shape
        if coll == "batch_stats":
            if name == "mean":
                return rng.normal(0, 0.2, shape).astype(np.float32)
            return rng.uniform(0.5, 2.0, shape).astype(np.float32)
        if name in ("scale", "weight"):
            return (1 + rng.normal(0, 0.1, shape)).astype(np.float32)
        if name == "bias":
            return rng.normal(0, 0.02, shape).astype(np.float32)
        fan_in = int(np.prod(shape[:-1])) if name == "kernel" else 1
        return rng.normal(0, fan_in ** -0.5, shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _clouds(b, p, seed):
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.random((b, p, 3)) * 0.8 - 0.4,
                          rng.random((b, p, 3)) * 2 - 1], -1)
    return pts.astype(np.float32)


def _pair(jmod, tmod, x, seed):
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.key(0), x))
    variables = random_variables(shapes, seed)
    load_flax_variables(tmod, variables)
    return variables


def test_pointnetpp_eval_and_train():
    pts = _clouds(5, 48, 0)
    jm = JPointNetPP(**SMALL)
    tm = TPointNetPP(in_feats=3, **SMALL)
    variables = _pair(jm, tm, jnp.asarray(pts), 1)
    ref = jax.jit(jm.apply)(variables, jnp.asarray(pts))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(pts))
    assert _rel(ref, got.numpy()) <= TOL
    # train mode: batch statistics, and the running statistics they move
    ref, upd = jax.jit(lambda v, x: jm.apply(
        v, x, deterministic=False, mutable=["batch_stats"]))(
            variables, jnp.asarray(pts))
    with torch.no_grad():
        got = tm.train()(torch.from_numpy(pts))
    assert _rel(ref, got.numpy()) <= TOL
    stats = upd["batch_stats"]["sa1"]["mlp"]["bn2"]
    assert _rel(stats["mean"], tm.sa1.mlp.bn2.running_mean.numpy()) <= TOL
    assert _rel(stats["var"], tm.sa1.mlp.bn2.running_var.numpy()) <= TOL


def test_sa_module_msg():
    pts = _clouds(3, 40, 2)
    xyz, feats = pts[..., :3], pts[..., 3:]
    kw = dict(mlps=((8, 16), (8, 24)), npoint=10, radii=(0.2, 0.4),
              nsamples=(6, 12))
    jm = JMSG(**kw)
    tm = TMSG(in_feats=3, **kw)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.asarray(xyz), jnp.asarray(feats)))
    variables = random_variables(shapes, 3)
    load_flax_variables(tm, variables)
    c_ref, f_ref = jax.jit(jm.apply)(variables, jnp.asarray(xyz),
                                     jnp.asarray(feats))
    with torch.no_grad():
        c_got, f_got = tm.eval()(torch.from_numpy(xyz),
                                 torch.from_numpy(feats))
    np.testing.assert_array_equal(c_got.numpy(), np.asarray(c_ref))
    assert _rel(f_ref, f_got.numpy()) <= TOL
    with pytest.raises(ValueError, match="disagree"):
        TMSG(in_feats=3, mlps=((8,),), radii=(0.2, 0.4), nsamples=(4, 8))


def test_object_encoder_frozen_pointnet():
    """The full-width backbone (768 out) behind the projection, frozen:
    BN in eval mode even in a model in train mode, no gradient into it."""
    b, o, p = 2, 3, 64
    pts = _clouds(b * o, p, 4).reshape(b, o, p, 6)
    jm = JObjectEncoder(hidden_size=32, input_feat_size=768,
                        backbone="pointnet++", freeze_backbone=True,
                        dropout=0.0)
    tm = TObjectEncoder(768, 32, dropout=0.0, backbone="pointnet++",
                        freeze_backbone=True)
    assert tm.input_feat_proj.in_features == 768
    variables = _pair(jm, tm, jnp.asarray(pts), 5)
    ref = jax.jit(jm.apply)(variables, jnp.asarray(pts))
    got = tm.eval()(torch.from_numpy(pts))
    assert _rel(ref, got.detach().numpy()) <= TOL
    tm.train()
    assert not tm.backbone.training and tm.input_feat_proj.training
    mean0 = tm.backbone.sa0.mlp.bn0.running_mean.clone()
    out = tm(torch.from_numpy(pts))
    assert _rel(ref, out.detach().numpy()) <= TOL   # dropout 0: same
    out.sum().backward()
    assert tm.backbone.sa0.mlp.dense0.weight.grad is None
    assert tm.input_feat_proj.weight.grad is not None
    assert torch.equal(mean0, tm.backbone.sa0.mlp.bn0.running_mean)
