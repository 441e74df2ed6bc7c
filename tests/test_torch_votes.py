"""The VoteNet set-abstraction modules (``PointnetSAModuleVotes``,
``PointnetSAModuleMSGVotes``) against the JAX package's on the CPU, with
moved weights, and the five checks of tests/test_pointnet_votes.py on the
port: max pooling equals the plain SA module, external indices, the rbf
pooling formula, the unique-neighbour count, the MSG shapes.  Indices and
unique counts must be equal; features within 1e-5 absolute (1e-4
relative for the parity cases)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pq3d_tpu.models import pointnet as jpn
from pq3d_tpu_torch.models import pointnet as tpn
from pq3d_tpu_torch.ops import sampling
from pq3d_tpu_torch.utils.weights import load_flax_variables
from test_torch_pointnet import random_variables

torch.set_num_threads(1)


def _data(seed=0, b=2, n=64, c=8):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, n, 3)).astype(np.float32),
            rng.standard_normal((b, n, c)).astype(np.float32))


def _pair(jmod, tmod, xyz, feats, seed=0):
    shapes = jax.eval_shape(lambda: jmod.init(
        jax.random.key(0), jnp.asarray(xyz),
        None if feats is None else jnp.asarray(feats)))
    variables = random_variables(shapes, seed)
    load_flax_variables(tmod, variables)
    return variables, tmod.eval()


def _t(x):
    return None if x is None else torch.from_numpy(x)


@pytest.mark.parametrize("pooling,normalize,with_feats", [
    ("max", False, True), ("avg", True, True), ("rbf", False, True),
    ("rbf", True, False)])
def test_votes_matches_jax(pooling, normalize, with_feats):
    xyz, feats = _data(5)
    feats = feats if with_feats else None
    kw = dict(npoint=8, radius=0.6, nsample=6, pooling=pooling,
              normalize_xyz=normalize, ret_unique_cnt=True)
    jm = jpn.PointnetSAModuleVotes(mlp=(16, 12), **kw)
    variables, tm = _pair(jm, tpn.PointnetSAModuleVotes(
        8 if with_feats else 0, (16, 12), **kw), xyz, feats)
    ref = jm.apply(variables, jnp.asarray(xyz),
                   None if feats is None else jnp.asarray(feats))
    with torch.no_grad():
        got = tm(_t(xyz), _t(feats))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    r = np.asarray(ref[1])
    assert np.abs(got[1].numpy() - r).max() <= 1e-4 * np.abs(r).max()


def test_msg_votes_matches_jax():
    xyz, feats = _data(6)
    jm = jpn.PointnetSAModuleMSGVotes(mlps=((16,), (8, 8)), npoint=8,
                                      radii=(0.3, 0.6), nsamples=(4, 8))
    variables, tm = _pair(jm, tpn.PointnetSAModuleMSGVotes(
        8, ((16,), (8, 8)), npoint=8, radii=(0.3, 0.6), nsamples=(4, 8)),
        xyz, feats)
    my = np.tile(np.arange(8, dtype=np.int32)[None] * 3, (2, 1))
    for inds in (None, my):
        ref = jm.apply(variables, jnp.asarray(xyz), jnp.asarray(feats),
                       inds=None if inds is None else jnp.asarray(inds))
        with torch.no_grad():
            got = tm(_t(xyz), _t(feats), inds=_t(inds))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
        r = np.asarray(ref[1])
        assert got[1].shape == (2, 8, 24)
        assert np.abs(got[1].numpy() - r).max() <= 1e-4 * np.abs(r).max()


def _votes_and_plain(xyz, feats, **kw):
    """A Votes module and the plain SA module with the same shared MLP."""
    votes = tpn.PointnetSAModuleVotes(feats.shape[-1], **kw).eval()
    plain = tpn.PointnetSAModule(feats.shape[-1], kw["mlp"],
                                 npoint=kw["npoint"], radius=kw["radius"],
                                 nsample=kw["nsample"]).eval()
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in votes.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3)
    plain.mlp.load_state_dict(votes.mlp.state_dict())
    return votes, plain


def test_votes_max_matches_plain_sa():
    xyz, feats = _data()
    votes, plain = _votes_and_plain(xyz, feats, mlp=(16, 16), npoint=8,
                                    radius=0.5, nsample=4)
    with torch.no_grad():
        nx_v, nf_v, inds = votes(_t(xyz), _t(feats))
        nx_p, nf_p = plain(_t(xyz), _t(feats))
    np.testing.assert_allclose(nf_v.numpy(), nf_p.numpy(), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(nx_v.numpy(), nx_p.numpy())
    assert inds.shape == (2, 8)


def test_votes_external_inds_and_gather():
    xyz, feats = _data(1)
    m = tpn.PointnetSAModuleVotes(8, (16,), npoint=8, radius=0.5,
                                  nsample=4).eval()
    my = torch.arange(8, dtype=torch.int32)[None].repeat(2, 1) * 2
    with torch.no_grad():
        nx, _nf, inds = m(_t(xyz), _t(feats), inds=my)
    np.testing.assert_array_equal(inds.numpy(), my.numpy())
    np.testing.assert_array_equal(nx.numpy(), xyz[:, ::2][:, :8])


def test_votes_rbf_pooling_formula():
    """sum_s h * exp(-|dx|^2 / (2 sigma^2)) / nsample, sigma = radius/2."""
    xyz, feats = _data(2)
    m = tpn.PointnetSAModuleVotes(8, (16,), npoint=8, radius=0.5,
                                  nsample=4, pooling="rbf").eval()
    with torch.no_grad():
        _nx, nf, inds = m(_t(xyz), _t(feats))
        centers = sampling.gather_centers_batched(_t(xyz), inds)
        idx = sampling.ball_query_batched(_t(xyz), centers, 0.5, 4).long()
        rows = torch.arange(2)[:, None, None]
        dxyz = _t(xyz)[rows, idx] - centers[:, :, None, :]
        h = m.mlp(torch.cat([dxyz, _t(feats)[rows, idx]], -1))
    sigma = 0.5 / 2
    rbf = np.exp(-np.sum(dxyz.numpy() ** 2, -1) / (sigma ** 2) / 2)
    want = (h.numpy() * rbf[..., None]).sum(2) / 4.0
    np.testing.assert_allclose(nf.numpy(), want, rtol=0, atol=1e-5)


def test_votes_unique_cnt():
    xyz, feats = _data(3)
    m = tpn.PointnetSAModuleVotes(8, (8,), npoint=8, radius=0.4, nsample=6,
                                  ret_unique_cnt=True).eval()
    with torch.no_grad():
        _nx, _nf, inds, uq = m(_t(xyz), _t(feats))
    centers = sampling.gather_centers_batched(_t(xyz), inds)
    idx = sampling.ball_query_batched(_t(xyz), centers, 0.4, 6).numpy()
    want = np.array([[len(np.unique(idx[i, j])) for j in range(8)]
                     for i in range(2)])
    np.testing.assert_array_equal(uq.numpy(), want)
    assert uq.dtype == torch.int32


def test_msg_votes_shapes_and_inds():
    xyz, feats = _data(4)
    m = tpn.PointnetSAModuleMSGVotes(8, ((16,), (8,)), npoint=8,
                                     radii=(0.3, 0.6), nsamples=(4, 8))
    with torch.no_grad():
        nx, nf, inds = m.eval()(_t(xyz), _t(feats))
    assert nx.shape == (2, 8, 3)
    assert nf.shape == (2, 8, 24)
    assert inds.dtype == torch.int32
