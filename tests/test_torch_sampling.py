"""The port's point sampling and grouping ops (pq3d_tpu_torch/ops/
sampling.py) against the JAX package's on the same seeded numpy clouds:
indices exact, floats within 1e-6.  The clouds include points exactly on
a ball's edge (excluded: the test is strict) and balls with fewer hits
than ``nsample`` (filled with the first hit) or none (all 0)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pq3d_tpu.ops import sampling as js
from pq3d_tpu_torch.ops import sampling as ts

torch.set_num_threads(1)
TOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max(initial=0.0) <= TOL * max(
        1.0, np.abs(ref).max(initial=0.0))


def _clouds(seed, b=3, n=96):
    """Random clouds in the unit cube plus grid points: every coordinate a
    multiple of 0.25, so distances between grid points are exact and a
    radius of 0.5 puts some of them exactly on a ball's edge, and an
    isolated far point whose ball holds only itself."""
    rng = np.random.default_rng(seed)
    xyz = rng.random((b, n, 3)).astype(np.float32)
    grid = rng.integers(0, 5, (b, n // 3, 3)).astype(np.float32) * 0.25
    xyz[:, : n // 3] = grid
    xyz[:, -1] = 9.0
    return xyz


@pytest.mark.parametrize("seed", [0, 1])
def test_furthest_point_sample(seed):
    xyz = _clouds(seed)
    got = ts.furthest_point_sample_batched(_t(xyz), 17).numpy()
    ref = np.asarray(js.furthest_point_sample_batched(jnp.asarray(xyz), 17))
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.int32
    got = ts.furthest_point_sample(_t(xyz[0]), 12).numpy()
    ref = np.asarray(js.furthest_point_sample(jnp.asarray(xyz[0]), 12))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("radius,nsample", [(0.5, 8), (0.25, 16),
                                            (0.05, 4), (100.0, 32)])
def test_ball_query(radius, nsample):
    xyz = _clouds(2)
    centers = np.concatenate([xyz[:, ::7], xyz[:, -1:]], 1)  # grid, far
    got = ts.ball_query_batched(_t(xyz), _t(centers), radius,
                                nsample).numpy()
    ref = np.asarray(js.ball_query_batched(
        jnp.asarray(xyz), jnp.asarray(centers), radius, nsample))
    np.testing.assert_array_equal(got, ref)
    got1 = ts.ball_query(_t(xyz[0]), _t(centers[0]), radius, nsample)
    np.testing.assert_array_equal(got1.numpy(), np.asarray(js.ball_query(
        jnp.asarray(xyz[0]), jnp.asarray(centers[0]), radius, nsample)))
    if radius == 0.5:
        # the far point's ball holds itself only: filled with it
        assert (got[:, -1] == xyz.shape[1] - 1).all()
        d2 = ((centers[:, :, None] - xyz[:, None]) ** 2).sum(-1)
        assert (d2 == 0.25).any()           # edge points occur, excluded
    # a ball with no hit at all comes back as zeros
    empty = ts.ball_query(_t(xyz[0]), torch.full((1, 3), -1e4), radius,
                          nsample)
    assert (empty == 0).all()


@pytest.mark.parametrize("use_xyz", [True, False])
def test_query_and_group(use_xyz):
    xyz = _clouds(3)
    rng = np.random.default_rng(3)
    feats = rng.standard_normal(xyz.shape[:2] + (5,)).astype(np.float32)
    idx = np.asarray(js.furthest_point_sample_batched(jnp.asarray(xyz), 9))
    centers_t = ts.gather_centers_batched(_t(xyz), _t(idx))
    centers_j = js.gather_centers_batched(jnp.asarray(xyz), jnp.asarray(idx))
    np.testing.assert_array_equal(centers_t.numpy(), np.asarray(centers_j))
    for f in (feats, None):
        got = ts.query_and_group_batched(
            _t(xyz), centers_t, None if f is None else _t(f), 0.4, 8,
            use_xyz)
        ref = js.query_and_group_batched(
            jnp.asarray(xyz), centers_j, None if f is None else
            jnp.asarray(f), 0.4, 8, use_xyz)
        _close(got.numpy(), ref)
        got1 = ts.query_and_group(_t(xyz[1]), centers_t[1],
                                  None if f is None else _t(f[1]), 0.4, 8,
                                  use_xyz)
        ref1 = js.query_and_group(jnp.asarray(xyz[1]), centers_j[1],
                                  None if f is None else jnp.asarray(f[1]),
                                  0.4, 8, use_xyz)
        _close(got1.numpy(), ref1)
    gi = rng.integers(0, xyz.shape[1], (4, 6)).astype(np.int32)
    _close(ts.group_points(_t(feats[0]), _t(gi)).numpy(),
           js.group_points(jnp.asarray(feats[0]), jnp.asarray(gi)))


def test_three_nn_and_interpolate():
    rng = np.random.default_rng(4)
    known = (rng.integers(0, 4, (20, 3)) * 0.5).astype(np.float32)
    unknown = np.concatenate([known[:5] + 0.25,
                              rng.random((15, 3)).astype(np.float32) * 2])
    d_t, i_t = ts.three_nn(_t(unknown), _t(known))
    d_j, i_j = js.three_nn(jnp.asarray(unknown), jnp.asarray(known))
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    _close(d_t.numpy(), d_j)
    feats = rng.standard_normal((20, 7)).astype(np.float32)
    iw_t = ts.three_interpolate_weights(_t(unknown), _t(known))
    iw_j = js.three_interpolate_weights(jnp.asarray(unknown),
                                        jnp.asarray(known))
    np.testing.assert_array_equal(iw_t[0].numpy(), np.asarray(iw_j[0]))
    _close(iw_t[1].numpy(), iw_j[1])
    _close(ts.three_interpolate(_t(feats), iw_t[0], iw_t[1]).numpy(),
           js.three_interpolate(jnp.asarray(feats), iw_j[0], iw_j[1]))
