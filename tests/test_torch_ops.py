"""The port's plain ops (pq3d_tpu_torch/ops) against the JAX package on the
same numpy inputs.  Tolerances, as max|diff| / max|ref|: 1e-5 at f32
compute (only the summation order differs), 1e-2 at the bf16 default
(operands round identically; the f32 sums differ in order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pq3d_tpu.ops import kernel_maps as jkm
from pq3d_tpu.ops import pairwise as jpw
from pq3d_tpu.ops import segment as jseg
from pq3d_tpu.ops import sparse as jsparse
from pq3d_tpu.ops import window_maps as jwm
from pq3d_tpu_torch.ops import pairwise as tpw
from pq3d_tpu_torch.ops import segment as tseg
from pq3d_tpu_torch.ops import sparse as tsparse

torch.set_num_threads(1)

TOL = {"f32": 1e-5, "bf16": 1e-2}
DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}


def _rel(ref, got):
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    return float(np.abs(ref - got).max() / (np.abs(ref).max() + 1e-6))


def _coords(n=800, extent=30, seed=0):
    rng = np.random.default_rng(seed)
    return np.unique(rng.integers(0, extent, (n, 3)), axis=0).astype(
        np.int32)


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_sparse_conv_3x3_and_down(mode):
    rng = np.random.default_rng(0)
    coords = _coords()
    n = len(coords)
    jdt, tdt = DT[mode]
    nbr = jkm.build_neighbor_map(coords, 3)
    coarse, parent, off = jkm.downsample_coords(coords)
    child = jkm.build_child_map(parent, off, len(coarse))
    x = rng.standard_normal((n, 16)).astype(np.float32)
    valid = rng.random(n) > 0.1
    for m, k in ((nbr, 27), (child, 8)):
        w = (rng.standard_normal((k, 16, 24)) * 0.1).astype(np.float32)
        ov = valid[:len(m)]
        ref = jsparse.sparse_conv(jnp.asarray(x), jnp.asarray(m),
                                  jnp.asarray(w), None, jnp.asarray(ov),
                                  compute_dtype=jdt)
        got = tsparse.sparse_conv(torch.from_numpy(x), torch.from_numpy(m),
                                  torch.from_numpy(w), None,
                                  torch.from_numpy(ov), compute_dtype=tdt)
        assert _rel(ref, got.numpy()) <= TOL[mode], (mode, k)


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_sparse_conv_transpose(mode):
    rng = np.random.default_rng(1)
    coords = _coords()
    jdt, tdt = DT[mode]
    coarse, parent, off = jkm.downsample_coords(coords)
    parent = np.concatenate([parent, [-1, -1]]).astype(np.int32)
    off = np.concatenate([off, [0, 0]]).astype(np.int32)
    x = rng.standard_normal((len(coarse), 24)).astype(np.float32)
    w = (rng.standard_normal((8, 24, 16)) * 0.1).astype(np.float32)
    valid = rng.random(len(parent)) > 0.1
    ref = jsparse.sparse_conv_transpose(
        jnp.asarray(x), jnp.asarray(parent), jnp.asarray(off),
        jnp.asarray(w), jnp.asarray(valid), compute_dtype=jdt)
    got = tsparse.sparse_conv_transpose(
        torch.from_numpy(x), torch.from_numpy(parent), torch.from_numpy(off),
        torch.from_numpy(w), torch.from_numpy(valid), compute_dtype=tdt)
    assert _rel(ref, got.numpy()) <= TOL[mode]


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_conv0_dense_block(mode):
    """Dense-block stem on the tests/test_dense_stem.py setup: blocks padded
    past the occupied count, kernel 5, block 8 (the weight-layout check)."""
    rng = np.random.default_rng(0)
    jdt, tdt = DT[mode]
    coords = _coords()
    n, cin, cout, block = len(coords), 3, 16, 8
    x = rng.standard_normal((n, cin)).astype(np.float32)
    w = (rng.standard_normal((125, cin, cout)) * 0.1).astype(np.float32)
    p = jwm.build_window_pack(coords, block, 0, with_neighbors=True)
    nb_pad = p["n_win"] + 2
    b3 = block ** 3
    dense = np.zeros((nb_pad * b3, cin), np.float32)
    dense[p["vox_slot"]] = x
    dense = dense.reshape(nb_pad, b3 * cin)
    c2v = np.full(nb_pad * b3, -1, np.int32)
    c2v[:len(p["cell_to_vox"])] = p["cell_to_vox"]
    nbrblk = np.full((nb_pad, 27), -1, np.int32)
    nbrblk[:p["n_win"]] = p["nbr_win"]
    slot = np.concatenate([p["vox_slot"], [-1, -1, -1]]).astype(np.int32)
    valid = np.arange(len(slot)) < n
    ref = jsparse.conv0_dense_block(
        jnp.asarray(dense), jnp.asarray(nbrblk), jnp.asarray(slot),
        jnp.asarray(c2v), jnp.asarray(w), jnp.asarray(valid),
        compute_dtype=jdt)
    got = tsparse.conv0_dense_block(
        torch.from_numpy(dense), torch.from_numpy(nbrblk),
        torch.from_numpy(slot), torch.from_numpy(w),
        torch.from_numpy(valid), compute_dtype=tdt)
    assert _rel(ref, got.numpy()) <= TOL[mode]
    if mode == "f32":
        # and the gathered 125-tap conv it replaces
        gathered = jsparse.sparse_conv(
            jnp.asarray(x), jnp.asarray(jkm.build_neighbor_map(coords, 5)),
            jnp.asarray(w), compute_dtype=jnp.float32)
        assert _rel(gathered, got.numpy()[:n]) <= TOL[mode]


def test_segment_ops():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((500, 7)).astype(np.float32)
    ids = rng.integers(0, 42, 500).astype(np.int32)   # 40 = trash, 41 drop
    for jf, tf in ((jseg.segment_sum, tseg.segment_sum),
                   (jseg.segment_mean, tseg.segment_mean)):
        ref = jf(jnp.asarray(x), jnp.asarray(ids), 40)
        got = tf(torch.from_numpy(x), torch.from_numpy(ids), 40)
        assert got.shape == (40, 7)
        assert _rel(ref, got.numpy()) <= TOL["f32"]


def test_calc_pairwise_locs():
    rng = np.random.default_rng(3)
    c = rng.standard_normal((2, 9, 3)).astype(np.float32)
    ref = jpw.calc_pairwise_locs(jnp.asarray(c), None)
    got = tpw.calc_pairwise_locs(torch.from_numpy(c))
    assert got.shape == (2, 9, 9, 5)
    assert _rel(ref, got.numpy()) <= TOL["f32"]


@pytest.mark.parametrize("rel_type", ["center", "vertical_bottom", "mlp"])
@pytest.mark.parametrize("with_whls", [False, True])
@pytest.mark.parametrize("spatial_dim", [5, 4])
def test_calc_pairwise_locs_every_branch(rel_type, with_whls, spatial_dim):
    """JAX's whole ``calc_pairwise_locs``: the three relation types, with
    and without box sizes ``whls``, within 1e-6 of the largest feature.
    ``vertical_bottom`` without ``whls`` is bit-equal to ``center``; with
    them its dz / dist / dist2d read the boxes' bottoms; ``mlp`` needs
    ``whls`` (JAX fails on ``concatenate`` without them) and the port
    raises."""
    rng = np.random.default_rng(7)
    c = rng.standard_normal((2, 6, 3)).astype(np.float32)
    w = rng.random((2, 6, 3)).astype(np.float32) + 0.1
    jw = jnp.asarray(w) if with_whls else None
    tw = torch.from_numpy(w) if with_whls else None
    kw = dict(pairwise_rel_type=rel_type, spatial_dim=spatial_dim)
    if rel_type == "mlp" and not with_whls:
        with pytest.raises(TypeError):
            jpw.calc_pairwise_locs(jnp.asarray(c), None, **kw)
        with pytest.raises(ValueError, match="whls"):
            tpw.calc_pairwise_locs(torch.from_numpy(c), None, **kw)
        return
    ref = np.asarray(jpw.calc_pairwise_locs(jnp.asarray(c), jw, **kw))
    got = tpw.calc_pairwise_locs(torch.from_numpy(c), tw, **kw).numpy()
    assert got.shape == ref.shape
    assert _rel(ref, got) <= 1e-6
    if rel_type == "vertical_bottom":
        center = tpw.calc_pairwise_locs(
            torch.from_numpy(c), None, spatial_dim=spatial_dim).numpy()
        if with_whls:
            assert not np.array_equal(got, center)
            np.testing.assert_array_equal(got[..., -2:], center[..., -2:])
        else:
            np.testing.assert_array_equal(got, center)
    with pytest.raises(NotImplementedError):
        tpw.calc_pairwise_locs(torch.from_numpy(c), tw,
                               pairwise_rel_type="nearest")
