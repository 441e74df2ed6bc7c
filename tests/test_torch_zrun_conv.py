"""The port's z-run 3^3 conv (pq3d_tpu_torch/ops/zrun_conv.py) against the
JAX package: plan bit-identity, plain-version numerics, routing predicate.

The CUDA kernel itself runs on the card only (chip_smoke.py holds it
against ``zrun_conv_reference`` there); here the wrapper takes its plain
version because the tensors lie on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pq3d_tpu.ops import kernel_maps as jkm
from pq3d_tpu.ops import sparse as jsparse
from pq3d_tpu.ops.pallas_zt import (build_pallas_zt_plan, device_zrun_plan,
                                    pallas_zt_applicable, pallas_zt_conv)
from pq3d_tpu_torch.ops import zrun_conv as tzr

torch.set_num_threads(1)


def _scene(rng, extent=28, n_pts=4000, align=128):
    """Ravel-sorted random voxels and their padded (N, 27) map."""
    coords = np.unique(rng.integers(0, extent, (n_pts, 3)).astype(np.int32),
                       axis=0)
    key = (coords[:, 0].astype(np.int64) * 4096
           + coords[:, 1]) * 4096 + coords[:, 2]
    coords = coords[np.argsort(key)]
    n = len(coords)
    n_pad = -(-n // align) * align
    nbr = jkm.build_neighbor_map(coords, 3, n_pad=n_pad)
    valid = np.arange(n_pad) < n
    return nbr, valid


def _rel(ref, got):
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    return float(np.abs(ref - got).max() / (np.abs(ref).max() + 1e-6))


@pytest.mark.parametrize("extent,n_pts", [(28, 4000), (48, 6000)])
def test_zrun_plan_bit_identical(extent, n_pts):
    nbr, _ = _scene(np.random.default_rng(extent), extent, n_pts)
    zb_t, zc_t = tzr.zrun_plan(torch.from_numpy(nbr))
    zb_h, zc_h = jkm.build_ztriple_plan(nbr, nbr.shape[0])
    zb_d, zc_d = device_zrun_plan(jnp.asarray(nbr))
    assert zb_t.dtype == torch.int32 and zc_t.dtype == torch.int8
    np.testing.assert_array_equal(zb_t.numpy(), zb_h)
    np.testing.assert_array_equal(zc_t.numpy(), zc_h)
    np.testing.assert_array_equal(zb_t.numpy(), np.asarray(zb_d))
    np.testing.assert_array_equal(zc_t.numpy(), np.asarray(zc_d))


def test_reference_matches_gather_conv_f32():
    """Plain z-run conv == the JAX 27-tap gather conv at f32, rel <= 1e-5."""
    rng = np.random.default_rng(1)
    nbr, valid = _scene(rng)
    n = nbr.shape[0]
    x = np.zeros((n, 32), np.float32)
    x[valid] = rng.standard_normal((valid.sum(), 32))
    w = (rng.standard_normal((27, 32, 48)) * 0.1).astype(np.float32)
    ref = jsparse.sparse_conv(jnp.asarray(x), jnp.asarray(nbr),
                              jnp.asarray(w), None, jnp.asarray(valid),
                              compute_dtype=jnp.float32)
    zb, zc = tzr.zrun_plan(torch.from_numpy(nbr))
    got = tzr.zrun_conv_reference(torch.from_numpy(x), torch.from_numpy(w),
                                  zb, zc, torch.from_numpy(valid),
                                  compute_dtype=torch.float32)
    assert _rel(ref, got.numpy()) <= 1e-5


def test_wrapper_on_cpu_matches_pallas_interpret_with_exceptions():
    """zrun_conv on CPU tensors (its plain version) vs the TPU kernel in
    Pallas interpret mode, on a plan whose narrow window forces exceptions;
    bf16 operands, rel < 2e-2."""
    rng = np.random.default_rng(0)
    nbr, valid = _scene(rng, extent=48, n_pts=3000, align=64)
    plan = build_pallas_zt_plan(nbr, tile=64, window=80)
    assert plan["n_exceptions"] > 0
    n = nbr.shape[0]
    x = np.zeros((n, 16), np.float32)
    x[valid] = rng.standard_normal((valid.sum(), 16))
    w = (rng.standard_normal((27, 16, 24)) * 0.1).astype(np.float32)
    dev = {k: jnp.asarray(v) for k, v in plan.items()
           if isinstance(v, np.ndarray)}
    ref = pallas_zt_conv(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w),
                         dev["win_lo"], dev["base_local"], dev["msel"],
                         dev["exc_base"], dev["exc_out"], dev["exc_msel"],
                         jnp.asarray(valid), tile=64, window=80,
                         interpret=True)
    zb, zc = tzr.zrun_plan(torch.from_numpy(nbr))
    launches = tzr.launches
    got = tzr.zrun_conv(torch.from_numpy(x).bfloat16(), torch.from_numpy(w),
                        zb, zc, torch.from_numpy(valid))
    assert tzr.launches == launches      # the CPU path launches no kernel
    assert got.dtype == torch.bfloat16
    assert _rel(ref, got.float().numpy()) < 2e-2


def test_predicate_matches_pallas_zt_applicable(monkeypatch):
    monkeypatch.delenv("PQ3D_PALLAS_INTERPRET", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    rows = (384, 16384, 40832, 40960, 41088, 65536, 131072, 245760,
            245761, 262144)
    chans = (32, 64, 96, 128, 192, 256)
    n_on = 0
    for n in rows:
        for cin in chans:
            for cout in chans:
                want = pallas_zt_applicable(n, cin, cout)
                assert tzr.applicable(n, cin, cout) == want, (n, cin, cout)
                n_on += want
    assert n_on > 0      # the grid covers routed shapes
    # the slice's routed shapes
    assert tzr.applicable(262144, 128, 96) and tzr.applicable(131072, 96, 96)
    assert not tzr.applicable(32768, 128, 128)


def test_every_routed_shape_passes_the_kernel_shape_rule():
    """Every (Cin, Cout) that ``applicable`` admits in its channel range
    (96 <= max < 256) gets a launch plan the CUDA kernel takes: Cin padded
    to a multiple of 16, Cout covered by column slices that are multiples
    of 16 and at most 240 wide (the kernel's instantiations)."""
    n = 262144          # past the z-run gather's N * C bound
    taken = set(range(16, 241, 16))
    routed = 0
    for cin in range(1, 256):
        for cout in range(1, 256):
            if not tzr.applicable(n, cin, cout):
                continue
            routed += 1
            cin_p, slices = tzr.kernel_shape(cin, cout)
            assert cin_p % 16 == 0 and cin <= cin_p < cin + 16
            assert slices[0][0] == 0 and all(w in taken for _, w in slices)
            assert all(a + wa == b for (a, wa), (b, _) in zip(slices,
                                                             slices[1:]))
            end = slices[-1][0] + slices[-1][1]
            assert cout <= end < cout + 16
            assert len(slices) == (1 if end <= 240 else 2)
    assert routed == 255 * 255 - 95 * 95


@pytest.mark.parametrize("cin,cout", [(100, 96), (96, 248), (248, 96)])
def test_padded_column_slices_give_the_conv(cin, cout):
    """The CUDA path's arithmetic, done with the plain version: x and W
    zero-padded as ``kernel_shape`` says, one conv per column slice, the
    slices joined and the pad cut off, equals the unpadded conv."""
    rng = np.random.default_rng(cin + cout)
    nbr, valid = _scene(rng, extent=12, n_pts=600)
    n = nbr.shape[0]
    x = torch.from_numpy(rng.standard_normal((n, cin)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((27, cin, cout)) * 0.1
                          ).astype(np.float32))
    zb, zc = tzr.zrun_plan(torch.from_numpy(nbr))
    v = torch.from_numpy(valid)
    cin_p, slices = tzr.kernel_shape(cin, cout)
    end = slices[-1][0] + slices[-1][1]
    xp = torch.nn.functional.pad(x, (0, cin_p - cin))
    wp = torch.nn.functional.pad(w, (0, end - cout, 0, cin_p - cin))
    got = torch.cat([tzr.zrun_conv_reference(xp, wp[:, :, c0:c0 + width], zb,
                                             zc, v)
                     for c0, width in slices], 1)[:, :cout]
    ref = tzr.zrun_conv(x, w, zb, zc, v)
    assert got.shape == ref.shape == (n, cout)
    assert _rel(ref.numpy(), got.numpy()) <= 1e-6


@pytest.mark.parametrize("extent,n_pts,pad_tiles", [(28, 4000, 0),
                                                    (40, 5000, 3)])
def test_tile_tap_mask_matches_neighbor_map(extent, n_pts, pad_tiles):
    """tile_tap_mask, read from zcode, against the (N, 27) map itself:
    tap k of a tile is set iff (nbr[tile rows, k] >= 0).any(), at the
    kernel's tile and at its 64-row halves.  This pins tap = 3*c + dz + 1,
    the order the kernel's skip of empty (tile, tap) pairs relies on.  The
    second scene ends in whole padding tiles, which have no tap set."""
    nbr, _ = _scene(np.random.default_rng(extent), extent, n_pts)
    nbr = np.concatenate([nbr, np.full((pad_tiles * tzr.TILE, 27), -1,
                                       np.int32)])
    _, zc = tzr.zrun_plan(torch.from_numpy(nbr))
    for tile in (tzr.TILE, tzr.MMA_ROWS):
        want = (nbr.reshape(-1, tile, 27) >= 0).any(1)
        got = tzr.tile_tap_mask(zc, tile)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want)
        assert 0 < want.mean() < 1
    padding = ~got.any(1).numpy()
    assert padding.sum() == pad_tiles * tzr.TILE // tzr.MMA_ROWS
