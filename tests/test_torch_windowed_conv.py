"""The port's windowed sparse conv (pq3d_tpu_torch/ops/windowed_conv.py)
against the JAX package: Morton order and window plan bit-identical, the
plain version against the Pallas kernel (in interpret mode) and against
the JAX gather conv, and the wrapper on CPU tensors.

The CUDA kernel itself runs on the card only (tests/test_torch_card.py
and chip_smoke.py hold it against ``windowed_sparse_conv_reference``
there); here the wrapper takes its plain version because the tensors lie
on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pq3d_tpu.ops import kernel_maps as jkm
from pq3d_tpu.ops import pallas_conv as jpc
from pq3d_tpu.ops import sparse as jsparse
from pq3d_tpu_torch.ops import kernel_maps as tkm
from pq3d_tpu_torch.ops import windowed_conv as twc

torch.set_num_threads(1)

PLAN_KEYS = ("win_lo", "nbr_local", "exc_in_k", "exc_row_tile",
             "exc_src_tile")


def _scene(seed, extent, n_pts, kernel=3, tile=64):
    """Morton-ordered random voxels in a cube (dense, so many references
    fall outside a tile's window) and their (N, K) map, N padded to a
    multiple of ``tile``; returns (nbr, valid rows)."""
    rng = np.random.default_rng(seed)
    coords = np.unique(rng.integers(0, extent, (n_pts, 3)).astype(np.int32),
                       axis=0)
    coords = coords[jkm.morton_order(coords)]
    n_pad = -(-len(coords) // tile) * tile
    nbr = jkm.build_neighbor_map(coords, kernel, n_pad=n_pad)
    return nbr, len(coords)


def _inputs(seed, n, n_valid, k, cin, cout):
    rng = np.random.default_rng(seed)
    x = np.zeros((n, cin), np.float32)
    x[:n_valid] = rng.standard_normal((n_valid, cin))
    w = (rng.standard_normal((k, cin, cout)) / np.sqrt(k * cin)
         ).astype(np.float32)
    return x, w


def _rel(ref, got):
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    return float(np.abs(ref - got).max() / (np.abs(ref).max() + 1e-6))


def _torch_plan(plan):
    return {key: torch.from_numpy(plan[key]) for key in PLAN_KEYS}


@pytest.mark.parametrize("case", ["cube", "negative", "past_10_bits",
                                  "duplicates"])
def test_morton_order_bit_identical(case):
    rng = np.random.default_rng(7)
    if case == "cube":
        coords = rng.integers(0, 64, (5000, 3))
    elif case == "negative":
        coords = rng.integers(-300, 300, (5000, 3))
    elif case == "past_10_bits":          # clipped at 2^10 - 1
        coords = rng.integers(0, 5000, (5000, 3))
    else:                                 # ties keep their input order
        coords = np.repeat(rng.integers(0, 8, (500, 3)), 4, axis=0)
    coords = coords.astype(np.int32)
    got = tkm.morton_order(coords)
    want = jkm.morton_order(coords)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tile,window,kernel,extent,n_pts", [
    (64, 128, 3, 16, 3000), (64, 128, 5, 16, 3000),
    (256, 512, 3, 24, 9000)])
def test_build_window_map_bit_identical(tile, window, kernel, extent, n_pts):
    nbr, _ = _scene(tile + kernel, extent, n_pts, kernel, tile)
    got = twc.build_window_map(nbr, tile=tile, window=window)
    want = jpc.build_window_map(nbr, tile=tile, window=window)
    # a scene with many exceptions, several on one output row
    assert got["n_exceptions"] == want["n_exceptions"] > nbr.shape[0] // 4
    rows = got["exc_row_tile"]
    assert any(len(r[r >= 0]) > len(np.unique(r[r >= 0])) for r in rows)
    for key in PLAN_KEYS:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("kernel,cin,cout,extent,n_pts", [
    (3, 32, 48, 16, 3000), (5, 16, 24, 12, 1200)])
def test_reference_matches_pallas_interpret(kernel, cin, cout, extent,
                                            n_pts):
    """The plain version against the TPU kernel run in interpret mode, f32
    x.  The TPU kernel rounds ``window @ W`` to bf16 before its one-hot
    sum and the port does not: rel <= 5e-3."""
    tile, window = 64, 128
    nbr, n_valid = _scene(kernel, extent, n_pts, kernel, tile)
    n, k = nbr.shape
    assert n <= 4096
    plan = twc.build_window_map(nbr, tile=tile, window=window)
    assert plan["n_exceptions"] > 0
    x, w = _inputs(1, n, n_valid, k, cin, cout)
    with pltpu.force_tpu_interpret_mode():
        ref = jpc.windowed_sparse_conv(
            jnp.asarray(x), jnp.asarray(w),
            *(jnp.asarray(plan[key]) for key in PLAN_KEYS),
            tile=tile, window=window)
    got = twc.windowed_sparse_conv_reference(
        torch.from_numpy(x), torch.from_numpy(w), _torch_plan(plan), tile,
        window)
    assert got.dtype == torch.float32 and got.shape == (n, cout)
    assert _rel(ref, got.numpy()) <= 5e-3


@pytest.mark.parametrize("kernel,cin,cout,extent,n_pts", [
    (3, 32, 48, 16, 3000), (5, 24, 16, 12, 1200)])
def test_reference_matches_gather_conv(kernel, cin, cout, extent, n_pts):
    """The plain version against the JAX gather conv on the same map: the
    same bf16 operands, f32 sums in another order, rel <= 1e-5."""
    tile, window = 64, 128
    nbr, n_valid = _scene(10 + kernel, extent, n_pts, kernel, tile)
    n, k = nbr.shape
    plan = twc.build_window_map(nbr, tile=tile, window=window)
    x, w = _inputs(2, n, n_valid, k, cin, cout)
    ref = jsparse.sparse_conv(jnp.asarray(x), jnp.asarray(nbr),
                              jnp.asarray(w))
    got = twc.windowed_sparse_conv_reference(
        torch.from_numpy(x), torch.from_numpy(w), _torch_plan(plan), tile,
        window)
    assert _rel(ref, got.numpy()) <= 1e-5


def test_exception_contrib_per_entry():
    """Row t * Et + slot of the contributions is x[src] @ W[k] of tile t's
    exception ``slot`` (bf16 operands, f32 products)."""
    tile, window = 64, 128
    nbr, n_valid = _scene(3, 16, 3000, 3, tile)
    plan = twc.build_window_map(nbr, tile=tile, window=window)
    x, w = _inputs(3, nbr.shape[0], n_valid, 27, 16, 8)
    got = twc.exception_contrib(
        torch.from_numpy(x), torch.from_numpy(w),
        torch.from_numpy(plan["exc_in_k"]),
        torch.from_numpy(plan["exc_src_tile"])).numpy()
    xb = torch.from_numpy(x).bfloat16().double().numpy()
    wb = torch.from_numpy(w).bfloat16().double().numpy()
    e_pad, et = plan["exc_in_k"].shape[1], plan["exc_row_tile"].shape[1]
    rows = plan["exc_row_tile"]
    checked = 0
    for t, s in zip(*np.nonzero(rows >= 0)):
        k, slot = divmod(int(plan["exc_src_tile"][t, s]), e_pad)
        src = plan["exc_in_k"][k, slot]
        assert nbr[t * tile + rows[t, s], k] == src
        np.testing.assert_allclose(got[t * et + s], xb[src] @ wb[k],
                                   rtol=1e-5, atol=1e-5)
        checked += 1
    assert checked == plan["n_exceptions"]


def test_wrapper_on_cpu_is_the_plain_version():
    tile, window = 64, 128
    nbr, n_valid = _scene(4, 16, 3000, 3, tile)
    plan = twc.build_window_map(nbr, tile=tile, window=window)
    x, w = _inputs(4, nbr.shape[0], n_valid, 27, 24, 40)
    xt, wt, pt = torch.from_numpy(x), torch.from_numpy(w), _torch_plan(plan)
    before = twc.launches
    got = twc.windowed_sparse_conv(xt, wt, *(pt[key] for key in PLAN_KEYS),
                                   tile=tile, window=window)
    assert twc.launches == before        # the CPU path launches no kernel
    ref = twc.windowed_sparse_conv_reference(xt, wt, pt, tile, window)
    assert torch.equal(got, ref)
    # a bf16 x gives the same: the operands are rounded to bf16 either way
    got_bf16 = twc.windowed_sparse_conv(
        xt.bfloat16(), wt, *(pt[key] for key in PLAN_KEYS), tile=tile,
        window=window)
    assert got_bf16.dtype == torch.float32 and torch.equal(got_bf16, ref)


@pytest.mark.parametrize("fault", ["w_cin", "tile_divides", "tile_width",
                                   "window", "nbr_dtype", "nbr_taps"])
def test_wrapper_refuses(fault):
    tile, window = 64, 128
    nbr, n_valid = _scene(5, 12, 1200, 3, tile)
    plan = twc.build_window_map(nbr, tile=tile, window=window)
    x, w = _inputs(5, nbr.shape[0], n_valid, 27, 16, 16)
    xt, wt, pt = torch.from_numpy(x), torch.from_numpy(w), _torch_plan(plan)
    if fault == "w_cin":
        wt = wt[:, :8]
    elif fault == "tile_divides":
        tile = next(c for c in range(48, 257, 16) if nbr.shape[0] % c)
    elif fault == "tile_width":
        tile = 40
    elif fault == "window":
        window = 32
    elif fault == "nbr_dtype":
        pt["nbr_local"] = pt["nbr_local"].long()
    else:
        pt["nbr_local"] = pt["nbr_local"][:, :8]
    with pytest.raises(ValueError):
        twc.windowed_sparse_conv(xt, wt, *(pt[key] for key in PLAN_KEYS),
                                 tile=tile, window=window)


def test_prepare_pads_and_launch_refuses_a_mismatched_plan():
    """prepare() pads Cin to a multiple of 16 and Cout to whole column
    slices (zeros that change no product); launch() checks its inputs
    before it builds or launches anything."""
    tile, window = 64, 128
    nbr, n_valid = _scene(6, 16, 3000, 3, tile)
    plan = twc.build_window_map(nbr, tile=tile, window=window)
    x, w = _inputs(6, nbr.shape[0], n_valid, 27, 24, 140)
    pt = _torch_plan(plan)
    xb, wt, contrib = twc.prepare(torch.from_numpy(x), torch.from_numpy(w),
                                  pt["exc_in_k"], pt["exc_src_tile"])
    assert xb.dtype == wt.dtype == torch.bfloat16
    assert xb.shape == (nbr.shape[0], 32) and not xb[:, 24:].any()
    assert wt.shape == (27, 160, 32)     # 140 -> two slices of 80
    want = twc.exception_contrib(torch.from_numpy(x), torch.from_numpy(w),
                                 pt["exc_in_k"], pt["exc_src_tile"])
    assert torch.equal(contrib[:, :140], want) and not contrib[:, 140:].any()
    before = twc.launches
    with pytest.raises(ValueError):
        twc.launch(xb, wt, contrib, pt["win_lo"], pt["nbr_local"][:, :26],
                   pt["exc_row_tile"], 140, tile, window)
    assert twc.launches == before
