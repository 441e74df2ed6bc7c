"""The port's windowed sparse conv (pq3d_tpu_torch/ops/windowed_conv.py)
against the JAX package: Morton order and window plan bit-identical, both
plain versions (over JAX's plan and over the kernel's folded plan) against
the Pallas kernel (in interpret mode) and against the JAX gather conv, the
folded plan itself, and the wrapper on CPU tensors.

The CUDA kernel itself runs on the card only (tests/test_torch_card.py
and chip_smoke.py hold it against the plain versions there); here the
wrapper takes its plain version because the tensors lie on the CPU.
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


def _torch_plan(plan, keys=PLAN_KEYS):
    return {key: torch.from_numpy(plan[key]) for key in keys}


def _folded(nbr, tile, window):
    plan = twc.build_window_map(nbr, tile=tile, window=window)
    return plan, twc.fold_exceptions(plan, nbr, tile, window)


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


@pytest.mark.parametrize("kernel,cin,cout,extent,n_pts", [
    (3, 32, 48, 16, 3000), (5, 16, 24, 12, 1200)])
def test_folded_reference_matches_jax_plan_and_kernels(kernel, cin, cout,
                                                       extent, n_pts):
    """The plain version over the folded plan, f32 x: against the plain
    version over JAX's plan and against the JAX gather conv (the same bf16
    operands, f32 sums in another order, rel <= 1e-5), and against the
    Pallas kernel in interpret mode (rel <= 5e-3: it rounds ``window @ W``
    to bf16)."""
    tile, window = 64, 128
    nbr, n_valid = _scene(20 + kernel, extent, n_pts, kernel, tile)
    n, k = nbr.shape
    plan, folded = _folded(nbr, tile, window)
    assert plan["n_exceptions"] > 0 and folded["exc_src"].shape[1] > 0
    x, w = _inputs(7, n, n_valid, k, cin, cout)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    got = twc.windowed_sparse_conv_folded_reference(
        xt, wt, _torch_plan(folded, twc.FOLDED_KEYS), tile, window)
    assert got.dtype == torch.float32 and got.shape == (n, cout)
    ref = twc.windowed_sparse_conv_reference(xt, wt, _torch_plan(plan), tile,
                                             window)
    assert _rel(ref.numpy(), got.numpy()) <= 1e-5
    gat = jsparse.sparse_conv(jnp.asarray(x), jnp.asarray(nbr),
                              jnp.asarray(w))
    assert _rel(gat, got.numpy()) <= 1e-5
    with pltpu.force_tpu_interpret_mode():
        pal = jpc.windowed_sparse_conv(
            jnp.asarray(x), jnp.asarray(w),
            *(jnp.asarray(plan[key]) for key in PLAN_KEYS),
            tile=tile, window=window)
    assert _rel(pal, got.numpy()) <= 5e-3


@pytest.mark.parametrize("tile,window,kernel,extent,n_pts,pad_tiles", [
    (64, 128, 3, 16, 3000, 2), (64, 128, 5, 12, 1200, 0),
    (256, 512, 3, 24, 9000, 1)])
def test_fold_exceptions_places_every_reference_once(tile, window, kernel,
                                                     extent, n_pts,
                                                     pad_tiles):
    """Every reference of the map, in the window or not, names exactly its
    source row through one slab row (``slab_sources`` gives back the map,
    -1 where it is -1); in-window references keep JAX's local row; each
    tile lists its distinct out-of-window sources once, ascending, and
    nothing else; X is their most a tile, rounded up to 16; ``tile_taps``
    lists the taps a tile's rows reference.  Tiles of padding rows have no
    tap and no extra row."""
    nbr, _ = _scene(30 + kernel, extent, n_pts, kernel, tile)
    nbr = np.concatenate([nbr, np.full((pad_tiles * tile, kernel ** 3), -1,
                                       np.int32)])
    n, k = nbr.shape
    plan, folded = _folded(nbr, tile, window)
    slab = folded["nbr_slab"]
    assert slab.shape == (n, k) and folded["tile_taps"].dtype == np.int16
    np.testing.assert_array_equal(folded["win_lo"], plan["win_lo"])
    src = twc.slab_sources(*(torch.from_numpy(folded[key]) for key in
                             ("win_lo", "nbr_slab", "exc_src")), tile, window)
    np.testing.assert_array_equal(src.numpy(), nbr)
    inside = plan["nbr_local"] >= 0
    np.testing.assert_array_equal(slab[inside], plan["nbr_local"][inside])
    outside = (nbr >= 0) & ~inside
    assert (slab[outside] >= window).all() and outside.sum() > 0
    exc = folded["exc_src"]
    t_of = np.arange(n) // tile
    most = 0
    for t in range(n // tile):
        listed = exc[t][exc[t] >= 0]
        want = np.unique(nbr[t * tile:(t + 1) * tile][
            outside[t * tile:(t + 1) * tile]])
        np.testing.assert_array_equal(listed, want)
        assert (exc[t][len(listed):] == -1).all()
        most = max(most, len(listed))
        used = np.flatnonzero((nbr[t_of == t] >= 0).any(0))
        taps = folded["tile_taps"][t]
        np.testing.assert_array_equal(taps[:len(used)], used)
        assert (taps[len(used):] == -1).all()
    assert exc.shape[1] == -(-most // 16) * 16
    assert (folded["tile_taps"][n // tile - pad_tiles:] == -1).all()


def test_nbr_slab_narrowing_is_exact():
    """nbr_slab is int16 and equals the slab rows computed in int64 from
    the plan (JAX's local row in the window, else the window plus the
    source's place in its tile's ascending list); a slab of 2^15 rows or
    more, which int16 cannot name, raises."""
    tile, window = 64, 128
    nbr, _ = _scene(8, 16, 3000, 3, tile)
    plan, folded = _folded(nbr, tile, window)
    assert folded["nbr_slab"].dtype == np.int16
    want = plan["nbr_local"].astype(np.int64)
    for j, k in zip(*np.nonzero((nbr >= 0) & (want < 0))):
        listed = folded["exc_src"][j // tile]
        want[j, k] = window + int(np.flatnonzero(listed == nbr[j, k])[0])
    np.testing.assert_array_equal(folded["nbr_slab"].astype(np.int64), want)
    # every reference of tile 0 outside a window of 2^15 - 8 rows: 16
    # extra rows take the slab past int16
    n, big = 1 << 16, (1 << 15) - 8
    far = np.full((n, 1), -1, np.int32)
    far[:16, 0] = big + 64 + np.arange(16)
    fake = {"win_lo": np.zeros(n // tile, np.int32),
            "nbr_local": np.full((n, 1), -1, np.int32)}
    with pytest.raises(ValueError, match="int16"):
        twc.fold_exceptions(fake, far, tile, big)


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
    """On CPU tensors the wrapper, over the folded plan, is the folded
    plan's plain version, which agrees with the plain version over JAX's
    plan (rel <= 1e-5)."""
    tile, window = 64, 128
    nbr, n_valid = _scene(4, 16, 3000, 3, tile)
    plan, folded = _folded(nbr, tile, window)
    x, w = _inputs(4, nbr.shape[0], n_valid, 27, 24, 40)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    pt = _torch_plan(folded, twc.FOLDED_KEYS)
    before = twc.launches
    got = twc.windowed_sparse_conv(xt, wt, *pt.values(), tile=tile,
                                   window=window)
    assert twc.launches == before        # the CPU path launches no kernel
    ref = twc.windowed_sparse_conv_folded_reference(xt, wt, pt, tile, window)
    assert torch.equal(got, ref)
    jax_plan = twc.windowed_sparse_conv_reference(xt, wt, _torch_plan(plan),
                                                  tile, window)
    assert _rel(jax_plan.numpy(), got.numpy()) <= 1e-5
    # a bf16 x gives the same: the operands are rounded to bf16 either way
    got_bf16 = twc.windowed_sparse_conv(xt.bfloat16(), wt, *pt.values(),
                                        tile=tile, window=window)
    assert got_bf16.dtype == torch.float32 and torch.equal(got_bf16, ref)


@pytest.mark.parametrize("fault", ["w_cin", "tile_divides", "tile_width",
                                   "window", "nbr_dtype", "nbr_taps",
                                   "x_rows_fit", "x_rows_16"])
def test_wrapper_refuses(fault):
    """The wrapper's checks, on CPU tensors: a plan the kernel would not
    take raises here as on the card, among them a plan whose slab (window
    plus X extra rows) does not fit shared memory."""
    tile, window = 64, 128
    nbr, n_valid = _scene(5, 12, 1200, 3, tile)
    _, folded = _folded(nbr, tile, window)
    x, w = _inputs(5, nbr.shape[0], n_valid, 27, 16, 16)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    pt = _torch_plan(folded, twc.FOLDED_KEYS)
    n_tiles = nbr.shape[0] // tile
    if fault == "w_cin":
        wt = wt[:, :8]
    elif fault == "tile_divides":
        tile = next(c for c in range(48, 257, 16) if nbr.shape[0] % c)
    elif fault == "tile_width":
        tile = 40
    elif fault == "window":
        window = 32
    elif fault == "nbr_dtype":
        pt["nbr_slab"] = pt["nbr_slab"].long()
    elif fault == "nbr_taps":
        pt["nbr_slab"] = pt["nbr_slab"][:, :8]
    elif fault == "x_rows_fit":
        pt["exc_src"] = torch.full((n_tiles, 8192), -1, dtype=torch.int32)
    else:
        pt["exc_src"] = torch.full((n_tiles, 24), -1, dtype=torch.int32)
    with pytest.raises(ValueError):
        twc.windowed_sparse_conv(xt, wt, *pt.values(), tile=tile,
                                 window=window)


def test_smem_fit_takes_the_routed_shapes():
    """The kernel's shared-memory plan at tile 256 / window 512 for every
    routed (Cin, Cout) with up to 208 extra rows a tile (the most the
    served batch's maps need is 144 at 3^3 and 192 at 5^3) and the 5^3
    case: the widest chunk that fits, one slab buffer when it holds all of
    Cin; within the 227 KB a block may use."""
    cases = [(96, 96, 27), (128, 96, 27), (128, 128, 27), (192, 128, 27),
             (32, 32, 125)]
    for cin, cout, k in cases:
        for x_rows in range(0, 209, 16):
            ck, bufs, smem = twc.smem_fit(cin, cout, 512, x_rows, k)
            assert ck % 16 == 0 and smem <= twc.SMEM_LIMIT
            assert bufs == (1 if ck >= cin else 2)
    assert twc.smem_fit(96, 96, 512, 144, 27)[:2] == (96, 1)
    assert twc.smem_fit(192, 128, 512, 144, 27)[:2] == (64, 2)


def test_prepare_pads_and_launch_refuses_a_mismatched_plan():
    """prepare() pads Cin to a multiple of 16 and Cout to whole column
    slices (zeros that change no product); launch() checks its inputs
    before it builds or launches anything."""
    tile, window = 64, 128
    nbr, n_valid = _scene(6, 16, 3000, 3, tile)
    _, folded = _folded(nbr, tile, window)
    x, w = _inputs(6, nbr.shape[0], n_valid, 27, 24, 140)
    pt = _torch_plan(folded, twc.FOLDED_KEYS)
    x_rows = folded["exc_src"].shape[1]
    xb, img = twc.prepare(torch.from_numpy(x), torch.from_numpy(w), x_rows,
                          window)
    assert xb.dtype == img.dtype == torch.bfloat16
    assert xb.shape == (nbr.shape[0], 32) and not xb[:, 24:].any()
    # 140 -> two slices of 80; Cin 32 in one chunk, rows 32 + 8 wide
    assert twc.smem_fit(24, 140, window, x_rows, 27)[0] == 32
    assert img.shape == (2, 1, 27, 80, 40)
    wb = torch.from_numpy(w).bfloat16()
    for s in range(2):
        cols = wb[:, :, 80 * s:80 * s + 80].transpose(1, 2)   # (27, n, Cin)
        assert torch.equal(img[s, 0, :, :cols.shape[1], :24], cols)
    assert not img[1, 0, :, 60:].any() and not img[..., 24:].any()
    before = twc.launches
    with pytest.raises(ValueError):
        twc.launch(xb, img, pt["win_lo"], pt["nbr_slab"][:, :26],
                   pt["exc_src"], pt["tile_taps"], 140, tile, window)
    assert twc.launches == before
