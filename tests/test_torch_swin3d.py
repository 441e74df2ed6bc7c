"""The port's Swin3D backbone (pq3d_tpu_torch/models/swin3d.py) and its
window maps (ops/window_maps.py) against the JAX package's.

The window packs, ``pad_pack``, ``relative_position_index`` and
``build_swin_packs`` equal JAX's exactly (negative coordinates included),
and the batches of the swin layouts (rectangular and flat) equal JAX's
bit for bit.  ``WindowAttention``, ``SwinBlock`` and ``Swin3DUNet`` (in
the rectangular and the flat layout) match JAX from one set of weights
moved by ``utils/weights.load_flax_variables``, within
``test_torch_model``'s tolerance (max|diff| / max|ref| <= 2e-2; the
attention alone at 1e-5).  The unit checks of ``tests/test_swin3d.py``
run on the port: the pack round trip, the pad, the bias index, the
attention against numpy with the masked cells' values perturbed, the
U-Net's padding invariance, the segment encoder and finite gradients
into every parameter.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pq3d_tpu.data import instseg_pipeline as jpipe
from pq3d_tpu.data import synthetic as jsyn
from pq3d_tpu.models import swin3d as jswin
from pq3d_tpu.ops import window_maps as jwm
from pq3d_tpu_torch.data import instseg_pipeline as tpipe
from pq3d_tpu_torch.models import swin3d as tswin
from pq3d_tpu_torch.models.encoders import SegVoxelEncoder
from pq3d_tpu_torch.ops import window_maps as twm
from pq3d_tpu_torch.serve import to_device
from pq3d_tpu_torch.utils.weights import load_flax_variables

from test_torch_model import TOL, _random_variables, _rel
from test_torch_pipeline import _assert_same

torch.set_num_threads(1)
CPU = torch.device("cpu")
# the small U-Net of tests/test_swin3d.py
SMALL = dict(out_channels=20, channels=(8, 16, 24, 32), depths=(1, 1, 2, 1),
             num_heads=(2, 2, 2, 2), stem_dim=8)
KW = dict(voxel_size=0.15, num_queries=8, max_segments=32, max_instances=8,
          voxel_bucket=256, use_aug=False, stem_mode="none", swin_window=4)


def _coords(n=500, seed=0, lo=0, hi=40):
    rng = np.random.default_rng(seed)
    return np.unique(rng.integers(lo, hi, (n, 3)), axis=0).astype(np.int32)


@pytest.mark.parametrize("lo,window,shift,nbrs", [
    (0, 4, 0, False), (0, 4, 2, False), (-50, 8, 4, True), (-50, 4, 2, True)])
def test_window_packs_equal_jax(lo, window, shift, nbrs):
    coords = _coords(3000, seed=1, lo=lo, hi=lo + 60)
    pj = jwm.build_window_pack(coords, window, shift, with_neighbors=nbrs)
    pt = twm.build_window_pack(coords, window, shift, with_neighbors=nbrs)
    _assert_same(pj, pt)
    _assert_same(jwm.pad_pack(pj, window, pj["n_win"] + 5, len(coords) + 9),
                 twm.pad_pack(pt, window, pt["n_win"] + 5, len(coords) + 9))
    np.testing.assert_array_equal(jwm.relative_position_index(window),
                                  twm.relative_position_index(window))
    levels = [coords, coords >> 1, coords >> 2]
    _assert_same(jwm.build_swin_packs(levels, window, (1, 2)),
                 twm.build_swin_packs(levels, window, (1, 2)))


def _scenes(seed=0, sizes=(600, 900)):
    rng = np.random.default_rng(seed)
    scenes = [jsyn.make_scene(rng, n_points=n, n_instances=3, n_segments=12)
              for n in sizes]
    for s in scenes:
        s["inst_labels"] = np.minimum(s["inst_labels"], 19)
    return scenes


def _batch(flat, pipe=tpipe, seed=0):
    caps = None if flat else [512, 256, 128, 128, 128]
    cfg = pipe.InstSegPipelineConfig(flat_pack=flat, level_caps=caps, **KW)
    return pipe.make_batch(_scenes(seed), cfg, np.random.default_rng(seed),
                           train=False)


@pytest.mark.parametrize("flat", [False, True])
def test_swin_batches_equal_jax(flat):
    """The swin layouts' batches (window packs padded per scene, or
    concatenated flat with ``win{l}s{j}_nw`` in the flat dims) equal JAX's
    bit for bit."""
    bj, bt = _batch(flat, jpipe), _batch(flat, tpipe)
    _assert_same(bj, bt)
    assert "stem_c2v" not in bt["maps"] and "win4s1_slot" in bt["maps"]


def test_window_attention_matches_jax_and_numpy():
    """The port's attention against JAX's from the same weights, and
    against numpy; the masked cells' values never reach an occupied
    cell's output; a window with no occupied cell stays finite."""
    rng = np.random.default_rng(1)
    w3, c, h = 27, 32, 4
    x = rng.standard_normal((3, w3, c)).astype(np.float32)
    occ = np.ones((3, w3), bool)
    occ[0, 10:] = False
    occ[2] = False
    jattn = jswin.WindowAttention(dim=c, num_heads=h, window=3)
    variables = _random_variables(lambda: jattn.init(
        jax.random.key(0), jnp.asarray(x), jnp.asarray(occ)))
    want = np.asarray(jattn.apply(variables, jnp.asarray(x),
                                  jnp.asarray(occ)))
    tattn = tswin.WindowAttention(c, h, 3)
    load_flax_variables(tattn, variables)
    with torch.no_grad():
        got = tattn(torch.from_numpy(x), torch.from_numpy(occ)).numpy()
        x2 = x.copy()
        x2[~occ] += 50.0
        got2 = tattn(torch.from_numpy(x2), torch.from_numpy(occ)).numpy()
    assert np.isfinite(got).all()
    assert _rel(want, got) <= 1e-5
    np.testing.assert_allclose(got[occ], got2[occ], rtol=1e-4, atol=1e-5)

    p = jax.tree.map(np.asarray, variables["params"])
    qkv = (x @ p["qkv"]["kernel"] + p["qkv"]["bias"]).reshape(3, w3, 3, h,
                                                               c // h)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    bias = p["rel_bias"][twm.relative_position_index(3)]
    logits = np.einsum("nqhd,nkhd->nhqk", q * (c // h) ** -0.5, k) \
        + bias.transpose(2, 0, 1)[None]
    logits = np.where(occ[:, None, None, :], logits, -1e9)
    a = np.exp(logits - logits.max(-1, keepdims=True))
    a = a / a.sum(-1, keepdims=True)
    o = np.einsum("nhqk,nkhd->nqhd", a, v).reshape(3, w3, c)
    np.testing.assert_allclose(got, o @ p["proj"]["kernel"]
                               + p["proj"]["bias"], rtol=1e-4, atol=1e-5)


def test_swin_block_matches_jax():
    """One block on flat rows through the packs of a real level (the
    regular pack), pad rows included, against JAX."""
    b = _batch(True)
    m = b["maps"]
    n, dim = m["valid_1"].shape[0], 16
    x = np.random.default_rng(2).standard_normal((n, dim)).astype(np.float32)
    x[~m["valid_1"]] = 0
    args = [m["win1s0_c2v"], m["win1s0_slot"], m["valid_1"]]
    jblock = jswin.SwinBlock(dim, 2, 4)
    variables = _random_variables(lambda: jblock.init(
        jax.random.key(0), jnp.asarray(x), *map(jnp.asarray, args)))
    want = jax.jit(lambda v: jblock.apply(
        v, jnp.asarray(x), *map(jnp.asarray, args)))(variables)
    tblock = tswin.SwinBlock(dim, 2, 4)
    load_flax_variables(tblock, variables)
    with torch.no_grad():
        got = tblock(torch.from_numpy(x),
                     *[torch.from_numpy(a) for a in args])
    assert _rel(want, got.numpy()) <= 1e-5


@pytest.fixture(scope="module")
def unets():
    """JAX's small U-Net output on the rectangular and the flat batch of
    the same scenes, its weights, and the batches."""
    out = {}
    jmodel = jswin.Swin3DUNet(**SMALL)
    for flat in (False, True):
        b = _batch(flat)
        maps = jax.tree.map(jnp.asarray, b["maps"])
        x = jnp.asarray(b["voxel_feats"])
        if "variables" not in out:
            out["variables"] = _random_variables(lambda: jmodel.init(
                jax.random.key(0), x, maps, train=False))
        final, fmaps = jax.jit(lambda v, x, m: jmodel.apply(
            v, x, m, train=False))(out["variables"], x, maps)
        out[flat] = (b, np.asarray(final), [np.asarray(f) for f in fmaps])
    return out


@pytest.mark.parametrize("flat", [False, True])
def test_swin3d_unet_matches_jax(unets, flat):
    b, final_j, fmaps_j = unets[flat]
    tmodel = tswin.Swin3DUNet(**SMALL).eval()
    load_flax_variables(tmodel, unets["variables"])
    with torch.inference_mode():
        final_t, fmaps_t = tmodel(torch.from_numpy(b["voxel_feats"]),
                                  to_device(b["maps"], CPU))
    assert final_t.shape == final_j.shape
    assert _rel(final_j, final_t.numpy()) <= TOL
    assert len(fmaps_t) == 5
    for lvl, (a, c) in enumerate(zip(fmaps_j, fmaps_t)):
        assert a.shape == tuple(c.shape), lvl
        assert _rel(a, c.numpy()) <= TOL, lvl


def test_swin3d_unet_padding_invariance_and_encoder(unets):
    """Pad rows' features do not reach valid outputs; the segment encoder
    on the swin backbone gives finite (B, S, hidden) scales at the swin
    widths [L4..L0]."""
    b = unets[False][0]
    maps = to_device(b["maps"], CPU)
    x = torch.from_numpy(b["voxel_feats"])
    tmodel = tswin.Swin3DUNet(**SMALL).eval()
    load_flax_variables(tmodel, unets["variables"])
    valid = torch.from_numpy(b["maps"]["valid_0"])
    with torch.inference_mode():
        final, fmaps = tmodel(x, maps)
        final2, _ = tmodel(x + 100.0 * (~valid)[..., None], maps)
    assert torch.isfinite(final).all()
    torch.testing.assert_close(final[valid], final2[valid], rtol=2e-3,
                               atol=2e-4)
    assert [f.shape[1] for f in fmaps] == [32, 24, 16, 8, 8]

    enc = SegVoxelEncoder(hidden_size=32, hlevels=(0, 1),
                          backbone_out_channels=20, backbone="swin3d")
    assert enc.backbone.feature_channels == [384, 192, 96, 48, 48]
    assert enc.feat_proj_0.Dense_0.in_features == 384
    with pytest.warns(UserWarning, match="pallas_conv"):
        SegVoxelEncoder(hidden_size=32, backbone="swin3d", pallas_conv=True)
    enc.backbone = tmodel
    enc.feat_proj_0 = type(enc.feat_proj_0)(32, 32)
    enc.feat_proj_1 = type(enc.feat_proj_1)(24, 32)
    enc.feat_proj_2 = type(enc.feat_proj_2)(8, 32)
    with torch.inference_mode():
        outs = enc.eval()(x, maps, torch.from_numpy(b["voxel2segment"]), 32)
    assert len(outs) == 3
    for o in outs:
        assert o.shape == (2, 32, 32) and torch.isfinite(o).all()


def test_swin3d_gradients_flow(unets):
    b = unets[False][0]
    tmodel = tswin.Swin3DUNet(**SMALL).train()
    load_flax_variables(tmodel, unets["variables"])
    out, _ = tmodel(torch.from_numpy(b["voxel_feats"]),
                    to_device(b["maps"], CPU))
    out[0].square().sum().backward()
    grads = {n: p.grad for n, p in tmodel.named_parameters()}
    assert all(g is not None and torch.isfinite(g).all()
               for g in grads.values())
    assert grads["stage1.block0.attn.rel_bias"].abs().sum() > 0
    assert grads["stage1.block0.attn.qkv.weight"].abs().sum() > 0


def test_window_pack_roundtrip_and_negative_coords():
    """Every voxel in exactly one cell, cells of a window in one spatial
    window, the pad, the bias index's range and symmetry, and injective
    packs of a cloud that spans negative coordinates, unchanged by a
    translation by a window multiple."""
    coords = _coords()
    for shift in (0, 2):
        p = twm.build_window_pack(coords, window=4, shift=shift)
        c2v, slot = p["cell_to_vox"], p["vox_slot"]
        assert len(np.unique(slot)) == len(coords)
        assert (c2v[slot] == np.arange(len(coords))).all()
        assert sorted(c2v[c2v >= 0]) == list(range(len(coords)))
        for win in range(min(p["n_win"], 5)):
            vox = c2v[win * 64:(win + 1) * 64]
            wc = (coords[vox[vox >= 0]] + shift) // 4
            assert (wc == wc[0]).all()
    pp = twm.pad_pack(p, 4, p["n_win"] + 3, len(coords) + 7)
    assert (pp["cell_to_vox"][p["n_win"] * 64:] == -1).all()
    assert (pp["vox_slot"][len(coords):] == -1).all()
    with pytest.raises(ValueError):
        twm.pad_pack(p, 4, p["n_win"] - 1, len(coords))
    ri = twm.relative_position_index(4)
    assert ri.shape == (64, 64) and ri.min() >= 0 and ri.max() < 7 ** 3
    assert ri[0, 63] + ri[63, 0] == 2 * ri[0, 0]

    p = twm.build_window_pack(np.array([[0, -1, 0], [-8, 7, 0]], np.int32),
                              8, 0)
    assert p["n_win"] == 2 and len(set(p["vox_slot"].tolist())) == 2
    cloud = _coords(5000, lo=-50, hi=50)
    for shift in (0, 4):
        p = twm.build_window_pack(cloud, 8, shift, with_neighbors=True)
        assert len(np.unique(p["vox_slot"])) == len(cloud)
        np.testing.assert_array_equal(p["cell_to_vox"][p["vox_slot"]],
                                      np.arange(len(cloud)))
        q = twm.build_window_pack(cloud - 8 * 13, 8, shift,
                                  with_neighbors=True)
        assert q["n_win"] == p["n_win"]
        np.testing.assert_array_equal(q["vox_slot"], p["vox_slot"])
        np.testing.assert_array_equal(q["nbr_win"], p["nbr_win"])
