"""The flat maps built on the device (pq3d_tpu_torch/ops/device_flat_maps)
against the JAX package's ``build_flat_maps`` and the port's
``collate_flat``, bit for bit, in the swin configuration (hierarchy and
all 8 window packs), the dense-block stem and the dense-block stem with
the z-run plans; with scenes at the low edge of their coordinate range
(after the bias every scene touches 0 on every axis, so a query off the
low edge lands in the previous scene's key margin, or below 0).
``_flat_device_true_dims`` equals JAX's, ``collate_flat_device``'s batch
equals JAX's, and its guards raise as JAX's do.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pq3d_tpu.data import instseg_pipeline as jpipe
from pq3d_tpu.data import synthetic as jsyn
from pq3d_tpu.ops import device_flat_maps as jdfm
from pq3d_tpu_torch.data import instseg_pipeline as tpipe
from pq3d_tpu_torch.ops import device_flat_maps as tdfm
from pq3d_tpu_torch.ops import device_maps as tdm

from test_torch_pipeline import _assert_same

torch.set_num_threads(1)
KW = dict(voxel_size=0.1, num_queries=16, max_segments=64, max_instances=16,
          voxel_bucket=256, use_aug=False, flat_pack=True)
CASES = {"swin": dict(stem_mode="none", swin_window=4),
         "dense": dict(stem_mode="dense_block"),
         "dense_zt": dict(stem_mode="dense_block", ztriple_conv=True)}


def _scenes(low_edge, n_scenes=3, n_points=2500):
    scenes = [jsyn.make_scene(np.random.default_rng(s), n_points=n_points,
                              n_instances=5, n_segments=24)
              for s in range(n_scenes)]
    for s in scenes:
        s["inst_labels"] = np.minimum(s["inst_labels"], 199)
        if low_edge:
            s["points"] = s["points"] - s["points"].min(0)
    return scenes


def _processed(cfg, low_edge):
    rng = np.random.default_rng(0)
    return [tpipe.process_scene(s, cfg, rng) for s in _scenes(low_edge)]


def flat_caps(maps):
    """The lock that gives the device maps a host flat batch's shapes."""
    caps = {f"{k}_{l}": (maps[f"valid_{l}"].shape[0] if k == "tot"
                         else maps[f"rect_{l}"].shape[1])
            for k in ("tot", "rect") for l in range(5)}
    caps.update({f"win{l}s{j}_nw": maps[f"win{l}s{j}_c2v"].shape[0] // 64
                 for l in (1, 2, 3, 4) for j in (0, 1)
                 if f"win{l}s{j}_c2v" in maps})
    if "stem_nbrblk" in maps:
        caps["stem_nb"] = maps["stem_nbrblk"].shape[0]
    return caps


@pytest.mark.parametrize("case,low_edge", [
    ("swin", False), ("swin", True), ("dense", True), ("dense_zt", False)])
def test_build_flat_maps_bit_parity(case, low_edge):
    cfg = tpipe.InstSegPipelineConfig(**KW, **CASES[case])
    processed = _processed(cfg, low_edge)
    host = tpipe.collate_flat(processed, cfg)
    caps = flat_caps(host["maps"])
    dcfg = dataclasses.replace(cfg, device_maps=True, flat_shape_caps=caps,
                               ztriple_conv=False)
    db = tpipe.collate_flat_device(processed, dcfg)
    if low_edge:
        starts = np.concatenate([[0], np.cumsum(db["n_voxels"])[:-1]])
        assert (db["vox_coords"][starts] == 0).any(1).all()
        assert all((db["vox_coords"][s:s + n].min(0) == 0).all() for s, n in
                   zip(starts, db["n_voxels"]))
    args = dict(swin_window=cfg.swin_window, stem_mode=cfg.stem_mode,
                ztriple=cfg.ztriple_conv)
    got = tdfm.build_flat_maps(
        torch.from_numpy(db["vox_coords"]), torch.from_numpy(db["n_voxels"]),
        caps, voxel_feats=torch.from_numpy(db["voxel_feats"]), **args)
    got = {k: v.numpy() for k, v in got.items()}
    _assert_same(host["maps"], got)
    want = jax.jit(lambda c, n, f: jdfm.build_flat_maps(
        c, n, caps, voxel_feats=f, **args))(
        jnp.asarray(db["vox_coords"]), jnp.asarray(db["n_voxels"]),
        jnp.asarray(db["voxel_feats"]))
    _assert_same({k: np.asarray(v) for k, v in want.items()}, got)


def test_collate_flat_device_and_true_dims_equal_jax():
    """The device-maps flat batch and the true dims it records equal JAX's;
    the true totals and window counts are at most the bucketed dims that
    ``collate_flat`` records, and the totals are exact."""
    cfg_kw = dict(KW, **CASES["swin"])
    processed = _processed(tpipe.InstSegPipelineConfig(**cfg_kw), False)
    host = tpipe.collate_flat(processed,
                              tpipe.InstSegPipelineConfig(**cfg_kw))
    caps = flat_caps(host["maps"])
    scenes = _scenes(False)
    bj = jpipe.make_batch([dict(s) for s in scenes],
                          jpipe.InstSegPipelineConfig(
                              device_maps=True, flat_shape_caps=caps,
                              **cfg_kw),
                          np.random.default_rng(0), train=False)
    bt = tpipe.make_batch([dict(s) for s in scenes],
                          tpipe.InstSegPipelineConfig(
                              device_maps=True, flat_shape_caps=caps,
                              **cfg_kw),
                          np.random.default_rng(0))
    _assert_same(bj, bt)
    for k, v in host["_meta"]["flat_dims"].items():
        assert bt["_meta"]["flat_dims"][k] <= v, k
    for l in range(5):
        assert bt["_meta"]["flat_dims"][f"tot_{l}"] == sum(
            p["hierarchy"].num_voxels[l] for p in processed)


def test_collate_flat_device_guards():
    """An incomplete lock, a batch past tot_0, a key space past 2^32 and a
    batch past any other cap raise, as in the JAX package (the device
    build would drop the rows silently)."""
    kw = dict(KW, **CASES["swin"])
    for pipe in (jpipe, tpipe):
        with pytest.raises(ValueError, match="COMPLETE"):
            pipe.InstSegPipelineConfig(device_maps=True, **kw)
    caps = {f"tot_{l}": 8 for l in range(5)}
    caps.update({f"rect_{l}": 8 for l in range(5)})
    caps.update({f"win{l}s{j}_nw": 8 for l in (1, 2, 3, 4) for j in (0, 1)})
    scenes = [jsyn.make_scene(np.random.default_rng(3), n_points=2000,
                              n_instances=4, n_segments=24)]
    scenes[0]["inst_labels"] = np.minimum(scenes[0]["inst_labels"], 199)
    for pipe in (jpipe, tpipe):
        cfg = pipe.InstSegPipelineConfig(device_maps=True,
                                         flat_shape_caps=caps, **kw)
        with pytest.raises(ValueError, match="tot_0"):
            pipe.make_batch([dict(s) for s in scenes], cfg,
                            np.random.default_rng(0), train=False)
    # every cap but one window count holds the scene
    proc = tpipe.process_scene(dict(scenes[0]),
                               tpipe.InstSegPipelineConfig(**kw),
                               np.random.default_rng(0))
    big = {k: 1 << 20 for k in caps}
    big["win2s1_nw"] = 1
    cfg = tpipe.InstSegPipelineConfig(device_maps=True, flat_shape_caps=big,
                                      **kw)
    with pytest.raises(ValueError, match="win2s1_nw"):
        tpipe.collate_flat_device([proc], cfg)
    tpipe.collate_flat_device([proc], dataclasses.replace(
        cfg, device_flat_check=False))
    # a field volume whose (B + 1) copies pass 2^32
    far = dict(proc, vox_coords=np.concatenate(
        [proc["vox_coords"], [[2000, 2000, 2000]]]).astype(np.int32),
        voxel_feats=np.concatenate([proc["voxel_feats"],
                                    proc["voxel_feats"][:1]]),
        voxel2segment=np.concatenate([proc["voxel2segment"], [0]]))
    with pytest.raises(ValueError, match="key space"):
        tpipe.collate_flat_device([far], cfg)


def test_swin_bias_align_and_low_edge_keys():
    """64-alignment at window 4 (16 without swin); on int64 keys a query
    one voxel below a scene's origin, on any axis, never hits a key."""
    assert tdm.swin_bias_align(4) == 64 and tdm.swin_bias_align(0) == 16
    cell = torch.tensor([[0, 0, 0], [0, 0, 1], [0, 1, 0], [1, 0, 0],
                         [1, 1, 1]])
    coords = torch.cat([cell, cell])
    scene = torch.tensor([0] * 5 + [1] * 5)
    valid = torch.ones(10, dtype=torch.bool)
    dims = coords.amax(0) + 3
    keys = tdfm._aug_key(coords, scene, valid, dims)
    assert (keys[1:] > keys[:-1]).all()
    origin = torch.tensor([0, 5])
    offs = [o for o in np.ndindex(3, 3, 3) if min(o) == 0]
    for off in offs:
        q = tdfm._aug_key(coords[origin] + torch.tensor(off) - 1,
                          scene[origin], valid[origin], dims)
        assert not torch.isin(q, keys).any(), off
