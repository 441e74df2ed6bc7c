"""Kernel maps built on the device (pq3d_tpu_torch/ops/device_maps.py)
against the JAX package's device maps and against the host's
``build_hierarchy`` / ``build_window_pack``, exactly; the device-maps batch
bit-identical to JAX's; the z-run plan three ways; a small Query3D in the
``dev_maps`` layout against JAX's same layout (max|diff| / max|ref| <=
2e-2, the port's model tolerance: bf16 conv operands round identically on
both sides, f32 sums differ in order) and against the port's own host-maps
forward (<= 1e-5: the same maps); the serving refusals.  Everything on the
CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pq3d_tpu.data import instseg_pipeline as jpipe
from pq3d_tpu.data import synthetic as jsyn
from pq3d_tpu.ops import device_maps as jdm
from pq3d_tpu.ops import kernel_maps as jkm
from pq3d_tpu.ops import window_maps as jwm
from pq3d_tpu.ops.pallas_zt import device_zrun_plan
from pq3d_tpu_torch.data import instseg_pipeline as tpipe
from pq3d_tpu_torch.models import query3d as tq3d
from pq3d_tpu_torch.ops import device_maps as tdm
from pq3d_tpu_torch.ops import kernel_maps as tkm
from pq3d_tpu_torch.ops import zrun_conv as tzr
from pq3d_tpu_torch.serve import InstSegServer, to_device
from pq3d_tpu_torch.utils.weights import load_flax_variables

from test_torch_model import TOL, _models, _random_variables, _rel
from test_torch_pipeline import _assert_same

torch.set_num_threads(1)
CPU = torch.device("cpu")
CAPS = (512, 256, 128, 64, 64)


def _scene_coords(seed, extent=40, n_pts=3000, offset=(0, 0, 0)):
    """Unique voxel coords in the lexicographic order voxelize.quantize
    gives."""
    rng = np.random.default_rng(seed)
    coords = np.unique(rng.integers(0, extent, (n_pts, 3)).astype(np.int32),
                       axis=0) + np.asarray(offset, np.int32)
    key = ((coords[:, 0].astype(np.int64) + 2048) * 8192
           + coords[:, 1] + 2048) * 8192 + coords[:, 2] + 2048
    return coords[np.argsort(key)]


SCENES = {"sparse": dict(seed=0),
          "dense": dict(seed=1, extent=16, n_pts=2500),
          "negative_origin": dict(seed=2, extent=36, n_pts=2000,
                                  offset=(-23, -5, -41))}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_device_hierarchy_matches_jax_and_host(name):
    coords = _scene_coords(**SCENES[name])
    host_j = jkm.build_hierarchy(coords, bucket=64, build_nbr5=False)
    host_t = tkm.build_hierarchy(coords, bucket=64)
    caps = list(host_j.pad_sizes)
    assert caps == host_t.pad_sizes
    biased, base = tdm.bias_coords_16(coords)
    assert (biased >= 0).all() and (base % 16 == 0).all()
    np.testing.assert_array_equal(biased, jdm.bias_coords_16(coords)[0])
    c0 = tkm.pad_rows(biased, caps[0])
    got = tdm.build_device_hierarchy(torch.from_numpy(c0)[None],
                                     torch.tensor([len(coords)]), caps)
    got = {k: v[0].numpy() for k, v in got.items()}
    ref = jax.jit(lambda c, n: jdm.build_device_hierarchy(
        c, n, tuple(caps), build_nbr5=False))(jnp.asarray(c0),
                                               jnp.int32(len(coords)))
    want = host_j.device_arrays()
    for k, v in want.items():
        _assert_same(v, got[k], k)
    for l in range(tkm.NUM_LEVELS):
        assert got[f"n_{l}"] == host_j.num_voxels[l] == host_t.num_voxels[l]
        _assert_same(np.asarray(ref[f"coords_{l}"]), got[f"coords_{l}"],
                     f"coords_{l}")
        _assert_same(host_t.nbr3[l], got[f"nbr3_{l}"], f"nbr3_{l}")
    for k in ref:
        if k != "nbr5_0":
            np.testing.assert_array_equal(np.asarray(ref[k]), got[k], k)


def test_device_hierarchy_batch_of_two():
    """Two scenes of different counts at one set of caps (the serving
    shape): each equals its own host build."""
    a = _scene_coords(3, extent=30, n_pts=1800, offset=(-7, 3, -16))
    b = _scene_coords(4, extent=44, n_pts=2600)
    hosts = [tkm.build_hierarchy(c, bucket=64) for c in (a, b)]
    caps = [max(x, y) for x, y in zip(*(h.pad_sizes for h in hosts))]
    c0 = np.stack([tkm.pad_rows(tdm.bias_coords_16(c)[0], caps[0])
                   for c in (a, b)])
    got = tdm.build_device_hierarchy(torch.from_numpy(c0),
                                     torch.tensor([len(a), len(b)]), caps)
    for i, c in enumerate((a, b)):
        want = jkm.build_hierarchy(c, pad_sizes=caps,
                                   build_nbr5=False).device_arrays()
        for k, v in want.items():
            _assert_same(v, got[k][i].numpy(), f"{k}[{i}]")


@pytest.mark.parametrize("name", ["sparse", "negative_origin"])
def test_device_stem_pack_matches_host(name):
    coords = _scene_coords(**SCENES[name])
    biased = tdm.bias_coords_16(coords)[0]
    pack = jwm.build_window_pack(coords, 8, 0, with_neighbors=True)
    nb_cap = -(-int(pack["n_win"]) // 64) * 64
    cap0 = -(-len(coords) // 256) * 256
    c0 = tkm.pad_rows(biased, cap0)
    got = tdm.build_device_stem_pack(torch.from_numpy(c0)[None],
                                     torch.tensor([len(coords)]), nb_cap)
    got = {k: v[0].numpy() for k, v in got.items()}
    ref = jdm.build_device_stem_pack(jnp.asarray(c0),
                                     jnp.int32(len(coords)), cap0, nb_cap)
    for k in got:
        np.testing.assert_array_equal(np.asarray(ref[k]), got[k], k)
    nw = int(pack["n_win"])
    assert got["n_win"] == nw
    np.testing.assert_array_equal(got["vox_slot"][:len(coords)],
                                  pack["vox_slot"])
    assert (got["vox_slot"][len(coords):] == -1).all()
    np.testing.assert_array_equal(got["nbr_win"][:nw], pack["nbr_win"])
    np.testing.assert_array_equal(
        got["cell_to_vox"][:len(pack["cell_to_vox"])], pack["cell_to_vox"])


def test_ztriple_plan_three_ways():
    """build_ztriple_plan (host, numpy) == zrun_conv.zrun_plan (device,
    also over a batch dim) == both of JAX's, on maps with pads."""
    h = tkm.build_hierarchy(_scene_coords(5), bucket=256)
    nbrs = [h.nbr3[l] for l in range(3)]
    for nbr in nbrs:
        base, code = tkm.build_ztriple_plan(nbr)
        jb, jc = jkm.build_ztriple_plan(nbr)
        _assert_same(jb, base, "base")
        _assert_same(jc, code, "code")
        db, dc = device_zrun_plan(jnp.asarray(nbr))
        _assert_same(np.asarray(db), base, "jax device base")
        _assert_same(np.asarray(dc), code, "jax device code")
        tb, tc = tzr.zrun_plan(torch.from_numpy(nbr))
        _assert_same(tb.numpy(), base, "port base")
        _assert_same(tc.numpy(), code, "port code")
    stacked = np.stack([nbrs[1], nbrs[1][::-1].copy()])
    tb, tc = tzr.zrun_plan(torch.from_numpy(stacked))
    for i in range(2):
        base, code = tkm.build_ztriple_plan(stacked[i])
        _assert_same(base, tb[i].numpy(), "batched base")
        _assert_same(code, tc[i].numpy(), "batched code")


def _scenes(seed, sizes=(700, 900)):
    rng = np.random.default_rng(seed)
    scenes = [jsyn.make_scene(rng, n_points=n, n_instances=4, n_segments=20)
              for n in sizes]
    for s in scenes:
        s["inst_labels"] = np.minimum(s["inst_labels"], 19)
    return scenes


KW = dict(voxel_size=0.15, num_queries=8, max_segments=32, max_instances=8,
          voxel_bucket=256, use_aug=False, stem_mode="dense_block",
          level_caps=CAPS)


def _dev_batches(seed=0):
    """(JAX batch, port batch, port host-maps batch) of the same scenes."""
    scenes = _scenes(3)
    bj = jpipe.make_batch([dict(s) for s in scenes],
                          jpipe.InstSegPipelineConfig(device_maps=True, **KW),
                          np.random.default_rng(seed), train=False)
    bt = tpipe.make_batch([dict(s) for s in scenes],
                          tpipe.InstSegPipelineConfig(device_maps=True, **KW),
                          np.random.default_rng(seed))
    bh = tpipe.make_batch([dict(s) for s in scenes],
                          tpipe.InstSegPipelineConfig(**KW),
                          np.random.default_rng(seed))
    return bj, bt, bh


def test_device_maps_batch_bit_identical():
    bj, bt, bh = _dev_batches()
    assert bt["maps"] == {} and bt["vox_coords"].shape == (2, CAPS[0], 3)
    _assert_same(bj, bt)
    for k in ("voxel_feats", "voxel2segment", "query_locs", "seg_center"):
        _assert_same(bh[k], bt[k], k)


@pytest.mark.parametrize("ztriple", [False, True])
def test_batch_maps_equal_host_and_jax(ztriple):
    """build_batch_maps on the device batch == the host collate's maps
    (with ztriple_conv's plans when asked) == JAX's build_batch_maps."""
    bj, bt, _ = _dev_batches()
    host = tpipe.make_batch(
        [dict(s) for s in _scenes(3)],
        tpipe.InstSegPipelineConfig(ztriple_conv=ztriple, **KW),
        np.random.default_rng(0))["maps"]
    t = to_device({k: v for k, v in bt.items() if k != "_meta"}, CPU)
    got = tdm.build_batch_maps(t["vox_coords"], t["n_voxels"],
                               t["voxel_feats"], CAPS, ztriple=ztriple)
    for k, v in host.items():
        _assert_same(v, got[k].numpy(), k)
    ref = jax.jit(lambda c, n, f: jdm.build_batch_maps(
        c, n, f, CAPS, ztriple=ztriple))(
        bj["vox_coords"], bj["n_voxels"], bj["voxel_feats"])
    assert set(ref) <= set(got)
    for k, v in ref.items():
        np.testing.assert_array_equal(np.asarray(v), got[k].numpy(), k)


def _dev_models(caps, ztriple):
    jm, tm = _models(num_layers=1, num_blocks=1)
    jm = jm.clone(voxel_enc=dataclasses.replace(
        jm.voxel_enc, device_maps=caps, device_ztriple=ztriple))
    tdev = tq3d.Query3DUnified(
        memories=tm.memories, heads=tm.heads, hidden_size=tm.hidden_size,
        dim_loc=3, unified=tm.unified,
        mv_enc=tq3d.EncoderCfg(16), pc_enc=tq3d.EncoderCfg(16),
        voxel_enc=dataclasses.replace(tm.voxel_enc, device_maps=caps,
                                      device_ztriple=ztriple),
        mask_head_cfg=tq3d.MaskHeadCfg(21, (0, 2)))
    return jm, tm, tdev


def _with_features(b, n=2):
    b = {k: v for k, v in b.items() if k != "_meta"}
    rng = np.random.default_rng(9)
    for name in ("mv", "pc"):
        b[f"{name}_seg_fts"] = rng.standard_normal((n, 32, 16)).astype(
            np.float32)
        b[f"{name}_seg_pad_masks"] = b["seg_pad_masks"]
    return b


@pytest.mark.parametrize("ztriple", [False, True])
def test_dev_maps_forward_matches_jax_and_host_maps(ztriple):
    bj, bt, bh = _dev_batches()
    bj, bt, bh = _with_features(bj), _with_features(bt), _with_features(bh)
    jm, tm, tdev = _dev_models(CAPS, ztriple)
    variables = _random_variables(lambda: jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        jax.tree_util.tree_map(jnp.asarray, bj), train=False))
    out_j = jax.jit(lambda v, b: jm.apply(v, b, train=False))(
        variables, jax.tree_util.tree_map(jnp.asarray, bj))
    for m in (tm, tdev):
        load_flax_variables(m, variables)
        m.eval()
    with torch.inference_mode():
        out_t = tdev(to_device(bt, CPU))
        out_h = tm(to_device(bh, CPU))
    seg_valid = bt["seg_pad_masks"][:, :, None]
    for r in range(len(out_j["predictions_class"])):
        cj = np.asarray(out_j["predictions_class"][r])[..., 3:]
        mj = np.asarray(out_j["predictions_mask"][r])
        mt = out_t["predictions_mask"][r].numpy()
        valid = np.broadcast_to(seg_valid, mj.shape)
        assert _rel(cj, out_t["predictions_class"][r].numpy()[..., 3:]) \
            <= TOL, r
        assert _rel(mj[valid], mt[valid]) <= TOL, r
        for key in ("predictions_class", "predictions_mask"):
            assert _rel(out_h[key][r].numpy(), out_t[key][r].numpy()) \
                <= 1e-5, (key, r)


def test_dev_maps_model_refuses_a_host_maps_batch():
    _, _, bh = _dev_batches()
    _, _, tdev = _dev_models(CAPS, False)
    with pytest.raises(ValueError, match="vox_coords"):
        tdev(to_device(_with_features(bh), CPU))


def _pipe(**kw):
    return tpipe.InstSegPipelineConfig(**{**KW, **kw})


def test_server_device_maps_mismatch_refused():
    _, tm, tdev = _dev_models(CAPS, False)
    with pytest.raises(ValueError, match="device_maps"):
        InstSegServer(tm, _pipe(device_maps=True), batch_size=2,
                      num_classes=20, device="cpu")
    with pytest.raises(ValueError, match="device_maps"):
        InstSegServer(tdev, _pipe(), batch_size=2, num_classes=20,
                      device="cpu")
    _, _, other = _dev_models((512, 256, 128, 128, 64), False)
    with pytest.raises(ValueError, match="device_maps"):
        InstSegServer(other, _pipe(device_maps=True), batch_size=2,
                      num_classes=20, device="cpu")


def test_layout_config_refusals():
    _, tm, _ = _dev_models(CAPS, False)
    with pytest.raises(ValueError, match="level_caps"):
        InstSegServer(tm, _pipe(level_caps=None), batch_size=2,
                      num_classes=20, device="cpu")
    with pytest.raises(ValueError, match="level_caps"):
        _pipe(level_caps=None, device_maps=True)
    # the flat device maps need a complete lock (the JAX package's refusal)
    with pytest.raises(ValueError, match="flat_shape_caps"):
        _pipe(device_maps=True, flat_pack=True)
    with pytest.raises(ValueError, match="stem_block_cap"):
        _pipe(device_maps=True, stem_block_cap=256)
    srv = InstSegServer(tm, _pipe(level_caps=None, flat_pack=True),
                        batch_size=2, num_classes=20, device="cpu")
    srv.close()


@pytest.mark.parametrize("layout", ["rect", "dev_maps", "flat_zt"])
def test_serving_config_and_training_refusal(layout, monkeypatch):
    """serving_config sets the layout up (model caps == level_caps under
    dev_maps, also after a level_caps override); the trainer takes
    dev_maps and flat_zt (as far as the model build; dev_maps was refused
    until the port trained it)."""
    from pq3d_tpu_torch import run
    from pq3d_tpu_torch.config import serving_config
    caps = [1024, 512, 256, 128, 64]
    cfg = serving_config(layout, [f"data.instseg_options.level_caps="
                                  f"{caps}"])
    pipe = tpipe.pipeline_config(cfg["data"]["instseg_options"])
    args = cfg["model"]["voxel_encoder"]["args"]
    assert args["pallas_conv"] is True
    assert pipe.device_maps == (layout == "dev_maps")
    assert pipe.flat_pack == pipe.ztriple_conv == (layout == "flat_zt")
    assert args.get("device_maps") == (caps if layout == "dev_maps"
                                       else None)
    assert bool(args.get("device_ztriple")) == (layout == "dev_maps")
    if layout == "rect":
        return
    cfg["device"] = "cpu"

    class Built(Exception):
        pass

    def build_model(cfg, device, seed):
        raise Built
    cfg["data"].update(train=["SyntheticInstSeg"], val=["SyntheticInstSeg"])
    monkeypatch.setattr(tq3d, "build_model", build_model)
    with pytest.raises(Built):
        run.build_instseg_trainer(cfg)


@pytest.mark.parametrize("override", [
    "model.voxel_encoder.args.device_stem=gathered",
    "model.voxel_encoder.args.device_stem_blocks=512"])
def test_build_model_refuses_other_device_stems(override):
    """A device stem the port does not build is refused by build_model, and
    so is a stem block cap other than the one the host's overflow count
    uses (``ops/device_maps.stem_cap``)."""
    from pq3d_tpu_torch.config import serving_config
    cfg = serving_config("dev_maps", [override])
    with pytest.raises(NotImplementedError, match="stem"):
        tq3d.build_model(cfg, device="cpu")


def test_device_map_counts_match_the_host():
    """The host's count of what the device build finds: the host
    hierarchy's voxels per level and the stem pack's occupied blocks."""
    cfg = _pipe()
    rng = np.random.default_rng(0)
    for s in _scenes(3) + [_sparse_scene()]:
        p = tpipe.process_scene(dict(s), cfg, rng)
        counts, nw = tpipe.device_map_counts(
            tdm.bias_coords_16(p["vox_coords"])[0], cfg.stem_block)
        assert counts == list(p["hierarchy"].num_voxels)
        assert nw == jwm.build_window_pack(p["vox_coords"], 8, 0)["n_win"]


def _sparse_scene():
    """450 points strewn over a 200 m square: more occupied 8^3 stem
    blocks than bucket(512 // 16) = 256, with fewer than 512 voxels at
    every level."""
    rng = np.random.default_rng(5)
    s = jsyn.make_scene(rng, n_points=450, n_instances=4, n_segments=20)
    s["points"] = (rng.random((len(s["points"]), 3))
                   * [200.0, 200.0, 1.0]).astype(np.float32)
    s["inst_labels"] = np.minimum(s["inst_labels"], 19)
    return s


def _outgrowing(where):
    """(scenes, caps): scenes that outgrow one cap of ``caps``, the
    others holding them."""
    if where == "stem":
        return [_sparse_scene()], (512,) * 5
    scenes = _scenes(3)
    cfg = _pipe()
    rng = np.random.default_rng(0)
    most = np.max([tpipe.process_scene(dict(s), cfg, rng)[
        "hierarchy"].num_voxels for s in scenes], 0)
    lvl = int(where[-1])
    caps = list(CAPS)
    caps[lvl] = int(most[lvl]) - 1
    return scenes, tuple(caps)


@pytest.mark.parametrize("where", ["level_0", "level_2", "level_4", "stem"])
def test_device_maps_collate_refuses_a_scene_past_its_caps(where):
    """Maps built on the device have the caps' static shapes: a scene that
    outgrows one (where the host maps would bucket-pad) is refused, not
    served with indices into the next scene."""
    scenes, caps = _outgrowing(where)
    cfg = _pipe(level_caps=caps, device_maps=True)
    with pytest.raises(ValueError, match="outgrows the device maps"):
        tpipe.make_batch([dict(s) for s in scenes], cfg,
                         np.random.default_rng(0))


def test_dev_maps_server_fails_a_scene_past_its_caps():
    """Through the server the refusal reaches the request's future."""
    scenes, caps = _outgrowing("level_4")
    _, _, tdev = _dev_models(caps, True)
    srv = InstSegServer(tdev, _pipe(level_caps=caps, device_maps=True),
                        batch_size=2, num_classes=20, device="cpu")
    try:
        fut = srv.submit(dict(scenes[1]))
        with pytest.raises(ValueError, match="outgrows the device maps"):
            fut.result(timeout=120)
    finally:
        srv.close()
