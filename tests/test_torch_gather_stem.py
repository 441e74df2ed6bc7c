"""The 125-tap gather stem (``stem_mode='gather'``, the JAX pipeline's
default) in the port, on the CPU.

- ``nbr5_0`` from ``collate``, ``collate_flat`` and the device build
  (``ops/device_maps``, run on the CPU) bit-equal to JAX's; the whole
  batch bit-identical, and the default ``stem_mode`` JAX's.
- The small Query3D with the gather stem against JAX's in the rect, flat
  and ``dev_maps`` layouts (max|diff| / max|ref| <= 2e-2, the port's model
  tolerance), and the card-built maps' forward against the host maps'
  (<= 1e-5).
- The gathered stem conv against the dense-block stem on the same weights
  in f32 (1e-5, as tests/test_dense_stem.py holds JAX's).
- conv0's weight gradient under ``scatter_free`` and ``native`` against
  JAX's (1e-4 of the scale); ``sorted_gather`` reads the stem's map
  through its monotone twin and gives the same values.
- The dense-block stem under device maps: the host's block count equals
  the pack the device builds, and a ``stem_block`` other
  than 8 is refused there.
- The serving layouts ``rect_gather`` and ``dev_gather`` and the refusals:
  gather under the flat device maps (as JAX), a model whose device stem
  is not the pipeline's.
"""
import dataclasses
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pq3d_tpu.data import instseg_pipeline as jpipe
from pq3d_tpu.models.sparse_unet import Res16UNet as JRes16UNet
from pq3d_tpu.ops import device_maps as jdm
from pq3d_tpu.ops import kernel_maps as jkm
from pq3d_tpu.ops import sparse as jsparse
from pq3d_tpu_torch.config import serving_config
from pq3d_tpu_torch.data import instseg_pipeline as tpipe
from pq3d_tpu_torch.models import query3d as tq3d
from pq3d_tpu_torch.models.sparse_unet import Res16UNet as TRes16UNet
from pq3d_tpu_torch.ops import device_maps as tdm
from pq3d_tpu_torch.ops.device_flat_maps import build_flat_maps
from pq3d_tpu_torch.ops import kernel_maps as tkm
from pq3d_tpu_torch.ops import sparse as tsparse
from pq3d_tpu_torch.ops import window_maps as twm
from pq3d_tpu_torch.serve import InstSegServer, to_device
from pq3d_tpu_torch.utils.weights import load_flax_variables

from test_torch_device_maps import _scene_coords, _with_features
from test_torch_flat_pack import _scenes
from test_torch_model import TOL, _models, _random_variables, _rel
from test_torch_pipeline import _assert_same

torch.set_num_threads(1)
CPU = torch.device("cpu")
CAPS = (512, 256, 128, 64, 64)
KW = dict(voxel_size=0.15, num_queries=8, max_segments=32, max_instances=8,
          voxel_bucket=256, use_aug=False, stem_mode="gather")


def _batches(sizes=(700, 900), seed=0, **kw):
    """(JAX, port) make_batch of the same scenes under the same options."""
    scenes = _scenes(3, sizes)
    out = []
    for pipe in (jpipe, tpipe):
        out.append(pipe.make_batch(
            [dict(s) for s in scenes],
            pipe.InstSegPipelineConfig(**{**KW, **kw}),
            np.random.default_rng(seed), train=False))
    return out


def test_default_stem_mode_is_jax_gather():
    assert tpipe.InstSegPipelineConfig().stem_mode == \
        jpipe.InstSegPipelineConfig().stem_mode == "gather"
    assert tpipe.pipeline_config({}).stem_mode == "gather"
    kw = {k: v for k, v in KW.items() if k != "stem_mode"}
    scenes = _scenes(1, (600, 500))
    bj = jpipe.make_batch([dict(s) for s in scenes],
                          jpipe.InstSegPipelineConfig(**kw),
                          np.random.default_rng(0), train=False)
    bt = tpipe.make_batch([dict(s) for s in scenes],
                          tpipe.InstSegPipelineConfig(**kw),
                          np.random.default_rng(0))
    assert "nbr5_0" in bt["maps"] and "stem_dense" not in bt["maps"]
    _assert_same(bj, bt)


@pytest.mark.parametrize("layout", ["rect", "rect_caps", "flat",
                                    "flat_k3"])
def test_collate_nbr5_bit_identical(layout):
    """The whole batch, nbr5_0 included, equals JAX's: rectangular (to
    buckets or level caps) and flat (offset by the scenes' starts), at
    conv0_kernel 5 and 3."""
    kw = {"rect": {}, "rect_caps": dict(level_caps=CAPS),
          "flat": dict(flat_pack=True),
          "flat_k3": dict(flat_pack=True, conv0_kernel=3)}[layout]
    bj, bt = _batches(**kw)
    nbr5 = bt["maps"]["nbr5_0"]
    k = 27 if layout == "flat_k3" else 125
    assert nbr5.shape[-1] == k and nbr5.dtype == np.int32
    assert "stem_dense" not in bt["maps"]
    _assert_same(bj, bt)
    if layout == "rect":
        # the native map and the numpy table's agree on a 5^3 kernel
        for i in range(nbr5.shape[0]):
            n = int(bt["maps"]["valid_0"][i].sum())
            coords = tpipe.process_scene(
                dict(_scenes(3, (700, 900))[i]),
                tpipe.InstSegPipelineConfig(**KW),
                np.random.default_rng(0))["vox_coords"]
            table = tkm.CoordTable(coords, margin=3)
            want = table.lookup_offsets(coords, tkm.kernel_offsets(5))
            np.testing.assert_array_equal(nbr5[i, :n], want)


@pytest.mark.parametrize("name", ["sparse", "dense", "negative_origin"])
def test_device_nbr5_matches_jax_and_host(name):
    from test_torch_device_maps import SCENES
    coords = _scene_coords(**SCENES[name])
    biased = tdm.bias_coords_16(coords)[0]
    cap = 4096
    c0 = np.zeros((cap, 3), np.int32)
    c0[:len(coords)] = biased
    caps = (cap,) * 5
    got = tdm.build_device_hierarchy(torch.from_numpy(c0)[None],
                                     torch.tensor([len(coords)]), caps,
                                     build_nbr5=True)["nbr5_0"][0].numpy()
    ref = jax.jit(lambda c, n: jdm.build_device_hierarchy(
        c, n, caps, build_nbr5=True))(jnp.asarray(c0),
                                      jnp.int32(len(coords)))["nbr5_0"]
    np.testing.assert_array_equal(np.asarray(ref), got)
    host = tkm.build_neighbor_map(coords, 5, n_pad=cap)
    np.testing.assert_array_equal(host, got)
    assert got.dtype == np.int32 and got.shape == (cap, 125)


def test_batch_maps_gather_equal_host_and_jax():
    """build_batch_maps with stem_mode 'gather' on the device batch gives
    the host collate's maps (nbr5_0 included, no stem pack) and JAX's."""
    scenes = _scenes(3, (700, 900))
    host = tpipe.make_batch([dict(s) for s in scenes],
                            tpipe.InstSegPipelineConfig(level_caps=CAPS, **KW),
                            np.random.default_rng(0))["maps"]
    bj, bt = _batches(level_caps=CAPS, device_maps=True)
    _assert_same({k: v for k, v in bj.items() if k != "_meta"},
                 {k: v for k, v in bt.items() if k != "_meta"})
    t = to_device({k: v for k, v in bt.items() if k != "_meta"}, CPU)
    got = tdm.build_batch_maps(t["vox_coords"], t["n_voxels"],
                               t["voxel_feats"], CAPS, stem_mode="gather")
    assert "stem_nbrblk" not in got
    for k, v in host.items():
        _assert_same(v, got[k].numpy(), k)
    ref = jax.jit(lambda c, n, f: jdm.build_batch_maps(
        c, n, f, CAPS, stem_mode="gather"))(
        jnp.asarray(bj["vox_coords"]), jnp.asarray(bj["n_voxels"]),
        jnp.asarray(bj["voxel_feats"]))
    assert set(ref) <= set(got)
    for k, v in ref.items():
        np.testing.assert_array_equal(np.asarray(v), got[k].numpy(), k)


def _gather_models(device_stem=False):
    jm, tm = _models(num_layers=1, num_blocks=1)
    if device_stem:
        jm = jm.clone(voxel_enc=dataclasses.replace(
            jm.voxel_enc, device_maps=CAPS, device_stem="gather"))
        tm = tq3d.Query3DUnified(
            memories=tm.memories, heads=tm.heads,
            hidden_size=tm.hidden_size, dim_loc=3, unified=tm.unified,
            mv_enc=tq3d.EncoderCfg(16), pc_enc=tq3d.EncoderCfg(16),
            voxel_enc=dataclasses.replace(tm.voxel_enc, device_maps=CAPS,
                                          device_stem="gather"),
            mask_head_cfg=tq3d.MaskHeadCfg(21, (0, 2)))
    return jm, tm


@pytest.fixture(scope="module")
def gather_weights():
    """JAX's weights for the small gather-stem model (conv0 (125, 3,
    32)), from the rectangular batch."""
    bj, _ = _batches(level_caps=CAPS)
    jm, _ = _gather_models()
    bj = _with_features(bj)
    variables = _random_variables(lambda: jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        jax.tree_util.tree_map(jnp.asarray, bj), train=False))
    assert variables["params"]["voxel_encoder"]["backbone"]["conv0"][
        "kernel"].shape == (125, 3, 32)
    return variables


@pytest.mark.parametrize("layout", ["rect", "flat", "dev_maps"])
def test_gather_forward_matches_jax(gather_weights, layout):
    kw = {"rect": dict(level_caps=CAPS), "flat": dict(flat_pack=True),
          "dev_maps": dict(level_caps=CAPS, device_maps=True)}[layout]
    bj, bt = _batches(**kw)
    bj, bt = _with_features(bj), _with_features(bt)
    jm, tm = _gather_models(device_stem=layout == "dev_maps")
    out_j = jax.jit(lambda v, b: jm.apply(v, b, train=False))(
        gather_weights, jax.tree_util.tree_map(jnp.asarray, bj))
    load_flax_variables(tm, gather_weights)
    tm.eval()
    with torch.inference_mode():
        out_t = tm(to_device(bt, CPU))
    seg_valid = bt["seg_pad_masks"][:, :, None]
    for r in range(len(out_j["predictions_class"])):
        cj = np.asarray(out_j["predictions_class"][r])[..., 3:]
        ct = out_t["predictions_class"][r].numpy()[..., 3:]
        mj = np.asarray(out_j["predictions_mask"][r])
        mt = out_t["predictions_mask"][r].numpy()
        valid = np.broadcast_to(seg_valid, mj.shape)
        assert _rel(cj, ct) <= TOL, r
        assert _rel(mj[valid], mt[valid]) <= TOL, r
    if layout == "dev_maps":
        # the card-built maps (here on the CPU) against the host maps
        _, host = _batches(level_caps=CAPS)
        _, th = _gather_models()
        load_flax_variables(th, gather_weights)
        th.eval()
        with torch.inference_mode():
            out_h = th(to_device(_with_features(host), CPU))
        for key in ("predictions_class", "predictions_mask"):
            for r in range(len(out_h[key])):
                assert _rel(out_h[key][r].numpy(),
                            out_t[key][r].numpy()) <= 1e-5, (key, r)


@pytest.mark.parametrize("kernel", [5, 3])
def test_gathered_stem_equals_dense_block(kernel):
    """conv0 as the gathered conv over nbr5_0 and as the dense-block conv
    over the stem pack, the same weights, f32 compute: values and dW."""
    coords = _scene_coords(0, extent=30, n_pts=800)
    rng = np.random.default_rng(0)
    n, cin, cout = len(coords), 3, 16
    x = torch.from_numpy(rng.standard_normal((n, cin)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((kernel ** 3, cin, cout))
                          * 0.1).astype(np.float32)).requires_grad_()
    nbr = torch.from_numpy(tkm.build_neighbor_map(coords, kernel))
    p = twm.build_window_pack(coords, 8, 0, with_neighbors=True)
    nb = p["n_win"] + 2
    dense = np.zeros((nb * 512, cin), np.float32)
    dense[p["vox_slot"]] = x.numpy()
    nbrblk = np.full((nb, 27), -1, np.int32)
    nbrblk[:p["n_win"]] = p["nbr_win"]
    got = tsparse.conv0_dense_block(
        torch.from_numpy(dense.reshape(nb, -1)), torch.from_numpy(nbrblk),
        torch.from_numpy(p["vox_slot"]), w, kernel=kernel,
        compute_dtype=torch.float32)
    ref = tsparse.sparse_conv(x, nbr, w, compute_dtype=torch.float32)
    np.testing.assert_allclose(got.detach().numpy(), ref.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    dy = torch.from_numpy(rng.standard_normal((n, cout)).astype(np.float32))
    g_dense, = torch.autograd.grad((got * dy).sum(), w)
    g_ref, = torch.autograd.grad((ref * dy).sum(), w)
    np.testing.assert_allclose(g_dense.numpy(), g_ref.numpy(), rtol=1e-4,
                               atol=1e-4)


def _unet_batch():
    _, bt = _batches(level_caps=CAPS)
    return bt


def _in_f32(fn):
    """``fn`` with its ``compute_dtype`` argument set to f32, however the
    caller passes it."""
    sig = inspect.signature(fn)

    @functools.wraps(fn)
    def wrapped(*a, **k):
        bound = sig.bind(*a, **k)
        bound.arguments["compute_dtype"] = jnp.float32
        return fn(*bound.args, **bound.kwargs)
    return wrapped


@pytest.mark.parametrize("grad_mode", ["scatter_free", "native"])
def test_conv0_weight_grad_matches_jax(grad_mode, monkeypatch):
    """dL/d conv0.kernel of the U-Net on a gather-stem batch (eval-mode
    batch norm, L = sum(out * dy)) against JAX's under the same
    grad_mode, every conv in f32 compute on both sides (bf16 operands
    part by a rounding that 30 convs amplify to 3%); the gathered stem
    runs the flipped-tap sym conv's backward under scatter_free."""
    for fn in ("sparse_conv", "sparse_conv_sym", "sparse_conv_down",
               "sparse_conv_transpose", "sparse_conv_transpose_gf"):
        monkeypatch.setattr(jsparse, fn, _in_f32(getattr(jsparse, fn)))
    monkeypatch.setattr(tsparse, "_round", lambda t, dtype: t.float())
    b = _unet_batch()
    maps_j = jax.tree_util.tree_map(jnp.asarray, b["maps"])
    x = jnp.asarray(b["voxel_feats"])
    jmodel = JRes16UNet(grad_mode=grad_mode, out_channels=20)
    variables = _random_variables(
        lambda: jmodel.init(jax.random.key(0), x, maps_j, train=False))
    dy = np.random.default_rng(5).standard_normal(
        (x.shape[0], x.shape[1], 20)).astype(np.float32)

    def loss(params):
        out, _ = jmodel.apply({**variables, "params": params}, x, maps_j,
                              train=False)
        return jnp.sum(out * dy)
    g_j = jax.jit(jax.grad(loss))(variables["params"])["conv0"]["kernel"]

    tmodel = TRes16UNet(grad_mode=grad_mode, out_channels=20).eval()
    load_flax_variables(tmodel, variables)
    calls = []
    orig = tsparse.sparse_conv_sym
    monkeypatch.setattr(tsparse, "sparse_conv_sym",
                        lambda x, nbr, *a, **k: calls.append(nbr.shape[1])
                        or orig(x, nbr, *a, **k))
    out, _ = tmodel(torch.from_numpy(b["voxel_feats"]),
                    to_device(b["maps"], CPU))
    (out * torch.from_numpy(dy)).sum().backward()
    assert (125 in calls) == (grad_mode == "scatter_free")
    g_t = tmodel.conv0.kernel.grad.numpy()
    assert _rel(np.asarray(g_j), g_t) <= 1e-4


def test_sorted_gather_with_gather_stem(monkeypatch):
    """sorted_gather reads nbr5_0 through its monotone map: the same
    output and conv0 gradient as the default gathers."""
    b = _unet_batch()
    torch.manual_seed(0)
    model = TRes16UNet(out_channels=20).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0, 0.1)
    seen = []
    orig = tsparse.sorted_conv_maps
    monkeypatch.setattr(tsparse, "sorted_conv_maps",
                        lambda nbr: seen.append(nbr.shape[1]) or orig(nbr))
    runs = []
    for sg in (False, True):
        model.sorted_gather = sg
        model.zero_grad()
        out, _ = model(torch.from_numpy(b["voxel_feats"]),
                       to_device(b["maps"], CPU))
        out.square().sum().backward()
        runs.append((out.detach(), model.conv0.kernel.grad.clone()))
    assert 125 in seen
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


def test_device_stem_block_count_matches_the_pack():
    """Under device maps the host counts the 8^3 blocks that
    the device packs, scene by scene; a stem_block the device does not
    pack is refused there, and a scene past the block cap is refused by
    collate."""
    for seed, extent, n_pts in ((0, 40, 3000), (1, 16, 2500), (3, 200, 450)):
        coords = _scene_coords(seed, extent=extent, n_pts=n_pts)
        biased = tdm.bias_coords_16(coords)[0]
        c0 = np.zeros((4096, 3), np.int32)
        c0[:len(coords)] = biased
        pack = tdm.build_device_stem_pack(
            torch.from_numpy(c0)[None], torch.tensor([len(coords)]),
            nb_cap=1024)
        _, nw = tpipe.device_map_counts(biased, 8)
        assert nw == int(pack["n_win"][0])
    dense = dict(KW, stem_mode="dense_block", level_caps=CAPS)
    with pytest.raises(ValueError, match="stem_block"):
        tpipe.InstSegPipelineConfig(device_maps=True, stem_block=16,
                                    **dense)
    tpipe.InstSegPipelineConfig(device_maps=True, stem_block=16,
                                **dict(KW, level_caps=CAPS))
    tpipe.InstSegPipelineConfig(stem_block=16, **dense)
    # 450 points strewn over 30 m: more occupied blocks than the cap
    # bucket(512 // 16) = 256 allows, refused for the dense block alone
    rng = np.random.default_rng(0)
    far = _scenes(3, (700,))[0]
    far["points"] = rng.uniform(0, 30, far["points"].shape).astype(
        np.float32)
    cfg = tpipe.InstSegPipelineConfig(device_maps=True, **dict(
        dense, level_caps=(4096, 4096, 4096, 4096, 4096)))
    with pytest.raises(ValueError, match="stem blocks"):
        tpipe.make_batch([dict(far)], cfg, np.random.default_rng(0))
    tpipe.make_batch([dict(far)], dataclasses.replace(
        cfg, stem_mode="gather"), np.random.default_rng(0))


def test_gather_refused_with_flat_device_maps():
    with pytest.raises(ValueError, match="gather"):
        tpipe.InstSegPipelineConfig(device_maps=True, flat_pack=True,
                                    flat_shape_caps={"tot_0": 4096}, **KW)
    with pytest.raises(NotImplementedError, match="gather"):
        build_flat_maps(torch.zeros(8, 3, dtype=torch.int32),
                        torch.tensor([8]), {"tot_0": 8}, stem_mode="gather")


SMALL = ["model.hidden_size=32",
         "model.unified_encoder.args.num_attention_heads=4",
         "model.unified_encoder.args.num_layers=1",
         "model.unified_encoder.args.num_blocks=1",
         "data.instseg_options.voxel_size=0.15",
         f"data.instseg_options.level_caps={list(CAPS)}",
         "data.instseg_options.voxel_bucket=256",
         "data.instseg_options.num_queries=8",
         "data.instseg_options.max_segments=32",
         "data.instseg_options.max_instances=8",
         "model.voxel_encoder.args.backbone_kwargs.out_channels=20",
         "model.mask_head.args.num_targets=21"]


@pytest.mark.parametrize("layout", ["rect_gather", "dev_gather"])
def test_gather_serving_layouts(layout):
    """serving_config sets the gather layouts up, InstSegServer serves
    them, and the two layouts' answers agree; a model whose device stem
    is not the pipeline's is refused."""
    cfg = serving_config(layout, SMALL)
    pipe = tpipe.pipeline_config(cfg["data"]["instseg_options"])
    assert pipe.stem_mode == "gather"
    model = tq3d.build_model(cfg, device="cpu", seed=0)
    assert model.voxel_encoder.backbone.conv0.kernel.shape[0] == 125
    assert (model.voxel_enc.device_stem == "gather") == \
        (layout == "dev_gather")
    scenes = _scenes(4, (700, 900, 800))
    srv = InstSegServer(model, pipe, batch_size=2, num_classes=21, topk=10,
                        max_delay_s=0.01,
                        extra_features={"mv": 768, "pc": 768}, device="cpu")
    try:
        answers = [f.result(timeout=300)
                   for f in [srv.submit(s) for s in scenes]]
    finally:
        srv.close()
    for s, preds in zip(scenes, answers):
        assert isinstance(preds, list)
        for p in preds:
            assert p["mask"].shape == (len(s["points"]),)
    if layout == "dev_gather":
        dense = dataclasses.replace(pipe, stem_mode="dense_block")
        with pytest.raises(ValueError, match="device stem"):
            InstSegServer(model, dense, batch_size=2, num_classes=21,
                          device="cpu")
