"""Query3DUnified with the Swin3D backbone against the JAX package's, on
the CPU, from one set of weights moved by ``utils/weights``.

Both packages' ``Swin3DUNet`` run at the small widths of
tests/test_swin3d.py (patched into each package's module for this file),
so the model stays small: hidden 32, one decoder layer with the
self-mask, hlevels (0, 1).

- the rectangular, flat and device-flat layouts against JAX within
  ``test_torch_model``'s tolerance (2e-2 of each round's scale, no
  self-mask attend bit differing); the device-flat port (flat maps built
  in the forward, ``ops/device_flat_maps``) runs against JAX's host-flat
  forward, and against the port's own host-flat forward within 1e-5;
- the stage-1 bf16 cast (``cast_model_bf16`` + ``cast_batch_bf16``)
  against JAX's (``cast_params_bf16`` + ``cast_batch_bf16``) in
  ``flat_swin`` and in ``flat_zt`` (the Res16UNet with the z-run gather
  conv), with tests/test_bf16_modes.py's gate: class and mask logits
  within 0.1 of the scale, top-1 equal where the top-2 margin exceeds
  0.03 of it.  (Against f32 the cast is farther off here: XLA rounds the
  bf16 sigmoid of the self-mask op by op, which flips attend bits near
  0, and the port does the same, ``models/heads._sigmoid``);
- ``InstSegServer`` serves ``flat_swin``, ``dev_flat_swin`` (equal to
  ``flat_swin`` within 1e-5), ``dev_flat_zt`` (equal to ``flat_zt``) and
  ``flat_swin_bf16`` / ``flat_zt_bf16`` (equal to the cast model's
  forward of the cast batch), and refuses a swin window the pipeline does
  not share, a device lock the model does not share, and a model with
  device maps behind host maps.
"""
import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pq3d_tpu.data import instseg_pipeline as jpipe
from pq3d_tpu.data import synthetic as jsyn
from pq3d_tpu.models import query3d as jq3d
from pq3d_tpu.models import swin3d as jswin
from pq3d_tpu.utils.inference import cast_batch_bf16 as jcast_batch
from pq3d_tpu.utils.inference import cast_params_bf16
from pq3d_tpu_torch.data import instseg_pipeline as tpipe
from pq3d_tpu_torch.models import query3d as tq3d
from pq3d_tpu_torch.models import swin3d as tswin
from pq3d_tpu_torch.serve import InstSegServer, to_device
from pq3d_tpu_torch.utils.inference import cast_batch_bf16, cast_model_bf16
from pq3d_tpu_torch.utils.weights import load_flax_variables

from test_torch_device_flat_maps import flat_caps
from test_torch_model import TOL, _models, _random_variables, _rel

torch.set_num_threads(1)
CPU = torch.device("cpu")
KW = dict(voxel_size=0.15, num_queries=8, max_segments=32, max_instances=8,
          voxel_bucket=128, use_aug=False)
SWIN = dict(stem_mode="none", swin_window=4)
SMALL = dict(channels=(8, 16, 24, 32), depths=(1, 1, 2, 1),
             num_heads=(2, 2, 2, 2), stem_dim=8)


class _JSmallSwin(jswin.Swin3DUNet):
    channels: Sequence[int] = SMALL["channels"]
    depths: Sequence[int] = SMALL["depths"]
    num_heads: Sequence[int] = SMALL["num_heads"]
    stem_dim: int = SMALL["stem_dim"]


class _TSmallSwin(tswin.Swin3DUNet):
    def __init__(self, **kw):
        super().__init__(**{**SMALL, **kw})


@pytest.fixture(scope="module", autouse=True)
def small_swin():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jswin, "Swin3DUNet", _JSmallSwin)
        mp.setattr(tswin, "Swin3DUNet", _TSmallSwin)
        yield


def _scenes(seed=7, sizes=(700, 1000)):
    scenes = [jsyn.make_scene(np.random.default_rng(seed + i), n_points=n,
                              n_instances=4, n_segments=20)
              for i, n in enumerate(sizes)]
    for s in scenes:
        s["inst_labels"] = np.minimum(s["inst_labels"], 19)
    return scenes


def _features(b):
    b = {k: v for k, v in b.items() if k != "_meta"}
    r = np.random.default_rng(5)
    for name in ("mv", "pc"):
        b[f"{name}_seg_fts"] = r.standard_normal(
            b["seg_pad_masks"].shape + (16,)).astype(np.float32)
        b[f"{name}_seg_pad_masks"] = b["seg_pad_masks"]
    return b


def _batch(pipe, **kw):
    return pipe.make_batch([dict(s) for s in _scenes()],
                           pipe.InstSegPipelineConfig(**KW, **kw),
                           np.random.default_rng(1), train=False)


def _swin_models(lock=None):
    kw = dict(memories=("voxel", "mv", "pc"), heads=("mask",),
              hidden_size=32, dim_loc=3)
    jm = jq3d.Query3DUnified(
        unified=jq3d.UnifiedEncoderCfg(
            num_layers=1, num_blocks=1, num_attention_heads=4,
            structure="parallel", spatial_selfattn=True, use_self_mask=True),
        mv_enc=jq3d.EncoderCfg(input_feat_size=16),
        pc_enc=jq3d.EncoderCfg(input_feat_size=16),
        voxel_enc=jq3d.VoxelEncoderCfg(hlevels=(0, 1), out_channels=20,
                                       backbone="swin3d"),
        mask_head_cfg=jq3d.MaskHeadCfg(num_targets=21,
                                       filter_out_classes=(0, 2)), **kw)
    tm = tq3d.Query3DUnified(
        unified=tq3d.UnifiedEncoderCfg(
            num_layers=1, num_blocks=1, num_attention_heads=4,
            structure="parallel", spatial_selfattn=True, use_self_mask=True),
        mv_enc=tq3d.EncoderCfg(16), pc_enc=tq3d.EncoderCfg(16),
        voxel_enc=tq3d.VoxelEncoderCfg(
            hlevels=(0, 1), out_channels=20, backbone="swin3d",
            device_flat_caps=(tuple(sorted(lock.items())) if lock
                              else None)),
        mask_head_cfg=tq3d.MaskHeadCfg(21, (0, 2)), **kw)
    return jm, tm.eval()


def _jax_forward(jm, variables, b):
    out = jax.jit(lambda v, b: jm.apply(v, b, train=False))(
        variables, jax.tree.map(jnp.asarray, b))
    return {k: [np.asarray(x, np.float32) for x in out[k]]
            for k in ("predictions_class", "predictions_mask")}


def _port_forward(tm, b):
    with torch.inference_mode():
        out = tm(to_device(b, CPU))
    return {k: [x.float().numpy() for x in out[k]]
            for k in ("predictions_class", "predictions_mask")}


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's weights and its f32 and bf16-cast outputs in the rectangular
    and the flat swin layout (the same scenes and queries)."""
    jm, _ = _swin_models()
    batches = {"rect": _features(_batch(jpipe, level_caps=[512, 256, 128,
                                                           128, 128],
                                        **SWIN)),
               "flat": _features(_batch(jpipe, flat_pack=True, **SWIN))}
    variables = _random_variables(lambda: jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        jax.tree.map(jnp.asarray, batches["flat"]), train=False))
    out = {lay: _jax_forward(jm, variables, b) for lay, b in batches.items()}
    out["flat_bf16"] = _jax_forward(jm, cast_params_bf16(variables),
                                    jcast_batch(batches["flat"]))
    return variables, out


def _assert_close(want, got, seg_valid, tol):
    keep = np.ones(want["predictions_class"][0].shape[-1], bool)
    keep[[0, 2]] = False             # filtered classes are -1e9 on both
    for r, (mj, mt) in enumerate(zip(want["predictions_mask"],
                                     got["predictions_mask"])):
        valid = np.broadcast_to(seg_valid[:, :, None], mj.shape)
        assert ((mj >= 0) != (mt >= 0))[valid].sum() == 0, r
        assert _rel(mj[valid], mt[valid]) <= tol, r
        assert _rel(want["predictions_class"][r][..., keep],
                    got["predictions_class"][r][..., keep]) <= tol, r


@pytest.mark.parametrize("layout", ["rect", "flat", "dev_flat"])
def test_swin_model_matches_jax(jax_runs, layout):
    variables, jout = jax_runs
    kw = dict(SWIN, flat_pack=layout != "rect")
    if layout == "rect":
        kw["level_caps"] = [512, 256, 128, 128, 128]
    host = _batch(tpipe, **kw)
    caps = flat_caps(host["maps"]) if layout == "dev_flat" else None
    _, tm = _swin_models(caps)
    load_flax_variables(tm, variables)
    b = host
    if caps:
        b = _batch(tpipe, device_maps=True, flat_shape_caps=caps, **kw)
        assert b["vox_coords"].ndim == 2 and not b["maps"]
    got = _port_forward(tm, _features(b))
    seg_valid = host["seg_pad_masks"]
    _assert_close(jout["rect" if layout == "rect" else "flat"], got,
                  seg_valid, TOL)
    if caps:
        _, hm = _swin_models()
        load_flax_variables(hm, variables)
        _assert_close(_port_forward(hm, _features(host)), got, seg_valid,
                      1e-5)


def _bf16_gate(ref, got, seg_valid):
    """tests/test_bf16_modes.py's gate on the final round, on the logits
    that are not masked out (the filtered classes are -1e9, the padded
    segments -1e6: as scales they would pass anything)."""
    c = ref["predictions_class"][-1][..., 3:]
    cb = got["predictions_class"][-1][..., 3:]
    scale = np.abs(c).max() + 1e-6
    assert np.abs(c - cb).max() / scale < 0.1
    srt = np.sort(c, -1)
    decided = (srt[..., -1] - srt[..., -2]) / scale > 0.03
    assert (c.argmax(-1) == cb.argmax(-1))[decided].all()
    m, mb = ref["predictions_mask"][-1], got["predictions_mask"][-1]
    valid = np.broadcast_to(seg_valid[:, :, None], m.shape)
    assert np.abs(m - mb)[valid].max() / (np.abs(m[valid]).max() + 1e-6) \
        < 0.1


def test_swin_bf16_cast_matches_jax_cast(jax_runs):
    variables, jout = jax_runs
    b = _batch(tpipe, flat_pack=True, **SWIN)
    _, tm = _swin_models()
    load_flax_variables(tm, variables)
    cast_model_bf16(tm)
    with torch.inference_mode():
        out = tm(cast_batch_bf16(to_device(_features(b), CPU)))
    assert out["predictions_class"][-1].dtype == torch.float32
    got = {k: [x.float().numpy() for x in out[k]]
           for k in ("predictions_class", "predictions_mask")}
    _bf16_gate(jout["flat_bf16"], got, b["seg_pad_masks"])


def test_flat_zt_bf16_cast_matches_jax_cast():
    kw = dict(stem_mode="dense_block", flat_pack=True, ztriple_conv=True)
    bj = _features(_batch(jpipe, **kw))
    bt = _features(_batch(tpipe, **kw))
    jm, tm = _models(num_layers=1, num_blocks=1)
    variables = _random_variables(lambda: jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        jax.tree.map(jnp.asarray, bj), train=False))
    want = _jax_forward(jm, cast_params_bf16(variables), jcast_batch(bj))
    load_flax_variables(tm, variables)
    cast_model_bf16(tm.eval())
    with torch.inference_mode():
        out = tm(cast_batch_bf16(to_device(bt, CPU)))
    got = {k: [x.float().numpy() for x in out[k]]
           for k in ("predictions_class", "predictions_mask")}
    _bf16_gate(want, got, bt["seg_pad_masks"])


class _Recording(InstSegServer):
    def __init__(self, *a, **k):
        self.logits, self.batches = [], []
        super().__init__(*a, **k)

    def _forward(self, batch):
        self.batches.append(batch)
        out = super()._forward(batch)
        self.logits.append(out)
        return out


def _serve(model, pipe, cast=None):
    srv = _Recording(model, pipe, batch_size=2, num_classes=20,
                     max_delay_s=1.0, extra_features={"mv": 16, "pc": 16},
                     device="cpu", cast=cast)
    try:
        results = [f.result(timeout=300) for f in
                   [srv.submit(s) for s in _scenes()]]
    finally:
        srv.close()
    assert len(srv.logits) == 1
    assert all(isinstance(r, list) for r in results)
    return srv.logits[0], srv.batches[0]


@pytest.mark.parametrize("backbone", ["swin3d", "res16unet"])
def test_server_serves_the_device_flat_layouts(jax_runs, backbone):
    """flat_swin and dev_flat_swin (swin3d), flat_zt and dev_flat_zt
    (res16unet, the z-run plans built in the forward): the device layout
    serves the host layout's logits within 1e-5; the device lock does not
    grow; the host layout behind the bf16 cast (flat_swin_bf16,
    flat_zt_bf16) serves its cast model's logits on the cast batch."""
    swin = backbone == "swin3d"
    kw = dict(SWIN) if swin else dict(stem_mode="dense_block",
                                      ztriple_conv=True)
    host_pipe = tpipe.InstSegPipelineConfig(flat_pack=True, **KW, **kw)
    caps = tpipe.device_flat_lock(_scenes(), host_pipe, 2)
    if swin:
        _, host_model = _swin_models()
        _, dev_model = _swin_models(caps)
        for m in (host_model, dev_model):
            load_flax_variables(m, jax_runs[0])
    else:
        _, host_model = _models(num_layers=1, num_blocks=1)
        tq3d.init_weights(host_model, torch.Generator().manual_seed(0))
        host_model.eval()
        dev_model = _models(num_layers=1, num_blocks=1)[1].eval()
        dev_model.voxel_enc = dataclasses.replace(
            host_model.voxel_enc,
            device_flat_caps=tuple(sorted(caps.items())),
            device_ztriple=True)
        dev_model.load_state_dict(host_model.state_dict())
    dev_pipe = dataclasses.replace(host_pipe, device_maps=True,
                                   flat_shape_caps=caps)
    host, _ = _serve(host_model, host_pipe)
    dev, _ = _serve(dev_model, dev_pipe)
    for h, d in zip(host, dev):
        assert _rel(h.numpy(), d.numpy()) <= 1e-5
    bf_model = cast_model_bf16(host_model)
    served, batch = _serve(bf_model, host_pipe, cast=cast_batch_bf16)
    with torch.inference_mode():
        out = bf_model(cast_batch_bf16(batch))
    for got, key in zip(served, ("predictions_class", "predictions_mask")):
        assert torch.equal(got, out[key][-1]), key


def test_server_pairing_checks(jax_runs):
    b = _batch(tpipe, flat_pack=True, **SWIN)
    caps = flat_caps(b["maps"])
    _, tm = _swin_models()
    _, tdev = _swin_models(caps)
    flat = tpipe.InstSegPipelineConfig(flat_pack=True, **KW, **SWIN)
    dev = dataclasses.replace(flat, device_maps=True, flat_shape_caps=caps)
    with pytest.raises(ValueError, match="swin window"):
        InstSegServer(tm, dataclasses.replace(flat, swin_window=2),
                      batch_size=2, num_classes=20, device="cpu")
    with pytest.raises(ValueError, match="device_flat_caps"):
        InstSegServer(tm, dev, batch_size=2, num_classes=20, device="cpu")
    other = dict(caps, tot_0=caps["tot_0"] * 2)
    with pytest.raises(ValueError, match="tot_0"):
        InstSegServer(tdev, dataclasses.replace(dev, flat_shape_caps=other),
                      batch_size=2, num_classes=20, device="cpu")
    with pytest.raises(ValueError, match="host maps"):
        InstSegServer(tdev, flat, batch_size=2, num_classes=20,
                      device="cpu")
    with pytest.raises(ValueError, match="flat 'vox_coords'"):
        with torch.inference_mode():
            tdev(to_device(_features(b), CPU))
