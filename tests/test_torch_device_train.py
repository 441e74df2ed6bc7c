"""Stage-1 training in the device-map layouts, on the CPU.

The layouts are ``dev_maps``, ``dev_gather``, ``dev_flat_zt`` and
``dev_flat_swin`` (``pq3d_tpu_torch/config.SERVING_LAYOUTS``): the batch
ships voxel coordinates and counts, and the model's forward builds the
kernel maps (and, in the Res16UNet layouts, the z-run plans of levels 1-3)
on the batch's device, in train mode as in eval mode.  JAX's model does
the same inside its jitted step (``pq3d_tpu/models/query3d.py``), and no
JAX test trains there, so each case first runs JAX's own train step.

For each layout, on one train-mode batch (augmented scenes, bit-identical
between the packages) with the same weights, the direct criterion, dropout
and the self-mask off and every sparse conv in f32 on both sides:

- the port's step against JAX's step in the same layout: loss within 1e-4
  relative, every gradient, normalised by the largest entry of all
  gradients, within 1e-4 (f32 sums in another order);
- the port's step against its own host-maps step on the same scenes: loss
  within 1e-5 relative, normalised gradients within 1e-5 (the same maps,
  so only the rows the device layout pads differ);
- the map build stays integer-only: no parameter of the map builders, and
  no gradient reaches ``vox_coords``.

``python -m pq3d_tpu_torch.run`` trains in each layout.  JAX's step takes
one to two minutes of XLA compile a layout on the CPU, so the layouts are
spread over three files (``test_torch_device_train{,_gather,_flat}.py``)
that pytest-xdist can run side by side.
"""
import functools
import shutil

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pq3d_tpu.data import instseg_pipeline as jpipe
from pq3d_tpu.models import query3d as jq3d
from pq3d_tpu.ops import sparse as jsparse
from pq3d_tpu.optim import losses as jlosses
from pq3d_tpu_torch.data import instseg_pipeline as tpipe
from pq3d_tpu_torch.models import query3d as tq3d
from pq3d_tpu_torch.ops import sparse as tsparse
from pq3d_tpu_torch.ops import zrun_conv as tzr
from pq3d_tpu_torch.optim import losses as tlosses
from pq3d_tpu_torch.serve import to_device
from pq3d_tpu_torch.utils.weights import load_flax_variables, torch_name

from test_torch_device_maps import _scenes
from test_torch_model import _random_variables
from test_torch_pipeline import _assert_same

torch.set_num_threads(1)
CPU = torch.device("cpu")
CAPS = (512, 256, 128, 64, 64)
KW = dict(voxel_size=0.15, num_queries=8, max_segments=32, max_instances=8,
          voxel_bucket=256, use_aug=True)
# each layout: the pipeline's options with device maps, the host-maps
# twin's, and the voxel encoder's device options
LAYOUTS = {
    "dev_maps": (dict(stem_mode="dense_block", level_caps=CAPS),
                 dict(ztriple_conv=True),
                 dict(device_maps=CAPS, device_ztriple=True)),
    "dev_gather": (dict(stem_mode="gather", level_caps=CAPS),
                   dict(ztriple_conv=True),
                   dict(device_maps=CAPS, device_ztriple=True,
                        device_stem="gather")),
    "dev_flat_zt": (dict(stem_mode="dense_block", flat_pack=True),
                    dict(ztriple_conv=True),
                    dict(device_ztriple=True)),
    "dev_flat_swin": (dict(stem_mode="none", flat_pack=True,
                           swin_window=4),
                      {}, dict(backbone="swin3d")),
}
REL_JAX = 1e-4
REL_HOST = 1e-5


def _f32_convs(monkeypatch):
    """Every sparse conv of both packages in f32 compute (bf16 gradients
    of a random-init train-mode U-Net are chaotic)."""
    for fn in ("sparse_conv_sym", "sparse_conv_down",
               "sparse_conv_transpose_gf", "conv0_dense_block",
               "sparse_conv_ztriple_sym"):
        monkeypatch.setattr(jsparse, fn, functools.partial(
            getattr(jsparse, fn), compute_dtype=jnp.float32))
    monkeypatch.setattr(tsparse, "_round", lambda t, dtype: t.float())


def _route(monkeypatch):
    """Kernel B1 (its plain version) on the 96-255-channel convs of the
    small levels, the z-run gather conv on the <= 64-channel ones of levels
    1-3 (the split the full-size levels make)."""
    monkeypatch.setattr(tzr, "MIN_ROWS", 128)
    monkeypatch.setattr(tsparse, "ztriple_applicable",
                        lambda n, cin, cout: max(cin, cout) <= 64)


def _batches(layout):
    """(JAX device batch, port device batch, port host-maps batch, the
    flat lock or None) of two augmented train scenes."""
    dev, host, _ = LAYOUTS[layout]
    scenes = _scenes(5)
    lock = None
    if dev.get("flat_pack"):
        probe = tpipe.InstSegPipelineConfig(**KW, **dev, **host)
        lock = tpipe.device_flat_lock(scenes, probe, len(scenes),
                                      margin=1.5)
        dev = dict(dev, flat_shape_caps=lock)

    def make(pkg, **opts):
        return pkg.make_batch([dict(s) for s in scenes],
                              pkg.InstSegPipelineConfig(**KW, **opts),
                              np.random.default_rng(7), train=True)
    bj = make(jpipe, device_maps=True, **dev)
    bt = make(tpipe, device_maps=True, **dev)
    bh = make(tpipe, **{k: v for k, v in dev.items()
                        if k != "flat_shape_caps"}, **host)
    return bj, bt, bh, lock


def _with_features(b):
    b = {k: v for k, v in b.items() if not k.startswith("_")}
    rng = np.random.default_rng(9)
    n = b["seg_pad_masks"].shape[0]
    for name in ("mv", "pc"):
        b[f"{name}_seg_fts"] = rng.standard_normal((n, 32, 16)).astype(
            np.float32)
        b[f"{name}_seg_pad_masks"] = b["seg_pad_masks"]
    b["instance_labels"] = (b["instance_labels"] % 17 + 3).astype(np.int32)
    return b


def _models(layout, lock):
    _, _, venc = LAYOUTS[layout]
    if lock is not None:
        venc = dict(venc, device_flat_caps=tuple(sorted(lock.items())))
    kw = dict(memories=("voxel", "mv", "pc"), heads=("mask",),
              hidden_size=32, dim_loc=3)
    unified = dict(num_layers=1, num_blocks=1, num_attention_heads=4,
                   structure="parallel", spatial_selfattn=True,
                   use_self_mask=False)
    jm = jq3d.Query3DUnified(
        unified=jq3d.UnifiedEncoderCfg(**unified),
        mv_enc=jq3d.EncoderCfg(input_feat_size=16, dropout=0.0),
        pc_enc=jq3d.EncoderCfg(input_feat_size=16, dropout=0.0),
        voxel_enc=jq3d.VoxelEncoderCfg(hlevels=(0, 1), out_channels=20,
                                       dropout=0.0, remat_policy="none",
                                       grad_mode="scatter_free", **venc),
        mask_head_cfg=jq3d.MaskHeadCfg(num_targets=21,
                                       filter_out_classes=(0, 2)), **kw)

    def port(**v):
        m = tq3d.Query3DUnified(
            unified=tq3d.UnifiedEncoderCfg(**unified),
            mv_enc=tq3d.EncoderCfg(16, dropout=0.0),
            pc_enc=tq3d.EncoderCfg(16, dropout=0.0),
            voxel_enc=tq3d.VoxelEncoderCfg(
                hlevels=(0, 1), out_channels=20, dropout=0.0,
                pallas_conv=v.get("backbone") != "swin3d", **v),
            mask_head_cfg=tq3d.MaskHeadCfg(21, (0, 2)), **kw)
        for mod in m.modules():
            if isinstance(mod, torch.nn.Dropout):
                mod.p = 0.0
        return m
    host = {k: v for k, v in venc.items() if k in ("backbone",)}
    return jm, port(**venc), port(**host)


def _port_step(model, batch):
    model.train()
    model.zero_grad(set_to_none=True)
    bt = to_device(batch, CPU)
    out = model(bt)
    total, _ = tlosses.instseg_direct_loss(
        out["predictions_class"], out["predictions_mask"], bt)
    total.backward()
    return total.item(), {n: p.grad.clone() for n, p in
                          model.named_parameters() if p.grad is not None}, bt


def _gmax(grads):
    return max(float(np.abs(np.asarray(g)).max()) for g in grads)


def check_layout_step(layout, monkeypatch):
    """The port's train step in ``layout`` against JAX's and against its
    own host-maps step (the module docstring's gates)."""
    bj_np, bt_np, bh_np, lock = _batches(layout)
    _assert_same({k: v for k, v in bj_np.items() if k != "_meta"},
                 {k: v for k, v in bt_np.items() if k != "_meta"})
    assert bt_np["maps"] == {} and "vox_coords" in bt_np
    bj, bt, bh = (_with_features(b) for b in (bj_np, bt_np, bh_np))
    jm, tdev, thost = _models(layout, lock)
    jb = jax.tree_util.tree_map(jnp.asarray, bj)
    variables = _random_variables(lambda: jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, jb,
        train=False))
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)
    _f32_convs(monkeypatch)

    # JAX's own step in this layout: the maps built inside the jit
    def loss_j(params):
        out, _ = jm.apply(
            {"params": params, "batch_stats": variables["batch_stats"],
             "buffers": variables["buffers"]}, jb, train=True,
            mutable=["batch_stats"])
        total, _ = jlosses.instseg_direct_loss(
            out["predictions_class"], out["predictions_mask"], jb)
        return total
    total_j, grads_j = jax.jit(jax.value_and_grad(loss_j))(
        variables["params"])
    total_j = float(total_j)
    assert np.isfinite(total_j)

    _route(monkeypatch)
    for m in (tdev, thost):
        load_flax_variables(m, variables)
    routed = []
    sym = tzr.zrun_conv_sym
    monkeypatch.setattr(tzr, "zrun_conv_sym", lambda *a, **k: (
        routed.append(a[0].shape) or sym(*a, **k)))
    built = []
    for mod, fn in ((tq3d.device_maps, "build_batch_maps"),
                    (tq3d.device_flat_maps, "build_flat_maps")):
        orig = getattr(mod, fn)
        monkeypatch.setattr(mod, fn, functools.partial(
            lambda orig, *a, **k: built.append(orig(*a, **k)) or built[-1],
            orig))
    loss_h, grads_h, _ = _port_step(thost, bh)
    n_host = len(routed)
    routed.clear()
    assert not built
    loss_t, grads_t, _ = _port_step(tdev, bt)
    assert len(routed) == n_host
    if LAYOUTS[layout][2].get("backbone") != "swin3d":
        assert routed, "no conv routed to kernel B1"
    # the map build ran once, under autograd, and stays integer-only: no
    # map, plan or pack it returns carries a gradient
    assert len(built) == 1 and built[0]
    for name, t in built[0].items():
        assert not t.requires_grad and t.grad_fn is None, name

    assert abs(loss_t - total_j) <= REL_JAX * abs(total_j), (loss_t,
                                                             total_j)
    assert abs(loss_t - loss_h) <= REL_HOST * abs(loss_h), (loss_t, loss_h)
    scale_j = _gmax(jax.tree_util.tree_leaves(grads_j))
    scale_h = max(g.abs().max().item() for g in grads_h.values())
    assert set(grads_t) == set(grads_h) and len(grads_t) > 50
    checked = set()
    for path, g in jax.tree_util.tree_flatten_with_path(grads_j)[0]:
        name, ref = torch_name(tdev, tuple(p.key for p in path),
                               np.asarray(g))
        got = grads_t.get(name)
        got = np.zeros_like(ref) if got is None else got.numpy()
        err = float(np.abs(got - ref).max()) / scale_j
        assert err <= REL_JAX, (name, err)
        err_h = (grads_t[name] - grads_h[name]).abs().max().item() / scale_h \
            if name in grads_h else 0.0
        assert err_h <= REL_HOST, (name, err_h)
        checked.add(name)
    assert checked >= set(grads_t)


@pytest.mark.parametrize("layout", ["dev_maps", "dev_flat_swin"])
def test_device_map_train_step_matches_jax_and_host_maps(layout,
                                                         monkeypatch):
    check_layout_step(layout, monkeypatch)


def run_layout(tmp_path, monkeypatch, layout, epochs=1):
    """``run.main`` on the tiny stage-1 config in ``layout`` (the serving
    layout's overrides; a flat layout's lock derived from the train
    scenes by ``device_flat_lock`` on its host-maps twin, margin 1.5, and
    set as both the pipeline's ``flat_shape_caps`` and the model's
    ``device_flat_caps``): ``epochs`` one-step epochs with finite weights,
    and the maps built in the forward of every step."""
    from pq3d_tpu_torch import run as trun
    from pq3d_tpu_torch.config import LOCK_PROBE, SERVING_LAYOUTS
    from pq3d_tpu_torch.config import load_config
    from pq3d_tpu_torch.data.datasets import build_dataset
    from pq3d_tpu_torch.train.trainer import Query3DTrainer
    from test_torch_trainer import TINY
    monkeypatch.setattr(Query3DTrainer, "install_preemption_handler",
                        lambda self, signals=None: None)
    extra = list(SERVING_LAYOUTS[layout])
    if layout in LOCK_PROBE:
        probe = load_config("instseg_sceneverse",
                            TINY + list(SERVING_LAYOUTS[LOCK_PROBE[layout]]))
        ds = build_dataset(probe, "train")
        lock = tpipe.device_flat_lock(
            [ds.get_scene(i) for i in range(len(ds))],
            tpipe.pipeline_config(probe["data"]["instseg_options"]), 2,
            margin=1.5)
        caps = ", ".join(f"{k}: {v}" for k, v in sorted(lock.items()))
        extra += [f"data.instseg_options.flat_shape_caps={{{caps}}}",
                  "model.voxel_encoder.args.device_flat_caps="
                  "${data.instseg_options.flat_shape_caps}"]
    seen = []
    orig = Query3DTrainer.train_batch

    def spy(self, batch):
        seen.append((batch["maps"], batch["vox_coords"].ndim))
        return orig(self, batch)
    monkeypatch.setattr(Query3DTrainer, "train_batch", spy)
    out = tmp_path / layout
    trainer = trun.main(["--config-name", "instseg_sceneverse", *TINY,
                         *extra, f"solver.epochs={epochs}",
                         "solver.epochs_per_eval=0",
                         "solver.epochs_per_save=0", f"exp_dir={out}"])
    # a stage-1 snapshot of the tiny config is about 0.46 GB
    shutil.rmtree(out)
    assert trainer.step == epochs and trainer.tracker.epoch == epochs
    assert seen == [({}, 2 if layout in LOCK_PROBE else 3)] * epochs
    assert all(torch.isfinite(p).all() for p in trainer.model.parameters())


def test_run_trains_dev_flat_swin(tmp_path, monkeypatch):
    run_layout(tmp_path, monkeypatch, "dev_flat_swin")
