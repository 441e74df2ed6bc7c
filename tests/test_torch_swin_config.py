"""The Swin3D stage-1 path from its config, on the CPU.

- No option that the JAX package reads is dropped in silence: a voxel
  encoder the port does not build raises ``NotImplementedError``; the
  options that raised until the port had them (``compact_conv``,
  ``level_cap_ladder``, ``conv0_kernel``, ``sorted_gather``,
  ``int8_gather``) now reach the pipeline and the model; ``swin_window``
  is read.
- ``PCDMask3DSwin3DEncoder`` builds the Swin3D backbone (window from
  ``backbone_kwargs.config.window``, else ``args.swin_window``, else 4),
  ``INSTSEG_SWIN3D_SYNTHETIC`` is ``instseg_swin3d_synthetic.yaml``, and a
  pipeline whose window differs from the model's is refused.
- One train step of ``instseg_swin3d_synthetic`` (the Swin3D U-Net at the
  small widths of tests/test_swin3d.py in both packages, f32 conv
  compute, dropout off) against the JAX package's on the same weights and
  batch: loss within 1e-3 relative, every gradient max|diff| / max|ref|
  <= 1e-3, the batch-norm statistics within 1e-3.
- ``python -m pq3d_tpu_torch.run --config-name instseg_swin3d_synthetic``
  trains 2 steps.
"""
import functools
import os
import shutil

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pq3d_tpu.config import load_config as jload_config
from pq3d_tpu.data import instseg_pipeline as jpipe
from pq3d_tpu.data import synthetic as jsyn
from pq3d_tpu.models import query3d as jq3d
from pq3d_tpu.ops import sparse as jsparse
from pq3d_tpu.optim import losses as jlosses
from pq3d_tpu_torch import config as tconfig
from pq3d_tpu_torch import run as trun
from pq3d_tpu_torch.data import instseg_pipeline as tpipe
from pq3d_tpu_torch.models import query3d as tq3d
from pq3d_tpu_torch.models.encoders import check_swin_window
from pq3d_tpu_torch.models.swin3d import Swin3DUNet
from pq3d_tpu_torch.ops import sparse as tsparse
from pq3d_tpu_torch.optim import losses as tlosses
from pq3d_tpu_torch.serve import to_device
from pq3d_tpu_torch.utils.weights import load_flax_variables, torch_name

from test_torch_model import _random_variables
from test_torch_swin_model import _JSmallSwin, _TSmallSwin
from test_torch_trainer import TINY, _jax_assignment, _rel

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWIN = "instseg_swin3d_synthetic"


@pytest.fixture()
def small_swin(monkeypatch):
    from pq3d_tpu.models import swin3d as jswin
    from pq3d_tpu_torch.models import swin3d as tswin
    monkeypatch.setattr(jswin, "Swin3DUNet", _JSmallSwin)
    monkeypatch.setattr(tswin, "Swin3DUNet", _TSmallSwin)


@pytest.mark.parametrize("key,value", [
    ("data.instseg_options.compact_conv", "true"),
    ("data.instseg_options.level_cap_ladder",
     "[[2048, 1024, 512, 256, 128]]"),
    ("data.instseg_options.conv0_kernel", "3"),
    ("model.voxel_encoder.args.sorted_gather", "true"),
    ("model.voxel_encoder.args.int8_gather", "true"),
    ("model.voxel_encoder.name", "PCDMask3DEncoder")])
def test_unported_option_is_refused_by_name(key, value):
    """The encoder name is refused by name; the gather stem's kernel and
    the four conv options the port now has are read (the pipeline's, or
    the backbone's attribute), no longer refused."""
    cfg = tconfig.load_config("instseg_synthetic", [f"{key}={value}",
                                                    "device=cpu"])
    leaf = key.split(".")[-1]
    if "name" in key:
        with pytest.raises(NotImplementedError, match="PCDMask3DEncoder"):
            trun.build_instseg_trainer(cfg)
        return
    trainer = trun.build_instseg_trainer(cfg)
    try:
        if key.startswith("data."):
            got = getattr(trainer.train_data.pipe_cfg, leaf)
            assert got == tconfig.parse_value(value), (leaf, got)
        else:
            assert getattr(trainer.model.voxel_encoder.backbone, leaf) is True
    finally:
        trainer._close_loaders()


def test_swin_options_are_read():
    """The JAX defaults and the model's own stem kernel pass; the window
    comes from backbone_kwargs.config.window, else args.swin_window; the
    Res16UNet encoder's name keeps the Res16UNet."""
    iopt = dict(tconfig.INSTSEG_SYNTHETIC["data"]["instseg_options"],
                compact_conv=False, level_cap_ladder=None, conv0_kernel=3,
                swin_window=2, stem_mode="none")
    pipe = tpipe.pipeline_config(iopt)
    assert pipe.swin_window == 2 and pipe.stem_mode == "none"
    small = ["model.hidden_size=32",
             "model.unified_encoder.args.num_attention_heads=4",
             "model.unified_encoder.args.num_layers=1"]
    for overrides, window in (
            ([], 4),
            (["model.voxel_encoder.args.swin_window=2"], 2),
            (["model.voxel_encoder.args.swin_window=2",
              "model.voxel_encoder.args.backbone_kwargs.config.window=8"],
             8)):
        model = tq3d.build_model(tconfig.load_config(SWIN, small
                                                     + overrides),
                                 device="cpu")
        assert isinstance(model.voxel_encoder.backbone, Swin3DUNet)
        assert model.voxel_enc.swin_window == window
        assert model.voxel_encoder.backbone.window == window
    check_swin_window(model, tpipe.InstSegPipelineConfig(swin_window=8))
    with pytest.raises(ValueError, match="swin window"):
        check_swin_window(model, tpipe.InstSegPipelineConfig(swin_window=4))
    rect = tq3d.build_model(tconfig.load_config("instseg_synthetic", small),
                            device="cpu")
    assert type(rect.voxel_encoder.backbone).__name__ == "Res16UNet"
    via_arg = tq3d.build_model(tconfig.load_config(
        "instseg_synthetic",
        small + ["model.voxel_encoder.args.backbone=swin3d"]), device="cpu")
    assert isinstance(via_arg.voxel_encoder.backbone, Swin3DUNet)
    with pytest.raises(ValueError, match="swin window"):
        trun.build_instseg_trainer(tconfig.load_config(
            SWIN, small + ["device=cpu",
                           "data.instseg_options.swin_window=2"]))
    path = os.path.join(REPO, "pq3d_tpu", "config", "configs", SWIN + ".yaml")
    with open(path) as f:
        assert tconfig.INSTSEG_SWIN3D_SYNTHETIC == yaml.safe_load(f)


def _step_overrides():
    return ["model.hidden_size=32",
            "model.unified_encoder.args.num_attention_heads=4",
            "model.unified_encoder.args.num_layers=1",
            "model.voxel_encoder.args.hlevels=[0, 1]",
            "model.voxel_encoder.args.dropout=0.0",
            "model.mv_encoder.args.dropout=0.0",
            "model.pc_encoder.args.dropout=0.0",
            "data.instseg_options.num_queries=8",
            "data.instseg_options.max_segments=32",
            "data.instseg_options.max_instances=8",
            "data.instseg_options.level_caps=[512, 256, 128, 128, 128]"]


def test_swin_train_step_matches_jax(monkeypatch, small_swin):
    ov = _step_overrides()
    jcfg = jload_config(SWIN, overrides=ov)
    jm = jq3d.build_model(jcfg)
    tcfg = tconfig.load_config(SWIN, ov)
    tm = tq3d.build_model(tcfg, device="cpu")
    pipe = jpipe.InstSegPipelineConfig(
        voxel_size=0.15, num_queries=8, max_segments=32, max_instances=8,
        voxel_bucket=128, stem_mode="none", swin_window=4,
        level_caps=[512, 256, 128, 128, 128])
    rng = np.random.default_rng(4)
    scenes = [jsyn.make_scene(rng, n_points=n, n_instances=4,
                              n_segments=20) for n in (700, 1000)]
    b = jpipe.make_batch(scenes, pipe, np.random.default_rng(1), train=True)
    b = {k: v for k, v in b.items() if not k.startswith("_")}
    for name in ("mv", "pc"):
        b[f"{name}_seg_fts"] = rng.standard_normal((2, 32, 768)).astype(
            np.float32)
        b[f"{name}_seg_pad_masks"] = b["seg_pad_masks"]
    b["instance_labels"] = (b["instance_labels"] % 17 + 3).astype(np.int32)
    bj = jax.tree_util.tree_map(jnp.asarray, b)
    variables = _random_variables(lambda: jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, bj,
        train=False))
    cfg_j = jlosses.InstSegLossConfig(num_classes=200)
    cfg_t = tlosses.InstSegLossConfig(num_classes=200)
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)
    for fn in ("sparse_conv_sym", "sparse_conv_down",
               "sparse_conv_transpose_gf"):
        monkeypatch.setattr(jsparse, fn, functools.partial(
            getattr(jsparse, fn), compute_dtype=jnp.float32))
    monkeypatch.setattr(tsparse, "_round", lambda t, dtype: t.float())

    def loss_j(params):
        out, upd = jm.apply(
            {"params": params, "batch_stats": variables["batch_stats"],
             "buffers": variables["buffers"]}, bj, train=True,
            mutable=["batch_stats"])
        total, _ = jlosses.instseg_set_loss(
            out["predictions_class"], out["predictions_mask"], bj, cfg_j)
        return total, (upd["batch_stats"], out)
    (total_j, (stats_j, out_j)), grads_j = jax.jit(
        jax.value_and_grad(loss_j, has_aux=True))(variables["params"])

    load_flax_variables(tm, variables)
    tm.train()
    for m in tm.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    bt = to_device(b, torch.device("cpu"))
    out_t = tm(bt)
    total_t, _ = tlosses.instseg_set_loss(
        out_t["predictions_class"], out_t["predictions_mask"], bt, cfg_t)
    total_t.backward()

    costs_t = tlosses.round_costs(
        out_t["predictions_class"], out_t["predictions_mask"], bt,
        cfg_t).numpy()
    col_t = tlosses.assign(costs_t)
    col_j = _jax_assignment(out_j, bj, cfg_j)
    for r in range(col_t.shape[0]):
        for i in range(col_t.shape[1]):
            v = b["instance_valid"][i]
            if not np.array_equal(col_t[r, i, v], col_j[r, i, v]):
                c = costs_t[r, i][v]
                assert r == 0 and np.array_equal(c[:, col_t[r, i, v]],
                                                 c[:, col_j[r, i, v]])
    assert abs(total_t.item() - float(total_j)) <= 1e-3 * abs(float(total_j))

    tparams = dict(tm.named_parameters())
    floor = 1e-6 * max(float(np.abs(np.asarray(g)).max())
                       for g in jax.tree_util.tree_leaves(grads_j))
    checked = set()
    for path, g in jax.tree_util.tree_flatten_with_path(grads_j)[0]:
        name, ref = torch_name(tm, tuple(p.key for p in path), np.asarray(g))
        got = tparams[name].grad
        if not np.abs(ref).max() > floor:
            assert got is None or np.abs(got.numpy()).max() <= floor, name
            continue
        assert _rel(ref, got.numpy()) <= 1e-3, (name, _rel(ref, got.numpy()))
        checked.add(name)
    assert "voxel_encoder.backbone.stage1.block0.attn.rel_bias" in checked
    assert "voxel_encoder.backbone.dec1.block0.mlp2.weight" in checked
    for path, v in jax.tree_util.tree_flatten_with_path(stats_j)[0]:
        name, ref = torch_name(tm, tuple(p.key for p in path), np.asarray(v))
        np.testing.assert_allclose(dict(tm.named_buffers())[name].numpy(),
                                   ref, rtol=1e-3, atol=1e-3, err_msg=name)


def test_run_trains_the_swin_config(tmp_path, monkeypatch, small_swin):
    from pq3d_tpu_torch.train.trainer import Query3DTrainer
    monkeypatch.setattr(Query3DTrainer, "install_preemption_handler",
                        lambda self, signals=None: None)
    seen = []
    orig = Query3DTrainer.train_batch

    def spy(self, batch):
        seen.append(sorted(k for k in batch["maps"] if k.startswith("win")))
        return orig(self, batch)
    monkeypatch.setattr(Query3DTrainer, "train_batch", spy)
    trainer = trun.main(["--config-name", SWIN, *TINY, "solver.epochs=2",
                         "solver.epochs_per_eval=0",
                         "solver.epochs_per_save=0",
                         f"exp_dir={tmp_path / 'swin'}"])
    shutil.rmtree(tmp_path / "swin")
    assert trainer.step == 2 and len(seen) == 2 and len(seen[0]) == 16
    assert isinstance(trainer.model.voxel_encoder.backbone, Swin3DUNet)
    assert all(torch.isfinite(p).all() for p in trainer.model.parameters())
