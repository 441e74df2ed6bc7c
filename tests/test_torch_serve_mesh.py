"""The port's sharded-batch mesh server (``pq3d_tpu_torch/serve.py``,
``mesh=``) on the CPU: the counterparts of ``tests/test_serve_mesh.py``.

- ``InstSegServer(mesh=["cpu", "cpu"], batch_size=4)`` against the
  one-device server on 8 scenes, every sparse conv in f32: the same
  classes, scores within rtol 1e-4 / atol 1e-6, masks agreeing on more
  than 0.999 of the points; each mesh part ran on its own replica;
- the same mesh server's final logits against the JAX package's model on
  each joined batch, with the same weights (max|diff| / max|ref| <= 2e-2,
  the tolerance of ``tests/test_torch_serve.py``);
- ``UnifiedServer(mesh=["cpu", "cpu"])`` serves 8 requests with the
  answers of the one-device server (the same object, the same tokens);
- ``split_rows`` cuts every array of a nested batch by rows and refuses
  one without the batch's leading dim;
- the refusals: a batch the mesh does not divide, the flat layouts
  (``flat_pack``, ``compact_conv``, ``flat_obj``), ``mesh`` with
  ``device``, and the default mesh without a card.
"""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pq3d_tpu.models import query3d as jq3d
from pq3d_tpu_torch.data import synthetic
from pq3d_tpu_torch.data import unified_pipeline as tup
from pq3d_tpu_torch.data.instseg_pipeline import (InstSegPipelineConfig,
                                                  make_batch)
from pq3d_tpu_torch.models import query3d as tq3d
from pq3d_tpu_torch.ops import sparse as tsparse
from pq3d_tpu_torch.serve import (InstSegServer, UnifiedServer, serving_mesh,
                                  split_rows)
from pq3d_tpu_torch.utils.weights import load_flax_variables
from test_torch_pointnet import random_variables
from test_torch_unified import FEATURE_DIMS, PIPE, _models, _requests

torch.set_num_threads(1)
MESH = ["cpu", "cpu"]


def _pipe(**kw):
    return InstSegPipelineConfig(
        voxel_size=0.15, num_queries=8, max_segments=32, max_instances=8,
        voxel_bucket=128, use_aug=False,
        level_caps=[512, 256, 128, 128, 128], **kw)


def _jax_model():
    return jq3d.Query3DUnified(
        memories=("voxel",), heads=("mask",), hidden_size=32, dim_loc=3,
        unified=jq3d.UnifiedEncoderCfg(num_layers=1, num_blocks=1,
                                       num_attention_heads=4,
                                       structure="parallel",
                                       spatial_selfattn=True,
                                       use_self_mask=True),
        voxel_enc=jq3d.VoxelEncoderCfg(hlevels=(0, 1), out_channels=20),
        mask_head_cfg=jq3d.MaskHeadCfg(num_targets=21,
                                       filter_out_classes=(0, 2)))


def _torch_model():
    return tq3d.Query3DUnified(
        memories=("voxel",), heads=("mask",), hidden_size=32, dim_loc=3,
        unified=tq3d.UnifiedEncoderCfg(num_layers=1, num_blocks=1,
                                       num_attention_heads=4,
                                       structure="parallel",
                                       spatial_selfattn=True,
                                       use_self_mask=True),
        voxel_enc=tq3d.VoxelEncoderCfg(hlevels=(0, 1), out_channels=20),
        mask_head_cfg=tq3d.MaskHeadCfg(21, (0, 2)))


class _Recording(InstSegServer):
    """Keeps each forward's batch and final logits, by replica."""

    def __init__(self, *a, **k):
        self.seen = {}
        self._lock = threading.Lock()
        super().__init__(*a, **k)

    def _forward_on(self, model, batch):
        cls_l, mask_l = super()._forward_on(model, batch)
        idx = next(i for i, r in enumerate(self.mesh_models or [self.model])
                   if r is model)
        rec = ({k: (v.numpy() if not isinstance(v, dict) else
                    {kk: vv.numpy() for kk, vv in v.items()})
                for k, v in batch.items()}, cls_l.numpy(), mask_l.numpy())
        with self._lock:
            self.seen.setdefault(idx, []).append(rec)
        return cls_l, mask_l


def _serve_all(srv, reqs):
    try:
        return [f.result(timeout=600) for f in [srv.submit(r)
                                                for r in reqs]]
    finally:
        srv.close()


@pytest.fixture(scope="module")
def instseg():
    rng = np.random.default_rng(0)
    scenes = [synthetic.make_scene(rng, n_points=n, n_instances=3,
                                   n_segments=16)
              for n in (600, 900, 700, 800, 650, 720, 880, 640)]
    for s in scenes:
        s["inst_labels"] = np.minimum(s["inst_labels"], 19)
    pipe = _pipe()
    jm = _jax_model()
    init = jax.tree.map(jnp.asarray, {
        k: v for k, v in make_batch(scenes[:2], pipe, rng,
                                    train=False).items()
        if not k.startswith("_")})
    variables = random_variables(jax.eval_shape(lambda: jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, init,
        train=False)), 3)
    tm = _torch_model()
    load_flax_variables(tm, variables)
    tm.eval()
    mp = pytest.MonkeyPatch()
    # f32 sparse convs: bf16 rounding moves with the GEMMs' split, which
    # can flip ranked near-ties (as tests/test_serve_mesh.py forces f32)
    mp.setattr(tsparse, "_round", lambda t, dtype: t.float())
    try:
        kw = dict(batch_size=4, num_classes=20, topk=20, max_delay_s=0.5)
        srv = _Recording(tm, pipe, mesh=MESH, **kw)
        sharded = _serve_all(srv, scenes)
        single = _serve_all(InstSegServer(tm, pipe, device="cpu", **kw),
                            scenes)
    finally:
        mp.undo()
    return srv, sharded, single, jm, variables


def test_mesh_server_matches_single_device(instseg):
    srv, sharded, single, _, _ = instseg
    assert srv.stats.scenes == 8 and srv.stats.steps == 2
    # each part ran on its own replica, a batch's two halves
    assert sorted(srv.seen) == [0, 1]
    assert all(len(v) == 2 for v in srv.seen.values())
    assert all(rec[1].shape[0] == 2 for v in srv.seen.values()
               for rec in v)
    assert srv.mesh_models[0] is not srv.mesh_models[1]
    for preds_a, preds_b in zip(sharded, single):
        assert len(preds_a) == len(preds_b) > 0
        for a, b in zip(preds_a, preds_b):
            assert a["class"] == b["class"]
            np.testing.assert_allclose(a["score"], b["score"], rtol=1e-4,
                                       atol=1e-6)
            assert (a["mask"] == b["mask"]).mean() > 0.999


def test_mesh_server_matches_jax_forward(instseg):
    srv, _, _, jm, variables = instseg
    fwd = jax.jit(lambda v, b: jm.apply(v, b, train=False))
    for (b0, c0, m0), (b1, c1, m1) in zip(srv.seen[0], srv.seen[1]):
        batch = jax.tree.map(lambda a, b: np.concatenate([a, b]), b0, b1)
        ref = fwd(variables, jax.tree.map(jnp.asarray, batch))
        for got, want in ((np.concatenate([c0, c1]),
                           ref["predictions_class"][-1]),
                          (np.concatenate([m0, m1]),
                           ref["predictions_mask"][-1])):
            want = np.asarray(want)
            assert np.abs(got - want).max() / np.abs(want).max() <= 2e-2


def test_unified_mesh_server_serves():
    jm, tm = _models()
    pipe = tup.UnifiedPipelineConfig(**PIPE)
    reqs = _requests(8)
    rng = np.random.default_rng(0)
    items = [tup.process_item(s, l, pipe, rng, False, FEATURE_DIMS)
             for s, l in reqs[:2]]
    batch = tup.collate_unified(items, pipe, FEATURE_DIMS, train=False)
    variables = random_variables(jax.eval_shape(lambda: jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        jax.tree.map(jnp.asarray, batch), train=False)), 3)
    load_flax_variables(tm, variables)
    tm.eval()
    kw = dict(batch_size=4, feature_dims=FEATURE_DIMS, max_delay_s=0.5,
              detokenize=lambda t: " ".join(map(str, t)))
    srv = UnifiedServer(tm, pipe, mesh=MESH, **kw)
    got = _serve_all(srv, reqs)
    want = _serve_all(UnifiedServer(tm, pipe, device="cpu", **kw), reqs)
    assert srv.stats.scenes == 8
    for g, r in zip(got, want):
        assert g["ground_obj"] == r["ground_obj"] is not None
        assert np.isfinite(g["ground_scores"][g["ground_obj"]])
        np.testing.assert_array_equal(g["generation_tokens"],
                                      r["generation_tokens"])
        assert isinstance(g["generation"], str)


@pytest.mark.parametrize("case", ["nested", "no_batch_dim"])
def test_split_rows(case):
    """A mesh part's rows of every array of a collated batch, nested dicts
    included; an array without the batch's leading dim raises."""
    batch = {"x": np.arange(8).reshape(4, 2), "n": 3,
             "maps": {"valid_0": np.arange(12).reshape(4, 3)}}
    if case == "nested":
        part = split_rows(batch, 2, 4, 4)
        np.testing.assert_array_equal(part["x"], [[4, 5], [6, 7]])
        np.testing.assert_array_equal(part["maps"]["valid_0"],
                                      [[6, 7, 8], [9, 10, 11]])
        assert part["n"] == 3
    else:
        batch["maps"]["flat"] = np.arange(5)
        with pytest.raises(ValueError, match="leading dim"):
            split_rows(batch, 0, 2, 4)


@pytest.mark.parametrize("case", ["ragged", "flat_pack", "compact_conv",
                                  "flat_obj", "device"])
def test_mesh_server_refusals(case):
    model = _torch_model()
    kw = dict(batch_size=4, num_classes=20, mesh=MESH)
    if case == "ragged":
        with pytest.raises(ValueError, match="not divisible"):
            InstSegServer(model, _pipe(), **dict(kw, batch_size=3))
    elif case in ("flat_pack", "compact_conv"):
        pipe = dataclasses.replace(_pipe(), **{case: True})
        with pytest.raises(ValueError, match="rectangular"):
            InstSegServer(model, pipe, **kw)
    elif case == "flat_obj":
        pipe = tup.UnifiedPipelineConfig(**PIPE, flat_obj=True)
        with pytest.raises(ValueError, match="flat_obj"):
            UnifiedServer(model, pipe, batch_size=4, feature_dims={},
                          mesh=MESH)
    else:
        with pytest.raises(ValueError, match="exclusive"):
            InstSegServer(model, _pipe(), device="cpu", **kw)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                serving_mesh()
