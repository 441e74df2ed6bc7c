"""``level_cap_ladder`` and ``compact_conv``'s guards in the port against
the JAX package's, on the CPU.

- The JAX package's guards (``tests/test_config_guards.py``): a short
  rung, descending rungs and the ladder with ``flat_pack`` raise
  ``ValueError`` in both packages, as do ``compact_conv`` or the ladder
  with ``device_maps``, rectangular or flat; an ascending ladder passes.
- ``pipeline_config`` reads the YAML ladder as the JAX runner does (lists
  of ints).
- The rung picks and the batches of ``tests/test_shape_stability.py:75``
  bit-equal to JAX's ``collate`` (each batch takes the first rung that
  holds its true per-level maxima), and a batch no rung holds raises a
  ``ValueError`` naming the ladder in both.
- ``InstSegServer`` refuses the ladder on the rectangular layout (JAX's
  ``tests/test_serve.py:209``).
- One train step of a small Query3D on a ladder batch against JAX's
  (``scatter_free``, f32 conv compute, dropout off; the direct criterion):
  loss within 1e-3 relative, gradients and batch-norm statistics within
  1e-3 (``test_torch_compact_conv.step_matches_jax``).
"""
import numpy as np
import pytest
import torch

from pq3d_tpu.data import instseg_pipeline as jpipe
from pq3d_tpu.data import synthetic as jsyn
from pq3d_tpu_torch.data import instseg_pipeline as tpipe
from pq3d_tpu_torch.ops import window_maps
from pq3d_tpu_torch.serve import InstSegServer

from test_torch_compact_conv import _models, _with_features, step_matches_jax
from test_torch_pipeline import _assert_same

torch.set_num_threads(1)
LADDER = [[256, 128, 96, 48, 24], [1024, 512, 256, 128, 64]]
KW = dict(voxel_size=0.1, num_queries=16, max_segments=64, max_instances=16,
          voxel_bucket=64, stem_mode="dense_block")


def _rung(top):
    return [max(top >> i, 4) for i in range(5)]


@pytest.mark.parametrize("kw,match", [
    (dict(level_cap_ladder=[_rung(64), _rung(32)]), "non-decreasing"),
    (dict(level_cap_ladder=[[64, 32]]), "one per level"),
    (dict(flat_pack=True, level_cap_ladder=[_rung(32), _rung(64)]),
     "flat_pack"),
    (dict(device_maps=True, level_caps=_rung(64), compact_conv=True),
     "compact_conv"),
    (dict(device_maps=True, level_caps=_rung(64),
          level_cap_ladder=[_rung(64)]), "level_cap_ladder"),
    (dict(device_maps=True, flat_pack=True, compact_conv=True,
          stem_mode="none", swin_window=4), "compact_conv"),
], ids=["descending", "short", "flat", "dev_compact", "dev_ladder",
        "dev_flat_compact"])
def test_guards_match_jax(kw, match):
    for pkg in (jpipe, tpipe):
        with pytest.raises(ValueError, match=match):
            pkg.InstSegPipelineConfig(**kw)
    ok = dict(level_cap_ladder=[_rung(32), _rung(64)])
    assert tpipe.InstSegPipelineConfig(**ok).level_cap_ladder == \
        jpipe.InstSegPipelineConfig(**ok).level_cap_ladder


def test_pipeline_config_reads_the_yaml_ladder():
    cfg = tpipe.pipeline_config({"level_cap_ladder": [["256", 128.0, 96, 48,
                                                       24], LADDER[1]],
                                 "compact_conv": False, "voxel_size": 0.1})
    assert cfg.level_cap_ladder == LADDER
    assert all(type(x) is int for rung in cfg.level_cap_ladder
               for x in rung)


def _scene_sets():
    return {"small": [jsyn.make_scene(np.random.default_rng(1), n_points=150,
                                      n_instances=3, n_segments=12)
                      for _ in range(2)],
            "big": [jsyn.make_scene(np.random.default_rng(2), n_points=1200,
                                    n_instances=4, n_segments=24)
                    for _ in range(2)],
            "huge": [jsyn.make_scene(np.random.default_rng(3),
                                     n_points=5000, n_instances=4,
                                     n_segments=24) for _ in range(2)]}


@pytest.mark.parametrize("caps", [None, [2048, 1024, 512, 256, 128]],
                         ids=["ladder", "ladder_and_caps"])
def test_rung_picks_match_jax_collate(caps):
    sets = _scene_sets()
    opts = dict(KW, level_cap_ladder=LADDER, level_caps=caps)
    jcfg = jpipe.InstSegPipelineConfig(**opts, use_aug=True)
    tcfg = tpipe.InstSegPipelineConfig(**opts, use_aug=True)
    for name, want in (("small", 256), ("big", 1024)):
        bj = jpipe.make_batch([dict(s) for s in sets[name]], jcfg,
                              np.random.default_rng(0), train=True)
        bt = tpipe.make_batch([dict(s) for s in sets[name]], tcfg,
                              np.random.default_rng(0), train=True)
        assert bt["maps"]["valid_0"].shape[1] == want
        rung = LADDER[0 if name == "small" else 1]
        assert [bt["maps"][f"valid_{l}"].shape[1] for l in range(5)] == rung
        # the stem's block cap still comes from level_caps when set
        if caps:
            assert bt["maps"]["stem_nbrblk"].shape[1] == \
                window_maps.bucket(caps[0] // 16)
        _assert_same(bj, bt)
    for pkg, cfg in ((jpipe, jcfg), (tpipe, tcfg)):
        with pytest.raises(ValueError, match="ladder"):
            pkg.make_batch([dict(s) for s in sets["huge"]], cfg,
                           np.random.default_rng(0), train=True)


def test_server_refuses_the_ladder():
    from test_torch_model import _models as model_pair
    _, tm = model_pair(num_layers=1, num_blocks=1)
    pipe = tpipe.InstSegPipelineConfig(
        voxel_size=0.15, num_queries=8, max_segments=32, max_instances=8,
        voxel_bucket=128, use_aug=False, level_caps=[512, 256, 128, 64, 32],
        level_cap_ladder=[[512, 256, 128, 64, 32]])
    with pytest.raises(ValueError, match="level_cap_ladder"):
        InstSegServer(tm.eval(), pipe, batch_size=2, num_classes=20,
                      device="cpu")


def test_ladder_train_step_matches_jax(monkeypatch):
    from test_torch_flat_pack import _scenes
    scenes = _scenes(3, (700, 900))
    opts = dict(voxel_size=0.15, num_queries=8, max_segments=32,
                max_instances=8, voxel_bucket=128, stem_mode="dense_block",
                use_aug=True, level_caps=[4096, 2048, 1024, 512, 256],
                level_cap_ladder=[[512, 256, 128, 64, 32],
                                  [1024, 512, 256, 128, 64]])
    bj = jpipe.make_batch([dict(s) for s in scenes],
                          jpipe.InstSegPipelineConfig(**opts),
                          np.random.default_rng(2), train=True)
    bt = tpipe.make_batch([dict(s) for s in scenes],
                          tpipe.InstSegPipelineConfig(**opts),
                          np.random.default_rng(2), train=True)
    _assert_same(bj, bt)
    assert bt["maps"]["valid_0"].shape[1] in (512, 1024)
    jm, tm = _models("scatter_free")
    step_matches_jax(monkeypatch, _with_features(bj), jm, tm)
