"""The port's host pipeline (pq3d_tpu_torch/data/instseg_pipeline.py) is
bit-identical to the JAX package's on the same scenes and seed: every
array of the collated batch, the maps and the host side channel."""
import numpy as np
import pytest

from pq3d_tpu.data import instseg_pipeline as jpipe
from pq3d_tpu.data import synthetic as jsyn
from pq3d_tpu.ops import sampling as jsampling
from pq3d_tpu_torch.data import instseg_pipeline as tpipe
from pq3d_tpu_torch.data import synthetic as tsyn
from pq3d_tpu_torch.ops import sampling as tsampling


def _assert_same(a, b, path="batch"):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, sorted(set(a) ^ set(b)))
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype \
            and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape,
                                     b.shape)
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


KW = dict(voxel_size=0.1, num_queries=16, max_segments=48,
          max_instances=8, voxel_bucket=256, use_aug=False,
          stem_mode="dense_block", fps_subsample=200)


@pytest.mark.parametrize("caps", [None, (2048, 1024, 512, 256, 256)])
def test_batch_bit_identical(caps):
    scenes_j = [jsyn.make_scene(np.random.default_rng(i), n_points=n,
                                n_instances=4, n_segments=20)
                for i, n in enumerate((1500, 2600, 2000))]
    scenes_t = [tsyn.make_scene(np.random.default_rng(i), n_points=n,
                                n_instances=4, n_segments=20)
                for i, n in enumerate((1500, 2600, 2000))]
    _assert_same(scenes_j, scenes_t, "scenes")
    cfg_j = jpipe.InstSegPipelineConfig(level_caps=caps, **KW)
    cfg_t = tpipe.InstSegPipelineConfig(level_caps=caps, **KW)
    rng_j, rng_t = np.random.default_rng(7), np.random.default_rng(7)
    proc_j = [jpipe.process_scene(s, cfg_j, rng_j, train=False)
              for s in scenes_j]
    proc_t = [tpipe.process_scene(s, cfg_t, rng_t) for s in scenes_t]
    for pj, pt in zip(proc_j, proc_t):
        for k in pt:
            if k == "hierarchy":
                hj, ht = pj[k], pt[k]
                for f in ("num_voxels", "pad_sizes", "valid", "nbr3",
                          "child", "parent", "parent_off", "ancestor"):
                    _assert_same(getattr(hj, f), getattr(ht, f), f)
            else:
                _assert_same(pj[k], pt[k], k)
    bj = jpipe.collate_processed(proc_j, cfg_j)
    bt = tpipe.collate_processed(proc_t, cfg_t)
    assert "stem_dense" in bt["maps"]
    _assert_same(bj, bt)


def test_fps_numpy_identical():
    pts = np.random.default_rng(4).standard_normal((3000, 3)).astype(
        np.float32)
    for kw in ({}, {"subsample": 500}):
        a = jsampling.fps_numpy(pts, 40, rng=np.random.default_rng(1), **kw)
        b = tsampling.fps_numpy(pts, 40, rng=np.random.default_rng(1), **kw)
        np.testing.assert_array_equal(a, b)
