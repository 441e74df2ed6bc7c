"""The plain reference of stage 1 against the port on the CPU at a tiny
size: its host pipeline, hierarchy and ranking exactly, its forward to
rounding."""
from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import tiny  # noqa: E402

sys.path.insert(0, tiny.REPO)
from perfbench.generators import instseg_scenes  # noqa: E402
from perfbench.reference import instseg as ref  # noqa: E402
from perfbench.weights import centre_projections, make_state  # noqa: E402

TRAFFIC = dict(tiny.TINY_TRAFFIC)
ARCH = tiny.TINY_CONFIG["arch"]


@pytest.fixture(scope="module")
def scenes():
    return instseg_scenes.make_scenes(5, TRAFFIC)


def test_voxels_fps_and_candidates_match_the_port(scenes):
    from pq3d_tpu_torch.data.instseg_pipeline import (InstSegPipelineConfig,
                                                      process_scene)
    from pq3d_tpu_torch.ops import voxelize
    cfg = InstSegPipelineConfig(num_queries=16, max_segments=64,
                                fps_subsample=512, device_maps=True,
                                level_caps=(8192, 4096, 2048, 1024, 512))
    counts = [ref.n_voxels(s, 0.02) for s in scenes]
    cands = ref.query_candidates(counts, 512, 16)
    rng = np.random.default_rng(0)      # the in-process server's stream
    for s in scenes:
        got = process_scene(s, cfg, rng)
        want = ref.prepare_scene(s, 0.02, 16, 64, next(cands))
        coords, first, inverse = voxelize.quantize(
            s["points"].astype(np.float32), 0.02)
        assert np.array_equal(want["coords"], coords)
        assert np.array_equal(want["feats"], got["voxel_feats"])
        assert np.array_equal(want["v2s"], got["voxel2segment"])
        assert np.array_equal(want["query_locs"], got["query_locs"])
        n = min(len(got["seg_center"]), 64)
        assert np.allclose(want["seg_center"][:n], got["seg_center"][:n])
        assert np.array_equal(want["coord_min"], got["coord_min"])


def test_hierarchy_matches_the_port(scenes):
    from pq3d_tpu_torch.ops import kernel_maps
    coords = ref.voxelize(scenes[0]["points"].astype(np.float32), 0.02)[0]
    lv, parent, off = ref.hierarchy(torch.as_tensor(coords))
    h = kernel_maps.build_hierarchy(coords.astype(np.int32))
    for l in range(5):
        assert np.array_equal(lv[l].coords.numpy(), h.coords[l])
        n = h.num_voxels[l]
        assert np.array_equal(lv[l].neighbours(3).numpy(), h.nbr3[l][:n])
    for l in range(4):
        n = h.num_voxels[l]
        assert np.array_equal(parent[l].numpy(), h.parent[l][:n])
        assert np.array_equal(off[l].numpy(), h.parent_off[l][:n])


def test_ranking_matches_the_port():
    from pq3d_tpu_torch.eval.instseg_eval import rank_instances
    g = np.random.default_rng(3)
    cls = g.normal(size=(16, 201)).astype(np.float32)
    mask = g.normal(size=(64, 16)).astype(np.float32) * 3
    valid = np.arange(64) < 50
    seg = g.integers(0, 70, 1000)
    served = rank_instances(cls, mask, valid, 200, 20, seg_to_full=seg)
    mine = ref.rank(cls, mask, valid, seg, 200, 20)
    assert len(served) == len(mine) > 0
    for p in served:
        hits = [k for k, (sc, m) in mine.items() if k[1] == p["class"]
                and sc == pytest.approx(p["score"], rel=1e-6)
                and np.array_equal(m, p["mask"])]
        assert len(hits) == 1


def test_forward_matches_the_port(scenes):
    from pq3d_tpu_torch.config import serving_config
    from pq3d_tpu_torch.data.instseg_pipeline import (make_batch,
                                                      pipeline_config)
    from pq3d_tpu_torch.models.query3d import build_model
    from pq3d_tpu_torch.serve import to_device
    cfg = serving_config("dev_maps", tiny.TINY_CONFIG["port"]["overrides"])
    pipe = pipeline_config(cfg["data"]["instseg_options"])
    model = build_model(cfg, device="cpu", seed=0)
    shapes = {k: (tuple(v.shape), v.dtype)
              for k, v in model.state_dict().items()}
    sd = make_state(shapes, 6, "cpu")
    sd.update(centre_projections(sd, scenes[:2], ARCH, "cpu"))
    model.load_state_dict(sd, strict=False)
    S = ARCH["max_segments"]
    batch = make_batch([dict(s) for s in scenes[:2]], pipe,
                       np.random.default_rng(0))
    batch.pop("_meta")
    for m in ("mv", "pc"):
        batch[f"{m}_seg_fts"] = np.zeros((2, S, 768), np.float32)
        batch[f"{m}_seg_pad_masks"] = batch["seg_pad_masks"]
    with torch.no_grad():
        out = model(to_device(batch, torch.device("cpu")))
    counts = [ref.n_voxels(s, 0.02) for s in scenes[:2]]
    cands = ref.query_candidates(counts, 512, 16)
    arch = dict(ARCH)
    for i in range(2):
        prep = ref.prepare_scene(scenes[i], 0.02, 16, S, next(cands))
        forced = [m[i] for m in out["predictions_mask"][:-1]]
        with torch.no_grad():
            got = ref.forward_scene(sd, prep, arch, forced, "cpu")
        valid = got["seg_valid"]
        assert len(got["mask"]) == len(out["predictions_mask"]) == 3
        for r in range(3):
            pm = out["predictions_mask"][r][i][valid]
            rm = got["mask"][r][valid]
            # the sparse convs round their operands to bf16: sums taken in
            # another order can round a stem output to the next bf16
            # value, which moves later features by up to 1e-3 of their
            # size; 1e-2 still refuses the bf16 cast (test_perfbench_run)
            assert rel(pm, rm) < 1e-2
            pc = out["predictions_class"][r][i][:, 3:]
            rc = got["cls"][r][:, 3:]
            assert rel(pc, rc) < 1e-2


def rel(got, want):
    """max |got - want| over max |want| (round 0's mask logits are all 0:
    the queries start at 0 and the mask head's query projection has no
    bias)."""
    return ((got - want).abs().max()
            / want.abs().max().clamp_min(1e-12)).item()
