"""Port faults repaired, on the CPU.

- ``build_model`` warns when ``int8_gather`` is set under
  ``grad_mode: scatter_free``, where it changes nothing (the JAX package
  quantises only on its ``native`` branches outside training); the
  numerics stay those of ``int8_gather`` off.
- ``slice_batch_rows`` cuts only per-row entries: batch-led
  arrays (alone, or a list of them per round or layer), the lists of
  ``_meta`` and those at a per-row key; a per-layer or per-task list that
  happens to hold ``batch_rows`` items keeps every item, and a
  namedtuple-like sequence comes back as a plain list instead of
  breaking its constructor.
"""
import collections
import warnings

import numpy as np
import pytest
import torch

from pq3d_tpu_torch.config import load_config
from pq3d_tpu_torch.data.instseg_pipeline import make_batch, pipeline_config
from pq3d_tpu_torch.data.synthetic import make_scene
from pq3d_tpu_torch.eval import base as tbase
from pq3d_tpu_torch.models.query3d import build_model
from pq3d_tpu_torch.serve import to_device

torch.set_num_threads(1)
SMALL = ["model.hidden_size=32",
         "model.unified_encoder.args.num_attention_heads=4",
         "model.unified_encoder.args.num_layers=1",
         "model.unified_encoder.args.num_blocks=1",
         "data.instseg_options.num_queries=8",
         "data.instseg_options.max_segments=32",
         "data.instseg_options.max_instances=8",
         "data.instseg_options.voxel_size=0.15",
         "data.instseg_options.voxel_bucket=256",
         "data.instseg_options.level_caps=[512, 256, 128, 128, 128]"]
INT8 = "model.voxel_encoder.args.int8_gather=true"


@pytest.mark.parametrize("grad_mode", ["scatter_free", "native"])
def test_int8_gather_warns_under_scatter_free(grad_mode):
    cfg = load_config("instseg_synthetic", SMALL + [
        INT8, f"model.voxel_encoder.args.grad_mode={grad_mode}"])
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        build_model(cfg, device="cpu")
    hits = [w for w in seen if "int8_gather" in str(w.message)]
    assert len(hits) == (grad_mode == "scatter_free")
    if hits:
        assert "native" in str(hits[0].message)


def test_int8_gather_under_scatter_free_keeps_the_numerics():
    """The model built with int8_gather under scatter_free gives the
    forward of the model built without it, bit for bit."""
    cfg_off = load_config("instseg_synthetic", SMALL)
    pipe = pipeline_config(cfg_off["data"]["instseg_options"])
    rng = np.random.default_rng(0)
    scenes = [make_scene(rng, n_points=n, n_instances=3, n_segments=16)
              for n in (600, 800)]
    for s in scenes:
        s["inst_labels"] = np.minimum(s["inst_labels"], 19)
    b = make_batch(scenes, pipe, np.random.default_rng(0))
    b.pop("_meta")
    for name, dim in (("mv", 768), ("pc", 768)):
        b[f"{name}_seg_fts"] = np.zeros((2, 32, dim), np.float32)
        b[f"{name}_seg_pad_masks"] = b["seg_pad_masks"]
    outs = []
    for cfg in (cfg_off, load_config("instseg_synthetic", SMALL + [INT8])):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            model = build_model(cfg, device="cpu", seed=3)
        assert model.voxel_encoder.backbone.int8_gather == (cfg is not
                                                            cfg_off)
        with torch.inference_mode():
            outs.append(model(to_device(b, torch.device("cpu"))))
    for key in ("predictions_class", "predictions_mask"):
        for a, c in zip(outs[0][key], outs[1][key]):
            assert torch.equal(a, c), key


Pair = collections.namedtuple("Pair", "first second")


def test_slice_batch_rows_cuts_only_per_row_entries():
    rows = 4
    rng = np.random.default_rng(0)
    tree = {
        "logits": rng.random((rows, 3)),
        "per_round": [rng.random((rows, 2)) for _ in range(3)],
        # per layer / per task, rows items by chance: kept whole
        "layer_scale": [0.5, 1.0, 1.5, 2.0],
        "tasks": ["ground", "qa", "caption", "refer"],
        "not_rows": rng.random((2, rows)),
        "pair": Pair(rng.random((rows, 5)), rng.random((rows, 1))),
        "answer_pred": ["a", "b", "c", "d"],
        "_meta": {"scan_id": ["s0", "s1", "s2", "s3"],
                  "points": [rng.random((rows, 3)) for _ in range(rows)],
                  "n_real": 3},
    }
    out = tbase.truncate_batch_rows(tree, 3, rows)
    assert out["logits"].shape == (3, 3)
    assert [a.shape for a in out["per_round"]] == [(3, 2)] * 3
    assert out["layer_scale"] == tree["layer_scale"]
    assert out["tasks"] == tree["tasks"]
    assert out["not_rows"].shape == (2, rows)
    assert type(out["pair"]) is list and [a.shape for a in out["pair"]] \
        == [(3, 5), (3, 1)]
    assert out["answer_pred"] == ["a", "b", "c"]
    # a _meta list holds one entry a row: the list is cut, its arrays kept
    assert out["_meta"]["scan_id"] == ["s0", "s1", "s2"]
    assert [p.shape for p in out["_meta"]["points"]] == [(rows, 3)] * 3
    assert out["_meta"]["n_real"] == 3
    # a caller names its own per-row keys
    got = tbase.slice_batch_rows(tree, 1, 3, rows,
                                 tbase.ROW_LISTS | {"tasks"})
    assert got["tasks"] == ["qa", "caption"]
    assert tbase.truncate_batch_rows(tree, rows, rows) is tree


def test_take_rows_splits_meta_lists():
    """A data-parallel rank's rows: every _meta list cut, n_real counted
    among the rows."""
    b = {"query_pad_masks": np.ones((4, 2), bool),
         "_meta": {"scan_id": ["a", "b", "c", "d"], "n_real": 3,
                   "answers": [["x"], ["y"], ["z"], ["w"]]}}
    lo = tbase.take_rows(b, 2, 4)
    assert lo["_meta"]["scan_id"] == ["c", "d"]
    assert lo["_meta"]["answers"] == [["z"], ["w"]]
    assert lo["_meta"]["n_real"] == 1
    assert lo["query_pad_masks"].shape == (2, 2)
