"""A copy of the benchmark in a temporary directory with one more cell,
``tiny_serve``: the stage-1 serving entry at a size the CPU holds (hidden
64, 2 decoder layers, 16 queries, 64 segments, rooms of 2,500-3,000
points), added as new files and ``BENCHMARK.json`` entries only."""
from __future__ import annotations

import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

CAPS = [8192, 4096, 2048, 1024, 512]
TINY_CONFIG = {
    "name": "tiny_instseg",
    "source": "https://github.com/PQ3D/PQ3D (test size)",
    "centre_scenes": 2,
    "port": {"config": "instseg_sceneverse",
             "overrides": [
                 "model.hidden_size=64",
                 "model.unified_encoder.args.num_attention_heads=4",
                 "model.unified_encoder.args.num_layers=2",
                 "model.unified_encoder.args.num_blocks=1",
                 "data.instseg_options.num_queries=16",
                 "data.instseg_options.max_segments=64",
                 "data.instseg_options.fps_subsample=512",
                 f"data.instseg_options.level_caps={CAPS}".replace(" ", "")]},
    "arch": {"hidden_size": 64, "num_heads": 4, "num_layers": 2,
             "num_blocks": 1, "memories": ["voxel", "mv", "pc"],
             "mv_dim": 768, "num_queries": 16, "max_segments": 64,
             "num_targets": 201, "filter_out_classes": [0, 2],
             "hlevels": [0, 1, 2, 3], "voxel_size": 0.02,
             "fps_subsample": 512, "level_caps": CAPS},
}
TINY_TRAFFIC = {"generator": "instseg_scenes", "scenes": 4,
                "points": [2500, 3000], "instances": 4, "segments": 16,
                "extent": 1.0, "num_labels": 200, "clients": 2,
                "warm_rounds": 1, "sample_count": 2,
                "trace_device": [0.1, 0.3], "trace_host": [0.5, 0.7]}
TINY_CELL = {"config": "tiny_instseg", "traffic": "tiny_scenes",
             "entry": "instseg_serve",
             "entry_args": {"layout": "dev_maps", "batch_size": 2, "max_delay_s": 0.05,
                            "num_workers": 0, "topk": 20},
             "chips": 1, "why": "test size",
             "limits": {"logit_gap": 1e-2, "rank_mismatch": 0}}


def tiny_root(tmp: str) -> str:
    """``tmp`` holding BENCHMARK.json and perfbench/ with the tiny cell
    added."""
    root = os.path.join(tmp, "checkout")
    shutil.copytree(os.path.join(REPO, "perfbench"),
                    os.path.join(root, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    pb = os.path.join(root, "perfbench")
    files = {"configs/tiny_instseg.json": TINY_CONFIG,
             "traffic/tiny_scenes.json": TINY_TRAFFIC,
             "cells/tiny_serve.json": TINY_CELL}
    for rel, obj in files.items():
        with open(os.path.join(pb, rel), "w") as f:
            json.dump(obj, f)
    bench["configs"].append({"name": "tiny_instseg",
                             "source": TINY_CONFIG["source"],
                             "file": "perfbench/configs/tiny_instseg.json",
                             "reduced": ["hidden_size"], "why": "test"})
    bench["workloads"].append({"name": "tiny_serve",
                               "config": "tiny_instseg",
                               "traffic": "tiny_scenes", "chips": 1,
                               "why": "test size"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and "s1_serve_dev_maps" in m["workloads"]:
            m["workloads"].append("tiny_serve")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root
