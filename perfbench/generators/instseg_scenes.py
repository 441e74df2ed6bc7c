"""Stage-1 traffic: a fixed set of synthetic scans served by a closed loop
of clients.

Frozen copies, so that a change to the port cannot move the traffic:

- ``make_scene``: ``pq3d_tpu_torch/data/synthetic.make_scene`` (box
  instances over a floor slab, per-point instance ids, a grid
  over-segmentation split per instance), unchanged;
- ``make_scenes``: the scene set of ``chip_smoke.make_scenes`` (sizes
  cycling over ``points``, instance classes clipped to the label range),
  drawn from the run's seed.

Every seed gives the same list of sizes; the seed moves the geometry and
the order in which each client sends its scenes.  Client ``c`` owns the
scenes ``c, c + clients, c + 2 * clients, ...``, so no two requests in
flight are of one scene.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def make_scene(rng: np.random.Generator, n_points: int = 20000,
               n_instances: int = 8, n_segments: int = 64,
               extent: float = 5.0) -> Dict[str, np.ndarray]:
    """A scan dict: points (N,3), colors (N,3) in [-1,1], instance_labels
    (N,), segment_id (N,), inst_labels (n_inst,) class ids."""
    pts = []
    inst = []
    n_floor = n_points // 4
    floor = np.zeros((n_floor, 3), np.float32)
    floor[:, 0] = rng.random(n_floor) * extent
    floor[:, 1] = rng.random(n_floor) * extent
    floor[:, 2] = rng.random(n_floor) * 0.05
    pts.append(floor)
    inst.append(np.full(n_floor, -1))

    per_obj = (n_points - n_floor) // n_instances
    for i in range(n_instances):
        center = rng.random(3) * np.array([extent, extent, 1.5]) + \
            np.array([0, 0, 0.2])
        size = rng.random(3) * 0.6 + 0.2
        # points on a box surface
        p = (rng.random((per_obj, 3)) - 0.5) * size
        face = rng.integers(0, 3, per_obj)
        sign = rng.choice([-0.5, 0.5], per_obj)
        p[np.arange(per_obj), face] = sign * size[face]
        pts.append((center + p).astype(np.float32))
        inst.append(np.full(per_obj, i))

    points = np.concatenate(pts)
    instance_labels = np.concatenate(inst)
    n = len(points)
    colors = (rng.random((n, 3)) * 2 - 1).astype(np.float32)

    # over-segmentation: spatial grid cells, split per instance
    cell = extent / max(2, int(np.sqrt(n_segments)))
    seg_key = np.floor(points[:, :2] / cell).astype(np.int64)
    seg_key = seg_key[:, 0] * 1000 + seg_key[:, 1]
    seg_key = seg_key + (instance_labels + 1) * 1000000
    _, segment_id = np.unique(seg_key, return_inverse=True)

    inst_labels = rng.integers(3, 50, n_instances)  # class ids, avoid 0/2
    return {
        "points": points,
        "colors": colors,
        "instance_labels": instance_labels.astype(np.int64),
        "segment_id": segment_id.astype(np.int64),
        "inst_labels": inst_labels.astype(np.int64),
    }


def make_scenes(seed: int, params: Dict) -> List[Dict[str, np.ndarray]]:
    """``params["scenes"]`` scans, scene i of ``params["points"][i % len]``
    points, ``instances`` boxes, ``segments`` over-segmentation cells and
    room side ``extent`` metres, from ``default_rng(seed)``; each carries
    its ``scan_id``."""
    rng = np.random.default_rng(seed)
    sizes = params["points"]
    scenes = []
    for i in range(params["scenes"]):
        s = make_scene(rng, n_points=sizes[i % len(sizes)],
                       n_instances=params["instances"],
                       n_segments=params["segments"],
                       extent=params.get("extent", 5.0))
        s["inst_labels"] = np.minimum(s["inst_labels"],
                                      params["num_labels"] - 1)
        s["scan_id"] = f"scene{i:03d}"
        scenes.append(s)
    return scenes


def client_orders(seed: int, n_scenes: int, clients: int,
                  length: int) -> List[List[int]]:
    """Each client's sequence of scene indices: its own scenes (``c``,
    ``c + clients``, ...) in a seeded order, the order redrawn each pass,
    ``length`` long."""
    rng = np.random.default_rng([seed, 1])
    orders = []
    for c in range(clients):
        own = np.arange(c, n_scenes, clients)
        seq: List[int] = []
        while len(seq) < length:
            seq.extend(int(i) for i in rng.permutation(own))
        orders.append(seq[:length])
    return orders
