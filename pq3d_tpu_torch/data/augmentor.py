"""Config-driven augmentation queue; counterpart of
``pq3d_tpu/data/augmentor.py``.

A named pipeline of scene augmentations applied in order, each selected by
name from ``AUGMENTATIONS``.  Every step draws from the caller's
``np.random.Generator`` in the JAX package's order, so the same generator
gives the same scene bit for bit.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np


def random_flip(scene: Dict, rng: np.random.Generator, axes=(0, 1), p=0.5):
    pts = scene["points"]
    for ax in axes:
        if rng.random() < p:
            pts[:, ax] = pts[:, ax].max() - pts[:, ax]
    return scene


def random_rotate_z(scene: Dict, rng: np.random.Generator,
                    max_angle=2 * np.pi):
    theta = rng.uniform(0, max_angle)
    c, s = np.cos(theta), np.sin(theta)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    scene["points"] = scene["points"] @ rot.T
    return scene


def random_scale(scene: Dict, rng: np.random.Generator, lo=0.9, hi=1.1):
    scene["points"] = scene["points"] * rng.uniform(lo, hi)
    return scene


def random_translate(scene: Dict, rng: np.random.Generator, sigma=0.1):
    scene["points"] = scene["points"] + rng.normal(0, sigma, 3).astype(
        np.float32)
    return scene


def color_jitter(scene: Dict, rng: np.random.Generator, sigma=0.05):
    scene["colors"] = np.clip(
        scene["colors"] + rng.normal(0, sigma, scene["colors"].shape), -1, 1
    ).astype(np.float32)
    return scene


def point_dropout(scene: Dict, rng: np.random.Generator, p=0.05):
    keep = rng.random(len(scene["points"])) >= p
    for k in ("points", "colors", "instance_labels", "segment_id"):
        if k in scene:
            scene[k] = scene[k][keep]
    return scene


# the augmentations a config may name, by name (the JAX package keeps them
# in a registry)
AUGMENTATIONS: Dict[str, Callable] = {
    "random_flip": random_flip, "random_rotate_z": random_rotate_z,
    "random_scale": random_scale, "random_translate": random_translate,
    "color_jitter": color_jitter, "point_dropout": point_dropout}


class DataAugmentor:
    """Apply a configured list of augmentations in order.  Config entries:
    a name, or ``{name: ..., args: {...}}``."""

    def __init__(self, aug_list: Sequence):
        self.steps: List = []
        for entry in aug_list or []:
            if isinstance(entry, str):
                name, args = entry, {}
            else:
                name = entry["name"]
                args = dict(entry.get("args", {}) or {})
            if name not in AUGMENTATIONS:
                raise KeyError(f"unknown augmentation {name!r}; known: "
                               f"{sorted(AUGMENTATIONS)}")
            self.steps.append((AUGMENTATIONS[name], args))

    def __call__(self, scene: Dict, rng: np.random.Generator) -> Dict:
        for fn, args in self.steps:
            scene = fn(scene, rng, **args)
        return scene
