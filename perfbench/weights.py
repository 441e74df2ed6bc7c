"""Random weights from the run's seed, made on the device in one call.

One ``torch.randn`` on a generator seeded with the run's seed fills a
buffer as long as all floating tensors of the state dict together; each
tensor is a slice of it, scaled by a rule on its name and shape:

- sparse conv kernels (K, Cin, Cout): He-normal over K * Cin;
- linear weights (out, in): normal with variance 1 / in;
- the Fourier projection ``gauss_B``: N(0, 1);
- norm scales 1 + N(0, 0.02^2);
- batch-norm running means N(0, 0.1^2), running variances 1 + |N(0, 0.1^2)|;
- every bias 0, as the port's own initialisation has them, but those of
  the segment projections, which ``centre_projections`` sets.

Random weights alone make every segment look alike to the mask head: the
pooled features are means of ReLU outputs, which share one large
direction, so each query's mask logits fall on one side of 0 for every
segment and each attend mask is all-true (or all-false, which the decoder
turns into all-true).  ``centre_projections`` gives each segment
projection ``voxel_encoder.feat_proj_<i>.Dense_0`` the bias that takes
the mean pooled feature of its scale, over the real segments of a few of
the run's own scenes, to 0, as a trained network's statistics would:
the projected segments then differ, the mask logits change sign from
segment to segment, and the attend masks are mixed.

Both sides, the program and the plain reference, get these tensors.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def _rule(name: str, shape: Tuple[int, ...]):
    """(std, mean, absolute) of the tensor ``name`` of ``shape``."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "kernel":
        return math.sqrt(2.0 / (shape[0] * shape[1])), 0.0, False
    if leaf == "gauss_B":
        return 1.0, 0.0, False
    if leaf == "mean":
        return 0.1, 0.0, False
    if leaf == "var":
        return 0.1, 1.0, True
    if leaf in ("weight", "scale") and len(shape) == 1:
        return 0.02, 1.0, False
    if leaf == "bias":
        return 0.0, 0.0, False
    if len(shape) == 2:
        return math.sqrt(1.0 / shape[1]), 0.0, False
    return 0.02, 0.0, False


def make_state(shapes: Dict[str, Tuple[Tuple[int, ...], torch.dtype]],
               seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: tensor} for every floating entry of ``shapes`` (name ->
    (shape, dtype)), drawn on ``device`` from ``seed``."""
    names = [n for n, (_, dt) in shapes.items() if dt.is_floating_point]
    sizes = [math.prod(shapes[n][0]) for n in names]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    for name, part in zip(names, torch.split(flat, sizes)):
        shape, dtype = shapes[name]
        std, mean, absolute = _rule(name, shape)
        t = part.view(shape) * std
        if absolute:
            t = t.abs()
        out[name] = (t + mean).to(dtype)
    return out


def centre_projections(state: Dict[str, torch.Tensor], scenes: List[Dict],
                       arch: Dict, device) -> Dict[str, torch.Tensor]:
    """{``voxel_encoder.feat_proj_<i>.Dense_0.bias``: minus the weight
    times the mean pooled feature of scale i over the real segments of
    ``scenes``}, the pooled features from the plain reference's backbone
    under ``state``."""
    from perfbench.reference import instseg as ref
    S = arch["max_segments"]
    sums: List[torch.Tensor] = []
    total = 0
    with torch.no_grad():
        for scene in scenes:
            coords, feats, v2s = ref.voxel_inputs(scene, arch["voxel_size"])
            maps, parent = ref.backbone(
                state, torch.as_tensor(feats, dtype=torch.float32,
                                       device=device),
                torch.as_tensor(coords, device=device))
            pooled, count = ref.pooled_segments(
                maps, parent, torch.as_tensor(v2s, device=device), S,
                arch["hlevels"])
            real = count > 0
            total += int(real.sum())
            for i, x in enumerate(pooled):
                s = x[real].sum(0)
                if len(sums) <= i:
                    sums.append(s)
                else:
                    sums[i] = sums[i] + s
    out = {}
    for i, s in enumerate(sums):
        name = f"voxel_encoder.feat_proj_{i}.Dense_0."
        out[name + "bias"] = -(state[name + "weight"] @ (s / total))
    return out
