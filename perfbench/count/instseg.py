"""Operations that one stage-1 forward of one scene needs, from shapes.

A multiply-add counts 2.  Sparse convs count the valid (row, tap)
references of the scene's real voxels, not the padded caps; matrix
products count the real segments and the queries.  Normalisations,
softmaxes, gathers and the map build are not counted.  The backbone's
``final`` layer, whose output the served answer never reads, is not
counted.
"""
from __future__ import annotations

import re
from typing import Dict, Sequence, Tuple

BACKBONE = "voxel_encoder.backbone."
# the level each residual stage runs at: encoder stages 1-4, decoder 5-8
STAGE_LEVEL = {1: 1, 2: 2, 3: 3, 4: 4, 5: 3, 6: 2, 7: 1, 8: 0}


def backbone_flops(shapes: Dict[str, Tuple[int, ...]], n: Sequence[int],
                   pairs3: Sequence[float], pairs_stem: float) -> float:
    """The U-Net's operations on a scene of ``n[l]`` voxels at level l
    with ``pairs3[l]`` valid 3^3 references there and ``pairs_stem`` of
    the stem's kernel at level 0; channels from the kernels' shapes."""
    total = 0.0
    for name, shape in shapes.items():
        if not name.startswith(BACKBONE):
            continue
        local = name[len(BACKBONE):]
        if local == "conv0.kernel":
            total += 2.0 * pairs_stem * shape[1] * shape[2]
        elif m := re.fullmatch(r"conv(\d)s2\.kernel", local):
            total += 2.0 * n[int(m.group(1)) - 1] * shape[1] * shape[2]
        elif m := re.fullmatch(r"convtr(\d)\.kernel", local):
            fine = 3 - (int(m.group(1)) - 4)
            total += 2.0 * n[fine] * shape[1] * shape[2]
        elif m := re.fullmatch(r"stage(\d)\.block\d+\.conv\d\.kernel", local):
            lvl = STAGE_LEVEL[int(m.group(1))]
            total += 2.0 * pairs3[lvl] * shape[1] * shape[2]
        elif m := re.fullmatch(r"stage(\d)\.block\d+\.downsample_conv\.weight",
                               local):
            lvl = STAGE_LEVEL[int(m.group(1))]
            total += 2.0 * n[lvl] * shape[0] * shape[1]
    return total


def decoder_flops(shapes: Dict[str, Tuple[int, ...]], queries: int,
                  segments: int, layers: int, blocks: int,
                  memories: int = 3) -> float:
    """The segment projections, the object encoders, every decoder round
    (cross attention to each memory, spatial self-attention, FFN) and
    every round of the mask head, for ``queries`` queries over
    ``segments`` real segments."""
    Q, S = queries, segments
    D = shapes["mask_head.cls_head.Dense_0.weight"][0]
    T = shapes["mask_head.cls_head.Dense_1.weight"][0]
    Fw = shapes["unified_encoder.layer0.ffn.Dense_0.weight"][0]
    total = 0.0
    i = 0
    while f"voxel_encoder.feat_proj_{i}.Dense_0.weight" in shapes:
        total += 2.0 * S * shapes[
            f"voxel_encoder.feat_proj_{i}.Dense_0.weight"][1] * D
        i += 1
    for m in ("mv", "pc"):
        w = shapes.get(f"{m}_encoder.input_feat_proj.weight")
        if w is not None:
            total += 2.0 * S * w[1] * w[0]
    # positions of the queries and the segments
    total += 2.0 * (Q + S) * D * D
    cross = 2.0 * (2 * Q * D * D + 2 * S * D * D + 2 * Q * S * D)
    spatial = 2.0 * (4 * Q * D * D + Q * Q * D * 2)
    ffn = 2.0 * 2 * Q * D * Fw
    total += layers * blocks * (memories * cross + spatial + ffn)
    head = 2.0 * (Q * D * D + Q * D * T
                  + memories * (S * D * D + Q * D * D + S * Q * D))
    total += (layers * blocks + 1) * head
    return total


def scene_flops(shapes: Dict[str, Tuple[int, ...]], stats: Dict,
                arch: Dict) -> float:
    """One scene's forward: ``stats`` holds ``n``, ``pairs3``,
    ``pairs_stem`` and ``segments`` (real ones, at most the cap)."""
    return (backbone_flops(shapes, stats["n"], stats["pairs3"],
                           stats["pairs_stem"])
            + decoder_flops(shapes, arch["num_queries"], stats["segments"],
                            arch["num_layers"], arch["num_blocks"]))
