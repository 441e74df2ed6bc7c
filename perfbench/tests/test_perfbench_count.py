"""The yardstick's arithmetic against hand counts at tiny shapes: the
operation counts, the roofline bounds and the trace's busy and idle
time."""
from __future__ import annotations

import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)
from perfbench.count import instseg, roofline  # noqa: E402
from perfbench.trace import Trace  # noqa: E402

B = "voxel_encoder.backbone."


def test_backbone_flops_by_hand():
    shapes = {B + "conv0.kernel": (125, 3, 4),
              B + "conv1s2.kernel": (8, 4, 4),
              B + "stage1.block0.conv1.kernel": (27, 4, 6),
              B + "stage1.block0.downsample_conv.weight": (6, 4),
              B + "convtr7.kernel": (8, 6, 5),
              B + "stage8.block0.conv2.kernel": (27, 5, 5),
              B + "final.weight": (200, 5),
              "mask_head.cls_head.Dense_0.weight": (8, 8)}
    n = [100, 40, 0, 0, 0]
    pairs3 = [900, 300, 0, 0, 0]
    want = (2 * 2000 * 3 * 4          # stem over its 2000 references
            + 2 * 100 * 4 * 4         # down conv: every level-0 voxel once
            + 2 * 300 * 4 * 6         # a level-1 3^3 conv
            + 2 * 40 * 4 * 6          # the level-1 1x1 downsample
            + 2 * 100 * 6 * 5         # transpose conv onto level 0
            + 2 * 900 * 5 * 5)        # a level-0 3^3 conv
    assert instseg.backbone_flops(shapes, n, pairs3, 2000) == want


def test_decoder_flops_by_hand():
    D, T, F, Q, S = 8, 5, 16, 3, 4
    shapes = {"mask_head.cls_head.Dense_0.weight": (D, D),
              "mask_head.cls_head.Dense_1.weight": (T, D),
              "unified_encoder.layer0.ffn.Dense_0.weight": (F, D),
              "voxel_encoder.feat_proj_0.Dense_0.weight": (D, 6),
              "mv_encoder.input_feat_proj.weight": (D, 7)}
    proj = 2 * S * 6 * D + 2 * S * 7 * D + 2 * (Q + S) * D * D
    cross = 2 * (2 * Q * D * D + 2 * S * D * D + 2 * Q * S * D)
    spatial = 2 * (4 * Q * D * D + 2 * Q * Q * D)
    ffn = 2 * 2 * Q * D * F
    rounds = 2 * 1
    head = 2 * (Q * D * D + Q * D * T + 3 * (S * D * D + Q * D * D
                                              + S * Q * D))
    want = proj + rounds * (3 * cross + spatial + ffn) + (rounds + 1) * head
    assert instseg.decoder_flops(shapes, Q, S, 2, 1) == want


def test_conv_bound_and_peaks():
    peaks = roofline.peaks_for("NVIDIA H100 80GB HBM3")
    assert peaks == (989e12, 3.35e12)
    assert roofline.peaks_for("cpu") is None
    ms, what, flops, nbytes = roofline.conv_bound(
        128, 96, 96, 1000, roofline.zrun_plan_bytes(128, True), *peaks,
        x_bytes=2)
    assert flops == 2 * 1000 * 96 * 96
    assert nbytes == (128 * 96 * 2 + 27 * 96 * 96 * 2
                      + 128 * (36 + 27 + 1) + 128 * 96 * 4)
    assert what == "bytes"
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3)
    assert roofline.bound_of(989e9, 1, *peaks) == (pytest.approx(1.0),
                                                   "operations")


def test_trace_busy_idle_and_gaps():
    tr = Trace(device=[("k1", 0.0, 1.0), ("k2", 0.5, 1.5),
                       ("Memcpy HtoD", 3.0, 3.5), ("k1", 4.0, 4.25)],
               host=[("aten::copy_", 1.6, 2.9, []),
                     ("aten::to", 1.5, 3.0, [])],
               start=0.0, end=5.0)
    assert tr.busy_s() == pytest.approx(1.5 + 0.5 + 0.25)
    assert tr.window_s == 5.0
    assert len(tr.kernels()) == 3
    gaps = tr.idle_gaps()
    assert gaps[0] == ["aten::copy_", pytest.approx(1.5)]
    assert gaps[1][1] == pytest.approx(0.75)
    ops = dict((n, s) for n, s in tr.top_ops())
    assert ops["k1"] == pytest.approx(1.25)
