"""The port's remaining single-process modules against the JAX package on
the same seeded inputs: the augmentor, the io, metric and box utilities,
the tokenizers' HF branch, ``segment_max``, the pools, ``match_layer``,
``fnv_hash`` and ``voxel_downsample_random``, ``build_block_pack``,
``hierarchy_to_host_format``, the legacy object encoders,
``VoxelLevelEncoder``, ``SemanticEncoder`` with the mixup curriculum, and
``trainer: DefaultTrainer`` through ``run.main``.

Tolerances: the numpy modules are bit-equal; the torch ones within 1e-5
of the scale (max|diff| / max|ref|) in f32, and within 2e-2 where bf16
conv operands round (``VoxelLevelEncoder``, tests/test_torch_model.py's
tolerance).  The io, box and metric cases of tests/test_utils_common.py
are repeated against the port's functions.
"""
import json
import logging
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pq3d_tpu.data import augmentor as jaug
from pq3d_tpu.data import tokenizers as jtok
from pq3d_tpu.models import encoders as jenc
from pq3d_tpu.models import legacy_encoders as jleg
from pq3d_tpu.ops import device_maps as jdm
from pq3d_tpu.ops import kernel_maps as jkm
from pq3d_tpu.ops import segment as jseg
from pq3d_tpu.ops import sparse as jsparse
from pq3d_tpu.ops import voxelize as jvox
from pq3d_tpu.optim import losses as jlosses
from pq3d_tpu.utils import box_utils as jbox
from pq3d_tpu.utils import io_utils as jio
from pq3d_tpu.utils import metric_utils as jmetric
from pq3d_tpu_torch import run as trun
from pq3d_tpu_torch.data import augmentor as taug
from pq3d_tpu_torch.data import tokenizers as ttok
from pq3d_tpu_torch.models import encoders as tenc
from pq3d_tpu_torch.models import legacy_encoders as tleg
from pq3d_tpu_torch.ops import device_maps as tdm
from pq3d_tpu_torch.ops import kernel_maps as tkm
from pq3d_tpu_torch.ops import segment as tseg
from pq3d_tpu_torch.ops import sparse as tsparse
from pq3d_tpu_torch.ops import voxelize as tvox
from pq3d_tpu_torch.optim import losses as tlosses
from pq3d_tpu_torch.serve import to_device
from pq3d_tpu_torch.utils import box_utils as tbox
from pq3d_tpu_torch.utils import io_utils as tio
from pq3d_tpu_torch.utils import metric_utils as tmetric
from pq3d_tpu_torch.utils.weights import load_flax_variables

from test_torch_model import (_batch, _random_variables, _route_small,
                              _spy_routed)
from test_torch_pointnet import random_variables
from test_torch_trainer import TINY

torch.set_num_threads(1)
TOL = 1e-5
CPU = torch.device("cpu")


def _rel(ref, got):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert ref.shape == got.shape
    return float(np.abs(ref - got).max() / (np.abs(ref).max() + 1e-12))


def _scene(seed, n=500):
    rng = np.random.default_rng(seed)
    return {"points": rng.normal(size=(n, 3)).astype(np.float32),
            "colors": rng.uniform(-1, 1, (n, 3)).astype(np.float32),
            "instance_labels": rng.integers(-1, 5, n),
            "segment_id": rng.integers(0, 20, n)}


# ---- data/augmentor.py ---------------------------------------------------

AUG_CASES = [["random_flip"], ["random_rotate_z"], ["random_scale"],
             ["random_translate"], ["color_jitter"],
             [{"name": "point_dropout", "args": {"p": 0.3}}],
             ["random_flip", {"name": "random_rotate_z",
                              "args": {"max_angle": 1.0}},
              {"name": "random_scale", "args": {"lo": 0.5, "hi": 2.0}},
              "random_translate", "color_jitter", "point_dropout"]]


@pytest.mark.parametrize("steps", AUG_CASES,
                         ids=["flip", "rotate_z", "scale", "translate",
                              "color_jitter", "point_dropout", "all"])
def test_augmentor_bit_equal(steps):
    """The same generator gives the same scene, bit for bit."""
    got = taug.DataAugmentor(steps)(_scene(0), np.random.default_rng(7))
    ref = jaug.DataAugmentor(steps)(_scene(0), np.random.default_rng(7))
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k])


def test_augmentor_refuses_unknown_names():
    assert taug.DataAugmentor(None).steps == []
    with pytest.raises(KeyError, match="random_warp"):
        taug.DataAugmentor(["random_warp"])


# ---- utils/io_utils.py, box_utils.py, metric_utils.py --------------------
# (tests/test_utils_common.py's cases, against the port's functions)

def test_ply_roundtrip(tmp_path):
    pts = np.random.default_rng(0).normal(size=(50, 3)).astype(np.float32)
    cols = np.random.default_rng(1).integers(0, 256, (50, 3)).astype(np.uint8)
    p = tmp_path / "cloud.ply"
    tio.save_ply(p, pts, cols)
    back = tio.load_ply(p)
    np.testing.assert_allclose(back["points"], pts, rtol=1e-6)
    np.testing.assert_array_equal(back["colors"], cols)


def test_json_jsonl_pickle_roundtrip(tmp_path):
    obj = {"a": 1, "b": [1, 2, 3]}
    tio.save_json(obj, tmp_path / "x.json")
    assert tio.load_json(tmp_path / "x.json") == obj
    rows = [{"i": i} for i in range(5)]
    tio.save_jsonl(rows, tmp_path / "x.jsonl")
    assert tio.load_jsonl(tmp_path / "x.jsonl") == rows
    tio.save_pickle(obj, tmp_path / "x.pkl")
    assert tio.load_pickle(tmp_path / "x.pkl") == obj


@pytest.mark.parametrize("colors", ["uint8", "unit", None])
def test_io_files_equal_jax(tmp_path, colors):
    """Every saver writes the bytes JAX's writes, and each package reads
    the other's files (binary PLY, and an ASCII PLY)."""
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(40, 3)).astype(np.float32)
    cols = {"uint8": rng.integers(0, 256, (40, 3)).astype(np.uint8),
            "unit": rng.uniform(0, 1, (40, 3)), None: None}[colors]
    tio.save_ply(tmp_path / "t.ply", pts, cols)
    jio.save_ply(tmp_path / "j.ply", pts, cols)
    assert (tmp_path / "t.ply").read_bytes() == \
        (tmp_path / "j.ply").read_bytes()
    for a, b in ((tio, tmp_path / "j.ply"), (jio, tmp_path / "t.ply")):
        got, ref = a.load_ply(b), jio.load_ply(tmp_path / "j.ply")
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])
    ascii_ply = ["ply", "format ascii 1.0", "element vertex 2",
                 "property float x", "property float y", "property float z",
                 "property uchar red", "property uchar green",
                 "property uchar blue", "end_header",
                 "0.5 1 2 1 2 3", "-1 0.25 3 4 5 6"]
    (tmp_path / "a.ply").write_text("\n".join(ascii_ply) + "\n")
    got, ref = tio.load_ply(tmp_path / "a.ply"), jio.load_ply(
        tmp_path / "a.ply")
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    obj = {"x": [1, 2.5, "s"], "y": {"z": None}}
    for name, t_save, j_save in (
            ("o.json", tio.save_json, jio.save_json),
            ("o.jsonl", lambda o, p: tio.save_jsonl([o, o], p),
             lambda o, p: jio.save_jsonl([o, o], p))):
        t_save(obj, tmp_path / "t" / name)
        j_save(obj, tmp_path / "j" / name)
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes()
    assert tio.load_jsonl(tmp_path / "j" / "o.jsonl") == [obj, obj]
    jio.save_pickle(obj, tmp_path / "j.pkl")
    assert tio.load_pickle(tmp_path / "j.pkl") == obj


def test_box3d_iou_identity_and_disjoint():
    c = tbox.get_3d_box([0, 0, 0], [2, 2, 2], 0.0)
    assert tbox.box3d_iou(c, c) == pytest.approx(1.0, abs=1e-6)
    c2 = tbox.get_3d_box([10, 0, 0], [2, 2, 2], 0.0)
    assert tbox.box3d_iou(c, c2) == pytest.approx(0.0, abs=1e-9)


def test_box3d_iou_rotation_invariant_cube():
    a = tbox.get_3d_box([0, 0, 0], [2, 2, 2], 0.0)
    b = tbox.get_3d_box([0, 0, 0], [2, 2, 2], np.pi / 4)
    iou = tbox.box3d_iou(a, b)
    # octagon intersection area = 8*(sqrt(2)-1), volume/union analytic
    inter = 8 * (np.sqrt(2) - 1) * 2
    expect = inter / (8 + 8 - inter)
    assert iou == pytest.approx(expect, rel=1e-3)


def test_box3d_iou_half_shift():
    a = tbox.get_3d_box([0, 0, 0], [2, 2, 2], 0.0)
    b = tbox.get_3d_box([1, 0, 0], [2, 2, 2], 0.0)
    assert tbox.box3d_iou(a, b) == pytest.approx(1 / 3, rel=1e-4)


def test_aabb_iou_matches_box3d_for_axis_aligned():
    rng = np.random.default_rng(2)
    for _ in range(10):
        ca, cb = rng.normal(size=(2, 3))
        sa, sb = rng.uniform(0.5, 2.0, (2, 3))
        a = np.concatenate([ca, sa])
        b = np.concatenate([cb, sb])
        v1 = tbox.aabb_iou(a, b)
        v2 = tbox.box3d_iou(tbox.get_3d_box(ca, sa),
                            tbox.get_3d_box(cb, sb))
        assert v1 == pytest.approx(v2, abs=1e-5)


def test_confusion_matrix():
    cm = tmetric.ConfusionMatrix(3)
    cm.add(np.array([0, 1, 2, 2]), np.array([0, 1, 1, -100]))
    m = cm.metrics()
    np.testing.assert_allclose(cm.per_class_iou()[:2], [1.0, 0.5])
    assert m["oacc"] == pytest.approx(2 / 3)


def test_points_to_aabb():
    pts = np.array([[0, 0, 0], [2, 4, 6]], np.float32)
    box = tbox.points_to_aabb(pts)
    np.testing.assert_allclose(box, [1, 2, 3, 2, 4, 6])


def test_boxes_bit_equal_jax():
    """Oriented boxes at random centres, sizes and headings (rotated,
    overlapping, nested and disjoint pairs): corners, both IoUs and both
    box conversions bit-equal to JAX's."""
    rng = np.random.default_rng(5)
    for i in range(40):
        c = rng.normal(0, 1 if i % 4 else 0.1, (2, 3))
        s = rng.uniform(0.3, 2.5, (2, 3))
        h = rng.uniform(-np.pi, np.pi, 2) if i % 3 else np.zeros(2)
        np.testing.assert_array_equal(tbox.rotz(h[0]), jbox.rotz(h[0]))
        ta = [tbox.get_3d_box(c[k], s[k], h[k]) for k in range(2)]
        ja = [jbox.get_3d_box(c[k], s[k], h[k]) for k in range(2)]
        for t, j in zip(ta, ja):
            np.testing.assert_array_equal(t, j)
            np.testing.assert_array_equal(tbox.corners_to_aabb(t),
                                          jbox.corners_to_aabb(j))
        assert tbox.box3d_iou(*ta) == jbox.box3d_iou(*ja)
        a, b = (np.concatenate([c[k], s[k]]) for k in range(2))
        assert tbox.aabb_iou(a, b) == jbox.aabb_iou(a, b)
    pts = rng.normal(size=(30, 3)).astype(np.float32)
    np.testing.assert_array_equal(tbox.points_to_aabb(pts),
                                  jbox.points_to_aabb(pts))


def test_metrics_bit_equal_jax():
    rng = np.random.default_rng(6)
    tcm, jcm = tmetric.ConfusionMatrix(7), jmetric.ConfusionMatrix(7)
    for _ in range(3):
        pred = rng.integers(-2, 9, 300)
        gt = rng.integers(-1, 8, 300)
        gt[rng.random(300) < 0.1] = -100
        tcm.add(pred, gt)
        jcm.add(pred, gt)
    np.testing.assert_array_equal(tcm.mat, jcm.mat)
    assert tcm.metrics() == jcm.metrics()
    np.testing.assert_array_equal(tcm.per_class_iou(), jcm.per_class_iou())
    tcm.reset()
    assert not tcm.mat.any() and tcm.metrics()["oacc"] == 0.0
    a, b = rng.random(50) < 0.4, rng.random(50) < 0.5
    w = rng.uniform(0, 3, 50)
    assert tmetric.mask_iou(a, b) == jmetric.mask_iou(a, b)
    assert tmetric.mask_iou(a, b, w) == jmetric.mask_iou(a, b, w)
    assert tmetric.mask_iou(np.zeros(5), np.zeros(5)) == 0.0


# ---- data/tokenizers.py: the HF branch ----------------------------------

class _FakeHF:
    """Stands in for a loaded HF tokenizer (no files are fetched)."""

    def __call__(self, s, truncation, max_length):
        return type("Enc", (), {"input_ids": [len(w) for w in s.split()]
                                [:max_length]})()

    def decode(self, ids, skip_special_tokens):
        return " ".join(str(i) for i in ids)


def test_tokenizers_pickle_roundtrip():
    """tests/test_loader_workers.py's pickling cases: every tokenizer
    callable and the bundle round-trip through pickle."""
    syn = ttok.SyntheticTokenize(16)
    assert pickle.loads(pickle.dumps(syn))("abc") == syn("abc")
    hf = ttok.HFTokenize("no-such-model", 32)
    hf2 = pickle.loads(pickle.dumps(hf))
    assert (hf2.name, hf2.max_length, hf2._t) == ("no-such-model", 32, None)
    de = pickle.loads(pickle.dumps(ttok.HFDetokenize("no-such-model")))
    assert de._t is None
    bundle = ttok.build_tokenizers({"data_wrapper": {}})
    b2 = pickle.loads(pickle.dumps(bundle))
    assert b2.tokenize("hello") == bundle.tokenize("hello")
    assert b2.detokenize(np.array([3, 5, 0])) == \
        bundle.detokenize(np.array([3, 5, 0]))
    assert (b2.prompt_name, b2.gen_name, b2.is_real) == \
        ("synthetic", "synthetic", False)


def test_failing_hf_name_warns_and_falls_back_as_jax(monkeypatch, caplog):
    """A name that cannot load gives JAX's warning and the synthetic
    bundle with JAX's ids; a name that loads gives HF wrappers."""
    import transformers

    def refuse(name, **kw):
        raise OSError(f"no tokenizer files for {name}")
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        refuse)
    cfg = {"data_wrapper": {"tokenizer": "no-such-model",
                            "generation_tokenizer": "no-such-t5"}}
    with caplog.at_level(logging.WARNING):
        got = ttok.build_tokenizers(cfg)
    port_msgs = [r.getMessage() for r in caplog.records]
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        ref = jtok.build_tokenizers(cfg)
    jax_msgs = [r.getMessage() for r in caplog.records]
    assert port_msgs == jax_msgs and len(port_msgs) == 2
    assert "falling back to the synthetic tokenizer" in port_msgs[0]
    assert (got.prompt_name, got.gen_name, got.is_real) == \
        (ref.prompt_name, ref.gen_name, ref.is_real) == \
        ("synthetic", "synthetic", False)
    for s in ("find the chair", "", "a" * 120):
        assert got.tokenize(s) == ref.tokenize(s)
        assert got.gen_tokenize(s) == ref.gen_tokenize(s)
    ids = np.array([4, 2, 9, 1, 0, 0])
    assert got.detokenize(ids) == ref.detokenize(ids)

    seen = []
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        lambda name, **kw: seen.append(kw) or _FakeHF())
    real = ttok.build_tokenizers(cfg)
    assert real.is_real and (real.prompt_name, real.gen_name) == \
        ("no-such-model", "no-such-t5")
    assert all(kw.get("local_files_only") for kw in seen)
    assert real.tokenize("a bb ccc") == [1, 2, 3]
    assert real.detokenize(np.array([7, 3, 0])) == "7 3"
    again = pickle.loads(pickle.dumps(real))
    assert again.tokenize._t is None and again.tokenize("dd e") == [2, 1]


# ---- ops: segment_max, pools, voxelize, block pack, host format ---------

@pytest.mark.parametrize("fill", [0.0, -7.5])
def test_segment_max_matches_jax(fill):
    rng = np.random.default_rng(8)
    x = rng.normal(size=(60, 5)).astype(np.float32)
    ids = rng.integers(0, 9, 60).astype(np.int32)   # 8 = the trash bucket
    ids[ids == 3] = 4                                # segment 3 is empty
    ref = jseg.segment_max(jnp.asarray(x), jnp.asarray(ids), 8, fill)
    got = tseg.segment_max(torch.from_numpy(x), torch.from_numpy(ids), 8,
                           fill)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (got[3] == fill).all()


def test_pools_match_jax():
    rng = np.random.default_rng(9)
    xc = rng.normal(size=(12, 6)).astype(np.float32)
    anc = rng.integers(-1, 12, 40).astype(np.int32)
    valid = rng.random(40) < 0.8
    ref = jsparse.pool_transpose(jnp.asarray(xc), jnp.asarray(anc),
                                 jnp.asarray(valid))
    got = tsparse.pool_transpose(torch.from_numpy(xc), torch.from_numpy(anc),
                                 torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    got = tsparse.pool_transpose(torch.from_numpy(xc), torch.from_numpy(anc))
    ref = jsparse.pool_transpose(jnp.asarray(xc), jnp.asarray(anc))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    x = rng.normal(size=(40, 6)).astype(np.float32)
    child = rng.integers(-1, 40, (12, 8)).astype(np.int32)
    child[3] = -1                                    # a row with no child
    ref = jsparse.avg_pool_stride2(jnp.asarray(x), jnp.asarray(child))
    got = tsparse.avg_pool_stride2(torch.from_numpy(x),
                                   torch.from_numpy(child))
    assert _rel(ref, got.numpy()) <= TOL
    assert (got[3] == 0).all()


def test_voxelize_bit_equal_jax():
    rng = np.random.default_rng(10)
    coords = rng.integers(-50, 50, (300, 3)).astype(np.int32)
    np.testing.assert_array_equal(tvox.fnv_hash(coords),
                                  jvox.fnv_hash(coords))
    pts = rng.normal(size=(2000, 3)).astype(np.float32)
    got = tvox.voxel_downsample_random(pts, 0.2, np.random.default_rng(1))
    ref = jvox.voxel_downsample_random(pts, 0.2, np.random.default_rng(1))
    np.testing.assert_array_equal(got, ref)
    assert len(np.unique(np.floor(pts[got] / 0.2), axis=0)) == len(got)


@pytest.mark.parametrize("block", [4, 8])
def test_block_pack_bit_equal_jax(block):
    rng = np.random.default_rng(11)
    coords = np.unique(rng.integers(0, 40, (500, 3)), axis=0).astype(
        np.int32)
    got = tkm.build_block_pack(coords, block)
    ref = jkm.build_block_pack(coords, block)
    assert set(got) == set(ref) and got["n_blocks"] == ref["n_blocks"]
    for k in ("vox_slot", "nbr_blocks"):
        assert got[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(got[k], ref[k])


def test_hierarchy_to_host_format_matches_jax():
    b = _batch()
    maps = {k: v for k, v in b["maps"].items()}
    got = tdm.hierarchy_to_host_format(to_device(maps, CPU))
    ref = jdm.hierarchy_to_host_format(
        {k: jnp.asarray(v) for k, v in maps.items()})
    assert set(got) == set(ref)
    for k in ref:
        assert isinstance(got[k], np.ndarray)
        np.testing.assert_array_equal(got[k], ref[k])


# ---- optim/losses.py: match_layer ---------------------------------------

def test_match_layer_matches_jax():
    rng = np.random.default_rng(12)
    b, q, m, s, c = 2, 8, 5, 20, 6
    cls = rng.normal(size=(b, q, c)).astype(np.float32)
    masks = rng.normal(size=(b, s, q)).astype(np.float32)
    labels = rng.integers(0, c - 1, (b, m)).astype(np.int32)
    labels[0, 1] = -100
    tgt = rng.random((b, m, s)) < 0.4
    inst_valid = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], bool)
    seg_valid = rng.random((b, s)) < 0.9
    args = (cls, masks, labels, tgt, inst_valid, seg_valid)
    ref = np.asarray(jlosses.match_layer(
        *(jnp.asarray(a) for a in args), jlosses.InstSegLossConfig(
            num_classes=c - 1)))
    got = tlosses.match_layer(
        *(torch.from_numpy(a) for a in args),
        tlosses.InstSegLossConfig(num_classes=c - 1)).numpy()
    assert got.shape == (b, m)
    np.testing.assert_array_equal(got[inst_valid], ref[inst_valid])
    for row in got:                  # padded targets take distinct queries
        assert len(set(row.tolist())) == m


# ---- models/legacy_encoders.py ------------------------------------------

def _clouds(b=1, o=2, p=48, seed=13):
    rng = np.random.default_rng(seed)
    pcds = np.concatenate([rng.uniform(-1, 1, (b, o, p, 3)),
                           rng.uniform(0, 1, (b, o, p, 3))], -1)
    locs = rng.normal(size=(b, o, 6))
    return pcds.astype(np.float32), locs.astype(np.float32)


@pytest.mark.parametrize("hidden", [768, 64])
def test_pcd_obj_encoder_matches_jax(hidden):
    pcds, _ = _clouds()
    jm = jleg.PcdObjEncoder(hidden_size=hidden)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0),
                                            jnp.asarray(pcds)))
    variables = random_variables(shapes, 1)
    ref = jax.jit(lambda v: jm.apply(v, jnp.asarray(pcds)))(variables)
    tm = tleg.PcdObjEncoder(hidden_size=hidden).eval()
    load_flax_variables(tm, variables)
    with torch.no_grad():
        got = tm(torch.from_numpy(pcds))
    assert (tm.Dense_0 is None) == (hidden == 768)
    assert _rel(ref, got.numpy()) <= TOL


def test_point_tokenize_encoder_matches_jax():
    pcds, locs = _clouds(b=2, o=3)
    valid = np.array([[1, 1, 0], [1, 1, 1]], bool)
    jm = jleg.PointTokenizeEncoder(hidden_size=64, num_layers=2,
                                   num_heads=4)
    args = (jnp.asarray(pcds), jnp.asarray(locs), jnp.asarray(valid))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), *args))
    variables = random_variables(shapes, 2)
    ref = jax.jit(lambda v: jm.apply(v, *args))(variables)
    tm = tleg.PointTokenizeEncoder(hidden_size=64, num_layers=2,
                                   num_heads=4).eval()
    load_flax_variables(tm, variables)
    with torch.no_grad():
        got = tm(torch.from_numpy(pcds), torch.from_numpy(locs),
                 torch.from_numpy(valid))
    assert _rel(ref, got.numpy()) <= TOL


# ---- models/encoders.py: VoxelLevelEncoder, SemanticEncoder, mixup ------

@pytest.mark.parametrize("pallas_conv", [False, True])
def test_voxel_level_encoder_matches_jax(pallas_conv, monkeypatch):
    """The U-Net's mask features and per-level features at (B, P_l), bf16
    conv operands on both sides (2e-2, as tests/test_torch_model.py); with
    ``pallas_conv`` the small levels route to B1 (its plain version
    here)."""
    b = _batch()
    maps_j = {k: jnp.asarray(v) for k, v in b["maps"].items()}
    x = jnp.asarray(b["voxel_feats"])
    jm = jenc.VoxelLevelEncoder(hidden_size=32, hlevels=(0, 1, 3))
    variables = _random_variables(
        lambda: jm.init(jax.random.key(0), x, maps_j, train=False))
    ref_mask, ref_scales = jax.jit(
        lambda v: jm.apply(v, x, maps_j, train=False))(variables)
    _route_small(monkeypatch, 128)
    tm = tenc.VoxelLevelEncoder(hidden_size=32, hlevels=(0, 1, 3),
                                pallas_conv=pallas_conv).eval()
    load_flax_variables(tm, variables)
    routed = _spy_routed(monkeypatch, tm)
    with torch.no_grad():
        got_mask, got_scales = tm(torch.from_numpy(b["voxel_feats"]),
                                  to_device(b["maps"], CPU))
    assert bool(routed) == pallas_conv
    assert got_mask.shape == ref_mask.shape
    assert _rel(ref_mask, got_mask.numpy()) <= 2e-2
    assert len(got_scales) == len(ref_scales) == 3
    for r, g in zip(ref_scales, got_scales):
        assert _rel(r, g.numpy()) <= 2e-2


def test_voxel_level_encoder_frozen_backbone_takes_no_gradient():
    b = _batch()
    tm = tenc.VoxelLevelEncoder(hidden_size=32, hlevels=(0,),
                                freeze_backbone=True).train()
    assert not tm.backbone.training and tm.mask_proj.training
    mask, scales = tm(torch.from_numpy(b["voxel_feats"]),
                      to_device(b["maps"], CPU))
    (mask.sum() + scales[0].sum()).backward()
    assert all(p.grad is None for p in tm.backbone.parameters())
    assert tm.mask_proj.Dense_0.weight.grad is not None


@pytest.mark.parametrize("use_matmul_label", [False, True])
@pytest.mark.parametrize("mixup", [0.0, 0.3])
def test_semantic_encoder_matches_jax(use_matmul_label, mixup):
    rng = np.random.default_rng(14)
    logits = [rng.normal(size=(2, 6, 11)).astype(np.float32)
              for _ in range(3)]
    labels = rng.integers(-1, 11, (2, 6)).astype(np.int32)
    jm = jenc.SemanticEncoder(hidden_size=24, embed_dim=10, num_classes=11,
                              use_matmul_label=use_matmul_label)
    jargs = ([jnp.asarray(l) for l in logits], jnp.asarray(labels), mixup)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), *jargs))
    variables = random_variables(shapes, 3)
    assert "semantic_embedding" in variables["buffers"]
    ref_emb, ref_logits = jax.jit(lambda v: jm.apply(v, *jargs))(variables)
    tm = tenc.SemanticEncoder(hidden_size=24, embed_dim=10, num_classes=11,
                              use_matmul_label=use_matmul_label).eval()
    load_flax_variables(tm, variables)
    with torch.no_grad():
        emb, out_logits = tm([torch.from_numpy(l) for l in logits],
                             torch.from_numpy(labels), mixup)
    assert _rel(ref_logits, out_logits.numpy()) <= TOL
    assert _rel(ref_emb, emb.numpy()) <= TOL


def test_mixup_and_decay_match_jax():
    rng = np.random.default_rng(15)
    probs = rng.dirichlet(np.ones(7), (3, 4)).astype(np.float32)
    labels = rng.integers(-1, 7, (3, 4)).astype(np.int32)
    for ratio in (0.0, 0.25, 1.0):
        ref = jenc.mixup_predictions(jnp.asarray(probs), jnp.asarray(labels),
                                     ratio)
        got = tenc.mixup_predictions(torch.from_numpy(probs),
                                     torch.from_numpy(labels), ratio)
        assert _rel(ref, got.numpy()) <= TOL
    for step in (0, 10, 33, 50, 71, 90, 100, 120):
        ref = jenc.linear_decay_mixup_ratio(step, 100, 0.3, 0.8)
        got = tenc.linear_decay_mixup_ratio(step, 100, 0.3, 0.8)
        assert float(got) == pytest.approx(float(ref), abs=1e-7)
    got = tenc.linear_decay_mixup_ratio(torch.tensor(55), 100, 0.3, 0.8)
    assert float(got) == pytest.approx(0.5, abs=1e-6)


# ---- train/trainer.py: DefaultTrainer through run.main -------------------

def _train_losses(exp):
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        return [r["loss"] for r in map(json.loads, f)
                if r["prefix"] == "train"]


def test_default_trainer_runs_as_query3d_trainer(tmp_path, monkeypatch):
    """``trainer: DefaultTrainer`` (which run.py refused) trains through
    run.main with the same losses as ``Query3DTrainer``."""
    from pq3d_tpu_torch.train.trainer import DefaultTrainer, Query3DTrainer
    monkeypatch.setattr(Query3DTrainer, "install_preemption_handler",
                        lambda self, signals=None: None)
    losses = {}
    for name in ("Query3DTrainer", "DefaultTrainer"):
        exp = str(tmp_path / name)
        trainer = trun.main(["--config-name", "instseg_sceneverse", *TINY,
                             f"trainer={name}", "solver.epochs=1",
                             "solver.epochs_per_eval=0", f"exp_dir={exp}"])
        assert type(trainer).__name__ == name
        losses[name] = _train_losses(exp)
    assert issubclass(DefaultTrainer, Query3DTrainer)
    assert len(losses["DefaultTrainer"]) == 1
    assert losses["DefaultTrainer"] == losses["Query3DTrainer"]
    with pytest.raises(NotImplementedError, match="NoSuchTrainer"):
        trun.main(["--config-name", "instseg_sceneverse", *TINY,
                   "trainer=NoSuchTrainer", f"exp_dir={tmp_path / 'x'}"])
