"""The port's SceneVerse reader against the JAX package's: the replica
writer (every file equal, arrays exact), the stage-1 scan dataset, the
seven stage-2 task datasets with gt and predicted objects, their loader
batches, the label converter and the answer vocabularies.  Both packages
read the same numpy and ``.pth`` files; everything must be exactly equal.
The cases of tests/test_sceneverse_real.py and tests/test_replica.py are
repeated on the port."""
import json
import os
from collections import Counter

import numpy as np
import pytest
import torch
from scipy import sparse as sp

from pq3d_tpu.config.config import Config
from pq3d_tpu.data import label_utils as jlabel
from pq3d_tpu.data import sceneverse as jsv
from pq3d_tpu.data import tokenizers as jtok
from pq3d_tpu.data import unified_loader as jloader
from pq3d_tpu.data import unified_pipeline as jup
from pq3d_tpu.data.datasets import SceneVerseInstSeg as JInstSeg
from pq3d_tpu.data.replica import ReplicaSpec as JSpec
from pq3d_tpu.data.replica import write_replica as jwrite
from pq3d_tpu_torch.data import label_utils as tlabel
from pq3d_tpu_torch.data import sceneverse as tsv
from pq3d_tpu_torch.data import tokenizers as ttok
from pq3d_tpu_torch.data import unified_loader as tloader
from pq3d_tpu_torch.data import unified_pipeline as tup
from pq3d_tpu_torch.data.datasets import SceneVerseInstSeg as TInstSeg
from pq3d_tpu_torch.data.datasets import build_dataset
from pq3d_tpu_torch.data.replica import ReplicaSpec as TSpec
from pq3d_tpu_torch.data.replica import write_replica as twrite
from pq3d_tpu_torch.data.scannet200_constants import CLASS_LABELS_200
from pq3d_tpu_torch.eval.grounding_eval import Multi3DReferEval
from test_sceneverse_real import SCAN, _write_scene, _write_scanqa

torch.set_num_threads(1)
SPEC = dict(n_train=2, n_val=1, n_points=4000, n_objects=8,
            n_anno_per_scan=3, mv_dim=16, voxel_dim=8, seg_dim=16)
TASKS = ("ScanReferSceneVerse", "Sr3DSceneVerse", "Nr3DSceneVerse",
         "Multi3DReferSceneVerse", "ScanQASceneVerse", "SQA3DSceneVerse",
         "Scan2CapSceneVerse")


def _same(a, b, path="x"):
    """Exact equality of nested payloads: dicts (Counter too), lists,
    tuples, sets, numpy arrays and tensors (dtype, shape and values),
    scalars."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor), path
        a, b = a.numpy(), b.numpy()
    if isinstance(a, dict):
        assert type(a) is type(b) and set(a) == set(b), (
            path, sorted(map(str, set(a) ^ set(b))))
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype \
            and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape,
                                     b.shape)
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


@pytest.fixture(scope="module")
def replicas(tmp_path_factory):
    """The same small replica written by each package."""
    root = tmp_path_factory.mktemp("replicas")
    out = {}
    for pkg, write, spec in (("jax", jwrite, JSpec), ("torch", twrite,
                                                      TSpec)):
        base, pred, aux = (str(root / pkg / d) for d in ("base", "pred",
                                                          "aux"))
        ids = write(base, pred, aux, spec(**SPEC))
        out[pkg] = {"root": str(root / pkg), "base": base, "pred": pred,
                    "aux": aux, "ids": ids}
    return out


@pytest.fixture(autouse=True)
def fresh_scan_caches():
    jsv.SceneVerseScans._cache = {}
    tsv.SceneVerseScans._cache = {}
    yield
    jsv.SceneVerseScans._cache = {}
    tsv.SceneVerseScans._cache = {}


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_replica_writers_write_the_same_files(replicas):
    j, t = replicas["jax"], replicas["torch"]
    assert j["ids"] == t["ids"] and len(t["ids"]) == 3
    files = _files(j["root"])
    assert files == _files(t["root"])
    kinds = Counter(os.path.splitext(f)[1] for f in files)
    assert kinds[".pth"] == 3 * 3 + 3 * 4 + 3 * 2 and kinds[".npz"] == 3
    for rel in files:
        pj, pt = os.path.join(j["root"], rel), os.path.join(t["root"], rel)
        if rel.endswith(".pth"):
            _same(torch.load(pj, weights_only=False),
                  torch.load(pt, weights_only=False), rel)
        elif rel.endswith(".npz"):
            # the zip members carry write times; the arrays must be equal
            a, b = sp.load_npz(pj), sp.load_npz(pt)
            _same(a.toarray(), b.toarray(), rel)
        else:
            with open(pj, "rb") as fj, open(pt, "rb") as ft:
                assert fj.read() == ft.read(), rel


def test_replica_scan_statistics_as_jax():
    rng_j, rng_t = np.random.default_rng(5), np.random.default_rng(5)
    from pq3d_tpu.data.replica import make_room_scan as jscan
    from pq3d_tpu_torch.data.replica import make_room_scan as tscan
    spec = dict(n_points=20_000, n_objects=6)
    sj, st = jscan(rng_j, JSpec(**spec)), tscan(rng_t, TSpec(**spec))
    _same(sj, st)
    assert len(st["points"]) == 20_000
    assert sorted(set(st["inst_to_label"].values()) & {"wall", "floor",
                                                       "ceiling"}) == [
        "ceiling", "floor", "wall"]


def _instseg_cfg(rep, **opts):
    return {"data": {"scene_verse_base": rep["base"],
                     "scene_verse_aux": rep["aux"],
                     "instseg_options": {"filter_out_classes": [0, 2],
                                         "ignore_label": -100},
                     "load_scan_options": {"load_image_segment_feat": True,
                                           "load_point_segment_feat": True,
                                           **opts},
                     "train": ["ScanNetInstSegSceneVerse"],
                     "val": ["ScanNetInstSegSceneVerse"]},
            "debug": {"flag": False}}


@pytest.mark.parametrize("split", ["train", "val"])
def test_instseg_scenes_equal_jax(replicas, split):
    dj = JInstSeg(Config(_instseg_cfg(replicas["jax"])), split)
    dt = build_dataset(_instseg_cfg(replicas["torch"]), split)
    assert isinstance(dt, TInstSeg)
    assert len(dt) == len(dj) == (2 if split == "train" else 1)
    for i in range(len(dt)):
        sj, st = dj.get_scene(i), dt.get_scene(i)
        _same(sj, st)
        assert st["mv_seg_fts"].shape == (int(st["segment_id"].max()) + 1,
                                          16)
        assert st["inst_labels"].max() < 200
        assert (st["instance_labels"] < len(st["inst_labels"])).all()


def test_instseg_dataset_pickles_without_modules(replicas):
    """The spawn pools pickle the dataset: it holds no module object."""
    import pickle
    ds = TInstSeg(_instseg_cfg(replicas["torch"]), "train")
    assert not any(type(v).__name__ == "module" for v in vars(ds).values())
    _same(pickle.loads(pickle.dumps(ds)).get_scene(1), ds.get_scene(1))


def _task_cfg(rep, pc_type, **extra):
    data = {"scene_verse_base": rep["base"], "scene_verse_aux": rep["aux"],
            "scene_verse_pred": rep["pred"], "pc_type": pc_type,
            "load_scan_options": {"load_image_obj_feat": True,
                                  "load_voxel_obj_feat": True},
            "Nr3DSceneVerse": {"sr3d_plus_aug": True}}
    data.update(extra)
    return {"data": data, "debug": {"flag": False}}


@pytest.mark.parametrize("pc_type", ["gt", "pred"])
@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("name", TASKS)
def test_task_items_equal_jax(replicas, name, split, pc_type):
    cj = Config(_task_cfg(replicas["jax"], pc_type))
    ct = _task_cfg(replicas["torch"], pc_type)
    kw_j = dict(tokenizer=jtok.SyntheticTokenize(77),
                gen_tokenizer=jtok.SyntheticTokenize(64))
    kw_t = dict(tokenizer=ttok.SyntheticTokenize(77),
                gen_tokenizer=ttok.SyntheticTokenize(64))
    dj = getattr(jsv, name)(cj, split, **kw_j)
    dt = getattr(tsv, name)(ct, split, **kw_t)
    assert dt.evaluator == dj.evaluator and dt.task_id == dj.task_id
    assert dt.pc_type == dj.pc_type
    assert len(dt) == len(dj) > 0
    _same(dj.lang_data, dt.lang_data)
    for i in range(len(dt)):
        _same(dj.get_item(i), dt.get_item(i), f"{name}[{i}]")
    if split == "val" and pc_type == "pred" and name != "SQA3DSceneVerse":
        assert dt.get_item(0)[1]["use_pred"]


@pytest.mark.parametrize("name", TASKS)
def test_task_dataset_pickles(replicas, name):
    """Spawn pools pickle the task datasets with their tokenizers."""
    import pickle
    ds = getattr(tsv, name)(_task_cfg(replicas["torch"], "pred"), "val",
                            tokenizer=ttok.SyntheticTokenize(77),
                            gen_tokenizer=ttok.SyntheticTokenize(64))
    copy = pickle.loads(pickle.dumps(ds))
    tsv.SceneVerseScans._cache = {}
    _same(ds.get_item(0), copy.get_item(0))


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", TASKS)
def test_task_loader_batches_equal_jax(replicas, name, train):
    """The datasets through each package's loader (object crop, point
    sampling, offline features, prompts): every batch array equal."""
    split = "train" if train else "val"
    dj = getattr(jsv, name)(Config(_task_cfg(replicas["jax"], "pred")),
                            split)
    dt = getattr(tsv, name)(_task_cfg(replicas["torch"], "pred"), split)
    kw = dict(max_obj_len=12, num_points=64, prompt_len=24,
              response_len=12, dim_loc=6)
    dims = {"mv": 16, "voxel": 8}
    lj = jloader.UnifiedTaskLoader(dj, jup.UnifiedPipelineConfig(**kw), 4,
                                   train, seed=3, feature_dims=dims)
    lt = tloader.UnifiedTaskLoader(dt, tup.UnifiedPipelineConfig(**kw), 4,
                                   train, seed=3, feature_dims=dims)
    bj, bt = list(lj(0)), list(lt(0))
    assert len(bt) == len(bj) > 0
    for a, b in zip(bj, bt):
        _same(a, b)


def test_label_converter_equals_jax(replicas):
    tsv_path = os.path.join(replicas["torch"]["base"], "ScanNet",
                            "annotations", "meta_data",
                            "scannetv2-labels.combined.tsv")
    names = list(CLASS_LABELS_200) + ["ceiling", "exotic gadget", ""]
    for path in (tsv_path, None):
        cj, ct = jlabel.LabelConverter(path), tlabel.LabelConverter(path)
        for key in vars(ct):
            _same(getattr(cj, key), getattr(ct, key), key)
        for n in names:
            assert ct.name_to_scannet200(n) == cj.name_to_scannet200(n), n
            assert ct.name_to_scannet200(n, -1) == \
                cj.name_to_scannet200(n, -1), n
        for rid in range(0, 1300, 7):
            assert ct.raw_to_scannet200(rid) == cj.raw_to_scannet200(rid)
    ct = tlabel.LabelConverter(tsv_path)
    assert ct.has_tsv and len(ct.id_to_scannetid) == 201
    assert ct.name_to_scannet200("wall") == 0
    assert ct.name_to_scannet200("exotic gadget") == -100   # not in the tsv


def test_answer_vocabs_equal_jax(replicas, tmp_path):
    base = replicas["torch"]["base"]
    vj = jlabel.AnswerVocab.from_scanqa_train(base)
    vt = tlabel.AnswerVocab.from_scanqa_train(base)
    assert vt.vocab == vj.vocab and len(vt) > 0
    answers = vt.vocab[:3] + ["not an answer"]
    np.testing.assert_array_equal(vt.multihot(answers),
                                  vj.multihot(answers))
    assert [vt.stoi(a) for a in answers] == [vj.stoi(a) for a in answers]
    sqa = tmp_path / "ScanNet" / "annotations" / "sqa_task"
    sqa.mkdir(parents=True)
    for cls in (jlabel.AnswerVocab, tlabel.AnswerVocab):
        with pytest.raises(FileNotFoundError):
            cls.from_sqa3d_dict(str(tmp_path))
    with open(sqa / "answer_dict.json", "w") as f:
        json.dump([{"yes": 0, "no": 1, "two": 2, "white": 3}, {}], f)
    vj = jlabel.AnswerVocab.from_sqa3d_dict(str(tmp_path))
    vt = tlabel.AnswerVocab.from_sqa3d_dict(str(tmp_path))
    assert vt.vocab == vj.vocab == sorted(["yes", "no", "two", "white"])
    assert vt.itos(1) == vj.itos(1) and vt.itos(9) == vj.itos(9) == ""


# ---- the cases of tests/test_sceneverse_real.py, on the port ------------

@pytest.fixture()
def sv_dirs(tmp_path):
    base, pred, aux = (str(tmp_path / d) for d in ("sceneverse", "pred",
                                                    "aux"))
    _write_scene(base, pred=pred, aux=aux)
    return base, pred, aux


def _real_cfg(base, pred=None, aux=None, **data_extra):
    data = {"scene_verse_base": base, "scene_verse_aux": aux,
            "scene_verse_pred": pred,
            "instseg_options": {"filter_out_classes": [0, 2],
                                "ignore_label": -100},
            "load_scan_options": {"load_image_obj_feat": True,
                                  "load_voxel_obj_feat": True,
                                  "load_image_segment_feat": aux is not None,
                                  "load_point_segment_feat": aux is not None}}
    data.update(data_extra)
    return {"data": data, "debug": {"flag": False}}


def test_instseg_real_labels(sv_dirs):
    base, _, aux = sv_dirs
    cfg = _real_cfg(base, aux=aux)
    scene = TInstSeg(cfg, "train").get_scene(0)
    _same(JInstSeg(Config(cfg), "train").get_scene(0), scene)
    # wall (200-id 0) filtered; chair (1), table (3), gadget (-100) stay
    assert sorted(scene["inst_labels"].tolist()) == [-100, 1, 3]
    assert set(np.unique(scene["instance_labels"])) == {-1, 0, 1, 2}
    assert scene["colors"].min() >= -1.001 and scene["colors"].max() <= 1.001
    assert scene["mv_seg_fts"].shape[1] == 4
    assert np.allclose(scene["pc_seg_fts"], 1.0)


def test_scanrefer_gt_mode(sv_dirs):
    base, pred, aux = sv_dirs
    cfg = _real_cfg(base, pred=pred, aux=aux)
    scene, lang = tsv.ScanReferSceneVerse(cfg, "val").get_item(0)
    _same(jsv.ScanReferSceneVerse(Config(cfg), "val").get_item(0),
          (scene, lang))
    tgt = lang["tgt_object_ids"][0]
    assert scene["inst_labels"][tgt] == 1
    assert lang["iou25_ids"] == lang["tgt_object_ids"]
    assert not lang["use_pred"]
    assert scene["gt_center"].shape == (4, 3)


def test_scanrefer_pred_mode_and_pipeline(sv_dirs):
    base, pred, aux = sv_dirs
    cfg = _real_cfg(base, pred=pred, aux=aux,
                    ScanReferSceneVerse={"pc_type": "pred"})
    scene, lang = tsv.ScanReferSceneVerse(cfg, "val").get_item(0)
    _same(jsv.ScanReferSceneVerse(Config(cfg), "val").get_item(0),
          (scene, lang))
    assert lang["use_pred"]
    assert lang["tgt_object_ids"] == [0]
    assert lang["iou25_ids"] == [0] and lang["iou50_ids"] == [0]
    assert lang["meta_iou"] > 0.99
    pcfg = tup.UnifiedPipelineConfig(max_obj_len=8, num_points=64,
                                     prompt_len=16, response_len=8,
                                     dim_loc=6)
    item = tup.process_item(scene, lang, pcfg, np.random.default_rng(0),
                            False, {"mv": 8, "voxel": 8})
    assert item["n_obj"] == 3
    assert item["obj_labels"].tolist() == [1, 3, 0]
    assert np.allclose(item["mv_fts"][:, 0], [0.5, 1.5, 2.5])
    batch = tup.collate_unified([item], pcfg, {"mv": 8, "voxel": 8},
                                train=False)
    assert batch["tgt_object_id_iou25"][0, 0] == 1.0
    assert batch["tgt_object_id_iou25"][0, 1:].sum() == 0
    assert np.allclose(batch["mv_seg_fts"][0, :3, 0], [0.5, 1.5, 2.5])


def test_gt_mode_offline_feats_and_crop_priority(sv_dirs):
    base, pred, aux = sv_dirs
    scene, lang = tsv.ScanReferSceneVerse(
        _real_cfg(base, pred=pred, aux=aux), "val").get_item(0)
    pcfg = tup.UnifiedPipelineConfig(max_obj_len=2, num_points=32,
                                     prompt_len=16, response_len=8,
                                     dim_loc=6)
    item = tup.process_item(scene, lang, pcfg, np.random.default_rng(0),
                            False, {"mv": 8})
    assert item["tgt_object_ids"] == [0]
    assert item["obj_labels"][0] == 1
    tgt_gt_idx = lang["tgt_object_ids"][0]
    assert item["mv_fts"][0, 0] == float(scene["inst_raw_ids"][tgt_gt_idx])


def test_background_objects_filtered_in_gt_mode(sv_dirs):
    base, pred, aux = sv_dirs
    scene, lang = tsv.ScanReferSceneVerse(
        _real_cfg(base, pred=pred, aux=aux), "val").get_item(0)
    assert scene["bg_label_ids"] == {0, 2}
    pcfg = tup.UnifiedPipelineConfig(max_obj_len=8, num_points=32,
                                     prompt_len=16, response_len=8,
                                     dim_loc=6)
    item = tup.process_item(scene, lang, pcfg, np.random.default_rng(0),
                            False, {"mv": 8})
    assert item["n_obj"] == 3
    assert 0 not in item["obj_labels"].tolist()
    tgt = item["tgt_object_ids"][0]
    assert item["obj_labels"][tgt] == 1
    assert item["mv_fts"][tgt, 0] == 1.0


def test_scanqa_use_val_for_train(sv_dirs):
    base, _, _ = sv_dirs
    _write_scanqa(base, "train", [
        {"scene_id": SCAN, "question": "what color is the chair?",
         "answers": ["red"], "object_ids": [1]}])
    _write_scanqa(base, "val", [
        {"scene_id": SCAN, "question": "how many tables?",
         "answers": ["one"], "object_ids": [2]}])
    assert len(tsv.ScanQASceneVerse(_real_cfg(base), "train")) == 1
    cfg = _real_cfg(base, ScanQASceneVerse={"use_val_for_train": True})
    ds = tsv.ScanQASceneVerse(cfg, "train")
    assert len(ds) == 2
    _same(jsv.ScanQASceneVerse(Config(cfg), "train").lang_data,
          ds.lang_data)


def test_scan2cap_txt_max_len(sv_dirs):
    base, _, _ = sv_dirs
    ds = tsv.Scan2CapSceneVerse(
        _real_cfg(base, Scan2CapSceneVerse={"txt_max_len": 3}), "val")
    assert ds.lang_data[0]["utterance"] == "the chair next"
    tsv.SceneVerseScans._cache = {}
    ds = tsv.Scan2CapSceneVerse(_real_cfg(base), "val")
    assert ds.lang_data[0]["utterance"] == "the chair next to the wall"


def test_missing_base_raises(tmp_path):
    cfg = _real_cfg(str(tmp_path / "absent"))
    with pytest.raises(FileNotFoundError):
        TInstSeg(cfg, "train")
    with pytest.raises(FileNotFoundError):
        tsv.ScanReferSceneVerse(cfg, "train")


# ---- the cases of tests/test_replica.py, on the port ---------------------

def test_instseg_dataset_full_label_space(replicas):
    rep = replicas["torch"]
    cfg = {"data": {"scene_verse_base": rep["base"],
                    "instseg_options": {"filter_out_classes": [0, 2],
                                        "ignore_label": -100},
                    "load_scan_options": {}}, "debug": {"flag": False}}
    labels = np.unique(TInstSeg(cfg, "val").get_scene(0)["inst_labels"])
    labels = labels[labels >= 0]
    assert len(labels) >= 2 and labels.max() < 200


def test_multi3drefer_eval_batch_keys(replicas):
    rep = replicas["torch"]
    ds = tsv.Multi3DReferSceneVerse(_task_cfg(rep, "gt"), "val")
    pipe = tup.UnifiedPipelineConfig(max_obj_len=8, num_points=32,
                                     prompt_len=12, response_len=4,
                                     dim_loc=6)
    loader = tloader.UnifiedTaskLoader(ds, pipe, batch_size=2, train=False,
                                       feature_dims={"mv": 16, "voxel": 8})
    batch = next(iter(loader(0)))
    meta = batch["_meta"]
    assert "tgt_obj_boxes" in meta and "eval_type" in meta
    assert all(b.ndim == 2 and b.shape[1] == 6
               for b in meta["tgt_obj_boxes"])
    ev = Multi3DReferEval()
    out = {"og3d_logits": np.random.default_rng(0).standard_normal(
        (2, pipe.max_obj_len)).astype(np.float32)}
    eval_batch = {k: v for k, v in batch.items() if not k.startswith("_")}
    eval_batch.update(meta)
    ev.update(out, eval_batch)
    assert "iou50_overall" in ev.record()
