"""The port's stage-2 unified path against the JAX package on the CPU:

- the host pipeline (data/unified_pipeline.py, data/unified_datasets.py):
  ``process_item`` / ``collate_unified`` batches bit-identical for the
  three synthetic datasets, in eval and train mode (crop, rotation);
- the whole ``Query3DUnified`` (mv, pc through PointNet++, offline voxel,
  prompt memories; ground and generation heads; dim_loc 6; the mixed
  decoder) at small widths with the same weights, moved one-to-one by
  utils/weights.load_flax_variables: ``ground_logits`` and teacher-forced
  ``generation_logits`` within max|diff| / max|ref| <= 1e-4, greedy tokens
  equal;
- ``UnifiedServer`` on 5 requests against the JAX ``UnifiedServer``: the
  same ``ground_obj`` and the same tokens;
- the two unified configs equal to their YAML files, and ``build_model``
  building the text and generation options of the YAML schema as JAX's
  ``build_model`` does (each held against it)."""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pq3d_tpu.config import Config
from pq3d_tpu.data import unified_datasets as jds
from pq3d_tpu.data import unified_pipeline as jup
from pq3d_tpu.models import query3d as jq3d
from pq3d_tpu.serve import UnifiedServer as JUnifiedServer
from pq3d_tpu_torch import config as tconfig
from pq3d_tpu_torch.data import tokenizers as ttok
from pq3d_tpu_torch.data import unified_datasets as tds
from pq3d_tpu_torch.data import unified_pipeline as tup
from pq3d_tpu_torch.models import query3d as tq3d
from pq3d_tpu_torch.serve import UnifiedServer as TUnifiedServer
from pq3d_tpu_torch.serve import to_device
from pq3d_tpu_torch.utils.weights import load_flax_variables
from test_torch_pointnet import random_variables

torch.set_num_threads(1)
TOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = {"data": {"synthetic": {"num_train": 6, "n_points": 600,
                              "n_instances": 10}},
       "debug": {"flag": False}, "model": {"heads": ["ground", "qa"]}}
PIPE = dict(max_obj_len=8, num_points=64, prompt_len=12, response_len=8)
FEATURE_DIMS = {"mv": 32, "voxel": 16}
DATASETS = ("SyntheticRefer", "SyntheticQA", "SyntheticCaption")


def _rel(ref, got):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert ref.shape == got.shape
    return float(np.abs(ref - got).max() / np.abs(ref).max())


def _requests(n, seed=0):
    """``n`` (scene, lang) pairs cycling through the three datasets, each
    scene with its own offline mv / voxel object features."""
    rng = np.random.default_rng(seed)
    sets = [getattr(tds, name)(CFG, "train") for name in DATASETS]
    out = []
    for i in range(n):
        scene, lang = sets[i % 3].get_item(i // 3)
        for mem, dim in FEATURE_DIMS.items():
            scene[f"{mem}_obj_feat_gt"] = rng.standard_normal(
                (len(scene["inst_labels"]), dim)).astype(np.float32)
        out.append((scene, lang))
    return out


@pytest.mark.parametrize("name", DATASETS)
@pytest.mark.parametrize("train", [False, True])
def test_pipeline_bit_identical(name, train):
    jcfg = Config(CFG)
    tset = getattr(tds, name)(CFG, "train")
    jset = getattr(jds, name)(jcfg, "train")
    tpipe = tup.UnifiedPipelineConfig(**PIPE)
    jpipe = jup.UnifiedPipelineConfig(**PIPE)
    trng, jrng = np.random.default_rng(7), np.random.default_rng(7)
    titems, jitems = [], []
    for i in range(3):
        (ts, tl), (js, jl) = tset.get_item(i), jset.get_item(i)
        for k in js:
            np.testing.assert_array_equal(ts[k], js[k])
        assert set(tl) == set(jl)
        for k in jl:
            np.testing.assert_array_equal(tl[k], jl[k])
        if i == 1:   # the legacy box-matched labels
            tl = dict(tl, gt_target_boxes=[[1.0, 1.0, 0.5, 0.6, 0.6, 0.6]])
            jl = dict(jl, gt_target_boxes=tl["gt_target_boxes"])
        titems.append(tup.process_item(ts, tl, tpipe, trng, train,
                                       FEATURE_DIMS))
        jitems.append(jup.process_item(js, jl, jpipe, jrng, train,
                                       FEATURE_DIMS))
    for ti, ji in zip(titems, jitems):
        assert set(ti) == set(ji)
        for k in ji:
            np.testing.assert_array_equal(np.asarray(ti[k]),
                                          np.asarray(ji[k]), err_msg=k)
    tb = tup.collate_unified(titems, tpipe, FEATURE_DIMS, train=train)
    jb = jup.collate_unified(jitems, jpipe, FEATURE_DIMS, train=train)
    assert set(tb) == set(jb)
    for k in jb:
        assert tb[k].dtype == jb[k].dtype, k
        np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    if name == "SyntheticQA":
        assert "answer_label" in tb
    assert tds.detokenize(tb["response"][0]) == \
        jds.detokenize(jb["response"][0])


def test_unified_configs_equal_yaml_and_tokenizer():
    for name in ("unified_tasks_sceneverse", "unified_tasks_synthetic"):
        with open(os.path.join(REPO, "pq3d_tpu", "config", "configs",
                               f"{name}.yaml")) as f:
            assert tconfig.CONFIGS[name] == yaml.safe_load(f)
        cfg = tconfig.load_config(name)
        assert cfg["model"]["unified_encoder"]["args"]["memories"] == \
            ["mv", "pc", "voxel", "prompt"]
    bundle = ttok.build_tokenizers(tconfig.load_config(
        "unified_tasks_sceneverse"))
    assert bundle.tokenize("find the chair") == \
        [ord(c) % 1000 for c in "find the chair"]
    assert bundle.detokenize(np.array([4, 2, 9, 1, 0])) == "find the chair"


def _models():
    kw = dict(memories=("mv", "pc", "voxel", "prompt"),
              heads=("ground", "generation"), hidden_size=64, dim_loc=6,
              use_offline_voxel_fts=True)
    gen = dict(vocab_size=100, d_model=32, d_kv=8, d_ff=64, num_layers=1,
               num_heads=4, max_new_tokens=4)
    txt = dict(vocab_size=200, width=32, layers=1, heads=4)
    jm = jq3d.Query3DUnified(
        skip_query_encoder_mask_pred=True, mask_head_cfg=None,
        unified=jq3d.UnifiedEncoderCfg(num_layers=1, num_blocks=1,
                                       num_attention_heads=4,
                                       structure="mixed"),
        mv_enc=jq3d.EncoderCfg(input_feat_size=32),
        pc_enc=jq3d.EncoderCfg(backbone="pointnet++", freeze_backbone=True),
        voxel_obj_enc=jq3d.EncoderCfg(input_feat_size=16),
        ground_head_cfg=jq3d.GroundHeadCfg(hidden_size=32),
        generation_head_cfg=jq3d.GenerationHeadCfg(**gen),
        txt_cfg=jq3d.TxtEncoderCfg(**txt), **kw)
    tm = tq3d.Query3DUnified(
        mask_head_cfg=None,
        unified=tq3d.UnifiedEncoderCfg(num_layers=1, num_blocks=1,
                                       num_attention_heads=4,
                                       structure="mixed"),
        mv_enc=tq3d.EncoderCfg(32),
        pc_enc=tq3d.EncoderCfg(backbone="pointnet++", freeze_backbone=True),
        voxel_obj_enc=tq3d.EncoderCfg(16),
        ground_head_cfg=tq3d.GroundHeadCfg(hidden_size=32),
        generation_head_cfg=tq3d.GenerationHeadCfg(**gen),
        txt_cfg=tq3d.TxtEncoderCfg(**txt), **kw)
    return jm, tm


@pytest.fixture(scope="module")
def pair():
    """The JAX model and the port's, with the same random weights, and a
    batch of 6 requests (every dataset twice: TXT and LOC prompts)."""
    jm, tm = _models()
    pipe = tup.UnifiedPipelineConfig(**PIPE)
    rng = np.random.default_rng(0)
    items = [tup.process_item(s, l, pipe, rng, False, FEATURE_DIMS)
             for s, l in _requests(6)]
    batch = tup.collate_unified(items, pipe, FEATURE_DIMS, train=False)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        jax.tree.map(jnp.asarray, batch), train=False))
    variables = random_variables(shapes, 3)
    load_flax_variables(tm, variables)
    n_leaves = len(jax.tree_util.tree_leaves(variables))
    assert n_leaves == len(tm.state_dict())
    return jm, tm.eval(), variables, batch


def test_unified_model_matches_jax(pair):
    jm, tm, variables, batch = pair
    assert set(batch["prompt_type"]) == {tup.PROMPT_TXT, tup.PROMPT_LOC}
    ref = jax.jit(lambda v, b: jm.apply(v, b, train=False))(
        variables, jax.tree.map(jnp.asarray, batch))
    with torch.no_grad():
        got = tm(to_device(batch, torch.device("cpu")))
    valid = batch["query_pad_masks"]
    assert _rel(np.asarray(ref["ground_logits"])[valid],
                got["ground_logits"].numpy()[valid]) <= TOL
    assert _rel(ref["generation_logits"],
                got["generation_logits"].numpy()) <= TOL
    np.testing.assert_array_equal(got["generation_tokens"].numpy(),
                                  np.asarray(ref["generation_tokens"]))
    # IMAGE prompts on two rows: the lazily built img_encoder, moved from
    # a JAX tree that holds it (tests/test_torch_unified_variants.py
    # holds the rest of the image path)
    img = dict(batch, prompt_img_fts=np.random.default_rng(4)
               .standard_normal((6, 12, 8)).astype(np.float32),
               prompt_type=np.where(np.arange(6) % 3 == 1, tup.PROMPT_IMAGE,
                                    batch["prompt_type"]))
    jimg = jax.tree.map(jnp.asarray, img)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, jimg,
        train=False))
    vimg = random_variables(shapes, 3)
    timg = copy.deepcopy(tm)     # the fixture's model keeps its weights
    load_flax_variables(timg, vimg)
    ref = jax.jit(lambda v, b: jm.apply(v, b, train=False))(vimg, jimg)
    with torch.no_grad():
        got = timg(to_device(img, torch.device("cpu")))
    assert _rel(np.asarray(ref["ground_logits"])[valid],
                got["ground_logits"].numpy()[valid]) <= TOL
    np.testing.assert_array_equal(got["generation_tokens"].numpy(),
                                  np.asarray(ref["generation_tokens"]))


def test_unified_server_matches_jax(pair):
    jm, tm, variables, _ = pair
    reqs = _requests(5, seed=1)
    jpipe = jup.UnifiedPipelineConfig(**PIPE)
    tpipe = tup.UnifiedPipelineConfig(**PIPE)
    jsrv = JUnifiedServer(jm, variables, jpipe, batch_size=2,
                          feature_dims=FEATURE_DIMS, max_delay_s=0.2,
                          detokenize=jds.detokenize)
    tsrv = TUnifiedServer(tm, tpipe, batch_size=2,
                          feature_dims=FEATURE_DIMS, max_delay_s=0.2,
                          detokenize=tds.detokenize, device="cpu")
    try:
        want = [f.result(timeout=300) for f in
                [jsrv.submit(r) for r in reqs]]
        got = [f.result(timeout=300) for f in
               [tsrv.submit(r) for r in reqs]]
    finally:
        jsrv.close()
        tsrv.close()
    for w, g in zip(want, got):
        assert g["ground_obj"] == w["ground_obj"]
        assert 0 <= g["ground_obj"] < PIPE["max_obj_len"]
        assert np.isfinite(g["ground_scores"][g["ground_obj"]])
        np.testing.assert_array_equal(g["generation_tokens"],
                                      w["generation_tokens"])
        assert g["generation"] == w["generation"]
    st = tsrv.stats.summary()
    assert st["scenes"] == 5
    assert set(st["stage_s"]) == {"preprocess", "collate",
                                  "forward_decode", "finish"}


def test_unified_entry_points_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal path is moot")
    cfg = tconfig.load_config("unified_tasks_synthetic")
    with pytest.raises(RuntimeError, match="CUDA"):
        tq3d.build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        TUnifiedServer(None, tup.UnifiedPipelineConfig(**PIPE),
                       batch_size=2, feature_dims=FEATURE_DIMS)
    # the CPU build of the same config: its widths, one-to-one buildable
    m = tq3d.build_model(cfg, device="cpu")
    assert m.txt_encoder.tower.token_embedding.num_embeddings == 64
    assert m.generation_head.cfg.max_new_tokens == 8
    assert m.pc_encoder.backbone is not None
    assert not m.pc_encoder.freeze_backbone


@pytest.mark.parametrize("head,key,value", [
    ("txt_encoder", "use_projection", False),
    ("txt_encoder", "projection_type", "attention"),
    ("txt_encoder", "freeze_backbone", False),
    ("generation_head", "use_projection", False)])
def test_build_model_refuses_unported_heads(head, key, value):
    """Each text and generation option that ``build_model`` once refused
    now builds, from the same config, the model JAX's ``build_model``
    builds: the same parameter tree, one-to-one, and the same ground
    logits, teacher-forced logits and tokens (rel 1e-4) on one batch.  The
    widths that the option needs equal: the tower's and the decoder's at
    the model's 48 (the attention projection has 12 heads)."""
    from pq3d_tpu.config import Config
    from pq3d_tpu.config import default_config_dir
    from pq3d_tpu.config import load_config as jload
    overrides = ["model.hidden_size=48", "model.txt_tower.width=48",
                 "model.txt_tower.layers=1",
                 "model.unified_encoder.args.num_layers=1",
                 "model.unified_encoder.args.num_attention_heads=4",
                 "model.generation_head.args.d_model=48",
                 "model.generation_head.args.d_kv=12",
                 "model.generation_head.args.d_ff=64",
                 "model.generation_head.args.num_heads=4",
                 "model.generation_head.args.num_layers=1",
                 "model.generation_head.args.max_new_tokens=4",
                 f"model.{head}.args.{key}={value}"]
    cfg = tconfig.load_config("unified_tasks_synthetic", overrides)
    jcfg = jload(os.path.join(default_config_dir(),
                              "unified_tasks_synthetic.yaml"),
                 overrides=overrides)
    assert isinstance(jcfg, Config)
    tm = tq3d.build_model(cfg, device="cpu")
    jm = jq3d.build_model(jcfg)
    pipe = tup.UnifiedPipelineConfig(**PIPE)
    dims = {"mv": 768, "voxel": 128}          # the config's feature widths
    rng = np.random.default_rng(0)
    sets = [getattr(tds, name)(CFG, "train") for name in DATASETS]
    items = [tup.process_item(*sets[i].get_item(0), pipe, rng, False, dims)
             for i in range(3)]
    batch = tup.collate_unified(items, pipe, dims, train=False)
    batch.pop("obj_fts")
    jb = jax.tree.map(jnp.asarray, batch)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, jb,
        train=False))
    variables = random_variables(shapes, 5)
    load_flax_variables(tm, variables)
    ref = jax.jit(lambda v, b: jm.apply(v, b, train=False))(variables, jb)
    with torch.no_grad():
        got = tm.eval()(to_device(batch, torch.device("cpu")))
    valid = batch["query_pad_masks"]
    assert _rel(np.asarray(ref["ground_logits"])[valid],
                got["ground_logits"].numpy()[valid]) <= TOL
    assert _rel(ref["generation_logits"],
                got["generation_logits"].numpy()) <= TOL
    np.testing.assert_array_equal(got["generation_tokens"].numpy(),
                                  np.asarray(ref["generation_tokens"]))


def test_vertical_bottom_model_matches_jax_and_center(pair):
    """``pairwise_rel_type: vertical_bottom`` through the model: JAX's
    model passes ``whls=None``, so both packages' spatial features equal
    ``center``'s.  The port's logits and tokens with it are bit-equal to
    its own with ``center`` at the same weights and within 1e-4 of JAX's
    model with ``vertical_bottom``.  ``build_model`` reads
    ``model.obj_loc.pairwise_rel_type``; ``mlp`` is refused with JAX's
    reason."""
    jm, tm, variables, batch = pair
    jvb = jm.clone(pairwise_rel_type="vertical_bottom")
    ref = jax.jit(lambda v, b: jvb.apply(v, b, train=False))(
        variables, jax.tree.map(jnp.asarray, batch))
    tvb = copy.deepcopy(tm)
    tvb.pairwise_rel_type = "vertical_bottom"
    with torch.no_grad():
        tb = to_device(batch, torch.device("cpu"))
        got, center = tvb(tb), tm(tb)
    for k in ("ground_logits", "generation_logits", "generation_tokens"):
        assert torch.equal(got[k], center[k]), k
    valid = batch["query_pad_masks"]
    assert _rel(np.asarray(ref["ground_logits"])[valid],
                got["ground_logits"].numpy()[valid]) <= TOL
    assert _rel(ref["generation_logits"],
                got["generation_logits"].numpy()) <= TOL
    np.testing.assert_array_equal(got["generation_tokens"].numpy(),
                                  np.asarray(ref["generation_tokens"]))
    small = ["model.hidden_size=48", "model.txt_tower.width=48",
             "model.txt_tower.layers=1",
             "model.unified_encoder.args.num_layers=1",
             "model.unified_encoder.args.num_attention_heads=4"]
    cfg = tconfig.load_config(
        "unified_tasks_synthetic",
        small + ["model.obj_loc.pairwise_rel_type=vertical_bottom"])
    assert tq3d.build_model(cfg, device="cpu").pairwise_rel_type == \
        "vertical_bottom"
    cfg = tconfig.load_config(
        "unified_tasks_synthetic",
        small + ["model.obj_loc.pairwise_rel_type=mlp"])
    with pytest.raises(NotImplementedError, match="whls=None"):
        tq3d.build_model(cfg, device="cpu")
