"""The GT-query stage-1 variant (instseg_sceneverse_gt.yaml) in the port
against the JAX package: queries at the GT object centres with the GT
segment masks as the decoder's offline attention masks, the mask head and
the whole small model with ``use_offline_attn_mask``, the direct criterion
and one train step.

The batch is exact.  The model comparisons run every sparse conv in f32 on
both sides (flax's Dropout the identity in the train step), since the
offline masks fix every attend bit; tolerances: forward logits rel 1e-5
(max|diff| / max|ref|), loss parts 1e-5, the train step's loss 1e-5 and
all gradients together 1e-4 in L2, BatchNorm statistics 1e-5.
"""
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pq3d_tpu.data import instseg_pipeline as jpipe
from pq3d_tpu.data import synthetic as jsyn
from pq3d_tpu.models import heads as jheads
from pq3d_tpu.models import query3d as jq3d
from pq3d_tpu.ops import sparse as jsparse
from pq3d_tpu.optim import losses as jlosses
from pq3d_tpu_torch.config import load_config
from pq3d_tpu_torch.data import instseg_pipeline as tpipe
from pq3d_tpu_torch.data import synthetic as tsyn
from pq3d_tpu_torch.models import heads as theads
from pq3d_tpu_torch.models import query3d as tq3d
from pq3d_tpu_torch.ops import sparse as tsparse
from pq3d_tpu_torch.optim import losses as tlosses
from pq3d_tpu_torch.serve import to_device
from pq3d_tpu_torch.utils.weights import load_flax_variables, torch_name
from test_torch_model import _random_variables, _route_small
from test_torch_pipeline import _assert_same

torch.set_num_threads(1)
TOL = 1e-5
GT = dict(query_sample_strategy="gt", offline_mask_source="gt")
KW = dict(voxel_size=0.1, num_queries=8, max_segments=48, max_instances=8,
          voxel_bucket=256, stem_mode="dense_block", fps_subsample=200)


def _rel(ref, got):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.abs(ref - got).max() / (np.abs(ref).max() + 1e-30))


def _scenes(mod, sizes=(1500, 2600, 2000), n_instances=4):
    return [mod.make_scene(np.random.default_rng(i), n_points=n,
                           n_instances=n_instances, n_segments=20)
            for i, n in enumerate(sizes)]


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("caps", [None, (2048, 1024, 512, 256, 256)])
def test_gt_batch_bit_identical(train, caps):
    """make_batch with GT queries and the offline mask: every array equal
    to JAX's, with and without augmentation."""
    cfg_j = jpipe.InstSegPipelineConfig(level_caps=caps, **KW, **GT)
    cfg_t = tpipe.InstSegPipelineConfig(level_caps=caps, **KW, **GT)
    bj = jpipe.make_batch(_scenes(jsyn), cfg_j, np.random.default_rng(3),
                          train=train)
    bt = tpipe.make_batch(_scenes(tsyn), cfg_t, np.random.default_rng(3),
                          train=train)
    _assert_same(bj, bt)
    oam = bt["offline_attn_mask"]
    assert oam.shape == (3, 8, 48) and oam.dtype == bool
    # query i attends exactly instance i's segments
    assert (oam == bt["segment_masks"][:, :8, :48]).all()
    # queries sit at the GT object centres, valid only for real instances
    np.testing.assert_array_equal(bt["query_pad_masks"],
                                  bt["instance_valid"])
    for i in range(3):
        n = int(bt["instance_valid"][i].sum())
        np.testing.assert_array_equal(bt["query_locs"][i, :n],
                                      bt["obj_center"][i, :n])
        assert not bt["query_locs"][i, n:].any()


def test_gt_queries_pad_past_the_instances():
    """More queries (120) than instances: query_locs and the offline mask
    are padded with zeros / False, as JAX's collate pads them."""
    kw = dict(KW, num_queries=12, max_instances=12)
    cfg_j = jpipe.InstSegPipelineConfig(**kw, **GT)
    cfg_t = tpipe.InstSegPipelineConfig(**kw, **GT)
    sj, st = _scenes(jsyn, n_instances=5), _scenes(tsyn, n_instances=5)
    bj = jpipe.make_batch(sj, cfg_j, np.random.default_rng(0), train=False)
    bt = tpipe.make_batch(st, cfg_t, np.random.default_rng(0), train=False)
    _assert_same(bj, bt)
    assert bt["query_pad_masks"].sum(1).tolist() == [5, 5, 5]
    assert not bt["offline_attn_mask"][:, 5:].any()


def test_pipeline_config_reads_the_gt_keys():
    cfg = load_config("instseg_sceneverse_gt")
    pipe = tpipe.pipeline_config(cfg["data"]["instseg_options"])
    assert pipe.query_sample_strategy == "gt"
    assert pipe.offline_mask_source == "gt"
    assert tpipe.pipeline_config(load_config("instseg_sceneverse")["data"][
        "instseg_options"]).offline_mask_source is None
    with pytest.raises(ValueError, match="query_sample_strategy"):
        tpipe.InstSegPipelineConfig(query_sample_strategy="random")
    with pytest.raises(ValueError, match="offline_mask_source"):
        tpipe.InstSegPipelineConfig(offline_mask_source="pred")


@pytest.mark.parametrize("skip", [False, True])
def test_mask_head_offline_mask_matches_jax(skip):
    rng = np.random.default_rng(0)
    b, q, s, d = 2, 6, 20, 32
    query = rng.standard_normal((b, q, d)).astype(np.float32)
    feats = [rng.standard_normal((b, s, d)).astype(np.float32)
             for _ in range(2)]
    valid = np.arange(s)[None] < np.array([[20], [14]])
    oam = rng.random((b, q, s)) < 0.4
    jh = jheads.MaskHeadSegLevel(hidden_size=d, num_targets=11,
                                 num_memories=2, filter_out_classes=(0, 2))
    mems = [(jnp.asarray(f), jnp.asarray(valid)) for f in feats]
    variables = jh.init(jax.random.key(0), jnp.asarray(query), mems,
                        jnp.asarray(valid))
    out_j = jh.apply(variables, jnp.asarray(query), mems, jnp.asarray(valid),
                     offline_attn_masks=jnp.asarray(oam),
                     skip_prediction=skip)
    th = theads.MaskHeadSegLevel(d, 11, num_memories=2,
                                 filter_out_classes=(0, 2))
    load_flax_variables(th, dict(variables))
    th.eval()
    with torch.no_grad():
        out_t = th(torch.from_numpy(query),
                   [(torch.from_numpy(f), torch.from_numpy(valid))
                    for f in feats], torch.from_numpy(valid),
                   offline_attn_masks=torch.from_numpy(oam),
                   skip_prediction=skip)
    if skip:
        assert out_j[0] is None and out_j[1] is None
        assert out_t[0] is None and out_t[1] is None
    else:
        keep = np.ones(11, bool)
        keep[[0, 2]] = False
        assert _rel(np.asarray(out_j[0])[..., keep],
                    out_t[0].numpy()[..., keep]) <= TOL
        m = np.broadcast_to(valid[:, :, None], out_t[1].shape)
        assert _rel(np.asarray(out_j[1])[m], out_t[1].numpy()[m]) <= TOL
    # the attend mask is the offline one, not sigmoid >= 0.5
    np.testing.assert_array_equal(np.asarray(out_j[2]), oam)
    np.testing.assert_array_equal(out_t[2].numpy(), oam)


def _gt_batch(n_scenes=2, seed=0):
    rng = np.random.default_rng(seed)
    pipe = jpipe.InstSegPipelineConfig(
        voxel_size=0.15, num_queries=8, max_segments=32, max_instances=8,
        voxel_bucket=128, use_aug=False, stem_mode="dense_block",
        level_caps=[512, 256, 128, 128, 128], **GT)
    scenes = [jsyn.make_scene(rng, n_points=n, n_instances=3,
                              n_segments=16)
              for n in (600, 900, 750)[:n_scenes]]
    b = jpipe.make_batch(scenes, pipe, rng, train=False)
    b.pop("_meta")
    for name in ("mv", "pc"):
        b[f"{name}_seg_fts"] = rng.standard_normal(
            (n_scenes, 32, 16)).astype(np.float32)
        b[f"{name}_seg_pad_masks"] = b["seg_pad_masks"]
    b["instance_labels"] = (b["instance_labels"] % 17 + 3).astype(np.int32)
    return b


def _gt_models(dropout=0.1, skip=False):
    kw = dict(memories=("voxel", "mv", "pc"), heads=("mask",),
              hidden_size=32, dim_loc=3, use_offline_attn_mask=True,
              skip_query_encoder_mask_pred=skip)
    jm = jq3d.Query3DUnified(
        unified=jq3d.UnifiedEncoderCfg(
            num_layers=2, num_blocks=2, num_attention_heads=4,
            structure="parallel", spatial_selfattn=True, use_self_mask=True),
        mv_enc=jq3d.EncoderCfg(input_feat_size=16, dropout=dropout),
        pc_enc=jq3d.EncoderCfg(input_feat_size=16, dropout=dropout),
        voxel_enc=jq3d.VoxelEncoderCfg(hlevels=(0, 1), out_channels=20,
                                       dropout=dropout, remat_policy="none",
                                       grad_mode="scatter_free"),
        mask_head_cfg=jq3d.MaskHeadCfg(num_targets=21,
                                       filter_out_classes=(0, 2)), **kw)
    tm = tq3d.Query3DUnified(
        unified=tq3d.UnifiedEncoderCfg(
            num_layers=2, num_blocks=2, num_attention_heads=4,
            structure="parallel", spatial_selfattn=True, use_self_mask=True),
        mv_enc=tq3d.EncoderCfg(16, dropout=dropout),
        pc_enc=tq3d.EncoderCfg(16, dropout=dropout),
        voxel_enc=tq3d.VoxelEncoderCfg(hlevels=(0, 1), out_channels=20,
                                       dropout=dropout, pallas_conv=True),
        mask_head_cfg=tq3d.MaskHeadCfg(21, (0, 2)), **kw)
    return jm, tm


def _f32_convs(monkeypatch):
    for fn in ("sparse_conv_sym", "sparse_conv_down",
               "sparse_conv_transpose_gf", "conv0_dense_block"):
        monkeypatch.setattr(jsparse, fn, functools.partial(
            getattr(jsparse, fn), compute_dtype=jnp.float32))
    monkeypatch.setattr(tsparse, "_round", lambda t, dtype: t.float())


def _init(jm, bj):
    return _random_variables(lambda: jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, bj,
        train=False))


@pytest.mark.parametrize("skip", [False, True])
def test_gt_model_forward_matches_jax(monkeypatch, skip):
    """Every decoder round's logits; with skip_query_encoder_mask_pred the
    rounds inside the decoder predict nothing (the offline masks still
    steer them) and only the final prediction is returned."""
    b = _gt_batch()
    jm, tm = _gt_models(skip=skip)
    bj = jax.tree_util.tree_map(jnp.asarray, b)
    variables = _init(jm, bj)
    _f32_convs(monkeypatch)
    out_j = jax.jit(lambda v: jm.apply(v, bj, train=False))(variables)
    _route_small(monkeypatch, 128)
    load_flax_variables(tm, variables)
    tm.eval()
    bt = to_device(b, torch.device("cpu"))
    with torch.no_grad():
        out_t = tm(bt)
        # the same weights without the flag predict their own attend masks
        tm.use_offline_attn_mask = False
        free = tm(bt)
    n_rounds = len(out_j["predictions_class"])
    assert n_rounds == len(out_t["predictions_class"]) == \
        (1 if skip else 2 * 2 + 1)
    keep = np.ones(21, bool)
    keep[[0, 2]] = False
    valid = np.broadcast_to(b["seg_pad_masks"][:, :, None],
                            out_t["predictions_mask"][0].shape)
    for r in range(n_rounds):
        assert _rel(np.asarray(out_j["predictions_class"][r])[..., keep],
                    out_t["predictions_class"][r].numpy()[..., keep]) \
            <= TOL, r
        assert _rel(np.asarray(out_j["predictions_mask"][r])[valid],
                    out_t["predictions_mask"][r].numpy()[valid]) <= TOL, r
    assert _rel(out_t["predictions_mask"][-1].numpy()[valid],
                free["predictions_mask"][-1].numpy()[valid]) > 1e-3


def test_missing_offline_mask_raises():
    b = _gt_batch()
    b.pop("offline_attn_mask")
    jm, tm = _gt_models()
    bj = jax.tree_util.tree_map(jnp.asarray, b)
    with pytest.raises(ValueError, match="offline_attn_mask"):
        jm.init({"params": jax.random.key(0), "dropout": jax.random.key(1)},
                bj, train=False)
    tm.eval()
    with pytest.raises(ValueError, match="offline_attn_mask"):
        with torch.no_grad():
            tm(to_device(b, torch.device("cpu")))


def test_build_model_reads_the_flag():
    over = ["model.hidden_size=32",
            "model.unified_encoder.args.num_attention_heads=4",
            "model.unified_encoder.args.num_layers=1",
            "model.unified_encoder.args.num_blocks=1"]
    gt = tq3d.build_model(load_config("instseg_sceneverse_gt", over),
                          device="cpu")
    assert gt.use_offline_attn_mask and not gt.skip_query_encoder_mask_pred
    fps = tq3d.build_model(load_config("instseg_sceneverse", over),
                           device="cpu")
    assert not fps.use_offline_attn_mask


def _direct_inputs(seed, b=2, q=8, s=24, m=6, rounds=3):
    rng = np.random.default_rng(seed)
    cls = [rng.standard_normal((b, q, 21)).astype(np.float32) * 3
           for _ in range(rounds)]
    mask = [rng.standard_normal((b, s, q)).astype(np.float32) * 3
            for _ in range(rounds)]
    labels = rng.integers(0, 20, (b, m)).astype(np.int32)
    labels[0, 1] = -100                       # an ignored instance
    inst_valid = np.arange(m)[None] < np.array([[5], [3]])
    labels[~inst_valid] = 0                   # collate pads with 0
    batch = {"instance_labels": labels,
             "segment_masks": rng.random((b, m, s)) < 0.3,
             "instance_valid": inst_valid,
             "seg_pad_masks": np.arange(s)[None] < np.array([[24], [17]])}
    return cls, mask, batch


@pytest.mark.parametrize("seed", [0, 1])
def test_direct_loss_matches_jax(seed):
    cls, mask, batch = _direct_inputs(seed)
    total_j, parts_j = jlosses.instseg_direct_loss(
        [jnp.asarray(c) for c in cls], [jnp.asarray(m) for m in mask],
        jax.tree_util.tree_map(jnp.asarray, batch))
    total_t, parts_t = tlosses.instseg_direct_loss(
        [torch.from_numpy(c) for c in cls],
        [torch.from_numpy(m) for m in mask],
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(parts_t) == set(parts_j) and len(parts_t) == 9
    for k in parts_j:
        assert abs(float(parts_t[k]) - float(parts_j[k])) <= \
            TOL * abs(float(parts_j[k])), k
    assert abs(float(total_t) - float(total_j)) <= TOL * abs(float(total_j))


def test_direct_loss_ignores_padded_instances():
    """A padded instance slot (label 0 from collate) adds no CE term."""
    cls, mask, batch = _direct_inputs(0)
    bt = {k: torch.from_numpy(v) for k, v in batch.items()}
    c = [torch.from_numpy(x) for x in cls]
    m = [torch.from_numpy(x) for x in mask]
    _, parts = tlosses.instseg_direct_loss(c, m, bt)
    moved = [x.clone() for x in c]
    for x in moved:
        x[1, 4:, :] += 50.0       # queries of scene 1's padded slots 3-5
        x[1, 3, :] += 50.0
    _, parts2 = tlosses.instseg_direct_loss(moved, m, bt)
    assert float(parts2["loss_ce"]) == float(parts["loss_ce"])


def test_gt_train_step_matches_jax(monkeypatch):
    b = _gt_batch()
    jm, tm = _gt_models(dropout=0.0)
    bj = jax.tree_util.tree_map(jnp.asarray, b)
    variables = _init(jm, bj)
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)
    _f32_convs(monkeypatch)

    def loss_j(params):
        out, upd = jm.apply(
            {"params": params, "batch_stats": variables["batch_stats"],
             "buffers": variables["buffers"]}, bj, train=True,
            mutable=["batch_stats"])
        total, parts = jlosses.instseg_direct_loss(
            out["predictions_class"], out["predictions_mask"], bj)
        return total, (upd["batch_stats"], parts)
    (total_j, (stats_j, parts_j)), grads_j = jax.jit(
        jax.value_and_grad(loss_j, has_aux=True))(variables["params"])

    _route_small(monkeypatch, 128)
    load_flax_variables(tm, variables)
    tm.train()
    for m in tm.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    bt = to_device(b, torch.device("cpu"))
    out_t = tm(bt)
    total_t, parts_t = tlosses.instseg_direct_loss(
        out_t["predictions_class"], out_t["predictions_mask"], bt)
    total_t.backward()
    assert abs(total_t.item() - float(total_j)) <= TOL * abs(float(total_j))
    for k in parts_j:
        assert abs(parts_t[k].item() - float(parts_j[k])) <= \
            TOL * abs(float(parts_j[k])), k

    tparams = dict(tm.named_parameters())
    ref, got = [], []
    for path, g in jax.tree_util.tree_flatten_with_path(grads_j)[0]:
        name, r = torch_name(tm, tuple(p.key for p in path), np.asarray(g))
        t = tparams[name].grad
        ref.append(r.ravel())
        got.append(np.zeros(r.size, np.float32) if t is None
                   else t.numpy().ravel())
    ref, got = np.concatenate(ref), np.concatenate(got)
    l2 = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert l2 <= 1e-4, l2
    bufs = dict(tm.named_buffers())
    for path, v in jax.tree_util.tree_flatten_with_path(stats_j)[0]:
        name, r = torch_name(tm, tuple(p.key for p in path), np.asarray(v))
        assert _rel(r, bufs[name].numpy()) <= TOL, name
