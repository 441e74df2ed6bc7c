"""The flat object layout of stage 2 (``UnifiedPipelineConfig.flat_obj``)
against the JAX package and against the padded layout, on the CPU:

- ``flat_obj_rows`` equal to JAX's; ``collate_unified``'s flat batch
  (``pc_obj_flat`` (F, P, 6), ``pc_flat_slot`` (B, O), pad slot F) bit
  for bit equal to JAX's from the same items, in eval and train mode;
- ``ObjectEncoder(flat_slot=)``: the frozen PointNet++ on the F real
  objects, scattered back, equals the padded layout's rows within 1e-6
  absolute (zero on padding); both refusals (no point backbone; an
  unfrozen backbone in training) raise ``ValueError``;
- the whole model: flat against JAX's flat forward within 1e-4, flat
  against the port's padded forward within 1e-5, tokens equal;
- a train step of ``build_multitask_trainer``'s model on the flat batch
  against the padded one from the same weights (loss parts within 1e-6,
  gradients within 1e-5 of the largest); ``run.single_device_reason``
  names ``flat_obj`` for stage 2."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pq3d_tpu.data import unified_pipeline as jup
from pq3d_tpu_torch import config as tconfig
from pq3d_tpu_torch import run as trun
from pq3d_tpu_torch.data import unified_pipeline as tup
from pq3d_tpu_torch.models.encoders import ObjectEncoder
from pq3d_tpu_torch.optim import optimizers as toptim
from pq3d_tpu_torch.serve import to_device
from pq3d_tpu_torch.train.state import make_train_step
from test_torch_unified import FEATURE_DIMS, PIPE, _rel, _requests
from test_torch_unified_variants import moved_pair

torch.set_num_threads(1)


def _items(pipe, n, train, seed=0, skip=()):
    rng = np.random.default_rng(seed)
    out = []
    for i, (s, l) in enumerate(_requests(n)):
        if i in skip:
            continue
        item = tup.process_item(s, l, pipe, rng, train, FEATURE_DIMS)
        out.append({k: v for k, v in item.items()
                    if not k.startswith("meta_")})
    return out


def test_flat_obj_rows_match_jax():
    for total in (0, 1, 5, 63, 64, 65, 300, 640, 5000):
        for b, o, bucket in ((8, 80, 64), (2, 8, 4), (32, 80, 64),
                             (1, 3, 1)):
            assert tup.flat_obj_rows(total, b, o, bucket) == \
                jup.flat_obj_rows(total, b, o, bucket)


@pytest.mark.parametrize("train", [False, True])
def test_flat_collate_bit_identical(train):
    kw = dict(PIPE, flat_obj=True, flat_obj_bucket=4)
    tpipe = tup.UnifiedPipelineConfig(**kw)
    jpipe = jup.UnifiedPipelineConfig(**kw)
    items = _items(tpipe, 5, train)
    tb = tup.collate_unified(items, tpipe, FEATURE_DIMS, train=train)
    jb = jup.collate_unified(items, jpipe, FEATURE_DIMS, train=train)
    assert set(tb) == set(jb)
    assert "obj_fts" not in tb and "pc_seg_fts" not in tb
    for k in jb:
        assert tb[k].dtype == jb[k].dtype, k
        np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    n_obj = [it["n_obj"] for it in items]
    F = tb["pc_obj_flat"].shape[0]
    assert F == tup.flat_obj_rows(sum(n_obj), 5, PIPE["max_obj_len"], 4)
    assert (tb["pc_flat_slot"][~tb["seg_pad_masks"]] == F).all()
    padded = tup.collate_unified(items, tup.UnifiedPipelineConfig(**PIPE),
                                 FEATURE_DIMS, train=train)
    slot = tb["pc_flat_slot"]
    real = slot < F
    np.testing.assert_array_equal(tb["pc_obj_flat"][slot[real]],
                                  padded["obj_fts"][real])
    assert not tb["pc_obj_flat"][sum(n_obj):].any()


def _flat_and_padded(n=6, skip=(1,)):
    """The same items collated in both layouts (one request dropped, so
    the flat rows are not a multiple of anything)."""
    pad_pipe = tup.UnifiedPipelineConfig(**PIPE)
    flat_pipe = tup.UnifiedPipelineConfig(**PIPE, flat_obj=True,
                                          flat_obj_bucket=4)
    items = _items(pad_pipe, n, False, skip=skip)
    padded = tup.collate_unified(items, pad_pipe, FEATURE_DIMS, train=False)
    flat = tup.collate_unified(items, flat_pipe, FEATURE_DIMS, train=False)
    padded.pop("obj_fts")
    return flat, padded


def test_object_encoder_flat_equals_padded_and_refusals():
    flat, padded = _flat_and_padded()
    torch.manual_seed(0)
    enc = ObjectEncoder(768, 32, backbone="pointnet++",
                        freeze_backbone=True).eval()
    with torch.no_grad():
        got = enc(torch.from_numpy(flat["pc_obj_flat"]),
                  flat_slot=torch.from_numpy(flat["pc_flat_slot"]))
        ref = enc(torch.from_numpy(padded["pc_seg_fts"]))
    valid = padded["seg_pad_masks"]
    assert got.shape == ref.shape
    assert np.abs(got.numpy()[valid] - ref.numpy()[valid]).max() <= 1e-6
    # padding slots read the appended zero row: the projection of zeros
    pad_row = enc.LayerNorm_0(enc.input_feat_proj(torch.zeros(768)))
    torch.testing.assert_close(got[torch.from_numpy(~valid)],
                               pad_row.expand(int((~valid).sum()), -1)
                               .detach())
    slot = torch.from_numpy(flat["pc_flat_slot"])
    pts = torch.from_numpy(flat["pc_obj_flat"])
    with pytest.raises(ValueError, match="pointnet"):
        ObjectEncoder(6, 32)(pts, flat_slot=slot)
    unfrozen = ObjectEncoder(768, 32, backbone="pointnet++",
                             freeze_backbone=False)
    with pytest.raises(ValueError, match="unfrozen"):
        unfrozen.train()(pts, flat_slot=slot)
    with torch.no_grad():
        unfrozen.eval()(pts, flat_slot=slot)       # eval mode serves it


def test_model_flat_matches_jax_and_padded():
    flat, padded = _flat_and_padded()
    jm, tm, variables = moved_pair("qa", padded)
    ref = jax.jit(lambda v, b: jm.apply(v, b, train=False))(
        variables, jax.tree.map(jnp.asarray, flat))
    with torch.no_grad():
        got = tm(to_device(flat, torch.device("cpu")))
        pad = tm(to_device(padded, torch.device("cpu")))
    valid = flat["query_pad_masks"]
    for k in ("ground_logits", "generation_logits", "answer_scores"):
        r, g, p = (np.asarray(x[k]) for x in (ref, got, pad))
        if k == "ground_logits":
            r, g, p = r[valid], g[valid], p[valid]
        assert _rel(r, g) <= 1e-4, k
        assert _rel(p, g) <= 1e-5, k
    np.testing.assert_array_equal(got["generation_tokens"].numpy(),
                                  np.asarray(ref["generation_tokens"]))
    np.testing.assert_array_equal(got["generation_tokens"].numpy(),
                                  pad["generation_tokens"].numpy())


SMALL = ["data.synthetic.n_points=400", "data.synthetic.n_instances=4",
         "data.unified_options.max_obj_len=6",
         "data.unified_options.num_points=32",
         "data.unified_options.prompt_len=8",
         "data.unified_options.response_len=6",
         "model.hidden_size=32", "model.txt_tower.width=16",
         "model.txt_tower.layers=1", "model.txt_tower.heads=2",
         "model.unified_encoder.args.num_attention_heads=4",
         "model.unified_encoder.args.num_layers=1",
         "model.unified_encoder.args.memory_dropout=0.0",
         "model.generation_head.args.d_model=16",
         "model.generation_head.args.d_kv=4",
         "model.generation_head.args.d_ff=32",
         "model.generation_head.args.num_layers=1",
         "model.generation_head.args.num_heads=2",
         "model.generation_head.args.max_new_tokens=4",
         "model.ground_head.args.hidden_size=16",
         "model.pc_encoder.args.freeze_backbone=True",
         "solver.sched.args.warmup_steps=0", "device=cpu",
         "data.unified_options.flat_obj=true",
         "data.unified_options.flat_obj_bucket=4"]


def test_flat_train_step_matches_padded(tmp_path):
    """``build_multitask_trainer`` reads ``flat_obj`` into its loaders; a
    train step (dropout off) on a flat batch equals the step on the same
    items collated padded."""
    cfg = tconfig.load_config("unified_tasks_synthetic", SMALL + [
        f"exp_dir={tmp_path}"])
    trainer = trun.build_multitask_trainer(cfg)
    lo = trainer.train_data.loaders[0]
    assert lo.cfg.flat_obj and lo.cfg.flat_obj_bucket == 4
    flat = next(iter(trainer.train_data(0)))
    assert "pc_obj_flat" in flat and "pc_seg_fts" not in flat
    pad_cfg = tup.UnifiedPipelineConfig(
        **{k: getattr(lo.cfg, k) for k in (
            "max_obj_len", "num_points", "prompt_len", "response_len")})
    sets = [lo_.dataset for lo_ in trainer.train_data.loaders]
    rng = np.random.default_rng(3)
    items = [tup.process_item(*sets[i % 3].get_item(i), pad_cfg, rng, True,
                              lo.feature_dims) for i in range(4)]
    items = [{k: v for k, v in it.items() if not k.startswith("meta_")}
             for it in items]
    batches = {
        "padded": tup.collate_unified(items, pad_cfg, lo.feature_dims),
        "flat": tup.collate_unified(items, lo.cfg, lo.feature_dims)}
    model = trainer.model
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    runs = {}
    for name, b in batches.items():
        net = copy.deepcopy(model).train()
        opt, sched, gn = toptim.build_from_config(cfg, net, 10)
        metrics = make_train_step(net, opt, sched, trainer.loss_fn, gn)(
            to_device(b, torch.device("cpu")))
        grads = {n: p.grad for n, p in net.named_parameters()
                 if p.grad is not None}
        runs[name] = ({k: float(v) for k, v in metrics.items()}, grads)
    (mp, gp), (mf, gf) = runs["padded"], runs["flat"]
    assert set(mp) == set(mf) and "loss" in mf
    for k in mp:
        assert abs(mf[k] - mp[k]) <= 1e-6 * max(abs(mp[k]), 1e-3), k
    gmax = max(g.abs().max().item() for g in gp.values())
    assert set(gp) == set(gf)
    for n in gp:
        assert (gf[n] - gp[n]).abs().max().item() <= 1e-5 * gmax, n
    trainer._close_loaders()


def test_flat_obj_is_a_single_device_layout():
    cfg = tconfig.load_config("unified_tasks_synthetic",
                              ["data.unified_options.flat_obj=true"])
    import pq3d_tpu_torch.parallel.dist as dist
    mp = pytest.MonkeyPatch()
    mp.setattr(dist, "world", lambda: 2)
    try:
        assert "flat_obj" in trun.single_device_reason(cfg)
        cfg["data"]["unified_options"]["flat_obj"] = False
        assert trun.single_device_reason(cfg) is None
    finally:
        mp.undo()
