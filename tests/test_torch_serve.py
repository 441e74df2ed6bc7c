"""The port's serving path (pq3d_tpu_torch/serve.py) on the CPU: ranking
bit-identical to the JAX package's, full-resolution answers through
submit(), and per-batch logits equal to the JAX model's forward on the
same batch with the same weights (max|diff| / max|ref| <= 2e-2)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from pq3d_tpu.eval.instseg_eval import rank_instances as j_rank
from pq3d_tpu.models import query3d as jq3d
from pq3d_tpu_torch.data import synthetic
from pq3d_tpu_torch.data.instseg_pipeline import InstSegPipelineConfig
from pq3d_tpu_torch.eval.instseg_eval import rank_instances as t_rank
from pq3d_tpu_torch.models import query3d as tq3d
from pq3d_tpu_torch.serve import InstSegServer
from pq3d_tpu_torch.utils.weights import load_flax_variables

torch.set_num_threads(1)
TOL = 2e-2


def test_rank_instances_bit_identical():
    rng = np.random.default_rng(0)
    for s, q in ((32, 8), (64, 20)):
        cls = rng.standard_normal((q, 21)).astype(np.float32) * 3
        mask = rng.standard_normal((s, q)).astype(np.float32) * 2
        seg_valid = rng.random(s) > 0.2
        seg_to_full = rng.integers(0, s, 500).astype(np.int32)
        for full in (None, seg_to_full):
            a = j_rank(cls, mask, seg_valid, num_classes=20, topk=15,
                       seg_to_full=full)
            b = t_rank(cls, mask, seg_valid, num_classes=20, topk=15,
                       seg_to_full=full)
            assert len(a) == len(b) > 0
            for pa, pb in zip(a, b):
                assert pa["class"] == pb["class"]
                assert pa["score"] == pb["score"]
                np.testing.assert_array_equal(pa["mask"], pb["mask"])


class _RecordingServer(InstSegServer):
    """Keeps each batch it ran and the logits it produced."""

    def __init__(self, *a, **k):
        self.seen = []
        super().__init__(*a, **k)

    def _forward(self, batch):
        cls_l, mask_l = super()._forward(batch)
        self.seen.append(({k: (v.numpy() if not isinstance(v, dict) else
                               {kk: vv.numpy() for kk, vv in v.items()})
                           for k, v in batch.items()},
                          cls_l.numpy(), mask_l.numpy()))
        return cls_l, mask_l


def test_server_answers_and_matches_jax_forward():
    rng = np.random.default_rng(0)
    pipe = InstSegPipelineConfig(
        voxel_size=0.15, num_queries=8, max_segments=32, max_instances=8,
        voxel_bucket=128, use_aug=False, stem_mode="dense_block",
        level_caps=[512, 256, 128, 128, 128])
    scenes = [synthetic.make_scene(rng, n_points=n, n_instances=3,
                                   n_segments=16) for n in (600, 900, 700)]
    for s in scenes:
        s["inst_labels"] = np.minimum(s["inst_labels"], 19)
    kw = dict(memories=("voxel", "mv", "pc"), heads=("mask",),
              hidden_size=32, dim_loc=3)
    tm = tq3d.Query3DUnified(
        unified=tq3d.UnifiedEncoderCfg(num_layers=1, num_blocks=1,
                                       num_attention_heads=4,
                                       use_self_mask=True),
        mv_enc=tq3d.EncoderCfg(16), pc_enc=tq3d.EncoderCfg(16),
        voxel_enc=tq3d.VoxelEncoderCfg(hlevels=(0, 1), out_channels=20,
                                       pallas_conv=True),
        mask_head_cfg=tq3d.MaskHeadCfg(21, (0, 2)), **kw)
    tq3d.init_weights(tm, torch.Generator().manual_seed(0))
    tm.eval()

    srv = _RecordingServer(tm, pipe, batch_size=2, num_classes=20, topk=20,
                           max_delay_s=0.01,
                           extra_features={"mv": 16, "pc": 16},
                           device="cpu")
    try:
        results = [f.result(timeout=300)
                   for f in [srv.submit(s) for s in scenes]]
    finally:
        srv.close()
    assert srv.stats.summary()["scenes"] == 3 and len(srv.seen) >= 2
    for s, preds in zip(scenes, results):
        assert isinstance(preds, list)
        for p in preds:
            assert p["mask"].shape == (len(s["points"]),)
            assert 0 <= p["class"] < 20
            assert np.isfinite(p["score"]) and p["score"] > 0

    # the same weights in the JAX model; its forward on each served batch
    jm = jq3d.Query3DUnified(
        unified=jq3d.UnifiedEncoderCfg(num_layers=1, num_blocks=1,
                                       num_attention_heads=4,
                                       structure="parallel",
                                       spatial_selfattn=True,
                                       use_self_mask=True),
        mv_enc=jq3d.EncoderCfg(input_feat_size=16),
        pc_enc=jq3d.EncoderCfg(input_feat_size=16),
        voxel_enc=jq3d.VoxelEncoderCfg(hlevels=(0, 1), out_channels=20),
        mask_head_cfg=jq3d.MaskHeadCfg(num_targets=21,
                                       filter_out_classes=(0, 2)), **kw)
    batch0 = jax.tree_util.tree_map(jnp.asarray, srv.seen[0][0])
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        batch0, train=False))
    state = {n: t.detach().numpy() for n, t in tm.state_dict().items()}

    def from_port(path, leaf):
        # inverse of load_flax_variables' path rule, for this test's model
        names = [p.key for p in path[1:]]
        mod = ".".join(names[:-1])
        module = tm.get_submodule(mod)
        name = names[-1]
        if isinstance(module, torch.nn.Linear) and name == "kernel":
            return state[f"{mod}.weight"].T
        if isinstance(module, torch.nn.LayerNorm) and name == "scale":
            return state[f"{mod}.weight"]
        return state[f"{mod}.{name}"]
    variables = jax.tree_util.tree_map_with_path(from_port, shapes)
    load_flax_variables(tm, variables)    # round trip is one-to-one
    fwd = jax.jit(lambda v, b: jm.apply(v, b, train=False))
    for batch, cls_t, mask_t in srv.seen:
        out = fwd(variables, jax.tree_util.tree_map(jnp.asarray, batch))
        cls_j = np.asarray(out["predictions_class"][-1])
        mask_j = np.asarray(out["predictions_mask"][-1])
        keep = np.ones(cls_j.shape[-1], bool)
        keep[[0, 2]] = False
        d = np.abs(cls_j[..., keep] - cls_t[..., keep]).max()
        assert d / np.abs(cls_j[..., keep]).max() <= TOL
        valid = np.broadcast_to(batch["seg_pad_masks"][:, :, None],
                                mask_j.shape)
        d = np.abs(mask_j[valid] - mask_t[valid]).max()
        assert d / np.abs(mask_j[valid]).max() <= TOL
