"""The port's training ops against the JAX package's: the backward of the
z-run conv (kernel B1's ``zrun_conv_sym`` on its plain version), the
scatter-free sparse convs, train-mode MaskedBatchNorm and dropout.

Inputs are numpy from a seed; both sides get the same maps (the port's
pipeline output, flattened by each package's ``flatten_maps``).  Gradient
tolerance: max|diff| / max|ref| <= 3e-2, as the JAX package's own Pallas
gradient test: operands round to bf16 identically on both sides, f32 sums
differ in order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pq3d_tpu.models.layers import MaskedBatchNorm as JMaskedBatchNorm
from pq3d_tpu.models.sparse_unet import flatten_maps as jflatten
from pq3d_tpu.ops import sparse as jsparse
from pq3d_tpu_torch.data import synthetic
from pq3d_tpu_torch.data.instseg_pipeline import (InstSegPipelineConfig,
                                                  make_batch)
from pq3d_tpu_torch.models import query3d as tq3d
from pq3d_tpu_torch.models.layers import MaskedBatchNorm
from pq3d_tpu_torch.models.sparse_unet import flatten_maps as tflatten
from pq3d_tpu_torch.ops import sparse as tsparse
from pq3d_tpu_torch.ops import zrun_conv as tzr
from pq3d_tpu_torch.serve import to_device

torch.set_num_threads(1)
GRAD_TOL = 3e-2


def _rel(ref, got):
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    return float(np.abs(ref - got).max() / (np.abs(ref).max() + 1e-12))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    pipe = InstSegPipelineConfig(
        voxel_size=0.1, num_queries=8, max_segments=32, max_instances=8,
        voxel_bucket=128, use_aug=False, level_caps=[1024, 512, 256, 128,
                                                     128])
    scenes = [synthetic.make_scene(rng, n_points=n, n_instances=3,
                                   n_segments=16) for n in (1400, 1800)]
    return make_batch(scenes, pipe, rng), rng


@pytest.fixture(scope="module")
def maps():
    b, _ = _batch()
    fm_t = tflatten(to_device(b["maps"], torch.device("cpu")))
    fm_j = jflatten(jax.tree_util.tree_map(jnp.asarray, b["maps"]))
    return fm_t, fm_j


def _grads_t(fn, x, w, r):
    xt = torch.tensor(x, requires_grad=x is not None) if x is not None \
        else None
    wt = torch.tensor(w, requires_grad=True)
    y = fn(xt, wt)
    (y * torch.from_numpy(r)).sum().backward()
    return y.detach().numpy(), (None if xt is None else xt.grad.numpy()), \
        wt.grad.numpy()


def _grads_j(fn, x, w, r):
    if x is None:
        y, vjp = jax.vjp(lambda ww: fn(None, ww), jnp.asarray(w))
        (dw,) = vjp(jnp.asarray(r))
        return np.asarray(y), None, np.asarray(dw)
    y, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(w))
    dx, dw = vjp(jnp.asarray(r))
    return np.asarray(y), np.asarray(dx), np.asarray(dw)


def test_zrun_conv_sym_backward_matches_jax(maps):
    """B1's Function on the CPU (its plain version) against jax.grad of
    sparse_conv_ztriple_sym, the XLA twin of pallas_zt_conv_sym with the
    same VJP; plus its plain backward twin and the 27-tap dW."""
    fm_t, _ = maps
    nbr, valid = fm_t["nbr3_0"], fm_t["valid_0"]
    zb, zc = tzr.zrun_plan(nbr)
    rng = np.random.default_rng(1)
    n, cin, cout = nbr.shape[0], 32, 48
    x = (rng.standard_normal((n, cin)) * valid.numpy()[:, None]
         ).astype(np.float32)
    w = (rng.standard_normal((27, cin, cout)) * 0.1).astype(np.float32)
    r = rng.standard_normal((n, cout)).astype(np.float32)
    before = dict(tzr.phase_launches)
    y_t, dx_t, dw_t = _grads_t(
        lambda a, b: tzr.zrun_conv_sym(a, b, zb, zc, valid), x, w, r)
    assert tzr.phase_launches == before     # the CPU runs no kernel
    zbj, zcj, vj = (jnp.asarray(t.numpy()) for t in (zb, zc, valid))
    y_j, dx_j, dw_j = _grads_j(
        lambda a, b: jsparse.sparse_conv_ztriple_sym(a, zbj, zcj, b, vj),
        x, w, r)
    assert _rel(y_j, y_t) <= 1e-2
    assert _rel(dx_j, dx_t) <= GRAD_TOL
    assert _rel(dw_j, dw_t) <= GRAD_TOL
    dx_p, dw_p = tzr.zrun_conv_backward_reference(
        torch.from_numpy(x), torch.from_numpy(w), zb, zc, valid,
        torch.from_numpy(r))
    np.testing.assert_array_equal(dx_p.numpy(), dx_t)
    np.testing.assert_array_equal(dw_p.numpy(), dw_t)
    # the z-run re-gather is the 27-tap gather's dW on the same map
    dw_g = tsparse.conv_weight_grad(
        torch.from_numpy(x), nbr, torch.where(valid[:, None],
                                              torch.from_numpy(r), 0))
    assert _rel(dw_g.numpy(), dw_t) <= 1e-5


def _case(name, fm_t, fm_j):
    """(port fn, jax fn, x, w, cotangent) of one scatter-free conv."""
    if name == "sym":
        n = fm_t["nbr3_1"].shape[0]
        cin, cout, k = 24, 40, 27
        return (lambda x, w: tsparse.sparse_conv_sym(
                    x, fm_t["nbr3_1"], w, fm_t["valid_1"]),
                lambda x, w: jsparse.sparse_conv_sym(
                    x, fm_j["nbr3_1"], w, fm_j["valid_1"]),
                (n, cin), (k, cin, cout), (n, cout))
    if name == "down":
        n_in, n_out = fm_t["nbr3_0"].shape[0], fm_t["nbr3_1"].shape[0]
        cin, cout = 16, 32
        return (lambda x, w: tsparse.sparse_conv_down(
                    x, fm_t["child_0"], w, fm_t["parent_0"],
                    fm_t["parent_off_0"], fm_t["valid_1"], fm_t["valid_0"]),
                lambda x, w: jsparse.sparse_conv_down(
                    x, fm_j["child_0"], w, fm_j["parent_0"],
                    fm_j["parent_off_0"], fm_j["valid_1"], fm_j["valid_0"]),
                (n_in, cin), (8, cin, cout), (n_out, cout))
    if name == "transpose_gf":
        n_in, n_out = fm_t["nbr3_1"].shape[0], fm_t["nbr3_0"].shape[0]
        cin, cout = 32, 24
        return (lambda x, w: tsparse.sparse_conv_transpose_gf(
                    x, fm_t["parent_0"], fm_t["parent_off_0"], w,
                    fm_t["child_0"], fm_t["valid_0"], fm_t["valid_1"]),
                lambda x, w: jsparse.sparse_conv_transpose_gf(
                    x, fm_j["parent_0"], fm_j["parent_off_0"], w,
                    fm_j["child_0"], fm_j["valid_0"], fm_j["valid_1"]),
                (n_in, cin), (8, cin, cout), (n_out, cout))
    # the dense-block stem: dW only, its input is data
    n_out = fm_t["valid_0"].shape[0]
    dense = fm_t["stem_dense"]
    blk = fm_t["stem_block"]
    return (lambda x, w: tsparse.conv0_dense_block(
                dense, fm_t["stem_nbrblk"], fm_t["stem_slot"], w,
                fm_t["valid_0"], block=blk),
            lambda x, w: jsparse.conv0_dense_block(
                fm_j["stem_dense"], fm_j["stem_nbrblk"], fm_j["stem_slot"],
                fm_j["stem_c2v"], w, fm_j["valid_0"], block=blk),
            None, (125, 3, 32), (n_out, 32))


CONVS = ["sym", "down", "transpose_gf", "stem"]


@pytest.mark.parametrize("name", CONVS)
def test_scatter_free_conv_grads_match_jax(maps, name):
    fm_t, fm_j = maps
    rng = np.random.default_rng(CONVS.index(name))
    fn_t, fn_j, xs, ws, rs = _case(name, fm_t, fm_j)
    x = None if xs is None else rng.standard_normal(xs).astype(np.float32)
    w = (rng.standard_normal(ws) / np.sqrt(ws[0] * ws[1])).astype(
        np.float32)
    r = rng.standard_normal(rs).astype(np.float32)
    y_t, dx_t, dw_t = _grads_t(fn_t, x, w, r)
    y_j, dx_j, dw_j = _grads_j(fn_j, x, w, r)
    assert _rel(y_j, y_t) <= 1e-2
    assert np.abs(dw_j).max() > 0
    assert _rel(dw_j, dw_t) <= GRAD_TOL
    if x is not None:
        assert _rel(dx_j, dx_t) <= GRAD_TOL


@pytest.mark.parametrize("rows_per_chunk", [512, 1 << 18])
def test_stem_weight_grad_matches_conv3d_weight(rows_per_chunk):
    """The stem's unfolded-patch dW, in one chunk and in several, equals
    torch's conv3d weight gradient on the same halo (f32, 1e-5)."""
    rng = np.random.default_rng(5)
    nb, blk, k, cin, cout = 5, 4, 5, 3, 8
    h = blk + k - 1
    halo = torch.from_numpy(rng.standard_normal((nb, h, h, h, cin))
                            .astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((nb * blk ** 3, cout))
                         .astype(np.float32))
    got = tsparse._stem_weight_grad(halo, g, k, rows_per_chunk)
    ref = torch.nn.grad.conv3d_weight(
        halo.permute(0, 4, 1, 2, 3), (cout, cin, k, k, k),
        g.reshape(nb, blk, blk, blk, cout).permute(0, 4, 1, 2, 3))
    ref = ref.permute(2, 3, 4, 1, 0).reshape(k ** 3, cin, cout)
    assert _rel(ref.numpy(), got.numpy()) <= 1e-5


def test_masked_batchnorm_train_matches_flax():
    """Batch statistics over valid rows with the biased variance, for the
    output and for the running-stat update (momentum 0.02)."""
    rng = np.random.default_rng(3)
    n, c = 300, 24
    x = (rng.standard_normal((n, c)) * 2 + 0.5).astype(np.float32)
    valid = rng.random(n) < 0.8
    x[~valid] = 0
    params = {"scale": (1 + 0.1 * rng.standard_normal(c)).astype(np.float32),
              "bias": (0.1 * rng.standard_normal(c)).astype(np.float32)}
    stats = {"mean": rng.normal(0, 0.3, c).astype(np.float32),
             "var": rng.uniform(0.5, 2, c).astype(np.float32)}
    out_j, upd = JMaskedBatchNorm(0.02).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x),
        jnp.asarray(valid), use_running_average=False,
        mutable=["batch_stats"])
    bn = MaskedBatchNorm(c, momentum=0.02).train()
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(params["scale"]))
        bn.bias.copy_(torch.from_numpy(params["bias"]))
        bn.mean.copy_(torch.from_numpy(stats["mean"]))
        bn.var.copy_(torch.from_numpy(stats["var"]))
    xt = torch.from_numpy(x).requires_grad_(True)
    out_t = bn(xt, torch.from_numpy(valid))
    out_t.sum().backward()            # the buffers stay out of the graph
    assert not bn.mean.requires_grad and not bn.var.requires_grad
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=1e-5, atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(bn, k).numpy(),
                                   np.asarray(upd["batch_stats"][k]),
                                   rtol=1e-5, atol=1e-6)
    bn.eval()                         # eval mode reads the running stats
    ref = JMaskedBatchNorm(0.02).apply(
        {"params": params, "batch_stats": upd["batch_stats"]},
        jnp.asarray(x), jnp.asarray(valid), use_running_average=True)
    with torch.no_grad():
        np.testing.assert_allclose(
            bn(torch.from_numpy(x), torch.from_numpy(valid)).numpy(),
            np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_dropout_only_in_train_mode():
    b, rng = _batch(seed=5)
    b.pop("_meta")
    for name in ("mv", "pc"):
        b[f"{name}_seg_fts"] = rng.standard_normal((2, 32, 16)).astype(
            np.float32)
        b[f"{name}_seg_pad_masks"] = b["seg_pad_masks"]
    model = tq3d.Query3DUnified(
        hidden_size=32,
        unified=tq3d.UnifiedEncoderCfg(num_layers=1, num_blocks=1,
                                       num_attention_heads=4,
                                       use_self_mask=True),
        mv_enc=tq3d.EncoderCfg(16, dropout=0.3),
        pc_enc=tq3d.EncoderCfg(16, dropout=0.3),
        voxel_enc=tq3d.VoxelEncoderCfg(hlevels=(0,), out_channels=20,
                                       dropout=0.3),
        mask_head_cfg=tq3d.MaskHeadCfg(21, (0, 2)))
    tq3d.init_weights(model, torch.Generator().manual_seed(0))
    batch = to_device(b, torch.device("cpu"))
    drops = [m for m in model.modules() if isinstance(m, torch.nn.Dropout)]
    assert drops and all(m.p > 0 for m in drops)

    def logits():
        with torch.no_grad():
            return model(batch)["predictions_class"][-1]
    model.train()
    assert not torch.equal(logits(), logits())
    model.eval()
    assert torch.equal(logits(), logits())
