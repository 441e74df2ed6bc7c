"""The tap-compacted conv (``compact_conv``) in the port against the JAX
package's, on the CPU, on the same seeded numpy inputs.

- ``build_compact_conv``: every array bit-equal to JAX's (slot order within
  a row included), on one scene's map and on a flat multi-scene map; the
  flat + compact batch of ``collate_flat`` bit-equal to JAX's.
- ``sparse_conv_compact`` against JAX's: max|diff| / max|ref| <= 1e-5 in
  f32 compute and with int8; in bf16 compute <= 2^-8, since the partial
  products are stored in bf16 on both sides and a sum in another order
  flips a product's last bit now and then (about 1 in 1e5).
- ``sparse_conv_compact_sym``'s dx and dW against ``jax.grad`` of JAX's
  custom VJP, and native autograd through ``sparse_conv_compact`` against
  JAX's autodiff, f32 compute, atol 2e-4 (``tests/test_ztriple.py``'s).
- A small Query3D (``tests/test_flat_pack.py:177``'s model) in the flat +
  compact layout against JAX's on the same weights: eval logits within
  the port's model tolerance (2e-2), and the port's compact forward against
  its rectangular one within JAX's own 5e-3; one ``scatter_free`` train
  step (``tests/test_flat_pack.py:207``; f32 conv compute, dropout off)
  against JAX's: loss within 1e-3 relative, every gradient max|diff| /
  max|ref| <= 1e-3, the batch-norm statistics within 1e-3.
"""
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pq3d_tpu.data import instseg_pipeline as jpipe
from pq3d_tpu.models import query3d as jq3d
from pq3d_tpu.ops import kernel_maps as jkm
from pq3d_tpu.ops import sparse as jsparse
from pq3d_tpu.optim import losses as jlosses
from pq3d_tpu_torch.data import instseg_pipeline as tpipe
from pq3d_tpu_torch.models import query3d as tq3d
from pq3d_tpu_torch.ops import kernel_maps as tkm
from pq3d_tpu_torch.ops import sparse as tsparse
from pq3d_tpu_torch.optim import losses as tlosses
from pq3d_tpu_torch.serve import to_device
from pq3d_tpu_torch.utils.weights import load_flax_variables, torch_name

from test_torch_flat_pack import _scenes
from test_torch_flat_train import _f32_convs as flat_train_f32
from test_torch_model import TOL, _random_variables, _rel
from test_torch_pipeline import _assert_same

torch.set_num_threads(1)
CPU = torch.device("cpu")
KW = dict(voxel_size=0.15, num_queries=8, max_segments=32, max_instances=8,
          voxel_bucket=128, stem_mode="dense_block")
PLAN = ("in_idx", "out_idx", "slots_a", "slots_b", "src")


def _hierarchy(seed=1, n=900, span=20):
    rng = np.random.default_rng(seed)
    coords = np.unique(rng.integers(0, span, (n, 3)), axis=0).astype(
        np.int32)
    return jkm.build_hierarchy(coords, bucket=256)


def _plans(nbr):
    return jkm.build_compact_conv(nbr), tkm.build_compact_conv(nbr)


def _flat_batches(seed=0, train=False, sizes=(700, 1000)):
    scenes = _scenes(seed, sizes)
    opts = dict(KW, use_aug=train, flat_pack=True, compact_conv=True)
    bj = jpipe.make_batch([dict(s) for s in scenes],
                          jpipe.InstSegPipelineConfig(**opts),
                          np.random.default_rng(1), train=train)
    bt = tpipe.make_batch([dict(s) for s in scenes],
                          tpipe.InstSegPipelineConfig(**opts),
                          np.random.default_rng(1), train=train)
    return bj, bt


@pytest.mark.parametrize("layout", ["scene", "flat"])
def test_build_compact_conv_bit_equal(layout):
    if layout == "scene":
        h = _hierarchy()
        maps = [h.nbr3[l] for l in range(3)]
    else:
        bj, bt = _flat_batches()
        _assert_same(bj, bt)
        maps = [bt["maps"][f"nbr3_{l}"] for l in range(5)]
        assert bt["maps"]["cmp4_sb"].shape[1] == 27
    for nbr in maps:
        pj, pt = _plans(nbr)
        assert set(pj) == set(pt)
        for k in PLAN:
            assert pt[k].dtype == pj[k].dtype, k
            np.testing.assert_array_equal(pt[k], pj[k], err_msg=k)
        assert pt["n_out"] == pj["n_out"] == len(nbr)
        # light and heavy rows both occur, and no row is lost
        n_taps = (nbr >= 0).sum(1)
        assert (n_taps > 8).any() and ((n_taps > 0) & (n_taps <= 8)).any()


def _conv_inputs(seed=2, cin=16, cout=24):
    h = _hierarchy(seed)
    nbr, valid = h.nbr3[0], np.asarray(h.valid[0])
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((len(valid), cin)).astype(np.float32)
    x[~valid] = 0
    w = (rng.standard_normal((27, cin, cout)) * 0.2).astype(np.float32)
    pj, pt = _plans(nbr)
    return (x, w, valid, {k: jnp.asarray(pj[k]) for k in PLAN},
            {k: torch.from_numpy(pt[k]) for k in PLAN}, nbr)


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
def test_sparse_conv_compact_matches_jax(mode):
    x, w, valid, pj, pt, nbr = _conv_inputs()
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if mode == "bf16"
                else (jnp.float32, torch.float32))
    i8 = mode == "int8"
    ref = np.asarray(jsparse.sparse_conv_compact(
        jnp.asarray(x), pj, jnp.asarray(w), jnp.asarray(valid),
        compute_dtype=jdt, int8_gather=i8))
    tx, tw, tv = (torch.from_numpy(a) for a in (x, w, valid))
    got = tsparse.sparse_conv_compact(tx, pt, tw, tv, compute_dtype=tdt,
                                      int8_gather=i8).numpy()
    assert _rel(ref, got) <= (2 ** -8 if mode == "bf16" else 1e-5)
    # the same function as the gather conv (the gather conv sums its f32
    # products, the compact conv its stored ones)
    gather = tsparse.sparse_conv(tx, torch.from_numpy(nbr), tw, None, tv,
                                 compute_dtype=tdt, int8_gather=i8).numpy()
    assert _rel(gather, got) <= (2 ** -7 if mode == "bf16" else 1e-5)


def _jgrads(fn, x, w, g):
    return jax.grad(lambda a, b: jnp.sum(fn(a, b) * g), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))


@pytest.mark.parametrize("mode", ["scatter_free", "native"])
def test_compact_gradients_match_jax(mode, monkeypatch):
    x, w, valid, pj, pt, _ = _conv_inputs(seed=3, cin=8, cout=12)
    g = np.random.default_rng(4).standard_normal(
        (len(valid), 12)).astype(np.float32)
    jv = jnp.asarray(valid)
    if mode == "scatter_free":
        ref = _jgrads(lambda a, b: jsparse.sparse_conv_compact_sym(
            a, pj, b, jv, compute_dtype=jnp.float32), x, w, g)
        monkeypatch.setattr(tsparse, "_round", lambda t, dtype: t.float())

        def conv(a, b):
            return tsparse.sparse_conv_compact_sym(a, pt, b,
                                                   torch.from_numpy(valid))
    else:
        ref = _jgrads(lambda a, b: jsparse.sparse_conv_compact(
            a, pj, b, jv, compute_dtype=jnp.float32), x, w, g)

        def conv(a, b):
            return tsparse.sparse_conv_compact(
                a, pt, b, torch.from_numpy(valid),
                compute_dtype=torch.float32)
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    conv(tx, tw).backward(torch.from_numpy(g))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(ref[0]), rtol=0,
                               atol=2e-4)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(ref[1]), rtol=0,
                               atol=2e-4)


def _with_features(b, n=2):
    b = {k: v for k, v in b.items() if not k.startswith("_")}
    rng = np.random.default_rng(5)
    for name in ("mv", "pc"):
        b[f"{name}_seg_fts"] = rng.standard_normal((n, 32, 16)).astype(
            np.float32)
        b[f"{name}_seg_pad_masks"] = b["seg_pad_masks"]
    b["instance_labels"] = (b["instance_labels"] % 17 + 3).astype(np.int32)
    return b


def _models(grad_mode="scatter_free"):
    """tests/test_flat_pack.py's small Query3D in both packages."""
    kw = dict(memories=("voxel", "mv", "pc"), heads=("mask",),
              hidden_size=32, dim_loc=3)
    unified = dict(num_layers=1, num_blocks=1, num_attention_heads=4,
                   structure="parallel", spatial_selfattn=True,
                   use_self_mask=True)
    jm = jq3d.Query3DUnified(
        unified=jq3d.UnifiedEncoderCfg(**unified),
        mv_enc=jq3d.EncoderCfg(input_feat_size=16, dropout=0.0),
        pc_enc=jq3d.EncoderCfg(input_feat_size=16, dropout=0.0),
        voxel_enc=jq3d.VoxelEncoderCfg(hlevels=(0, 1), out_channels=20,
                                       dropout=0.0, remat_policy="none",
                                       grad_mode=grad_mode),
        mask_head_cfg=jq3d.MaskHeadCfg(num_targets=21,
                                       filter_out_classes=(0, 2)), **kw)
    tm = tq3d.Query3DUnified(
        unified=tq3d.UnifiedEncoderCfg(**unified),
        mv_enc=tq3d.EncoderCfg(16, dropout=0.0),
        pc_enc=tq3d.EncoderCfg(16, dropout=0.0),
        voxel_enc=tq3d.VoxelEncoderCfg(hlevels=(0, 1), out_channels=20,
                                       dropout=0.0, grad_mode=grad_mode),
        mask_head_cfg=tq3d.MaskHeadCfg(21, (0, 2)), **kw)
    for m in tm.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return jm, tm


def test_flat_compact_forward_matches_jax_and_rect(monkeypatch):
    bj, bt = _flat_batches()
    scenes = _scenes(0, (700, 1000))
    br = tpipe.make_batch([dict(s) for s in scenes],
                          tpipe.InstSegPipelineConfig(**KW, use_aug=False),
                          np.random.default_rng(1))
    bj, bt, br = (_with_features(b) for b in (bj, bt, br))
    jm, tm = _models()
    jb = jax.tree_util.tree_map(jnp.asarray, bj)
    variables = _random_variables(lambda: jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, jb,
        train=False))
    out_j = jax.jit(lambda v, b: jm.apply(v, b, train=False))(variables, jb)
    load_flax_variables(tm, variables)
    tm.eval()
    calls = []
    orig = tsparse.sparse_conv_compact
    monkeypatch.setattr(tsparse, "sparse_conv_compact",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    with torch.inference_mode():
        out_t = tm(to_device(bt, CPU))
        n_compact = len(calls)
        out_r = tm(to_device(br, CPU))
    assert n_compact > 20
    seg_valid = bt["seg_pad_masks"][:, :, None]
    for key in ("predictions_class", "predictions_mask"):
        a = np.asarray(out_j[key][-1])
        c = out_t[key][-1].numpy()
        r = out_r[key][-1].numpy()
        if key == "predictions_mask":
            m = np.broadcast_to(seg_valid, a.shape)
            a, c, r = a[m], c[m], r[m]
        else:
            a, c, r = a[..., 3:], c[..., 3:], r[..., 3:]
        assert _rel(a, c) <= TOL, key
        np.testing.assert_allclose(c, r, atol=5e-3, err_msg=key)


def _f32_convs(monkeypatch):
    """Every sparse conv of both packages in f32 compute, the compact one
    among them."""
    flat_train_f32(monkeypatch)
    monkeypatch.setattr(jsparse, "sparse_conv_compact_sym", functools.partial(
        jsparse.sparse_conv_compact_sym, compute_dtype=jnp.float32))


def step_matches_jax(monkeypatch, b, jm, tm, spy=None):
    """One train step of ``jm`` and ``tm`` (dropout off, f32 conv compute)
    on the numpy batch ``b`` with the direct criterion: loss within 1e-3
    relative, every gradient max|diff| / max|ref| <= 1e-3 and the batch-norm
    statistics within 1e-3.  ``spy`` (module, name) counts the port's calls
    of a function, returned."""
    bj = jax.tree_util.tree_map(jnp.asarray, b)
    variables = _random_variables(lambda: jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, bj,
        train=False))
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)
    _f32_convs(monkeypatch)

    def loss_j(params):
        out, upd = jm.apply(
            {"params": params, "batch_stats": variables["batch_stats"],
             "buffers": variables["buffers"]}, bj, train=True,
            mutable=["batch_stats"])
        total, _ = jlosses.instseg_direct_loss(
            out["predictions_class"], out["predictions_mask"], bj)
        return total, upd["batch_stats"]
    (total_j, stats_j), grads_j = jax.jit(
        jax.value_and_grad(loss_j, has_aux=True))(variables["params"])

    load_flax_variables(tm, variables)
    tm.train()
    calls = []
    if spy is not None:
        orig = getattr(*spy)
        monkeypatch.setattr(spy[0], spy[1], lambda *a, **k: calls.append(1)
                            or orig(*a, **k))
    bt = to_device(b, CPU)
    out_t = tm(bt)
    total_t, _ = tlosses.instseg_direct_loss(
        out_t["predictions_class"], out_t["predictions_mask"], bt)
    total_t.backward()
    assert abs(total_t.item() - float(total_j)) <= 1e-3 * abs(float(total_j))
    tparams = dict(tm.named_parameters())
    floor = 1e-6 * max(float(np.abs(np.asarray(g)).max())
                       for g in jax.tree_util.tree_leaves(grads_j))
    checked = 0
    for path, g in jax.tree_util.tree_flatten_with_path(grads_j)[0]:
        name, ref = torch_name(tm, tuple(p.key for p in path), np.asarray(g))
        got = tparams[name].grad
        if not np.abs(ref).max() > floor:
            assert got is None or np.abs(got.numpy()).max() <= floor, name
            continue
        assert _rel(ref, got.numpy()) <= 1e-3, (name, _rel(ref, got.numpy()))
        checked += 1
    assert checked > 50
    for path, v in jax.tree_util.tree_flatten_with_path(stats_j)[0]:
        name, ref = torch_name(tm, tuple(p.key for p in path), np.asarray(v))
        np.testing.assert_allclose(dict(tm.named_buffers())[name].numpy(),
                                   ref, rtol=1e-3, atol=1e-3, err_msg=name)
    return len(calls)


def test_flat_compact_scatter_free_step_matches_jax(monkeypatch):
    bj, bt = _flat_batches(seed=4, train=True)
    _assert_same(bj, bt)
    jm, tm = _models("scatter_free")
    n = step_matches_jax(monkeypatch, _with_features(bj), jm, tm,
                         spy=(tsparse, "sparse_conv_compact_sym"))
    assert n > 20
