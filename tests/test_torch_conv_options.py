"""The voxel encoder's conv options in the port against the JAX package's,
on the CPU, on the same seeded numpy inputs.

- ``quantize_rows``: q bit-equal, the scale within 1 ulp.
- ``int8_gather`` in ``sparse_conv`` and ``sparse_conv_transpose`` against
  JAX's int8 functions (not against the f32 conv): max|diff| / max|ref|
  <= 1e-5, the f32 path's tolerance, in f32 and bf16 compute.  The
  transpose conv quantizes its f32 partial products, so a product whose
  ``y / s`` sits within 1e-4 of a rounding boundary of ``round`` may take
  the neighbouring step on one side: such entries (under 0.1% of them)
  are allowed one step (``s``); every other entry is held to 1e-5.
- ``sorted_conv_maps`` equal to JAX's, and every conv with
  ``sorted_maps`` bit-equal to the default one, values and gradients, as
  is the U-Net with ``sorted_gather`` under both grad modes.
- ``grad_mode: native``: autograd through the port's conv, down conv,
  transpose conv and z-run gather conv against ``jax.grad`` of JAX's (f32
  compute), atol 2e-4 (``tests/test_ztriple.py``'s).
- The U-Net: int8 is off in train mode and under ``scatter_free`` (bit
  for bit the model without it), as in JAX; the int8 eval forward under
  ``native`` against JAX's within the model tolerance (2e-2); each
  ``remat_policy``'s gradients and batch-norm statistics equal ``none``'s
  under both grad modes.
- The Swin3D encoder warns that ``sorted_gather``, ``int8_gather`` and
  ``pallas_conv`` are ignored and computes what it computes without them;
  its remat gives ``none``'s gradients.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pq3d_tpu.models.sparse_unet import Res16UNet as JRes16UNet
from pq3d_tpu.ops import kernel_maps as jkm
from pq3d_tpu.ops import sparse as jsparse
from pq3d_tpu_torch.models.encoders import SegVoxelEncoder
from pq3d_tpu_torch.models.sparse_unet import Res16UNet as TRes16UNet
from pq3d_tpu_torch.ops import sparse as tsparse
from pq3d_tpu_torch.serve import to_device
from pq3d_tpu_torch.utils.weights import load_flax_variables

from test_torch_model import TOL, _batch, _random_variables, _rel

torch.set_num_threads(1)
CPU = torch.device("cpu")
F32 = (jnp.float32, torch.float32)
BF16 = (jnp.bfloat16, torch.bfloat16)


def _level(seed=1, n=700, span=24, level=0):
    """A hierarchy of random coordinates: (nbr3, valid, child, parent,
    parent_off, coarse valid) of ``level``."""
    rng = np.random.default_rng(seed)
    coords = np.unique(rng.integers(0, span, (n, 3)), axis=0).astype(
        np.int32)
    h = jkm.build_hierarchy(coords, bucket=128)
    return (h.nbr3[level], np.asarray(h.valid[level]), h.child[level],
            h.parent[level], h.parent_off[level],
            np.asarray(h.valid[level + 1]))


def _x(rng, n, c, valid=None):
    x = rng.standard_normal((n, c)).astype(np.float32)
    if valid is not None:
        x[~valid] = 0
    return x


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_quantize_rows_matches_jax():
    rng = np.random.default_rng(0)
    x = _x(rng, 500, 24) * rng.uniform(0.01, 5, 24).astype(np.float32)
    x[:, 3] = 0                                  # a zero channel: eps
    x[7, 5] = 0.5 * 127 * np.abs(x[:, 5]).max() / 127  # a half step
    q, s = tsparse.quantize_rows(torch.from_numpy(x))
    qj, sj = jsparse.quantize_rows(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_max_ulp(s.numpy(), np.asarray(sj), maxulp=1)


@pytest.mark.parametrize("dtypes", [F32, BF16], ids=["f32", "bf16"])
def test_int8_sparse_conv_matches_jax_int8(dtypes):
    nbr, valid, *_ = _level()
    rng = np.random.default_rng(2)
    x = _x(rng, len(valid), 16, valid)
    w = (rng.standard_normal((27, 16, 24)) * 0.2).astype(np.float32)
    ref = np.asarray(jsparse.sparse_conv(
        jnp.asarray(x), jnp.asarray(nbr), jnp.asarray(w), None,
        jnp.asarray(valid), compute_dtype=dtypes[0], int8_gather=True))
    tx, tn, tw, tv = _t(x, nbr, w, valid)
    got = tsparse.sparse_conv(tx, tn, tw, None, tv, compute_dtype=dtypes[1],
                              int8_gather=True)
    assert _rel(ref, got.numpy()) <= 1e-5
    # the quantisation is really on: the f32 conv differs by far more
    plain = tsparse.sparse_conv(tx, tn, tw, None, tv, compute_dtype=dtypes[1])
    assert _rel(plain.numpy(), got.numpy()) > 1e-3


@pytest.mark.parametrize("dtypes", [F32, BF16], ids=["f32", "bf16"])
def test_int8_transpose_matches_jax_int8(dtypes):
    _, valid, _, parent, poff, cvalid = _level(seed=3, n=900)
    rng = np.random.default_rng(4)
    x = _x(rng, len(cvalid), 24, cvalid)
    w = (rng.standard_normal((8, 24, 16)) * 0.2).astype(np.float32)
    args = (parent, poff, w, valid)
    ref = np.asarray(jsparse.sparse_conv_transpose(
        jnp.asarray(x), *map(jnp.asarray, args), compute_dtype=dtypes[0],
        int8_gather=True))
    got = tsparse.sparse_conv_transpose(
        *_t(x, *args), compute_dtype=dtypes[1], int8_gather=True).numpy()
    # the partial products and their scales, for the boundary exemption
    y = np.einsum("nc,kcd->knd", np.asarray(jnp.asarray(x).astype(
        dtypes[0]).astype(jnp.float32)), np.asarray(jnp.asarray(w).astype(
            dtypes[0]).astype(jnp.float32))).reshape(-1, 16)
    s = np.asarray(jsparse.quantize_rows(jnp.asarray(y))[1])
    frac = (y / s) % 1.0
    near = np.abs(frac - 0.5) < 1e-4
    flat = poff.astype(np.int64) * len(cvalid) + np.maximum(parent, 0)
    edge = near[flat] & (parent >= 0)[:, None] & valid[:, None]
    scale = np.abs(ref).max()
    diff = np.abs(ref - got)
    assert (diff[~edge] <= 1e-5 * scale).all()
    assert (diff[edge] <= s[None, :].repeat(len(ref), 0)[edge] * 1.001
            + 1e-5 * scale).all()
    assert edge.mean() < 1e-3


def test_sorted_conv_maps_match_jax():
    for level in (0, 1):
        nbr, *_ = _level(level=level)
        idx, valid = tsparse.sorted_conv_maps(torch.from_numpy(nbr))
        jidx, jvalid = jsparse.sorted_conv_maps(jnp.asarray(nbr))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
        assert (np.diff(idx.numpy(), axis=0) >= 0).all()


def _grads(fn, *inputs):
    ins = [t.clone().requires_grad_(True) for t in inputs]
    y = fn(*ins)
    g = torch.from_numpy(np.random.default_rng(9).standard_normal(
        tuple(y.shape)).astype(np.float32))
    y.backward(g)
    return y.detach(), [t.grad for t in ins]


def test_sorted_convs_bit_equal_default():
    nbr, valid, child, parent, poff, cvalid = _level()
    rng = np.random.default_rng(5)
    x, x1 = _x(rng, len(valid), 16, valid), _x(rng, len(cvalid), 16, cvalid)
    w, wd = (rng.standard_normal((27, 16, 8)).astype(np.float32),
             rng.standard_normal((8, 16, 8)).astype(np.float32))
    tn, tv, tc, tp, to, tcv = _t(nbr, valid, child, parent, poff, cvalid)
    cases = [
        (lambda sm: lambda a, b: tsparse.sparse_conv(
            a, tn, b, None, tv, sorted_maps=sm, int8_gather=True),
         (x, w)),
        (lambda sm: lambda a, b: tsparse.sparse_conv_sym(
            a, tn, b, tv, sorted_maps=sm), (x, w)),
        (lambda sm: lambda a, b: tsparse.sparse_conv_down(
            a, tc, b, tp, to, tcv, tv, sorted_maps=sm), (x, wd)),
        (lambda sm: lambda a, b: tsparse.sparse_conv_transpose_gf(
            a, tp, to, b, tc, tv, tcv, sorted_maps=sm), (x1, wd)),
    ]
    for make, ins in cases:
        y0, g0 = _grads(make(False), *_t(*ins))
        y1, g1 = _grads(make(True), *_t(*ins))
        assert torch.equal(y0, y1)
        for a, b in zip(g0, g1):
            assert a is None and b is None or torch.equal(a, b)


def _native_case(kind):
    """(JAX function, port function, inputs) of one native-mode conv in
    f32 compute."""
    nbr, valid, child, parent, poff, cvalid = _level(seed=6, n=800)
    rng = np.random.default_rng(7)
    f32 = dict(compute_dtype=jnp.float32)
    tf32 = dict(compute_dtype=torch.float32)
    if kind == "conv":
        x, w = _x(rng, len(valid), 8, valid), rng.standard_normal(
            (27, 8, 12)).astype(np.float32)
        return (lambda a, b: jsparse.sparse_conv(
                    a, jnp.asarray(nbr), b, None, jnp.asarray(valid), **f32),
                lambda a, b: tsparse.sparse_conv(
                    a, *_t(nbr), b, None, *_t(valid), **tf32), x, w)
    if kind == "down":
        x, w = _x(rng, len(valid), 8, valid), rng.standard_normal(
            (8, 8, 12)).astype(np.float32)
        return (lambda a, b: jsparse.sparse_conv(
                    a, jnp.asarray(child), b, None, jnp.asarray(cvalid),
                    **f32),
                lambda a, b: tsparse.sparse_conv(
                    a, *_t(child), b, None, *_t(cvalid), **tf32), x, w)
    if kind == "transpose":
        x, w = _x(rng, len(cvalid), 8, cvalid), rng.standard_normal(
            (8, 8, 12)).astype(np.float32)
        return (lambda a, b: jsparse.sparse_conv_transpose(
                    a, jnp.asarray(parent), jnp.asarray(poff), b,
                    jnp.asarray(valid), **f32),
                lambda a, b: tsparse.sparse_conv_transpose(
                    a, *_t(parent, poff), b, *_t(valid), **tf32), x, w)
    zb, zc = jkm.build_ztriple_plan(nbr)
    x, w = _x(rng, len(valid), 8, valid), rng.standard_normal(
        (27, 8, 12)).astype(np.float32)
    return (lambda a, b: jsparse.sparse_conv_ztriple(
                a, jnp.asarray(zb), jnp.asarray(zc), b, jnp.asarray(valid),
                **f32),
            lambda a, b: tsparse.sparse_conv_ztriple(
                a, *_t(zb, zc), b, *_t(valid), **tf32), x, w)


@pytest.mark.parametrize("kind", ["conv", "down", "transpose", "ztriple"])
def test_native_gradients_match_jax(kind):
    jfn, tfn, x, w = _native_case(kind)
    y = np.asarray(jfn(jnp.asarray(x), jnp.asarray(w)))
    g = np.random.default_rng(9).standard_normal(y.shape).astype(np.float32)
    ref = jax.grad(lambda a, b: jnp.sum(jfn(a, b) * g), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    tx, tw = (t.requires_grad_(True) for t in _t(x, w))
    out = tfn(tx, tw)
    np.testing.assert_allclose(out.detach().numpy(), y, rtol=0, atol=2e-4)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(ref[0]), rtol=0,
                               atol=2e-4)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(ref[1]), rtol=0,
                               atol=2e-4)


def _unet(**kw):
    b = _batch()
    maps_j = jax.tree_util.tree_map(jnp.asarray, b["maps"])
    x = jnp.asarray(b["voxel_feats"])
    variables = _random_variables(lambda: JRes16UNet().init(
        jax.random.key(0), x, maps_j, train=False))
    model = TRes16UNet(**kw)
    load_flax_variables(model, variables)
    return b, variables, model


def _unet_forward(model, b, train):
    model.train(train)
    x = torch.from_numpy(b["voxel_feats"]).requires_grad_(False)
    out, fm = model(x, to_device(b["maps"], CPU))
    return out, fm


def test_int8_off_in_train_mode_and_under_scatter_free():
    b, _, model = _unet(int8_gather=True)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    outs = {}
    for gm in ("scatter_free", "native"):
        for train in (False, True):
            for i8 in (False, True):
                model.load_state_dict(state)
                model.grad_mode, model.int8_gather = gm, i8
                with torch.no_grad():
                    outs[gm, train, i8] = _unet_forward(model, b, train)[0]
    for key in (("scatter_free", False), ("scatter_free", True),
                ("native", True)):
        assert torch.equal(outs[key + (False,)], outs[key + (True,)]), key
    assert not torch.equal(outs["native", False, False],
                           outs["native", False, True])


@pytest.mark.parametrize("grad_mode", ["scatter_free", "native"])
def test_sorted_gather_model_bit_equal(grad_mode):
    """The U-Net with sorted_gather (each map made monotone once per
    forward) against without: train-mode output, gradients and statistics
    bit for bit."""
    b, _, model = _unet(grad_mode=grad_mode)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    ref = _train_grads(model, b, state)
    model.sorted_gather = True
    got = _train_grads(model, b, state)
    assert got[0] == ref[0] and set(got[1]) == set(ref[1])
    for n in ref[1]:
        assert torch.equal(got[1][n], ref[1][n]), n
    for n in ref[2]:
        assert torch.equal(got[2][n], ref[2][n]), n


def test_int8_native_eval_forward_matches_jax():
    b, variables, model = _unet(grad_mode="native", int8_gather=True)
    maps_j = jax.tree_util.tree_map(jnp.asarray, b["maps"])
    jm = JRes16UNet(grad_mode="native", int8_gather=True)
    out_j, fm_j = jax.jit(lambda v: jm.apply(
        v, jnp.asarray(b["voxel_feats"]), maps_j, train=False))(variables)
    with torch.inference_mode():
        out_t, fm_t = _unet_forward(model, b, False)
    assert _rel(out_j, out_t.numpy()) <= TOL
    for a, c in zip(fm_j, fm_t):
        assert _rel(a, c.numpy()) <= TOL


def _train_grads(model, b, state):
    model.load_state_dict(state)
    model.zero_grad(set_to_none=True)
    out, fm = _unet_forward(model, b, True)
    g = np.random.default_rng(3)
    loss = (out * torch.from_numpy(g.standard_normal(
        tuple(out.shape)).astype(np.float32))).sum() + sum(
        (f * f).mean() for f in fm)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    stats = {n: v.clone() for n, v in model.named_buffers()}
    return loss.item(), grads, stats


@pytest.mark.parametrize("grad_mode", ["scatter_free", "native"])
@pytest.mark.parametrize("policy", ["full", "dots", "gather_only"])
def test_remat_policy_gradients_equal_none(policy, grad_mode):
    """Exactly equal on the CPU: the recomputation repeats the same
    arithmetic, and the batch norms update their statistics once."""
    b, _, model = _unet(grad_mode=grad_mode)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    model.remat_policy = "none"
    ref = _train_grads(model, b, state)
    model.remat_policy = policy
    got = _train_grads(model, b, state)
    assert got[0] == ref[0]
    assert set(got[1]) == set(ref[1]) and len(ref[1]) > 50
    for n in ref[1]:
        assert torch.equal(got[1][n], ref[1][n]), n
    for n in ref[2]:
        assert torch.equal(got[2][n], ref[2][n]), n
    assert not torch.equal(ref[2]["bn0.mean"], state["bn0.mean"])


SMALL_SWIN = dict(channels=(8, 16, 24, 32), depths=(1, 1, 2, 1),
                  num_heads=(2, 2, 2, 2), stem_dim=8)


def _swin_encoder(monkeypatch, **kw):
    """A small-width swin SegVoxelEncoder (test_torch_swin_model's
    widths), weights from torch's seed 0."""
    from pq3d_tpu_torch.models import swin3d as tswin
    full = tswin.Swin3DUNet
    monkeypatch.setattr(tswin, "Swin3DUNet",
                        lambda **a: full(**{**a, **SMALL_SWIN}))
    torch.manual_seed(0)
    try:
        return SegVoxelEncoder(hidden_size=32, hlevels=(0, 1),
                               backbone_out_channels=20, backbone="swin3d",
                               dropout=0.0, **kw)
    finally:
        monkeypatch.setattr(tswin, "Swin3DUNet", full)


def _swin_batch():
    from pq3d_tpu.data import synthetic as jsyn
    from pq3d_tpu_torch.data import instseg_pipeline as tpipe
    rng = np.random.default_rng(7)
    scenes = [jsyn.make_scene(rng, n_points=n, n_instances=4, n_segments=20)
              for n in (700, 1000)]
    cfg = tpipe.InstSegPipelineConfig(
        voxel_size=0.15, num_queries=8, max_segments=32, max_instances=8,
        voxel_bucket=128, use_aug=False, stem_mode="none", swin_window=4,
        flat_pack=True)
    b = tpipe.make_batch(scenes, cfg, np.random.default_rng(0))
    return to_device({k: v for k, v in b.items() if k != "_meta"}, CPU)


def test_swin3d_ignores_conv_gather_flags(monkeypatch):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        flagged = SegVoxelEncoder(hidden_size=32, backbone="swin3d",
                                  sorted_gather=True, int8_gather=True,
                                  pallas_conv=True)
    msg = " ".join(str(x.message) for x in w)
    assert "sorted_gather/int8_gather/pallas_conv" in msg and "ignored" in msg
    assert not hasattr(flagged.backbone, "int8_gather")
    tb = _swin_batch()
    s = int(tb["seg_pad_masks"].shape[1])
    plain = _swin_encoder(monkeypatch)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        other = _swin_encoder(monkeypatch, sorted_gather=True, int8_gather=True,
                              pallas_conv=True, remat_policy="full")
    other.load_state_dict(plain.state_dict())
    args = (tb["voxel_feats"], tb["maps"], tb["voxel2segment"], s)
    with torch.inference_mode():
        plain.eval()
        other.eval()
        for x, y in zip(plain(*args), other(*args)):
            assert torch.equal(x, y)
    # the swin remat ('full': any policy but 'none') gives the gradients
    # and statistics of no remat
    results = []
    for enc in (plain, other):
        enc.train()
        outs = enc(*args)
        sum((o * o).sum() for o in outs).backward()
        results.append(({n: p.grad for n, p in enc.named_parameters()
                         if p.grad is not None},
                        {n: v for n, v in enc.named_buffers()}))
    assert set(results[0][0]) == set(results[1][0]) and results[0][0]
    for n in results[0][0]:
        assert torch.equal(results[1][0][n], results[0][0][n]), n
    for n in results[0][1]:
        assert torch.equal(results[1][1][n], results[0][1][n]), n
