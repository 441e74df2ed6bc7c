"""The port's export (pq3d_tpu_torch/export.py) and kernel B1 as the
operator ``pq3d::zrun_conv``, against the JAX package's export cases
(tests/test_export.py).

Stage 1: tests/test_export.py's model (hidden 32, one parallel block,
hlevels (0, 1), the full-width Res16UNet34C) with JAX's weights moved by
load_flax_variables and routing lowered so the small levels run B1 (its
plain version on the CPU).  One export serves every check: the graph holds
one ``pq3d.zrun_conv`` node per routed conv, the artifact's logits are
bit-equal to the port's eager forward, and the eager forward is within
2e-2 of JAX's jitted one (bf16 conv operands, tests/test_torch_model.py's
tolerance).  Stage 2: tests/test_model_unified.py's model (mixed decoder,
ground and generation heads, 5 greedy tokens): tokens and ground logits
bit-equal across the round trip, tokens equal to JAX's; the same model
with ``early_exit`` exports its ``torch.while_loop`` decode, whose tokens
equal eager's, the fixed-length decode's and JAX's early-exit decode's.
The op itself:
``torch.library.opcheck``, and a train step's gradients through it against
the plain backward.  (The same on the card: tests/test_torch_card.py.)
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pq3d_tpu.models import query3d as jq3d
from pq3d_tpu.models.query3d import PROMPT_LOC, PROMPT_TXT
from pq3d_tpu_torch import export as tex
from pq3d_tpu_torch.models import query3d as tq3d
from pq3d_tpu_torch.ops import zrun_conv as tzr
from pq3d_tpu_torch.serve import to_device
from pq3d_tpu_torch.utils.weights import load_flax_variables

from test_export import _setup
from test_model_unified import B, L, Q, S, unified_model
from test_torch_model import _random_variables, _route_small, _spy_routed
from test_torch_pointnet import random_variables

torch.set_num_threads(1)
CPU = torch.device("cpu")
OUTS = ("predictions_class", "predictions_mask")


def _rel(ref, got):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.abs(ref - got).max() / (np.abs(ref).max() + 1e-12))


@pytest.fixture(scope="module")
def stage1():
    """JAX's export-test model and batch, the port's twin with its
    weights, the eager forward, and one export of it.  The weights are
    drawn with numpy in the shapes of ``_setup``'s init (non-trivial BN
    statistics), which is quicker than flax's initializers on the CPU."""
    with pytest.MonkeyPatch.context() as mp:
        init = jq3d.Query3DUnified.init
        mp.setattr(jq3d.Query3DUnified, "init",
                   lambda self, *a, **k: _random_variables(
                       lambda: init(self, *a, **k)))
        jm, variables, batch = _setup()
    ref_j = jax.jit(lambda b: jm.apply(variables, b, train=False))(batch)
    tm = tq3d.Query3DUnified(
        memories=("voxel", "mv", "pc"), heads=("mask",), hidden_size=32,
        dim_loc=3,
        unified=tq3d.UnifiedEncoderCfg(num_layers=1, num_blocks=1,
                                       num_attention_heads=4,
                                       structure="parallel",
                                       spatial_selfattn=True,
                                       use_self_mask=True),
        mv_enc=tq3d.EncoderCfg(16), pc_enc=tq3d.EncoderCfg(16),
        voxel_enc=tq3d.VoxelEncoderCfg(hlevels=(0, 1), out_channels=20,
                                       pallas_conv=True),
        mask_head_cfg=tq3d.MaskHeadCfg(21, (0, 2)))
    load_flax_variables(tm, jax.tree.map(np.asarray, variables))
    tm.eval()
    bt = to_device(batch, CPU)
    with pytest.MonkeyPatch.context() as mp:
        _route_small(mp, 128)
        with pytest.MonkeyPatch.context() as spy, torch.no_grad():
            routed = _spy_routed(spy, tm)
            eager = tm(bt)
        n_routed = len(routed)
        program = tex.export_program(tm, bt, outputs=OUTS)
    fn = tex.load_forward(tex.save_program(program))
    return {"ref_j": ref_j, "bt": bt, "eager": eager, "routed": n_routed,
            "program": program, "got": fn(bt)}


def test_stage1_graph_holds_one_op_per_routed_conv(stage1):
    assert stage1["routed"] >= 8
    assert tex.kernel_nodes(stage1["program"]) == stage1["routed"]
    assert tex.exported_platforms(stage1["program"]) == ("cpu",)


def test_stage1_round_trip_bit_equal_to_eager(stage1):
    got, eager = stage1["got"], stage1["eager"]
    assert set(got) == set(OUTS)          # ``outputs`` trims the dict
    assert len(got["predictions_class"]) == len(eager["predictions_class"])
    for key in OUTS:
        for g, e in zip(got[key], eager[key]):
            assert torch.equal(g, e), key


def test_stage1_eager_matches_jax(stage1):
    ref, eager = stage1["ref_j"], stage1["eager"]
    seg_valid = np.asarray(stage1["bt"]["seg_pad_masks"])[:, :, None]
    cj = np.asarray(ref["predictions_class"][-1])
    keep = np.ones(cj.shape[-1], bool)
    keep[[0, 2]] = False              # filtered classes are -1e9 on both
    assert _rel(cj[..., keep],
                eager["predictions_class"][-1].numpy()[..., keep]) <= 2e-2
    mj = np.asarray(ref["predictions_mask"][-1])
    valid = np.broadcast_to(seg_valid, mj.shape)
    assert _rel(mj[valid],
                eager["predictions_mask"][-1].numpy()[valid]) <= 2e-2


def _unified_batch():
    rng = np.random.default_rng(0)
    return {
        "query_locs": rng.standard_normal((B, Q, 6)).astype(np.float32),
        "query_pad_masks": np.ones((B, Q), bool),
        "seg_center": rng.standard_normal((B, S, 6)).astype(np.float32),
        "seg_pad_masks": np.ones((B, S), bool),
        "coord_min": np.full((B, 3), -1, np.float32),
        "coord_max": np.full((B, 3), 1, np.float32),
        "mv_seg_fts": rng.standard_normal((B, S, 16)).astype(np.float32),
        "mv_seg_pad_masks": np.ones((B, S), bool),
        "pc_seg_fts": rng.standard_normal((B, S, 16)).astype(np.float32),
        "pc_seg_pad_masks": np.ones((B, S), bool),
        "voxel_seg_fts": rng.standard_normal((B, S, 8)).astype(np.float32),
        "voxel_seg_pad_masks": np.ones((B, S), bool),
        "prompt": rng.integers(0, 64, (B, L)).astype(np.float32),
        "prompt_pad_masks": np.ones((B, L), bool),
        "prompt_type": np.array([PROMPT_TXT, PROMPT_TXT, PROMPT_LOC,
                                 PROMPT_TXT]),
    }


def test_stage2_round_trip_and_tokens_equal_jax():
    b = _unified_batch()
    jm = unified_model()
    bj = jax.tree.map(jnp.asarray, b)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, bj,
        train=False))
    variables = random_variables(shapes, 3)
    ref_j = jax.jit(lambda v, bb: jm.apply(v, bb, train=False))(
        variables, bj)
    tm = tq3d.Query3DUnified(
        memories=("mv", "pc", "voxel", "prompt"),
        heads=("ground", "generation"), hidden_size=32, dim_loc=6,
        use_offline_voxel_fts=True, skip_query_encoder_mask_pred=True,
        mask_head_cfg=None,
        unified=tq3d.UnifiedEncoderCfg(num_layers=2, num_blocks=1,
                                       num_attention_heads=4,
                                       structure="mixed",
                                       spatial_selfattn=True,
                                       memory_dropout=0.5),
        mv_enc=tq3d.EncoderCfg(16), pc_enc=tq3d.EncoderCfg(16),
        voxel_obj_enc=tq3d.EncoderCfg(8),
        ground_head_cfg=tq3d.GroundHeadCfg(hidden_size=16),
        generation_head_cfg=tq3d.GenerationHeadCfg(
            vocab_size=64, d_model=16, d_kv=4, d_ff=32, num_layers=2,
            num_heads=4, max_new_tokens=5),
        txt_cfg=tq3d.TxtEncoderCfg(vocab_size=64, width=16, layers=2,
                                   heads=2))
    load_flax_variables(tm, variables)
    tm.eval()
    bt = to_device(b, CPU)
    with torch.no_grad():
        eager = tm(bt)
    keys = ("ground_logits", "generation_tokens")
    blob = tex.export_forward(tm, bt, outputs=keys)
    assert tex.kernel_nodes(blob) == 0          # B1 is on no stage-2 path
    got = tex.load_forward(blob)(dict(bt, _meta={"ids": [1, 2, 3, 4]}))
    assert set(got) == set(keys)
    for k in keys:
        assert torch.equal(got[k], eager[k]), k
    np.testing.assert_array_equal(got["generation_tokens"].numpy(),
                                  np.asarray(ref_j["generation_tokens"]))
    # early_exit: the decode is one torch.while_loop, which the program
    # keeps as a loop; its tokens equal eager's, the fixed-length
    # decode's and JAX's early-exit decode's (finished rows emit PAD)
    te = copy.deepcopy(tm)
    te.generation_head.cfg = dataclasses.replace(te.generation_head.cfg,
                                                 early_exit=True)
    jee = jm.clone(generation_head_cfg=dataclasses.replace(
        jm.generation_head_cfg, early_exit=True))
    ref_ee = jax.jit(lambda v, bb: jee.apply(v, bb, train=False))(
        variables, bj)
    with torch.no_grad():
        eager_ee = te(bt)
    blob = tex.export_forward(te, bt, outputs=keys)
    assert tex.while_loop_nodes(blob) == 1
    got = tex.load_forward(blob)(bt)
    for k in keys:
        assert torch.equal(got[k], eager_ee[k]), k
    for toks in (eager["generation_tokens"],
                 torch.from_numpy(np.asarray(ref_ee["generation_tokens"]))):
        assert torch.equal(got["generation_tokens"], toks)


class _Head(torch.nn.Module):
    """A generation head as a forward over one batch dict."""

    def __init__(self, head):
        super().__init__()
        self.head = head

    def forward(self, batch):
        return {"tokens": self.head(batch["emb"], batch["valid"])}


def test_early_exit_export_stops_when_every_row_ends():
    """tests/test_torch_text_gen.py's generation head (12-token window,
    rows that emit EOS at steps 1, 3 and 8), exported with early_exit on
    those three rows, so the loop ends at step 9 of 12: the program's
    tokens equal eager's early-exit and fixed-length decodes and JAX's
    early-exit decode; every row ends with EOS and then PAD."""
    from test_torch_text_gen import _gen_pair
    jm, tm, variables, emb, valid, _ = _gen_pair(early_exit=True)
    rows = [0, 1, 2]
    emb, valid = emb[rows], valid[rows]
    ref = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(emb),
                                       jnp.asarray(valid)))
    batch = {"emb": torch.from_numpy(emb), "valid": torch.from_numpy(valid)}
    blob = tex.export_forward(_Head(tm), batch)
    assert tex.while_loop_nodes(blob) == 1
    got = tex.load_forward(blob)(batch)["tokens"]
    with torch.no_grad():
        eager = tm(batch["emb"], batch["valid"])
        fixed = copy.deepcopy(tm)
        fixed.cfg = dataclasses.replace(fixed.cfg, early_exit=False)
        fixed = fixed(batch["emb"], batch["valid"])
    for toks in (eager, fixed, torch.from_numpy(ref)):
        assert torch.equal(got, toks)
    ends = [int(np.flatnonzero(r == 1)[0]) for r in got.numpy()]
    assert max(ends) < got.shape[1] - 1, got
    for r, e in zip(got.numpy(), ends):
        assert (r[e + 1:] == 0).all()


def _op_inputs(n=256, cin=96, cout=128, seed=0):
    rng = np.random.default_rng(seed)
    nbr = rng.integers(-1, n, (n, 27)).astype(np.int32)
    nbr[:, 13] = np.arange(n)
    zb, zc = tzr.zrun_plan(torch.from_numpy(nbr))
    x = torch.from_numpy(rng.standard_normal((n, cin)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((27, cin, cout)) * 0.1)
                         .astype(np.float32))
    valid = torch.from_numpy(rng.random(n) < 0.8)
    return x, w, zb, zc, valid


@pytest.mark.parametrize("with_valid", [True, False])
def test_zrun_conv_op_check(with_valid):
    """opcheck: the schema, the fake (N, Cout) in x.dtype, the autograd
    registration and the traced op agree with the eager op."""
    x, w, zb, zc, valid = _op_inputs()
    v = valid if with_valid else None
    torch.library.opcheck(tex.ZRUN_CONV_OP, (x, w, zb, zc, v, "fwd"))
    torch.library.opcheck(
        tex.ZRUN_CONV_OP,
        (x.clone().requires_grad_(), w.clone().requires_grad_(), zb, zc, v,
         "fwd"))


def test_zrun_conv_op_gradient_equals_plain_backward():
    """A train step's gradients through the op: dx equals
    ``zrun_conv_backward_reference``'s, dW the plain re-gather's; the CPU
    launches no kernel."""
    x, w, zb, zc, valid = _op_inputs(seed=1)
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    before = dict(tzr.phase_launches)
    y = tzr.zrun_conv_sym(xg, wg, zb, zc, valid)
    dy = torch.from_numpy(np.random.default_rng(2).standard_normal(
        tuple(y.shape)).astype(np.float32))
    y.backward(dy)
    assert tzr.phase_launches == before
    dx, dw = tzr.zrun_conv_backward_reference(x, w, zb, zc, valid, dy)
    assert torch.equal(xg.grad, dx) and torch.equal(wg.grad, dw)
    with pytest.raises(ValueError, match="phase"):
        tzr.zrun_conv(x, w, zb, zc, valid, phase="sideways")
