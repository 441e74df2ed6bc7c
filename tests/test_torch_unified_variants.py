"""The stage-2 model options this slice ports, each against the JAX
package's model on the CPU at small widths, with the same weights (moved
by utils/weights.load_flax_variables) and the same batch of 6 requests
(every synthetic dataset twice: TXT and LOC prompts):

- ``qa``: the answer classifier over the valid queries' mean;
- ``gate``: the gated decoder structure;
- ``bert``: ``BERTLanguageEncoder`` as the text encoder;
- ``attention``: the text encoder's self-attention projection;
- ``image``: IMAGE prompts through the lazily built ``img_encoder``, on
  two rows, with and without ``prompt_img_masks``;
- ``txt_unprojected`` / ``txt_trainable``: the text encoder's
  ``use_projection: False`` / ``freeze_backbone: False``;
- ``gen_unprojected``: the generation head's ``use_projection: False``;
- ``tower_bf16``: the CLIP tower's ``compute_dtype: bfloat16``.

Gate: ``ground_logits`` (valid rows), teacher-forced
``generation_logits`` and ``answer_scores`` within max|diff| / max|ref|
<= 1e-4 (the bf16 tower: 1e-2; the port rounds each bf16 op where XLA
does, but XLA's and torch's bf16 exp and softmax differ in the last bit),
greedy tokens equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pq3d_tpu.models import query3d as jq3d
from pq3d_tpu_torch.data import unified_pipeline as tup
from pq3d_tpu_torch.models import query3d as tq3d
from pq3d_tpu_torch.serve import to_device
from pq3d_tpu_torch.utils.weights import load_flax_variables
from test_torch_pointnet import random_variables
from test_torch_unified import FEATURE_DIMS, PIPE, _rel, _requests

torch.set_num_threads(1)
TOL = 1e-4
VARIANTS = ("qa", "gate", "bert", "attention", "image", "txt_unprojected",
            "txt_trainable", "gen_unprojected", "tower_bf16")
HIDDEN = 48
N_ANSWERS = 5
D_IMG = 24


def _options(variant):
    """(common kwargs, JAX-only kwargs, port-only kwargs) of the pair."""
    heads = ("ground", "generation") + (("qa",) if variant == "qa" else ())
    gen = dict(vocab_size=100, d_model=32, d_kv=8, d_ff=64, num_layers=1,
               num_heads=4, max_new_tokens=4)
    if variant == "gen_unprojected":
        gen.update(d_model=HIDDEN, d_kv=12, use_projection=False)
    txt = dict(vocab_size=200, width=HIDDEN, layers=1, heads=4)
    txt.update({"bert": dict(kind="bert", layers=2),
                "attention": dict(projection_type="attention",
                                  num_projection_layers=2),
                "txt_unprojected": dict(use_projection=False),
                "txt_trainable": dict(freeze_backbone=False),
                "tower_bf16": dict(compute_dtype="bfloat16")}.get(variant,
                                                                  {}))
    kw = dict(memories=("mv", "pc", "voxel", "prompt"), heads=heads,
              hidden_size=HIDDEN, dim_loc=6, use_offline_voxel_fts=True,
              qa_num_answers=N_ANSWERS)
    structure = "gate" if variant == "gate" else "mixed"
    return kw, gen, txt, structure


def make_pair(variant):
    """The JAX model and the port's with the same options."""
    kw, gen, txt, structure = _options(variant)
    jm = jq3d.Query3DUnified(
        skip_query_encoder_mask_pred=True, mask_head_cfg=None,
        unified=jq3d.UnifiedEncoderCfg(num_layers=1, num_blocks=1,
                                       num_attention_heads=4,
                                       structure=structure),
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
                                       structure=structure),
        mv_enc=tq3d.EncoderCfg(32),
        pc_enc=tq3d.EncoderCfg(backbone="pointnet++", freeze_backbone=True),
        voxel_obj_enc=tq3d.EncoderCfg(16),
        ground_head_cfg=tq3d.GroundHeadCfg(hidden_size=32),
        generation_head_cfg=tq3d.GenerationHeadCfg(**gen),
        txt_cfg=tq3d.TxtEncoderCfg(**txt), **kw)
    return jm, tm


def variant_batch(variant, n=6, seed=0):
    pipe = tup.UnifiedPipelineConfig(**PIPE)
    rng = np.random.default_rng(seed)
    items = [tup.process_item(s, l, pipe, rng, False, FEATURE_DIMS)
             for s, l in _requests(n)]
    batch = tup.collate_unified(items, pipe, FEATURE_DIMS, train=False)
    batch.pop("obj_fts")
    if variant == "image":
        r = np.random.default_rng(seed + 1)
        L = PIPE["prompt_len"]
        batch["prompt_img_fts"] = r.standard_normal(
            (n, L, D_IMG)).astype(np.float32)
        batch["prompt_type"] = batch["prompt_type"].copy()
        batch["prompt_type"][[0, 3]] = tup.PROMPT_IMAGE
    return batch


def moved_pair(variant, batch, seed=3):
    """(JAX model, port model in eval mode, flax variables) with the same
    random weights."""
    jm, tm = make_pair(variant)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        jax.tree.map(jnp.asarray, batch), train=False))
    variables = random_variables(shapes, seed)
    load_flax_variables(tm, variables)
    assert len(jax.tree_util.tree_leaves(variables)) == len(tm.state_dict())
    return jm, tm.eval(), variables


def _compare(jm, tm, variables, batch, tol):
    ref = jax.jit(lambda v, b: jm.apply(v, b, train=False))(
        variables, jax.tree.map(jnp.asarray, batch))
    with torch.no_grad():
        got = tm(to_device(batch, torch.device("cpu")))
    valid = batch["query_pad_masks"]
    assert _rel(np.asarray(ref["ground_logits"])[valid],
                got["ground_logits"].numpy()[valid]) <= tol
    assert _rel(ref["generation_logits"],
                got["generation_logits"].numpy()) <= tol
    np.testing.assert_array_equal(got["generation_tokens"].numpy(),
                                  np.asarray(ref["generation_tokens"]))
    assert set(got) - {"query"} == set(ref) - {"query"}
    if "answer_scores" in ref:
        assert got["answer_scores"].shape == (len(valid), N_ANSWERS)
        assert _rel(ref["answer_scores"],
                    got["answer_scores"].numpy()) <= tol
        assert got["qa_logits"] is got["answer_scores"]
    return ref, got


@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_matches_jax(variant):
    batch = variant_batch(variant)
    jm, tm, variables = moved_pair(variant, batch)
    _compare(jm, tm, variables, batch,
             1e-2 if variant == "tower_bf16" else TOL)
    if variant == "tower_bf16":
        tower = tm.txt_encoder.tower
        assert tower.block0.attn.dtype == torch.bfloat16
        assert tower.block0.fc1.weight.dtype == torch.float32
    if variant == "image":
        # the prompt rows of type IMAGE read img_encoder, the others not
        assert tm.img_encoder.input_feat_proj.in_features == D_IMG
        masked = dict(batch, prompt_img_masks=np.arange(
            PIPE["prompt_len"])[None].repeat(6, 0) < 5)
        _compare(jm, tm, variables, masked, TOL)


def test_image_encoder_is_built_at_the_first_image_batch():
    """Without a tree that holds it, the first image batch creates
    ``img_encoder`` at its feature width (random weights, eval mode, the
    model's dtype); later batches reuse it; a batch without image
    features never reads it."""
    _, tm = make_pair("image")
    tm.eval()
    plain = variant_batch("qa")
    with torch.no_grad():
        a = tm(to_device(plain, torch.device("cpu")))["ground_logits"]
    assert not hasattr(tm, "img_encoder")
    img = variant_batch("image")
    with torch.no_grad():
        tm(to_device(img, torch.device("cpu")))
    enc = tm.img_encoder
    assert enc.input_feat_proj.weight.shape == (HIDDEN, D_IMG)
    assert not enc.training and enc.drop.p == 0.0
    with torch.no_grad():
        tm(to_device(img, torch.device("cpu")))
        b = tm(to_device(plain, torch.device("cpu")))["ground_logits"]
    assert tm.img_encoder is enc
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_gate_layer_matches_jax():
    """One ``gate`` decoder layer alone, train-mode memory list included:
    the gated update reads every scene memory, also one that
    ``drop_memories_test`` leaves out of the other structures."""
    from pq3d_tpu.models.query_encoder import QueryEncoderLayer as JLayer
    from pq3d_tpu_torch.models.query_encoder import QueryEncoderLayer
    rng = np.random.default_rng(0)
    b, q, d = 2, 5, 16
    mems = ("mv", "voxel", "prompt")
    inputs = {"query": (rng.standard_normal((b, q, d)),
                        rng.random((b, q)) < 0.8,
                        rng.standard_normal((b, q, d)))}
    for m in mems:
        n = 7 if m != "prompt" else 4
        inputs[m] = (rng.standard_normal((b, n, d)),
                     rng.random((b, n)) < 0.7,
                     None if m == "prompt" else rng.standard_normal(
                         (b, n, d)))
    f32 = lambda x: None if x is None else (  # noqa: E731
        x.astype(np.float32) if x.dtype == np.float64 else x)
    inputs = {k: tuple(f32(x) for x in v) for k, v in inputs.items()}
    jl = JLayer(d, 4, mems, spatial_selfattn=False, structure="gate",
                drop_memories_test=("voxel",))
    jin = jax.tree.map(jnp.asarray, inputs)
    q0 = jin["query"][0]
    shapes = jax.eval_shape(lambda: jl.init(jax.random.key(0), q0, jin))
    variables = random_variables(shapes, 1)
    tl = QueryEncoderLayer(d, 4, mems, spatial_selfattn=False,
                           structure="gate", drop_memories_test=("voxel",))
    load_flax_variables(tl, variables)
    tl.eval()
    ref = jl.apply(variables, q0, jin)
    tin = {k: tuple(None if x is None else torch.from_numpy(x) for x in v)
           for k, v in inputs.items()}
    with torch.no_grad():
        got = tl(tin["query"][0], tin)
    assert _rel(ref, got.numpy()) <= 1e-5
