"""The import of HF and reference PQ3D weights (pq3d_tpu_torch/utils/
hf_import.py) against the JAX package's importer, on the CPU, with no file
to download: the HF models are built from configs in code, the reference
state_dicts from models in code (tools/torch_reference_names.py).

- ``import_t5_decoder`` / ``import_clip_text_tower``: the port's tree, and
  JAX's moved through ``load_flax_variables``, give the same tensors bit
  for bit; the port's tower forward matches HF's within 1e-5 of the scale.
- ``import_query3d`` on small stage-1 and stage-2 models (the in-proj
  split, FFN and spatial attention, the heads, the U-Net's ME kernels and
  BN statistics, PointNet++, the location encoders, the HF towers, DDP's
  ``module.`` prefix and the ``layers`` alias, a shape mismatch and an
  unused key): the port's model equals JAX's import moved through
  ``load_flax_variables`` bit for bit, and the two reports are equal.
- The trainer's warm start from a ``.bin`` file and from a directory of
  ``pytorch_model*.bin``; ``python -m pq3d_tpu_torch.run ...
  pretrain_ckpt_path=<dir>`` trains; one forward of the warm-started
  model against JAX's at the model tolerance (2e-2).
"""
import copy
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pq3d_tpu.utils import hf_import as jhf
from pq3d_tpu_torch import run as trun
from pq3d_tpu_torch.config import load_config
from pq3d_tpu_torch.models.clip_text import CLIPTextTower
from pq3d_tpu_torch.models.t5 import T5Decoder
from pq3d_tpu_torch.serve import to_device
from pq3d_tpu_torch.train import checkpoints as tckpt
from pq3d_tpu_torch.utils import hf_import as thf
from pq3d_tpu_torch.utils.weights import flax_leaves, load_flax_variables

from test_torch_model import TOL, _batch, _models, _random_variables, _rel
from test_torch_trainer import TINY

transformers = pytest.importorskip("transformers")

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
from torch_reference_names import reference_state_dict  # noqa: E402

CPU = torch.device("cpu")
STAGE1_MEMORIES = ("voxel", "mv", "pc")


def _hf_t5(seed=0, layers=2, d_model=32, d_kv=8, d_ff=64, heads=4,
           vocab=100):
    from transformers import T5Config, T5ForConditionalGeneration
    cfg = T5Config(d_model=d_model, d_kv=d_kv, d_ff=d_ff, num_layers=layers,
                   num_heads=heads, vocab_size=vocab,
                   decoder_start_token_id=0, dropout_rate=0.0,
                   pad_token_id=0, eos_token_id=1, tie_word_embeddings=True)
    torch.manual_seed(seed)
    return T5ForConditionalGeneration(cfg).eval()


def _hf_clip(seed=0, layers=2, width=32, heads=4, vocab=100, inter=128,
             proj=32, positions=16):
    from transformers import CLIPTextConfig, CLIPTextModelWithProjection
    cfg = CLIPTextConfig(hidden_size=width, intermediate_size=inter,
                         num_hidden_layers=layers, num_attention_heads=heads,
                         vocab_size=vocab, projection_dim=proj,
                         max_position_embeddings=positions,
                         hidden_act="quick_gelu", attention_dropout=0.0)
    torch.manual_seed(seed)
    return CLIPTextModelWithProjection(cfg).eval()


def _same_tensors(a: torch.nn.Module, b: torch.nn.Module):
    sa, sb = a.state_dict(), b.state_dict()
    assert set(sa) == set(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def test_t5_import_matches_jax_and_hf():
    hf = _hf_t5()
    sd = hf.state_dict()
    mine, via_jax = (T5Decoder(vocab_size=100, d_model=32, d_kv=8, d_ff=64,
                               num_layers=2, heads=4, dropout=0.0).eval()
                     for _ in range(2))
    load_flax_variables(mine, {"params": thf.import_t5_decoder(sd, 2)})
    load_flax_variables(via_jax, {"params": jhf.import_t5_decoder(sd, 2)})
    _same_tensors(mine, via_jax)
    rng = np.random.default_rng(0)
    enc = rng.standard_normal((2, 5, 32)).astype(np.float32)
    enc_mask = np.ones((2, 5), bool)
    enc_mask[1, 3:] = False
    dec_in = rng.integers(1, 100, (2, 7))
    with torch.no_grad():
        ref = hf(encoder_outputs=[torch.tensor(enc)],
                 attention_mask=torch.tensor(enc_mask),
                 decoder_input_ids=torch.tensor(dec_in)).logits.numpy()
        got = mine(torch.tensor(dec_in), torch.tensor(enc),
                   torch.tensor(enc_mask)).numpy()
    assert _rel(ref, got) <= 1e-5


def test_clip_import_matches_jax_and_hf():
    hf = _hf_clip()
    sd = hf.state_dict()
    # the port's tower, as the configs use it: MLP width 4x, projection
    # width x width
    mine, via_jax = (CLIPTextTower(vocab_size=100, width=32, heads=4,
                                   layers=2, max_positions=16).eval()
                     for _ in range(2))
    load_flax_variables(mine, {"params": thf.import_clip_text_tower(sd, 2)})
    load_flax_variables(via_jax,
                        {"params": jhf.import_clip_text_tower(sd, 2)})
    _same_tensors(mine, via_jax)
    rng = np.random.default_rng(0)
    ids = torch.tensor(rng.integers(0, 100, (2, 9)))
    mask = torch.ones(2, 9, dtype=torch.bool)
    with torch.no_grad():
        out = hf(ids, attention_mask=mask)
        ref = (out.last_hidden_state @ hf.text_projection.weight.T).numpy()
        got = mine(ids, mask).numpy()
    assert _rel(ref, got) <= 1e-5


def _jax_import(sd, variables, memories, **kw):
    """JAX's import of ``sd`` into (params, batch_stats), with the other
    collections of ``variables`` kept."""
    new, report = jhf.import_query3d(
        {k: v.numpy() for k, v in sd.items()},
        {c: variables[c] for c in ("params", "batch_stats")
         if c in variables}, memories=memories, **kw)
    return {**variables, **new}, report


def _check_import(tm, variables, sd, memories, **kw):
    """Port import of ``sd`` into ``tm`` (loaded with ``variables``) against
    JAX's import moved by load_flax_variables: the same tensors and the
    same report.  Returns (the port's report, the JAX-imported tree)."""
    load_flax_variables(tm, variables)
    got = thf.import_query3d(sd, tm, memories=memories, **kw)
    new, want = _jax_import(sd, variables, memories, **kw)
    ref = copy.deepcopy(tm)
    load_flax_variables(ref, new)
    _same_tensors(tm, ref)
    assert got == want
    return got, new


@pytest.fixture(scope="module")
def stage1():
    """The small stage-1 pair of tests/test_torch_model.py, JAX's initial
    weights, and a second port model with other weights that names the
    reference state_dict."""
    b = _batch()
    jm, tm = _models(num_layers=2, num_blocks=1)
    bj = jax.tree_util.tree_map(jnp.asarray, b)
    init = lambda: jm.init(  # noqa: E731
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, bj,
        train=False)
    variables = _random_variables(init, seed=1)
    source = copy.deepcopy(tm)
    load_flax_variables(source, _random_variables(init, seed=2))
    return jm, tm, variables, source, b


def test_import_query3d_stage1(stage1):
    jm, tm, variables, source, _ = stage1
    sd = reference_state_dict(source, STAGE1_MEMORIES, module_every=2,
                              layers_alias=True)
    keys = set(thf.canonical_state_dict(sd))
    assert any(".layers." in k for k in sd)
    for k in ("unified_encoder.unified_encoder.0.cross_attn_list.0."
              "multihead_attn.in_proj_weight",
              "unified_encoder.unified_encoder.1.self_attn.self_attn.w_qs."
              "weight",
              "unified_encoder.unified_encoder.0.ffn.linear1.weight",
              "mask_head.cls_head.0.weight",
              "mask_head.mask_pred_list.0.k_proj.weight",
              "voxel_encoder.backbone.conv0p1s1.kernel",
              "voxel_encoder.backbone.conv2p2s2.kernel",
              "voxel_encoder.backbone.block3.0.downsample.0.kernel",
              "voxel_encoder.backbone.convtr6p4s2.kernel",
              "voxel_encoder.backbone.bntr7.running_var",
              "voxel_encoder.feat_proj_list.1.0.weight",
              "voxel_encoder.backbone.final.kernel"):
        assert k in keys, k
    assert any(k.startswith("module.") for k in sd)
    # a key nothing reads and a tensor of the wrong shape
    sd["voxel_encoder.backbone.conv9p1s1.kernel"] = torch.zeros(3)
    sd["mask_head.cls_head.4.bias"] = torch.zeros(7)
    tm = copy.deepcopy(tm)
    report, _ = _check_import(tm, variables, sd, STAGE1_MEMORIES)
    assert report["unused"] == ["voxel_encoder.backbone.conv9p1s1.kernel"]
    assert report["mismatched"] == [("mask_head/cls_head/Dense_1/bias",
                                     (21,), (7,))]
    assert not report["missing"]
    # every leaf but the mismatched one holds the source's value
    n = sum(1 for c, _, _ in flax_leaves(tm)
            if c in ("params", "batch_stats"))
    assert len(report["loaded"]) == n - 1


def test_import_query3d_partial_dicts(stage1):
    """test_full_import.py's hand-written dicts: the in-proj split, FFN,
    spatial attention and the mask head, the U-Net's stem and first BN
    with its statistics; the rest reported missing, equal to JAX's."""
    _, tm, variables, _, _ = stage1
    rng = np.random.default_rng(0)
    h, ff = 32, 2048

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))
    j = STAGE1_MEMORIES.index("mv")
    base = f"unified_encoder.layers.0.cross_attn_list.{j}.multihead_attn"
    w = t(3 * h, h)
    sd = {f"{base}.in_proj_weight": w, f"{base}.in_proj_bias": t(3 * h),
          f"{base}.out_proj.weight": t(h, h), f"{base}.out_proj.bias": t(h),
          "unified_encoder.layers.0.ffn.linear1.weight": t(ff, h),
          "unified_encoder.layers.0.ffn.linear1.bias": t(ff),
          "unified_encoder.layers.0.self_attn.self_attn.w_qs.weight":
              t(h, h),
          "unified_encoder.layers.0.self_attn.norm.weight": t(h),
          "mask_head.cls_head.0.weight": t(h, h),
          "mask_head.mask_pred_list.0.k_proj.weight": t(h, h),
          "module.voxel_encoder.backbone.conv0p1s1.kernel": t(125, 3, 32),
          "voxel_encoder.backbone.bn0.weight": t(32),
          "voxel_encoder.backbone.bn0.running_mean": t(32),
          "voxel_encoder.backbone.bn0.running_var": t(32).abs()}
    tm = copy.deepcopy(tm)
    report, _ = _check_import(tm, variables, sd, STAGE1_MEMORIES)
    assert not report["unused"] and not report["mismatched"]
    attn = tm.unified_encoder.layer0.cross_attns_mv.MultiHeadAttention_0
    assert torch.equal(attn.k_proj.weight, w[h:2 * h])
    assert "params:unified_encoder/layer1/ffn/Dense_0/kernel" in \
        report["missing"]


def test_import_query3d_stage2():
    """The stage-2 model of tests/test_torch_unified.py: PointNet++'s
    shared MLPs and BatchNorm2d, the coord and box encoders, the ground
    head, the generation head's input projection, and the HF towers under
    txt_encoder.model. (CLIP) and generation_head.model. (T5)."""
    from test_torch_pointnet import random_variables
    from test_torch_unified import (FEATURE_DIMS, PIPE, _models as
                                    _unified_models, _requests)
    from pq3d_tpu.data import unified_pipeline as jup
    jm, tm = _unified_models()
    pipe = jup.UnifiedPipelineConfig(**PIPE)
    rng = np.random.default_rng(0)
    batch = jup.collate_unified(
        [jup.process_item(s, l, pipe, rng, False, FEATURE_DIMS)
         for s, l in _requests(3)], pipe, FEATURE_DIMS, train=False)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        jax.tree.map(jnp.asarray, batch), train=False))
    variables = random_variables(shapes, 3)
    source = copy.deepcopy(tm)
    load_flax_variables(source, random_variables(shapes, 4))
    memories = ("mv", "pc", "voxel", "prompt")
    sd = reference_state_dict(source, memories, module_every=3)
    keys = set(thf.canonical_state_dict(sd))
    for k in ("pc_encoder.backbone.sa1.mlp_module.layer0.conv.weight",
              "pc_encoder.backbone.sa2.mlp_module.layer1.normlayer.bn."
              "running_mean",
              "coord_encoder.0.weight", "box_encoder.1.bias",
              "ground_head.og3d_head.4.weight",
              "generation_head.input_proj.0.weight"):
        assert k in keys, k
    clip = _hf_clip(seed=1, layers=1, width=32, heads=4, vocab=200,
                    inter=128, proj=32, positions=77)
    t5 = _hf_t5(seed=2, layers=1, d_model=32, d_kv=8, d_ff=64, heads=4,
                vocab=100)
    sd.update({f"txt_encoder.model.{k}": v
               for k, v in clip.state_dict().items()})
    sd.update({f"module.generation_head.model.{k}": v
               for k, v in t5.state_dict().items()})
    tm = copy.deepcopy(tm)
    report, _ = _check_import(tm, variables, sd, memories)
    assert "txt_encoder/tower/block0/attn/q_proj/kernel" in report["loaded"]
    assert "generation_head/decoder/block0/self_attn/relative_attention_" \
        "bias/embedding" in report["loaded"]
    assert not report["mismatched"] and not report["missing"]
    # HF keys no port module has (position ids, T5's encoder) are unused
    assert all(k.startswith(("txt_encoder.model.",
                             "generation_head.model."))
               for k in report["unused"])
    tower = copy.deepcopy(tm.txt_encoder.tower)
    load_flax_variables(tower, {"params": thf.import_clip_text_tower(
        clip.state_dict(), 1)})
    _same_tensors(tm.txt_encoder.tower, tower)


def _stage1_trainer(tmp_path, pretrain, name="run"):
    cfg = load_config("instseg_sceneverse",
                      [*TINY, f"exp_dir={tmp_path / name}",
                       f"pretrain_ckpt_path={pretrain}"])
    trainer = trun.build_instseg_trainer(cfg)
    trainer._lazy_init()
    return trainer


@pytest.mark.parametrize("layout", ["file", "dir"])
def test_trainer_warm_start_from_reference_weights(tmp_path, layout,
                                                   capsys):
    """A source model's weights under reference names, in one .bin file or
    split over two pytorch_model-*.bin files, warm-start the trainer's
    model: the four counts printed, every params / batch_stats leaf
    loaded, each tensor equal to the source's."""
    source = _stage1_trainer(tmp_path, "", "source").model
    memories = tuple(load_config("instseg_sceneverse")["model"]["memories"])
    sd = reference_state_dict(source, memories, module_every=2)
    keys = sorted(sd)
    if layout == "file":
        path = str(tmp_path / "weights.bin")
        torch.save(sd, path)
    else:
        path = str(tmp_path / "ref")
        os.makedirs(path)
        half = len(keys) // 2
        for i, part in enumerate((keys[:half], keys[half:])):
            torch.save({k: sd[k] for k in part}, os.path.join(
                path, f"pytorch_model-0000{i + 1}-of-00002.bin"))
    assert tckpt.reference_weights(path)
    capsys.readouterr()
    trainer = _stage1_trainer(tmp_path, path)
    out = capsys.readouterr().out
    report = trainer.warm_start_report
    n = sum(1 for c, _, _ in flax_leaves(trainer.model)
            if c in ("params", "batch_stats"))
    assert len(report["loaded"]) == n == len(trainer.warm_started)
    assert not (report["missing"] or report["mismatched"]
                or report["unused"])
    assert (f"{n} loaded, 0 missing, 0 mismatched, 0 unused") in out
    got, want = trainer.model.state_dict(), source.state_dict()
    for k in want:
        if not k.endswith("gauss_B"):
            assert torch.equal(got[k], want[k]), k
    trainer._close_loaders()


def test_run_warm_starts_from_a_reference_dir(tmp_path):
    """``python -m pq3d_tpu_torch.run ... pretrain_ckpt_path=<dir with
    pytorch_model.bin>`` warm-starts and trains 2 steps."""
    source = _stage1_trainer(tmp_path, "", "source").model
    memories = tuple(load_config("instseg_sceneverse")["model"]["memories"])
    ref = tmp_path / "ref"
    ref.mkdir()
    torch.save(reference_state_dict(source, memories),
               str(ref / "pytorch_model.bin"))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "pq3d_tpu_torch.run", "--config-name",
         "instseg_sceneverse", *TINY, "solver.epochs=1",
         "solver.epochs_per_eval=0", f"exp_dir={tmp_path / 'run'}",
         f"pretrain_ckpt_path={ref}"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "warm start from 1 torch file(s):" in proc.stdout
    assert " 0 missing, 0 mismatched, 0 unused" in proc.stdout
    assert '"train"' in open(tmp_path / "run" / "metrics.jsonl").read()


def test_warm_started_forward_matches_jax(stage1):
    """One forward of the port model warm-started from a reference dict
    against JAX's model warm-started by JAX's importer from the same dict,
    at the model tolerance."""
    jm, tm, variables, source, b = stage1
    sd = reference_state_dict(source, STAGE1_MEMORIES, module_every=2)
    tm = copy.deepcopy(tm)
    load_flax_variables(tm, variables)
    thf.import_query3d(sd, tm, memories=STAGE1_MEMORIES)
    new, _ = _jax_import(sd, variables, STAGE1_MEMORIES)
    bj = jax.tree_util.tree_map(jnp.asarray, b)
    out_j = jax.jit(lambda v: jm.apply(v, bj, train=False))(new)
    tm.eval()
    with torch.inference_mode():
        out_t = tm(to_device(b, CPU))
    seg_valid = b["seg_pad_masks"][:, :, None]
    for r in range(len(out_j["predictions_class"])):
        cj = np.asarray(out_j["predictions_class"][r])[..., 3:]
        ct = out_t["predictions_class"][r].numpy()[..., 3:]
        mj = np.asarray(out_j["predictions_mask"][r])
        valid = np.broadcast_to(seg_valid, mj.shape)
        assert _rel(cj, ct) <= TOL, r
        assert _rel(mj[valid],
                    out_t["predictions_mask"][r].numpy()[valid]) <= TOL, r
