"""The stage-2 serving variants against the JAX package on the CPU:

- two-phase decode: ``two_phase`` returns ``generation_enc`` /
  ``generation_enc_mask``, and ``decode_states`` over them gives exactly
  the one-phase tokens and JAX's ``generation.decode_states`` tokens;
- the bf16 serving cast: ``cast_model_bf16`` + ``cast_batch_bf16``
  against JAX's ``cast_params_bf16`` + ``cast_batch_bf16`` forward with
  tests/test_bf16_modes.py's gate (ground and answer logits within 0.1 of
  the f32 scale, the top-1 object equal where the f32 top-2 margin
  exceeds 0.03 of it), JAX's f32 islands at the same places (the prompt
  memory and everything after the prompt cross-attention in f32), and
  the cast's dtype rules (``JaxPromotion``, ``cast_batch_bf16``);
- ``UnifiedServer`` with ``cast``, ``flat_obj`` and ``two_phase``: every
  answer equal to the port's own forward of the same batches (f32 setups
  also to JAX's ``UnifiedServer``); ``InstSegServer`` with ``cast`` serves
  the logits of the cast stage-1 model's forward on the cast batch."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pq3d_tpu.data import unified_datasets as jds
from pq3d_tpu.data import unified_pipeline as jup
from pq3d_tpu.models.generation import decode_states as jdecode_states
from pq3d_tpu.serve import UnifiedServer as JUnifiedServer
from pq3d_tpu.utils.inference import cast_batch_bf16 as jcast_batch
from pq3d_tpu.utils.inference import cast_params_bf16
from pq3d_tpu_torch.data import unified_datasets as tds
from pq3d_tpu_torch.data import unified_pipeline as tup
from pq3d_tpu_torch.serve import InstSegServer, UnifiedServer, to_device
from pq3d_tpu_torch.utils.inference import (JaxPromotion, cast_batch_bf16,
                                            cast_model_bf16)
from test_torch_unified import FEATURE_DIMS, PIPE, _requests
from test_torch_unified_variants import moved_pair, variant_batch

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _two_phase(tm):
    head = tm.generation_head
    head.cfg = dataclasses.replace(head.cfg, two_phase=True)
    return tm


def test_two_phase_tokens_equal_one_phase_and_jax():
    batch = variant_batch("qa")
    jm, tm, variables = moved_pair("qa", batch)
    with torch.no_grad():
        one = tm(to_device(batch, CPU))
        out = _two_phase(tm)(to_device(batch, CPU))
        assert "generation_tokens" not in out
        toks = tm.decode_states(out["generation_enc"],
                                out["generation_enc_mask"])
    assert out["generation_enc"].shape[-1] == tm.generation_head.cfg.d_model
    torch.testing.assert_close(out["generation_enc_mask"],
                               to_device(batch, CPU)["query_pad_masks"])
    np.testing.assert_array_equal(toks.numpy(),
                                  one["generation_tokens"].numpy())
    ref = jdecode_states(variables, jnp.asarray(out["generation_enc"]),
                         jnp.asarray(batch["query_pad_masks"]),
                         dataclasses.replace(jm.generation_head_cfg,
                                             two_phase=True))
    np.testing.assert_array_equal(toks.numpy(), np.asarray(ref))


def bf16_gate(ref32, got, valid=None):
    """tests/test_bf16_modes.py's gate: within 0.1 of the f32 scale, and
    the same top-1 where the f32 top-2 margin exceeds 0.03 of it."""
    r = np.asarray(ref32, np.float32)
    g = np.asarray(got, np.float32)
    if valid is not None:
        r = np.where(valid, r, -1e9)
        g = np.where(valid, g, -1e9)
        scale = np.abs(r[valid]).max() + 1e-6
        err = np.abs(r - g)[valid].max()
    else:
        scale = np.abs(r).max() + 1e-6
        err = np.abs(r - g).max()
    srt = np.sort(r, -1)
    decided = (srt[..., -1] - srt[..., -2]) / scale > 0.03
    return err / scale, (r.argmax(-1) == g.argmax(-1))[decided].all()


def test_bf16_cast_matches_jax_bf16():
    batch = variant_batch("qa")
    jm, tm, variables = moved_pair("qa", batch)
    jb = jax.tree.map(jnp.asarray, batch)
    fwd = jax.jit(lambda v, b: jm.apply(v, b, train=False))
    ref32 = fwd(variables, jb)
    ref = fwd(cast_params_bf16(variables), jcast_batch(jb))
    cast_model_bf16(tm)
    assert all(p.dtype == torch.bfloat16 for p in tm.parameters())
    assert all(b.dtype == torch.bfloat16 for b in tm.buffers()
               if b.is_floating_point())
    seen = {}
    tm.unified_encoder.layer0.register_forward_hook(
        lambda m, a, o: seen.__setitem__("query", o.dtype))
    tm.txt_encoder.register_forward_hook(
        lambda m, a, o: seen.__setitem__("prompt", o.dtype))
    tm.mv_encoder.register_forward_hook(
        lambda m, a, o: seen.__setitem__("mv", o.dtype))
    with torch.no_grad():
        got = tm(cast_batch_bf16(to_device(batch, CPU)))
    # JAX's islands: the text encoder's projection reads the tower's f32
    # output, so the prompt memory, and the query after the prompt
    # cross-attention, are f32; the scene memories stay bf16
    assert seen == {"prompt": torch.float32, "query": torch.float32,
                    "mv": torch.bfloat16}
    valid = batch["query_pad_masks"]
    for k, v in (("ground_logits", valid), ("answer_scores", None)):
        assert str(got[k].dtype).endswith(str(ref[k].dtype)), k
        for r in (ref32[k], ref[k]):
            err, top1 = bf16_gate(r, got[k].float().numpy(), v)
            assert err < 0.1 and top1, (k, err)


def test_jax_promotion_and_batch_cast():
    a = torch.randn(2, 3)
    lin = torch.nn.Linear(3, 4).bfloat16()
    with pytest.raises(RuntimeError):
        lin(a)
    with JaxPromotion():
        assert lin(a).dtype == torch.float32
        assert lin(a.bfloat16()).dtype == torch.bfloat16
        assert F.layer_norm(a, (3,), torch.ones(3).bfloat16()).dtype == \
            torch.float32
        assert torch.einsum("ij,kj->ik", a, a.bfloat16()).dtype == \
            torch.float32
        assert (a.bfloat16() @ a.T).dtype == torch.float32
    b = cast_batch_bf16({"x": a, "i": torch.arange(3), "m": a > 0,
                         "maps": {"y": a.double(), "z": a}})
    assert (b["x"].dtype, b["i"].dtype, b["m"].dtype) == (
        torch.bfloat16, torch.int64, torch.bool)
    assert (b["maps"]["y"].dtype, b["maps"]["z"].dtype) == (
        torch.float64, torch.bfloat16)


def _direct(tm, reqs, pipe, bs, cast=None):
    """The port model's own answers for ``reqs`` in batches of ``bs``, the
    last padded by repeating, items from one rng as the server's."""
    rng = np.random.default_rng(0)
    items = [{k: v for k, v in tup.process_item(
        s, l, pipe, rng, False, FEATURE_DIMS).items()
        if not k.startswith("meta_")} for s, l in reqs]
    out = []
    for i in range(0, len(items), bs):
        chunk = items[i:i + bs]
        chunk += [chunk[-1]] * (bs - len(chunk))
        b = tup.collate_unified(chunk, pipe, FEATURE_DIMS, train=False)
        b = to_device({k: v for k, v in b.items()
                       if k not in ("obj_fts", "response")}, CPU)
        if cast is not None:
            b = cast(b)
        with torch.no_grad():
            o = tm(b)
            toks = o["generation_tokens"] if "generation_tokens" in o \
                else tm.decode_states(o["generation_enc"],
                                      o["generation_enc_mask"])
        for r in range(min(bs, len(reqs) - i)):
            out.append((o["ground_logits"][r].float().numpy(),
                        toks[r].numpy()))
    return out


SETUPS = {"two_phase": (False, True, False), "flat_obj": (False, False, True),
          "bf16": (True, False, False), "two_bf16": (True, True, False),
          "flat_bf16": (True, False, True)}


@pytest.mark.parametrize("setup", list(SETUPS))
def test_unified_server_variants(setup):
    bf16, two, flat = SETUPS[setup]
    batch = variant_batch("qa")
    jm, tm, variables = moved_pair("qa", batch)
    if two:
        _two_phase(tm)
    if bf16:
        cast_model_bf16(tm)
    kw = dict(PIPE, flat_obj=flat, flat_obj_bucket=4)
    reqs = _requests(5, seed=1)
    srv = UnifiedServer(tm, tup.UnifiedPipelineConfig(**kw), batch_size=2,
                        feature_dims=FEATURE_DIMS, max_delay_s=0.2,
                        detokenize=tds.detokenize, device="cpu",
                        cast=cast_batch_bf16 if bf16 else None)
    try:
        got = [f.result(timeout=300) for f in [srv.submit(r) for r in reqs]]
    finally:
        srv.close()
    want = _direct(tm, reqs, tup.UnifiedPipelineConfig(**kw), 2,
                   cast_batch_bf16 if bf16 else None)
    for g, (scores, toks) in zip(got, want):
        valid = np.isfinite(g["ground_scores"])
        np.testing.assert_array_equal(g["ground_scores"][valid],
                                      scores[valid])
        assert g["ground_obj"] == int(np.argmax(np.where(valid, scores,
                                                         -np.inf)))
        np.testing.assert_array_equal(g["generation_tokens"], toks)
        assert g["generation"] == tds.detokenize(toks.tolist())
    if bf16:
        return
    if two:
        jm = jm.clone(generation_head_cfg=dataclasses.replace(
            jm.generation_head_cfg, two_phase=True))
    jsrv = JUnifiedServer(jm, variables, jup.UnifiedPipelineConfig(**kw),
                          batch_size=2, feature_dims=FEATURE_DIMS,
                          max_delay_s=0.2, detokenize=jds.detokenize)
    try:
        ref = [f.result(timeout=300) for f in
               [jsrv.submit(r) for r in reqs]]
    finally:
        jsrv.close()
    for g, r in zip(got, ref):
        assert g["ground_obj"] == r["ground_obj"]
        np.testing.assert_array_equal(g["generation_tokens"],
                                      r["generation_tokens"])


def test_inst_seg_server_serves_the_cast():
    """InstSegServer(cast=cast_batch_bf16) in front of a stage-1 model cast
    by cast_model_bf16 serves the logits of that model's forward on the
    cast batch, to the bit."""
    from pq3d_tpu_torch.data import instseg_pipeline as tpipe
    from pq3d_tpu_torch.data import synthetic as tsyn
    from pq3d_tpu_torch.models.query3d import init_weights
    from test_torch_model import _models
    _, tm = _models(num_layers=1, num_blocks=1)
    init_weights(tm, torch.Generator().manual_seed(0))
    model = cast_model_bf16(tm.eval())
    pipe = tpipe.InstSegPipelineConfig(
        voxel_size=0.15, num_queries=8, max_segments=32, max_instances=8,
        voxel_bucket=128, use_aug=False, stem_mode="dense_block",
        level_caps=[512, 256, 128, 128, 128])
    rng = np.random.default_rng(0)
    scenes = [tsyn.make_scene(rng, n_points=n, n_instances=3, n_segments=16)
              for n in (600, 900)]
    for sc in scenes:
        sc["inst_labels"] = np.minimum(sc["inst_labels"], 19)
    served = []

    class Recording(InstSegServer):
        def _forward(self, batch):
            out = super()._forward(batch)
            served.append(out)
            return out
    srv = Recording(model, pipe, batch_size=2, num_classes=20,
                    max_delay_s=1.0, extra_features={"mv": 16, "pc": 16},
                    device="cpu", cast=cast_batch_bf16)
    try:
        results = [f.result(timeout=300) for f in
                   [srv.submit(sc) for sc in scenes]]
    finally:
        srv.close()
    assert len(served) == 1 and all(isinstance(r, list) for r in results)
    r2 = np.random.default_rng(0)
    b = tpipe.collate_processed([tpipe.process_scene(sc, pipe, r2)
                                 for sc in scenes], pipe)
    b.pop("_meta")
    for name in ("mv", "pc"):
        b[f"{name}_seg_fts"] = np.zeros((2, 32, 16), np.float32)
        b[f"{name}_seg_pad_masks"] = b["seg_pad_masks"]
    with torch.inference_mode():
        out = model(cast_batch_bf16(to_device(b, torch.device("cpu"))))
    for got, key in zip(served[0], ("predictions_class",
                                    "predictions_mask")):
        assert got.dtype == out[key][-1].dtype
        assert torch.equal(got, out[key][-1]), key


def test_bf16_sampling_picks_equal_jax():
    """Under the cast, PointNet++'s FPS and ball query take their
    distances of bf16 points (differenced, squared and summed in f32,
    rounded back once, as XLA's fused expression): the same picks as
    JAX's on bf16 clouds."""
    from pq3d_tpu.ops import sampling as js
    from pq3d_tpu_torch.ops import sampling as ts
    rng = np.random.default_rng(3)
    xyz = rng.standard_normal((3, 96, 3)).astype(np.float32)
    jx = jnp.asarray(xyz).astype(jnp.bfloat16)
    tx = torch.from_numpy(xyz).bfloat16()
    picks = ts.furthest_point_sample_batched(tx, 16)
    np.testing.assert_array_equal(
        picks.numpy(), np.asarray(js.furthest_point_sample_batched(jx, 16)))
    centers = ts.gather_centers_batched(tx, picks)
    np.testing.assert_array_equal(
        ts.ball_query_batched(tx, centers, 0.5, 8).numpy(),
        np.asarray(js.ball_query_batched(
            jx, js.gather_centers_batched(jx, jnp.asarray(picks.numpy())),
            0.5, 8)))
