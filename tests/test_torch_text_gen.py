"""The port's CLIP text encoder (pq3d_tpu_torch/models/clip_text.py), T5
decoder (models/t5.py) and generation head (models/generation.py) against
the JAX modules with the same weights, moved one-to-one by
utils/weights.load_flax_variables, on the same seeded inputs.

- CLIP at 2 layers, width 32: max|diff| / max|ref| <= 1e-5;
- relative_position_bucket exact for every distance 0..300;
- teacher-forced T5 logits through the head: rel <= 1e-5;
- greedy tokens exact, with and without early exit, with rows that emit
  EOS early (PAD after it) and rows that never do."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from pq3d_tpu.models import clip_text as jclip
from pq3d_tpu.models import t5 as jt5
from pq3d_tpu.models.generation import T5GenerationHead as JGenHead
from pq3d_tpu.models.query3d import GenerationHeadCfg as JGenCfg
from pq3d_tpu_torch.models import clip_text as tclip
from pq3d_tpu_torch.models import t5 as tt5
from pq3d_tpu_torch.models.generation import T5GenerationHead as TGenHead
from pq3d_tpu_torch.models.query3d import GenerationHeadCfg as TGenCfg
from pq3d_tpu_torch.utils.weights import load_flax_variables
from test_torch_pointnet import random_variables

torch.set_num_threads(1)
TOL = 1e-5
GEN = dict(vocab_size=50, d_model=32, d_kv=8, d_ff=64, num_layers=2,
           num_heads=4, max_new_tokens=12)


def _rel(ref, got):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert ref.shape == got.shape
    return float(np.abs(ref - got).max() / np.abs(ref).max())


def test_clip_text_encoder():
    rng = np.random.default_rng(0)
    b, L = 3, 10
    ids = rng.integers(0, 100, (b, L)).astype(np.int32)
    valid = np.arange(L)[None] < np.array([[10], [6], [1]])
    kw = dict(vocab_size=100, width=32, tower_heads=4, tower_layers=2)
    jm = jclip.CLIPTextEncoder(output_dim=24, dropout=0.0, **kw)
    tm = tclip.CLIPTextEncoder(output_dim=24, dropout=0.0, **kw)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.asarray(ids), jnp.asarray(valid)))
    variables = random_variables(shapes, 1)
    load_flax_variables(tm, variables)
    ref = jax.jit(jm.apply)(variables, jnp.asarray(ids), jnp.asarray(valid))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(ids).long(),
                        torch.from_numpy(valid))
    assert _rel(ref, got.numpy()) <= TOL
    x = np.linspace(-4, 4, 17, dtype=np.float32)
    np.testing.assert_allclose(
        tclip.quick_gelu(torch.from_numpy(x)).numpy(),
        np.asarray(jclip.quick_gelu(jnp.asarray(x))), rtol=1e-6, atol=1e-7)


def test_relative_position_bucket_exact():
    rel = np.arange(-300, 1, dtype=np.int32)[None, :]
    for nb, md in ((32, 128), (16, 64)):
        ref = np.asarray(jt5.relative_position_bucket(jnp.asarray(rel), nb,
                                                      md))
        got = tt5.relative_position_bucket(torch.from_numpy(rel), nb, md)
        np.testing.assert_array_equal(got.numpy(), ref)


def _gen_pair(early_exit=False, seed=2):
    rng = np.random.default_rng(seed)
    b, q, h = 4, 7, 24
    emb = rng.standard_normal((b, q, h)).astype(np.float32)
    valid = np.arange(q)[None] < np.array([[7], [5], [3], [6]])
    labels = rng.integers(2, GEN["vocab_size"], (b, 9)).astype(np.int32)
    labels[0, 4:] = 0                      # a padded response
    labels[1, 6] = tt5.T5_EOS_ID
    labels[1, 7:] = 0
    jm = JGenHead(cfg=JGenCfg(early_exit=early_exit, **GEN))
    tm = TGenHead(h, TGenCfg(early_exit=early_exit, **GEN))
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.asarray(emb), jnp.asarray(valid),
        labels=jnp.asarray(labels)))
    variables = random_variables(shapes, seed)
    # a small embedding (the blocks, not the fed-back token, decide the
    # next one) and EOS likelier than the rest: rows finish at steps 1, 3
    # and 8 of 12, and one runs the whole window
    emb_tab = variables["params"]["decoder"]["embed"]["embedding"]
    emb_tab *= 0.1
    emb_tab[tt5.T5_EOS_ID] *= 3.0
    load_flax_variables(tm, variables)
    return jm, tm.eval(), variables, emb, valid, labels


def test_t5_teacher_forced_logits():
    jm, tm, variables, emb, valid, labels = _gen_pair()
    ref = jax.jit(lambda v, e, m, l: jm.apply(v, e, m, labels=l))(
        variables, jnp.asarray(emb), jnp.asarray(valid),
        jnp.asarray(labels))
    with torch.no_grad():
        got = tm(torch.from_numpy(emb), torch.from_numpy(valid),
                 labels=torch.from_numpy(labels))
    assert got.shape == (4, 9, GEN["vocab_size"])
    assert _rel(ref, got.numpy()) <= TOL


def test_t5_greedy_tokens_exact():
    toks = {}
    for early in (False, True):
        jm, tm, variables, emb, valid, _ = _gen_pair(early_exit=early)
        ref = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(emb),
                                           jnp.asarray(valid)))
        with torch.no_grad():
            got = tm(torch.from_numpy(emb), torch.from_numpy(valid)).numpy()
        np.testing.assert_array_equal(got, ref)
        assert got.dtype == np.int32
        toks[early] = got
    np.testing.assert_array_equal(toks[True], toks[False])
    got = toks[False]
    # EOS freeze: only PAD after the first EOS; some rows end early,
    # some run the whole window
    ended = []
    for row in got:
        eos = np.flatnonzero(row == tt5.T5_EOS_ID)
        if len(eos):
            assert (row[eos[0] + 1:] == tt5.T5_PAD_ID).all()
        ended.append(len(eos) > 0)
    assert any(ended) and not all(ended), got
