"""The non-mask decoder ``QueryEncoder`` and the FFN's ``activation``
option, each against the JAX package's module on the CPU at small widths,
with the same weights (moved by ``utils/weights.load_flax_variables``):

- ``FFNLayer(activation=)`` with relu, gelu (``jax.nn.gelu``'s tanh
  approximation) and glu (the hidden width halved), and a
  ``QueryEncoderLayer`` with gelu;
- ``QueryEncoder`` in eval mode: ``sequential`` with a memory left out by
  ``drop_memories_test`` (zeroed, feature and position), ``mixed`` with
  the voxel memory as a list of per-layer levels and spatial
  self-attention, and ``parallel`` with ``drop_memories_test``;
- train-mode memory dropout against a numpy transcription of its draws
  under a seeded generator (one uniform draw a sample and scene memory,
  the memories in order), and the train-mode forward (every dropout
  module at 0) against the eval forward on the transcribed inputs.

Gate: max|diff| / max|ref| <= 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pq3d_tpu.models import layers as jlayers
from pq3d_tpu.models import query_encoder as jqe
from pq3d_tpu_torch.models import layers as tlayers
from pq3d_tpu_torch.models import query_encoder as tqe
from pq3d_tpu_torch.utils.weights import load_flax_variables
from test_torch_pointnet import random_variables

torch.set_num_threads(1)
GATE = 1e-5
B, Q, D, HEADS = 2, 5, 16, 4


def _rel(ref, got):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert ref.shape == got.shape
    return float(np.abs(ref - got).max() / np.abs(ref).max())


def _inputs(memories, seed, voxel_levels=0):
    """Memories name -> (feat, attend mask, pos) as numpy (the prompt
    without a position); the voxel feature a list of ``voxel_levels``
    arrays when set."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    out = {"query": (f32(B, Q, D), rng.random((B, Q)) < 0.8, f32(B, Q, D))}
    for m in memories:
        n = 4 if m == "prompt" else 7
        feat = f32(B, n, D)
        if m == "voxel" and voxel_levels:
            feat = [f32(B, n, D) for _ in range(voxel_levels)]
        mask = rng.random((B, n)) < 0.7
        mask[:, 0] = True
        out[m] = (feat, mask, None if m == "prompt" else f32(B, n, D))
    return out


def _jax(x):
    return jax.tree.map(jnp.asarray, x)


def _torch(inputs):
    def conv(x):
        if x is None:
            return None
        if isinstance(x, list):
            return [torch.from_numpy(v) for v in x]
        return torch.from_numpy(x)
    return {k: tuple(conv(x) for x in v) for k, v in inputs.items()}


@pytest.mark.parametrize("activation", ["relu", "gelu", "glu"])
def test_ffn_activation_matches_jax(activation):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, Q, D)).astype(np.float32)
    jl = jlayers.FFNLayer(D, 32, activation=activation)
    shapes = jax.eval_shape(lambda: jl.init(jax.random.key(0),
                                            jnp.asarray(x)))
    variables = random_variables(shapes, 2)
    tl = tlayers.FFNLayer(D, 32, activation=activation).eval()
    load_flax_variables(tl, variables)
    ref = jl.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tl(torch.from_numpy(x))
    assert _rel(ref, got.numpy()) <= GATE


def test_query_encoder_layer_activation_matches_jax():
    mems = ("mv", "pc", "prompt")
    inputs = _inputs(mems, 3)
    jl = jqe.QueryEncoderLayer(D, HEADS, mems, structure="mixed",
                               activation="gelu")
    jin = _jax(inputs)
    q0 = jin["query"][0]
    shapes = jax.eval_shape(lambda: jl.init(jax.random.key(0), q0, jin))
    variables = random_variables(shapes, 4)
    tl = tqe.QueryEncoderLayer(D, HEADS, mems, structure="mixed",
                               activation="gelu").eval()
    load_flax_variables(tl, variables)
    tin = _torch(inputs)
    with torch.no_grad():
        got = tl(tin["query"][0], tin)
    assert _rel(jl.apply(variables, q0, jin), got.numpy()) <= GATE


ENCODERS = {
    "sequential_drop": dict(memories=("mv", "pc", "prompt"),
                            structure="sequential",
                            drop_memories_test=("pc",)),
    "mixed_voxel_levels": dict(memories=("voxel", "mv", "prompt"),
                               structure="mixed", spatial_selfattn=True),
    "parallel_drop": dict(memories=("voxel", "mv", "pc"),
                          structure="parallel",
                          drop_memories_test=("mv",)),
}


def _pair(kw, seed, layers=2):
    """The JAX encoder, its random variables, the port's with them."""
    voxel_levels = layers if kw.get("spatial_selfattn") else 0
    inputs = _inputs(kw["memories"], seed, voxel_levels)
    rng = np.random.default_rng(seed + 1)
    locs = rng.standard_normal((B, Q, Q, 5)).astype(np.float32)
    je = jqe.QueryEncoder(D, HEADS, layers, **kw)
    jin = _jax(inputs)
    shapes = jax.eval_shape(lambda: je.init(jax.random.key(0), jin,
                                            jnp.asarray(locs)))
    variables = random_variables(shapes, seed + 2)
    te = tqe.QueryEncoder(D, HEADS, layers, **kw)
    load_flax_variables(te, variables)
    return je, variables, te, inputs, locs


@pytest.mark.parametrize("case", sorted(ENCODERS))
def test_query_encoder_matches_jax(case):
    je, variables, te, inputs, locs = _pair(ENCODERS[case], 5)
    ref, rc, rm = je.apply(variables, _jax(inputs), jnp.asarray(locs))
    te.eval()
    with torch.no_grad():
        got, gc, gm = te(_torch(inputs), torch.from_numpy(locs))
    assert (rc, rm, gc, gm) == ([], [], [], [])
    assert _rel(ref, got.numpy()) <= GATE


def _dropped_numpy(inputs, memories, u, p):
    """The memory dropout transcribed: scene memory m of sample b zeroed,
    feature and position, where its draw ``u[m][b] < p``."""
    out = dict(inputs)
    for m in memories:
        if m == "prompt":
            continue
        feat, mask, pos = inputs[m]
        keep = (u[m] >= p)[:, None, None].astype(np.float32)
        out[m] = (feat * keep, mask, pos * keep)
    return out


def test_memory_dropout_matches_numpy_transcription():
    kw = dict(memories=("voxel", "mv", "pc", "prompt"),
              structure="sequential", memory_dropout=0.5)
    inputs = _inputs(kw["memories"], 7)
    te = tqe.QueryEncoder(D, HEADS, 2, **kw)
    with pytest.raises(RuntimeError, match="set_memory_generator"):
        te.train()(_torch(inputs))
    gen = torch.Generator().manual_seed(11)
    draws = torch.Generator().manual_seed(11)
    u = {m: torch.rand((B,), generator=draws).numpy()
         for m in kw["memories"] if m != "prompt"}
    assert any((v < 0.5).any() for v in u.values())
    assert any((v >= 0.5).any() for v in u.values())
    want = _dropped_numpy(inputs, kw["memories"], u, 0.5)
    te.set_memory_generator(gen)
    for mod in te.modules():
        if isinstance(mod, torch.nn.Dropout):
            mod.p = 0.0
    got_in = te.drop_memories(_torch(inputs))
    for m in kw["memories"]:
        for g, w in zip(got_in[m], want[m]):
            if w is not None:
                np.testing.assert_array_equal(g.numpy(), w)
    # the train-mode forward against the eval forward on those inputs
    gen.manual_seed(11)
    with torch.no_grad():
        got, _, _ = te(_torch(inputs))
        te.eval()
        ref, _, _ = te(_torch(want))
    assert _rel(ref.numpy(), got.numpy()) <= GATE
