"""One stage-2 train step under the port's data parallelism on the CPU:
two gloo ranks (``python -m pq3d_tpu_torch.launch``) at a global batch of
6 items cycling through the three synthetic tasks, with the small widths
of ``tests/test_torch_unified_train.py`` (PointNet++ frozen, as the
sceneverse YAML freezes it; every dropout and memory dropout off;
``Loss(ground_loss x10, generation_loss)``): the two ranks end with
bit-identical gradients; against one process at the global batch the
loss parts within 1e-6 and every gradient within 1e-5 of its own largest
entry; against the JAX trainer's jitted step on a 2-device mesh from the
same weights the loss parts and gradient norm within 1e-5 (the
one-process comparison's tolerance) and every gradient within 1e-4 of
its own largest entry.  A gradient below 1e-6 of the step's largest is
f32 noise on an exact zero (the spatial attention's key bias) and is
held to that floor instead.
"""
import os
import pickle
import shutil

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ddp_worker as w
from pq3d_tpu.config import default_config_dir
from pq3d_tpu.config import load_config as jload
from pq3d_tpu.models import query3d as jq3d
from pq3d_tpu.optim.loss_aggregator import Loss as JLoss
from pq3d_tpu.parallel.mesh import MeshConfig, make_mesh, shard_batch
from pq3d_tpu.train.state import TrainState
from pq3d_tpu.train.state import make_train_step as jmake_train_step
from pq3d_tpu_torch.models import query3d as tq3d
from pq3d_tpu_torch.optim.loss_aggregator import Loss as TLoss
from pq3d_tpu_torch.utils.weights import load_flax_variables, torch_name
from test_torch_ddp import _capture_grads, _rel
from test_torch_pointnet import random_variables

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def stage2(tmp_path_factory):
    d = tmp_path_factory.mktemp("step2")
    tcfg = w.stage2_cfg()
    batch = w.stage2_batch(tcfg)
    with open(d / "batch.pkl", "wb") as f:
        pickle.dump(batch, f)
    jcfg = jload(os.path.join(default_config_dir(),
                              "unified_tasks_synthetic.yaml"),
                 overrides=w.STAGE2)
    jm = jq3d.build_model(jcfg)
    bj = jax.tree_util.tree_map(jnp.asarray, batch)
    variables = random_variables(jax.eval_shape(lambda: jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, bj,
        train=False)), 3)
    tm = tq3d.build_model(tcfg, device="cpu")
    load_flax_variables(tm, variables)
    torch.save(tm.state_dict(), d / "model.pt")
    ranks = w.spawn("step2", d)
    shutil.rmtree(d)            # the ranks' results are in memory
    one = w.train_step(tm, batch, TLoss(*w.STAGE2_LOSS))

    mp = pytest.MonkeyPatch()
    mp.setattr(fnn.Dropout, "__call__",
               lambda self, x, deterministic=None, rng=None: x)
    try:
        tx = _capture_grads()
        state = TrainState.create(variables, tx, jax.random.key(5))
        mesh = make_mesh(MeshConfig(data=2), devices=jax.devices()[:2])
        new_state, jmetrics = jmake_train_step(
            jm, tx, JLoss(*w.STAGE2_LOSS), donate=False)(
                state, shard_batch(bj, mesh))
    finally:
        mp.undo()
    ref = {"metrics": {k: float(v) for k, v in jmetrics.items()},
           "grads": jax.tree_util.tree_map(np.asarray, new_state.opt_state)}
    return ranks, one, ref, tm


def test_stage2_step_ranks_agree_bit_for_bit(stage2):
    (m0, g0, _), (m1, g1, _) = stage2[0]
    assert m0 == m1 and g0.keys() == g1.keys()
    assert all(torch.equal(g0[k], g1[k]) for k in g0)


def _check_grads(want, got, tol):
    top = max(np.abs(g).max() for g in want.values())
    checked = 0
    for k, g in want.items():
        if np.abs(g).max() <= 1e-6 * top:
            assert k not in got or np.abs(got[k]).max() <= 1e-6 * top, k
            continue
        assert _rel(g, got[k]) <= tol, (k, _rel(g, got[k]))
        checked += 1
    return checked


def test_stage2_step_matches_one_process_at_the_global_batch(stage2):
    (m, grads, _), (m1, grads1, _) = stage2[0][0], stage2[1]
    assert m.keys() == m1.keys()
    for k, v in m1.items():
        assert abs(m[k] - v) <= 1e-6 * abs(v), (k, m[k], v)
    assert grads.keys() == grads1.keys()
    assert _check_grads({k: g.numpy() for k, g in grads1.items()},
                        {k: g.numpy() for k, g in grads.items()},
                        1e-5) > 50


def test_stage2_step_matches_jax_on_a_two_device_mesh(stage2):
    (m, grads, _), ref, tm = stage2[0][0], stage2[2], stage2[3]
    for k in ("loss", "ground_loss", "generation_loss", "grad_norm"):
        want = ref["metrics"][k]
        assert abs(m[k] - want) <= 1e-5 * abs(want), (k, m[k], want)
    want = {}
    for path, g in jax.tree_util.tree_flatten_with_path(ref["grads"])[0]:
        name, g = torch_name(tm, tuple(p.key for p in path), g)
        want[name] = g
    got = {k: v.numpy() for k, v in grads.items()}
    assert _check_grads(want, got, 1e-4) > 50
