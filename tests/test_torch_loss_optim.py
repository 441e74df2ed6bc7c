"""The port's set criterion and optimizer against the JAX package's:
``instseg_set_loss`` on the same numpy logits (same assignments, total and
parts within 1e-5 relative), and AdamW + clip + warmup_cosine against
optax on identical gradients (parameters within 1e-6 relative over three
steps, the same decayed set)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from pq3d_tpu.models import heads as jheads
from pq3d_tpu.ops import hungarian
from pq3d_tpu.optim import losses as jlosses
from pq3d_tpu.optim import optimizers as joptim
from pq3d_tpu_torch.models import heads as theads
from pq3d_tpu_torch.optim import losses as tlosses
from pq3d_tpu_torch.optim import optimizers as toptim
from pq3d_tpu_torch.utils.weights import torch_name
from test_torch_model import _batch, _models

torch.set_num_threads(1)


def _loss_inputs(seed=0, r=3, b=2, q=10, c=21, s=24, m=6):
    rng = np.random.default_rng(seed)
    cls = [rng.standard_normal((b, q, c)).astype(np.float32) * 2
           for _ in range(r)]
    for x in cls:
        x[..., [0, 2]] = -1e9                 # filtered classes
    msk = [rng.standard_normal((b, s, q)).astype(np.float32) * 3
           for _ in range(r)]
    n_inst = np.array([4, 6])
    inst_valid = np.arange(m)[None] < n_inst[:, None]
    labels = rng.integers(3, c - 1, (b, m)).astype(np.int32)
    labels[0, 1] = -100                       # an ignored target
    labels[~inst_valid] = 0
    seg_valid = np.arange(s)[None] < np.array([[20], [24]])
    tgt = (rng.random((b, m, s)) < 0.3) & inst_valid[..., None] \
        & seg_valid[:, None, :]
    batch = {"instance_labels": labels, "segment_masks": tgt,
             "instance_valid": inst_valid, "seg_pad_masks": seg_valid}
    return cls, msk, batch


def test_set_loss_matches_jax():
    cls, msk, batch = _loss_inputs()
    cfg_j = jlosses.InstSegLossConfig(num_classes=20)
    cfg_t = tlosses.InstSegLossConfig(num_classes=20)
    bj = {k: jnp.asarray(v) for k, v in batch.items()}
    bt = {k: torch.from_numpy(v) for k, v in batch.items()}
    total_j, parts_j = jlosses.instseg_set_loss(
        [jnp.asarray(x) for x in cls], [jnp.asarray(x) for x in msk], bj,
        cfg_j)
    ct = [torch.from_numpy(x) for x in cls]
    mt = [torch.from_numpy(x) for x in msk]
    total_t, parts_t = tlosses.instseg_set_loss(ct, mt, bt, cfg_t)

    # the same costs, and the same assignment of every real target
    costs_t = tlosses.round_costs(ct, mt, bt, cfg_t).numpy()
    costs_j = []
    for cl, mk in zip(cls, msk):
        c_cls = jlosses.batch_class_cost(jnp.asarray(cl),
                                         bj["instance_labels"])
        c_bce, c_dice = jlosses.batch_mask_cost(
            jnp.asarray(mk), bj["segment_masks"], bj["seg_pad_masks"])
        cost = 2 * c_cls + 5 * c_bce + 2 * c_dice
        cost = jnp.where(bj["instance_valid"][:, None, :], cost,
                         jlosses.PAD_COST)
        costs_j.append(np.asarray(jnp.swapaxes(cost, 1, 2)))
    costs_j = np.stack(costs_j)
    np.testing.assert_allclose(costs_t, costs_j, rtol=1e-5, atol=1e-5)
    col_j = np.asarray(hungarian.solve_batch(
        jnp.asarray(costs_j.reshape((-1,) + costs_j.shape[2:])))
    ).reshape(costs_j.shape[:3])
    col_t = tlosses.assign(costs_t)
    valid = np.broadcast_to(batch["instance_valid"], col_t.shape)
    np.testing.assert_array_equal(col_t[valid], col_j[valid])

    assert set(parts_t) == set(parts_j) and len(parts_t) == 9
    for k in parts_j:
        np.testing.assert_allclose(parts_t[k].item(), float(parts_j[k]),
                                   rtol=1e-5)
    np.testing.assert_allclose(total_t.item(), float(total_j), rtol=1e-5)


def test_schedule_lambdas_match_jax():
    for total, warm in ((12, 3), (12, 0), (7, 7)):
        sj = joptim.make_schedule("warmup_cosine", 1e-3, total, warm)
        ft = toptim.lr_lambda("warmup_cosine", total, warm)
        for step in range(15):
            # the JAX lambda runs in f32: 0.5 * (1 + cos) near its trough
            # cancels to f32 resolution of the multiplier (1e-7 * lr)
            np.testing.assert_allclose(1e-3 * ft(step), float(sj(step)),
                                       rtol=1e-6, atol=1e-10,
                                       err_msg=f"{total} {warm} {step}")


def _flax_names(model, params):
    """flax param path -> the port's parameter name (the weight mover's)."""
    return {tuple(p.key for p in path): torch_name(
                model, tuple(p.key for p in path), np.asarray(leaf))[0]
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


def test_decayed_set_matches_no_decay_mask():
    """The port's decay rule on its own parameter names selects exactly
    the parameters no_decay_mask selects, moved through the weight mover."""
    b = _batch()
    jm, tm = _models(num_layers=1, num_blocks=1)
    bj = jax.tree_util.tree_map(jnp.asarray, b)
    params = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, bj,
        train=False))["params"]
    names = _flax_names(tm, params)
    mask = jax.tree_util.tree_flatten_with_path(joptim.no_decay_mask(params))
    decay_j = {names[tuple(p.key for p in path)]
               for path, dec in mask[0] if dec}
    tparams = dict(tm.named_parameters())
    assert set(names.values()) == set(tparams)
    decay_t = {n for n, p in tparams.items() if toptim.decays(n, p)}
    assert decay_t == decay_j and len(decay_t) > 50
    groups = toptim.param_groups(tm, 0.01)
    assert sum(len(g["params"]) for g in groups) == len(tparams)


def test_adamw_clip_schedule_match_optax():
    """Three steps on identical gradients (the second one clipped) through
    the mask head's parameters: optax's clip + adamw + warmup_cosine
    against the port's AdamW + clip + LambdaLR."""
    hidden, feats = 32, 3
    jm = jheads.MaskHeadSegLevel(hidden, 21, num_memories=feats)
    tm = theads.MaskHeadSegLevel(hidden, 21, num_memories=feats)
    q = jnp.zeros((1, 4, hidden))
    seg = [(jnp.zeros((1, 6, hidden)), jnp.ones((1, 6), bool))] * feats
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), q, seg,
                                            jnp.ones((1, 6), bool)))
    rng = np.random.default_rng(4)
    params = jax.tree_util.tree_map(
        lambda l: rng.standard_normal(l.shape).astype(np.float32) * 0.1,
        shapes["params"])
    names = _flax_names(tm, params)
    tparams = dict(tm.named_parameters())
    paths = [tuple(p.key for p in path) for path, _ in
             jax.tree_util.tree_flatten_with_path(params)[0]]

    def to_torch(tree):
        for keys, leaf in zip(paths, jax.tree_util.tree_leaves(tree)):
            yield tparams[names[keys]], torch_name(tm, keys,
                                                   np.asarray(leaf))[1]

    for t, v in to_torch(params):
        with torch.no_grad():
            t.copy_(torch.from_numpy(np.array(v)))
    tx, _ = joptim.build_optimizer(params, "AdamW", lr=1e-3, total_steps=6,
                                   warmup_steps=1, grad_norm=5.0)
    state = tx.init(params)
    update = jax.jit(lambda g, s, p: tx.update(g, s, p))
    opt, sched = toptim.build_optimizer(tm, "AdamW", lr=1e-3, total_steps=6,
                                        warmup_steps=1)
    p_j = params
    for step, scale in enumerate((0.01, 1.0, 0.02)):
        g_j = jax.tree_util.tree_map(
            lambda l: rng.standard_normal(l.shape).astype(np.float32)
            * scale, params)
        upd, state = update(g_j, state, p_j)
        p_j = optax.apply_updates(p_j, upd)
        grads_t = []
        for t, g in to_torch(g_j):
            t.grad = torch.from_numpy(np.array(g))
            grads_t.append(t.grad)
        norm = toptim.global_norm(grads_t)
        ref = np.sqrt(sum((np.asarray(g, np.float64) ** 2).sum()
                          for g in jax.tree_util.tree_leaves(g_j)))
        np.testing.assert_allclose(norm.item(), ref, rtol=1e-6)
        assert (norm.item() > 5.0) == (step == 1)
        toptim.clip_by_global_norm_(grads_t, 5.0, norm)
        opt.step()
        sched.step()
    worst = 0.0
    for t, ref in to_torch(p_j):
        got = t.detach().numpy()
        worst = max(worst, float(np.abs(got - ref).max()
                                 / (np.abs(ref).max() + 1e-12)))
    assert worst <= 1e-6, worst


def test_unused_parameter_decays_like_optax():
    """A parameter the loss does not reach (the backbone's `final` layer)
    gets a zero gradient, so AdamW decays it as optax does."""
    from pq3d_tpu_torch.train.state import make_train_step
    w0 = np.random.default_rng(2).standard_normal((3, 4)).astype(np.float32)
    model = torch.nn.Module()
    model.used = torch.nn.Parameter(torch.ones(3))
    model.final = torch.nn.Linear(4, 3, bias=False)
    with torch.no_grad():
        model.final.weight.copy_(torch.from_numpy(w0))
    opt, sched = toptim.build_optimizer(model, lr=1e-2, total_steps=4)
    step = make_train_step(model, opt, sched,
                           lambda out, b: ((model.used ** 2).sum(), {}),
                           grad_norm_max=80.0)
    model.forward = lambda batch: None
    step({})
    tx = optax.adamw(1e-2, b1=0.9, b2=0.98, weight_decay=0.01)
    p = {"w": jnp.asarray(w0.T)}
    upd, _ = tx.update({"w": jnp.zeros_like(p["w"])}, tx.init(p), p)
    ref = np.asarray(optax.apply_updates(p, upd)["w"]).T
    np.testing.assert_allclose(model.final.weight.detach().numpy(), ref,
                               rtol=1e-6)
    assert not np.allclose(ref, w0)
