"""The port's assignment solver (``pq3d_tpu_torch/ops/hungarian.py``)
against the JAX package's on-device solver (``pq3d_tpu/ops/hungarian.py``)
on the CPU, where ``solve_batch`` runs its plain version.

The plain version repeats JAX's f32 arithmetic in JAX's order, so its
``col4row`` must equal JAX's exactly on every row: padded rows and tied
columns included, not only an assignment of equal cost.  The cost of the
real rows is held to scipy's within 1e-5 relative (f32 sums in another
order).  The set loss's assignment is held to JAX's ``solve_batch`` on the
same costs in every round.  The CUDA kernel is held to the plain version
in tests/test_torch_card.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from pq3d_tpu.ops import hungarian as jh
from pq3d_tpu_torch.ops import hungarian as th
from pq3d_tpu_torch.optim import losses as tlosses

torch.set_num_threads(1)


def _port(cost):
    return th.solve_batch(torch.from_numpy(np.ascontiguousarray(
        cost, np.float32))).numpy()


def _jax(cost):
    return np.asarray(jh.solve_batch(jnp.asarray(cost, jnp.float32)))


@pytest.mark.parametrize("shape", [(5, 5), (7, 12), (1, 4), (30, 120)])
def test_plain_solve_equals_jax(shape):
    rng = np.random.default_rng(sum(shape))
    for _ in range(5):
        c = (rng.standard_normal(shape) * 10).astype(np.float32)
        got = th.solve(torch.from_numpy(c))
        assert got.dtype == torch.int32 and got.shape == (shape[0],)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jh.solve(jnp.asarray(c))))


@pytest.mark.parametrize("kind", ["padded", "all_tied", "tied_columns",
                                  "integers"])
def test_plain_solve_equals_jax_on_ties(kind):
    """Constant padded rows (tests/test_ops.py's case), an all-zero matrix,
    rows constant along the columns (a round of identical queries) and
    small integer costs with many ties: every row equal to JAX's."""
    rng = np.random.default_rng(3)
    if kind == "padded":
        c = rng.standard_normal((4, 10)).astype(np.float32)
        c = np.concatenate([c, np.full((3, 10), 5.0, np.float32)])
    elif kind == "all_tied":
        c = np.zeros((12, 12), np.float32)
    elif kind == "tied_columns":
        c = np.repeat(rng.standard_normal((9, 1)), 14, 1).astype(np.float32)
    else:
        c = rng.integers(0, 3, (16, 20)).astype(np.float32)
    np.testing.assert_array_equal(_port(c[None])[0],
                                  np.asarray(jh.solve(jnp.asarray(c))))


def test_batched_lanes_equal_jax_vmap():
    """Lanes that need very different numbers of Dijkstra steps (random,
    all tied, padded rows, a 1-row problem padded out) run in lockstep
    under a done mask: each lane equals jax.vmap's, and the step counts
    differ."""
    rng = np.random.default_rng(5)
    r, n = 24, 30
    lanes = [rng.standard_normal((r, n)) * 10,
             np.zeros((r, n)),
             np.repeat(rng.standard_normal((r, 1)), n, 1),
             np.concatenate([rng.standard_normal((6, n)),
                             np.full((r - 6, n), tlosses.PAD_COST)]),
             rng.integers(0, 2, (r, n)),
             np.concatenate([rng.standard_normal((1, n)),
                             np.full((r - 1, n), 1.0)])]
    c = np.stack(lanes).astype(np.float32)
    steps = torch.zeros(len(lanes), dtype=torch.int32)
    got = th.solve_batch(torch.from_numpy(c), steps)
    np.testing.assert_array_equal(got.numpy(), _jax(c))
    # a tied lane scans every assigned column before a free one
    assert steps[1].item() == r * (r + 1) // 2
    assert len(set(steps.tolist())) >= 4
    for lane in range(len(lanes)):
        one = torch.zeros(1, dtype=torch.int32)
        th.solve_batch(torch.from_numpy(c[lane:lane + 1]), one)
        assert one.item() == steps[lane].item()


@pytest.mark.parametrize("real", [1, 17, 100])
def test_real_rows_cost_equals_scipy(real):
    """120 x 120 lanes with ``real`` real rows and the rest at PAD_COST,
    as the set loss builds them: the real rows' cost equals scipy's on
    the real rows alone within 1e-5 relative, every lane a valid
    permutation."""
    rng = np.random.default_rng(real)
    c = rng.standard_normal((3, 120, 120)).astype(np.float32) * 3
    c[:, real:] = tlosses.PAD_COST
    got = _port(c)
    oracle = th.solve_scipy(torch.from_numpy(c)).numpy()
    assert oracle.dtype == np.int32
    for lane in range(3):
        assert len(set(got[lane].tolist())) == 120
        ours = c[lane, np.arange(real), got[lane, :real]].sum(dtype=np.float64)
        ref = c[lane, np.arange(real), oracle[lane, :real]].sum(
            dtype=np.float64)
        assert abs(ours - ref) <= 1e-5 * abs(ref)


def _set_loss_inputs():
    """Predictions and a batch at tests/test_torch_trainer.py's shapes
    (B = 2 scenes, Q = 8 queries, M = 8 targets, S = 32 segments, 21
    classes, 5 rounds: 2 layers x 2 blocks and the final one), random from a
    seed; round 0's queries are identical, as the decoder's all-zero
    initial query makes them, so every query column of round 0 ties."""
    rng = np.random.default_rng(11)
    b, q, m, s, c, rounds = 2, 8, 8, 32, 21, 5
    cls = [rng.standard_normal((b, q, c)).astype(np.float32)
           for _ in range(rounds)]
    msk = [rng.standard_normal((b, s, q)).astype(np.float32) * 2
           for _ in range(rounds)]
    cls[0][:] = cls[0][:, :1]
    msk[0][:] = msk[0][:, :, :1]
    inst_valid = np.zeros((b, m), bool)
    inst_valid[0, :3] = inst_valid[1, :5] = True
    seg_valid = np.zeros((b, s), bool)
    seg_valid[0, :20] = seg_valid[1, :27] = True
    batch = {"instance_labels": np.where(inst_valid, rng.integers(
                 0, 20, (b, m)), 0).astype(np.int32),
             "segment_masks": (rng.random((b, m, s)) < 0.3) & inst_valid[
                 ..., None] & seg_valid[:, None],
             "instance_valid": inst_valid, "seg_pad_masks": seg_valid}
    return cls, msk, batch


def test_set_loss_assignment_equals_jax(monkeypatch):
    """``instseg_set_loss`` matches with ``hungarian.solve_batch`` (the
    plain solver here): its assignment equals JAX's ``solve_batch`` on the
    same costs on every row of every round, round 0's ties included, and
    ``match_layer`` gives the same as the set loss for each round."""
    cls, msk, nb = _set_loss_inputs()
    batch = {k: torch.from_numpy(v) for k, v in nb.items()}
    cfg = tlosses.InstSegLossConfig(num_classes=20)
    seen = []
    orig = th.solve_batch
    monkeypatch.setattr(th, "solve_batch", lambda cost: seen.append(
        (cost.clone(), orig(cost))) or seen[-1][1])
    total, parts = tlosses.instseg_set_loss(
        [torch.from_numpy(x) for x in cls],
        [torch.from_numpy(x) for x in msk], batch, cfg)
    assert len(seen) == 1 and np.isfinite(total.item()) and len(parts) == 15
    cost, col = seen[0]
    assert cost.shape == (5 * 2, 8, 8)
    # round 0's real rows: every query column ties
    c0 = cost[:2].numpy()
    assert all(np.ptp(c0[i, nb["instance_valid"][i]], axis=1).max() == 0
               for i in range(2))
    np.testing.assert_array_equal(col.numpy(), _jax(cost.numpy()))
    for r in range(5):
        got = tlosses.match_layer(
            torch.from_numpy(cls[r]), torch.from_numpy(msk[r]),
            batch["instance_labels"], batch["segment_masks"],
            batch["instance_valid"], batch["seg_pad_masks"], cfg)
        assert got.dtype == torch.long
        np.testing.assert_array_equal(got.numpy(),
                                      col.numpy()[2 * r:2 * r + 2])
    # the oracle: the same cost of the real targets in every round
    costs = cost.numpy().reshape(5, 2, 8, 8)
    oracle = tlosses.assign(costs)
    for r in range(5):
        for i in range(2):
            v = nb["instance_valid"][i]
            ours = costs[r, i][v][np.arange(v.sum()),
                                  col.numpy()[2 * r + i][v]].sum()
            ref = costs[r, i][v][np.arange(v.sum()), oracle[r, i][v]].sum()
            assert abs(ours - ref) <= 1e-5 * abs(ref)


@pytest.mark.parametrize("bad", ["rows_over_cols", "float64", "int",
                                 "strided", "too_wide", "not_3d",
                                 "steps_dtype"])
def test_refusals(bad):
    """R > N, a dtype other than f32, a non-contiguous cost, more than
    MAX_COLS columns, a cost of the wrong rank and a wrong ``steps``
    raise, on the CPU as on the card."""
    c = torch.zeros(2, 4, 6)
    steps = None
    if bad == "rows_over_cols":
        c = torch.zeros(2, 7, 6)
    elif bad == "float64":
        c = c.double()
    elif bad == "int":
        c = c.int()
    elif bad == "strided":
        c = torch.zeros(2, 6, 4).transpose(1, 2)
    elif bad == "too_wide":
        c = torch.zeros(1, 2, th.MAX_COLS + 1)
    elif bad == "not_3d":
        c = torch.zeros(4, 6)
    else:
        steps = torch.zeros(2, dtype=torch.int64)
    with pytest.raises((ValueError, TypeError)):
        th.solve_batch(c, steps)
    if bad == "rows_over_cols":
        with pytest.raises(ValueError):
            th.solve(torch.zeros(7, 6))


def test_failed_lane_rule_on_non_finite_costs():
    """A lane with a NaN row, one of +inf costs and one where 6 rows have
    only 4 finite columns each fail within their step caps and return -1
    on every row (JAX's while_loop can spin forever on such lanes); the
    finite lanes beside them equal JAX's."""
    rng = np.random.default_rng(9)
    c = rng.standard_normal((5, 6, 8)).astype(np.float32)
    c[1, 2] = np.nan
    c[2] = np.inf
    c[3, :, 4:] = np.inf
    steps = torch.zeros(5, dtype=torch.int32)
    got = th.solve_batch(torch.from_numpy(c), steps).numpy()
    for lane in (1, 2, 3):
        assert (got[lane] == -1).all()
    assert (steps <= 6 * 8).all() and (steps > 0).all()
    finite = c[[0, 4]]
    np.testing.assert_array_equal(got[[0, 4]], _jax(finite))
    assert (got[[0, 4]] >= 0).all()


def test_empty_and_single_column():
    """No lanes, and 1 x 1 lanes (the smallest problem)."""
    assert th.solve_batch(torch.zeros(0, 3, 4)).shape == (0, 3)
    got = th.solve_batch(torch.tensor([[[2.0]], [[-1.0]]]))
    np.testing.assert_array_equal(got.numpy(), [[0], [0]])


def test_padded_rows_bound_the_f32_gap_to_scipy():
    """Why chip_smoke.py's phase 8b gates the real rows' cost at one f32
    ulp of PAD_COST a real row beside padded rows: with costs that nearly
    tie (queries 1e-3 apart, as in early decoder rounds) and PAD_COST rows
    after the real ones, the f32 duals reach 1e4 and resolve a reduced
    cost only to its ulp (2^-10), so the solver, JAX's as well (equal on
    every row), may match the real rows a little dearer than scipy's
    optimum, by less than that ulp a row.  The real rows alone in f32,
    and the same lanes in f64, reach scipy's cost."""
    rng = np.random.default_rng(0)
    lanes, m = 16, 120
    base = rng.standard_normal((lanes, m, 1)) * 3
    c = (base + 1e-3 * rng.standard_normal((lanes, m, m))).astype(np.float32)
    real = rng.integers(10, 40, lanes)
    for lane in range(lanes):
        c[lane, real[lane]:] = tlosses.PAD_COST
    got = _port(c)
    np.testing.assert_array_equal(got, _jax(c))
    ulp = float(np.spacing(np.float32(tlosses.PAD_COST)))
    assert ulp == 2.0 ** -10
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        got64 = th.solve_batch_reference(torch.from_numpy(
            c.astype(np.float64)))[0].numpy()
    finally:
        torch.set_default_dtype(prev)
    gaps = []
    for lane in range(lanes):
        r = np.arange(real[lane])
        sub = c[lane, :real[lane]]
        ri, ci = linear_sum_assignment(sub)
        ref = sub[ri, ci].sum(dtype=np.float64)
        alone = _port(sub[None])[0]
        for col, tol in ((got[lane], real[lane] * ulp),
                         (got64[lane], 1e-9 * abs(ref)),
                         (alone, 1e-6 * abs(ref))):
            gap = c[lane, r, col[r]].sum(dtype=np.float64) - ref
            assert -1e-9 * abs(ref) <= gap <= tol, (lane, gap, tol)
        gaps.append((c[lane, r, got[lane, r]].sum(dtype=np.float64) - ref)
                    / abs(ref))
    # the f32 gap is there: some lane is matched dearer than scipy's by
    # more than the 1e-5 relative gate of lanes without padded rows
    assert max(gaps) > 1e-5


def _cpu_lanes(kind, rng, lanes, r, n):
    if kind == "random":
        return (rng.standard_normal((lanes, r, n)) * 10).astype(np.float32)
    if kind == "padded":
        c = rng.standard_normal((lanes, r, n)).astype(np.float32) * 3
        for lane, real in enumerate(rng.integers(1, r, lanes)):
            c[lane, real:] = tlosses.PAD_COST
        return c
    if kind == "tied":
        c = np.repeat(rng.standard_normal((lanes, r, 1)), n, 2)
        c[0] = 0.0
        return c.astype(np.float32)
    return rng.integers(0, 3, (lanes, r, n)).astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "padded", "tied", "integers"])
def test_host_solver_equals_plain_version_and_jax(kind):
    """``solve_batch`` on a CPU tensor runs csrc/hungarian_cpu.cpp: its
    ``col4row`` and Dijkstra steps equal the plain version's on every lane,
    and its ``col4row`` equals JAX's ``solve`` on every row."""
    rng = np.random.default_rng(len(kind))
    c = _cpu_lanes(kind, rng, 6, 14, 19)
    steps = torch.zeros(6, dtype=torch.int32)
    got = th.solve_batch(torch.from_numpy(c), steps)
    ref, ref_steps = th.solve_batch_reference(torch.from_numpy(c))
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    np.testing.assert_array_equal(steps.numpy(), ref_steps.numpy())
    np.testing.assert_array_equal(got.numpy(), _jax(c))


def test_host_solver_at_full_width_equals_jax():
    """The set loss's full-width problem, 52 lanes (13 rounds x 4 scenes)
    of 120 x 120 with padded rows: every row equal to JAX's, and the steps
    equal to the plain version's."""
    c = _cpu_lanes("padded", np.random.default_rng(52), 52, 120, 120)
    steps = torch.zeros(52, dtype=torch.int32)
    got = th.solve_batch(torch.from_numpy(c), steps)
    np.testing.assert_array_equal(got.numpy(), _jax(c))
    ref, ref_steps = th.solve_batch_reference(torch.from_numpy(c))
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    np.testing.assert_array_equal(steps.numpy(), ref_steps.numpy())


def test_host_solver_build_flags():
    """The host solver is built without contraction or fast math, so no
    float operation is fused or reordered against JAX's order."""
    assert "-ffp-contract=off" in th.CPU_FLAGS
    assert not any("fast-math" in f or f == "-Ofast" or "march" in f
                   for f in th.CPU_FLAGS)
    assert th.build_cpu() is th.build_cpu()
