"""Tests of the port that need an NVIDIA card: the CUDA kernels, forward
and backward, against their plain PyTorch versions on the same inputs.
They skip without a card.
This file imports neither JAX nor the JAX package, so it runs on a machine
that has only the port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_card.py -q
"""
import numpy as np
import pytest
import torch

from pq3d_tpu_torch.ops import kernel_maps
from pq3d_tpu_torch.ops import windowed_conv as twc
from pq3d_tpu_torch.ops import zrun_conv as tzr


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _scene(rng, extent, n_pts, align=128):
    """Ravel-sorted random voxels and their padded (N, 27) map."""
    coords = np.unique(rng.integers(0, extent, (n_pts, 3)).astype(np.int32),
                       axis=0)
    key = (coords[:, 0].astype(np.int64) * 4096
           + coords[:, 1]) * 4096 + coords[:, 2]
    coords = coords[np.argsort(key)]
    n_pad = -(-len(coords) // align) * align
    nbr = kernel_maps.build_neighbor_map(coords, 3, n_pad=n_pad)
    return nbr, np.arange(n_pad) < len(coords)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout", [(96, 96), (128, 96), (192, 128)])
def test_zrun_conv_kernel_matches_plain_version(cuda_device, dtype, cin,
                                                cout):
    """zrun_conv.cu against zrun_conv_reference: the same bf16-rounded
    operands, f32 sums in another order, so max|diff| / max|ref| <= 1e-2
    (the bf16 output's rounding); pad rows are zero; one launch counted."""
    rng = np.random.default_rng(cin + cout)
    nbr, valid = _scene(rng, extent=40, n_pts=9000)
    n = nbr.shape[0]
    x = np.zeros((n, cin), np.float32)
    x[valid] = rng.standard_normal((valid.sum(), cin))
    w = (rng.standard_normal((27, cin, cout)) * 0.05).astype(np.float32)
    xd = torch.from_numpy(x).to(cuda_device, dtype)
    wd = torch.from_numpy(w).to(cuda_device)
    vd = torch.from_numpy(valid).to(cuda_device)
    zb, zc = tzr.zrun_plan(torch.from_numpy(nbr).to(cuda_device))
    before = tzr.launches
    got = tzr.zrun_conv(xd, wd, zb, zc, vd)
    torch.cuda.synchronize()
    assert tzr.launches == before + 1 and got.dtype == dtype
    ref = tzr.zrun_conv_reference(xd, wd, zb, zc, vd).float()
    err = (got.float() - ref).abs().max() / ref.abs().max()
    assert err.item() <= 1e-2
    assert not got.float()[~vd].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout", [(96, 96), (128, 192), (96, 240)])
def test_zrun_conv_kernel_skips_padding_tiles_wide_cout(cuda_device, dtype,
                                                        cin, cout):
    """A scene padded to over twice its voxel count, so that whole tiles
    of the kernel hold no reference and skip the main loop, at the dx
    widths (Cout 192, and 240, the widest the kernel takes).  Blocks of
    y's size are filled with NaN and freed first, so a skipped tile that
    wrote nothing would leave NaN in y.  Against zrun_conv_reference
    within 1e-2 of max|ref|; pad rows exactly zero; one launch counted."""
    rng = np.random.default_rng(cin + 2 * cout)
    nbr, valid = _scene(rng, extent=30, n_pts=7000)
    n_valid = int(valid.sum())
    n = -(-(2 * n_valid + tzr.TILE) // tzr.TILE) * tzr.TILE
    nbr = np.concatenate([nbr, np.full((n - len(nbr), 27), -1, np.int32)])
    valid = np.arange(n) < n_valid
    x = np.zeros((n, cin), np.float32)
    x[valid] = rng.standard_normal((n_valid, cin))
    w = (rng.standard_normal((27, cin, cout)) * 0.05).astype(np.float32)
    xd = torch.from_numpy(x).to(cuda_device, dtype)
    wd = torch.from_numpy(w).to(cuda_device)
    vd = torch.from_numpy(valid).to(cuda_device)
    zb, zc = tzr.zrun_plan(torch.from_numpy(nbr).to(cuda_device))
    skipped = ~tzr.tile_tap_mask(zc).any(1)
    assert skipped.sum().item() >= 2
    junk = [torch.full((n, cout), float("nan"), dtype=dtype,
                       device=cuda_device) for _ in range(2)]
    del junk
    before = tzr.launches
    got = tzr.zrun_conv(xd, wd, zb, zc, vd)
    torch.cuda.synchronize()
    assert tzr.launches == before + 1 and got.dtype == dtype
    assert torch.isfinite(got.float()).all()
    ref = tzr.zrun_conv_reference(xd, wd, zb, zc, vd).float()
    err = (got.float() - ref).abs().max() / ref.abs().max()
    assert err.item() <= 1e-2
    assert not got.float()[~vd].any()


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(208, 128), (240, 96), (192, 192),
                                      (192, 240), (240, 240)])
def test_zrun_conv_kernel_splits_wide_stages(cuda_device, cin, cout):
    """Shapes whose whole-tap ring stages, (128 + Cout) x Cin bf16, would
    not fit twice in a block's shared memory: the kernel splits Cin into
    K chunks.  Against zrun_conv_reference within 1e-2, twice in a row
    (the second launch reuses the tile counter the first set back to 0,
    which the test reads), one launch counted per call."""
    rng = np.random.default_rng(cin * cout)
    nbr, valid = _scene(rng, extent=32, n_pts=6000)
    n = nbr.shape[0]
    x = np.zeros((n, cin), np.float32)
    x[valid] = rng.standard_normal((valid.sum(), cin))
    w = (rng.standard_normal((27, cin, cout)) * 0.05).astype(np.float32)
    xd = torch.from_numpy(x).to(cuda_device)
    wd = torch.from_numpy(w).to(cuda_device)
    vd = torch.from_numpy(valid).to(cuda_device)
    zb, zc = tzr.zrun_plan(torch.from_numpy(nbr).to(cuda_device))
    ref = tzr.zrun_conv_reference(xd, wd, zb, zc, vd)
    for _ in range(2):
        before = tzr.launches
        got = tzr.zrun_conv(xd, wd, zb, zc, vd)
        torch.cuda.synchronize()
        assert tzr.launches == before + 1
        err = (got - ref).abs().max() / ref.abs().max()
        assert err.item() <= 1e-2
        assert not got[~vd].any()
        stream = torch.cuda.current_stream(cuda_device).cuda_stream
        counter = tzr._counters[(xd.device.index, stream)]
        assert counter.tolist() == [0, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("dy_layout", ["masked", "offset", "strided"])
@pytest.mark.parametrize("cin,cout", [(96, 128), (192, 128)])
def test_zrun_conv_sym_backward_matches_plain(cuda_device, dy_layout, cin,
                                              cout):
    """zrun_conv_sym's backward on the card: dx launches the kernel once
    (Cin and Cout swapped, so the (192, 128) conv's dx runs Cout 192) and
    dW is the re-gather; both against zrun_conv_backward_reference within
    1e-2 of max|ref|.  An unmasked dy that is a view 4 bytes into its
    storage, or a column slice, still launches the kernel (on an aligned
    copy)."""
    rng = np.random.default_rng(cin)
    nbr, valid = _scene(rng, extent=32, n_pts=6000)
    n = nbr.shape[0]
    x = np.zeros((n, cin), np.float32)
    x[valid] = rng.standard_normal((valid.sum(), cin))
    w = (rng.standard_normal((27, cin, cout)) * 0.05).astype(np.float32)
    dy = rng.standard_normal((n, cout)).astype(np.float32)
    zb, zc = tzr.zrun_plan(torch.from_numpy(nbr).to(cuda_device))
    vd = torch.from_numpy(valid).to(cuda_device) \
        if dy_layout == "masked" else None
    dyd = torch.from_numpy(dy).to(cuda_device)
    if dy_layout == "offset":
        flat = torch.zeros(n * cout + 1, device=cuda_device)
        flat[1:] = dyd.reshape(-1)
        dyd = flat[1:].view(n, cout)
        assert dyd.data_ptr() % 16
    elif dy_layout == "strided":
        wide = torch.zeros(n, cout + 16, device=cuda_device)
        wide[:, 16:] = dyd
        dyd = wide[:, 16:]
        assert not dyd.is_contiguous()
    xd = torch.from_numpy(x).to(cuda_device).requires_grad_(True)
    wd = torch.from_numpy(w).to(cuda_device).requires_grad_(True)
    before = dict(tzr.phase_launches)
    tzr.zrun_conv_sym(xd, wd, zb, zc, vd).backward(dyd)
    torch.cuda.synchronize()
    assert tzr.phase_launches["fwd"] == before["fwd"] + 1
    assert tzr.phase_launches["bwd"] == before["bwd"] + 1
    dx_ref, dw_ref = tzr.zrun_conv_backward_reference(
        xd.detach(), wd.detach(), zb, zc, vd, dyd)
    for got, ref in ((xd.grad, dx_ref), (wd.grad, dw_ref)):
        assert got.shape == ref.shape
        err = (got - ref).abs().max() / ref.abs().max()
        assert err.item() <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(100, 96), (96, 248), (248, 96)])
def test_zrun_conv_sym_pads_and_slices_routed_shapes(cuda_device, cin, cout):
    """Shapes ``applicable`` routes that are not the kernel's own: Cin 100
    (padded to 112), Cout 248 (padded to 256 and run as two slices of 128)
    and its dx (Cin 248 -> Cout 96 forward: dx has Cin 96 -> Cout 248).
    Forward against zrun_conv_reference within 1e-2 (pad rows zero), dx
    and dW against zrun_conv_backward_reference within 1e-2; each call
    counted as one launch of its pass."""
    rng = np.random.default_rng(cin * cout)
    nbr, valid = _scene(rng, extent=32, n_pts=6000)
    n = nbr.shape[0]
    x = np.zeros((n, cin), np.float32)
    x[valid] = rng.standard_normal((valid.sum(), cin))
    w = (rng.standard_normal((27, cin, cout)) * 0.05).astype(np.float32)
    dy = rng.standard_normal((n, cout)).astype(np.float32)
    zb, zc = tzr.zrun_plan(torch.from_numpy(nbr).to(cuda_device))
    vd = torch.from_numpy(valid).to(cuda_device)
    dyd = torch.from_numpy(dy).to(cuda_device)
    xd = torch.from_numpy(x).to(cuda_device).requires_grad_(True)
    wd = torch.from_numpy(w).to(cuda_device).requires_grad_(True)
    before = dict(tzr.phase_launches)
    y = tzr.zrun_conv_sym(xd, wd, zb, zc, vd)
    torch.cuda.synchronize()
    assert tzr.phase_launches["fwd"] == before["fwd"] + 1
    assert y.shape == (n, cout) and y.is_contiguous()
    ref = tzr.zrun_conv_reference(xd.detach(), wd.detach(), zb, zc, vd)
    assert ((y.detach() - ref).abs().max() / ref.abs().max()).item() <= 1e-2
    assert not y.detach()[~vd].any()
    y.backward(dyd)
    torch.cuda.synchronize()
    assert tzr.phase_launches["bwd"] == before["bwd"] + 1
    dx_ref, dw_ref = tzr.zrun_conv_backward_reference(
        xd.detach(), wd.detach(), zb, zc, vd, dyd)
    for got, want in ((xd.grad, dx_ref), (wd.grad, dw_ref)):
        assert got.shape == want.shape
        assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel,cin,cout,pad_tiles", [
    (3, 40, 48, 0), (3, 128, 96, 0), (3, 96, 192, 0), (5, 32, 32, 0),
    (3, 192, 128, 0), (3, 96, 96, 3)])
def test_windowed_conv_kernel_matches_plain_version(cuda_device, dtype,
                                                    kernel, cin, cout,
                                                    pad_tiles):
    """windowed_conv.cu over the folded plan against its plain version
    (windowed_sparse_conv_folded_reference) and the plain version over
    JAX's plan, at tile 256, window 512, on a dense Morton-ordered scene
    whose tiles carry several exceptions on one row (so many extra slab
    rows); Cin 40 is padded to 48, Cout 192 runs as two column slices of
    96, Cin 192 -> 128 stages the slab in K chunks, K = 125 is the 5^3
    map, and the last case ends in whole tiles of padding rows, which load
    nothing: blocks of y's size are filled with NaN and freed first, so a
    skipped tile that wrote nothing would leave NaN.  The same bf16
    operands, f32 sums in another order: max|diff| / max|ref| <= 1e-3;
    padding rows exactly zero; one launch counted."""
    tile, window = 256, 512
    rng = np.random.default_rng(cin + cout + kernel)
    coords = np.unique(rng.integers(0, 32, (20000, 3)).astype(np.int32),
                       axis=0)
    coords = coords[kernel_maps.morton_order(coords)]
    n = (-(-len(coords) // tile) + pad_tiles) * tile
    nbr = kernel_maps.build_neighbor_map(coords, kernel, n_pad=n)
    plan = twc.build_window_map(nbr, tile=tile, window=window)
    rows = plan["exc_row_tile"]
    assert any(len(r[r >= 0]) > len(np.unique(r[r >= 0])) for r in rows)
    folded = twc.fold_exceptions(plan, nbr, tile, window)
    assert folded["exc_src"].shape[1] >= 16
    x = np.zeros((n, cin), np.float32)
    x[:len(coords)] = rng.standard_normal((len(coords), cin))
    w = (rng.standard_normal((kernel ** 3, cin, cout)) * 0.05
         ).astype(np.float32)
    xd = torch.from_numpy(x).to(cuda_device, dtype)
    wd = torch.from_numpy(w).to(cuda_device)
    pd = {key: torch.from_numpy(folded[key]).to(cuda_device)
          for key in twc.FOLDED_KEYS}
    junk = [torch.full((n, cout), float("nan"), device=cuda_device)
            for _ in range(2)]
    del junk
    before = twc.launches
    got = twc.windowed_sparse_conv(xd, wd, *pd.values(), tile=tile,
                                   window=window)
    torch.cuda.synchronize()
    assert twc.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (n, cout)
    assert torch.isfinite(got).all()
    assert not got[len(coords):].any()
    ref = twc.windowed_sparse_conv_folded_reference(xd, wd, pd, tile, window)
    jax_plan = twc.windowed_sparse_conv_reference(
        xd, wd, {key: torch.from_numpy(plan[key]).to(cuda_device) for key in
                 ("win_lo", "nbr_local", "exc_in_k", "exc_row_tile",
                  "exc_src_tile")}, tile, window)
    for want in (ref, jax_plan):
        err = (got - want).abs().max() / want.abs().max()
        assert err.item() <= 1e-3


@pytest.mark.cuda
def test_zrun_conv_refuses_misaligned_rows(cuda_device):
    """A bf16 view that starts 2 bytes into its storage would break the
    kernel's 16-byte row copies: the wrapper raises before launching.  (f32
    x is cast to an aligned bf16 copy first, so only bf16 x can be
    misaligned.)"""
    rng = np.random.default_rng(1)
    nbr, valid = _scene(rng, extent=24, n_pts=3000)
    n = nbr.shape[0]
    flat = torch.zeros(n * 96 + 1, dtype=torch.bfloat16, device=cuda_device)
    xd = flat[1:].view(n, 96)
    wd = torch.zeros(27, 96, 96, device=cuda_device)
    zb, zc = tzr.zrun_plan(torch.from_numpy(nbr).to(cuda_device))
    before = tzr.launches
    with pytest.raises(ValueError, match="aligned"):
        tzr.zrun_conv(xd, wd, zb, zc, torch.from_numpy(valid).to(cuda_device))
    assert tzr.launches == before


@pytest.mark.cuda
def test_unified_forward_on_the_card_matches_the_cpu(cuda_device):
    """The stage-2 unified model (unified_tasks_synthetic: PointNet++,
    the CLIP tower, the mixed decoder, the grounding head, T5 decode) on
    the card against the same weights on the CPU, f32 with TF32 off:
    ground_logits and teacher-forced logits within 1e-4 relative, greedy
    tokens equal; then UnifiedServer answers on the card."""
    import copy
    from pq3d_tpu_torch.config import load_config
    from pq3d_tpu_torch.data import unified_datasets as uds
    from pq3d_tpu_torch.data.unified_pipeline import (
        UnifiedPipelineConfig, collate_unified, process_item)
    from pq3d_tpu_torch.models.query3d import build_model
    from pq3d_tpu_torch.serve import UnifiedServer, to_device
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = load_config("unified_tasks_synthetic")
    pipe = UnifiedPipelineConfig(**cfg["data"]["unified_options"])
    dims = {"mv": 768, "voxel": 128}
    sets = [cls(cfg, "train") for cls in (uds.SyntheticRefer,
                                          uds.SyntheticQA,
                                          uds.SyntheticCaption)]
    reqs = [sets[i % 3].get_item(i) for i in range(6)]
    rng = np.random.default_rng(0)
    items = [process_item(s, l, pipe, rng, False, dims) for s, l in reqs]
    batch = collate_unified(
        [{k: v for k, v in it.items() if not k.startswith("meta_")}
         for it in items], pipe, dims, train=False)
    model = build_model(cfg, device="cpu", seed=0)
    card = copy.deepcopy(model).to(cuda_device)
    with torch.inference_mode():
        ref = model(to_device(batch, torch.device("cpu")))
        got = card(to_device(batch, cuda_device))
    valid = torch.from_numpy(batch["query_pad_masks"])
    for key, mask in (("ground_logits", valid), ("generation_logits", None)):
        r = ref[key] if mask is None else ref[key][mask]
        g = got[key].cpu() if mask is None else got[key].cpu()[mask]
        assert ((g - r).abs().max() / r.abs().max()).item() <= 1e-4, key
    assert torch.equal(got["generation_tokens"].cpu(),
                       ref["generation_tokens"])
    srv = UnifiedServer(card, pipe, batch_size=4, feature_dims=dims,
                        max_delay_s=0.01, detokenize=uds.detokenize,
                        device="cuda")
    try:
        answers = [f.result(timeout=300) for f in
                   [srv.submit(r) for r in reqs]]
    finally:
        srv.close()
    for (scene, _), a in zip(reqs, answers):
        assert 0 <= a["ground_obj"] < len(scene["inst_labels"])
        assert a["generation_tokens"].shape == (8,)


@pytest.mark.cuda
def test_unified_train_step_on_the_card_matches_the_cpu(cuda_device):
    """One stage-2 train step (unified_tasks_synthetic, memory dropout and
    every dropout off, PointNet++ trained, AdamW with the T5 head at 1e-5,
    warmup off) on the card against the same step on the CPU from the same
    weights, f32 with TF32 off: loss parts and gradient norm within 1e-5
    relative; all gradients together within 1e-3 and all updates (new
    minus old) together within 1e-2, relative in L2 (an H100 read 5.6e-5
    and 2.5e-3; one element whose
    gradient is near AdamW's eps moves its update by up to the rate, so a
    per-tensor maximum would read that element alone); a tensor whose CPU
    gradient is f32 noise, below 1e-6 of the largest, is held to the rate
    instead."""
    import copy
    from pq3d_tpu_torch.config import load_config
    from pq3d_tpu_torch.data import unified_datasets as uds
    from pq3d_tpu_torch.data.unified_pipeline import (
        UnifiedPipelineConfig, collate_unified, process_item)
    from pq3d_tpu_torch.models.query3d import build_model
    from pq3d_tpu_torch.optim.loss_aggregator import Loss
    from pq3d_tpu_torch.optim.optimizers import build_from_config
    from pq3d_tpu_torch.serve import to_device
    from pq3d_tpu_torch.train.state import make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_config("unified_tasks_synthetic", [
        "model.unified_encoder.args.memory_dropout=0.0",
        "solver.sched.args.warmup_steps=0"])
    pipe = UnifiedPipelineConfig(**cfg["data"]["unified_options"])
    dims = {"mv": 768, "voxel": 128}
    sets = [cls(cfg, "train") for cls in (uds.SyntheticRefer,
                                          uds.SyntheticQA,
                                          uds.SyntheticCaption)]
    rng = np.random.default_rng(0)
    items = [process_item(*sets[i % 3].get_item(i), pipe, rng, True, dims)
             for i in range(6)]
    batch = collate_unified(
        [{k: v for k, v in it.items() if not k.startswith("meta_")}
         for it in items], pipe, dims, train=True)
    model = build_model(cfg, device="cpu", seed=0).train()
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    card = copy.deepcopy(model).to(cuda_device)
    old = {n: p.detach().clone() for n, p in model.named_parameters()}
    loss = Loss(cfg["model"]["loss_list"], cfg["model"]["loss_weights"])
    metrics = {}
    for name, net, dev in (("cpu", model, torch.device("cpu")),
                           ("card", card, cuda_device)):
        opt, sched, gn = build_from_config(cfg, net, 100)
        step = make_train_step(net, opt, sched, loss, gn)
        metrics[name] = {k: float(v) for k, v in
                         step(to_device(batch, dev)).items()}
    for key, ref in metrics["cpu"].items():
        got = metrics["card"][key]
        assert abs(got - ref) <= 1e-5 * abs(ref), (key, ref, got)
    grads = {n: p.grad for n, p in model.named_parameters()}
    gmax = max(g.abs().max().item() for g in grads.values())
    noise = {n for n, g in grads.items()
             if 0 < g.abs().max().item() <= 1e-6 * gmax}
    lr = float(cfg["solver"]["lr"])
    card_p = {n: p.detach().cpu() for n, p in card.named_parameters()}
    card_g = {n: p.grad.cpu() for n, p in card.named_parameters()}
    sums = {"gradients": [0.0, 0.0], "updates": [0.0, 0.0]}
    for n, p in model.named_parameters():
        if n in noise:
            assert (card_p[n] - old[n]).abs().max().item() <= 1.01 * lr * (
                1 + 0.01 * old[n].abs().max().item()), n
            continue
        for key, a, b in (("gradients", card_g[n], grads[n]),
                          ("updates", card_p[n] - old[n],
                           p.detach() - old[n])):
            sums[key][0] += (a.double() - b.double()).square().sum().item()
            sums[key][1] += b.double().square().sum().item()
    rel = {k: (num / den) ** 0.5 for k, (num, den) in sums.items()}
    print(f"unified train step, card vs CPU (L2, relative): {rel}")
    assert rel["gradients"] <= 1e-3 and rel["updates"] <= 1e-2, rel


@pytest.mark.cuda
def test_gt_train_step_with_b1_matches_all_plain(cuda_device, tmp_path):
    """The GT-query variant (instseg_sceneverse_gt, pallas_conv: true, at
    its widths) on a batch of 2 SceneVerse-replica scans at real-scan
    statistics: one train step (dropout off) with kernel B1 on the routed
    convs against the same step with every conv on its plain version, loss
    within 2e-2 relative (chip_smoke.py's train_check gate); B1 ran its
    forward and dx once per routed conv, and every gradient is finite."""
    import copy
    from pq3d_tpu_torch import run
    from pq3d_tpu_torch.config import load_config
    from pq3d_tpu_torch.data.replica import ReplicaSpec, write_replica
    base, pred, aux = (str(tmp_path / d) for d in ("base", "pred", "aux"))
    write_replica(base, pred, aux, ReplicaSpec(n_train=2, n_val=1))
    cfg = load_config("instseg_sceneverse_gt", [
        f"data.scene_verse_base={base}", f"data.scene_verse_aux={aux}",
        "data.load_scan_options.load_image_segment_feat=true",
        "data.load_scan_options.load_point_segment_feat=true",
        "model.voxel_encoder.args.pallas_conv=true", "dataloader.batchsize=2",
        "device=cuda", f"exp_dir={tmp_path / 'exp'}"])
    trainer = run.build_instseg_trainer(cfg)
    batch = next(iter(trainer.train_data(0)))
    assert batch["offline_attn_mask"].any()
    model = trainer.model.train()
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    b = trainer._put(batch)
    backbone = model.voxel_encoder.backbone
    routed = backbone.routed_convs(
        [int(np.prod(batch["maps"][f"valid_{l}"].shape)) for l in range(5)])
    assert routed
    plain = copy.deepcopy(model)
    plain.voxel_encoder.backbone.pallas_conv = False
    losses = []
    for net in (model, plain):
        tzr.reset_counts()
        net.zero_grad(set_to_none=True)
        total, _ = trainer.loss_fn(net(b), b)
        total.backward()
        torch.cuda.synchronize()
        losses.append(total.item())
        assert all(torch.isfinite(p.grad).all().item()
                   for p in net.parameters() if p.grad is not None)
        counts = dict(tzr.phase_launches)
        if net is model:
            assert counts == {"fwd": len(routed), "bwd": len(routed)}
        else:
            assert counts == {"fwd": 0, "bwd": 0}
    assert abs(losses[0] - losses[1]) <= 2e-2 * abs(losses[1]), losses
