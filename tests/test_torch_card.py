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

from pq3d_tpu_torch.ops import hungarian as thu
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


def _layout_batch(seed, **kw):
    """A 2-scene batch of synthetic scenes of 40k and 50k points."""
    from pq3d_tpu_torch.data import synthetic
    from pq3d_tpu_torch.data.instseg_pipeline import (InstSegPipelineConfig,
                                                      make_batch)
    rng = np.random.default_rng(seed)
    scenes = [synthetic.make_scene(rng, n_points=n, n_instances=5,
                                   n_segments=40) for n in (40000, 50000)]
    cfg = InstSegPipelineConfig(num_queries=16, max_segments=64,
                                max_instances=8, voxel_bucket=8192,
                                use_aug=False, stem_mode="dense_block", **kw)
    return make_batch(scenes, cfg, np.random.default_rng(seed))


@pytest.mark.cuda
def test_device_maps_on_the_card_equal_the_host(cuda_device):
    """build_batch_maps on the card (sorts, batched searchsorted, index
    scatters) gives every array of the host's collate exactly, z-run
    plans included."""
    from pq3d_tpu_torch.ops import device_maps
    from pq3d_tpu_torch.serve import to_device
    caps = (65536, 40960, 16384, 4096, 2048)
    host = _layout_batch(1, level_caps=caps, ztriple_conv=True)["maps"]
    dev = _layout_batch(1, level_caps=caps, device_maps=True)
    t = to_device({k: v for k, v in dev.items() if k != "_meta"},
                  cuda_device)
    got = device_maps.build_batch_maps(t["vox_coords"], t["n_voxels"],
                                       t["voxel_feats"], caps, ztriple=True)
    for key, want in host.items():
        g = got[key].cpu().numpy()
        assert g.dtype == want.dtype and g.shape == want.shape, key
        np.testing.assert_array_equal(g, want, err_msg=key)


@pytest.mark.cuda
def test_flat_unet_with_b1_matches_plain(cuda_device):
    """The U-Net on a flat-pack batch with z-run plans: the decoder's
    96/128-channel convs at L0 and L1 launch the kernel on the flat level
    totals, the rest run the z-run gather conv or the gather conv; against
    the same U-Net with every conv plain, the output and feature maps
    within 2e-2 relative (chip_smoke's gate)."""
    from pq3d_tpu_torch.models.sparse_unet import Res16UNet
    from pq3d_tpu_torch.serve import to_device
    b = _layout_batch(2, flat_pack=True, ztriple_conv=True)
    torch.manual_seed(0)
    model = Res16UNet(pallas_conv=True).to(cuda_device).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0, 0.05)
    maps = to_device(b["maps"], cuda_device)
    x = torch.from_numpy(b["voxel_feats"]).to(cuda_device)
    rows = [b["maps"][f"valid_{l}"].shape[0] for l in range(5)]
    routed = model.routed_convs(rows)
    assert routed
    before = tzr.launches
    with torch.inference_mode():
        out, fm = model(x, maps)
        assert tzr.launches - before == len(routed)
        model.pallas_conv = False
        ref, fm_ref = model(x, maps)
    for a, r in zip([out] + fm, [ref] + fm_ref):
        assert torch.isfinite(a).all()
        err = (a.float() - r.float()).abs().max() / r.float().abs().max()
        assert err <= 2e-2


@pytest.mark.cuda
def test_flat_train_batch_backwards_match_plain(cuda_device):
    """On a flat + z-run training batch (two augmented scenes of 40k and
    50k points): the z-run gather conv's Function at the shapes it takes
    (levels 1-3, 32 and 64 channels) against autograd through the plain
    gather conv, and B1's Function at every shape the U-Net routes on
    these flat totals against its plain backward; forward, dx and dW
    within 1e-2 of max|ref|, one dx launch per B1 call."""
    from pq3d_tpu_torch.data import synthetic
    from pq3d_tpu_torch.data.instseg_pipeline import (InstSegPipelineConfig,
                                                      make_batch)
    from pq3d_tpu_torch.models.sparse_unet import Res16UNet
    from pq3d_tpu_torch.ops import sparse
    rng = np.random.default_rng(4)
    scenes = [synthetic.make_scene(rng, n_points=n, n_instances=5,
                                   n_segments=40) for n in (40000, 50000)]
    cfg = InstSegPipelineConfig(num_queries=16, max_segments=64,
                                max_instances=8, voxel_bucket=8192,
                                flat_pack=True, ztriple_conv=True,
                                stem_mode="dense_block")
    maps = make_batch(scenes, cfg, rng, train=True)["maps"]
    rows = [maps[f"valid_{l}"].shape[0] for l in range(5)]
    routed = {(lvl, cin, cout) for _, lvl, cin, cout
              in Res16UNet(pallas_conv=True).routed_convs(rows)}
    assert routed
    gen = torch.Generator().manual_seed(0)

    def inputs(lvl, cin, cout):
        valid = torch.from_numpy(maps[f"valid_{lvl}"]).to(cuda_device)
        n = valid.shape[0]
        x = (torch.randn(n, cin, generator=gen).to(cuda_device)
             * valid[:, None]).requires_grad_(True)
        w = (torch.randn(27, cin, cout, generator=gen) * 0.05).to(
            cuda_device).requires_grad_(True)
        dy = torch.randn(n, cout, generator=gen).to(cuda_device)
        return valid, x, w, dy

    def close(got, ref):
        assert got.shape == ref.shape and torch.isfinite(got).all()
        return ((got.float() - ref.float()).abs().max()
                / ref.float().abs().max()).item() <= 1e-2

    for lvl, c in ((1, 32), (2, 64), (3, 64)):
        zb, zc = (torch.from_numpy(maps[f"zt{lvl}_{k}"]).to(cuda_device)
                  for k in ("base", "code"))
        nbr = torch.from_numpy(maps[f"nbr3_{lvl}"]).to(cuda_device)
        valid, x, w, dy = inputs(lvl, c, c)
        y = sparse.sparse_conv_ztriple_sym(x, zb, zc, w, valid)
        y.backward(dy)
        xr = x.detach().clone().requires_grad_(True)
        wr = w.detach().clone().requires_grad_(True)
        yr = sparse.sparse_conv(xr, nbr, wr, None, valid)
        yr.backward(dy)
        assert close(y, yr) and close(x.grad, xr.grad) \
            and close(w.grad, wr.grad), (lvl, c)
    for lvl, cin, cout in sorted(routed):
        zb, zc = tzr.zrun_plan(torch.from_numpy(
            maps[f"nbr3_{lvl}"]).to(cuda_device))
        valid, x, w, dy = inputs(lvl, cin, cout)
        before = dict(tzr.phase_launches)
        y = tzr.zrun_conv_sym(x, w, zb, zc, valid)
        y.backward(dy)
        torch.cuda.synchronize()
        assert tzr.phase_launches["fwd"] == before["fwd"] + 1
        assert tzr.phase_launches["bwd"] == before["bwd"] + 1
        dx_ref, dw_ref = tzr.zrun_conv_backward_reference(
            x.detach(), w.detach(), zb, zc, valid, dy)
        y_ref = tzr.zrun_conv_reference(x.detach(), w.detach(), zb, zc,
                                        valid)
        assert close(y, y_ref) and close(x.grad, dx_ref) \
            and close(w.grad, dw_ref), (lvl, cin, cout)


@pytest.mark.cuda
@pytest.mark.parametrize("backend,nproc", [("gloo", 2), ("nccl", 1)])
def test_data_parallel_step_on_the_card(cuda_device, tmp_path, monkeypatch,
                                        backend, nproc):
    """One stage-1 train step (the small model of test_torch_trainer.py,
    every sparse conv plain in f32) through ``python -m
    pq3d_tpu_torch.launch`` on cuda:0: two gloo ranks (nccl refuses two
    ranks on one card) end with bit-identical gradients, and one nccl
    rank (the nccl group initialised, DDP's broadcast and all-reduce on
    it); each matches one process at the global batch of 4 on the card:
    loss within 1e-5, gradients within 1e-4 of the largest."""
    import pickle
    import _torch_ddp_worker as w
    from pq3d_tpu_torch.models import query3d as tq3d
    batch = w.stage1_batch()
    with open(tmp_path / "batch.pkl", "wb") as f:
        pickle.dump(batch, f)
    model = w.stage1_model()
    tq3d.init_weights(model, torch.Generator().manual_seed(0))
    torch.save(model.state_dict(), tmp_path / "model.pt")
    ranks = w.spawn("card_step", tmp_path, devices=("cuda:0",) * nproc,
                    backend=backend)
    assert all(r[3] == backend for r in ranks)
    monkeypatch.setattr(w.tsparse, "_round", lambda t, dtype: t.float())
    m, grads, _ = w.train_step(model.to(cuda_device), batch, w.stage1_loss,
                               device=cuda_device)
    for r in ranks[1:]:
        assert r[0] == ranks[0][0]
        assert all(torch.equal(r[1][k], ranks[0][1][k]) for k in r[1])
    got_m, got = ranks[0][0], ranks[0][1]
    assert abs(got_m["loss"] - m["loss"]) <= 1e-5 * abs(m["loss"])
    top = max(g.abs().max().item() for g in grads.values())
    assert grads.keys() == got.keys()
    assert max((got[k] - g).abs().max().item()
               for k, g in grads.items()) <= 1e-4 * top


@pytest.mark.cuda
def test_zrun_conv_op_check_on_the_card(cuda_device):
    """torch.library.opcheck of ``pq3d::zrun_conv`` on CUDA tensors at a
    routed shape: schema, fake shape rule, autograd registration (its dx
    launches the kernel) and traced calls agree with the eager op."""
    rng = np.random.default_rng(5)
    nbr, valid = _scene(rng, extent=40, n_pts=9000)
    n = nbr.shape[0]
    x = torch.from_numpy(rng.standard_normal((n, 96)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((27, 96, 128)) * 0.05)
                         .astype(np.float32))
    zb, zc = tzr.zrun_plan(torch.from_numpy(nbr).to(cuda_device))
    vd = torch.from_numpy(valid).to(cuda_device)
    xd, wd = x.to(cuda_device), w.to(cuda_device)
    before = dict(tzr.phase_launches)
    torch.library.opcheck(torch.ops.pq3d.zrun_conv.default,
                          (xd, wd, zb, zc, vd, "fwd"))
    torch.library.opcheck(torch.ops.pq3d.zrun_conv.default,
                          (xd.clone().requires_grad_(),
                           wd.clone().requires_grad_(), zb, zc, vd, "fwd"))
    torch.cuda.synchronize()
    assert tzr.phase_launches["fwd"] > before["fwd"]
    assert tzr.phase_launches["bwd"] > before["bwd"]


@pytest.mark.cuda
def test_export_on_the_cpu_runs_on_the_card(cuda_device):
    """An artifact exported on the CPU, loaded with device="cuda": one
    pq3d.zrun_conv node per routed conv, B1 launched that often a forward,
    and the first decoder round within 1e-5 of the eager forward on the
    card (the later rounds read the self-mask's attend bits, which the
    card's atomic segment sums may flip).  Random weights from the port's
    init: every conv, the dense-block stem's included, does work (the
    stem's cuDNN conv must run without TF32 in both)."""
    from pq3d_tpu_torch import export
    from pq3d_tpu_torch.models import query3d
    from pq3d_tpu_torch.serve import to_device
    caps = (65536, 40960, 16384, 4096, 2048)
    b = _layout_batch(3, level_caps=caps)
    torch.manual_seed(0)
    model = query3d.Query3DUnified(
        memories=("voxel",), heads=("mask",), hidden_size=32,
        unified=query3d.UnifiedEncoderCfg(num_layers=1, num_blocks=1,
                                          num_attention_heads=4),
        voxel_enc=query3d.VoxelEncoderCfg(hlevels=(0, 1), out_channels=20,
                                          pallas_conv=True),
        mask_head_cfg=query3d.MaskHeadCfg(21, (0, 2))).eval()
    query3d.init_weights(model, torch.Generator().manual_seed(0))
    bc = to_device({k: v for k, v in b.items() if k != "_meta"},
                   torch.device("cpu"))
    rows = [int(np.prod(b["maps"][f"valid_{l}"].shape)) for l in range(5)]
    routed = model.voxel_encoder.backbone.routed_convs(rows)
    assert routed
    keys = ("predictions_class", "predictions_mask")
    blob = export.export_forward(model, bc, outputs=keys)
    assert export.kernel_nodes(blob) == len(routed)
    assert export.exported_platforms(blob) == ("cpu",)
    fn = export.load_forward(blob, device="cuda")
    bd = to_device(bc, cuda_device)
    before = tzr.launches
    got = fn(bd)
    torch.cuda.synchronize()
    assert tzr.launches - before == len(routed)
    model.to(cuda_device)
    with torch.no_grad():
        ref = model(bd)
    for key in keys:
        g, r = got[key][0].float(), ref[key][0].float()
        assert g.device.type == "cuda" and torch.isfinite(g).all()
        assert (g - r).abs().max() <= 1e-5 * r.abs().max()


def _assignment_lanes(kind, lanes, rows, cols, seed):
    """(lanes, rows, cols) f32 costs of one kind: random with the last
    fifth of the rows padded at the set loss's PAD_COST, every query
    column tied (a round of identical queries), small integers with many
    ties, plain random, or lanes with non-finite costs beside finite
    ones."""
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((lanes, rows, cols)).astype(np.float32) * 3
    if kind == "padded":
        c[:, rows - rows // 5:] = 1e4
    elif kind == "tied":
        c[:] = c[:, :, :1]
    elif kind == "integers":
        c = rng.integers(0, 3, c.shape).astype(np.float32)
    elif kind == "non_finite":
        c[1, rows // 2] = np.nan
        c[2] = np.inf
        c[3, :, rows - 2:] = np.inf
    return c


@pytest.mark.cuda
@pytest.mark.parametrize("kind,lanes,rows,cols,stage", [
    ("padded", 52, 120, 120, True), ("tied", 52, 120, 120, True),
    ("integers", 8, 120, 120, True), ("padded", 52, 120, 120, False),
    ("random", 5, 30, 33, True), ("random", 3, 1, 1, True),
    ("random", 4, 200, 257, True), ("random", 2, 64, 1024, False),
    ("non_finite", 6, 12, 16, True)])
def test_hungarian_kernel_matches_plain_version(cuda_device, monkeypatch,
                                                kind, lanes, rows, cols,
                                                stage):
    """hungarian.cu against solve_batch_reference on a CPU copy: col4row
    equal on every row of every lane (the kernel pins JAX's f32 operation
    order, so no tolerance), the same Dijkstra steps a lane, one launch
    counted; costs staged in shared memory and read from global memory
    (``stage`` False forces the second path); failed lanes -1."""
    c = _assignment_lanes(kind, lanes, rows, cols, rows + cols)
    fits = thu.staged
    monkeypatch.setattr(thu, "staged", lambda r, n: stage and fits(r, n))
    cd = torch.from_numpy(c).to(cuda_device)
    steps = torch.zeros(lanes, dtype=torch.int32, device=cuda_device)
    before = thu.launches
    got = thu.solve_batch(cd, steps)
    torch.cuda.synchronize()
    assert thu.launches == before + 1 and got.dtype == torch.int32
    ref, ref_steps = thu.solve_batch_reference(torch.from_numpy(c))
    assert torch.equal(got.cpu(), ref)
    assert torch.equal(steps.cpu(), ref_steps)
    if kind == "non_finite":
        assert (ref[1:4] == -1).all() and (ref[[0, 4, 5]] >= 0).all()
    else:
        assert all(len(set(r.tolist())) == rows for r in ref)


@pytest.mark.cuda
def test_hungarian_refusals_on_the_card(cuda_device):
    """A non-f32 or strided cost, and R > N, raise before any launch."""
    before = thu.launches
    for bad in (torch.zeros(2, 4, 6, device=cuda_device, dtype=torch.half),
                torch.zeros(2, 6, 4, device=cuda_device).transpose(1, 2),
                torch.zeros(2, 7, 6, device=cuda_device)):
        with pytest.raises((TypeError, ValueError)):
            thu.solve_batch(bad)
    assert thu.launches == before


@pytest.mark.cuda
def test_set_loss_makes_no_host_sync(cuda_device):
    """instseg_set_loss on CUDA tensors under
    torch.cuda.set_sync_debug_mode("error"): no operation of the set loss
    synchronises with the host, the solver launched once."""
    from pq3d_tpu_torch.optim import losses
    rng = np.random.default_rng(2)
    b, q, m, s, rounds = 2, 16, 12, 40, 3
    cls = [torch.from_numpy(rng.standard_normal((b, q, 21)).astype(
        np.float32)).to(cuda_device) for _ in range(rounds)]
    msk = [torch.from_numpy(rng.standard_normal((b, s, q)).astype(
        np.float32)).to(cuda_device) for _ in range(rounds)]
    valid = torch.zeros(b, m, dtype=torch.bool)
    valid[0, :5] = valid[1, :9] = True
    batch = {"instance_labels": torch.from_numpy(rng.integers(
                 0, 20, (b, m)).astype(np.int32)),
             "segment_masks": torch.from_numpy(rng.random((b, m, s)) < 0.3),
             "instance_valid": valid,
             "seg_pad_masks": torch.ones(b, s, dtype=torch.bool)}
    batch = {k: v.to(cuda_device) for k, v in batch.items()}
    cfg = losses.InstSegLossConfig(num_classes=20)
    torch.cuda.synchronize()
    before = thu.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        total, _ = losses.instseg_set_loss(cls, msk, batch, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert thu.launches == before + 1
    ref, _ = losses.instseg_set_loss([x.cpu() for x in cls],
                                     [x.cpu() for x in msk],
                                     {k: v.cpu() for k, v in batch.items()},
                                     cfg)
    assert abs(total.item() - ref.item()) <= 1e-4 * abs(ref.item())
