"""Tests of the port that need an NVIDIA card: the CUDA kernels against
their plain PyTorch versions on the same inputs.  They skip without a card.
This file imports neither JAX nor the JAX package, so it runs on a machine
that has only the port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_card.py -q
"""
import numpy as np
import pytest
import torch

from pq3d_tpu_torch.ops import kernel_maps
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
def test_zrun_conv_refuses_grad(cuda_device):
    """Forward only: with grad mode on and a weight that requires grad the
    wrapper raises; under inference_mode the same call runs."""
    rng = np.random.default_rng(0)
    nbr, valid = _scene(rng, extent=24, n_pts=3000)
    n = nbr.shape[0]
    xd = torch.from_numpy(rng.standard_normal((n, 96)).astype(np.float32)
                          ).to(cuda_device)
    wd = torch.zeros(27, 96, 96, device=cuda_device, requires_grad=True)
    zb, zc = tzr.zrun_plan(torch.from_numpy(nbr).to(cuda_device))
    vd = torch.from_numpy(valid).to(cuda_device)
    with pytest.raises(RuntimeError, match="forward-only"):
        tzr.zrun_conv(xd, wd, zb, zc, vd)
    with torch.inference_mode():
        assert tzr.zrun_conv(xd, wd, zb, zc, vd).shape == (n, 96)


@pytest.mark.cuda
def test_zrun_conv_refuses_misaligned_rows(cuda_device):
    """A contiguous view that starts 4 bytes into its storage would break
    the kernel's 16-byte row loads: the wrapper raises before launching."""
    rng = np.random.default_rng(1)
    nbr, valid = _scene(rng, extent=24, n_pts=3000)
    n = nbr.shape[0]
    flat = torch.zeros(n * 96 + 1, device=cuda_device)
    xd = flat[1:].view(n, 96)
    wd = torch.zeros(27, 96, 96, device=cuda_device)
    zb, zc = tzr.zrun_plan(torch.from_numpy(nbr).to(cuda_device))
    before = tzr.launches
    with pytest.raises(ValueError, match="aligned"):
        tzr.zrun_conv(xd, wd, zb, zc, torch.from_numpy(valid).to(cuda_device))
    assert tzr.launches == before
