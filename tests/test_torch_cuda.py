"""The port's CUDA kernels against their plain versions on the card.

Every test here needs a CUDA device (marker ``cuda``) and skips without
one. The file imports no JAX, so it also runs on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: max|kernel - plain| <= 2e-2 * max|plain|. The plain versions
round at the kernel's points and run in f32 with TF32 off, so the two
differ by the order of f32 sums and the bf16 roundings that order flips.
"""

import numpy as np
import pytest
import torch

from stofnet_tpu_torch.models import (
    StofNet, stofnet_apply_fused, stofnet_apply_reference,
)
from stofnet_tpu_torch.ops.kernels import conv_stack, sgb
from stofnet_tpu_torch.serve import make_pipeline

pytestmark = pytest.mark.cuda
TOL = 2e-2


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, ref):
    torch.cuda.synchronize()
    assert got.shape == ref.shape
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= TOL * ref.float().abs().max().item(), err


def _bf16(rng, shape, dev, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return torch.from_numpy(a).to(dev, torch.bfloat16)


@pytest.mark.parametrize("batch,length,f", [(3, 80, 512), (2, 800, 512),
                                            (1, 2000, 128), (5, 8000, 512)])
def test_sgb_kernel_matches_plain(cuda, batch, length, f):
    """Odd window counts leave a tile with one window; both sequence ends
    take the zero halo."""
    rng = np.random.default_rng(length)
    h = _bf16(rng, (batch, length, 64), cuda)
    w = _bf16(rng, (5, 64, f), cuda, 0.05)
    b = _bf16(rng, (f,), cuda, 0.1)
    before = sgb.launches
    got = sgb.sgb_contract_pool(h, w, b)
    assert sgb.launches == before + 1
    _close(got, sgb.sgb_contract_pool_reference(h, w, b))


@pytest.mark.parametrize("batch,length,up", [(2, 80, 4), (1, 444, 4),
                                             (3, 445, 1), (2, 800, 8),
                                             (2, 8000, 4)])
def test_conv_stack_kernel_matches_plain(cuda, batch, length, up):
    """Tiles of 444 positions: seams at tile edges and both sequence ends."""
    rng = np.random.default_rng(length)
    state = StofNet(upsample_factor=up, device=cuda,
                    generator=torch.Generator().manual_seed(1)).state_dict()
    h0 = _bf16(rng, (batch, length, 64), cuda)
    before = conv_stack.launches
    got = conv_stack.conv_stack_fused(h0, state)
    assert conv_stack.launches == before + 1
    assert got.dtype == torch.float32
    _close(got, conv_stack.conv_stack_fused_reference(h0, state))


def test_kernels_refuse_float32_on_the_card(cuda):
    h = torch.zeros((1, 800, 64), device=cuda)
    with pytest.raises(TypeError):
        sgb.sgb_contract_pool(h, torch.zeros((5, 64, 512), device=cuda),
                              torch.zeros(512, device=cuda))


def test_fused_forward_and_pipeline_on_the_card(cuda):
    rng = np.random.default_rng(0)
    state = StofNet(device=cuda,
                    generator=torch.Generator().manual_seed(2)).state_dict()
    x = torch.from_numpy(rng.standard_normal((2, 1, 1600)).astype(
        np.float32)).to(cuda)
    _close(stofnet_apply_fused(state, x), stofnet_apply_reference(state, x))
    counts = (sgb.launches, conv_stack.launches)
    coords = make_pipeline(state, {}, max_echoes=8, device=cuda)(x)
    assert coords.shape == (2, 8) and coords.is_cuda
    assert (sgb.launches, conv_stack.launches) == (counts[0] + 1,
                                                   counts[1] + 1)
