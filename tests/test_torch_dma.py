"""The streamed SGB kernel's module (``ops/kernels/sgb_dma.py``) and the
``sgb_impl`` dispatch of the fused forward, against the JAX package's
manual-DMA kernel in interpret mode, on the CPU. The CUDA kernel itself is
held against its plain version on the card in tests/test_torch_cuda.py and
chip_smoke.py."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from stofnet_tpu.models import StofNet as JaxStofNet
from stofnet_tpu.models.fused import stofnet_apply_fused as jax_fused
from stofnet_tpu.ops.pallas.sgb_dma_kernel import (
    dma_supported as jax_dma_supported,
    sgb_contract_pool_dma as jax_sgb_dma,
)
from stofnet_tpu_torch.models import stofnet_apply_fused
from stofnet_tpu_torch.models.torch_import import params_to_state_dict
from stofnet_tpu_torch.ops.kernels import sgb_dma


def _inputs(rng, length):
    """As tests/test_pallas_kernels.py:test_sgb_dma_kernel_matches_xla."""
    h = rng.standard_normal((2, length, 64)).astype(np.float32)
    w = (rng.standard_normal((5, 64, 512)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(512) * 0.1).astype(np.float32)
    return h, w, b


@pytest.mark.parametrize("length", [800, 2400])
def test_sgb_dma_plain_matches_pallas(rng, length):
    """f32: the same function up to the order of f32 sums (rtol and atol
    1e-4, the JAX kernel's own test tolerance)."""
    h, w, b = _inputs(rng, length)
    got = sgb_dma.sgb_contract_pool_dma(
        *map(torch.from_numpy, (h, w, b))).numpy()
    ref = np.asarray(jax_sgb_dma(*map(jnp.asarray, (h, w, b)),
                                 interpret=True))
    assert got.shape == ref.shape == (2, length // 80, 512)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("length", [800, 2400])
def test_sgb_dma_plain_matches_pallas_bf16(rng, length):
    """bf16 inputs: both round weights and bias to bf16, sum in f32 and
    round the pooled output once, so they differ by at most one bf16 step
    (2^-8 relative) of max|ref| where the f32 sums straddle a rounding
    boundary."""
    h, w, b = _inputs(rng, length)
    got = sgb_dma.sgb_contract_pool_dma(
        torch.from_numpy(h).to(torch.bfloat16), *map(torch.from_numpy, (w, b)))
    ref = jax_sgb_dma(jnp.asarray(h, jnp.bfloat16), jnp.asarray(w),
                      jnp.asarray(b), interpret=True)
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    got = got.float().numpy()
    ref = np.asarray(ref.astype(jnp.float32))
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 2.0 ** -8 * np.abs(ref).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("length", [800, 2400])
def test_sgb_dma_plain_matches_pallas_on_spikes(length, dtype):
    """The inputs of the card's halo check (``spike_inputs``: spikes at
    window offsets 0, 1, 78, 79 and at both sequence ends, one tap and one
    channel per output): every sum is exact, so the plain version gives
    the JAX kernel's bits, in f32 and in bf16."""
    h, w, b = sgb_dma.spike_inputs(2, length, seed=length)
    got = sgb_dma.sgb_contract_pool_dma(
        torch.from_numpy(h).to(getattr(torch, dtype)),
        *map(torch.from_numpy, (w, b)))
    ref = jax_sgb_dma(jnp.asarray(h, getattr(jnp, dtype)), jnp.asarray(w),
                      jnp.asarray(b), interpret=True)
    assert got.shape == ref.shape == (2, length // 80, 512)
    assert 0 < float(got.max()) < 32
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_sgb_dma_weight_image_is_lossless(dtype):
    """``sgb_dma_weights`` holds, for each group of 64 output channels and
    each tap t, the block [n][c] = w[t, c, 64 * group + n] with row n's
    16-byte chunk j (8 channels) at chunk j ^ (n % 8), and nothing else;
    ``dma_weights_plain`` reads the conv kernel back."""
    rng = np.random.default_rng(9)
    w = torch.from_numpy(rng.standard_normal((5, 64, 512)).astype(
        np.float32))
    b = torch.from_numpy(rng.standard_normal(512).astype(np.float32))
    image, bias = sgb_dma.sgb_dma_weights(w, b, dtype)
    assert image.shape == (8, 5, 64 * 64) and image.dtype == dtype
    n, c = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
    index = torch.from_numpy(n * 64 + ((c // 8) ^ (n % 8)) * 8 + c % 8)
    for group in range(8):
        for t in range(5):
            assert torch.equal(image[group, t][index],
                               w[t, :, 64 * group:64 * group + 64].T.to(dtype))
    assert torch.equal(sgb_dma.dma_weights_plain(image), w.to(dtype))
    assert torch.equal(bias, b.to(dtype).float())
    with pytest.raises(ValueError, match="F % 64"):
        sgb_dma.sgb_dma_weights(w[:, :, :96], b[:96], dtype)


def test_dma_supported_takes_every_multiple_of_80():
    """The documented departure from JAX's rule: the serving kernel takes
    exactly L % 80 == 0, L >= 80 and C == 64 (JAX's L % 800 picks a TPU
    tiling, not a function); wherever L % 800 == 0 the two agree."""
    for length in (0, 40, 80, 160, 240, 640, 720, 800, 1000, 1600, 2000,
                   2400, 7200, 8000, 8040, 8800):
        for channels in (1, 32, 64, 128):
            want = length % 80 == 0 and length >= 80 and channels == 64
            assert sgb_dma.dma_supported(length, channels) == want, (
                length, channels)
            if length % 800 == 0:
                assert want == jax_dma_supported(length, channels), (
                    length, channels)


def test_sgb_dma_wrapper_refuses_without_fallback(rng):
    """A shape dma_supported refuses raises ValueError (no other route);
    a tensor off the CPU that the CUDA kernel does not take raises
    TypeError (not the plain version)."""
    h, w, b = (torch.from_numpy(a) for a in _inputs(rng, 800))
    with pytest.raises(ValueError, match="L % 80"):
        sgb_dma.sgb_contract_pool_dma(h[:, :600], w, b)
    with pytest.raises(TypeError, match="CUDA"):
        sgb_dma.sgb_contract_pool_dma(h.to("meta"), w, b)


@pytest.mark.parametrize("length", [800, 2000])
def test_fused_forward_sgb_dma_matches_jax(rng, length):
    """``sgb_impl="dma"`` with the plain conv stack, as the bench runs it:
    at L=800 JAX takes its DMA kernel, at L=2000 (L % 800 != 0) it falls
    back to its tile kernel, and the port runs its one serving kernel (on
    the CPU its plain version) at both. f32 on the CPU, at
    test_torch_model.py's tolerance."""
    variables = JaxStofNet().init(jax.random.key(0),
                                  jnp.zeros((1, 1, length)))
    state = {k: torch.tensor(v)
             for k, v in params_to_state_dict(variables).items()}
    x = rng.standard_normal((2, 1, length)).astype(np.float32)
    ref = np.asarray(jax_fused(variables, jnp.asarray(x), dtype=None,
                               interpret=True, fused_stack=False,
                               sgb_impl="dma"))
    got = stofnet_apply_fused(state, torch.from_numpy(x), dtype=None,
                              fused_stack=False, sgb_impl="dma").numpy()
    assert got.shape == ref.shape == (2, 1, 4 * length)
    np.testing.assert_allclose(got, ref, rtol=2e-3,
                               atol=2e-4 * np.abs(ref).max())


@pytest.mark.parametrize("length", [240, 2000])
def test_sgb_impl_tile_and_dma_give_the_same_output(rng, length):
    """``sgb_impl`` chooses no kernel in the port: ``"tile"`` and
    ``"dma"`` give identical outputs on the CPU, in bf16 with the fused
    stack and in f32 with the plain one."""
    state = {k: torch.tensor(v) for k, v in params_to_state_dict(
        JaxStofNet().init(jax.random.key(1),
                          jnp.zeros((1, 1, length)))).items()}
    x = torch.from_numpy(rng.standard_normal((2, 1, length)).astype(
        np.float32))
    for kw in ({}, {"dtype": None, "fused_stack": False}):
        tile = stofnet_apply_fused(state, x, sgb_impl="tile", **kw)
        dma = stofnet_apply_fused(state, x, sgb_impl="dma", **kw)
        assert tile.shape == (2, 1, 4 * length)
        assert torch.equal(tile, dma), kw


def test_fused_forward_at_32_features_matches_jax(rng):
    """A state the serving kernel cannot take (``num_features=32``) on the
    CPU: the fused forward lays no image out and runs the plain version on
    (w, b), as JAX's runs its tile kernel. f32, plain conv stack, at
    test_torch_model.py's tolerance."""
    variables = JaxStofNet(num_features=32).init(jax.random.key(3),
                                                 jnp.zeros((1, 1, 240)))
    state = {k: torch.tensor(v)
             for k, v in params_to_state_dict(variables).items()}
    x = rng.standard_normal((2, 1, 240)).astype(np.float32)
    ref = np.asarray(jax_fused(variables, jnp.asarray(x), dtype=None,
                               interpret=True, fused_stack=False))
    got = stofnet_apply_fused(state, torch.from_numpy(x), dtype=None,
                              fused_stack=False).numpy()
    assert got.shape == ref.shape == (2, 1, 4 * 240)
    np.testing.assert_allclose(got, ref, rtol=2e-3,
                               atol=2e-4 * np.abs(ref).max())


def test_sgb_impl_unknown_raises():
    with pytest.raises(ValueError, match="sgb_impl"):
        stofnet_apply_fused({}, torch.zeros((1, 1, 800)), sgb_impl="tpu")
