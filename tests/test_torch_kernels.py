"""The plain versions of the port's kernels (what a CPU tensor runs) against
the JAX package's Pallas kernels in interpret mode, on the CPU. The CUDA
kernels themselves are held against these plain versions on the card in
tests/test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from stofnet_tpu.models import StofNet as JaxStofNet
from stofnet_tpu.ops.packed_conv import conv1d_same as jax_conv1d_same
from stofnet_tpu.ops.pallas.conv_stack_kernel import (
    conv_stack_fused as jax_conv_stack,
)
from stofnet_tpu.ops.pallas.sgb_kernel import sgb_contract_pool as jax_sgb
from stofnet_tpu_torch.models import StofNet
from stofnet_tpu_torch.models.torch_import import params_to_state_dict
from stofnet_tpu_torch.ops.conv import conv1d_same
from stofnet_tpu_torch.ops.kernels import conv_stack, sgb


def _sgb_inputs(rng, length):
    h = rng.standard_normal((2, length, 64)).astype(np.float32)
    w = (rng.standard_normal((5, 64, 512)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(512) * 0.1).astype(np.float32)
    return h, w, b


@pytest.mark.parametrize("k", [5, 7, 4])
def test_conv1d_same_matches_jax(rng, k):
    x = rng.standard_normal((2, 300, 8)).astype(np.float32)
    w = rng.standard_normal((k, 8, 16)).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    got = conv1d_same(*map(torch.from_numpy, (x, w, b))).numpy()
    ref = np.asarray(jax_conv1d_same(*map(jnp.asarray, (x, w, b))))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("length", [800, 2000])
def test_sgb_contract_pool_plain_matches_pallas(rng, length):
    h, w, b = _sgb_inputs(rng, length)
    got = sgb.sgb_contract_pool(*map(torch.from_numpy, (h, w, b))).numpy()
    ref = np.asarray(jax_sgb(*map(jnp.asarray, (h, w, b)), interpret=True))
    assert got.shape == ref.shape == (2, length // 80, 512)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_conv_stack_plain_matches_pallas(rng):
    variables = JaxStofNet().init(jax.random.key(0), jnp.zeros((1, 1, 800)))
    state = {k: torch.tensor(v)
             for k, v in params_to_state_dict(variables).items()}
    h0 = rng.standard_normal((2, 800, 64)).astype(np.float32)
    got = conv_stack.conv_stack_fused(torch.from_numpy(h0), state).numpy()
    ref = np.asarray(jax_conv_stack(jnp.asarray(h0), variables["params"],
                                    interpret=True))
    assert got.shape == ref.shape == (2, 800, 4)
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-5 * np.abs(ref).max())


def test_kernel_wrappers_never_fall_back_off_the_cpu(rng):
    """Only a CPU tensor takes the plain version: any other device goes to
    the kernel path, which refuses what the CUDA kernel does not take."""
    h, w, b = (torch.from_numpy(a) for a in _sgb_inputs(rng, 800))
    with pytest.raises(TypeError, match="CUDA"):
        sgb.sgb_contract_pool(h.to("meta"), w, b)
    state = {k: torch.tensor(v) for k, v in params_to_state_dict(
        JaxStofNet().init(jax.random.key(0), jnp.zeros((1, 1, 80)))).items()}
    with pytest.raises(TypeError, match="CUDA"):
        conv_stack.conv_stack_fused(h.to("meta"), state)
    with pytest.raises(ValueError, match="L % 80"):
        sgb.sgb_contract_pool(h[:, :799], w, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_prepared_weight_layouts_are_lossless(dtype):
    """The weight layouts a pipeline builds once for the kernels hold each
    weight rounded to the compute type and nothing else: [n][t * C + c]
    rows, biases in f32, conv_last padded with zero rows to 8."""
    state = StofNet(generator=torch.Generator().manual_seed(3),
                    device="cpu").state_dict()
    name = "semi_global_block.contract_conv"
    w = state[f"{name}.weight"].permute(2, 1, 0)
    b = state[f"{name}.bias"]
    wt, bias = sgb.sgb_weights(w, b, dtype)
    assert torch.equal(wt.reshape(512, 5, 64).permute(1, 2, 0), w.to(dtype))
    assert torch.equal(bias, b.to(dtype).float())

    wts = conv_stack.stack_weights(state, dtype)
    for layer, i in enumerate(range(2, 13)):
        assert torch.equal(wts.mid[layer].reshape(64, 7, 64).permute(0, 2, 1),
                           state[f"conv{i}.weight"].to(dtype))
        assert torch.equal(wts.mid_bias[layer],
                           state[f"conv{i}.bias"].to(dtype).float())
    assert wts.r == 4 and wts.last.shape == (8, 3 * 64)
    assert torch.equal(wts.last[:4].reshape(4, 3, 64).permute(0, 2, 1),
                       state["conv_last.weight"].to(dtype))
    assert torch.equal(wts.last_bias[:4],
                       state["conv_last.bias"].to(dtype).float())
    assert not wts.last[4:].any() and not wts.last_bias[4:].any()
