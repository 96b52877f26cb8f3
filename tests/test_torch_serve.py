"""The port's serving pipeline against the JAX package's on the CPU: the
decoded coords of ``make_pipeline`` on an echo-bearing gate batch, the gate
batch itself, and the device rule of the entry points."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from stofnet_tpu import serve as jax_serve
from stofnet_tpu.data.synthetic import gate_batch as jax_gate_batch
from stofnet_tpu.models import StofNet as JaxStofNet
from stofnet_tpu_torch import default_device
from stofnet_tpu_torch.data.synthetic import gate_batch
from stofnet_tpu_torch.models import StofNet
from stofnet_tpu_torch.models.torch_import import params_to_state_dict
from stofnet_tpu_torch.serve import (
    make_pipeline, module_coords, probe_dtype_agreement,
)


@pytest.fixture(scope="module")
def weights():
    variables = JaxStofNet().init(jax.random.key(0), jnp.zeros((1, 1, 800)))
    return variables, params_to_state_dict(variables)


def test_gate_batch_matches_jax():
    a = gate_batch(4, 800, np.random.default_rng(5))
    b = jax_gate_batch(4, 800, np.random.default_rng(5))
    assert a.shape == (4, 1, 800) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)


def test_pipeline_coords_match_jax(rng, weights):
    variables, state = weights
    x = gate_batch(8, 800, rng)
    ref = np.asarray(jax.jit(jax_serve.make_pipeline(
        variables, {}, window_size=20, threshold=None, max_echoes=8,
        dtype=jnp.float32))(jnp.asarray(x)))
    got = make_pipeline(state, {}, window_size=20, threshold=None,
                        max_echoes=8, dtype=torch.float32, device="cpu")(x)
    assert got.shape == ref.shape == (8, 8)
    assert np.all(np.abs(got.numpy() - ref) <= 1.0), (got, ref)
    assert np.all((got.numpy() != 0).sum(1) >= 1)


def test_pipeline_bf16_on_cpu(rng, weights):
    _, state = weights
    x = gate_batch(2, 800, rng)
    got = make_pipeline(state, {"upsample_factor": 4}, max_echoes=8,
                        device="cpu")(torch.from_numpy(x))
    assert got.shape == (2, 8) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    with pytest.raises(ValueError, match="num_features"):
        make_pipeline(state, {"num_features": 32}, device="cpu")


def test_probe_dtype_agreement_on_cpu(weights):
    """The port's probe against the JAX package's on the same weights,
    batch and seed. Both legs run the module's forward, so the f32 legs
    decode to identical coords. The bf16 legs sum in another order (oneDNN
    against XLA), and on random weights a row's maximum lies within bf16
    noise of its runner-up, so the two move different rows: the fractions
    are held to 0.05 of each other (6 of 128 slots) and to the same
    verdict at the export gate's 0.99."""
    variables, state = weights
    for length in (800, 1600, 2000):
        x = gate_batch(16, length, np.random.default_rng(3008))
        ref32 = np.asarray(jax.jit(jax_serve.make_pipeline(
            variables, {}, max_echoes=8, dtype=jnp.float32))(jnp.asarray(x)))
        np.testing.assert_array_equal(
            module_coords(state, {}, x, torch.float32, "cpu", max_echoes=8),
            ref32)
        ref = jax_serve.probe_dtype_agreement(variables, {}, length=length,
                                              max_echoes=8)
        got = probe_dtype_agreement(state, {}, length=length, device="cpu",
                                    max_echoes=8)
        assert abs(got - ref) <= 0.05, (length, got, ref)
        assert (got >= 0.99) == (ref >= 0.99), (length, got, ref)


def test_entry_points_raise_without_a_card(weights):
    """Without device='cpu', an entry point on a machine with no GPU raises
    instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, state = weights
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_pipeline(state, {})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StofNet()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        default_device()
