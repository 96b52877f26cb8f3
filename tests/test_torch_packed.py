"""The position-packed conv (``ops/packed_conv.py``) and the packed StofNet
forward (``models/fused.py:stofnet_apply_packed``) against the JAX
package's, on the CPU in f32."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from stofnet_tpu.models import StofNet as JaxStofNet
from stofnet_tpu.models.fused import stofnet_apply_packed as jax_packed
from stofnet_tpu.ops.packed_conv import (
    conv1d_same_packed as jax_conv_packed, pack_kernel as jax_pack_kernel,
)
from stofnet_tpu_torch.models import stofnet_apply_packed
from stofnet_tpu_torch.models.torch_import import params_to_state_dict
from stofnet_tpu_torch.ops.packed_conv import conv1d_same_packed, pack_kernel

# the parameter grid of tests/test_packed_conv.py
GRID = [
    (7, 64, 64, 2, 160),    # the hot StofNet conv shape
    (9, 1, 64, 2, 160),     # conv1
    (3, 64, 4, 32, 320),    # conv_last, heavy packing
    (7, 64, 64, 4, 160),
    (5, 64, 96, 2, 160),
    (6, 8, 8, 2, 160),      # even kernel: asymmetric SAME padding
    (1, 8, 8, 4, 160),      # pointwise
]


@pytest.mark.parametrize("K,Cin,Cout,P,L", GRID)
def test_pack_kernel_bit_equal(rng, K, Cin, Cout, P, L):
    """A gather and a transpose: the same bits and the same block padding."""
    k = rng.standard_normal((K, Cin, Cout)).astype(np.float32)
    got, pads = pack_kernel(torch.from_numpy(k), P)
    ref, ref_pads = jax_pack_kernel(jnp.asarray(k), P)
    assert pads == ref_pads
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("K,Cin,Cout,P,L", GRID)
def test_conv1d_same_packed_matches_jax(rng, K, Cin, Cout, P, L):
    """The same sums in another order: rtol 1e-5, atol 1e-5 max|ref|."""
    x = rng.standard_normal((2, L, Cin)).astype(np.float32)
    k = rng.standard_normal((K, Cin, Cout)).astype(np.float32)
    b = rng.standard_normal((Cout,)).astype(np.float32)
    got = conv1d_same_packed(*map(torch.from_numpy, (x, k, b)), P).numpy()
    ref = np.asarray(jax_conv_packed(*map(jnp.asarray, (x, k, b)), P))
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("P", [2, 1])
def test_conv1d_same_packed_fallback_matches_jax(rng, P):
    """L % P != 0, or P == 1: the plain conv, in both frameworks."""
    x = rng.standard_normal((2, 159, 8)).astype(np.float32)
    k = rng.standard_normal((7, 8, 8)).astype(np.float32)
    b = rng.standard_normal((8,)).astype(np.float32)
    got = conv1d_same_packed(*map(torch.from_numpy, (x, k, b)), P).numpy()
    ref = np.asarray(jax_conv_packed(*map(jnp.asarray, (x, k, b)), P))
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("pack,cfg,length", [
    (2, {}, 800), (4, {}, 800), (2, {"semi_global_scale": 1}, 400)])
def test_stofnet_apply_packed_matches_jax(rng, pack, cfg, length):
    """The whole packed forward on random-init weights moved across by
    ``params_to_state_dict``: rtol 1e-4, atol 1e-5 max|ref|."""
    variables = JaxStofNet(**cfg).init(jax.random.key(0),
                                       jnp.zeros((1, 1, length)))
    state = {k: torch.tensor(v)
             for k, v in params_to_state_dict(variables).items()}
    x = rng.standard_normal((2, 1, length)).astype(np.float32)
    ref = np.asarray(jax_packed(variables, jnp.asarray(x), dtype=None,
                                pack=pack, **cfg))
    got = stofnet_apply_packed(state, torch.from_numpy(x), dtype=None,
                               pack=pack, **cfg).numpy()
    assert got.shape == ref.shape == (2, 1, 4 * length)
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-5 * np.abs(ref).max())
