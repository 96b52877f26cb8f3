"""The bench's compute paths (``bench_paths.py``) and the plain versions of
the probe and its canary (``ops/kernels/dma_probe.py``), against the JAX
functions they replace, on the CPU."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from stofnet_tpu.models import StofNet as JaxStofNet
from stofnet_tpu.models.fused import (
    stofnet_apply_fused as jax_fused, stofnet_apply_packed as jax_packed,
)
from stofnet_tpu.ops import mask2coords as jax_mask2coords
from stofnet_tpu_torch.bench_paths import (
    coord_agreement, make_decoder, make_xla_pipeline, try_fused_pipeline,
    try_packed_pipeline,
)
from stofnet_tpu_torch.data.synthetic import gate_batch
from stofnet_tpu_torch.models.torch_import import params_to_state_dict
from stofnet_tpu_torch.ops.kernels import dma_probe

B, L = 2, 800


def _decode(heat):
    """The bench's decode (bench.py:make_decoder) in JAX."""
    return np.asarray(jax_mask2coords(heat, window_size=20, threshold=None,
                                      upsample_factor=4, max_echoes=8))


@pytest.fixture(scope="module")
def model():
    """Random-init JAX weights, their port state dict, an echo gate batch."""
    variables = JaxStofNet().init(jax.random.key(0), jnp.zeros((1, 1, L)))
    state = {k: torch.tensor(v)
             for k, v in params_to_state_dict(variables).items()}
    x = gate_batch(B, L, np.random.default_rng(7))
    return variables, state, x


def test_fused_pipeline_matches_jax(model):
    """bench.py:try_fused_pipeline's forward: bf16, plain conv stack, the
    DMA kernel (interpret mode in JAX, the plain version here). Every coord
    slot within 1 sample of JAX's, and the gate passes on them."""
    variables, state, x = model
    ref = _decode(jax_fused(variables, jnp.asarray(x), dtype=jnp.bfloat16,
                            interpret=True, fused_stack=False,
                            sgb_impl="dma"))
    pipe = try_fused_pipeline(state, {}, torch.from_numpy(x), ref)
    assert pipe is not None
    got = pipe(state, torch.from_numpy(x))
    assert got.shape == ref.shape == (B, 8)
    assert np.abs(got.numpy() - ref).max() <= 1.0
    assert (got.numpy() != 0).any()


def test_packed_pipeline_matches_jax(model):
    """bench.py:try_packed_pipeline's forward: bf16, pack 2."""
    variables, state, x = model
    ref = _decode(jax_packed(variables, jnp.asarray(x), dtype=jnp.bfloat16,
                             pack=2))
    pipe = try_packed_pipeline(state, {"upsample_factor": 4},
                               torch.from_numpy(x), ref)
    assert pipe is not None
    got = pipe(state, torch.from_numpy(x))
    assert got.shape == ref.shape == (B, 8)
    assert np.abs(got.numpy() - ref).max() <= 1.0


def test_xla_pipeline_matches_jax_module(model):
    """bench.py:make_xla_pipeline (the flax module under XLA) is the
    StofNet module here: f32 coords equal JAX's."""
    variables, state, x = model
    ref = _decode(JaxStofNet().apply(variables, jnp.asarray(x)))
    got = make_xla_pipeline({}, None, "cpu")(state, torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("gate", [try_fused_pipeline, try_packed_pipeline])
def test_gate_refuses_shifted_coords(model, gate):
    """A coords_ref 2 samples off every slot: agreement 0, no pipeline."""
    _, state, x = model
    xt = torch.from_numpy(x)
    own = make_decoder({})(torch.zeros((B, 1, 4 * L)))  # all slots empty
    assert coord_agreement(own, own) == 1.0
    ref = make_xla_pipeline({}, torch.bfloat16, "cpu")(state, xt)
    assert gate(state, {}, xt, ref.numpy() + 2.0) is None


def test_bench_paths_refuse_other_architectures(model):
    _, state, x = model
    with pytest.raises(ValueError, match="num_features"):
        try_fused_pipeline(state, {"num_features": 32},
                           torch.from_numpy(x), np.zeros((B, 8)))


def _probe_input(rng, n_rows):
    x = torch.from_numpy(rng.standard_normal((n_rows, 128)).astype(
        np.float32)).to(torch.bfloat16)
    return x, jnp.asarray(x.float().numpy(), jnp.bfloat16)


@pytest.mark.parametrize("chunk_rows,n_buffers", [(8, 2), (64, 4), (512, 8)])
def test_probe_plain_matches_jax_sum(rng, chunk_rows, n_buffers):
    """The probe's plain version against the sum the JAX script checks its
    kernel with (scripts/dma_probe.py:161-163; the Pallas probe has no
    interpret switch and cannot run on the CPU): rtol 1e-5, atol 1e-5 of
    max|ref| (f32 sums in another order)."""
    x, xj = _probe_input(rng, 4096)
    got = dma_probe.stream_probe(x, chunk_rows, n_buffers).numpy()
    ref = np.asarray(jnp.sum(xj.astype(jnp.float32).reshape(-1, 8, 128),
                             axis=0))
    assert got.shape == ref.shape == (8, 128) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def test_canary_plain_matches_jax(rng):
    """o = 2 x, exact (scripts/dma_probe.py:triv)."""
    x = rng.standard_normal((8, 128)).astype(np.float32)
    got = dma_probe.canary(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.asarray(x) * 2.0))


def test_probe_wrapper_refuses_bad_shapes(rng):
    x, _ = _probe_input(rng, 4096)
    with pytest.raises(ValueError, match="divides"):
        dma_probe.stream_probe(x, 384)  # 4096 % 384
    with pytest.raises(ValueError, match="multiple of 8"):
        dma_probe.stream_probe(x[:4092], 4)
    with pytest.raises(ValueError, match="128"):
        dma_probe.stream_probe(x[:, :64], 64)
    with pytest.raises(ValueError, match="n_buffers"):
        dma_probe.stream_probe(x, 64, 5)
    with pytest.raises(TypeError, match="CUDA"):
        dma_probe.stream_probe(x.to("meta"), 64)
    with pytest.raises(TypeError, match="CUDA"):
        dma_probe.canary(torch.zeros((8, 128), device="meta"))
