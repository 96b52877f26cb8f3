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
from stofnet_tpu_torch.ops.kernels import conv_stack, sgb, sgb_dma


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("length", [80, 240, 2000])
def test_sgb_contract_pool_matches_pallas_on_spikes(length, dtype):
    """The port's counterpart of JAX's ``sgb_contract_pool`` on
    ``sgb_dma.spike_inputs`` (spikes at window offsets 0, 1, 78, 79 and at
    both sequence ends, every f32 sum exact) gives the Pallas kernel's bits
    in interpret mode, in f32 and in bf16, at 1, 3 and 25 windows: odd
    counts, where the card's serving kernel computes a masked last tile."""
    h, w, b = sgb_dma.spike_inputs(2, length, seed=length)
    got = sgb.sgb_contract_pool(
        torch.from_numpy(h).to(getattr(torch, dtype)),
        *map(torch.from_numpy, (w, b)))
    ref = jax_sgb(jnp.asarray(h, getattr(jnp, dtype)), jnp.asarray(w),
                  jnp.asarray(b), interpret=True)
    assert got.shape == ref.shape == (2, length // 80, 512)
    assert 0 < float(got.max()) < 32
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


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
    """The weight layout a pipeline builds once for the conv stack holds
    each weight rounded to the compute type and nothing else: the k7
    layers as swizzled 64 x 64 tap blocks, conv_last as [n][t * C + c]
    rows padded with zero rows to 8, biases in f32. (The SGB kernel's
    image is held in tests/test_torch_dma.py.)"""
    state = StofNet(generator=torch.Generator().manual_seed(3),
                    device="cpu").state_dict()
    wts = conv_stack.stack_weights(state, dtype)
    assert wts.mid.shape == (11, 7, 64 * 64)
    # tap block [layer][t]: row n holds w[n, :, t] with its 16-byte chunk j
    # (8 channels) at chunk j ^ (n % 8)
    n, c = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
    image = n * 64 + ((c // 8) ^ (n % 8)) * 8 + c % 8
    assert sorted(image.ravel()) == list(range(64 * 64))
    for layer, i in enumerate(range(2, 13)):
        w = state[f"conv{i}.weight"].to(dtype)
        for t in range(7):
            assert torch.equal(wts.mid[layer, t][torch.from_numpy(image)],
                               w[:, :, t])
        assert torch.equal(conv_stack.mid_plain(wts)[layer].reshape(
            64, 7, 64).permute(0, 2, 1), w)
        assert torch.equal(wts.mid_bias[layer],
                           state[f"conv{i}.bias"].to(dtype).float())
    assert wts.r == 4 and wts.last.shape == (8, 3 * 64)
    assert torch.equal(wts.last[:4].reshape(4, 3, 64).permute(0, 2, 1),
                       state["conv_last.weight"].to(dtype))
    assert torch.equal(wts.last_bias[:4],
                       state["conv_last.bias"].to(dtype).float())
    assert not wts.last[4:].any() and not wts.last_bias[4:].any()


@pytest.mark.parametrize("length", [80, 444, 478, 479, 512, 513, 956, 957,
                                    2000, 8000])
def test_conv_stack_tile_plan(length):
    """Every position lies in exactly one kept range; a kept position has a
    halo of rows on both sides within its tile, or lies within the halo of
    a sequence end that its tile touches; tiles lie inside the sequence."""
    starts, kept = conv_stack.tile_plan(length)
    rows, halo = conv_stack.ROWS, conv_stack.HALO
    assert halo == 34 and len(starts) == len(kept)
    owner = np.zeros(length, np.int64)
    for start, (lo, hi) in zip(starts, kept):
        assert 0 <= start and lo < hi and (length <= rows
                                           or start + rows <= length)
        owner[lo:hi] += 1
        p = np.arange(lo, hi)
        left_ok = (p - start >= halo) | ((start == 0) & (p < halo))
        right_ok = ((start + rows - 1 - p >= halo)
                    | ((start + rows >= length) & (p >= length - halo)))
        assert left_ok.all() and right_ok.all()
    assert (owner == 1).all()
    want = {8000: 18, 2000: 5, 512: 1, 513: 2, 956: 2, 957: 3}
    assert len(starts) == want.get(length, len(starts))


@pytest.mark.parametrize("length", [479, 513, 957, 2000, 8000])
def test_conv_stack_tiles_stitch_to_the_whole(rng, length):
    """The plain stack run tile by tile on the windows of the plan the
    kernel is given (each a zero-padded sequence of its own, as the
    kernel's buffer is) and stitched over the kept ranges equals the stack
    over the whole sequence: f32, so the two differ by summation order
    alone. Random weights all but erase the outermost paths of the
    receptive field (a halo a few rows short moves the output by far less
    than the tolerance), so every layer's outermost taps also carry an
    identity: position p then depends on p - 34 and p + 34 with weight 1,
    and a halo one row short fails the tolerance."""
    state = StofNet(generator=torch.Generator().manual_seed(6),
                    device="cpu").state_dict()
    for name, n in [(f"conv{i}", 64) for i in range(2, 13)] + [
            ("conv_last", 4)]:
        w = state[f"{name}.weight"]
        w[:, :n, 0] += torch.eye(n)
        w[:, :n, -1] += torch.eye(n)
    wts = conv_stack.stack_weights(state, torch.float32)
    h0 = torch.from_numpy(rng.standard_normal((1, length, 64)).astype(
        np.float32))
    ref = conv_stack.conv_stack_fused_prepared(h0, wts)
    got = torch.full_like(ref, float("nan"))
    plan = conv_stack.launch_plan(length, torch.device("cpu"))
    starts, kept = conv_stack.tile_plan(length)
    assert plan.dtype == torch.int32 and plan.tolist() == [
        [s, lo, hi] for s, (lo, hi) in zip(starts, kept)]
    for start, lo, hi in plan.tolist():
        window = h0[:, start:start + conv_stack.ROWS]
        out = conv_stack.conv_stack_fused_prepared(window, wts)
        got[:, lo:hi] = out[:, lo - start:hi - start]
    assert torch.isfinite(got).all()
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("module", ["conv_stack", "dma_probe", "sgb",
                                    "sgb_dma"])
def test_every_launch_takes_its_stream_from_build(module):
    """Each wrapper passes its device index and raw stream handle through
    ``_build.launch_args`` (one helper, no ``torch.cuda.Stream`` object a
    call), and no CUDA launch function calls ``cudaSetDevice`` itself
    (``use_device`` in ``csrc/common.cuh`` skips it where the device is
    already current)."""
    import inspect
    from pathlib import Path
    from stofnet_tpu_torch.ops import kernels

    src = inspect.getsource(getattr(kernels, module))
    launches = src.count("_launch(")
    assert launches and src.count("*_build.launch_args(") == launches
    assert "current_stream" not in src and "device.index" not in src
    csrc = Path(kernels._build.CSRC)
    for cu in csrc.glob("*.cu"):
        assert "cudaSetDevice" not in cu.read_text(), cu.name
