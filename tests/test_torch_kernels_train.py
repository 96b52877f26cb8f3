"""The training side of the port's kernels on the CPU, against the JAX
package: the ``maxpool_leaky`` backward (ties to the first maximal
element), the plain versions of kernel A (forward with argmax) and kernel
B (backward) against the Pallas kernel in interpret mode and its XLA
backward, the trainable op's value and gradients, and the gradients of the
fused trainable forward end to end. The CUDA kernels are held against these
plain versions on the card in tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from stofnet_tpu.models import StofNet as JaxStofNet
from stofnet_tpu.models.fused import stofnet_apply_fused as jax_fused
from stofnet_tpu.ops import poolgrad as jpool
from stofnet_tpu.ops.pallas import sgb_kernel as jsgb
from stofnet_tpu_torch.models import stofnet_apply_fused
from stofnet_tpu_torch.models.torch_import import params_to_state_dict
from stofnet_tpu_torch.ops.conv import conv1d_same
from stofnet_tpu_torch.ops import poolgrad
from stofnet_tpu_torch.ops.kernels import sgb, sgb_dma


def _torch_grad_of_pool(y, g, scale, dtype=torch.float32):
    yt = torch.tensor(y, dtype=dtype, requires_grad=True)
    out = poolgrad.maxpool_leaky(yt, scale)
    out.backward(torch.tensor(g, dtype=dtype))
    return out.detach().float().numpy(), yt.grad.float().numpy()


def _jax_grad_of_pool(y, g, scale, dtype=jnp.float32):
    out, vjp = jax.vjp(lambda a: jpool.maxpool_leaky(a, scale),
                       jnp.asarray(y, dtype))
    return (np.asarray(out.astype(jnp.float32)),
            np.asarray(vjp(jnp.asarray(g, dtype))[0].astype(jnp.float32)))


@pytest.mark.parametrize("window,want", [
    ([1.0, 3.0, 3.0, 0.0], [0.0, 1.0, 0.0, 0.0]),
    ([-1.0, -3.0, -1.0, -2.0], [0.01, 0.0, 0.0, 0.0]),
])
def test_maxpool_leaky_tie_goes_to_first_maximum(window, want):
    """An exact tie routes the whole cotangent to the first maximal element
    (amax would split it as [0, 0.5, 0.5, 0]); a negative maximum takes
    the leaky slope."""
    y = np.asarray(window, np.float32).reshape(1, 4, 1)
    g = np.ones((1, 1, 1), np.float32)
    _, got = _torch_grad_of_pool(y, g, 4)
    _, ref = _jax_grad_of_pool(y, g, 4)
    np.testing.assert_array_equal(got.ravel(), ref.ravel())
    np.testing.assert_allclose(got.ravel(), want, rtol=1e-7)


def test_maxpool_leaky_bf16_gradient_matches_jax(rng):
    """bf16 values on a grid of 1/4, so many windows tie, and a cropped
    tail (L = 813 pools 10 windows of 80). The cotangent lands on the same
    element in both frameworks; its value agrees to one bf16 rounding (the
    slope product rounds at another point in each)."""
    y = np.round(rng.standard_normal((2, 813, 16)) * 4) / 4
    g = rng.standard_normal((2, 10, 16)).astype(np.float32)
    out, got = _torch_grad_of_pool(y, g, 80, torch.bfloat16)
    ref_out, ref = _jax_grad_of_pool(y, g, 80, jnp.bfloat16)
    np.testing.assert_array_equal(out, ref_out)
    ties = (y[:, :800].reshape(2, 10, 80, 16) == y[:, :800].reshape(
        2, 10, 80, 16).max(2, keepdims=True)).sum(2) > 1
    assert ties.mean() > 0.2  # the case under test: a quarter of them tie
    np.testing.assert_array_equal(got != 0, ref != 0)
    np.testing.assert_allclose(got, ref, rtol=1e-2, atol=0)
    assert not got[:, 800:].any()  # the cropped tail gets zero


def _sgb_inputs(rng, length, f=512, scale=0.05):
    h = rng.standard_normal((2, length, 64)).astype(np.float32)
    w = (rng.standard_normal((5, 64, f)) * scale).astype(np.float32)
    b = (rng.standard_normal(f) * 0.1).astype(np.float32)
    return h, w, b


@pytest.mark.parametrize("length", [800, 2000])
def test_sgb_argmax_plain_matches_pallas(rng, length):
    """Kernel A's plain version against the Pallas kernel's with_argmax
    outputs: offsets of the biased f32 conv output, window-relative."""
    h, w, b = _sgb_inputs(rng, length)
    image, bias = sgb.sgb_dma_weights(torch.from_numpy(w),
                                      torch.from_numpy(b), torch.float32)
    pooled, off = sgb.sgb_contract_pool_argmax(torch.from_numpy(h), image,
                                               bias)
    ref_pooled, ref_off = jsgb._run(*map(jnp.asarray, (h, w, b)), 0.01,
                                    True, True)
    assert off.dtype == torch.int32 and off.shape == (2, length // 80, 512)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(ref_pooled),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(off.numpy(), np.asarray(ref_off))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("length", [80, 240, 800])
def test_sgb_argmax_plain_matches_pallas_on_spikes(length, dtype):
    """Kernel A's plain version, through the wrapper on the weight image,
    against the Pallas kernel's with_argmax outputs in interpret mode, bit
    for bit, offsets included, on ``sgb_dma.spike_inputs``: every f32 sum
    is exact, the all-bias columns tie across whole windows (the first
    position wins) and spikes sit at window positions 0, 1, 78 and 79
    (read by a neighbouring window's halo). One window, an odd count (the
    card's masked last tile) and an even one."""
    h, w, b = sgb_dma.spike_inputs(2, length, seed=length)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    image, bias = sgb.sgb_dma_weights(torch.from_numpy(w),
                                      torch.from_numpy(b), tdt)
    pooled, off = sgb.sgb_contract_pool_argmax(
        torch.from_numpy(h).to(tdt), image, bias)
    ref_pooled, ref_off = jsgb._run(jnp.asarray(h, jdt), jnp.asarray(w),
                                    jnp.asarray(b), 0.01, True, True)
    assert off.shape == ref_off.shape == (2, length // 80, 512)
    assert 0 < float(pooled.max()) < 32
    y = conv1d_same(*map(torch.from_numpy, (h, w, b))).reshape(
        2, length // 80, 80, 512)
    ties = (y == y.max(2, keepdim=True).values).sum(2) > 1
    assert ties.float().mean() > 0.15  # the case under test: 16-47 % tie
    np.testing.assert_array_equal(pooled.float().numpy(),
                                  np.asarray(ref_pooled.astype(jnp.float32)))
    np.testing.assert_array_equal(off.numpy(), np.asarray(ref_off))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dma_weight_image_round_trips_from_sgb(dtype):
    """``sgb.dma_weights_plain`` reads back the conv kernel that
    ``sgb.sgb_dma_weights`` laid out (rounded to ``dtype``), and the bias
    is rounded to ``dtype`` and held in f32; ``sgb_dma`` re-exports both."""
    rng = np.random.default_rng(11)
    w = torch.from_numpy(rng.standard_normal((5, 64, 256)).astype(
        np.float32))
    b = torch.from_numpy(rng.standard_normal(256).astype(np.float32))
    image, bias = sgb.sgb_dma_weights(w, b, dtype)
    assert image.shape == (4, 5, 64 * 64) and image.dtype == dtype
    assert torch.equal(sgb.dma_weights_plain(image), w.to(dtype))
    assert bias.dtype == torch.float32
    assert torch.equal(bias, b.to(dtype).float())
    assert sgb_dma.sgb_dma_weights is sgb.sgb_dma_weights
    assert sgb_dma.dma_weights_plain is sgb.dma_weights_plain


def test_sgb_trainable_value_and_grads_match_jax(rng):
    """The port's custom gradient on the CPU (plain versions of kernels A
    and B) against jax.value_and_grad of the JAX op in interpret mode, as
    the JAX package's own test holds it against XLA."""
    b, length, c, f = 2, 240, 64, 512
    h = rng.standard_normal((b, length, c)).astype(np.float32)
    w = (rng.standard_normal((5, c, f)) * 0.1).astype(np.float32)
    bias = (rng.standard_normal(f) * 0.1).astype(np.float32)
    probe = rng.standard_normal((b, length // 80, f)).astype(np.float32)

    def jax_fn(h, w, bias):
        y = jsgb.sgb_contract_pool_trainable(h, w, bias, 0.01, True)
        return jnp.sum(y * probe)

    ref_val, ref_grads = jax.value_and_grad(jax_fn, argnums=(0, 1, 2))(
        *map(jnp.asarray, (h, w, bias)))
    ts = [torch.tensor(a, requires_grad=True) for a in (h, w, bias)]
    val = (sgb.sgb_contract_pool_trainable(*ts) * torch.from_numpy(
        probe)).sum()
    val.backward()
    np.testing.assert_allclose(val.item(), float(ref_val), rtol=1e-5)
    for t, g_ref, name in zip(ts, ref_grads, ("h", "w", "bias")):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g_ref),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sgb_bwd_plain_matches_jax_backward(rng, dtype):
    """Kernel B's plain version against the JAX backward
    (``_trainable_bwd``) on the same residuals, at the same rounding
    points: dkernel from the cotangent rounded to h's type, dh from f32
    factors rounded once. In bf16 the slope product of a negative window
    rounds at another point in each (JAX multiplies in bf16 by bf16(0.01),
    the port in f32 by 0.01), so dh, dkernel and dbias agree to a few bf16
    steps there: atol 2e-2 of each output's largest magnitude."""
    h, w, b = _sgb_inputs(rng, 800)
    jdt = jnp.dtype(dtype)
    hj = jnp.asarray(h).astype(jdt)
    pooled, off = jsgb._run(hj, jnp.asarray(w), jnp.asarray(b), 0.01, True,
                            True)
    g = jnp.asarray(rng.standard_normal(pooled.shape).astype(np.float32)
                    ).astype(jdt)
    ref = jsgb._trainable_bwd(0.01, True, (hj, jnp.asarray(w),
                                           jnp.asarray(b), pooled, off), g)
    tdt = getattr(torch, dtype)

    def t(a):
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)
    got = sgb.sgb_contract_pool_bwd(t(hj), torch.from_numpy(w), t(g),
                                    t(pooled),
                                    torch.from_numpy(np.array(off)))
    assert [x.dtype for x in got] == [tdt, torch.float32, torch.float32]
    for x, r, name in zip(got, ref, ("dh", "dkernel", "dbias")):
        r = np.asarray(r.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(x.numpy(), r, rtol=1e-4,
                                       atol=1e-5 * np.abs(r).max(),
                                       err_msg=name)
        else:
            np.testing.assert_allclose(x.float().numpy(), r, rtol=0,
                                       atol=2e-2 * np.abs(r).max(),
                                       err_msg=name)


@pytest.mark.parametrize("batch,length", [(2, 80), (2, 800)])
def test_sgb_bwd_plain_matches_jax_backward_bit_for_bit(batch, length):
    """On ``sgb.bwd_exact_inputs`` (small integers, pooled >= 0 so g_pre
    = g, offsets at the window seams 0, 1, 78, 79 and elsewhere) every f32
    sum is exact and dh exact in bf16: kernel B's plain version gives the
    bits of the JAX backward in bf16, each output, with terms across the
    seams present in both."""
    h, w, g, pooled, off = sgb.bwd_exact_inputs(batch, length, seed=length)
    hj, gj, pj = (jnp.asarray(a).astype(jnp.bfloat16) for a in (h, g, pooled))
    ref = jsgb._trainable_bwd(0.01, True, (hj, jnp.asarray(w),
                                           jnp.zeros(w.shape[2]), pj,
                                           jnp.asarray(off)), gj)
    hb, gb, pb = (torch.from_numpy(a).to(torch.bfloat16)
                  for a in (h, g, pooled))
    got = sgb.sgb_contract_pool_bwd(hb, torch.from_numpy(w), gb, pb,
                                    torch.from_numpy(off))
    seam = np.isin(off, [0, 1, 78, 79]).mean()
    assert 0.4 < seam < 0.7  # half the offsets at the seams, a few by chance
    for x, r, name in zip(got, ref, ("dh", "dkernel", "dbias")):
        r = np.asarray(r.astype(jnp.float32))
        assert np.abs(r).max() > 0, name
        np.testing.assert_array_equal(x.float().numpy(), r, err_msg=name)


@pytest.mark.parametrize("f", [128, 512])
@pytest.mark.parametrize("batch,length", [(3, 80), (3, 800), (3, 2000),
                                          (3, 8000), (128, 8000)])
def test_bwd_plan_covers_every_window_once(batch, length, f):
    """Kernel B's plan: dh runs of at most BWD_RUN consecutive windows and
    dkernel groups, each a partition of the B * L / 80 windows in order (a
    partial last run where B * L / 80 % 8 != 0), no group empty, and one
    CTA an SM for the dkernel pass where the windows allow."""
    total = batch * (length // 80)
    for sms in (132, 114):
        runs, groups = sgb.bwd_plan(batch, length, f, sms)
        for bounds in (runs, groups):
            covered = np.concatenate([np.arange(a, b) for a, b in
                                      zip(bounds[:-1], bounds[1:])])
            np.testing.assert_array_equal(covered, np.arange(total))
            assert all(b > a for a, b in zip(bounds[:-1], bounds[1:]))
        sizes = np.diff(runs)
        assert sizes.max() <= sgb.BWD_RUN
        assert (sizes[:-1] == sgb.BWD_RUN).all()
        assert sizes[-1] == (total % sgb.BWD_RUN or sgb.BWD_RUN)
        tiles = -(-f // sgb.BWD_F_TILE)
        assert (len(groups) - 1) * tiles <= sms
        assert len(groups) - 1 == min(total, sms // tiles)
        assert np.ptp(np.diff(groups)) <= 1


def test_sgb_trainable_saves_no_pre_pool_plane(rng):
    """The op keeps (h, w, pooled, offsets) for its backward: nothing of
    the (B, L, F) size of the pre-pool plane."""
    h, w, b = (torch.from_numpy(a) for a in _sgb_inputs(rng, 800))
    pooled, off = sgb.sgb_contract_pool_argmax_reference(h, w, b)
    g = torch.ones_like(pooled)
    sizes = []

    def hook(t):
        sizes.append(t.numel())
        return t
    with torch.autograd.graph.saved_tensors_hooks(hook, lambda t: t):
        out = sgb.sgb_contract_pool_trainable(h.requires_grad_(),
                                              w.requires_grad_(), b)
    out.backward(g)
    plane = h.shape[0] * h.shape[1] * w.shape[2]
    assert sizes and max(sizes) < plane


def test_trainable_wrappers_never_fall_back_off_the_cpu(rng):
    h, w, b = (torch.from_numpy(a) for a in _sgb_inputs(rng, 800))
    image, bias = sgb.sgb_dma_weights(w, b, torch.float32)
    with pytest.raises(TypeError, match="CUDA"):
        sgb.sgb_contract_pool_argmax(h.to("meta"), image, bias)
    pooled, off = sgb.sgb_contract_pool_argmax(h, image, bias)
    with pytest.raises(TypeError, match="CUDA"):
        sgb.sgb_contract_pool_bwd(h.to("meta"), w, pooled, pooled, off)
    with pytest.raises(ValueError):
        sgb.sgb_contract_pool_bwd(h, w, pooled[:, :-1], pooled, off)


@pytest.mark.parametrize("case", ["length", "image", "bias"])
def test_sgb_argmax_wrapper_refuses_bad_shapes(rng, case):
    """Kernel A's wrapper checks every shape before it runs anything: an L
    that is not a multiple of 80, weights in another layout ([n][t * 64 +
    c] rows) or a bias of another width raise ValueError."""
    h, w, b = (torch.from_numpy(a) for a in _sgb_inputs(rng, 800))
    image, bias = sgb.sgb_dma_weights(w, b, torch.float32)
    rows = w.permute(2, 0, 1).reshape(512, 5 * 64)
    args = {"length": (h[:, :760], image, bias),
            "image": (h, rows, bias),
            "bias": (h, image, bias[:448])}[case]
    with pytest.raises(ValueError, match="L % 80"):
        sgb.sgb_contract_pool_argmax(*args)


def test_fused_trainable_grads_match_jax(rng):
    """End to end: the gradients of mean(pred^2) through
    stofnet_apply_fused(trainable=True, dtype=None) against JAX's, on the
    same weights, at L=800 (the JAX package's own tolerance against the
    flax module)."""
    x = rng.standard_normal((2, 1, 800)).astype(np.float32)
    variables = JaxStofNet().init(jax.random.key(0), jnp.asarray(x))

    def jax_loss(params):
        pred = jax_fused({"params": params}, jnp.asarray(x), dtype=None,
                         interpret=True, trainable=True)
        return jnp.mean(pred ** 2)

    ref_loss, ref_grads = jax.value_and_grad(jax_loss)(variables["params"])
    ref = params_to_state_dict({"params": ref_grads})
    params = {k: torch.tensor(v, requires_grad=True)
              for k, v in params_to_state_dict(variables).items()}
    loss = (stofnet_apply_fused(params, torch.from_numpy(x), dtype=None,
                                trainable=True) ** 2).mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    assert params.keys() == ref.keys()
    for k, p in params.items():
        np.testing.assert_allclose(p.grad.numpy(), ref[k], rtol=5e-3,
                                   atol=1e-5, err_msg=k)


def _narrow_inputs(rng, c=32, f=128, length=160):
    h = rng.standard_normal((2, length, c)).astype(np.float32)
    w = (rng.standard_normal((5, c, f)) * 0.1).astype(np.float32)
    bias = (rng.standard_normal(f) * 0.1).astype(np.float32)
    return h, w, bias


def test_sgb_trainable_takes_any_channel_count_on_the_cpu(rng):
    """On a CPU tensor the trainable op runs kernel A's and B's plain
    versions on (w, b) and builds no weight image, so it computes what
    JAX's op computes at C=32, F=128, L=160 (the image takes C == 64 only):
    value and gradients at the tolerances of the C=64 case above."""
    h, w, bias = _narrow_inputs(rng)
    probe = rng.standard_normal((2, 2, 128)).astype(np.float32)

    def jax_fn(h, w, bias):
        y = jsgb.sgb_contract_pool_trainable(h, w, bias, 0.01, True)
        return jnp.sum(y * probe)

    ref_val, ref_grads = jax.value_and_grad(jax_fn, argnums=(0, 1, 2))(
        *map(jnp.asarray, (h, w, bias)))
    ts = [torch.tensor(a, requires_grad=True) for a in (h, w, bias)]
    out = sgb.sgb_contract_pool_trainable(*ts)
    assert out.shape == (2, 2, 128)
    val = (out * torch.from_numpy(probe)).sum()
    val.backward()
    np.testing.assert_allclose(val.item(), float(ref_val), rtol=1e-5)
    for t, g_ref, name in zip(ts, ref_grads, ("h", "w", "bias")):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g_ref),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_sgb_trainable_refuses_c32_off_the_cpu(rng):
    """Off the CPU the op builds the kernels' image, which takes C == 64
    only: C=32 raises ValueError there, before any launch."""
    h, w, bias = (torch.from_numpy(a).to("meta")
                  for a in _narrow_inputs(rng))
    with pytest.raises(ValueError, match="5, 64, F"):
        sgb.sgb_contract_pool_trainable(h, w, bias)


def test_fused_trainable_grads_match_jax_at_32_features(rng):
    """The repair end to end: stofnet_apply_fused(trainable=True,
    dtype=None) on a ``num_features=32`` state, at L=160, against JAX's
    on the same weights, at the tolerances of the 64-feature case above."""
    x = rng.standard_normal((2, 1, 160)).astype(np.float32)
    variables = JaxStofNet(num_features=32).init(jax.random.key(2),
                                                 jnp.asarray(x))

    def jax_loss(params):
        pred = jax_fused({"params": params}, jnp.asarray(x), dtype=None,
                         interpret=True, trainable=True)
        return jnp.mean(pred ** 2)

    ref_loss, ref_grads = jax.value_and_grad(jax_loss)(variables["params"])
    ref = params_to_state_dict({"params": ref_grads})
    params = {k: torch.tensor(v, requires_grad=True)
              for k, v in params_to_state_dict(variables).items()}
    assert params["semi_global_block.contract_conv.weight"].shape[1] == 32
    loss = (stofnet_apply_fused(params, torch.from_numpy(x), dtype=None,
                                trainable=True) ** 2).mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    assert params.keys() == ref.keys()
    for k, p in params.items():
        np.testing.assert_allclose(p.grad.numpy(), ref[k], rtol=5e-3,
                                   atol=1e-5, err_msg=k)
