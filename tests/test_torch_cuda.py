"""The port's CUDA kernels against their plain versions on the card.

Every test here needs a CUDA device (marker ``cuda``) and skips without
one. The file imports no JAX, so it also runs on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: max|kernel - plain| <= 2e-2 * max|plain|. The plain versions
round at the kernel's points and run in f32 with TF32 off, so the two
differ by the order of f32 sums and the bf16 roundings that order flips.
Kernel A's offsets must equal the plain version's wherever the plain
window maximum beats its runner-up by more than 1e-3 of its magnitude (a
closer pair may swap under another order of f32 sums), and both its
outputs must equal the plain version's bits on spike inputs, whose every
f32 sum is exact; kernel B is held
against its plain version on kernel A's own outputs, per output, and must
give the same bits twice. The serving SGB kernel (the streamed kernel's
serving instantiation, which both ``sgb.sgb_contract_pool`` and
``sgb_dma.sgb_contract_pool_dma`` launch) is held to its plain version at
the tolerance on random inputs and bit for bit on spike inputs, whose
every f32 sum is exact. The probe is held to its total (rtol 1e-3 of the f64 sum),
each element to 64 f32 epsilons of the sum of its terms' magnitudes, and
the same bits twice; the canary to ``x * 2`` exactly.
"""

import numpy as np
import pytest
import torch

from stofnet_tpu_torch.data.synthetic import gate_batch
from stofnet_tpu_torch.models import (
    StofNet, stofnet_apply_fused, stofnet_apply_reference,
)
from stofnet_tpu_torch.ops.conv import conv1d_same
from stofnet_tpu_torch.ops.kernels import conv_stack, dma_probe, sgb, sgb_dma
from stofnet_tpu_torch.scripts.dma_probe import ELEM_TOL
from stofnet_tpu_torch.serve import make_pipeline, module_coords
from stofnet_tpu_torch.train import (
    LossConfig, make_fused_train_step, make_optimizer,
)

pytestmark = pytest.mark.cuda
TOL = 2e-2
MARGIN = 1e-3  # offsets are compared where max - runner-up > MARGIN * |max|


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
    """JAX's ``sgb_contract_pool`` counterpart launches the serving kernel
    once at every L % 80 == 0: odd window counts leave a masked last tile
    with one window; both sequence ends take the zero halo."""
    rng = np.random.default_rng(length)
    h = _bf16(rng, (batch, length, 64), cuda)
    w = _bf16(rng, (5, 64, f), cuda, 0.05)
    b = _bf16(rng, (f,), cuda, 0.1)
    before = sgb_dma.launches
    got = sgb.sgb_contract_pool(h, w, b)
    assert sgb_dma.launches == before + 1
    _close(got, sgb.sgb_contract_pool_reference(h, w, b))


@pytest.mark.parametrize("batch,length,up", [(2, 80, 4), (1, 444, 4),
                                             (3, 445, 1), (2, 478, 4),
                                             (2, 479, 4), (2, 800, 8),
                                             (2, 957, 4), (2, 8000, 4)])
def test_conv_stack_kernel_matches_plain(cuda, batch, length, up):
    """Edge tiles of 478 positions and middle tiles of 444 (tile_plan):
    one tile up to 512, two up to 956, three from 957; the seams between
    tiles and both sequence ends."""
    rng = np.random.default_rng(length)
    state = StofNet(upsample_factor=up, device=cuda,
                    generator=torch.Generator().manual_seed(1)).state_dict()
    h0 = _bf16(rng, (batch, length, 64), cuda)
    before = conv_stack.launches
    got = conv_stack.conv_stack_fused(h0, state)
    assert conv_stack.launches == before + 1
    assert got.dtype == torch.float32
    _close(got, conv_stack.conv_stack_fused_reference(h0, state))


def _shift_state(up, tap_mid, tap_last, dev):
    """Stack weights that only shift: every layer's output is its input at
    one outermost tap (identity there, zeros elsewhere, zero biases)."""
    state = {}
    for i in range(2, 13):
        w = torch.zeros(64, 64, 7, device=dev)
        w[:, :, tap_mid] = torch.eye(64, device=dev)
        state[f"conv{i}.weight"] = w
        state[f"conv{i}.bias"] = torch.zeros(64, device=dev)
    w = torch.zeros(up, 64, 3, device=dev)
    w[:, :up, tap_last] = torch.eye(up, device=dev)
    state["conv_last.weight"] = w
    state["conv_last.bias"] = torch.zeros(up, device=dev)
    return state


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("length", [300, 957, 8000])
def test_conv_stack_kernel_sees_its_whole_halo(cuda, length, side):
    """With weights that only shift to one side, output p sums inputs up to
    p -/+ 34 along paths of weight 1: small integers (under 256), exact in
    bf16 and in any order of f32 sums, so kernel and plain version agree
    bit for bit. A tile whose halo on that side is one row short drops the
    path to the 34th row and differs; random weights at TOL would hide it."""
    rng = np.random.default_rng(length)
    taps = (0, 0) if side == "left" else (6, 2)
    state = _shift_state(4, *taps, cuda)
    h0 = torch.from_numpy(rng.integers(1, 4, (2, length, 64)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    got = conv_stack.conv_stack_fused(h0, state)
    ref = conv_stack.conv_stack_fused_reference(h0, state)
    torch.cuda.synchronize()
    assert 0 < ref.max().item() < 256
    assert torch.equal(got, ref), (got != ref).sum().item()


def _clear_windows(h, w, b):
    """Windows whose plain maximum beats the runner-up by > MARGIN * |max|."""
    y = conv1d_same(h.float(), w.to(h.dtype).float(), b.to(h.dtype).float())
    bsz, length, f = y.shape
    top = y.reshape(bsz, length // 80, 80, f).topk(2, dim=2).values
    return (top[:, :, 0] - top[:, :, 1]) > MARGIN * top[:, :, 0].abs()


@pytest.mark.parametrize("batch,length,f", [(3, 80, 512), (2, 800, 512),
                                            (1, 2000, 128), (5, 8000, 512)])
def test_sgb_trainable_kernels_match_plain(cuda, batch, length, f):
    """Kernel A (pooled, offsets) and kernel B (dh, dkernel, dbias): one
    window per sequence, both sequence ends and the seams of dh."""
    rng = np.random.default_rng(length + 1)
    h = _bf16(rng, (batch, length, 64), cuda)
    w = torch.from_numpy((rng.standard_normal((5, 64, f)) * 0.05).astype(
        np.float32)).to(cuda)
    b = torch.from_numpy((rng.standard_normal(f) * 0.1).astype(
        np.float32)).to(cuda)
    image, bias = sgb.sgb_dma_weights(w, b, torch.bfloat16)
    before = (sgb.argmax_launches, sgb.bwd_launches)
    pooled, off = sgb.sgb_contract_pool_argmax(h, image, bias)
    ref_pooled, ref_off = sgb.sgb_contract_pool_argmax_reference(h, w, b)
    _close(pooled, ref_pooled)
    clear = _clear_windows(h, w, b)
    assert bool((off == ref_off)[clear].all())
    assert int(off.min()) >= 0 and int(off.max()) < 80

    g = _bf16(rng, pooled.shape, cuda)
    got = sgb.sgb_contract_pool_bwd(h, w, g, pooled, off)
    again = sgb.sgb_contract_pool_bwd(h, w, g, pooled, off)
    ref = sgb.sgb_contract_pool_bwd_reference(h, w, g, pooled, off)
    assert (sgb.argmax_launches, sgb.bwd_launches) == (before[0] + 1,
                                                       before[1] + 2)
    for x, y, z in zip(got, again, ref):
        _close(x, z)
        assert torch.equal(x, y)


@pytest.mark.parametrize("batch,length", [(3, 80), (1, 240), (2, 2000),
                                          (5, 8000)])
def test_sgb_argmax_kernel_spike_inputs_bit_for_bit(cuda, batch, length):
    """Kernel A on ``sgb_dma.spike_inputs``: every f32 sum is exact, so the
    kernel gives its plain version's bits in pooled and offsets alike; the
    all-bias columns tie across whole windows (the first position must
    win) and spikes at window positions 0, 1, 78, 79 move into another
    window if a tap reads one row off. 1, 3, 25 and 100 windows a
    sequence: one window, odd counts (the masked last tile) and even."""
    h, w, b = (torch.from_numpy(a).to(cuda)
               for a in sgb_dma.spike_inputs(batch, length, seed=length))
    h = h.to(torch.bfloat16)
    image, bias = sgb.sgb_dma_weights(w, b, torch.bfloat16)
    before = sgb.argmax_launches
    pooled, off = sgb.sgb_contract_pool_argmax(h, image, bias)
    ref_pooled, ref_off = sgb.sgb_contract_pool_argmax_reference(h, w, b)
    torch.cuda.synchronize()
    assert sgb.argmax_launches == before + 1
    assert 0 < ref_pooled.float().max().item() < 32
    assert torch.equal(pooled, ref_pooled), (pooled != ref_pooled).sum().item()
    assert torch.equal(off, ref_off), (off != ref_off).sum().item()


def test_sgb_argmax_kernel_takes_a_batch_past_the_grid_row_limit(cuda):
    """B = 70,000 > 65,535 (the grid's y limit) at L=80, F=128: kernel A
    numbers its CTAs along x, so the grid refuses no training batch."""
    rng = np.random.default_rng(7)
    h = _bf16(rng, (70_000, 80, 64), cuda)
    w = _bf16(rng, (5, 64, 128), cuda, 0.05)
    b = _bf16(rng, (128,), cuda, 0.1)
    image, bias = sgb.sgb_dma_weights(w, b, torch.bfloat16)
    pooled, off = sgb.sgb_contract_pool_argmax(h, image, bias)
    ref_pooled, ref_off = sgb.sgb_contract_pool_argmax_reference(h, w, b)
    _close(pooled, ref_pooled)
    assert bool((off == ref_off)[_clear_windows(h, w, b)].all())


@pytest.mark.parametrize("batch,length,f", [(1, 80, 512), (2, 800, 128),
                                            (3, 2000, 512), (5, 8000, 512)])
def test_sgb_bwd_kernel_exact_inputs_bit_for_bit(cuda, batch, length, f):
    """Kernel B on ``sgb.bwd_exact_inputs``: every f32 sum exact and dh
    exact in bf16, offsets at the window seams, so the kernel gives its
    plain version's bits and a term missed across a seam (between two
    windows of one CTA's run or across its ends) differs. B * L / 80 is 1,
    20, 75 and 500 windows: runs of 8 with a partial last one, a single
    window with no neighbour, runs that cross from one waveform to the
    next."""
    h, w, g, pooled, off = (torch.from_numpy(a).to(cuda) for a in
                            sgb.bwd_exact_inputs(batch, length, seed=length,
                                                 f=f))
    h, g, pooled = (t.to(torch.bfloat16) for t in (h, g, pooled))
    assert (batch * length // 80) % sgb.BWD_RUN != 0
    before = sgb.bwd_launches
    got = sgb.sgb_contract_pool_bwd(h, w, g, pooled, off)
    again = sgb.sgb_contract_pool_bwd(h, w, g, pooled, off)
    ref = sgb.sgb_contract_pool_bwd_reference(h, w, g, pooled, off)
    torch.cuda.synchronize()
    assert sgb.bwd_launches == before + 2
    for x, y, z, name in zip(got, again, ref, ("dh", "dkernel", "dbias")):
        assert z.abs().max().item() > 0, name
        assert torch.equal(x, z), (name, (x != z).sum().item())
        assert torch.equal(x, y), name


def test_fused_train_step_on_the_card(cuda):
    """Two fused train steps at L=1600: both trainable kernels launch on
    each, the loss is finite."""
    rng = np.random.default_rng(4)
    model = StofNet(device=cuda, generator=torch.Generator().manual_seed(5))
    params = dict(model.named_parameters())
    cfg = LossConfig(upsample_factor=4, max_echoes=8)
    opt, sched = make_optimizer(params.values(), steps_per_epoch=100)
    step = make_fused_train_step(params, opt, sched, cfg)
    x = rng.standard_normal((2, 1, 1600)).astype(np.float32)
    x /= np.abs(x).max(-1, keepdims=True)
    gt = torch.tensor([[[1600, 4400]]] * 2, dtype=torch.int32, device=cuda)
    for _ in range(2):
        before = (sgb.argmax_launches, sgb.bwd_launches)
        loss = step(torch.from_numpy(x).to(cuda), gt)
        assert (sgb.argmax_launches, sgb.bwd_launches) == (before[0] + 1,
                                                           before[1] + 1)
        assert bool(torch.isfinite(loss))


def test_kernels_refuse_float32_on_the_card(cuda):
    """f32 raises TypeError, and C=32 (which the CPU computes) ValueError,
    for the serving op and the trainable op, before any launch."""
    h = torch.zeros((1, 800, 64), device=cuda)
    before = (sgb_dma.launches, sgb.argmax_launches)
    with pytest.raises(TypeError):
        sgb.sgb_contract_pool(h, torch.zeros((5, 64, 512), device=cuda),
                              torch.zeros(512, device=cuda))
    h32 = torch.zeros((1, 160, 32), device=cuda, dtype=torch.bfloat16)
    w32 = torch.zeros((5, 32, 128), device=cuda)
    b32 = torch.zeros(128, device=cuda)
    with pytest.raises(ValueError):
        sgb.sgb_contract_pool(h32, w32, b32)
    with pytest.raises(ValueError):
        sgb.sgb_contract_pool_trainable(h32, w32, b32)
    assert (sgb_dma.launches, sgb.argmax_launches) == before


def test_image_kernels_refuse_a_misaligned_h(cuda):
    """Kernel A and the streamed kernel read h through a tensor map, whose
    base must be 16-byte aligned: a contiguous view 2 bytes off raises
    ValueError before any launch (a non-contiguous h is copied first)."""
    w = torch.zeros((5, 64, 128), device=cuda)
    image, bias = sgb.sgb_dma_weights(w, torch.zeros(128, device=cuda),
                                      torch.bfloat16)
    flat = torch.zeros(800 * 64 + 1, device=cuda, dtype=torch.bfloat16)
    h = flat[1:].view(1, 800, 64)
    before = (sgb.argmax_launches, sgb_dma.launches)
    with pytest.raises(ValueError, match="16-byte"):
        sgb.sgb_contract_pool_argmax(h, image, bias)
    with pytest.raises(ValueError, match="16-byte"):
        sgb_dma.sgb_contract_pool_dma_prepared(h, image, bias)
    assert (sgb.argmax_launches, sgb_dma.launches) == before


def test_fused_forward_and_pipeline_on_the_card(cuda):
    rng = np.random.default_rng(0)
    state = StofNet(device=cuda,
                    generator=torch.Generator().manual_seed(2)).state_dict()
    x = torch.from_numpy(rng.standard_normal((2, 1, 1600)).astype(
        np.float32)).to(cuda)
    _close(stofnet_apply_fused(state, x), stofnet_apply_reference(state, x))
    counts = (sgb_dma.launches, conv_stack.launches)
    coords = make_pipeline(state, {}, max_echoes=8, device=cuda)(x)
    assert coords.shape == (2, 8) and coords.is_cuda
    assert (sgb_dma.launches, conv_stack.launches) == (counts[0] + 1,
                                                       counts[1] + 1)


def test_pipeline_module_route_on_the_card(cuda):
    """At L=1000 (not a multiple of 80) make_pipeline serves the StofNet
    module and launches no kernel; its coords are the bf16 module's."""
    state = StofNet(device=cuda,
                    generator=torch.Generator().manual_seed(2)).state_dict()
    x = gate_batch(4, 1000, np.random.default_rng(3))
    pipe = make_pipeline(state, {}, max_echoes=8, device=cuda)
    counts = (sgb_dma.launches, conv_stack.launches)
    got = pipe(x)
    assert (sgb_dma.launches, conv_stack.launches) == counts
    assert pipe.calls == {"fused": 0, "module": 1}
    ref = module_coords(state, {}, x, torch.bfloat16, cuda, max_echoes=8)
    assert torch.equal(got.cpu(), torch.from_numpy(ref))


def test_pipeline_float32_takes_the_module_route_on_the_card(cuda):
    """The kernels take bfloat16 only: an f32 pipeline on the card serves
    the f32 StofNet module (no launch) and gives its coords."""
    state = StofNet(device=cuda,
                    generator=torch.Generator().manual_seed(2)).state_dict()
    x = gate_batch(4, 800, np.random.default_rng(4))
    pipe = make_pipeline(state, {}, max_echoes=8, device=cuda,
                         dtype=torch.float32)
    assert pipe.route(800) == "module"
    counts = (sgb_dma.launches, conv_stack.launches)
    got = pipe(x)
    assert (sgb_dma.launches, conv_stack.launches) == counts
    ref = module_coords(state, {}, x, torch.float32, cuda, max_echoes=8)
    assert torch.equal(got.cpu(), torch.from_numpy(ref))


def test_f32_pipeline_computes_without_tf32_on_the_card(cuda):
    """Repair: PyTorch leaves cuDNN's TF32 on by default, and the f32
    route's convs rounded their products to TF32. With the caller's flags
    at PyTorch's default, an f32 pipeline gives the coords it gives with
    TF32 off (the fixture's setting), bit for bit, and leaves the flag
    on."""
    state = StofNet(device=cuda,
                    generator=torch.Generator().manual_seed(2)).state_dict()
    x = gate_batch(16, 8000, np.random.default_rng(3008))
    want = make_pipeline(state, {}, max_echoes=8, device=cuda,
                         dtype=torch.float32)(x)
    torch.backends.cudnn.allow_tf32 = True
    try:
        pipe = make_pipeline(state, {}, max_echoes=8, device=cuda,
                             dtype=torch.float32)
        got = pipe(x)
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = False
    assert pipe.route(8000) == "module"
    assert torch.equal(got, want)


def test_pipelines_in_two_threads_give_their_own_bits(cuda):
    """Repair: the conv stack's wrapper let its contiguous copy of the
    input go before the launch was queued, so another thread serving at
    the same time (a daemon runs one dispatcher a length) could be handed
    that memory and write it first: 1-2 rows of 60 batches differed from
    the pipeline's own coords served alone. Two threads, L=8000 and 2000,
    40 batches of 1-8 rows each, give the coords of one thread."""
    import threading

    state = StofNet(device=cuda,
                    generator=torch.Generator().manual_seed(0)).state_dict()
    rng = np.random.default_rng(0)
    pipes = {n: make_pipeline(state, {}, max_echoes=64, device=cuda)
             for n in (8000, 2000)}
    data = {n: [gate_batch(int(b), n, rng) for b in rng.integers(1, 9, 40)]
            for n in pipes}
    alone = {n: [pipes[n](x).cpu() for x in data[n]] for n in pipes}
    differing = {}

    def serve(n):
        differing[n] = sum(int((pipes[n](x).cpu() != want).any(1).sum())
                           for x, want in zip(data[n], alone[n]))

    threads = [threading.Thread(target=serve, args=(n,)) for n in pipes]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120.0)
    assert not any(t.is_alive() for t in threads)
    assert differing == {8000: 0, 2000: 0}


def test_artifact_on_the_card(cuda, tmp_path):
    """A batch-polymorphic artifact exported and loaded on the card gives
    make_pipeline's coords bit for bit, and launches the serving SGB
    kernel and the conv stack once a batch through their custom ops."""
    from stofnet_tpu_torch.serve import (
        export_pipeline, load_pipeline, save_pipeline,
    )
    state = StofNet(device=cuda,
                    generator=torch.Generator().manual_seed(2)).state_dict()
    program = export_pipeline(state, {}, "b", 1600, device=cuda,
                              max_echoes=8)
    served = load_pipeline(save_pipeline(tmp_path / "a.pt2", program))
    assert served.device.type == "cuda"
    live = make_pipeline(state, {}, max_echoes=8, device=cuda)
    for b in (1, 3):
        x = gate_batch(b, 1600, np.random.default_rng(b))
        counts = (sgb_dma.launches, conv_stack.launches)
        got = served(x)
        assert (sgb_dma.launches, conv_stack.launches) == (counts[0] + 1,
                                                           counts[1] + 1)
        assert torch.equal(got, live(x))


@pytest.mark.parametrize("impl", ["conv", "dots"])
@pytest.mark.parametrize("batch,length,k", [(1, 8000, 5), (3, 840, 7)])
def test_int8_conv_on_the_card(cuda, impl, batch, length, k):
    """The int8 route's s8 conv (``torch._int_mm`` on the codes
    ``quantize_weight`` lays out column-major) gives the CPU's exact
    int32 sums on the card, B=1 included."""
    from stofnet_tpu_torch.ops.int8 import conv1d_same_int8, quantize_weight

    rng = np.random.default_rng(k)
    xq = torch.from_numpy(rng.integers(-127, 128, (batch, length, 64))
                          .astype(np.int8))
    wq, _ = quantize_weight(torch.from_numpy(
        rng.standard_normal((k, 64, 512)).astype(np.float32)))
    want = conv1d_same_int8(xq, wq, impl)
    got = conv1d_same_int8(xq.to(cuda), wq.to(cuda), impl)
    assert torch.equal(got.cpu(), want)


def test_canary_on_the_card(cuda):
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, 128)).astype(np.float32)).to(cuda)
    before = dma_probe.canary_launches
    got = dma_probe.canary(x)
    torch.cuda.synchronize()
    assert dma_probe.canary_launches == before + 1
    assert torch.equal(got, x * 2)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("length", [800, 8000])
def test_sgb_dma_kernel_matches_plain(cuda, length, seed):
    """The streamed kernel: L=800 is one ring's worth of windows and a
    little more (5 tiles of 2 windows through 4 slots), L=8000 many
    turns of the ring; both sequence ends take the copy's zero fill."""
    rng = np.random.default_rng(100 + seed)
    h = _bf16(rng, (4, length, 64), cuda)
    w = _bf16(rng, (5, 64, 512), cuda, 0.05)
    b = _bf16(rng, (512,), cuda, 0.1)
    before = sgb_dma.launches
    got = sgb_dma.sgb_contract_pool_dma(h, w, b)
    assert sgb_dma.launches == before + 1
    _close(got, sgb_dma.sgb_contract_pool_dma_reference(h, w, b))


@pytest.mark.parametrize("length", [80, 240, 800, 2000, 8000])
def test_sgb_dma_kernel_sees_window_edges_and_halo(cuda, length):
    """Spikes at window offsets 0, 1, 78, 79 and at both sequence ends,
    one tap and one channel per output, small integers: every f32 sum is
    exact, so the kernel gives its plain version's bits, and a tap that
    reads one row off (a halo row short, a window misplaced) differs where
    random inputs at the tolerance would hide it. 1, 3 and 25 windows a
    sequence leave a masked last tile; 10 and 100 do not."""
    h, w, b = (torch.from_numpy(a).to(cuda)
               for a in sgb_dma.spike_inputs(8, length, seed=length))
    h = h.to(torch.bfloat16)
    got = sgb_dma.sgb_contract_pool_dma(h, w, b)
    ref = sgb_dma.sgb_contract_pool_dma_reference(h, w, b)
    torch.cuda.synchronize()
    assert 0 < ref.float().max().item() < 32
    assert torch.equal(got, ref), (got != ref).sum().item()


def test_sgb_dma_kernel_takes_a_batch_past_the_grid_row_limit(cuda):
    """B = 70,000 > 65,535 (the grid's y limit) at L=80, F=512: the serving
    kernel numbers its CTAs along x, and gives its plain version's bits on
    spike inputs."""
    h, w, b = (torch.from_numpy(a).to(cuda)
               for a in sgb_dma.spike_inputs(70_000, 80, seed=7))
    h = h.to(torch.bfloat16)
    got = sgb.sgb_contract_pool(h, w, b)
    for s in range(0, h.shape[0], 10_000):  # the f32 plain conv in parts
        ref = sgb.sgb_contract_pool_reference(h[s:s + 10_000], w, b)
        torch.cuda.synchronize()
        assert 0 < ref.float().max().item() < 32
        assert torch.equal(got[s:s + 10_000], ref), (
            s, (got[s:s + 10_000] != ref).sum().item())


@pytest.mark.parametrize("impl", ["dma", "tile"])
@pytest.mark.parametrize("length", [2000, 8000])
def test_sgb_impl_dispatch_by_launch_count(cuda, length, impl):
    """Both ``sgb_impl`` values launch the serving kernel once, at
    L=2000 (a length JAX's DMA kernel refuses) as at L=8000: the argument
    is kept for parity with the JAX function and chooses nothing."""
    state = StofNet(device=cuda,
                    generator=torch.Generator().manual_seed(2)).state_dict()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 1, length)).astype(np.float32)).to(cuda)
    before = (sgb_dma.launches, conv_stack.launches)
    got = stofnet_apply_fused(state, x, fused_stack=False, sgb_impl=impl)
    after = (sgb_dma.launches, conv_stack.launches)
    assert after == (before[0] + 1, before[1])
    _close(got, stofnet_apply_reference(state, x, fused_stack=False))


@pytest.mark.parametrize("chunk_rows,n_buffers", [(64, 2), (128, 4)])
def test_probe_on_the_card(cuda, chunk_rows, n_buffers):
    """Two sweep points: total, per-element rule and the same bits twice."""
    x = _bf16(np.random.default_rng(5), (256_000, 128), cuda)
    before = dma_probe.probe_launches
    got = dma_probe.stream_probe(x, chunk_rows, n_buffers)
    again = dma_probe.stream_probe(x, chunk_rows, n_buffers)
    plain = dma_probe.stream_probe_reference(x, chunk_rows)
    torch.cuda.synchronize()
    assert dma_probe.probe_launches == before + 2
    assert torch.equal(got, again)
    total = float(x.double().sum())
    assert np.isclose(float(got.double().sum()), total, rtol=1e-3)
    mag = torch.sum(x.abs().view(-1, 8, 128), dim=0, dtype=torch.float32)
    assert bool(((got - plain).abs() <= ELEM_TOL * mag).all())
