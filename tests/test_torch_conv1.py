"""The conv1 op (``ops/kernels/conv1.py``): conv1 + bias + ReLU as the
(B, L, 64) rows the SGB and conv-stack kernels read.

On the CPU the op is its plain version, which must equal the fused
forward's former conv1 (``relu(conv1d_same(..., dtype))``) bit for bit;
the fused forward engages it only for a (64, 1, 9) conv1. The tests marked
``cuda`` hold the kernel to its plain version on the card and skip
without one. The file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_conv1.py

Tolerance on the card: the kernel sums conv1's 9 products in another
order than cuDNN, so the f32 sum can land on the other side of a bf16
rounding point. At most 0.1 % of the outputs may differ, each by at most
one bf16 ulp of the larger of the plain conv output and the result
(a flipped rounding of the conv output carries through the bias add);
on inputs whose every f32 sum is exact the bits must be equal.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from stofnet_tpu_torch.models import (
    StofNet, stofnet_apply_fused, stofnet_apply_packed,
    stofnet_apply_reference,
)
from stofnet_tpu_torch.models import fused
from stofnet_tpu_torch.ops.conv import conv1d_same
from stofnet_tpu_torch.ops.kernels import conv1
from stofnet_tpu_torch.serve import make_pipeline

BF16 = torch.bfloat16
DIFF_SHARE = 1e-3  # outputs that may differ from the plain version's bits
# the benchmark's two configurations, at a length the SGB takes
ARCHS = {"stofnet-armadillo": {}, "stofnet-nosgb": {"semi_global_scale": 1}}
# conv1s that the kernel does not compute
OTHER_CONV1 = {"k7": dict(kernel_sizes=(7, 7, 3)),
               "two_channels": dict(in_channels=2),
               "32_features": dict(num_features=32)}


def _state(device="cpu", seed=2, **arch):
    return StofNet(generator=torch.Generator().manual_seed(seed),
                   device=device, **arch).state_dict()


def _frames(shape, seed=0, device="cpu"):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(device)


def _weights(seed=1, device="cpu", dtype=BF16):
    g = torch.Generator().manual_seed(seed)
    w = (torch.rand((64, 1, 9), generator=g) * 2 - 1) / 3
    b = (torch.rand(64, generator=g) * 2 - 1) / 3
    return conv1.conv1_weights(w.to(device), b.to(device), dtype)


def _former(x, w, b, dtype):
    """The fused forward's conv1 before the op: on (B, L, 1) frames."""
    h = x.transpose(1, 2).to(dtype)
    return F.relu(conv1d_same(h, w.permute(2, 1, 0), b, dtype))


class _Spy:
    """Counts the calls of a function of ``module`` and records whether
    each call's first argument was contiguous."""

    def __init__(self, monkeypatch, module, name):
        self.fn, self.calls, self.contiguous = getattr(module, name), 0, []
        monkeypatch.setattr(module, name, self)

    def __call__(self, h, *args):
        self.calls += 1
        self.contiguous.append(h.is_contiguous())
        return self.fn(h, *args)


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
@pytest.mark.parametrize("length", [8, 80, 517, 8000])
def test_op_plain_version_is_the_former_conv1(length, dtype):
    """Bit for bit the former ``relu(conv1d_same(...))``, as contiguous
    (B, L, 64) rows in the weight's type."""
    x = _frames((2, 1, length), seed=length)
    w, b = _weights(dtype=dtype)
    got = conv1.conv1_relu_rows(x, w, b)
    assert got.shape == (2, length, 64) and got.dtype == dtype
    assert got.is_contiguous()
    assert torch.equal(got, _former(x, w, b, dtype))


def test_fake_gives_shape_and_type_and_refuses_other_shapes():
    w, b = _weights()
    with torch._subclasses.FakeTensorMode() as mode:
        x = mode.from_tensor(torch.zeros((3, 1, 517)))
        fw, fb = mode.from_tensor(w), mode.from_tensor(b)
        out = torch.ops.stofnet_torch.conv1_relu_rows(x, fw, fb)
        assert out.shape == (3, 517, 64) and out.dtype == BF16
        with pytest.raises(ValueError, match="conv1_relu_rows"):
            torch.ops.stofnet_torch.conv1_relu_rows(
                mode.from_tensor(torch.zeros((3, 2, 517))), fw, fb)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_fused_forward_is_unchanged_on_the_cpu(monkeypatch, name):
    """The fused forward through the op gives the former forward's bits
    (the op's gate closed), calls it once, and hands the SGB and
    conv-stack ops contiguous rows."""
    state, x = _state(**ARCHS[name]), _frames((2, 1, 160))
    spy = _Spy(monkeypatch, conv1, "conv1_relu_rows")
    kernels = [_Spy(monkeypatch, fused, n) for n in (
        "sgb_contract_pool_prepared", "conv_stack_fused_prepared")]
    got = fused.fused_forward(state, **ARCHS[name])(x)
    assert spy.calls == 1
    assert all(c for k in kernels for c in k.contiguous)
    assert kernels[1].calls == 1 and kernels[0].calls == (name == "stofnet-"
                                                          "armadillo")
    monkeypatch.setattr(conv1, "takes", lambda w: False)
    assert torch.equal(got, fused.fused_forward(state, **ARCHS[name])(x))
    assert spy.calls == 1


@pytest.mark.parametrize("name", sorted(OTHER_CONV1))
def test_other_conv1_takes_the_plain_conv(monkeypatch, name):
    """A conv1 other than (64, 1, 9) keeps the plain conv: the op is not
    called and the forward is the reference's."""
    arch = dict(OTHER_CONV1[name], semi_global_scale=1)
    state = _state(**arch)
    x = _frames((2, arch.get("in_channels", 1), 160))
    spy = _Spy(monkeypatch, conv1, "conv1_relu_rows")
    stack = arch.get("num_features", 64) == 64
    got = stofnet_apply_fused(state, x, semi_global_scale=1,
                              fused_stack=stack)
    assert spy.calls == 0
    assert torch.equal(got, stofnet_apply_reference(
        state, x, semi_global_scale=1, fused_stack=stack))


def test_trainable_reference_and_packed_forwards_keep_the_plain_conv(
        monkeypatch):
    state, x = _state(), _frames((2, 1, 160))
    spy = _Spy(monkeypatch, conv1, "conv1_relu_rows")
    stofnet_apply_fused(state, x, trainable=True)
    stofnet_apply_reference(state, x)
    stofnet_apply_packed(state, x)
    assert spy.calls == 0


def test_export_names_the_op():
    """``torch.export`` of the fused forward holds the op once."""
    state = _state()
    forward = fused.fused_forward(state)

    class Forward(torch.nn.Module):
        def forward(self, x):
            return forward(x)

    program = torch.export.export(Forward(), (_frames((2, 1, 160)),))
    ops = [str(n.target) for n in program.graph.nodes
           if n.op == "call_function" and "stofnet_torch" in str(n.target)]
    assert ops.count("stofnet_torch.conv1_relu_rows.default") == 1


# --- on the card -----------------------------------------------------------

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _ulp_bf16(v: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at the magnitude ``v`` (8 significant bits)."""
    _, e = torch.frexp(v.float().abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,length", [(128, 8000), (3, 80), (2, 517),
                                          (1, 8)])
def test_kernel_matches_plain_version(cuda, batch, length):
    x = _frames((batch, 1, length), seed=length, device=cuda)
    w, b = _weights(device=cuda)
    before = conv1.launches
    got = conv1.conv1_relu_rows(x, w, b)
    torch.cuda.synchronize()
    assert conv1.launches == before + 1
    ref = conv1.conv1_relu_rows_reference(x, w, b)
    assert got.shape == ref.shape and got.dtype == BF16
    assert got.is_contiguous()
    conv = conv1.conv1_relu_rows_reference(x, w, torch.zeros_like(b))
    differ = got != ref
    share = differ.float().mean().item()
    assert share <= DIFF_SHARE, share
    scale = torch.maximum(ref.float().abs(), conv.float().abs())
    gap = (got.float() - ref.float()).abs()
    assert bool((gap <= _ulp_bf16(scale)).all()), gap.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("batch,length", [(128, 8000), (2, 517)])
def test_kernel_bits_on_exact_sums(cuda, batch, length):
    """Frames of small integers, weights and biases on a 1/64 grid: every
    f32 sum is exact in any order, so the bits are the plain version's
    (a tap one position off, or a halo not zero, differs)."""
    rng = np.random.default_rng(length)
    x = torch.from_numpy(rng.integers(-8, 9, (batch, 1, length)).astype(
        np.float32)).to(cuda)
    w = torch.from_numpy(rng.integers(-64, 65, (64, 1, 9)).astype(
        np.float32) / 64).to(cuda, BF16)
    b = torch.from_numpy(rng.integers(-64, 65, 64).astype(
        np.float32) / 64).to(cuda, BF16)
    got = conv1.conv1_relu_rows(x, w, b)
    assert torch.equal(got, conv1.conv1_relu_rows_reference(x, w, b))


@pytest.mark.cuda
def test_kernel_refuses_float32_weights(cuda):
    x = _frames((1, 1, 80), device=cuda)
    w, b = _weights(device=cuda, dtype=torch.float32)
    before = conv1.launches
    with pytest.raises(TypeError):
        conv1.conv1_relu_rows(x, w, b)
    assert conv1.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_fused_forward_launches_once_with_contiguous_rows(cuda, monkeypatch,
                                                          name):
    """One launch a fused forward; the SGB and conv-stack ops get
    contiguous rows; the result is the plain path's within the kernels'
    tolerance."""
    state = _state(cuda, **ARCHS[name])
    x = _frames((2, 1, 1600), device=cuda)
    kernels = [_Spy(monkeypatch, fused, n) for n in (
        "sgb_contract_pool_prepared", "conv_stack_fused_prepared")]
    forward = fused.fused_forward(state, **ARCHS[name])
    before = conv1.launches
    got = forward(x)
    forward(x)
    torch.cuda.synchronize()
    assert conv1.launches == before + 2
    assert kernels[1].calls == 2 and all(
        c for k in kernels for c in k.contiguous)
    ref = stofnet_apply_reference(state, x, **ARCHS[name])
    err = (got - ref).abs().max().item()
    assert err <= 2e-2 * ref.abs().max().item(), err


@pytest.mark.cuda
def test_other_forwards_do_not_launch(cuda):
    """The trainable, reference, packed and int8 forwards keep the plain
    conv1, and so does a fused forward whose conv1 is k7."""
    state = _state(cuda)
    x = _frames((2, 1, 1600), device=cuda)
    before = conv1.launches
    stofnet_apply_fused(state, x, trainable=True)
    stofnet_apply_reference(state, x)
    stofnet_apply_packed(state, x)
    make_pipeline(state, {}, device=cuda, max_echoes=8,
                  int8_calib=x.cpu().numpy())(x.cpu().numpy())
    k7 = _state(cuda, kernel_sizes=(7, 7, 3))
    stofnet_apply_fused(k7, x)
    torch.cuda.synchronize()
    assert conv1.launches == before
